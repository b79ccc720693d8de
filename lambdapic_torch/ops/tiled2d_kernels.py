"""The tiled 2D engine's kernels (counterpart of
lambdapic_tpu/ops/tiled2d_pallas.py):

    B8  gather_tiled_k    staggered gather of E, B at     csrc/gather_tiled.cu
                          every tile slot
    B9  deposit_tiled_k   Esirkepov jx, jy, jz, rho into  csrc/deposit_tiled.cu
                          per-tile windows

Each entry point launches its CUDA kernel on CUDA tensors and runs its
plain PyTorch version on CPU tensors; there is no fallback from a kernel
to its plain version on the card. Each launch adds one to the wrapper's
``launches``. The operands are checked for device, type, shape and
contiguity, and what the kernel does not take raises.

B8 reads the padded E/B stack directly (the window cut fuses into its
load), so its plain version is ``extract_windows`` + ``gather_tiled``;
B9 takes the alive mask and reads no dead slot's payload, so its plain
version is ``deposit_tiled`` with w zeroed where the mask is 0; it writes
the XLA layout (4, ntx, nty, wx, wy) that ``fold_windows`` takes. The
TPU layout (C, ntx, wx, nty, wy) and its selection-matrix relayouts
exist for the TPU's block rules and are not ported.
"""
from __future__ import annotations

import torch

from ..constants import c as c_light
from . import kernel_lib
from .cellpallas import _check_float, _on_card
from .tiled2d import TileCfg, deposit_tiled, extract_windows, gather_tiled

# shared memory a block may hold on an H100 (bytes)
MAX_SMEM = 232448
# shared memory a B9 block takes beside its windows: the list of a round's
# 4096 alive slots (2 bytes each), its scan's 256 + 17 counts, 16 bytes of
# alignment and, per real, its eight warps' staging buffers (6 x 132)
DEPOSIT_SCRATCH = 2 * 4096 + 4 * (256 + 17) + 16
DEPOSIT_STAGE = 8 * 6 * 132


def _check_tiles(cfg: TileCfg, dtype, nwin: int, what: str,
                 scratch: int = 0) -> None:
    smem = nwin * cfg.wx * cfg.wy * (8 if dtype == torch.float64 else 4) \
        + scratch
    if smem > MAX_SMEM:
        raise ValueError(f"{what}: {nwin} windows of {cfg.wx} x {cfg.wy} "
                         f"take {smem} bytes of shared memory, more than "
                         f"{MAX_SMEM}")


def gather_tiled_plain(eb_pad, x, y, cfg: TileCfg):
    """Plain version of kernel B8."""
    return gather_tiled(extract_windows(eb_pad, cfg), x, y, cfg)


def gather_tiled_k(eb_pad: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   cfg: TileCfg):
    """Kernel B8. eb_pad (6, nx+2h, ny+2h) = (ex, ey, ez, bx, by, bz) with
    h = cfg.h guard cells; x, y (ntx, nty, cap_t) device-local cell
    coordinates. Returns the six gathered components, each (ntx, nty,
    cap_t)."""
    if not _on_card(x, "gather_tiled_k"):
        return gather_tiled_plain(eb_pad, x, y, cfg)
    dev, dtype = x.device, x.dtype
    _check_float(dtype, "gather_tiled_k")
    _check_tiles(cfg, dtype, 6, "gather_tiled_k")
    shape = (cfg.ntx, cfg.nty, x.shape[-1])
    kernel_lib.check(eb_pad, "eb_pad", (6, cfg.ntx * cfg.tx + 2 * cfg.h,
                                        cfg.nty * cfg.ty + 2 * cfg.h),
                     dtype, dev)
    kernel_lib.check(x, "x", shape, dtype, dev)
    kernel_lib.check(y, "y", shape, dtype, dev)
    outs = [torch.empty(shape, dtype=dtype, device=dev) for _ in range(6)]
    kernel_lib.call(
        "gather_tiled", "lp_gather_tiled", [eb_pad, x, y] + outs,
        [cfg.ntx, cfg.nty, shape[2], cfg.tx, cfg.ty, cfg.h,
         dtype == torch.float64], [], dev)
    gather_tiled_k.launches += 1
    return tuple(outs)


gather_tiled_k.launches = 0


def deposit_tiled_plain(x, y, ux, uy, uz, inv_gamma, w, alive,
                        cfg: TileCfg, *, q: float, dx: float, dy: float,
                        dt: float) -> torch.Tensor:
    """Plain version of kernel B9: ``tiled2d.deposit_tiled`` with w
    zeroed in the slots that ``alive`` does not name."""
    return deposit_tiled(x, y, ux, uy, uz, inv_gamma,
                         torch.where(alive, w, torch.zeros_like(w)), cfg,
                         q=q, dx=dx, dy=dy, dt=dt)


def deposit_tiled_k(x, y, ux, uy, uz, inv_gamma, w, alive, cfg: TileCfg, *,
                    q: float, dx: float, dy: float, dt: float
                    ) -> torch.Tensor:
    """Kernel B9: the per-tile (4, ntx, nty, wx, wy) jx, jy, jz, rho
    windows of one species, the contract of ``tiled2d.deposit_tiled``.
    ``alive`` (bool, the slots' shape) names the depositing slots: the
    kernel reads one byte a slot and no dead slot's payload, whatever w
    holds there."""
    if not _on_card(x, "deposit_tiled_k"):
        return deposit_tiled_plain(x, y, ux, uy, uz, inv_gamma, w, alive,
                                   cfg, q=q, dx=dx, dy=dy, dt=dt)
    dev, dtype = x.device, x.dtype
    _check_float(dtype, "deposit_tiled_k")
    _check_tiles(cfg, dtype, 4, "deposit_tiled_k", DEPOSIT_SCRATCH +
                 DEPOSIT_STAGE * (8 if dtype == torch.float64 else 4))
    shape = (cfg.ntx, cfg.nty, x.shape[-1])
    for name, t in (("x", x), ("y", y), ("ux", ux), ("uy", uy), ("uz", uz),
                    ("inv_gamma", inv_gamma), ("w", w)):
        kernel_lib.check(t, name, shape, dtype, dev)
    kernel_lib.check(alive, "alive", shape, torch.bool, dev)
    out = torch.empty((4, cfg.ntx, cfg.nty, cfg.wx, cfg.wy), dtype=dtype,
                      device=dev)
    kernel_lib.call(
        "deposit_tiled", "lp_deposit_tiled",
        [x, y, ux, uy, uz, inv_gamma, w, alive, out],
        [cfg.ntx, cfg.nty, shape[2], cfg.tx, cfg.ty, cfg.h,
         dtype == torch.float64],
        [c_light * dt / dx, c_light * dt / dy, c_light, q / (dx * dy),
         q / (dy * dt), q / (dx * dt)], dev)
    deposit_tiled_k.launches += 1
    return out


deposit_tiled_k.launches = 0
