"""The cell engine's particle stage and rim fold (counterpart of
lambdapic_tpu/ops/cellslab.py: ``slab_species_step`` driving kernel B2,
``fold_reduce_slab`` = kernel B3).

Rim layout (the port's own): the deposit writes per-tile panels
``(C, nbx, nby, T+4, T+4)``, C = 4 (jx, jy, jz, rho) or 3 without rho,
T = ``TILE`` cells per side; panel (bi, bj) node (a, b) is the current at
interior index (bi*T + a - 2, bj*T + b - 2). In 3D the panels are
``(C, nbx, nby, nbz, T+4, T+4, T+4)`` with T = ``TILE3``. Species chain
their panels: each species' stage starts from the previous species'
panels (``rims_in``), and one fold adds the sum into the interior J.

``cell_step`` and ``fold_reduce`` take 2D slots ``(cap, nx, ny)`` or 3D
slots ``(cap, nx, ny, nz)`` (then with ``dz`` and three ``periodic``
flags). They launch the CUDA kernels (``csrc/cellstep.cu``,
``csrc/fold.cu``; in 3D ``csrc/cellstep3d.cu``, ``csrc/fold3d.cu``) on
CUDA tensors and run their plain versions (``cell_step_plain``,
``fold_reduce_plain``) on CPU tensors. Each kernel launch adds one to
the wrapper's ``launches``; ``cell_step.launches_by_mode`` counts B2's
launches per mode ("default", "want_chi", "photon").

B2's modes, in 2D and 3D: ``want_chi`` also returns chi and the
pre-push inv_gamma for QED; ``photon`` is the field-free stage of a
photon species (no gather, no Boris, no deposit; returns no panels).
A species' payloads beyond the fixed set (a QED species' tau, delta,
event: every key but ``FLOAT_PAYLOADS``, ``ID_PAYLOADS`` and
``cell2d.TRANSIENT``) ride through the re-binning with it.

Any per-cell capacity: the sorting kernels (B2, B6, B7) pack a 16-bit
slot index under the re-binning key; above ``MAXC_LOCAL`` slots a cell
they sort in a global scratch (``key_scratch``) instead of thread-local
arrays.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..constants import c as c_light
from ..models.qed import CHI_FACTOR, calculate_chi
from ..parallel.halo import halo_reduce
from . import kernel_lib
from .cell2d import (TRANSIENT, batcher_network, deposit_offsets,
                     gather_cell_2d, migrate_cells)
from .cell3d import deposit_offsets_3d, gather_cell_3d
from .pusher import boris_push, photon_push, push_position_2d, \
    push_position_3d

TILE = 16
TILE3 = 8           # 3D tile: a (C, 12, 12, 12) panel per 8 x 8 x 8 cells
# payloads carried through the kernel, in its pointer order
FLOAT_PAYLOADS = ("x", "y", "z", "w", "ux", "uy", "uz")
ID_PAYLOADS = ("id_lo", "id_hi")
MAX_EXTRA = 3      # csrc/cellstep.cu's and csrc/cellstep3d.cu's NXF
# csrc/cell2d.cuh: the largest capacity sorted in thread-local arrays, the
# scratch rows (int32 of cap entries) of a thread above it, and the
# largest capacity of the 16-bit slot index; held equal to the library's
# lp_key_limits at its first use (``_check_key_limits``)
MAXC_LOCAL = 128
KEY_ROWS = 3
MAX_SLOTS = 1 << 16
# resident 128-thread blocks an SM gets for the scratch above MAXC_LOCAL
# (a choice not yet timed against others)
KEY_BLOCKS_PER_SM = 2
MODES = ("default", "want_chi", "photon")


def extra_payloads(data: Dict[str, torch.Tensor]) -> Tuple[str, ...]:
    """The species' carried payloads beyond the fixed set, sorted."""
    fixed = set(FLOAT_PAYLOADS) | set(ID_PAYLOADS) | TRANSIENT
    return tuple(sorted(k for k in data if k not in fixed))


@functools.cache
def _check_key_limits(lib: str) -> None:
    """The sort scratch's limits, which the kernels index by and this
    module sizes by, held equal to csrc/cell2d.cuh's once, when a sorting
    library is first used."""
    so = kernel_lib.library(lib)
    got = tuple(so.lp_key_limits(i) for i in range(3))
    want = (MAXC_LOCAL, KEY_ROWS, MAX_SLOTS)
    if got != want:
        raise RuntimeError(f"csrc/{kernel_lib.SOURCES[lib]} has sort limits "
                           f"{got}, ops/cellslab.py {want}")


def key_scratch(cap: int, ncell: int, device,
                lib: str) -> Tuple[Optional[torch.Tensor], int]:
    """The sort scratch of a launch of library ``lib``'s sorting kernel
    over ``ncell`` cells of ``cap`` slots: (None, 0) up to MAXC_LOCAL
    slots a cell, where the kernel sorts in thread-local arrays; above, a
    row of KEY_ROWS x cap int32 for each thread of a grid-stride launch of
    KEY_BLOCKS_PER_SM 128-thread blocks an SM (fewer for fewer cells):
    (scratch, threads). It is sized by the resident threads, not by the
    cells."""
    _check_key_limits(lib)
    if not 0 < cap <= MAX_SLOTS:
        raise ValueError(f"{cap} slots per cell: the sorting kernels take 1 "
                         f"to {MAX_SLOTS} (a 16-bit slot index)")
    if cap <= MAXC_LOCAL:
        return None, 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    threads = min(-(-ncell // 128), KEY_BLOCKS_PER_SM * sms) * 128
    return torch.empty(threads * KEY_ROWS * cap, dtype=torch.int32,
                       device=device), threads


def _mode(want_chi: bool, photon: bool) -> str:
    if want_chi and photon:
        raise ValueError("cell_step: want_chi and photon exclude each other")
    return "want_chi" if want_chi else ("photon" if photon else "default")


def panel_shape(ncomp: int, nx: int, ny: int, nz: Optional[int] = None,
                tile: Optional[int] = None):
    """Shape of the tile panels of an (nx, ny) or (nx, ny, nz) grid."""
    n = (nx, ny) if nz is None else (nx, ny, nz)
    if tile is None:
        tile = TILE if nz is None else TILE3
    return ((ncomp,) + tuple(-(-k // tile) for k in n)
            + (tile + 4,) * len(n))


def deposit_panels(x, y, ux, uy, uz, inv_gamma, w, *, q: float, dx: float,
                   dy: float, dt: float, with_rho: bool = True,
                   rims_in: Optional[torch.Tensor] = None,
                   tile: int = TILE) -> torch.Tensor:
    """Esirkepov deposit of one species into tile panels, added to
    ``rims_in`` when given."""
    cap, nx, ny = x.shape
    ncomp = 4 if with_rho else 3
    shape = panel_shape(ncomp, nx, ny, tile=tile)
    nbx, nby = shape[1], shape[2]
    panels = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for (ox, oy), cell in deposit_offsets(x, y, ux, uy, uz, inv_gamma, w, q=q,
                                          dx=dx, dy=dy, dt=dt,
                                          with_rho=with_rho):
        cell = F.pad(cell, (0, nby * tile - ny, 0, nbx * tile - nx))
        cell = cell.reshape(ncomp, nbx, tile, nby, tile).permute(0, 1, 3, 2, 4)
        panels[..., 2 + ox:2 + ox + tile, 2 + oy:2 + oy + tile] += cell
    return panels if rims_in is None else rims_in + panels


def fold_panels(panels: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    """Overlap-add tile panels into the padded current (C, nx+4, ny+4),
    guard width 2. Along each axis a panel's first T nodes tile the line
    without overlap and its last 4 nodes land on the next tile's first 4."""
    C, nbx, nby, p, _ = panels.shape
    tile = p - 4
    out = torch.zeros((C, nbx + 1, tile, nby + 1, tile), dtype=panels.dtype,
                      device=panels.device)
    tails = F.pad(panels, (0, tile - 4, 0, tile - 4))   # (C,nbx,nby,2T,2T)
    for sx, (ax0, ax1) in enumerate(((0, tile), (tile, 2 * tile))):
        for sy, (ay0, ay1) in enumerate(((0, tile), (tile, 2 * tile))):
            part = tails[:, :, :, ax0:ax1, ay0:ay1].permute(0, 1, 3, 2, 4)
            out[:, sx:sx + nbx, :, sy:sy + nby, :] += part
    out = out.reshape(C, (nbx + 1) * tile, (nby + 1) * tile)
    return out[:, :nx + 4, :ny + 4]


def deposit_panels_3d(x, y, z, ux, uy, uz, inv_gamma, w, *, q: float,
                      dx: float, dy: float, dz: float, dt: float,
                      with_rho: bool = True,
                      rims_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3D Esirkepov deposit of one species into tile panels
    (C, nbx, nby, nbz, T+4, T+4, T+4), added to ``rims_in`` when given."""
    cap, nx, ny, nz = x.shape
    ncomp = 4 if with_rho else 3
    tile = TILE3
    shape = panel_shape(ncomp, nx, ny, nz)
    nbx, nby, nbz = shape[1:4]
    panels = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for (ox, oy, oz), cell in deposit_offsets_3d(
            x, y, z, ux, uy, uz, inv_gamma, w, q=q, dx=dx, dy=dy, dz=dz,
            dt=dt, with_rho=with_rho):
        cell = F.pad(cell, (0, nbz * tile - nz, 0, nby * tile - ny,
                            0, nbx * tile - nx))
        cell = cell.reshape(ncomp, nbx, tile, nby, tile, nbz, tile
                            ).permute(0, 1, 3, 5, 2, 4, 6)
        panels[..., 2 + ox:2 + ox + tile, 2 + oy:2 + oy + tile,
               2 + oz:2 + oz + tile] += cell
    return panels if rims_in is None else rims_in + panels


def _fold_axis(t: torch.Tensor, dim: int, n: int, tile: int) -> torch.Tensor:
    """Overlap-add along one axis: ``t`` has that axis's block index at
    ``dim`` and its panel node (T+4) at ``dim + 1``; they become one line
    of n+4 nodes at ``dim``. A panel's first T nodes tile the line and its
    last 4 land on the next tile's first 4."""
    nb = t.shape[dim]
    t = t.movedim((dim, dim + 1), (0, 1))
    rest = tuple(t.shape[2:])
    folded = torch.zeros((nb + 1, tile) + rest, dtype=t.dtype,
                         device=t.device)
    folded[:nb] += t[:, :tile]
    folded[1:, :4] += t[:, tile:]
    line = folded.reshape(((nb + 1) * tile,) + rest)[:n + 4]
    return line.movedim(0, dim)


def fold_panels_3d(panels: torch.Tensor, nx: int, ny: int, nz: int
                   ) -> torch.Tensor:
    """Overlap-add 3D tile panels into the padded current
    (C, nx+4, ny+4, nz+4), guard width 2, one axis after another."""
    tile = panels.shape[-1] - 4
    t = panels.permute(0, 1, 4, 2, 5, 3, 6)    # (C, nbx, P, nby, P, nbz, P)
    for dim, n in ((1, nx), (2, ny), (3, nz)):
        t = _fold_axis(t, dim, n, tile)
    return t


def fold_reduce_plain(rims: torch.Tensor, shape: Sequence[int],
                      periodic: Sequence[bool]) -> torch.Tensor:
    """Plain version of kernel B3: the interior current (C,) + ``shape``
    of a grid of ``shape`` cells, (nx, ny) or (nx, ny, nz)."""
    if len(shape) == 2:
        return halo_reduce(fold_panels(rims, *shape), 2, (1, 2), periodic)
    return halo_reduce(fold_panels_3d(rims, *shape), 2, (1, 2, 3), periodic)


def cell_step_plain(eb_pad, data: Dict[str, torch.Tensor], alive, *,
                    q: float, m: float, dt: float, dx: float, dy: float,
                    g: int, periodic: Sequence[bool],
                    rims_in: Optional[torch.Tensor] = None,
                    with_rho: bool = True, dz: Optional[float] = None,
                    want_chi: bool = False, photon: bool = False):
    """Plain version of kernel B2: the JAX package's XLA cell path
    (step.py's cell branch) with the Batcher-order migration, 2D for
    slots (cap, nx, ny) and 3D (with ``dz``) for (cap, nx, ny, nz).
    ``data`` holds the stored (pre-push) state. Returns (data, alive,
    n_lost, rims) with data fully pushed; with ``want_chi`` also
    (chi, ig0), the quantum parameter and inv_gamma at the pre-push
    momenta; with ``photon`` rims is None (the stage reads no field and
    deposits nothing)."""
    _mode(want_chi, photon)
    three_d = alive.ndim == 4
    axes = ("x", "y", "z") if three_d else ("x", "y")
    deltas = (dx, dy, dz) if three_d else (dx, dy)
    h = [c_light * dt / d / 2 for d in deltas]
    moms = ("ux", "uy", "uz")[:len(axes)]
    push_pos = push_position_3d if three_d else push_position_2d

    def pushed(d, ig):
        return push_pos(*(d[a] for a in axes), *(d[k] for k in moms), ig, *h)
    d = dict(data)
    d.update(zip(axes, pushed(d, d["inv_gamma"])))
    d, alive, n_lost = migrate_cells(
        d, alive, tuple(zip(alive.shape[1:], periodic, axes)),
        recompute_ig=not photon)
    if photon:
        ig = photon_push(d["ux"], d["uy"], d["uz"])
        d.update(zip(axes, pushed(d, ig)))
        d["inv_gamma"] = ig
        return d, alive, n_lost, None
    pos = [d[a] for a in axes]
    eb = (gather_cell_3d if three_d else gather_cell_2d)(eb_pad, *pos, g)
    if want_chi:
        ig0 = d["inv_gamma"]
        chi = calculate_chi(*eb, d["ux"], d["uy"], d["uz"], ig0)
    ux, uy, uz, ig = boris_push(d["ux"], d["uy"], d["uz"], *eb, q, m, dt)
    d.update(ux=ux, uy=uy, uz=uz)
    d.update(zip(axes, pushed(d, ig)))
    d["inv_gamma"] = ig
    w = torch.where(alive, d["w"], 0.0)
    kw = dict(q=q, dx=dx, dy=dy, dt=dt, with_rho=with_rho, rims_in=rims_in)
    if three_d:
        rims = deposit_panels_3d(*(d[a] for a in axes), ux, uy, uz, ig, w,
                                 dz=dz, **kw)
    else:
        rims = deposit_panels(*(d[a] for a in axes), ux, uy, uz, ig, w, **kw)
    if want_chi:
        return d, alive, n_lost, rims, (chi, ig0)
    return d, alive, n_lost, rims


@functools.cache
def _check_tile(lib: str = "cellstep") -> None:
    """The panel layout's tile is ``TILE`` (``TILE3`` in 3D) here and a
    constant in csrc/cellstep.cu (csrc/cellstep3d.cu), which sizes the
    panels the kernel writes; hold the two equal once, when the library
    is first used."""
    want = TILE if lib == "cellstep" else TILE3
    got = kernel_lib.library(lib).lp_cell_tile()
    if got != want:
        raise RuntimeError(f"csrc/{kernel_lib.SOURCES[lib]} tiles panels by "
                           f"{got}, ops/cellslab.py by {want}")


_CES: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _ces_tensor(cap: int, device) -> torch.Tensor:
    key = (cap, torch.device(device))
    t = _CES.get(key)
    if t is None:
        pairs = batcher_network(cap) or ((0, 0),)
        t = torch.tensor(pairs, dtype=torch.int32).reshape(-1).to(device)
        _CES[key] = t
    return t


def _pad3(ts) -> list:
    """Pointers of up to MAX_EXTRA extra payloads, None-padded."""
    ts = list(ts)
    return ts + [None] * (MAX_EXTRA - len(ts))


def _cell_step_3d(eb_pad, data, alive, *, q, m, dt, dx, dy, dz, g, periodic,
                  rims_in, with_rho, mode, extra):
    """The 3D launch of kernel B2 (csrc/cellstep3d.cu): x pass into
    buffer A, y pass into buffer B, z pass back into A, then the push in
    place on A (gather + Boris + half push; with want_chi also chi and
    ig0; a photon's 1/|u| + half push) and, but for photons, the deposit
    from A."""
    dev = alive.device
    dtype = data["x"].dtype
    shape = tuple(alive.shape)
    cap, nx, ny, nz = shape
    photon = mode == "photon"
    _check_tile("cellstep3d")
    kernel_lib.check(alive, "alive", shape, torch.bool, dev)
    if not photon:
        kernel_lib.check(eb_pad, "eb_pad",
                         (6, nx + 2 * g, ny + 2 * g, nz + 2 * g), dtype, dev)
    for k in FLOAT_PAYLOADS + ("inv_gamma",) + extra:
        kernel_lib.check(data[k], k, shape, dtype, dev)
    for k in ID_PAYLOADS:
        kernel_lib.check(data[k], k, shape, torch.int32, dev)
    ncomp = 4 if with_rho else 3
    pshape = panel_shape(ncomp, nx, ny, nz)
    if rims_in is not None and not photon:
        kernel_lib.check(rims_in, "rims_in", pshape, dtype, dev)

    def empty(dt_):
        return torch.empty(shape, dtype=dt_, device=dev)

    def slots(n):
        return [empty(dtype) for _ in range(n)]

    a_alive, b_alive = empty(torch.bool), empty(torch.bool)
    a_f, b_f = slots(len(FLOAT_PAYLOADS)), slots(len(FLOAT_PAYLOADS))
    a_x, b_x = slots(len(extra)), slots(len(extra))
    a_ig = empty(dtype)
    a_id = [empty(torch.int32) for _ in ID_PAYLOADS]
    b_id = [empty(torch.int32) for _ in ID_PAYLOADS]
    rims = None if photon else torch.empty(pshape, dtype=dtype, device=dev)
    chi, ig0 = (empty(dtype), empty(dtype)) if mode == "want_chi" \
        else (None, None)
    n_lost = torch.zeros((), dtype=torch.int64, device=dev)
    keys, key_threads = key_scratch(cap, nx * ny * nz, dev, "cellstep3d")
    ptrs = ([None if photon else eb_pad, alive]
            + [data[k] for k in FLOAT_PAYLOADS]
            + [data["inv_gamma"]] + [data[k] for k in ID_PAYLOADS]
            + [a_alive] + a_f + [a_ig] + a_id
            + [b_alive] + b_f + b_id
            + [None if photon else rims_in, rims, n_lost,
               _ces_tensor(cap, dev), chi, ig0]
            + _pad3(data[k] for k in extra) + _pad3(a_x) + _pad3(b_x)
            + [keys])
    cdt = [c_light * dt / d for d in (dx, dy, dz)]
    if photon:
        # q = m = 0: no Boris factors (q / m is undefined) and no deposit
        force = [0.0] * 9
    else:
        force = [q * dt / (2 * m * c_light), q * dt / (2 * m), cdt[0], cdt[1],
                 cdt[2], q / (dx * dy * dz), q / (dy * dz * dt),
                 q / (dx * dz * dt), q / (dx * dy * dt)]
    kernel_lib.call(
        "cellstep3d", "lp_cell_step_3d", ptrs,
        [cap, nx, ny, nz, g, periodic[0], periodic[1], periodic[2], ncomp,
         len(batcher_network(cap)), dtype == torch.float64,
         MODES.index(mode), len(extra), key_threads],
        [cdt[0] / 2, cdt[1] / 2, cdt[2] / 2] + force + [c_light, CHI_FACTOR],
        dev)
    out = dict(data)
    out.update(zip(FLOAT_PAYLOADS, a_f))
    out.update(zip(ID_PAYLOADS, a_id))
    out.update(zip(extra, a_x))
    out["inv_gamma"] = a_ig
    if chi is not None:
        return out, a_alive, n_lost, rims, (chi, ig0)
    return out, a_alive, n_lost, rims


def cell_step(eb_pad, data: Dict[str, torch.Tensor], alive, *, q: float,
              m: float, dt: float, dx: float, dy: float, g: int,
              periodic: Sequence[bool],
              rims_in: Optional[torch.Tensor] = None, with_rho: bool = True,
              dz: Optional[float] = None, want_chi: bool = False,
              photon: bool = False):
    """One species' particle stage through kernel B2 (see
    ``cell_step_plain`` for the arguments and results). In ``photon``
    mode ``eb_pad`` and ``rims_in`` are not read (either may be None) and
    no deposit runs."""
    if alive.device.type == "cpu":
        return cell_step_plain(eb_pad, data, alive, q=q, m=m, dt=dt, dx=dx,
                               dy=dy, g=g, periodic=periodic, rims_in=rims_in,
                               with_rho=with_rho, dz=dz, want_chi=want_chi,
                               photon=photon)
    if alive.device.type != "cuda":
        raise ValueError(f"cell_step: unsupported device {alive.device}")
    mode = _mode(want_chi, photon)
    dev = alive.device
    dtype = data["x"].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"cell_step: dtype {dtype}")
    extra = extra_payloads(data)
    if len(extra) > MAX_EXTRA:
        raise ValueError(f"cell_step: {len(extra)} extra payloads {extra}; "
                         f"the kernel carries at most {MAX_EXTRA}")
    if alive.ndim == 4:
        outs = _cell_step_3d(eb_pad, data, alive, q=q, m=m, dt=dt, dx=dx,
                             dy=dy, dz=dz, g=g, periodic=periodic,
                             rims_in=rims_in, with_rho=with_rho, mode=mode,
                             extra=extra)
        cell_step.launches += 1
        cell_step.launches_by_mode[mode] += 1
        return outs
    cap, nx, ny = alive.shape
    _check_tile()
    shape = (cap, nx, ny)
    kernel_lib.check(alive, "alive", shape, torch.bool, dev)
    if not photon:
        kernel_lib.check(eb_pad, "eb_pad", (6, nx + 2 * g, ny + 2 * g),
                         dtype, dev)
    for k in FLOAT_PAYLOADS + ("inv_gamma",) + extra:
        kernel_lib.check(data[k], k, shape, dtype, dev)
    for k in ID_PAYLOADS:
        kernel_lib.check(data[k], k, shape, torch.int32, dev)
    ncomp = 4 if with_rho else 3
    pshape = panel_shape(ncomp, nx, ny)
    if rims_in is not None and not photon:
        kernel_lib.check(rims_in, "rims_in", pshape, dtype, dev)

    def empty(dt_):
        return torch.empty(shape, dtype=dt_, device=dev)

    def slots(n):
        return [empty(dtype) for _ in range(n)]

    s_alive, o_alive = empty(torch.bool), empty(torch.bool)
    s_f, o_f = slots(len(FLOAT_PAYLOADS)), slots(len(FLOAT_PAYLOADS))
    s_x, o_x = slots(len(extra)), slots(len(extra))
    s_id = [empty(torch.int32) for _ in ID_PAYLOADS]
    o_id = [empty(torch.int32) for _ in ID_PAYLOADS]
    o_ig = empty(dtype)
    rims = None if photon else torch.empty(pshape, dtype=dtype, device=dev)
    chi, ig0 = (empty(dtype), empty(dtype)) if want_chi else (None, None)
    n_lost = torch.zeros((), dtype=torch.int64, device=dev)
    ces = _ces_tensor(cap, dev)
    keys, key_threads = key_scratch(cap, nx * ny, dev, "cellstep")
    ptrs = ([None if photon else eb_pad, alive]
            + [data[k] for k in FLOAT_PAYLOADS]
            + [data["inv_gamma"]] + [data[k] for k in ID_PAYLOADS]
            + [s_alive] + s_f + s_id
            + [o_alive] + o_f + [o_ig] + o_id
            + [None if photon else rims_in, rims, n_lost, ces, chi, ig0]
            + _pad3(data[k] for k in extra) + _pad3(s_x) + _pad3(o_x)
            + [keys])
    cdx, cdy = c_light * dt / dx, c_light * dt / dy
    if photon:
        # q = m = 0: no Boris factors (q / m is undefined) and no deposit
        force = [0.0] * 8
    else:
        force = [q * dt / (2 * m * c_light), q * dt / (2 * m), cdx, cdy,
                 c_light, q / (dx * dy), q / (dy * dt), q / (dx * dt)]
    kernel_lib.call(
        "cellstep", "lp_cell_step", ptrs,
        [cap, nx, ny, g, periodic[0], periodic[1], ncomp,
         len(batcher_network(cap)), dtype == torch.float64,
         MODES.index(mode), len(extra), key_threads],
        [cdx / 2, cdy / 2] + force + [CHI_FACTOR],
        dev)
    cell_step.launches += 1
    cell_step.launches_by_mode[mode] += 1
    out = dict(data)
    out.update(zip(FLOAT_PAYLOADS, o_f))
    out.update(zip(ID_PAYLOADS, o_id))
    out.update(zip(extra, o_x))
    out["inv_gamma"] = o_ig
    if want_chi:
        return out, o_alive, n_lost, rims, (chi, ig0)
    return out, o_alive, n_lost, rims


cell_step.launches = 0
cell_step.launches_by_mode = dict.fromkeys(MODES, 0)


def fold_reduce(rims: torch.Tensor, shape: Sequence[int],
                periodic: Sequence[bool]) -> torch.Tensor:
    """Species-summed panels -> interior current (C,) + ``shape`` of a
    grid of ``shape`` cells, (nx, ny) or (nx, ny, nz), through kernel B3."""
    if rims.device.type == "cpu":
        return fold_reduce_plain(rims, shape, periodic)
    if rims.device.type != "cuda":
        raise ValueError(f"fold_reduce: unsupported device {rims.device}")
    shape = tuple(shape)
    if len(shape) not in (2, 3) or len(periodic) != len(shape):
        raise ValueError(f"fold_reduce: shape {shape} and periodic "
                         f"{tuple(periodic)} must both name 2 or 3 axes")
    C = rims.shape[0]
    kernel_lib.check(rims, "rims", panel_shape(C, *shape), rims.dtype,
                     rims.device)
    out = torch.empty((C,) + shape, dtype=rims.dtype, device=rims.device)
    f64 = rims.dtype == torch.float64
    if len(shape) == 3:
        kernel_lib.call("fold3d", "lp_fold_3d", [rims, out],
                        [C, *shape, TILE3, *periodic, f64], [], rims.device)
    else:
        kernel_lib.call("fold", "lp_fold", [rims, out],
                        [C, *shape, TILE, *periodic, f64], [], rims.device)
    fold_reduce.launches += 1
    return out


fold_reduce.launches = 0
