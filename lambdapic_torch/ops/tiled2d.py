"""The tile-binned 2D particle engine's plain PyTorch operations
(counterpart of lambdapic_tpu/ops/tiled2d.py).

Particles sit in (TX, TY)-cell tiles with a fixed per-tile capacity:
every particle array is ``(ntx, nty, cap_t)``, the slot axis last. Each
tile sees a halo'd window of ``(TX + 2h, TY + 2h)`` field nodes, padded
array index ``k * T + c`` for window node ``c`` of tile ``k``.

- ``extract_windows`` / ``fold_windows`` cut the padded fields into the
  tiles' windows and overlap-add per-tile current windows back;
- ``gather_tiled`` and ``deposit_tiled`` are the staggered quadratic
  gather and the Esirkepov deposit written as dense per-tile
  contractions of B-spline tap matrices W[c, p] = M2(c - x_p). They are
  the plain versions of kernels B8 and B9 (``ops/tiled2d_kernels.py``);
- ``migrate_tiled`` re-bins particles that left their tile (the slab
  formulation: one stable sort per axis with a 5-way key, end slabs that
  roll one tile over, arrivals that overwrite them), and
  ``insert_tiled`` merges QED newborns into their parents' tiles.

On one device a periodic axis rolls with the +-nloc wrap adjust; on an
open axis the wrapped slab arrives invalid, so particles that leave the
domain vanish without being counted (as on the JAX package's one-device
mesh). Sorts are ``torch.sort(stable=True)``, which keeps the JAX
package's slot order (its ``lax.sort`` is stable on the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import torch

from ..constants import c as c_light
from .cell2d import _m2, _scalar, _u32_to_i32

# attributes rewritten before any read after a re-binning: the gathered
# fields (a fresh gather each step) and chi (recomputed by the QED
# update); they stay in place through the merge sorts
_TRANSIENT = frozenset({"ex_part", "ey_part", "ez_part", "bx_part",
                        "by_part", "bz_part", "chi"})
# attributes zeroed in dead slots (inv_gamma is set to 1)
_SANITIZED = ("x", "y", "z", "w", "ux", "uy", "uz", "tau", "event")


@dataclass(frozen=True)
class TileCfg:
    """Static tiling of the one device: tile size (tx, ty), tile counts
    (ntx, nty), slots a tile ``cap_t`` and halo ``h`` (= n_guard)."""

    tx: int
    ty: int
    ntx: int
    nty: int
    cap_t: int
    h: int = 3

    @property
    def wx(self) -> int:
        return self.tx + 2 * self.h

    @property
    def wy(self) -> int:
        return self.ty + 2 * self.h


# the quadratic B-spline M2(d), support |d| < 1.5
bspline2 = _m2


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

def extract_windows(fpad: torch.Tensor, cfg: TileCfg) -> torch.Tensor:
    """(C, nx+2h, ny+2h) -> (C, ntx, nty, wx, wy): window (i, j) is
    fpad[:, i*tx : i*tx+wx, j*ty : j*ty+wy]."""
    return fpad.unfold(1, cfg.wx, cfg.tx).unfold(2, cfg.wy, cfg.ty
                                                 ).contiguous()


def _fold_axis(blocks: torch.Tensor, axis: int, n: int, t: int, h: int
               ) -> torch.Tensor:
    """Overlap-add along one tile axis: (..., nt, t+2h, ...) with the
    tile axis at ``axis`` -> (..., n+2h, ...). Each window is split into
    two t-wide halves laid out with hop t (t >= 2h), and the two halves'
    arrays are added in turn, as the JAX package adds them."""
    if t < 2 * h:
        raise ValueError("tile size must be >= 2*halo")
    w = t + 2 * h
    pad = [0, 0] * (blocks.ndim - axis - 2) + [0, 2 * t - w]
    bp = torch.nn.functional.pad(blocks, pad)
    head = tuple(blocks.shape[:axis])
    tail = tuple(blocks.shape[axis + 2:])
    A = bp.narrow(axis + 1, 0, t).reshape(head + (n,) + tail)
    B = bp.narrow(axis + 1, t, t).reshape(head + (n,) + tail)
    L = n + 2 * h
    out = torch.zeros(head + (L,) + tail, dtype=blocks.dtype,
                      device=blocks.device)
    out.narrow(axis, 0, n).add_(A)
    out.narrow(axis, t, L - t).add_(B.narrow(axis, 0, L - t))
    return out


def fold_windows(win: torch.Tensor, cfg: TileCfg) -> torch.Tensor:
    """(C, ntx, nty, wx, wy) -> (C, nx+2h, ny+2h) by overlap-add."""
    nx, ny = cfg.ntx * cfg.tx, cfg.nty * cfg.ty
    w = win.permute(0, 1, 3, 2, 4)                    # (C, ntx, wx, nty, wy)
    w = _fold_axis(w, 3, ny, cfg.ty, cfg.h)           # (C, ntx, wx, ny+2h)
    return _fold_axis(w, 1, nx, cfg.tx, cfg.h)        # (C, nx+2h, ny+2h)


# ---------------------------------------------------------------------------
# taps
# ---------------------------------------------------------------------------

def _tile_coords(x, y, cfg: TileCfg):
    """Device-local cell coordinates -> window coordinates (window node c
    of tile k is local cell k*T - h + c)."""
    ox = (torch.arange(cfg.ntx, dtype=x.dtype, device=x.device)
          * cfg.tx)[:, None, None]
    oy = (torch.arange(cfg.nty, dtype=y.dtype, device=y.device)
          * cfg.ty)[None, :, None]
    return x - ox + cfg.h, y - oy + cfg.h


def _taps(xw: torch.Tensor, n_w: int, shift: float = 0.0) -> torch.Tensor:
    """Dense taps (..., n_w, cap_t): W[c, p] = M2(c + shift - xw_p)."""
    cg = torch.arange(n_w, dtype=xw.dtype, device=xw.device).reshape(
        (1,) * (xw.ndim - 1) + (n_w, 1))
    return bspline2(cg + shift - xw[..., None, :])


# ---------------------------------------------------------------------------
# gather (plain version of kernel B8)
# ---------------------------------------------------------------------------

def gather_tiled(windows: torch.Tensor, x, y, cfg: TileCfg):
    """windows (6, ntx, nty, wx, wy) of (ex, ey, ez, bx, by, bz); x, y
    (ntx, nty, cap_t) device-local cell coordinates. Returns the six
    gathered components, each (ntx, nty, cap_t): integer taps M2(c - x),
    half taps M2(c + 0.5 - x) (a field stored at c + 0.5)."""
    xw, yw = _tile_coords(x, y, cfg)
    gx = _taps(xw, cfg.wx, 0.0)          # (ntx, nty, wx, cap)
    hx = _taps(xw, cfg.wx, 0.5)
    gy = _taps(yw, cfg.wy, 0.0)
    hy = _taps(yw, cfg.wy, 0.5)

    def interp(F, Wx, Wy):
        # tmp[x, p] = sum_y F[x, y] Wy[y, p], per tile
        return torch.sum(Wx * torch.matmul(F, Wy), dim=2)

    ex, ey, ez, bx, by, bz = windows
    return (interp(ex, hx, gy), interp(ey, gx, hy), interp(ez, gx, gy),
            interp(bx, gx, hy), interp(by, hx, gy), interp(bz, hx, hy))


# ---------------------------------------------------------------------------
# Esirkepov deposit (plain version of kernel B9)
# ---------------------------------------------------------------------------

def deposit_tiled(x, y, ux, uy, uz, inv_gamma, w, cfg: TileCfg, *,
                  q: float, dx: float, dy: float, dt: float) -> torch.Tensor:
    """Charge-conserving deposit into per-tile windows: (4, ntx, nty, wx,
    wy) = (jx, jy, jz, rho); ``fold_windows`` and the guard reduction
    complete it. Separable closed forms:
        jx = Fx^T b,  Fx = -q w/(dy dt) cumsum(DSx)
        jy = a^T Gy,  Gy = -q w/(dx dt) cumsum(DSy)
        jz = q w vz/(dx dy) (a^T b + DSx^T DSy / 12)
        rho = q w/(dx dy) S1x^T S1y
    with S0/S1 the shapes at x -/+ v dt/2, DS = S1 - S0, a = S0x + DSx/2,
    b = S0y + DSy/2. Dead slots carry w = 0."""
    vx_c = ux * inv_gamma * _scalar(c_light * dt / dx, x)
    vy_c = uy * inv_gamma * _scalar(c_light * dt / dy, x)
    vz = uz * inv_gamma * _scalar(c_light, x)

    xw, yw = _tile_coords(x, y, cfg)
    s0x = _taps(xw - 0.5 * vx_c, cfg.wx)      # (ntx, nty, wx, cap)
    s1x = _taps(xw + 0.5 * vx_c, cfg.wx)
    s0y = _taps(yw - 0.5 * vy_c, cfg.wy)
    s1y = _taps(yw + 0.5 * vy_c, cfg.wy)
    dsx = s1x - s0x
    dsy = s1y - s0y

    cd = _scalar(q / (dx * dy), x) * w        # (ntx, nty, cap)
    fdx = _scalar(q / (dy * dt), x) * w
    fdy = _scalar(q / (dx * dt), x) * w

    a = s0x + 0.5 * dsx
    b = s0y + 0.5 * dsy
    fx = -fdx[:, :, None, :] * torch.cumsum(dsx, dim=2)
    gy = -fdy[:, :, None, :] * torch.cumsum(dsy, dim=2)

    def outer(u, v):
        # (..., wx, cap) x (..., wy, cap) -> (..., wx, wy), over cap
        return torch.matmul(u, v.transpose(-1, -2))

    cvz = cd * vz
    jx_w = outer(fx, b)
    jy_w = outer(a, gy)
    jz_w = outer(a * cvz[:, :, None, :], b) + outer(
        dsx * (cvz / 12.0)[:, :, None, :], dsy)
    rho_w = outer(s1x * cd[:, :, None, :], s1y)
    return torch.stack([jx_w, jy_w, jz_w, rho_w], dim=0)


# ---------------------------------------------------------------------------
# re-binning between tiles
# ---------------------------------------------------------------------------

def _sanitize_tiled(data: Dict[str, torch.Tensor], alive: torch.Tensor):
    """Dead slots: w = 0, positions and momenta 0, inv_gamma 1."""
    data = dict(data)
    for k in _SANITIZED:
        if k in data:
            data[k] = torch.where(alive, data[k], torch.zeros_like(data[k]))
    data["inv_gamma"] = torch.where(alive, data["inv_gamma"],
                                    torch.ones_like(data["inv_gamma"]))
    return data


def migrate_tiled(data: Dict[str, torch.Tensor], alive: torch.Tensor,
                  cfg: TileCfg, periodic: Sequence[bool], nx_loc: int,
                  ny_loc: int, *, recompute_ig: bool = False):
    """Re-bin particles to their home tiles, the slab formulation. Per
    axis, one stable cap_t-wide sort with the 5-way key

        0: donor(+1)   1: dead(even slot)   2: stay
        3: dead(odd)   4: donor(-1)

    packs +1-donors into the front slab [0:m] and -1-donors into the back
    slab [cap-m:] (m = max(8, cap/8)). The slabs roll one tile over and
    arrivals overwrite the receiver's end slabs. Donors beyond m, and
    survivors an arrival overwrites, are counted in n_lost. With
    ``recompute_ig`` (non-photon species) inv_gamma is recomputed as
    1/sqrt(1 + u^2) instead of carried. Returns (data, alive, n_lost)."""
    cap = alive.shape[-1]
    dev = alive.device
    m = max(8, cap // 8)
    n_lost = torch.zeros((), dtype=torch.int64, device=dev)
    skip = set(_TRANSIENT) | ({"inv_gamma"} if recompute_ig else set())
    names = sorted(k for k in data if k not in skip)
    parity = (torch.arange(cap, device=dev) & 1) == 0

    plan = ((cfg.tx, cfg.ntx, nx_loc, periodic[0], "x"),
            (cfg.ty, cfg.nty, ny_loc, periodic[1], "y"))
    for axis, (t, nt, nloc, per, coord) in enumerate(plan):
        pos = data[coord]
        origin = (torch.arange(nt, dtype=pos.dtype, device=dev) * t)
        origin = origin[:, None, None] if axis == 0 else origin[None, :, None]
        local = pos - origin
        out_hi = alive & (local >= t - 0.5)          # -> tile + 1
        out_lo = alive & (local < -0.5)              # -> tile - 1
        key = torch.where(out_hi, 0, torch.where(
            out_lo, 4, torch.where(alive, 2, torch.where(parity, 1, 3))))
        skey, order = torch.sort(key.to(torch.int32), dim=-1, stable=True)
        sdata = {k: torch.gather(data[k], -1, order) for k in names}

        # donors that did not fit in their slab are lost
        n_lost = n_lost + (skey[..., m:] == 0).sum() \
            + (skey[..., :cap - m] == 4).sum()

        def send(sl, valid, direction):
            """Roll an m-slab one tile over: the wrapped row gets the
            +-nloc coordinate adjust (periodic) or arrives invalid
            (open)."""
            tile = torch.arange(nt, device=dev)
            tile = tile[:, None, None] if axis == 0 else tile[None, :, None]
            from_wrap = tile == (0 if direction > 0 else nt - 1)
            moved = {k: torch.roll(v, direction, dims=axis)
                     for k, v in sl.items()}
            valid_m = torch.roll(valid, direction, dims=axis)
            adj = -nloc if direction > 0 else nloc
            moved[coord] = torch.where(from_wrap, moved[coord] + adj,
                                       moved[coord])
            if not per:
                valid_m = valid_m & ~from_wrap
            return moved, valid_m

        in_lo, val_lo = send({k: v[..., :m] for k, v in sdata.items()},
                             skey[..., :m] == 0, +1)
        in_hi, val_hi = send({k: v[..., cap - m:] for k, v in sdata.items()},
                             skey[..., cap - m:] == 4, -1)

        # arrivals merge into the end slabs: stays there are packed away
        # from the arrivals, so the two collide only on overflow, which
        # loses the stay and is counted
        stay_lo = skey[..., :m] == 2
        stay_hi = skey[..., cap - m:] == 2
        n_lost = n_lost + (stay_lo & val_lo).sum() + (stay_hi & val_hi).sum()
        mid_alive = skey[..., m:cap - m] == 2
        data = {k: torch.cat(
                    [torch.where(val_lo, in_lo[k].to(v.dtype),
                                 sdata[k][..., :m]),
                     sdata[k][..., m:cap - m],
                     torch.where(val_hi, in_hi[k].to(v.dtype),
                                 sdata[k][..., cap - m:])], dim=-1)
                if k in sdata else v
                for k, v in data.items()}
        alive = torch.cat([val_lo | stay_lo, mid_alive, val_hi | stay_hi],
                          dim=-1)

    if recompute_ig:
        # boris_push's expression, so the value equals the carried one
        data["inv_gamma"] = 1.0 / torch.sqrt(
            1.0 + data["ux"]**2 + data["uy"]**2 + data["uz"]**2)
    return _sanitize_tiled(data, alive), alive, n_lost


def insert_tiled(data: Dict[str, torch.Tensor], alive: torch.Tensor,
                 next_id: torch.Tensor, new_vals: Dict[str, torch.Tensor],
                 valid: torch.Tensor):
    """Tile-aligned in-step creation (QED photon birth). A newborn sits at
    its parent's slot in the parent species' layout and shares its
    parent's position, so its home tile is the parent's: each tile merges
    (child survivors, newborns) by one stable sort on the key (alive 0,
    newborn 1, other 2) over the concatenated 2 x cap_t slots and keeps
    the first cap_t.

    data/alive: child species, (ntx, nty, cap_t); new_vals/valid:
    (ntx, nty, cap_src) at the parent's slots. Ids are sequential from
    ``next_id`` in (tile, slot) order; id_hi is 0 (the one device). Keys
    of ``data`` absent from ``new_vals`` start at 0 (inv_gamma at 1).
    Returns (data, alive, next_id, n_lost): newborns beyond their tile's
    free slots are dropped and counted."""
    cap_t = alive.shape[-1]
    vi = valid.to(torch.int64)
    intra = torch.cumsum(vi, dim=-1) - vi                # exclusive, per tile
    counts = vi.sum(-1)                                  # (ntx, nty)
    flat = counts.reshape(-1)
    base = (torch.cumsum(flat, 0) - flat).reshape(counts.shape)
    ids = _u32_to_i32(next_id + base[..., None] + intra)

    keys = torch.cat([torch.where(alive, 0, 2), torch.where(valid, 1, 2)],
                     dim=-1).to(torch.int32)
    skeys, order = torch.sort(keys, dim=-1, stable=True)
    out = {}
    for k in sorted(data):
        arr = data[k]
        if k == "id_lo":
            nv = ids
        elif k == "id_hi":
            nv = torch.zeros(valid.shape, dtype=arr.dtype, device=arr.device)
        elif k in new_vals:
            nv = torch.where(valid, new_vals[k].to(arr.dtype), 0)
        elif k == "inv_gamma":
            nv = torch.ones(valid.shape, dtype=arr.dtype, device=arr.device)
        else:
            nv = torch.zeros(valid.shape, dtype=arr.dtype, device=arr.device)
        both = torch.cat([arr, nv.to(arr.dtype)], dim=-1)
        out[k] = torch.gather(both, -1, order[..., :cap_t])
    n_lost = (skeys[..., cap_t:] < 2).sum()
    return (out, skeys[..., :cap_t] < 2, (next_id + counts.sum()) & 0xFFFFFFFF,
            n_lost)
