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

On a device mesh (K4, K5): ``cell_step`` also runs one dispatch of the
stage on one shard (neighbour edge columns in place of a wrap, a subset
of the re-binning axes, with or without the tail), ``cell_step_mesh``
drives the dispatches over every shard with the edge exchanges between
them, and ``fold_reduce`` with a mesh folds each shard's panels and adds
the neighbours' guard strips; ``launches_by_dispatch`` and
``fold_reduce.launches_by_kind`` count those launches.

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


def fold_reduce_plain(rims, shape: Sequence[int], periodic: Sequence[bool],
                      mesh=None, specs=None):
    """Plain version of kernel B3: the interior current (C,) + ``shape``
    of a grid (or, on a mesh, a shard) of ``shape`` cells, (nx, ny) or
    (nx, ny, nz). With ``mesh`` ``rims`` is a list of per-shard panels and
    the guard rims go to the neighbour shards through ``halo_reduce``
    with ``specs`` (``periodic`` is not read); returns the shards'
    interior currents."""
    fold = fold_panels if len(shape) == 2 else fold_panels_3d
    axes = tuple(range(1, len(shape) + 1))
    if mesh is None:
        return halo_reduce(fold(rims, *shape), 2, axes, periodic)
    return halo_reduce([fold(r, *shape) for r in rims], 2, axes, specs, mesh)


def _merge_axes(nd: int, merge_axes, tail: bool) -> Tuple[int, ...]:
    axes = tuple(range(nd)) if merge_axes is None else tuple(merge_axes)
    if not axes or list(axes) != list(range(axes[0], axes[-1] + 1)) \
            or axes[-1] >= nd or (tail and axes[-1] != nd - 1) \
            or (not tail and axes[-1] == nd - 1):
        raise ValueError(f"cell_step: merge_axes {axes} with tail={tail} "
                         f"on {nd} axes (consecutive axes; the tail "
                         "dispatch ends with the last axis, no other does)")
    return axes


def cell_step_plain(eb_pad, data: Dict[str, torch.Tensor], alive, *,
                    q: float, m: float, dt: float, dx: float, dy: float,
                    g: int, periodic: Sequence[bool],
                    rims_in: Optional[torch.Tensor] = None,
                    with_rho: bool = True, dz: Optional[float] = None,
                    want_chi: bool = False, photon: bool = False,
                    edges_lo: Optional[Dict[str, torch.Tensor]] = None,
                    edges_hi: Optional[Dict[str, torch.Tensor]] = None,
                    merge_axes: Optional[Sequence[int]] = None,
                    tail: bool = True, yz_edges=None):
    """Plain version of kernel B2: the JAX package's XLA cell path
    (step.py's cell branch) with the Batcher-order migration, 2D for
    slots (cap, nx, ny) and 3D (with ``dz``) for (cap, nx, ny, nz).
    ``data`` holds the stored (pre-push) state. Returns (data, alive,
    n_lost, rims) with data fully pushed; with ``want_chi`` also
    (chi, ig0), the quantum parameter and inv_gamma at the pre-push
    momenta; with ``photon`` rims is None (the stage reads no field and
    deposits nothing).

    On a device mesh one call is one dispatch on one shard (the JAX
    package's ``unified_cell_step`` arguments of the same names):

    - ``edges_lo`` / ``edges_hi``: the x neighbours' edge columns of the
      stored state (``cell2d.migrate_cells``' edge dicts, with
      inv_gamma: their first half push is applied here) in place of the
      x wrap;
    - ``merge_axes``: the axes this dispatch re-bins (default all); a
      dispatch that starts with x applies the first half push;
    - ``tail=False``: stop after the re-binning and return (data, alive,
      n_lost), dead slots and inv_gamma left for the next dispatch;
    - ``yz_edges`` = (axis, lo, hi): the neighbours' edge columns of
      that axis (the first of ``merge_axes``) from their previous
      dispatch's output.
    """
    _mode(want_chi, photon)
    three_d = alive.ndim == 4
    axes = ("x", "y", "z") if three_d else ("x", "y")
    deltas = (dx, dy, dz) if three_d else (dx, dy)
    h = [c_light * dt / d / 2 for d in deltas]
    moms = ("ux", "uy", "uz")[:len(axes)]
    push_pos = push_position_3d if three_d else push_position_2d
    merge = _merge_axes(len(axes), merge_axes, tail)

    def pushed(d, ig):
        return push_pos(*(d[a] for a in axes), *(d[k] for k in moms), ig, *h)
    d = dict(data)
    edges = {}
    if merge[0] == 0:
        d.update(zip(axes, pushed(d, d["inv_gamma"])))
        if edges_lo is not None:
            edges[0] = tuple({**e, **dict(zip(axes, pushed(e, e["inv_gamma"])))}
                             for e in (edges_lo, edges_hi))
    if yz_edges is not None:
        edges[yz_edges[0]] = tuple(yz_edges[1:])
    d, alive, n_lost = migrate_cells(
        d, alive, tuple((alive.shape[1 + a], periodic[a], axes[a])
                        for a in merge),
        recompute_ig=not photon, edges=edges, finish=tail)
    if not tail:
        return d, alive, n_lost
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


EDGE_PTRS = 14          # csrc/cellstep*.cu's Edge: alive, 7 floats, ig, ids, 3


def _edge_ptrs(edge: Optional[Dict[str, torch.Tensor]], shape, extra,
               dtype, dev, with_ig: bool) -> list:
    """The kernel's pointers of one neighbour edge (see ``edge_columns``),
    checked against its shape, or EDGE_PTRS None."""
    if edge is None:
        return [None] * EDGE_PTRS
    kernel_lib.check(edge["alive"], "edge alive", shape, torch.int32, dev)
    floats = FLOAT_PAYLOADS + (("inv_gamma",) if with_ig else ()) + extra
    for k in floats:
        kernel_lib.check(edge[k], f"edge {k}", shape, dtype, dev)
    for k in ID_PAYLOADS:
        kernel_lib.check(edge[k], f"edge {k}", shape, torch.int32, dev)
    return ([edge["alive"]] + [edge[k] for k in FLOAT_PAYLOADS]
            + [edge["inv_gamma"] if with_ig else None]
            + [edge[k] for k in ID_PAYLOADS] + _pad3(edge[k] for k in extra))


def _edge_shape(shape, axis: int):
    s = list(shape)
    s[1 + axis] = 1
    return tuple(s)


def _cell_step_3d(eb_pad, data, alive, *, q, m, dt, dx, dy, dz, g, periodic,
                  rims_in, with_rho, mode, extra, merge, tail, edges):
    """The 3D launch of kernel B2 (csrc/cellstep3d.cu): the re-binning
    passes of the axes ``merge`` (the whole stage: x into buffer A, y into
    buffer B, z back into A), then with ``tail`` the tile kernel in place
    on A (gather from a shared E/B window + Boris + half push + deposit
    into the tile's panel; with want_chi also chi and ig0), or for
    photons the per-slot 1/|u| + half push. ``edges``: axis -> (lo, hi)
    neighbour edges."""
    dev = alive.device
    dtype = data["x"].dtype
    shape = tuple(alive.shape)
    cap, nx, ny, nz = shape
    photon = mode == "photon"
    _check_tile("cellstep3d")
    kernel_lib.check(alive, "alive", shape, torch.bool, dev)
    if tail and not photon:
        if g < 2:
            raise ValueError(f"cell_step: {g} guard cells; the 3D kernel's "
                             "gather window reaches 2 cells below a tile")
        kernel_lib.check(eb_pad, "eb_pad",
                         (6, nx + 2 * g, ny + 2 * g, nz + 2 * g), dtype, dev)
    first = merge[0] == 0
    for k in FLOAT_PAYLOADS + (("inv_gamma",) if first else ()) + extra:
        kernel_lib.check(data[k], k, shape, dtype, dev)
    for k in ID_PAYLOADS:
        kernel_lib.check(data[k], k, shape, torch.int32, dev)
    ncomp = 4 if with_rho else 3
    pshape = panel_shape(ncomp, nx, ny, nz)
    if rims_in is not None and tail and not photon:
        kernel_lib.check(rims_in, "rims_in", pshape, dtype, dev)

    def empty(dt_):
        return torch.empty(shape, dtype=dt_, device=dev)

    def slots(n):
        return [empty(dtype) for _ in range(n)]

    def none(n):
        return [None] * n

    two = len(merge) > 1              # a second buffer is passed through
    a_alive = empty(torch.bool)
    b_alive = empty(torch.bool) if two else None
    a_f = slots(len(FLOAT_PAYLOADS))
    b_f = slots(len(FLOAT_PAYLOADS)) if two else none(len(FLOAT_PAYLOADS))
    a_x = slots(len(extra))
    b_x = slots(len(extra)) if two else []
    a_ig = empty(dtype) if tail else None
    a_id = [empty(torch.int32) for _ in ID_PAYLOADS]
    b_id = [empty(torch.int32) for _ in ID_PAYLOADS] if two else none(2)
    rims = torch.empty(pshape, dtype=dtype, device=dev) \
        if tail and not photon else None
    chi, ig0 = (empty(dtype), empty(dtype)) if mode == "want_chi" and tail \
        else (None, None)
    n_lost = torch.zeros((), dtype=torch.int64, device=dev)
    keys, key_threads = key_scratch(cap, nx * ny * nz, dev, "cellstep3d")
    eptrs = []
    for ax in range(3):
        lo, hi = edges.get(ax, (None, None))
        esh = _edge_shape(shape, ax)
        eptrs += (_edge_ptrs(lo, esh, extra, dtype, dev, ax == 0)
                  + _edge_ptrs(hi, esh, extra, dtype, dev, ax == 0))
    ptrs = ([eb_pad if tail and not photon else None, alive]
            + [data[k] for k in FLOAT_PAYLOADS]
            + [data["inv_gamma"] if first else None]
            + [data[k] for k in ID_PAYLOADS]
            + [a_alive] + a_f + [a_ig] + a_id
            + [b_alive] + b_f + b_id
            + [rims_in if tail and not photon else None, rims, n_lost,
               _ces_tensor(cap, dev), chi, ig0]
            + _pad3(data[k] for k in extra) + _pad3(a_x) + _pad3(b_x)
            + [keys] + eptrs)
    cdt = [c_light * dt / d for d in (dx, dy, dz)]
    if photon:
        # q = m = 0: no Boris factors (q / m is undefined) and no deposit
        force = [0.0] * 9
    else:
        force = [q * dt / (2 * m * c_light), q * dt / (2 * m), cdt[0], cdt[1],
                 cdt[2], q / (dx * dy * dz), q / (dy * dz * dt),
                 q / (dx * dz * dt), q / (dx * dy * dt)]
    edge_axes = sum(1 << ax for ax in edges)
    kernel_lib.call(
        "cellstep3d", "lp_cell_step_3d", ptrs,
        [cap, nx, ny, nz, g, periodic[0], periodic[1], periodic[2], ncomp,
         len(batcher_network(cap)), dtype == torch.float64,
         MODES.index(mode), len(extra), key_threads, merge[0], merge[-1],
         int(tail), edge_axes],
        [cdt[0] / 2, cdt[1] / 2, cdt[2] / 2] + force + [c_light, CHI_FACTOR],
        dev)
    out = dict(data)
    out.update(zip(FLOAT_PAYLOADS, a_f))
    out.update(zip(ID_PAYLOADS, a_id))
    out.update(zip(extra, a_x))
    if not tail:
        out.pop("inv_gamma", None)
        return out, a_alive, n_lost
    out["inv_gamma"] = a_ig
    if chi is not None:
        return out, a_alive, n_lost, rims, (chi, ig0)
    return out, a_alive, n_lost, rims


def _cell_step_2d(eb_pad, data, alive, *, q, m, dt, dx, dy, g, periodic,
                  rims_in, with_rho, mode, extra, merge, tail, edges):
    """The 2D launch of kernel B2 (csrc/cellstep.cu): pass_x into the
    scratch slots, pass_y (with the push) into the output slots, the
    deposit; on a mesh the dispatch's part of it (x alone, whose output
    is the scratch, or y with the tail, reading its input through the
    scratch pointers). ``edges``: axis -> (lo, hi) neighbour edges."""
    dev = alive.device
    dtype = data["x"].dtype
    cap, nx, ny = alive.shape
    photon = mode == "photon"
    _check_tile()
    shape = (cap, nx, ny)
    first = merge[0] == 0
    kernel_lib.check(alive, "alive", shape, torch.bool, dev)
    if tail and not photon:
        if g < 2:
            raise ValueError(f"cell_step: {g} guard cells; the 3D kernel's "
                             "gather window reaches 2 cells below a tile")
        kernel_lib.check(eb_pad, "eb_pad", (6, nx + 2 * g, ny + 2 * g),
                         dtype, dev)
    for k in FLOAT_PAYLOADS + (("inv_gamma",) if first else ()) + extra:
        kernel_lib.check(data[k], k, shape, dtype, dev)
    for k in ID_PAYLOADS:
        kernel_lib.check(data[k], k, shape, torch.int32, dev)
    ncomp = 4 if with_rho else 3
    pshape = panel_shape(ncomp, nx, ny)
    if rims_in is not None and tail and not photon:
        kernel_lib.check(rims_in, "rims_in", pshape, dtype, dev)

    def empty(dt_):
        return torch.empty(shape, dtype=dt_, device=dev)

    def slots(n):
        return [empty(dtype) for _ in range(n)]

    nf = len(FLOAT_PAYLOADS)
    if first:
        # pass_x reads the input, writes the scratch
        in_ptrs = ([alive] + [data[k] for k in FLOAT_PAYLOADS]
                   + [data["inv_gamma"]] + [data[k] for k in ID_PAYLOADS])
        s_alive, s_f, s_x = empty(torch.bool), slots(nf), slots(len(extra))
        s_id = [empty(torch.int32) for _ in ID_PAYLOADS]
        s_xin = s_x
    else:
        # pass_y reads the input through the scratch pointers
        in_ptrs = [None] * (2 + nf + len(ID_PAYLOADS))
        s_alive, s_f = alive, [data[k] for k in FLOAT_PAYLOADS]
        s_id = [data[k] for k in ID_PAYLOADS]
        s_xin = [data[k] for k in extra]
    if tail:
        o_alive, o_f, o_x = empty(torch.bool), slots(nf), slots(len(extra))
        o_id = [empty(torch.int32) for _ in ID_PAYLOADS]
        o_ig = empty(dtype)
    else:
        o_alive, o_f, o_x, o_id, o_ig = None, [None] * nf, [], [None] * 2, None
    rims = torch.empty(pshape, dtype=dtype, device=dev) \
        if tail and not photon else None
    chi, ig0 = (empty(dtype), empty(dtype)) if mode == "want_chi" and tail \
        else (None, None)
    n_lost = torch.zeros((), dtype=torch.int64, device=dev)
    keys, key_threads = key_scratch(cap, nx * ny, dev, "cellstep")
    eptrs = []
    for ax in range(2):
        lo, hi = edges.get(ax, (None, None))
        esh = _edge_shape(shape, ax)
        eptrs += (_edge_ptrs(lo, esh, extra, dtype, dev, ax == 0)
                  + _edge_ptrs(hi, esh, extra, dtype, dev, ax == 0))
    ptrs = ([eb_pad if tail and not photon else None] + in_ptrs
            + [s_alive] + s_f + s_id
            + [o_alive] + o_f + [o_ig] + o_id
            + [rims_in if tail and not photon else None, rims, n_lost,
               _ces_tensor(cap, dev), chi, ig0]
            + _pad3(data[k] for k in extra) + _pad3(s_xin) + _pad3(o_x)
            + [keys] + eptrs)
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
         MODES.index(mode), len(extra), key_threads, merge[0], merge[-1],
         int(0 in edges), int(1 in edges)],
        [cdx / 2, cdy / 2] + force + [CHI_FACTOR],
        dev)
    out = dict(data)
    if not tail:
        out.update(zip(FLOAT_PAYLOADS, s_f))
        out.update(zip(ID_PAYLOADS, s_id))
        out.update(zip(extra, s_x))
        out.pop("inv_gamma", None)
        return out, s_alive, n_lost
    out.update(zip(FLOAT_PAYLOADS, o_f))
    out.update(zip(ID_PAYLOADS, o_id))
    out.update(zip(extra, o_x))
    out["inv_gamma"] = o_ig
    if chi is not None:
        return out, o_alive, n_lost, rims, (chi, ig0)
    return out, o_alive, n_lost, rims


DISPATCHES = ("whole", "head", "tail")


def cell_step(eb_pad, data: Dict[str, torch.Tensor], alive, *, q: float,
              m: float, dt: float, dx: float, dy: float, g: int,
              periodic: Sequence[bool],
              rims_in: Optional[torch.Tensor] = None, with_rho: bool = True,
              dz: Optional[float] = None, want_chi: bool = False,
              photon: bool = False,
              edges_lo: Optional[Dict[str, torch.Tensor]] = None,
              edges_hi: Optional[Dict[str, torch.Tensor]] = None,
              merge_axes: Optional[Sequence[int]] = None, tail: bool = True,
              yz_edges=None):
    """One species' particle stage through kernel B2 (see
    ``cell_step_plain`` for the arguments and results, the mesh ones
    included). In ``photon`` mode ``eb_pad`` and ``rims_in`` are not read
    (either may be None) and no deposit runs; nor are they in a dispatch
    without the tail."""
    if alive.device.type == "cpu":
        return cell_step_plain(eb_pad, data, alive, q=q, m=m, dt=dt, dx=dx,
                               dy=dy, g=g, periodic=periodic, rims_in=rims_in,
                               with_rho=with_rho, dz=dz, want_chi=want_chi,
                               photon=photon, edges_lo=edges_lo,
                               edges_hi=edges_hi, merge_axes=merge_axes,
                               tail=tail, yz_edges=yz_edges)
    if alive.device.type != "cuda":
        raise ValueError(f"cell_step: unsupported device {alive.device}")
    mode = _mode(want_chi, photon)
    dtype = data["x"].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"cell_step: dtype {dtype}")
    extra = extra_payloads(data)
    if len(extra) > MAX_EXTRA:
        raise ValueError(f"cell_step: {len(extra)} extra payloads {extra}; "
                         f"the kernel carries at most {MAX_EXTRA}")
    nd = alive.ndim - 1
    merge = _merge_axes(nd, merge_axes, tail)
    edges = {}
    if edges_lo is not None:
        if merge[0] != 0:
            raise ValueError("cell_step: x edges need a dispatch that "
                             "re-bins x")
        edges[0] = (edges_lo, edges_hi)
    if yz_edges is not None:
        if yz_edges[0] != merge[0] or yz_edges[0] == 0:
            raise ValueError(f"cell_step: edges of axis {yz_edges[0]} in a "
                             f"dispatch of axes {merge}")
        edges[yz_edges[0]] = tuple(yz_edges[1:])
    kw = dict(q=q, m=m, dt=dt, dx=dx, dy=dy, g=g, periodic=periodic,
              rims_in=rims_in, with_rho=with_rho, mode=mode, extra=extra,
              merge=merge, tail=tail, edges=edges)
    if nd == 3:
        outs = _cell_step_3d(eb_pad, data, alive, dz=dz, **kw)
    else:
        outs = _cell_step_2d(eb_pad, data, alive, **kw)
    cell_step.launches += 1
    whole = len(merge) == nd
    cell_step.launches_by_dispatch[
        "whole" if whole else ("tail" if tail else "head")] += 1
    if tail:
        cell_step.launches_by_mode[mode] += 1
    return outs


cell_step.launches = 0
cell_step.launches_by_mode = dict.fromkeys(MODES, 0)
# per dispatch: "whole" (every axis and the tail, the one-device stage),
# "head" (a mesh's re-binning dispatch), "tail" (its last dispatch)
cell_step.launches_by_dispatch = dict.fromkeys(DISPATCHES, 0)


def fold_reduce(rims, shape: Sequence[int], periodic: Sequence[bool],
                mesh=None, specs=None):
    """Species-summed panels -> interior current (C,) + ``shape`` of a
    grid of ``shape`` cells, (nx, ny) or (nx, ny, nz), through kernel B3.
    With ``mesh`` (and a HaloSpec per axis in ``specs``) ``rims`` is a list
    of per-shard panels and ``shape`` a shard's: each shard folds its
    panels keeping the guard nodes of the split axes, then per split axis
    in reverse order the guard strips go to the neighbour shards and a
    strip launch adds what arrives (kernel B3's mesh form, K5)."""
    if mesh is not None:
        return _fold_reduce_mesh(rims, shape, mesh, specs)
    if rims.device.type == "cpu":
        return fold_reduce_plain(rims, shape, periodic)
    if rims.device.type != "cuda":
        raise ValueError(f"fold_reduce: unsupported device {rims.device}")
    return _fold(rims, tuple(shape), periodic, (False,) * len(shape))


def _fold(rims, shape, periodic, split):
    if len(shape) not in (2, 3) or len(periodic) != len(shape):
        raise ValueError(f"fold_reduce: shape {shape} and periodic "
                         f"{tuple(periodic)} must both name 2 or 3 axes")
    C = rims.shape[0]
    kernel_lib.check(rims, "rims", panel_shape(C, *shape), rims.dtype,
                     rims.device)
    oshape = tuple(n + 4 if s else n for n, s in zip(shape, split))
    out = torch.empty((C,) + oshape, dtype=rims.dtype, device=rims.device)
    f64 = rims.dtype == torch.float64
    if len(shape) == 3:
        kernel_lib.call("fold3d", "lp_fold_3d", [rims, out],
                        [C, *shape, TILE3, *periodic, f64, *split], [],
                        rims.device)
    else:
        kernel_lib.call("fold", "lp_fold", [rims, out],
                        [C, *shape, TILE, *periodic, f64, *split], [],
                        rims.device)
    fold_reduce.launches += 1
    fold_reduce.launches_by_kind["fold"] += 1
    return out


def _fold_strips(q: torch.Tensor, axis: int, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """One split axis's strip add (fold.cu's lp_fold_strips): the interior
    of ``q`` along array axis ``axis`` plus the received strips."""
    n = q.shape[axis] - 4
    sshape = list(q.shape)
    sshape[axis] = 2
    for name, t in (("strip lo", lo), ("strip hi", hi)):
        kernel_lib.check(t, name, sshape, q.dtype, q.device)
    kernel_lib.check(q, "folded", q.shape, q.dtype, q.device)
    oshape = list(q.shape)
    oshape[axis] = n
    out = torch.empty(oshape, dtype=q.dtype, device=q.device)
    outer = 1
    for k in q.shape[:axis]:
        outer *= k
    inner = 1
    for k in q.shape[axis + 1:]:
        inner *= k
    kernel_lib.call("fold", "lp_fold_strips", [q, lo, hi, out],
                    [outer, n, inner, q.dtype == torch.float64], [],
                    q.device)
    fold_reduce.launches += 1
    fold_reduce.launches_by_kind["strips"] += 1
    return out


def _fold_reduce_mesh(rims, shape, mesh, specs):
    from ..parallel.halo import exchange_strips
    rims = list(rims)
    if rims[0].device.type == "cpu":
        return fold_reduce_plain(rims, shape, None, mesh, specs)
    for r in rims:
        if r.device.type != "cuda":
            raise ValueError(f"fold_reduce: unsupported device {r.device}")
    shape = tuple(shape)
    periodic = tuple(sp.periodic for sp in specs)
    split = tuple(sp.size > 1 for sp in specs)
    qs = [_fold(r, shape, periodic, split) for r in rims]
    for ax in reversed(range(len(shape))):
        if not split[ax]:
            continue
        axis = 1 + ax
        n_pad = qs[0].shape[axis]
        from_lo, from_hi = exchange_strips(
            [q.narrow(axis, 0, 2).contiguous() for q in qs],
            [q.narrow(axis, n_pad - 2, 2).contiguous() for q in qs],
            specs[ax], mesh)
        qs = [_fold_strips(q, axis, lo, hi)
              for q, lo, hi in zip(qs, from_lo, from_hi)]
    return qs


fold_reduce.launches = 0
# "fold": the panel fold (one a shard); "strips": a split axis's strip add
fold_reduce.launches_by_kind = {"fold": 0, "strips": 0}


# ----------------------------------------------------------------------
# the cell engine's particle stage on a device mesh
# ----------------------------------------------------------------------

def dispatch_groups(sizes: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
    """The re-binning axes of each dispatch on a mesh of ``sizes`` shards
    per axis (lambdapic_tpu/ops/cellslab.py:1965-1970): x starts the
    first; every split y or z axis starts a new one, whose edge columns
    come from the previous dispatch's output."""
    groups = [[0]]
    for ax in range(1, len(sizes)):
        if sizes[ax] > 1:
            groups.append([ax])
        else:
            groups[-1].append(ax)
    return tuple(tuple(g) for g in groups)


def edge_columns(datas: Sequence[Dict[str, torch.Tensor]],
                 alives: Sequence[torch.Tensor], keys: Sequence[str],
                 axis: int, spec, mesh) -> list:
    """Per shard, the (lo, hi) edge columns of its neighbours along
    ``axis``: lo the lower neighbour's last column, hi the upper one's
    first, of ``alive`` (as int32, zero past an open global face) and of
    the payloads ``keys``, each a contiguous array one cell wide along the
    axis, copied to the shard's device (the JAX package's ppermutes of
    the edge columns, cellslab.py:1897-1915 and ``_yz_edge`` :1972-2001;
    the coordinates are shifted by the kernel, not here)."""
    from ..parallel.mesh import axis_index, ppermute
    dim = 1 + axis
    n = alives[0].shape[dim]

    def col(t, at):
        return t.narrow(dim, at, 1).contiguous()

    lo = {"alive": ppermute([col(a, n - 1).to(torch.int32) for a in alives],
                            mesh, spec.axis_name, +1)}
    hi = {"alive": ppermute([col(a, 0).to(torch.int32) for a in alives],
                            mesh, spec.axis_name, -1)}
    for k in keys:
        lo[k] = ppermute([col(d[k], n - 1) for d in datas], mesh,
                         spec.axis_name, +1)
        hi[k] = ppermute([col(d[k], 0) for d in datas], mesh,
                         spec.axis_name, -1)
    out = []
    for i in range(mesh.size):
        c = axis_index(mesh, i, spec.axis_name)
        e_lo = {k: v[i] for k, v in lo.items()}
        e_hi = {k: v[i] for k, v in hi.items()}
        if not spec.periodic:
            if c == 0:
                e_lo["alive"] = torch.zeros_like(e_lo["alive"])
            if c == spec.size - 1:
                e_hi["alive"] = torch.zeros_like(e_hi["alive"])
        out.append((e_lo, e_hi))
    return out


def cell_step_mesh(eb_pads, datas, alives, mesh, specs, *, q: float,
                   m: float, dt: float, dx: float, dy: float, g: int,
                   dz: Optional[float] = None, rims_in=None,
                   with_rho: bool = True, step=None):
    """One species' particle stage on every shard of a device mesh (the
    counterpart of lambdapic_tpu/ops/cellslab.py::slab_species_step on a
    mesh): the x edge columns of the stored state from the x neighbours
    (where the mesh splits x), then one dispatch per group of
    ``dispatch_groups`` on every shard, the edge columns of a split y (z)
    axis exchanged from the previous dispatch's output in between; the
    last dispatch runs the tail and deposits into the panels chained
    through ``rims_in`` (a list per shard, or None).

    ``step`` is ``cell_step`` (kernel B2 on CUDA shards, the plain version
    on CPU ones) or ``cell_step_plain``. Returns per shard (data, alive,
    n_lost, rims)."""
    step = step or cell_step
    nd = len(specs)
    periodic = tuple(sp.periodic for sp in specs)
    groups = dispatch_groups([sp.size for sp in specs])
    n = mesh.size
    extra = extra_payloads(datas[0])
    names = FLOAT_PAYLOADS + ID_PAYLOADS + extra
    x_edges = None
    if specs[0].size > 1:
        x_edges = edge_columns(datas, alives, names + ("inv_gamma",), 0,
                               specs[0], mesh)
    cur = [dict(d) for d in datas]
    cur_alive = list(alives)
    lost = [torch.zeros((), dtype=torch.int64, device=a.device)
            for a in alives]
    rims = [None] * n
    kw = dict(q=q, m=m, dt=dt, dx=dx, dy=dy, dz=dz, g=g, periodic=periodic,
              with_rho=with_rho)
    for gi, grp in enumerate(groups):
        last = gi == len(groups) - 1
        yz = None
        if gi > 0:
            yz = edge_columns(cur, cur_alive, names, grp[0], specs[grp[0]],
                              mesh)
        for i in range(n):
            e_lo = e_hi = None
            if gi == 0 and x_edges is not None:
                e_lo, e_hi = x_edges[i]
            outs = step(
                eb_pads[i] if last else None, cur[i], cur_alive[i],
                rims_in=(rims_in[i] if rims_in is not None and last
                         else None),
                edges_lo=e_lo, edges_hi=e_hi, merge_axes=grp, tail=last,
                yz_edges=None if yz is None else (grp[0],) + tuple(yz[i]),
                **kw)
            cur[i], cur_alive[i] = outs[0], outs[1]
            lost[i] = lost[i] + outs[2]
            if last:
                rims[i] = outs[3]
        del yz
    out = []
    for i in range(n):
        d = dict(datas[i])
        d.update(cur[i])
        out.append((d, cur_alive[i], lost[i], rims[i]))
    return out
