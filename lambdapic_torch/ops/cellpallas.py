"""The per-stage cell engine's kernels, 2D and 3D (counterpart of
lambdapic_tpu/ops/cellpallas.py):

    B4  fused_push_cell_2d   gather + Boris + half push   csrc/push2d.cu
        fused_push_cell_3d                                csrc/push3d.cu
    B5  deposit_cell_2d_k    Esirkepov J, rho -> padded   csrc/deposit2d.cu
        deposit_cell_3d_k                                 csrc/deposit3d.cu
    B6  migrate_axis         one re-binning axis, 2D or   csrc/migrate.cu
                             3D slots (driven by migrate_cells_fused, one
                             launch per axis)
    B7  sort_cells           Batcher sort along slots     csrc/sortcells.cu
                             of any rank

On a device mesh (K7) B6 reads the neighbour shards' edge columns in
place of the wrap (``migrate_axis``'s ``edge``), and
``migrate_cells_mesh`` drives the re-binning across the shards, axis by
axis, with the exchanges in between.

Each entry point launches its CUDA kernel on CUDA tensors and runs its
plain PyTorch version on CPU tensors; there is no fallback from a kernel
to its plain version on the card. Each kernel launch adds one to the
wrapper's ``launches`` (B4 also counts per mode in ``launches_by_mode``,
"default" and "want_eb"). A wrapper checks device, type, shape and
contiguity of its operands and raises on what its kernel does not take.

Plain versions: B4 ``fused_push_cell_2d_plain`` (``gather_cell_2d`` +
``boris_push`` + ``push_position_2d``) and ``fused_push_cell_3d_plain``
(the same with ``gather_cell_3d`` and ``push_position_3d``), each with
the dead slots given their dead values, B5
``cell2d.deposit_cell_2d`` and ``cell3d.deposit_cell_3d``, B6
``cell2d.migrate_cells`` (fast scheme, Batcher order, two or three
axes), B7 ``cell2d.batcher_sort``.
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence

import torch

from ..constants import c as c_light
from . import kernel_lib
from .cell2d import (MERGED, SANITIZED, TRANSIENT, batcher_network,
                     batcher_sort, deposit_cell_2d, gather_cell_2d,
                     migrate_cells)
from .cell3d import deposit_cell_3d, gather_cell_3d
from .cellslab import TILE, _ces_tensor, key_scratch, panel_shape
from .pusher import boris_push, push_position_2d, push_position_3d

# csrc/migrate.cu's MAXF / MAXI and csrc/sortcells.cu's MAXP, held equal
# to them when each library is first used
MIGRATE_MAX_FLOAT = 16
MIGRATE_MAX_INT = 4
SORT_MAX_PAYLOADS = 24
# csrc/deposit3d.cu's column geometry: x segment, (y, z) cells of a column,
# planes of a segment's panel, plane panel (y, z) nodes
DEPOSIT3_GEOMETRY = (32, 4, 8, 36, 8, 12)
PUSH_MODES = ("default", "want_eb")


def _on_card(t: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (run the plain version), True for a CUDA
    tensor; raise for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def _check_float(dtype, what: str) -> None:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: dtype {dtype}")


@functools.cache
def _check_limits(lib: str) -> None:
    """The kernels' compile-time limits, held equal to this module's once,
    when a library is first used."""
    so = kernel_lib.library(lib)
    if lib == "deposit2d":
        got, want = (so.lp_deposit_tile(),), (TILE,)
    elif lib == "deposit3d":
        got = tuple(so.lp_deposit_geometry(i)
                    for i in range(len(DEPOSIT3_GEOMETRY)))
        want = DEPOSIT3_GEOMETRY
    elif lib == "migrate":
        got = (so.lp_migrate_max_payloads(0), so.lp_migrate_max_payloads(1))
        want = (MIGRATE_MAX_FLOAT, MIGRATE_MAX_INT)
    else:
        got, want = (so.lp_sort_max_payloads(),), (SORT_MAX_PAYLOADS,)
    if got != want:
        raise RuntimeError(f"csrc/{kernel_lib.SOURCES[lib]} has limits {got}, "
                           f"ops/cellpallas.py {want}")


# ----------------------------------------------------------------------
# B4: gather + Boris + half push
# ----------------------------------------------------------------------

def fused_push_cell_2d_plain(eb_pad, x, y, ux, uy, uz, *, q: float,
                             m: float, dt: float, dx: float, dy: float,
                             g: int, alive: torch.Tensor,
                             want_eb: bool = False, do_pos1: bool = True):
    """Plain version of kernel B4 (see ``fused_push_cell_2d``)."""
    hx, hy = c_light * dt / dx / 2, c_light * dt / dy / 2
    if do_pos1:
        ig = 1.0 / torch.sqrt(1.0 + ux**2 + uy**2 + uz**2)
        x, y = push_position_2d(x, y, ux, uy, ig, hx, hy)
    eb = gather_cell_2d(eb_pad, x, y, g)
    ux, uy, uz, ig = boris_push(ux, uy, uz, *eb, q, m, dt)
    x, y = push_position_2d(x, y, ux, uy, ig, hx, hy)
    out = (x, y, ux, uy, uz, ig) + (tuple(eb) if want_eb else ())
    # the dead slots' values: zero floats, inv_gamma 1
    return tuple(torch.where(alive, t, 1.0 if i == 5 else 0.0)
                 for i, t in enumerate(out))


def fused_push_cell_2d(eb_pad, x, y, ux, uy, uz, *, q: float, m: float,
                       dt: float, dx: float, dy: float, g: int,
                       alive: torch.Tensor, want_eb: bool = False,
                       do_pos1: bool = True):
    """Kernel B4. eb_pad (6, nx+2g, ny+2g), g >= 2; slots (cap, nx, ny),
    freshly re-binned, ``alive`` (bool, the slots' shape) naming the slots
    to push. With ``do_pos1`` the positions first get a half push at
    inv_gamma = 1/sqrt(1 + u^2); without it they are already at the
    mid-step point (the per-stage step's case). Returns (x, y, ux, uy, uz,
    inv_gamma) after the gather, Boris and the second half push, and with
    ``want_eb`` also the six gathered components (ex, ey, ez, bx, by, bz);
    every dead slot gets the dead values: 0 in each output, inv_gamma 1."""
    if not _on_card(x, "fused_push_cell_2d"):
        return fused_push_cell_2d_plain(eb_pad, x, y, ux, uy, uz, q=q, m=m,
                                        dt=dt, dx=dx, dy=dy, g=g,
                                        alive=alive, want_eb=want_eb,
                                        do_pos1=do_pos1)
    dev, dtype = x.device, x.dtype
    _check_float(dtype, "fused_push_cell_2d")
    if x.ndim != 3:
        raise ValueError("fused_push_cell_2d: 2D slots (cap, nx, ny); 3D "
                         "slots go to fused_push_cell_3d")
    if g < 2:
        raise ValueError("fused_push_cell_2d: the gather window needs g >= 2")
    shape = tuple(x.shape)
    cap, nx, ny = shape
    kernel_lib.check(eb_pad, "eb_pad", (6, nx + 2 * g, ny + 2 * g), dtype, dev)
    for name, t in (("x", x), ("y", y), ("ux", ux), ("uy", uy), ("uz", uz)):
        kernel_lib.check(t, name, shape, dtype, dev)
    kernel_lib.check(alive, "alive", shape, torch.bool, dev)
    outs = [torch.empty(shape, dtype=dtype, device=dev)
            for _ in range(12 if want_eb else 6)]
    ebs = outs[6:] if want_eb else [None] * 6
    cdx, cdy = c_light * dt / dx, c_light * dt / dy
    kernel_lib.call(
        "push2d", "lp_push_2d",
        [eb_pad, x, y, ux, uy, uz] + outs[:6] + ebs + [alive],
        [cap, nx, ny, g, want_eb, do_pos1, dtype == torch.float64],
        [cdx / 2, cdy / 2, q * dt / (2 * m * c_light), q * dt / (2 * m)], dev)
    fused_push_cell_2d.launches += 1
    fused_push_cell_2d.launches_by_mode[PUSH_MODES[int(want_eb)]] += 1
    return tuple(outs)


fused_push_cell_2d.launches = 0
fused_push_cell_2d.launches_by_mode = dict.fromkeys(PUSH_MODES, 0)


def fused_push_cell_3d_plain(eb_pad, x, y, z, ux, uy, uz, *, q: float,
                             m: float, dt: float, dx: float, dy: float,
                             dz: float, g: int, alive: torch.Tensor,
                             want_eb: bool = False, do_pos1: bool = True):
    """Plain version of kernel B4 in 3D (see ``fused_push_cell_3d``)."""
    h = [c_light * dt / d / 2 for d in (dx, dy, dz)]
    if do_pos1:
        ig = 1.0 / torch.sqrt(1.0 + ux**2 + uy**2 + uz**2)
        x, y, z = push_position_3d(x, y, z, ux, uy, uz, ig, *h)
    eb = gather_cell_3d(eb_pad, x, y, z, g)
    ux, uy, uz, ig = boris_push(ux, uy, uz, *eb, q, m, dt)
    x, y, z = push_position_3d(x, y, z, ux, uy, uz, ig, *h)
    out = (x, y, z, ux, uy, uz, ig) + (tuple(eb) if want_eb else ())
    # the dead slots' values: zero floats, inv_gamma 1
    return tuple(torch.where(alive, t, 1.0 if i == 6 else 0.0)
                 for i, t in enumerate(out))


def fused_push_cell_3d(eb_pad, x, y, z, ux, uy, uz, *, q: float, m: float,
                       dt: float, dx: float, dy: float, dz: float, g: int,
                       alive: torch.Tensor, want_eb: bool = False,
                       do_pos1: bool = True):
    """Kernel B4 in 3D. eb_pad (6, nx+2g, ny+2g, nz+2g), g >= 2; slots
    (cap, nx, ny, nz), freshly re-binned, ``alive`` (bool, the slots'
    shape) naming the slots to push; ``do_pos1`` as in
    ``fused_push_cell_2d``. Returns (x, y, z, ux, uy, uz, inv_gamma) after
    the gather, Boris and the second half push, and with ``want_eb`` also
    the six gathered components (ex, ey, ez, bx, by, bz); every dead slot
    gets the dead values: 0 in each output, inv_gamma 1."""
    if not _on_card(x, "fused_push_cell_3d"):
        return fused_push_cell_3d_plain(eb_pad, x, y, z, ux, uy, uz, q=q,
                                        m=m, dt=dt, dx=dx, dy=dy, dz=dz,
                                        g=g, alive=alive, want_eb=want_eb,
                                        do_pos1=do_pos1)
    dev, dtype = x.device, x.dtype
    _check_float(dtype, "fused_push_cell_3d")
    if x.ndim != 4:
        raise ValueError("fused_push_cell_3d: 3D slots (cap, nx, ny, nz)")
    shape = tuple(x.shape)
    cap, nx, ny, nz = shape
    kernel_lib.check(eb_pad, "eb_pad", (6, nx + 2 * g, ny + 2 * g,
                                        nz + 2 * g), dtype, dev)
    if g < 2:
        raise ValueError("fused_push_cell_3d: the gather window needs g >= 2")
    for name, t in (("x", x), ("y", y), ("z", z), ("ux", ux), ("uy", uy),
                    ("uz", uz)):
        kernel_lib.check(t, name, shape, dtype, dev)
    kernel_lib.check(alive, "alive", shape, torch.bool, dev)
    outs = [torch.empty(shape, dtype=dtype, device=dev)
            for _ in range(13 if want_eb else 7)]
    ebs = outs[7:] if want_eb else [None] * 6
    h = [c_light * dt / d / 2 for d in (dx, dy, dz)]
    kernel_lib.call(
        "push3d", "lp_push_3d",
        [eb_pad, x, y, z, ux, uy, uz] + outs[:7] + ebs + [alive],
        [cap, nx, ny, nz, g, want_eb, do_pos1, dtype == torch.float64],
        h + [q * dt / (2 * m * c_light), q * dt / (2 * m)], dev)
    fused_push_cell_3d.launches += 1
    fused_push_cell_3d.launches_by_mode[PUSH_MODES[int(want_eb)]] += 1
    return tuple(outs)


fused_push_cell_3d.launches = 0
fused_push_cell_3d.launches_by_mode = dict.fromkeys(PUSH_MODES, 0)


# ----------------------------------------------------------------------
# B5: deposit into the padded current
# ----------------------------------------------------------------------

def deposit_cell_2d_k(x, y, ux, uy, uz, inv_gamma, w, *, q: float,
                      dx: float, dy: float, dt: float, g: int,
                      alive: torch.Tensor) -> torch.Tensor:
    """Kernel B5, the contract of ``cell2d.deposit_cell_2d`` (home-cell
    binned slots, dead slots with w == 0): the padded (4, nx+2g, ny+2g)
    jx, jy, jz, rho of one species. ``alive`` (bool, the slots' shape)
    names the depositing slots, so the kernel reads one byte a slot and
    no dead slot's payload; the plain version needs no mask (its dead
    slots add w = 0)."""
    if not _on_card(x, "deposit_cell_2d_k"):
        return deposit_cell_2d(x, y, ux, uy, uz, inv_gamma, w, q=q, dx=dx,
                               dy=dy, dt=dt, g=g)
    return _deposit_panels_2d(x, y, ux, uy, uz, inv_gamma, w, q=q, dx=dx,
                              dy=dy, dt=dt, g=g, alive=alive)[0]


def _deposit_panels_2d(x, y, ux, uy, uz, inv_gamma, w, *, q: float,
                       dx: float, dy: float, dt: float, g: int,
                       alive: torch.Tensor):
    """Kernel B5's launch on CUDA tensors, for ``deposit_cell_2d_k`` and
    the test that holds B5's tile panels against B2's: (jpad, panels
    (4, nbx, nby, 20, 20), flags (nbx * nby,) uint8). A panel is written
    only where its tile's flag is 1 (the tile holds an alive slot; the
    others hold whatever the allocation held); it is then bit for bit
    kernel B2's deposit2 panel of the same slots
    (csrc/cell2d.cuh::deposit_panel)."""
    if not _on_card(x, "deposit_cell_2d_k"):
        raise ValueError("deposit_cell_2d_k: the kernel's panels exist on "
                         "the card only")
    dev, dtype = x.device, x.dtype
    _check_float(dtype, "deposit_cell_2d_k")
    if x.ndim != 3:
        raise ValueError("deposit_cell_2d_k: 2D slots (cap, nx, ny); 3D "
                         "slots go to deposit_cell_3d_k")
    if g < 2:
        raise ValueError("deposit_cell_2d_k: the 5-tap stencil needs g >= 2")
    _check_limits("deposit2d")
    shape = tuple(x.shape)
    cap, nx, ny = shape
    for name, t in (("x", x), ("y", y), ("ux", ux), ("uy", uy), ("uz", uz),
                    ("inv_gamma", inv_gamma), ("w", w)):
        kernel_lib.check(t, name, shape, dtype, dev)
    kernel_lib.check(alive, "alive", shape, torch.bool, dev)
    pshape = panel_shape(4, nx, ny)
    panels = torch.empty(pshape, dtype=dtype, device=dev)
    flags = torch.empty(pshape[1] * pshape[2], dtype=torch.uint8, device=dev)
    jpad = torch.empty((4, nx + 2 * g, ny + 2 * g), dtype=dtype, device=dev)
    kernel_lib.call(
        "deposit2d", "lp_deposit_2d",
        [x, y, ux, uy, uz, inv_gamma, w, panels, jpad, alive, flags],
        [cap, nx, ny, g, dtype == torch.float64],
        [c_light * dt / dx, c_light * dt / dy, c_light, q / (dx * dy),
         q / (dy * dt), q / (dx * dt)], dev)
    deposit_cell_2d_k.launches += 1
    return jpad, panels, flags


deposit_cell_2d_k.launches = 0


def deposit_cell_3d_k(x, y, z, ux, uy, uz, inv_gamma, w, *, q: float,
                      dx: float, dy: float, dz: float, dt: float, g: int,
                      alive: torch.Tensor) -> torch.Tensor:
    """Kernel B5 in 3D, the contract of ``cell3d.deposit_cell_3d``
    (home-cell binned slots, dead slots with w == 0): the padded
    (4, nx+2g, ny+2g, nz+2g) jx, jy, jz, rho of one species. ``alive``
    (bool, the slots' shape) names the depositing slots, so the kernel
    reads one byte a slot and no dead slot's payload; the plain version
    needs no mask (its dead slots add w = 0)."""
    if not _on_card(x, "deposit_cell_3d_k"):
        return deposit_cell_3d(x, y, z, ux, uy, uz, inv_gamma, w, q=q,
                               dx=dx, dy=dy, dz=dz, dt=dt, g=g)
    dev, dtype = x.device, x.dtype
    _check_float(dtype, "deposit_cell_3d_k")
    if x.ndim != 4:
        raise ValueError("deposit_cell_3d_k: 3D slots (cap, nx, ny, nz)")
    if g < 2:
        raise ValueError("deposit_cell_3d_k: the 5-tap stencil needs g >= 2")
    _check_limits("deposit3d")
    shape = tuple(x.shape)
    cap, nx, ny, nz = shape
    for name, t in (("x", x), ("y", y), ("z", z), ("ux", ux), ("uy", uy),
                    ("uz", uz), ("inv_gamma", inv_gamma), ("w", w)):
        kernel_lib.check(t, name, shape, dtype, dev)
    kernel_lib.check(alive, "alive", shape, torch.bool, dev)
    seg, cy, cz, planes, qy, qz = DEPOSIT3_GEOMETRY
    panels = torch.empty((-(-nx // seg), -(-ny // cy), -(-nz // cz), planes,
                          qy, qz, 4), dtype=dtype, device=dev)
    jpad = torch.empty((4, nx + 2 * g, ny + 2 * g, nz + 2 * g), dtype=dtype,
                       device=dev)
    kernel_lib.call(
        "deposit3d", "lp_deposit_3d",
        [x, y, z, ux, uy, uz, inv_gamma, w, panels, jpad, alive],
        [cap, nx, ny, nz, g, dtype == torch.float64],
        [c_light * dt / dx, c_light * dt / dy, c_light * dt / dz,
         q / (dx * dy * dz), q / (dy * dz * dt), q / (dx * dz * dt),
         q / (dx * dy * dt)], dev)
    deposit_cell_3d_k.launches += 1
    return jpad


deposit_cell_3d_k.launches = 0


# ----------------------------------------------------------------------
# B7: Batcher sort along the slot axis
# ----------------------------------------------------------------------

def sort_cells(key: torch.Tensor, payloads: Sequence[torch.Tensor]):
    """Kernel B7: sort (key, *payloads) along axis 0 (the slots),
    independently for every cell, with the Batcher compare-exchange list
    (strict ka > kb). key: (cap, *cells) int32; payloads: arrays of the
    key's shape, any type of 1, 2, 4 or 8 bytes. Returns (sorted key,
    [sorted payloads]), as ``cell2d.batcher_sort``."""
    if not _on_card(key, "sort_cells"):
        return batcher_sort(key, payloads)
    dev = key.device
    shape = tuple(key.shape)
    cap = shape[0]
    _check_limits("sortcells")
    if len(payloads) > SORT_MAX_PAYLOADS:
        raise ValueError(f"sort_cells: {len(payloads)} payloads; the kernel "
                         f"moves at most {SORT_MAX_PAYLOADS}")
    kernel_lib.check(key, "key", shape, torch.int32, dev)
    sizes = []
    for i, p in enumerate(payloads):
        kernel_lib.check(p, f"payload {i}", shape, p.dtype, dev)
        if p.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"sort_cells: payload {i} has {p.element_size()}"
                             "-byte elements")
        sizes.append(p.element_size())
    key_out = torch.empty_like(key)
    outs = [torch.empty_like(p) for p in payloads]
    pad = [None] * (SORT_MAX_PAYLOADS - len(payloads))
    ncell = key[0].numel()
    keys, key_threads = key_scratch(cap, ncell, dev, "sortcells")
    kernel_lib.call(
        "sortcells", "lp_sort_cells",
        [key, key_out, _ces_tensor(cap, dev), keys] + list(payloads) + pad
        + outs + pad,
        [cap, ncell, len(payloads), len(batcher_network(cap)), key_threads]
        + sizes + [0] * len(pad), [], dev)
    sort_cells.launches += 1
    return key_out, outs


sort_cells.launches = 0


# ----------------------------------------------------------------------
# B6: one re-binning axis, and the loop over the axes
# ----------------------------------------------------------------------

def migrate_axis(alive: torch.Tensor, floats: Dict[str, torch.Tensor],
                 ints: Dict[str, torch.Tensor], *, axis: int, periodic: bool,
                 coord: str, final: bool, recompute_ig: bool, edge=None):
    """Kernel B6: one axis of the fast re-binning of 2D or 3D slots.
    ``floats`` (the species' float type) and ``ints`` (int32) are the
    carried payloads by name, ``coord`` the axis's coordinate among them.
    On the ``final`` axis dead slots' x, y, z, w, ux, uy, uz become 0 and
    inv_gamma is recomputed from u (``recompute_ig``) or, carried, set to
    1 in dead slots. ``edge`` = (lo, hi): the neighbour shards' edge
    columns along the axis (``cellslab.edge_columns``: ``alive`` as int32,
    zero past an open face, and every carried payload, one cell wide along
    the axis) in place of the wrap (K7). Returns (alive, floats, ints,
    inv_gamma or None, n_merged)."""
    dev = alive.device
    shape = tuple(alive.shape)
    cap, cells = shape[0], shape[1:]
    fnames, inames = list(floats), list(ints)
    dtype = floats[coord].dtype
    kernel_lib.check(alive, "alive", shape, torch.bool, dev)
    for k in fnames:
        kernel_lib.check(floats[k], k, shape, dtype, dev)
    for k in inames:
        kernel_lib.check(ints[k], k, shape, torch.int32, dev)

    def index(k):
        return fnames.index(k) if k in fnames else -1

    def mask(names):
        return sum(1 << i for i, k in enumerate(fnames) if k in names)

    new_alive = torch.empty_like(alive)
    fout = [torch.empty_like(floats[k]) for k in fnames]
    iout = [torch.empty_like(ints[k]) for k in inames]
    ig = torch.empty(shape, dtype=dtype, device=dev) \
        if final and recompute_ig else None
    n_merged = torch.zeros((), dtype=torch.int64, device=dev)
    fpad = [None] * (MIGRATE_MAX_FLOAT - len(fnames))
    ipad = [None] * (MIGRATE_MAX_INT - len(inames))
    keys, key_threads = key_scratch(cap, alive[0].numel(), dev,
                                    "migrate")
    # the cells between neighbours along the axis (C order)
    stride = 1
    for n in cells[axis + 1:]:
        stride *= n
    eptrs = []
    if edge is not None:
        esh = list(shape)
        esh[1 + axis] = 1
        for side, e in zip(("lo", "hi"), edge):
            kernel_lib.check(e["alive"], f"edge {side} alive", esh,
                             torch.int32, dev)
            for k in fnames:
                kernel_lib.check(e[k], f"edge {side} {k}", esh, dtype, dev)
            for k in inames:
                kernel_lib.check(e[k], f"edge {side} {k}", esh, torch.int32,
                                 dev)
            eptrs += ([e["alive"]] + [e[k] for k in fnames] + fpad
                      + [e[k] for k in inames] + ipad)
    else:
        eptrs = [None] * (2 * (1 + MIGRATE_MAX_FLOAT + MIGRATE_MAX_INT))
    kernel_lib.call(
        "migrate", "lp_migrate_axis",
        [alive, new_alive, n_merged, _ces_tensor(cap, dev), ig]
        + [floats[k] for k in fnames] + fpad + fout + fpad
        + [ints[k] for k in inames] + ipad + iout + ipad + [keys] + eptrs,
        [cap, alive[0].numel(), cells[axis], stride, periodic, len(fnames),
         len(inames), index(coord), index("w"), mask(MERGED + ("w",)), final,
         mask(SANITIZED), index("ux"), index("uy"), index("uz"),
         recompute_ig, -1 if recompute_ig else index("inv_gamma"),
         len(batcher_network(cap)), dtype == torch.float64, key_threads,
         edge is not None, cells[0], cells[1],
         cells[2] if len(cells) == 3 else 0, axis],
        [], dev)
    migrate_axis.launches += 1
    return (new_alive, dict(zip(fnames, fout)), dict(zip(inames, iout)), ig,
            n_merged)


migrate_axis.launches = 0


def migrate_cells_fused(data: Dict[str, torch.Tensor], alive: torch.Tensor,
                        plan, *, recompute_ig: bool = True, edges=None,
                        finish: bool = True):
    """The fast re-binning of ``cell2d.migrate_cells`` (same arguments and
    results, Batcher order, the axes named by each plan entry's
    coordinate) of 2D or 3D slots through kernel B6, one launch per axis.
    It carries every payload but the transient ones (``cell2d.TRANSIENT``;
    inv_gamma too unless ``recompute_ig``), a QED species' tau, delta and
    event included. ``edges`` maps an axis to the (lo, hi) edge columns of
    its neighbour shards (K7); ``finish=False`` leaves the dead slots to
    the next axis's call and drops inv_gamma, as in ``migrate_cells``."""
    if not _on_card(alive, "migrate_cells_fused"):
        return migrate_cells(data, alive, plan, recompute_ig=recompute_ig,
                             edges=edges, finish=finish)
    nd = alive.ndim - 1
    axes = ["xyz".index(p[2]) for p in plan]
    if nd not in (2, 3) or not axes or \
            axes != list(range(axes[0], axes[0] + len(axes))) or \
            axes[-1] >= nd or (finish and axes[-1] != nd - 1):
        raise ValueError(f"migrate_cells_fused: slots of shape "
                         f"{tuple(alive.shape)} and a plan of axes {axes}: "
                         "2D or 3D slots, one entry per axis of a run of "
                         "consecutive axes, which ends with the last axis "
                         "when it finishes the re-binning")
    _check_limits("migrate")
    transient = set(TRANSIENT) if recompute_ig \
        else set(TRANSIENT) - {"inv_gamma"}
    names = sorted(k for k in data if k not in transient)
    dtype = data[plan[0][2]].dtype
    _check_float(dtype, "migrate_cells_fused")
    floats = {k: data[k] for k in names if data[k].dtype == dtype}
    ints = {k: data[k] for k in names if data[k].dtype == torch.int32}
    other = set(names) - set(floats) - set(ints)
    if other:
        raise ValueError(f"migrate_cells_fused: payloads {sorted(other)} are "
                         f"neither {dtype} nor int32")
    if "w" not in floats or len(floats) > MIGRATE_MAX_FLOAT \
            or len(ints) > MIGRATE_MAX_INT:
        raise ValueError(f"migrate_cells_fused: payloads {names}: the kernel "
                         f"takes w and at most {MIGRATE_MAX_FLOAT} float and "
                         f"{MIGRATE_MAX_INT} int32 payloads")
    edges = edges or {}
    n_lost = torch.zeros((), dtype=torch.int64, device=alive.device)
    ig = None
    for i, (nloc, periodic, coord) in enumerate(plan):
        axis = "xyz".index(coord)
        if nloc != alive.shape[1 + axis]:
            raise ValueError(f"migrate_cells_fused: plan axis {axis} has "
                             f"{nloc} cells, the slots {alive.shape[1 + axis]}")
        alive, floats, ints, ig, n_m = migrate_axis(
            alive, floats, ints, axis=axis, periodic=bool(periodic),
            coord=coord, final=finish and i == len(plan) - 1,
            recompute_ig=recompute_ig, edge=edges.get(axis))
        n_lost = n_lost + n_m
    out = {**data, **floats, **ints}
    if recompute_ig:
        out.pop("inv_gamma", None)
        if ig is not None:
            out["inv_gamma"] = ig
    return out, alive, n_lost


def migrate_fn(scheme: str):
    """The per-shard re-binning of ``scheme``, with the arguments of
    ``cell2d.migrate_cells``: "fused" (kernel B6 per axis,
    ``migrate_cells_fused``), "sort" (the fast scheme sorting through
    kernel B7, ``LAMBDAPIC_MIG_FUSED=0``) or "exact" (the lossless scheme,
    plain torch as it is XLA in JAX)."""
    if scheme == "fused":
        return migrate_cells_fused
    if scheme == "sort":
        return functools.partial(migrate_cells, sort_fn=sort_cells)
    if scheme == "exact":
        return functools.partial(migrate_cells, exact=True)
    raise ValueError(f"migrate_fn: scheme {scheme!r}")


def migrate_cells_mesh(datas, alives, mesh, specs, *, recompute_ig: bool =
                       True, scheme="fused"):
    """The re-binning of one species on every shard of a device mesh
    (lambdapic_tpu/ops/cell2d.py::migrate_cells and cellpallas.py::
    migrate_cells_fused under shard_map), axis after axis: where the mesh
    splits an axis, the neighbours' edge columns of the previous axis's
    output come over (``cellslab.edge_columns``) and take the place of
    the wrap; an axis the mesh does not split wraps within the shard.
    ``scheme`` names the per-shard re-binning (``migrate_fn``; "fused" is
    kernel B6 with the cross-device strips, K7, and its plain version on
    CPU shards), or is such a function itself (``cell2d.migrate_cells``
    is K7's plain version on any device). Returns per shard (data,
    alive, n_lost)."""
    from .cellslab import edge_columns
    migrate = scheme if callable(scheme) else migrate_fn(scheme)
    nd = len(specs)
    transient = set(TRANSIENT) if recompute_ig \
        else set(TRANSIENT) - {"inv_gamma"}
    names = tuple(sorted(k for k in datas[0] if k not in transient))
    cur = [dict(d) for d in datas]
    cur_alive = list(alives)
    lost = [torch.zeros((), dtype=torch.int64, device=a.device)
            for a in alives]
    for axis, spec in enumerate(specs):
        coord = "xyz"[axis]
        finish = axis == nd - 1
        edges = None
        if spec.size > 1:
            edges = edge_columns(cur, cur_alive, names, axis, spec, mesh)
        for i in range(mesh.size):
            plan = ((cur_alive[i].shape[1 + axis], spec.periodic, coord),)
            e = None if edges is None else {axis: edges[i]}
            kw = dict(recompute_ig=recompute_ig, edges=e, finish=finish)
            out = migrate(cur[i], cur_alive[i], plan, **kw)
            cur[i], cur_alive[i] = out[0], out[1]
            lost[i] = lost[i] + out[2]
        del edges
    return [(d, a, n) for d, a, n in zip(cur, cur_alive, lost)]
