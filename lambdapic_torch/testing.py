"""Seeded inputs and comparison rules shared by the tests and
``chip_smoke.py``.

Inputs are made with numpy from a seed, so the same arrays can be handed
to the JAX package, to a plain version and to its kernel. Slot order
within a cell carries no physics; comparisons first sort each cell's
slots by (dead, id_hi, id_lo): on a mesh a shard's newborns number from
its own counter, so id_lo repeats across shards with another id_hi.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .core.state import ID_KEYS, ids_to_numpy, ids_to_torch

SLOT_FLOATS = ("x", "y", "z", "w", "ux", "uy", "uz", "inv_gamma")
QED_PAYLOADS = ("tau", "delta", "event")


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the body with ``n`` threads in PyTorch's CPU pool, restoring
    the count after. A small 3D step is thousands of operations on arrays
    just above PyTorch's parallel grain; when several test processes each
    run a full pool on the same cores, every one of them waits on the
    others' threads and the step slows a hundredfold."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def random_cell_state(cap: int, nx: int, ny: int, nz: Optional[int] = None,
                      *, g: int = 3, n_frac: float = 0.4,
                      spread: float = 0.95, umax: float = 2.0,
                      field: float = 5e11,
                      seed: int = 0) -> Tuple[Dict[str, np.ndarray],
                                              np.ndarray, np.ndarray]:
    """A cell-binned species state, 2D slots (cap, nx, ny) or with ``nz``
    3D slots (cap, nx, ny, nz) (positions within +-spread/2 of their cell
    centre, momenta up to +-umax: at c dt/dx ~ 0.66 particles cross cells
    in every direction) and a random padded E/B stack. Returns
    (data, alive, eb_pad) as numpy arrays, ids as uint32."""
    rng = np.random.default_rng(seed)
    n = (nx, ny) if nz is None else (nx, ny, nz)
    shape = (cap,) + n
    alive = rng.uniform(0, 1, shape) < n_frac

    def mk(lo, hi):
        return rng.uniform(lo, hi, shape)

    def centred(axis):
        ishape = [1] * len(shape)
        ishape[1 + axis] = n[axis]
        return mk(-spread / 2, spread / 2) + np.arange(n[axis]).reshape(ishape)

    data = {"x": np.where(alive, centred(0), 0.0),
            "y": np.where(alive, centred(1), 0.0),
            "z": np.where(alive, mk(-1, 1) if nz is None else centred(2),
                          0.0)}
    u = [np.where(alive, mk(-umax, umax), 0.0) for _ in range(3)]
    data.update(ux=u[0], uy=u[1], uz=u[2])
    data["inv_gamma"] = 1 / np.sqrt(1 + u[0]**2 + u[1]**2 + u[2]**2)
    data["w"] = np.where(alive, mk(0.5, 1.5), 0.0)
    data["id_lo"] = rng.permutation(int(np.prod(shape))).reshape(shape
                                                                 ).astype(np.uint32)
    data["id_hi"] = np.zeros(shape, np.uint32)
    eb_pad = rng.uniform(-field, field, (6,) + tuple(k + 2 * g for k in n))
    return data, alive, eb_pad


def occupied_cell_state(cap: int, occupied: np.ndarray, per_cell: int, *,
                        seed: int = 0, **kw):
    """A 2D (or 3D) cell state whose cells are empty but those where the
    bool mask ``occupied`` (the cell shape) is set, which hold
    ``per_cell`` alive particles each in randomly chosen slots; otherwise
    as ``random_cell_state`` (``kw``: its spread, umax, field, g).
    Returns (data, alive, eb_pad)."""
    occupied = np.asarray(occupied, bool)
    if not 0 <= per_cell <= cap:
        raise ValueError(f"{per_cell} particles a cell in {cap} slots")
    data, full, eb_pad = random_cell_state(cap, *occupied.shape, n_frac=1.0,
                                           seed=seed, **kw)
    rank = np.argsort(np.random.default_rng(seed + 1).uniform(
        size=full.shape), axis=0)
    alive = (rank < per_cell) & occupied[None]
    return _dead_zeroed(data, alive), alive, eb_pad


def _dead_zeroed(data, alive):
    """``data`` with zero floats in the dead slots and inv_gamma of the
    momenta."""
    data = {k: (np.where(alive, v, 0.0) if k in SLOT_FLOATS else v)
            for k, v in data.items()}
    data["inv_gamma"] = 1 / np.sqrt(1 + data["ux"]**2 + data["uy"]**2
                                    + data["uz"]**2)
    return data


def band_mask(nx: int, ny: int, x0: int, width: int) -> np.ndarray:
    """The (nx, ny) mask of a band of ``width`` x-columns from ``x0``
    across all of y: a foil's cells."""
    mask = np.zeros((nx, ny), bool)
    mask[x0:x0 + width] = True
    return mask


SPARSE_GRID = (64, 80)
# cells on the four faces and the outward direction of their particles
FACE_CELLS = (((63, slice(40, 61)), (1, 0)), ((0, slice(0, 11)), (-1, 0)),
              ((slice(20, 31), 79), (0, 1)), ((slice(44, 53), 0), (0, -1)))


def _aim(data, alive, mask, sx, sy, rng):
    """Put the alive particles of the cells in ``mask`` near the (sx, sy)
    face or corner of their cell with momenta that carry most of them
    across it in the first half push."""
    sel = alive & mask[None]
    ix = np.arange(alive.shape[1])[None, :, None]
    iy = np.arange(alive.shape[2])[None, None, :]
    for s, key, ukey, idx in ((sx, "x", "ux", ix), (sy, "y", "uy", iy)):
        if s:
            data[key] = np.where(sel, idx + s * rng.uniform(0.15, 0.45,
                                                            alive.shape),
                                 data[key])
            data[ukey] = np.where(sel, s * rng.uniform(1.0, 4.0, alive.shape),
                                  data[ukey])
    data["inv_gamma"] = np.where(alive, 1 / np.sqrt(
        1 + data["ux"]**2 + data["uy"]**2 + data["uz"]**2), 1.0)


def sparse_cell_state(case: str, cap: int, seed: int = 0):
    """(data, alive, eb_pad, periodic) of a sparse 2D cell state on
    SPARSE_GRID (4 x 5 deposit tiles of 16 x 16 cells, 8 x 3 tiles of
    kernel B2's 8 x 32 re-binning passes):
    ``band`` a 10-column band, empty tiles on both sides; ``corner`` one
    cell at the corner of a deposit tile and of a pass tile whose
    particles cross into the three empty tiles beyond it; ``wrap`` and
    ``open`` cells on the four faces whose particles leave through them
    (through periodic faces into empty edge tiles, or through open faces,
    which drop them); ``empty`` nothing alive; ``crowded`` a band whose
    re-binning merges."""
    nx, ny = SPARSE_GRID
    rng = np.random.default_rng(seed + 7)
    per = max(1, min(cap // 2, 128))
    occ = np.zeros(SPARSE_GRID, bool)
    periodic = (False, True)
    if case == "band":
        occ = band_mask(nx, ny, 24, 10)
    elif case == "corner":
        occ[47, 31] = True
    elif case in ("wrap", "open"):
        for cells, _ in FACE_CELLS:
            occ[cells] = True
        periodic = (case == "wrap",) * 2
    if case == "crowded":
        data, alive, eb = crowded_cell_state(cap, nx, ny, seed=seed,
                                             n_frac=0.9)
        alive &= band_mask(nx, ny, 24, 10)[None]
        return _dead_zeroed(data, alive), alive, eb, (True, True)
    data, alive, eb = occupied_cell_state(cap, occ, per if occ.any() else 0,
                                          seed=seed, field=5e13)
    if case == "corner":
        _aim(data, alive, occ, 1, 1, rng)
    elif case in ("wrap", "open"):
        for cells, (sx, sy) in FACE_CELLS:
            m = np.zeros(SPARSE_GRID, bool)
            m[cells] = True
            _aim(data, alive, m, sx, sy, rng)
    return data, alive, eb, periodic


def add_qed_payloads(data: Dict[str, np.ndarray], seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    """A radiating species' QED attributes on a 2D or 3D cell state,
    different in every slot (tau, delta, event; chi zero), so that a
    re-binning that mixed them up would show."""
    rng = np.random.default_rng(seed)
    shape = np.shape(data["x"])
    data = dict(data)
    data["tau"] = rng.uniform(0.1, 2.0, shape)
    data["delta"] = rng.uniform(0.0, 1.0, shape)
    data["event"] = (rng.uniform(0, 1, shape) < 0.3).astype(np.float64)
    data["chi"] = np.zeros(shape)
    return data


def photon_cell_state(cap: int, nx: int, ny: int, nz: Optional[int] = None,
                      *, n_frac: float = 0.4, seed: int = 0):
    """A 2D (or with ``nz`` 3D) cell state of a photon species:
    inv_gamma = 1/|u| (1 where u = 0). Returns (data, alive) as numpy
    arrays."""
    data, alive, _ = random_cell_state(cap, nx, ny, nz, n_frac=n_frac,
                                       seed=seed)
    u2 = data["ux"]**2 + data["uy"]**2 + data["uz"]**2
    data["inv_gamma"] = np.where(u2 > 0, 1 / np.sqrt(np.maximum(u2, 1e-30)),
                                 1.0)
    return data, alive


def to_torch(data: Dict[str, np.ndarray], alive: np.ndarray, dtype, device):
    out = {k: (ids_to_torch(v, device) if k in ID_KEYS
               else torch.as_tensor(v, dtype=dtype).to(device))
           for k, v in data.items()}
    return out, torch.as_tensor(alive).to(device)


def to_numpy(data: Dict[str, torch.Tensor], alive: torch.Tensor):
    out = {k: (ids_to_numpy(v) if k in ID_KEYS else v.detach().cpu().numpy())
           for k, v in data.items()}
    return out, alive.detach().cpu().numpy()


def canon_slots(d: Dict[str, np.ndarray], alive: np.ndarray):
    """Reorder each cell's slot column by (dead, id_hi, id_lo) (id_hi 0
    where ``d`` has none)."""
    alive = np.asarray(alive)
    lo = np.asarray(d["id_lo"]).astype(np.int64)
    hi = np.asarray(d["id_hi"]).astype(np.int64) if "id_hi" in d \
        else np.zeros_like(lo)
    order = np.lexsort((lo, hi, (~alive).astype(np.int64)), axis=0)
    out = {k: np.take_along_axis(np.asarray(v), order, axis=0)
           for k, v in d.items()}
    return out, np.take_along_axis(alive, order, axis=0)


def compare_slots(ref, ref_alive, got, got_alive, *, rtol: float,
                  keys=SLOT_FLOATS, floor: float = 1e-14) -> None:
    """Slot-for-slot comparison after canonicalisation: alive and ids
    equal, the float attributes equal to ``rtol`` on alive slots. A value
    that cancels to near zero (a momentum after two opposite kicks)
    keeps the absolute rounding of its terms, so each attribute also
    gets an absolute floor of ``floor`` times its peak."""
    ref, ra = canon_slots(ref, ref_alive)
    got, ga = canon_slots(got, got_alive)
    np.testing.assert_array_equal(ga, ra)
    for k in ID_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k])[ga],
                                      np.asarray(ref[k])[ra], err_msg=k)
    for k in keys:
        r = np.asarray(ref[k])[ra]
        peak = float(np.abs(r).max()) if r.size else 0.0
        np.testing.assert_allclose(np.asarray(got[k])[ga], r, rtol=rtol,
                                   atol=max(floor * peak, 1e-300), err_msg=k)


def crowded_cell_state(cap: int, nx: int, ny: int, nz: Optional[int] = None,
                       *, seed: int = 0, n_frac: float = 1.0, **kw):
    """A 2D (or with ``nz`` 3D) cell state whose re-binning along x
    overfills cells: in columns ix = 3k + 1 the particles sit below -0.5
    of their cell (they move to 3k), in columns 3k + 2 at or above +0.5
    (they move to 3k + 3), and in columns 3k they stay, so a column 3k can
    receive 3 cap particles. Along y (and z) about a fifth of the
    particles cross a cell face. ``kw`` goes to ``random_cell_state``.
    Returns (data, alive, eb_pad) as ``random_cell_state``."""
    data, alive, eb_pad = random_cell_state(cap, nx, ny, nz, n_frac=n_frac,
                                            seed=seed, **kw)
    rng = np.random.default_rng(seed + 1)
    shape = alive.shape

    def index(axis):
        ishape = [1] * len(shape)
        ishape[1 + axis] = shape[1 + axis]
        return np.broadcast_to(np.arange(shape[1 + axis]).reshape(ishape),
                               shape)

    ix = index(0)
    off = np.select([ix % 3 == 1, ix % 3 == 2],
                    [rng.uniform(-0.95, -0.55, shape),
                     rng.uniform(0.5, 0.9, shape)],
                    rng.uniform(-0.45, 0.45, shape))
    data = dict(data)
    data["x"] = np.where(alive, ix + off, 0.0)
    for axis in range(1, len(shape) - 1):
        yoff = np.where(rng.uniform(0, 1, shape) < 0.2,
                        rng.choice([-0.7, 0.6], shape),
                        rng.uniform(-0.45, 0.45, shape))
        data["yz"[axis - 1]] = np.where(alive, index(axis) + yoff, 0.0)
    return data, alive, eb_pad


def random_mesh_cells(mesh_shape, cap: int, nloc, *, seed: int = 0,
                      crowded: bool = False, n_frac: float = 0.4,
                      qed: bool = False, **kw):
    """Cell states of every shard of a mesh of ``mesh_shape`` shards of
    ``nloc`` cells (``random_cell_state`` with ``kw``, or with ``crowded``
    ``crowded_cell_state``: merges; with ``qed`` also a radiating
    species' tau, delta and event, ``add_qed_payloads``), in the JAX
    package's layout of
    per-device arrays (leading mesh axes): (data, alive, eb_pad), one
    random padded E/B stack per shard. id_lo is unique over the mesh and
    id_hi the shard's flat index, as the fill numbers them. Positions are
    shard-local, so particles cross the shards' faces and corners."""
    shards = []
    for i, _ in enumerate(np.ndindex(tuple(mesh_shape))):
        nz = nloc[2] if len(nloc) == 3 else None
        if crowded:
            d, a, eb = crowded_cell_state(cap, nloc[0], nloc[1], nz,
                                          seed=seed + i, n_frac=n_frac, **kw)
        else:
            d, a, eb = random_cell_state(cap, nloc[0], nloc[1], nz,
                                         seed=seed + i, n_frac=n_frac, **kw)
        if qed:
            d = add_qed_payloads(d, seed + 100 + i)
        size = a.size
        d["id_lo"] = (d["id_lo"].astype(np.int64) + i * size).astype(np.uint32)
        d["id_hi"] = np.full(a.shape, i, np.uint32)
        shards.append((d, a, eb))
    lead = tuple(mesh_shape)

    def stack(xs):
        return np.stack(xs).reshape(lead + xs[0].shape)
    data = {k: stack([sh[0][k] for sh in shards]) for k in shards[0][0]}
    return (data, stack([sh[1] for sh in shards]),
            stack([sh[2] for sh in shards]))


def mesh_to_torch(data: Dict[str, np.ndarray], alive: np.ndarray, mesh,
                  dtype):
    """Arrays under leading mesh axes -> per-shard (data, alive) on the
    mesh's devices."""
    out = []
    for i in range(mesh.size):
        c = mesh.coords(i)
        out.append(to_torch({k: v[c] for k, v in data.items()}, alive[c],
                            dtype, mesh.devices[i]))
    return out


def mesh_to_numpy(shards, mesh_shape):
    """Per-shard (data, alive) -> numpy arrays under leading mesh axes."""
    lead = tuple(mesh_shape)
    outs = [to_numpy(d, a) for d, a in shards]

    def stack(xs):
        return np.stack(xs).reshape(lead + xs[0].shape)
    data = {k: stack([o[0][k] for o in outs]) for k in outs[0][0]}
    return data, stack([o[1] for o in outs])


def compare_mesh_slots(ref, ref_alive, got, got_alive, mesh_shape, *,
                       rtol: float, keys=SLOT_FLOATS,
                       floor: float = 1e-14) -> None:
    """``compare_slots`` shard by shard of arrays under leading mesh
    axes (each attribute's absolute floor from its peak over the mesh)."""
    ra, ga = np.asarray(ref_alive), np.asarray(got_alive)
    for c in np.ndindex(tuple(mesh_shape)):
        compare_slots({k: np.asarray(v)[c] for k, v in ref.items()}, ra[c],
                      {k: np.asarray(v)[c] for k, v in got.items()}, ga[c],
                      rtol=rtol, keys=(), floor=floor)
    for k in keys:
        peak = float(np.abs(np.asarray(ref[k])[ra]).max()) if ra.any() else 0
        for c in np.ndindex(tuple(mesh_shape)):
            r, rm = canon_slots({k: np.asarray(ref[k])[c],
                                 **{i: np.asarray(ref[i])[c]
                                    for i in ID_KEYS}}, ra[c])
            g, gm = canon_slots({k: np.asarray(got[k])[c],
                                 **{i: np.asarray(got[i])[c]
                                    for i in ID_KEYS}}, ga[c])
            np.testing.assert_allclose(g[k][gm], r[k][rm], rtol=rtol,
                                       atol=max(floor * peak, 1e-300),
                                       err_msg=f"{k} shard {c}")


def tiny_laser_target(pkg, *, nx: int = 48, ny: int = 32, **sim_kw):
    """A tiny 2D laser-target of package ``pkg`` (lambdapic_tpu or
    lambdapic_torch, passed in): electrons (a y-dependent momentum so that
    particles cross cells) and protons in a 0.4 um foil at x = Lx/2, PML
    on all faces, a GaussianLaser2D of a0 = 2, float64, seed 1. Returns
    (sim, laser); ``sim_kw`` go to the Simulation (``tiling`` defaults to
    "cell")."""
    um = 1e-6
    l0 = 0.8 * um
    dx = l0 / 16
    Lx, Ly = nx * dx, ny * dx
    nc = 1.742e27

    def density(x, y):
        return np.where((x > Lx / 2) & (x < Lx / 2 + 0.4 * um), 5 * nc, 0.0)

    def ux(x, y):
        return 1.5 * np.sin(2 * np.pi * y / Ly)

    def uz(x, y):
        return 0.3 * np.cos(2 * np.pi * y / Ly)

    species = [pkg.Electron(density=density, ppc=4, momentum=(ux, None, uz)),
               pkg.Proton(density=density, ppc=2)]
    laser = pkg.GaussianLaser2D(a0=2, l0=l0, w0=0.6 * um, ctau=0.5 * um,
                                x0=0.0, focus_position=Lx / 4)
    sim_kw.setdefault("tiling", "cell")
    sim = pkg.Simulation(nx=nx, ny=ny, dx=dx, dy=dx, random_seed=1,
                         precision="double", **sim_kw)
    sim.add_species(species)
    return sim, laser


def tiny_tiled_laser_target(pkg, *, rebin_interval: int = 1, **sim_kw):
    """``tiny_laser_target`` at 64 x 32 cells under the tiled engine:
    tiling (16, 16) (4 x 2 tiles; the foil's front sits on a tile face),
    ``rebin_interval`` R and the n_guard it needs (3, or 2 + ceil(R c dt
    / dx) for R > 1, as bench.py sets it)."""
    import math
    n_guard = 3 if rebin_interval == 1 else \
        2 + math.ceil(rebin_interval * 0.95 / 2**0.5)
    return tiny_laser_target(pkg, nx=64, ny=32, tiling=(16, 16),
                             rebin_interval=rebin_interval, n_guard=n_guard,
                             **sim_kw)


def tiled_state(cfg, *, seed: int = 0, n_frac: float = 0.4,
                drift: float = 1.0, umax: float = 2.0, field: float = 5e11,
                qed: bool = False):
    """A tiled 2D species state ``(ntx, nty, cap_t)`` for the TileCfg
    ``cfg`` and a random padded E/B stack (6, nx+2h, ny+2h). Alive slots
    lie within [-0.5 - drift, T - 0.5 + drift) of their tile's origin
    (the drift since the last re-binning, in cells), one in twenty on
    one of those two edges; momenta up to +-umax. Dead slots hold what
    the re-binning leaves there: x = y = w = u = 0, inv_gamma 1. With
    ``qed`` the QED attributes and the gathered-field slots are added.
    Returns (data, alive, eb_pad) as numpy arrays, ids as uint32."""
    rng = np.random.default_rng(seed)
    shape = (cfg.ntx, cfg.nty, cfg.cap_t)
    alive = rng.uniform(0, 1, shape) < n_frac
    edge = rng.uniform(0, 1, shape)

    def position(t, n, axis):
        lo, hi = -0.5 - drift, t - 0.5 + drift
        local = rng.uniform(lo, hi, shape)
        local = np.where(edge < 0.025, lo, local)
        local = np.where(edge > 0.975, np.nextafter(hi, lo), local)
        origin = (np.arange(n) * t).reshape((n, 1, 1) if axis == 0
                                            else (1, n, 1))
        return np.where(alive, origin + local, 0.0)

    data = {"x": position(cfg.tx, cfg.ntx, 0),
            "y": position(cfg.ty, cfg.nty, 1)}
    u = [np.where(alive, rng.uniform(-umax, umax, shape), 0.0)
         for _ in range(3)]
    data.update(ux=u[0], uy=u[1], uz=u[2])
    data["inv_gamma"] = 1 / np.sqrt(1 + u[0]**2 + u[1]**2 + u[2]**2)
    data["w"] = np.where(alive, rng.uniform(0.5, 1.5, shape), 0.0)
    data["id_lo"] = rng.permutation(int(np.prod(shape))).reshape(
        shape).astype(np.uint32)
    data["id_hi"] = np.zeros(shape, np.uint32)
    if qed:
        data = add_qed_payloads(data, seed)
        for k in ("ex_part", "ey_part", "ez_part", "bx_part", "by_part",
                  "bz_part"):
            data[k] = rng.normal(size=shape)
    nxp = cfg.ntx * cfg.tx + 2 * cfg.h
    nyp = cfg.nty * cfg.ty + 2 * cfg.h
    eb_pad = rng.uniform(-field, field, (6, nxp, nyp))
    return data, alive, eb_pad


def tiled_fill_state(cfg, *, seed: int = 0, per_cell: int = 10,
                     first_tile: int = 0, shuffle: bool = False,
                     umax: float = 2.0, field: float = 5e11):
    """A tiled 2D species state ``(ntx, nty, cap_t)`` laid out as the fill
    and ``initfill.bin_tiled`` leave it: each tile with x index
    ``first_tile`` or more holds ``per_cell`` particles in each of its
    cells, cell by cell (x rows, y along a row), in its first ``tx * ty *
    per_cell`` slots, each at its cell's centre plus U(-0.5, 0.5) an axis;
    the other tiles are empty. With ``shuffle`` each tile's slots are
    permuted at random (the same particles in random slot order). Momenta
    up to +-umax, weights U(0.5, 1.5); dead slots hold x = y = w = u = 0,
    inv_gamma 1. Returns (data, alive, eb_pad) as ``tiled_state`` does."""
    rng = np.random.default_rng(seed)
    shape = (cfg.ntx, cfg.nty, cfg.cap_t)
    n = cfg.tx * cfg.ty * per_cell
    if n > cfg.cap_t:
        raise ValueError(f"{n} particles a tile exceed cap_t {cfg.cap_t}")
    alive = np.zeros(shape, bool)
    alive[first_tile:, :, :n] = True
    cell = np.repeat(np.arange(cfg.tx * cfg.ty), per_cell)
    u, v = np.divmod(cell, cfg.ty)
    ox = (np.arange(cfg.ntx) * cfg.tx)[:, None, None]
    oy = (np.arange(cfg.nty) * cfg.ty)[None, :, None]
    x = np.zeros(shape)
    y = np.zeros(shape)
    x[..., :n] = ox + u + rng.uniform(-0.5, 0.5, shape[:2] + (n,))
    y[..., :n] = oy + v + rng.uniform(-0.5, 0.5, shape[:2] + (n,))
    data = {"x": np.where(alive, x, 0.0), "y": np.where(alive, y, 0.0)}
    mom = [np.where(alive, rng.uniform(-umax, umax, shape), 0.0)
           for _ in range(3)]
    data.update(ux=mom[0], uy=mom[1], uz=mom[2])
    data["inv_gamma"] = 1 / np.sqrt(1 + mom[0]**2 + mom[1]**2 + mom[2]**2)
    data["w"] = np.where(alive, rng.uniform(0.5, 1.5, shape), 0.0)
    data["id_lo"] = rng.permutation(int(np.prod(shape))).reshape(
        shape).astype(np.uint32)
    data["id_hi"] = np.zeros(shape, np.uint32)
    if shuffle:
        order = np.argsort(rng.uniform(size=shape), axis=-1)
        data = {k: np.take_along_axis(a, order, -1) for k, a in data.items()}
        alive = np.take_along_axis(alive, order, -1)
    nxp = cfg.ntx * cfg.tx + 2 * cfg.h
    nyp = cfg.nty * cfg.ty + 2 * cfg.h
    eb_pad = rng.uniform(-field, field, (6, nxp, nyp))
    return data, alive, eb_pad


def shard_state(state, grid, cpml, mesh):
    """A one-device SimulationState of the global grid ``grid`` split into
    a MeshState on ``mesh`` (whose shape is ``grid``'s mesh shape): each
    shard's block of the fields, the rows of its PML slabs of psi
    (``ops/cpml.py::psi_rows``), its cells' slots with positions shifted
    into its local cell units (x - offset, exact in float32 and float64 at
    these magnitudes; dead slots stay 0), ids kept. The state may lie on
    the host; each shard is copied to its device."""
    from .core.state import MeshState, SimulationState
    from .ops.cpml import psi_rows
    f = state.fields
    names = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")
    nloc = grid.local_shape
    shards = []
    for i in range(mesh.size):
        dev = mesh.devices[i]
        c = mesh.coords(i)
        cells = tuple(slice(ci * n, (ci + 1) * n) for ci, n in zip(c, nloc))

        def block(t, lead=0):
            return t[(slice(None),) * lead + cells].to(dev, copy=True
                                                       ).contiguous()

        psi = {}
        for key, v in f.psi.items():
            k = grid.axes.index(key[-1])
            idx = list(cells)
            rows = torch.as_tensor(psi_rows(cpml, grid, key[-1], c[k]),
                                   device=v.device)
            idx[k] = slice(None)
            psi[key] = v[tuple(idx)].index_select(k, rows).to(dev).contiguous()
        fields = f.replace(psi=psi, **{k: block(getattr(f, k)) for k in names})
        parts = []
        for p in state.particles:
            alive = block(p.alive, 1)
            data = {}
            for k, v in p.data.items():
                t = block(v, 1)
                if k in grid.axes:
                    off = float(c[grid.axes.index(k)] * nloc[grid.axes.index(k)])
                    t = torch.where(alive, t - off, torch.zeros_like(t))
                data[k] = t
            parts.append(p.replace(data=data, alive=alive,
                                   next_id=p.next_id.to(dev, copy=True),
                                   overflow=torch.zeros_like(
                                       p.overflow, device=dev)))
        shards.append(SimulationState(fields=fields, particles=tuple(parts)))
    return MeshState(shards=tuple(shards))


def unshard_state(mstate, grid, mesh, device):
    """The inverse of ``shard_state``: one SimulationState of the global
    grid on ``device`` (psi not carried: an empty dict), positions back in
    global cell units, overflow summed over the shards."""
    from .core.state import SimulationState
    from .parallel.mesh import psum
    nloc = grid.local_shape

    def join(ts, lead):
        blocks = np.empty(mesh.shape, dtype=object)
        for i, t in enumerate(ts):
            blocks[mesh.coords(i)] = t.to(device)

        def cat(b, axis):
            if b.ndim == 1:
                return torch.cat(list(b), dim=axis)
            return torch.cat([cat(b[k], axis + 1) for k in range(b.shape[0])],
                             dim=axis)
        return cat(blocks, lead)

    shards = mstate.shards
    f0 = shards[0].fields
    fields = f0.replace(psi={}, **{
        k: join([getattr(s.fields, k) for s in shards], 0)
        for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz",
                  "rho")})
    parts = []
    for ispec, p0 in enumerate(shards[0].particles):
        ps = [s.particles[ispec] for s in shards]
        data = {}
        for k in p0.data:
            ts = []
            for i, p in enumerate(ps):
                t = p.data[k]
                if k in grid.axes:
                    ax = grid.axes.index(k)
                    off = float(mesh.coords(i)[ax] * nloc[ax])
                    t = torch.where(p.alive, t + off, torch.zeros_like(t))
                ts.append(t)
            data[k] = join(ts, 1)
        parts.append(p0.replace(
            data=data, alive=join([p.alive for p in ps], 1),
            next_id=p0.next_id.to(device),
            overflow=psum([p.overflow for p in ps], mesh).to(device)))
    return SimulationState(fields=fields, particles=tuple(parts))


def mesh_twin(sim, mesh_shape, devices, source=None):
    """A Simulation (or Simulation3D) like the one-device ``sim`` (same
    configuration, species, step and time) on a mesh of ``mesh_shape``
    over ``devices``, without a fill of its own: its state is ``source``
    (a one-device state of ``sim``'s grid, by default ``sim``'s own; it
    may lie on the host) split with ``shard_state``."""
    import copy
    from .parallel.mesh import make_mesh
    twin = copy.copy(sim)
    for ax, p in zip("xyz", mesh_shape):
        setattr(twin, "npatch_" + ax, p)
    twin.grid = twin._make_grid()
    twin._check_mesh_supported()
    twin.mesh = make_mesh(twin.grid, devices)
    twin._species_static = list(sim._species_static)
    for k in ("_overflow_seen", "_occ_seen", "_loss_reported"):
        setattr(twin, k, dict(getattr(sim, k)))
    twin._builder = None
    twin.state = shard_state(sim.state if source is None else source,
                             twin.grid, sim.cpml, twin.mesh)
    return twin
