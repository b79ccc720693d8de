"""Seeded inputs and comparison rules shared by the tests and
``chip_smoke.py``.

Inputs are made with numpy from a seed, so the same arrays can be handed
to the JAX package, to a plain version and to its kernel. Slot order
within a cell carries no physics; comparisons first sort each cell's
slots by (dead, id_lo).
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
    """Reorder each cell's slot column by (dead, id_lo)."""
    alive = np.asarray(alive)
    key = (~alive).astype(np.int64) * (1 << 40) \
        + np.asarray(d["id_lo"]).astype(np.int64)
    order = np.argsort(key, axis=0, kind="stable")
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
                       *, seed: int = 0, n_frac: float = 1.0):
    """A 2D (or with ``nz`` 3D) cell state whose re-binning along x
    overfills cells: in columns ix = 3k + 1 the particles sit below -0.5
    of their cell (they move to 3k), in columns 3k + 2 at or above +0.5
    (they move to 3k + 3), and in columns 3k they stay, so a column 3k can
    receive 3 cap particles. Along y (and z) about a fifth of the
    particles cross a cell face. Returns (data, alive, eb_pad) as
    ``random_cell_state``."""
    data, alive, eb_pad = random_cell_state(cap, nx, ny, nz, n_frac=n_frac,
                                            seed=seed)
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


def tiny_laser_target(pkg, *, nx: int = 48, ny: int = 32, **sim_kw):
    """A tiny 2D laser-target of package ``pkg`` (lambdapic_tpu or
    lambdapic_torch, passed in): electrons (a y-dependent momentum so that
    particles cross cells) and protons in a 0.4 um foil at x = Lx/2, PML
    on all faces, a GaussianLaser2D of a0 = 2, float64, seed 1. Returns
    (sim, laser); ``sim_kw`` go to the Simulation."""
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
    sim = pkg.Simulation(nx=nx, ny=ny, dx=dx, dy=dx, tiling="cell",
                         random_seed=1, precision="double", **sim_kw)
    sim.add_species(species)
    return sim, laser
