"""Kernel B4 in 2D pushes only the alive slots and gives every dead slot
fixed values (zero positions and momenta, inv_gamma 1, zero gathered
fields). Nothing downstream of B4 in the per-stage 2D step may read
those slots: the next step's first half push, the exact re-binning,
QED's update_chi_and_events and kernel B5.

The port's per-stage 2D step runs here on the CPU (the plain versions),
float64, for two steps, twice from the same seeded state: once as the
step runs it, with the initial state's dead slots set to the dead values
(not NaN: the plain deposit multiplies w = 0 into positions); once with
made-up particles (positions inside their cells, random momenta and
fields, w = 0) in place of the dead values, both in the initial state's
dead slots and in every dead slot that B4 returns. The alive slots,
sorted by (id_hi, id_lo), and the fields (J among them) must be equal bit
for bit. Two configurations: the tiny laser-target of
lambdapic_torch.testing with ``cell_migration="exact"``, and radiating
electrons with their photons and protons, also exact (B4's want_eb
mode). One torch thread; no JAX. The 3D twin is
tests/test_torch_deadslots3d.py.
"""
import numpy as np
import pytest
import torch

import lambdapic_torch
from lambdapic_torch.core import species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.ops import cellpallas
from lambdapic_torch.simulation import step as t_step
from lambdapic_torch.testing import tiny_laser_target, torch_threads

NSTEPS = 2
FIELDS = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz")
DEAD = {"x": 0.0, "y": 0.0, "ux": 0.0, "uy": 0.0, "uz": 0.0,
        "inv_gamma": 1.0}
IG_OUT = 5          # B4 2D's inv_gamma output


@pytest.fixture(autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def clear_registry():
    t_species._ALL_SPECIES.clear()
    yield
    t_species._ALL_SPECIES.clear()


def _laser_target():
    """The tiny laser-target (48 x 32 cells, a foil with momenta along x
    and z, PML), exact re-binning."""
    sim, laser = tiny_laser_target(lambdapic_torch, device="cpu",
                                   cell_migration="exact")
    sim.initialize()
    return sim, [laser]


def _radiating():
    """Electrons of Lorentz factor 2000 in a uniform Bz (chi ~ 1) with
    their photons, and protons, periodic 16 x 16 cells, exact
    re-binning."""
    from lambdapic_torch.constants import c, e, hbar, m_e
    L = lambdapic_torch
    nx, ny, d = 16, 16, 1e-7
    gamma = 2000.0
    bc = {k: "periodic" for k in ("xmin", "xmax", "ymin", "ymax")}
    pho = L.Photon(capacity=16384)
    ele = L.Electron(radiation="photons")
    ele.set_photon(pho)
    sim = L.Simulation(nx=nx, ny=ny, dx=d, dy=d, boundary_conditions=bc,
                       random_seed=3, precision="double", tiling="cell",
                       cell_migration="exact", device="cpu")
    sim.add_species([ele, L.Proton(), pho])
    sim.initialize()
    rng = np.random.default_rng(1)

    def coords(n):
        return {a: rng.uniform(0.05, 0.95, n) * n_ * d
                for a, n_ in zip("xy", (nx, ny))}
    ux = np.sqrt(gamma**2 - 1)
    sim.set_particles_global(0, coords(200), {
        "w": np.ones(200), "ux": np.full(200, ux), "uy": np.zeros(200),
        "uz": np.zeros(200), "inv_gamma": np.full(200, 1 / gamma)})
    u = rng.uniform(-0.5, 0.5, (3, 300))
    sim.set_particles_global(1, coords(300), {
        "w": np.full(300, 2.0), "ux": u[0], "uy": u[1], "uz": u[2],
        "inv_gamma": 1 / np.sqrt(1 + (u**2).sum(0))})
    sim.set_field("bz", np.full((nx, ny), 1.0 / (
        e * hbar / (m_e**2 * c**3) * c * ux)))
    return sim, []


def _made_up(alive, gen):
    """Made-up particles for every slot of ``alive``'s shape: inside their
    cells, moving, with inv_gamma to match."""
    out = {}
    for ax, k in enumerate("xy"):
        shape = [1] * alive.ndim
        shape[ax + 1] = alive.shape[ax + 1]
        cell = torch.arange(alive.shape[ax + 1],
                            dtype=torch.float64).view(shape)
        out[k] = cell + torch.rand(alive.shape, generator=gen,
                                   dtype=torch.float64) - 0.5
    u = torch.rand((3,) + tuple(alive.shape), generator=gen,
                   dtype=torch.float64) - 0.5
    out.update(ux=u[0], uy=u[1], uz=u[2],
               inv_gamma=1 / torch.sqrt(1 + (u**2).sum(0)))
    return out


def _run(make, made_up, monkeypatch):
    """The state after NSTEPS steps, the dead slots holding the dead
    values, or made-up particles (``made_up``: in the initial state and
    in B4's outputs). Also B4's want_eb flags, call by call."""
    calls = []
    gen = torch.Generator().manual_seed(5)

    def push(*args, alive, **kw):
        calls.append(kw["want_eb"])
        outs = cellpallas.fused_push_cell_2d(*args, alive=alive, **kw)
        for i, t in enumerate(outs):
            assert bool((t[~alive] == (1.0 if i == IG_OUT else 0.0)).all()), i
        if not made_up:
            return outs
        fake = list(_made_up(alive, gen).values())
        fake += [t.abs().max() * (torch.rand(t.shape, generator=gen,
                                             dtype=t.dtype) - 0.5)
                 for t in outs[6:]]
        return tuple(torch.where(alive, t, f) for t, f in zip(outs, fake))
    monkeypatch.setattr(t_step, "fused_push_cell_2d", push)
    sim, cbs = make()
    for p in sim.state.particles:
        dead = ~p.alive
        assert bool((p.data["w"][dead] == 0).all())
        vals = _made_up(p.alive, gen) if made_up else DEAD
        for k, v in vals.items():
            p.data[k][dead] = v[dead] if made_up else v
    sim.run(NSTEPS, callbacks=cbs)
    monkeypatch.undo()
    return state_to_numpy(sim.state), calls


def _alive_sorted(p):
    alive = np.asarray(p.alive)[0, 0]
    data = {k: np.asarray(v)[0, 0][alive] for k, v in p.data.items()}
    order = np.lexsort((data["id_lo"], data["id_hi"]))
    return {k: v[order] for k, v in data.items()}


@pytest.mark.parametrize("make", [_laser_target, _radiating],
                         ids=["exact", "exact_qed"])
def test_dead_slots_reach_nothing(make, monkeypatch):
    made_up, calls = _run(make, True, monkeypatch)
    as_run, calls_r = _run(make, False, monkeypatch)
    assert calls == calls_r and len(calls) >= NSTEPS
    for k in FIELDS:
        a, b = getattr(as_run.fields, k), getattr(made_up.fields, k)
        assert np.array_equal(a, b), k
    assert np.abs(as_run.fields.jx).max() > 0
    for pm, pa in zip(as_run.particles, made_up.particles):
        got, ref = _alive_sorted(pm), _alive_sorted(pa)
        assert sorted(got) == sorted(ref)
        assert len(got["id_lo"]) == len(ref["id_lo"])
        for k in ref:
            assert np.array_equal(got[k], ref[k]), k
    if make is _radiating:
        # photons were emitted, and B4 ran its want_eb mode
        assert int(np.asarray(as_run.particles[2].alive).sum()) > 20
        assert any(calls)
