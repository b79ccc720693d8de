"""The port's tiled 2D Simulation on its own, on the CPU, float64, on
lambdapic_torch.testing.tiny_tiled_laser_target (64 x 32 cells, tiling
(16, 16)):

- a split tiled step (an ``_interpolator`` callback) equals a full tiled
  step from a cloned state, bit for bit but for the gathered-field slots
  only the split step writes;
- re-capacity on the tiled layout grows the slot axis, the last, and
  keeps every particle and id;
- a step refuses a state binned per cell;
- the refusals name their ROADMAP items, and _validate_tiling's errors
  (tiles that do not divide the grid, tiles under 2 n_guard, a halo too
  narrow for rebin_interval) are raised.
"""
import copy

import numpy as np
import pytest
import torch

import lambdapic_torch
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import ids_to_numpy
from lambdapic_torch.testing import tiny_tiled_laser_target, torch_threads

EB_PART = ("ex_part", "ey_part", "ez_part", "bx_part", "by_part", "bz_part")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: beside the other test processes a full pool
    waits on their threads (lambdapic_torch.testing.torch_threads)."""
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def clear_registry():
    t_species._ALL_SPECIES.clear()
    yield
    t_species._ALL_SPECIES.clear()


def test_split_step_equals_full_step():
    sim, laser = tiny_tiled_laser_target(lambdapic_torch, device="cpu")
    sim.run(3, callbacks=[laser])
    saved = (copy.deepcopy(sim.state), sim.itime, sim.time)
    seen = []
    probe = lambdapic_torch.callback(stage="_interpolator")(
        lambda s: seen.append(s.get_particles(0)["ex_part"].size))
    sim.run(1, callbacks=[laser, probe])
    split = sim.state
    assert len(seen) == 1 and seen[0] > 0
    sim.state, sim.itime, sim.time = saved
    sim.run(1, callbacks=[laser])
    full = sim.state
    for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho"):
        assert torch.equal(getattr(split.fields, k),
                           getattr(full.fields, k)), k
    for ps, pf in zip(split.particles, full.particles):
        assert torch.equal(ps.alive, pf.alive)
        for k in pf.data:
            if k not in EB_PART:
                assert torch.equal(ps.data[k], pf.data[k]), k


def test_recapacity_grows_last_axis_and_keeps_ids():
    sim, laser = tiny_tiled_laser_target(
        lambdapic_torch, device="cpu", particle_capacity_factor=1.01,
        recap_interval=2)
    sim.initialize()
    caps0 = [p.cap for p in sim.state.particles]
    shapes0 = [tuple(p.alive.shape) for p in sim.state.particles]

    def ids(p):
        return np.sort(ids_to_numpy(p.data["id_lo"])[p.alive.numpy()])
    ids0 = [ids(p) for p in sim.state.particles]
    sim.run(4, callbacks=[laser])
    grew = False
    for p, cap0, shape0, i0 in zip(sim.state.particles, caps0, shapes0,
                                   ids0):
        assert tuple(p.alive.shape[:2]) == shape0[:2]
        assert p.cap == p.alive.shape[-1] >= cap0
        grew |= p.cap > cap0
        np.testing.assert_array_equal(ids(p), i0)
        assert int(p.overflow) == 0
    assert grew
    assert [st.cap for st in sim._species_static] == \
        [p.cap for p in sim.state.particles]


def _sim(**kw):
    kw.setdefault("tiling", (16, 16))
    return lambdapic_torch.Simulation(nx=64, ny=32, dx=5e-8, dy=5e-8,
                                      device="cpu", **kw)


REFUSALS = [
    (dict(tiling=None), NotImplementedError, "item 12"),
    (dict(tiling_backend="pallas"), NotImplementedError, "item 13"),
    (dict(npatch_x=2, npatch_y=1), NotImplementedError, "item 15"),
    (dict(tiling=(12, 16)), ValueError, "divisible"),
    (dict(tiling=(4, 16)), ValueError, "2\\*n_guard"),
    (dict(rebin_interval=4), ValueError, "needs n_guard >= 5"),
    (dict(tiling=(16,)), ValueError, "pair of positive ints"),
]


@pytest.mark.parametrize("kw,exc,match", REFUSALS)
def test_refusals(kw, exc, match):
    sim = _sim(**kw)
    sim.add_species([lambdapic_torch.Electron(density=lambda x, y: 1e25,
                                              ppc=1)])
    with pytest.raises(exc, match=match):
        sim.initialize()


def test_refuses_3d_tiling_and_pairs():
    sim = lambdapic_torch.Simulation3D(nx=16, ny=16, nz=16, dx=5e-8,
                                       dy=5e-8, dz=5e-8, tiling=(8, 8),
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="2D-only.*item 13"):
        sim.initialize()
    t_species._ALL_SPECIES.clear()
    pho = lambdapic_torch.Photon()
    pho.set_bw_pair(electron=lambdapic_torch.Electron(),
                    positron=lambdapic_torch.Electron())
    sim = _sim()
    sim.add_species([pho])
    with pytest.raises(NotImplementedError, match="item 9"):
        sim.initialize()


def test_step_refuses_a_state_of_the_other_layout():
    sim, laser = tiny_tiled_laser_target(lambdapic_torch, device="cpu")
    sim.initialize()
    sim.state = sim.state.replace(particles=tuple(
        p.replace(tiled=False) for p in sim.state.particles))
    with pytest.raises(ValueError, match="binned per cell.*tiled engine"):
        sim.run(1, callbacks=[laser])
