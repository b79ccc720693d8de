"""The port's 2D cell-engine step end to end against the JAX package: a
tiny laser-target (electrons and protons, a y-dependent momentum profile
so particles cross cells, PML on all faces, GaussianLaser2D) run for
five steps in float64 by both Simulations from the same seed.

The JAX side runs its XLA cell path on the CPU (LAMBDAPIC_FIELDS_PALLAS=0
keeps its fields update out of Pallas interpret mode; ops/maxwell.py is
what that kernel is tested against). Its re-binning sorts with stable
lax.sort, which pairs merging particles differently from the Batcher
order the port (and the TPU kernel) use, so the test asserts that no
merge happened. Fields agree to rtol 1e-9 (the current sums run in
another order); particles agree slot for slot after canonicalisation.
"""
import numpy as np
import pytest
import torch

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.testing import compare_slots, torch_threads

UM = 1e-6
NSTEPS = 5
FIELDS = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: beside the other test processes a full pool
    waits on their threads (lambdapic_torch.testing.torch_threads)."""
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def clear_registries():
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()
    yield
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()


def _config(pkg):
    l0 = 0.8 * UM
    nx = ny = 32
    dx = l0 / 16
    Lx, Ly = nx * dx, ny * dx
    nc = 1.742e27

    def density(x, y):
        return np.where((x > Lx / 2) & (x < Lx / 2 + 0.4 * UM), 5 * nc, 0.0)

    def ux(x, y):
        return 1.5 * np.sin(2 * np.pi * y / Ly)

    def uz(x, y):
        return 0.3 * np.cos(2 * np.pi * y / Ly)

    species = [pkg.Electron(density=density, ppc=4, momentum=(ux, None, uz)),
               pkg.Proton(density=density, ppc=2)]
    laser = pkg.GaussianLaser2D(a0=2, l0=l0, w0=0.6 * UM, ctau=0.5 * UM,
                                x0=0.0, focus_position=Lx / 4)
    # capacity headroom keeps the overwrite-merge re-binning merge-free
    sim_kw = dict(nx=nx, ny=ny, dx=dx, dy=dx, tiling="cell", random_seed=1,
                  precision="double", particle_capacity_factor=4.0)
    return species, laser, sim_kw


def _home_cells(np_state):
    """id_lo -> flat cell index of every alive particle, per species."""
    out = []
    for p in np_state.particles:
        alive = np.asarray(p.alive)[0, 0]
        ids = np.asarray(p.data["id_lo"])[0, 0]
        cell = np.broadcast_to(np.arange(alive[0].size).reshape(alive.shape[1:]),
                               alive.shape)
        out.append(dict(zip(ids[alive].tolist(), cell[alive].tolist())))
    return out


def test_laser_target_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    import jax
    import lambdapic_tpu
    import lambdapic_torch

    species, laser, kw = _config(lambdapic_tpu)
    jsim = lambdapic_tpu.Simulation(npatch_x=1, npatch_y=1, **kw)
    jsim.add_species(species)
    jsim.run(NSTEPS, callbacks=[laser])
    jstate = jax.device_get(jsim.state)

    species, laser, kw = _config(lambdapic_torch)
    tsim = lambdapic_torch.Simulation(device="cpu", **kw)
    tsim.add_species(species)
    tsim.initialize()
    start = _home_cells(state_to_numpy(tsim.state))
    tsim.run(NSTEPS, callbacks=[laser])
    tstate = state_to_numpy(tsim.state)

    # guards on the test itself: no merge (lax.sort and the Batcher order
    # pair merges differently), and particles did change cells
    assert [int(np.asarray(p.overflow).sum()) for p in jstate.particles] \
        == [0, 0]
    assert [int(np.asarray(p.overflow).sum()) for p in tstate.particles] \
        == [0, 0]
    end = _home_cells(tstate)
    moved = sum(int(s[i] != e[i]) for s, e in zip(start, end) for i in s)
    assert moved > 0
    assert tsim.itime == jsim.itime == NSTEPS

    for k in FIELDS:
        ref = np.asarray(getattr(jstate.fields, k))
        np.testing.assert_allclose(getattr(tstate.fields, k), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=k)
    for k, v in jstate.fields.psi.items():
        ref = np.asarray(v)
        np.testing.assert_allclose(tstate.fields.psi[k], ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=k)
    rho = jsim.get_field("rho")
    np.testing.assert_allclose(tsim.get_field("rho"), rho, rtol=1e-9,
                               atol=1e-9 * np.abs(rho).max())
    assert np.abs(rho).max() > 0

    for jp, tp in zip(jstate.particles, tstate.particles):
        ref = {k: np.asarray(v)[0, 0] for k, v in jp.data.items()}
        got = {k: v[0, 0] for k, v in tp.data.items()}
        compare_slots(ref, np.asarray(jp.alive)[0, 0], got, tp.alive[0, 0],
                      rtol=1e-9)


def _port_sim(**extra):
    import lambdapic_torch
    species, laser, kw = _config(lambdapic_torch)
    sim = lambdapic_torch.Simulation(device="cpu", **{**kw, **extra})
    sim.add_species(species)
    return sim, laser


def test_segmented_step_equals_full_step():
    """A host callback at maxwell_1 splits the step into its three
    segments; the result is bit for bit the fused step's."""
    from lambdapic_torch import callback
    seen = []
    sims = []
    for cbs in ([], [callback(stage="maxwell_1")(lambda s: seen.append(s.itime))]):
        t_species._ALL_SPECIES.clear()
        sim, laser = _port_sim()
        sim.run(3, callbacks=[laser] + cbs)
        sims.append(state_to_numpy(sim.state))
    assert seen == [0, 1, 2]
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(sims[1].fields, k),
                                      getattr(sims[0].fields, k), err_msg=k)
    for a, b in zip(sims[0].particles, sims[1].particles):
        for k in a.data:
            np.testing.assert_array_equal(b.data[k], a.data[k], err_msg=k)


def test_grow_capacity_pads_dead_slots():
    """Re-capacity pads the slot axis with dead slots (inv_gamma 1) and
    leaves the population unchanged; the run goes on."""
    sim, laser = _port_sim()
    sim.initialize()
    old = sim.state.particles[0]
    cap = old.cap
    sim._grow_capacity(0, cap + 5)
    new = sim.state.particles[0]
    assert new.cap == cap + 6 == sim._species_static[0].cap   # kept even
    for k, v in old.data.items():
        assert torch.equal(new.data[k][:cap], v), k
        fill = 1 if k == "inv_gamma" else 0
        assert bool((new.data[k][cap:] == fill).all()), k
    assert torch.equal(new.alive[:cap], old.alive)
    assert not bool(new.alive[cap:].any())
    n0 = sim.npart_alive
    sim.run(2, callbacks=[laser])
    assert sim.npart_alive == n0


def test_grow_capacity_stops_at_kernel_limit():
    """Re-capacity no longer stops at a kernel limit: the sorting kernels
    take any per-cell capacity (a 16-bit slot index), so a request past
    128 slots grows the species as the JAX package does, a smaller one
    leaves it, and the run goes on."""
    sim, laser = _port_sim()
    sim.initialize()
    assert sim._grow_capacity(0, 128 + 50)
    assert sim.state.particles[0].cap == 178 == sim._species_static[0].cap
    assert sim._grow_capacity(0, 2 * 128)
    assert sim.state.particles[0].cap == 256 == sim._species_static[0].cap
    assert not sim._grow_capacity(0, 200)
    assert sim.state.particles[0].cap == 256
    n0 = sim.npart_alive
    sim.run(1, callbacks=[laser])
    assert sim.npart_alive == n0
