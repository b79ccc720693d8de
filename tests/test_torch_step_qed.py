"""The port's QED step end to end against the JAX package, and the
emission-rate statistics on the port alone.

A tiny radiating run (periodic 32 x 32, one device, float64): electrons
with gamma 2000 in a uniform Bz at chi ~ 1, as in tests/test_qed.py, go
through N steps of both Simulations from the same seed. The two make the
same draws (lambdapic_torch.random is jax.random bit for bit). A draw
belongs to a slot, not to a particle, so the slots of each cell must also
be in the same order: the JAX side runs its XLA cell path on the CPU
(LAMBDAPIC_FIELDS_PALLAS=0) with its re-binning's sort swapped, for this
test only, for the Batcher compare-exchange list that the TPU kernel and
the port use (ROADMAP's oracle for kernel B2; stable lax.sort orders tied
keys differently). Then the same electrons fire, the same photons are
born with the same ids, and merges pair alike. Slots are compared after
canonicalisation by id, floats to rtol 1e-9 (the fields' current sums
run in another order).
"""
import numpy as np
import pytest

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.testing import QED_PAYLOADS, SLOT_FLOATS, compare_slots
from lambdapic_torch.testing import torch_threads

NSTEPS = 5
N_ELE = 150


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


def _radiating_sim(pkg, n, gamma, chi_target, photon_capacity, seed=3,
                   **extra):
    """A periodic 32 x 32 float64 Simulation of ``pkg`` with ``n``
    electrons of Lorentz factor ``gamma`` moving along x in a uniform Bz
    set for ``chi_target``."""
    from lambdapic_torch.constants import c, e, hbar, m_e
    bc = {k: "periodic" for k in ("xmin", "xmax", "ymin", "ymax")}
    pho = pkg.Photon(capacity=photon_capacity)
    ele = pkg.Electron(radiation="photons")
    ele.set_photon(pho)
    sim = pkg.Simulation(nx=32, ny=32, dx=1e-7, dy=1e-7,
                         boundary_conditions=bc, random_seed=seed,
                         precision="double", tiling="cell", **extra)
    sim.add_species([ele, pho])
    sim.initialize()
    ux = np.sqrt(gamma**2 - 1)
    rng = np.random.default_rng(1)
    coords = {"x": rng.uniform(0.3e-6, 2.9e-6, n),
              "y": rng.uniform(0.3e-6, 2.9e-6, n)}
    attrs = {"w": np.ones(n), "ux": np.full(n, ux), "uy": np.zeros(n),
             "uz": np.zeros(n), "inv_gamma": np.full(n, 1 / gamma)}
    sim.set_particles_global(0, coords, attrs)
    bz = chi_target / (e * hbar / (m_e**2 * c**3) * c * ux)
    sim.set_field("bz", np.full((32, 32), bz))
    return sim


def test_qed_step_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    import jax
    import lambdapic_tpu
    import lambdapic_torch
    from lambdapic_tpu.ops import cell2d as j_cell2d
    from test_torch_cellstep import batcher_sort_jnp

    xla_migrate = j_cell2d.migrate_cells

    def batcher_migrate(*args, sort_fn=None, **kw):
        return xla_migrate(*args, sort_fn=sort_fn or batcher_sort_jnp, **kw)
    monkeypatch.setattr(j_cell2d, "migrate_cells", batcher_migrate)

    kw = dict(n=N_ELE, gamma=2000.0, chi_target=1.0, photon_capacity=16384)
    jsim = _radiating_sim(lambdapic_tpu, npatch_x=1, npatch_y=1, **kw)
    jsim.run(NSTEPS)
    jstate = jax.device_get(jsim.state)
    tsim = _radiating_sim(lambdapic_torch, device="cpu", **kw)
    assert [p.cap for p in tsim.state.particles] == \
        [np.asarray(p.alive).shape[2] for p in jstate.particles]
    tsim.run(NSTEPS)
    tstate = state_to_numpy(tsim.state)

    assert [int(np.asarray(p.overflow).sum()) for p in tstate.particles] \
        == [int(np.asarray(p.overflow).sum()) for p in jstate.particles]
    n_ph = jsim.npart_alive[1]
    assert n_ph > 20
    assert tsim.npart_alive == jsim.npart_alive
    assert int(np.asarray(tstate.particles[1].next_id).sum()) == \
        int(np.asarray(jstate.particles[1].next_id).sum())

    for jp, tp in zip(jstate.particles, tstate.particles):
        keys = SLOT_FLOATS + tuple(k for k in QED_PAYLOADS + ("chi",)
                                   if k in tp.data)
        compare_slots({k: np.asarray(v)[0, 0] for k, v in jp.data.items()},
                      np.asarray(jp.alive)[0, 0],
                      {k: v[0, 0] for k, v in tp.data.items()},
                      tp.alive[0, 0], rtol=1e-9, keys=keys)
    for k in ("ex", "ey", "bz", "jx", "jy"):
        ref = np.asarray(getattr(jstate.fields, k))
        np.testing.assert_allclose(getattr(tstate.fields, k), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=k)

    # photons (none merged here): the parent's weight, inv_gamma = 1/|u|,
    # momentum below the parent's
    assert int(tstate.particles[1].overflow.sum()) == 0
    ph = tsim.get_particles(1)
    umag = np.sqrt(ph["ux"]**2 + ph["uy"]**2 + ph["uz"]**2)
    np.testing.assert_allclose(ph["w"], 1.0, rtol=1e-12)
    np.testing.assert_allclose(ph["inv_gamma"], 1 / umag, rtol=1e-12)
    assert 0 < umag.min() and umag.max() < np.sqrt(2000.0**2 - 1)


def test_qed_initial_state_matches_jax():
    """example/photons.py's species wiring, small: both packages build the
    same initial arrays (the radiating electrons carry chi, tau, delta and
    event; the photons start all dead, their capacity floored at the
    electrons')."""
    import jax
    import lambdapic_tpu
    import lambdapic_torch
    sims = []
    for pkg, extra in ((lambdapic_tpu, dict(npatch_x=1, npatch_y=1)),
                       (lambdapic_torch, dict(device="cpu"))):
        pho = pkg.Photon(capacity=1 << 14)
        ele = pkg.Electron(density=lambda x, y: np.where(x > 1e-6, 1e27, 0.0),
                           ppc=3, radiation="photons")
        ele.set_photon(pho)
        sim = pkg.Simulation(nx=32, ny=24, dx=1e-7, dy=1e-7, tiling="cell",
                             random_seed=5, precision="double", **extra)
        sim.add_species([ele, pkg.Proton(density=ele.density, ppc=2), pho])
        sim.initialize()
        sims.append(sim)
    jstate = jax.device_get(sims[0].state)
    tstate = state_to_numpy(sims[1].state)
    assert sims[1].npart_alive == sims[0].npart_alive
    assert sims[1].npart_alive[2] == 0
    for jp, tp in zip(jstate.particles, tstate.particles):
        assert sorted(tp.data) == sorted(jp.data)
        np.testing.assert_array_equal(tp.alive, np.asarray(jp.alive))
        assert int(tp.next_id.sum()) == int(np.asarray(jp.next_id).sum())
        for k, v in jp.data.items():
            np.testing.assert_array_equal(tp.data[k], np.asarray(v),
                                          err_msg=k)
    caps = [p.alive.shape[2] for p in tstate.particles]
    assert caps[2] >= caps[0] and "tau" in tstate.particles[0].data


def test_emission_rate_matches_table():
    """Photon count after N steps against the optical-depth statistics:
    per-step event probability p = 1 - exp(-W dt / gamma), at most one
    event per particle per step (tests/test_qed.py's check, on the port's
    cell engine). Photons that merged or found no free slot are counted
    through the photon species' overflow."""
    import lambdapic_torch
    from lambdapic_torch.models.qed_tables import load_tables
    n, gamma, chi_target, nsteps = 2000, 20000.0, 0.5, 5
    sim = _radiating_sim(lambdapic_torch, n, gamma, chi_target, 65536,
                         seed=7, device="cpu")
    sim.run(nsteps=nsteps)
    t = load_tables()
    grid = np.linspace(*t["log_chi_range"], int(t["chi_N"]))
    W = np.interp(np.log10(chi_target), grid, t["photon_prob_rate_total"])
    p_step = 1 - np.exp(-W * sim.dt / gamma)
    # first-event expectation; recoil secondaries add a few percent
    expected = n * (1 - (1 - p_step) ** nsteps)
    emitted = sim.npart_alive[1] + int(sim.state.particles[1].overflow)
    assert expected > 50
    assert expected * 0.85 - 4 * np.sqrt(expected) < emitted < \
        expected * 1.3 + 4 * np.sqrt(expected)
    assert sim.npart_alive[0] == n
