"""QED photon emission under the port's tiled engine against the JAX
package: tests/test_qed_tiled.py::test_tiled_photon_emission with (8, 8)
tiles on one device (32 x 32 periodic cells, 200 electrons at gamma 2000
in a uniform Bz that gives chi ~ 1, a photon species of capacity 32768,
float64, seed 3), ten steps through both Simulations.

Photons are born through insert_tiled into their parents' tiles. A
draw belongs to a slot, and both sides keep the same slot order (stable
re-binning sorts), so the draws, the events and the newborns agree: the
states match slot for slot (alive masks and ids equal, the other
attributes within testing.compare_slots' rtol 1e-11 and its floor of
1e-14 of each attribute's peak; the QED sampler's Chebyshev sum rounds
in another order), and the test's own physics checks hold on the port.
"""
import numpy as np
import pytest

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from test_torch_step_tiled import assert_states_match

NSTEPS = 10
N = 200
GAMMA = 2000.0


@pytest.fixture(autouse=True)
def clear_registries():
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()
    yield
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()


def _radiating_sim(pkg, **kw):
    from lambdapic_tpu.constants import c, e, hbar, m_e
    pho = pkg.Photon(capacity=32768)
    ele = pkg.Electron(radiation="photons")
    ele.set_photon(pho)
    bc = {k: "periodic" for k in ("xmin", "xmax", "ymin", "ymax")}
    sim = pkg.Simulation(nx=32, ny=32, dx=1e-7, dy=1e-7,
                         boundary_conditions=bc, random_seed=3,
                         precision="double", tiling=(8, 8), **kw)
    sim.add_species([ele, pho])
    sim.initialize()
    ux = np.sqrt(GAMMA**2 - 1)
    rng = np.random.default_rng(0)
    coords = {"x": rng.uniform(0.5e-6, 2.5e-6, N),
              "y": rng.uniform(0.5e-6, 2.5e-6, N)}
    attrs = {"w": np.ones(N), "ux": np.full(N, ux), "uy": np.zeros(N),
             "uz": np.zeros(N), "inv_gamma": np.full(N, 1 / GAMMA)}
    sim.set_particles_global(0, coords, attrs)
    bz = 1.0 / (e * hbar / (m_e**2 * c**3) * c * ux)     # chi ~ 1
    sim.set_field("bz", np.full((32, 32), bz))
    return sim


def test_tiled_photon_emission_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    import jax
    import lambdapic_tpu
    import lambdapic_torch

    jsim = _radiating_sim(lambdapic_tpu, npatch_x=1, npatch_y=1)
    jsim.run(nsteps=NSTEPS)
    tsim = _radiating_sim(lambdapic_torch, device="cpu")
    tsim.run(nsteps=NSTEPS - 1)
    first_new = int(tsim.state.particles[1].next_id)
    tsim.run(nsteps=1)
    assert [p.cap for p in tsim.state.particles] == \
        [int(np.asarray(p.alive).shape[-1]) for p in jsim.state.particles]
    assert_states_match(jax.device_get(jsim.state),
                        state_to_numpy(tsim.state))

    # tests/test_qed_tiled.py's checks, on the port
    ux = np.sqrt(GAMMA**2 - 1)
    e, ph = tsim.get_particles(0), tsim.get_particles(1)
    assert len(e["w"]) == N
    n_ph = len(ph["w"])
    assert n_ph > 0, "no photons emitted at chi ~ 1 after 10 steps"
    np.testing.assert_allclose(ph["w"], 1.0, rtol=1e-12)
    u_ph = np.sqrt(ph["ux"]**2 + ph["uy"]**2 + ph["uz"]**2)
    assert 0 < u_ph.min() and u_ph.max() < ux
    np.testing.assert_allclose(ph["inv_gamma"], 1 / u_ph, rtol=1e-9)
    assert ph["x"].min() >= -0.5e-7 and ph["x"].max() < 3.15e-6
    assert ph["y"].min() >= -0.5e-7 and ph["y"].max() < 3.15e-6
    assert e["ux"].sum() < ux * N
    ids = (ph["id_hi"].astype(np.uint64) << np.uint64(32)) | \
        ph["id_lo"].astype(np.uint64)
    assert len(np.unique(ids)) == n_ph
    # the last step's newborns sit in their parents' tiles, at their
    # parents' positions
    el, pp = state_to_numpy(tsim.state).particles
    born = pp.alive & (pp.data["id_lo"] >= first_new)
    assert born.sum() > 0
    for i, j in zip(*np.nonzero(born[0, 0].any(-1))):
        pos_e = set(zip(el.data["x"][0, 0, i, j][el.alive[0, 0, i, j]],
                        el.data["y"][0, 0, i, j][el.alive[0, 0, i, j]]))
        b = born[0, 0, i, j]
        assert set(zip(pp.data["x"][0, 0, i, j][b],
                       pp.data["y"][0, 0, i, j][b])) <= pos_e
