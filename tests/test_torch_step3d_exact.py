"""The port's 3D per-stage engine with ``cell_migration="exact"`` against
the JAX package's, end to end (float64, CPU).

tests/test_torch_step3d.py's tiny 3D laser-target (32 x 16 x 16 cells,
electrons with momenta along every axis and protons, PML on all six faces,
GaussianLaser3D) at 4 slots a cell, so that some cells overfill and the
exact re-binning merges and drops rows (counted in the overflow), run
four steps in both Simulation3Ds from the same seed. The JAX CPU run
re-bins with stable lax.sort in the exact scheme and the port keeps the
same stable order, so the slots are compared in place (alive masks and
ids equal where they sit), other attributes to rtol 1e-9
(compare_slots), fields to rtol 1e-9 of their peak (the current sums run
in another order).
"""
import numpy as np
import pytest

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.testing import compare_slots, torch_threads

from test_torch_step3d import _config

NSTEPS = 4
FIELDS = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")


@pytest.fixture(autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def clear_registries():
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()
    yield
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()


def test_exact_laser_target_3d_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    import jax
    import lambdapic_tpu
    import lambdapic_torch

    def make(pkg, **extra):
        species, laser, kw = _config(pkg)
        kw.update(particle_capacity_factor=2.0, cell_migration="exact")
        sim = pkg.Simulation3D(**kw, **extra)
        sim.add_species(species)
        return sim, laser

    jsim, laser = make(lambdapic_tpu, npatch_x=1, npatch_y=1, npatch_z=1)
    jsim.run(NSTEPS, callbacks=[laser])
    jstate = jax.device_get(jsim.state)

    tsim, laser = make(lambdapic_torch, device="cpu")
    tsim.initialize()
    assert [p.cap for p in tsim.state.particles] == [4, 4]
    n0 = tsim.npart_alive
    ids0 = [np.sort(tsim.get_particles(i)["id_lo"]) for i in range(2)]
    tsim.run(NSTEPS, callbacks=[laser])
    tstate = state_to_numpy(tsim.state, dimension=3)
    # the per-stage engine ran, not kernel B2's plain version
    assert tsim._builder.transients_valid == {0: False, 1: False}

    for k in FIELDS:
        ref = np.asarray(getattr(jstate.fields, k))
        assert ref.shape == (32, 16, 16)
        np.testing.assert_allclose(getattr(tstate.fields, k), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=k)
    assert np.abs(tstate.fields.jx).max() > 0
    for jp, tp in zip(jstate.particles, tstate.particles):
        ref = {k: np.asarray(v)[0, 0, 0] for k, v in jp.data.items()}
        ref_alive = np.asarray(jp.alive)[0, 0, 0]
        got = {k: v[0, 0, 0] for k, v in tp.data.items()}
        # in place: both packages' exact re-binning keeps the stable order
        np.testing.assert_array_equal(tp.alive[0, 0, 0], ref_alive)
        for k in ("id_lo", "id_hi"):
            np.testing.assert_array_equal(got[k][ref_alive],
                                          ref[k][ref_alive], err_msg=k)
        compare_slots(ref, ref_alive, got, tp.alive[0, 0, 0], rtol=1e-9)
        assert int(np.asarray(tp.overflow).sum()) == \
            int(np.asarray(jp.overflow).sum())
    # the electrons overfilled cells: rows merged or dropped, all counted;
    # every other id is kept (the electrons may also leave through a face)
    lost = [int(np.asarray(p.overflow).sum()) for p in tstate.particles]
    assert lost[0] > 0
    ids1 = [np.sort(tsim.get_particles(i)["id_lo"]) for i in range(2)]
    assert np.isin(ids1[0], ids0[0]).all()
    assert len(ids1[0]) + lost[0] <= n0[0]
    assert lost[1] == 0
    np.testing.assert_array_equal(ids1[1], ids0[1])
