"""The port's per-stage engine with ``cell_migration="exact"`` against the
JAX package's, end to end (float64, CPU).

1. A tiny 2D laser-target (48 x 32 cells, electrons and protons, PML, a
   GaussianLaser2D; lambdapic_torch.testing.tiny_laser_target) for four
   steps in both Simulations from the same seed. The exact re-binning
   sorts stably on both sides, so the slots are compared in place (alive
   masks and ids equal where they sit), other attributes to rtol 1e-9
   (compare_slots), fields to rtol 1e-9 of their peak (the current sums
   run in another order).
2. The same with a radiating electron species and photons
   (tests/test_torch_step_qed.py's set-up, chi ~ 1): the stable order
   makes both runs draw for the same particles, so the same electrons
   fire and the same photons are born, slot for slot.
"""
import numpy as np
import pytest

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.testing import (QED_PAYLOADS, SLOT_FLOATS,
                                     compare_slots, tiny_laser_target)
from lambdapic_torch.testing import torch_threads

NSTEPS = 4
FIELDS = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")


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


def _compare(jstate, tstate, rtol, keys=SLOT_FLOATS):
    for k in FIELDS:
        ref = np.asarray(getattr(jstate.fields, k))
        np.testing.assert_allclose(getattr(tstate.fields, k), ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max(), err_msg=k)
    for jp, tp in zip(jstate.particles, tstate.particles):
        ref = {k: np.asarray(v)[0, 0] for k, v in jp.data.items()}
        ref_alive = np.asarray(jp.alive)[0, 0]
        got = {k: v[0, 0] for k, v in tp.data.items()}
        # in place: both packages' exact re-binning sorts stably
        np.testing.assert_array_equal(tp.alive[0, 0], ref_alive)
        for k in ("id_lo", "id_hi"):
            np.testing.assert_array_equal(got[k][ref_alive],
                                          ref[k][ref_alive], err_msg=k)
        compare_slots(ref, ref_alive, got, tp.alive[0, 0], rtol=rtol,
                      keys=tuple(k for k in keys if k in got))
        assert int(np.asarray(tp.overflow).sum()) == \
            int(np.asarray(jp.overflow).sum())


def test_exact_laser_target_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    import jax
    import lambdapic_tpu
    import lambdapic_torch
    jsim, laser = tiny_laser_target(lambdapic_tpu, npatch_x=1, npatch_y=1,
                                    cell_migration="exact")
    jsim.run(NSTEPS, callbacks=[laser])
    jstate = jax.device_get(jsim.state)
    tsim, laser = tiny_laser_target(lambdapic_torch, device="cpu",
                                    cell_migration="exact")
    tsim.initialize()
    ids0 = [np.sort(p["id_lo"]) for p in (tsim.get_particles(i)
                                           for i in range(2))]
    tsim.run(NSTEPS, callbacks=[laser])
    tstate = state_to_numpy(tsim.state)
    _compare(jstate, tstate, rtol=1e-9)
    assert np.abs(tstate.fields.jx).max() > 0
    # lossless: every particle is kept (nothing reaches a face here)
    for i, ids in enumerate(ids0):
        np.testing.assert_array_equal(np.sort(tsim.get_particles(i)["id_lo"]),
                                      ids)
    # the per-stage engine ran, not kernel B2's plain version
    assert tsim._builder.transients_valid == {0: False, 1: False}


def test_exact_qed_step_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    import jax
    import lambdapic_tpu
    import lambdapic_torch
    from test_torch_step_qed import _radiating_sim
    kw = dict(n=150, gamma=2000.0, chi_target=1.0, photon_capacity=16384,
              cell_migration="exact")
    jsim = _radiating_sim(lambdapic_tpu, npatch_x=1, npatch_y=1, **kw)
    jsim.run(NSTEPS)
    jstate = jax.device_get(jsim.state)
    tsim = _radiating_sim(lambdapic_torch, device="cpu", **kw)
    tsim.run(NSTEPS)
    tstate = state_to_numpy(tsim.state)
    assert jsim.npart_alive[1] > 20
    assert tsim.npart_alive == jsim.npart_alive
    _compare(jstate, tstate, rtol=1e-9,
             keys=SLOT_FLOATS + QED_PAYLOADS + ("chi",))
    # the radiating species' gathered fields are this step's
    assert tsim._builder.transients_valid[0]
    assert "ex_part" in tsim.get_particles(0)
    assert "ex_part" not in tsim.get_particles(1)
