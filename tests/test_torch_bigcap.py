"""Per-cell capacities above 128 slots against the JAX package, which has
no per-cell limit (its ``_grow_capacity`` and ``initfill.bin_cells`` take
any capacity). The port's sorting kernels once packed the slot index into
8 bits of their sort key and the port held every species at 128 slots a
cell; they now pack 16 bits and sort in a global scratch above 128
(kernel-against-plain checks at caps 130 and 256 are in
tests/test_torch_kernels.py and tests/test_torch_kernels3d.py, marked
``gpu``).

1. The tiny 2D laser-target of lambdapic_torch.testing.tiny_laser_target
   with particle_capacity_factor 40: the electrons start at 160 slots a
   cell, the protons at 80. Four steps in both packages from the same
   seed (float64): equal capacities, no merge, fields to rtol 1e-9 of
   their peak and slots to rtol 1e-9 after canonicalisation (the current
   sums run in another order), as tests/test_torch_step.py.
2. A re-capacity past 128 through ``_maybe_recap``: the electrons start
   at 100 slots a cell, merge pressure is recorded in both packages alike
   after two steps, and the growth rule (1.5x) asks for 150. JAX grows to
   150 and so must the port; the two runs then agree for two more steps.
"""
import numpy as np
import pytest

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.testing import compare_slots, tiny_laser_target
from lambdapic_torch.testing import torch_threads

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


def _sims(factor):
    import lambdapic_tpu
    import lambdapic_torch
    jsim, jlaser = tiny_laser_target(lambdapic_tpu, npatch_x=1, npatch_y=1,
                                     particle_capacity_factor=factor)
    tsim, tlaser = tiny_laser_target(lambdapic_torch, device="cpu",
                                     particle_capacity_factor=factor)
    jsim.initialize()
    tsim.initialize()
    return jsim, jlaser, tsim, tlaser


def _caps(jsim, tsim):
    import jax
    jcaps = [np.asarray(p.alive).shape[2]
             for p in jax.device_get(jsim.state).particles]
    tcaps = [p.cap for p in tsim.state.particles]
    assert tcaps == jcaps == [s.cap for s in tsim._species_static]
    return tcaps


def _compare(jsim, tsim):
    import jax
    jstate = jax.device_get(jsim.state)
    tstate = state_to_numpy(tsim.state)
    assert tsim.npart_alive == jsim.npart_alive
    for k in FIELDS:
        ref = np.asarray(getattr(jstate.fields, k))
        np.testing.assert_allclose(getattr(tstate.fields, k), ref, rtol=0,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=k)
    assert np.abs(tstate.fields.jx).max() > 0
    for jp, tp in zip(jstate.particles, tstate.particles):
        assert int(tp.overflow.sum()) == int(np.asarray(jp.overflow).sum())
        compare_slots({k: np.asarray(v)[0, 0] for k, v in jp.data.items()},
                      np.asarray(jp.alive)[0, 0],
                      {k: v[0, 0] for k, v in tp.data.items()},
                      tp.alive[0, 0], rtol=1e-9)


def test_species_above_128_slots_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    jsim, jlaser, tsim, tlaser = _sims(40.0)
    assert _caps(jsim, tsim) == [160, 80]
    jsim.run(4, callbacks=[jlaser])
    tsim.run(4, callbacks=[tlaser])
    assert _caps(jsim, tsim) == [160, 80]
    assert [int(p.overflow) for p in tsim.state.particles] == [0, 0]
    _compare(jsim, tsim)


def test_recap_past_128_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    jsim, jlaser, tsim, tlaser = _sims(25.0)
    assert _caps(jsim, tsim) == [100, 50]
    jsim.run(2, callbacks=[jlaser])
    tsim.run(2, callbacks=[tlaser])
    # merge pressure on the electrons: a merge count of a tenth of their
    # population (the trigger is 0.5%), recorded alike on both sides
    n = tsim.npart_alive[0] // 10
    for sim in (jsim, tsim):
        parts = list(sim.state.particles)
        parts[0] = parts[0].replace(overflow=parts[0].overflow + n)
        sim.state = sim.state.replace(particles=tuple(parts))
        sim._maybe_recap()
    assert _caps(jsim, tsim) == [150, 50]
    jsim.run(2, callbacks=[jlaser])
    tsim.run(2, callbacks=[tlaser])
    _compare(jsim, tsim)
