"""The port's tiled 2D engine end to end against the JAX package: a tiny
laser-target (64 x 32 cells, tiling (16, 16), electrons and protons in a
foil whose front sits on a tile face, a y-dependent momentum so that
particles cross tiles, PML on all faces, GaussianLaser2D) run for six
steps in float64 by both Simulations from the same seed, once with
rebin_interval=1 and once with rebin_interval=2 (the JAX side then also
builds its step without migration, run on steps 0, 2 and 4).

The JAX side runs tiling_backend "xla" on the CPU, i.e. the dense
functions that ops/tiled2d.py ports (LAMBDAPIC_FIELDS_PALLAS=0 keeps its
fields update out of Pallas interpret mode). Both sides re-bin with
stable sorts, so particles agree slot for slot: alive masks and ids
equal, the other attributes within testing.compare_slots' rtol 1e-11 and
its floor of 1e-14 of each attribute's peak. Fields agree to rtol 1e-11
with a floor of 1e-14 of each array's peak (the current sums run in
another order).
"""
import numpy as np
import pytest

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.testing import compare_slots, tiny_tiled_laser_target
from lambdapic_torch.testing import torch_threads

NSTEPS = 6
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


def _tiles_of(np_state):
    """id_lo -> flat tile index of every alive particle, per species."""
    out = []
    for p in np_state.particles:
        alive = np.asarray(p.alive)[0, 0]
        ids = np.asarray(p.data["id_lo"])[0, 0]
        tile = np.broadcast_to(np.arange(alive[..., 0].size).reshape(
            alive.shape[:2] + (1,)), alive.shape)
        out.append(dict(zip(ids[alive].tolist(), tile[alive].tolist())))
    return out


def assert_states_match(jstate, tstate):
    for k in FIELDS:
        ref = np.asarray(getattr(jstate.fields, k))
        np.testing.assert_allclose(getattr(tstate.fields, k), ref,
                                   rtol=1e-11, atol=1e-14 * np.abs(ref).max(),
                                   err_msg=k)
    for k, v in jstate.fields.psi.items():
        ref = np.asarray(v)
        np.testing.assert_allclose(tstate.fields.psi[k], ref, rtol=1e-11,
                                   atol=1e-14 * np.abs(ref).max(), err_msg=k)
    for jp, tp in zip(jstate.particles, tstate.particles):
        ja, ta = np.asarray(jp.alive)[0, 0], tp.alive[0, 0]
        np.testing.assert_array_equal(ta, ja)
        # slot axis first, as compare_slots takes it
        ref = {k: np.moveaxis(np.asarray(v)[0, 0], -1, 0)
               for k, v in jp.data.items()}
        got = {k: np.moveaxis(v[0, 0], -1, 0) for k, v in tp.data.items()}
        np.testing.assert_array_equal(got["id_lo"], ref["id_lo"])
        compare_slots(ref, np.moveaxis(ja, -1, 0), got, np.moveaxis(ta, -1, 0),
                      rtol=1e-11)
        assert int(np.asarray(jp.overflow).sum()) == int(tp.overflow.sum())


@pytest.mark.parametrize("rebin", [1, 2])
def test_tiled_laser_target_matches_jax(monkeypatch, rebin):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    import jax
    import lambdapic_tpu
    import lambdapic_torch

    jsim, laser = tiny_tiled_laser_target(lambdapic_tpu, npatch_x=1,
                                          npatch_y=1, rebin_interval=rebin)
    jsim.run(NSTEPS, callbacks=[laser])
    jstate = jax.device_get(jsim.state)

    tsim, laser = tiny_tiled_laser_target(lambdapic_torch, device="cpu",
                                          rebin_interval=rebin)
    tsim.initialize()
    start = _tiles_of(state_to_numpy(tsim.state))
    tsim.run(NSTEPS, callbacks=[laser])
    tstate = state_to_numpy(tsim.state)

    # guards on the test itself: the laser reached the grid, particles
    # changed tile, and no id was lost
    assert np.abs(tstate.fields.ey).max() > 0
    end = _tiles_of(tstate)
    assert sum(int(s[i] != e[i]) for s, e in zip(start, end) for i in s) > 0
    assert [len(e) for e in end] == [len(s) for s in start]
    assert tsim.itime == jsim.itime == NSTEPS
    assert_states_match(jstate, tstate)
    np.testing.assert_allclose(tsim.get_field("rho"), jsim.get_field("rho"),
                               rtol=1e-11, atol=1e-14 * np.abs(
                                   jsim.get_field("rho")).max())
    for ispec in range(2):
        a, b = tsim.get_particles(ispec), jsim.get_particles(ispec)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-11,
                                       atol=1e-14 * np.abs(b[k]).max(),
                                       err_msg=k)
