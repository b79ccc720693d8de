"""The port's split particle path in 3D (a host callback at an inner
stage is due: one sub-segment per stage, lambdapic_torch/simulation/
step.py::seg_particles_sub over 3D slots) on the CPU, float64, on
tests/test_torch_step3d.py's tiny 3D laser-target (32 x 16 x 16 cells).

- one split step (a ``_push_momentum`` callback) against one fused step
  (kernel B2's plain version in 3D) from the same seeded state: both
  re-bin in the Batcher order and push op for op alike, so the particles
  are equal bit for bit; J and rho agree to 1e-12 of their peak (the
  per-stage deposit sums into the padded current, B2 into tile panels);
  under LAMBDAPIC_MIG_FUSED=0 (the fast migrate_cells sorting through
  sort_cells) the split steps equal the default ones bit for bit;
- a split run against the JAX package's split run, the callback at
  ``_push_momentum`` due every step and the JAX side's re-binning sort
  swapped for the Batcher list (as in tests/test_torch_split.py): slots
  after canonicalisation to rtol 1e-9, fields to rtol 1e-9 of their
  peak; the callbacks saw the same steps and the gathered fields of every
  alive electron.
"""
import numpy as np
import pytest

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.testing import compare_slots, torch_threads

from test_torch_step3d import _config, _home_cells

NSTEPS = 3
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


def _port_run(nsteps, cbs=(), **extra):
    import lambdapic_torch
    t_species._ALL_SPECIES.clear()
    species, laser, kw = _config(lambdapic_torch)
    sim = lambdapic_torch.Simulation3D(device="cpu", **{**kw, **extra})
    sim.add_species(species)
    sim.run(nsteps, callbacks=[laser, *cbs])
    return sim


def _probe(seen):
    from lambdapic_torch import callback
    return callback(stage="_push_momentum")(lambda s: seen.append(
        (s.itime, s.get_particles(0)["ex_part"].size)))


def test_split_3d_equals_fused(monkeypatch):
    fused = _port_run(1)
    seen = []
    split = _port_run(1, [_probe(seen)])
    assert seen == [(0, split.npart_alive[0])]
    a = state_to_numpy(fused.state, dimension=3)
    b = state_to_numpy(split.state, dimension=3)
    for pa, pb in zip(a.particles, b.particles):
        np.testing.assert_array_equal(pb.alive, pa.alive)
        for k in pa.data:
            if not k.endswith("_part"):
                np.testing.assert_array_equal(pb.data[k], pa.data[k],
                                              err_msg=k)
        compare_slots(pa.data, pa.alive, pb.data, pb.alive, rtol=1e-11)
    for k in FIELDS:
        # the fused run skips the rho deposit (the laser is rho-free) and
        # recomputes rho on demand; the split step always deposits it
        ref = fused.get_field("rho") if k == "rho" else getattr(a.fields, k)
        np.testing.assert_allclose(getattr(b.fields, k), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=k)
    assert np.abs(b.fields.jx).max() > 0
    # the split step's re-binning moved particles along every axis
    start = _home_cells(state_to_numpy(_port_run(0).state, dimension=3))
    end = _home_cells(b)
    for axis in range(3):
        assert sum(int(s[i][axis] != e[i][axis])
                   for s, e in zip(start, end) for i in s if i in e) > 0
    # the re-binning through sort_cells gives the same split steps
    b2 = state_to_numpy(_port_run(2, [_probe([])]).state, dimension=3)
    monkeypatch.setenv("LAMBDAPIC_MIG_FUSED", "0")
    c = state_to_numpy(_port_run(2, [_probe([])]).state, dimension=3)
    for pb, pc in zip(b2.particles, c.particles):
        np.testing.assert_array_equal(pc.alive, pb.alive)
        for k in pb.data:
            np.testing.assert_array_equal(pc.data[k], pb.data[k], err_msg=k)
    np.testing.assert_array_equal(c.fields.jx, b2.fields.jx)


def test_split_3d_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    import jax
    import lambdapic_tpu
    from lambdapic_tpu.ops import cell2d as j_cell2d
    from lambdapic_tpu.simulation.callbacks import callback as j_callback
    from test_torch_cell3d import batcher_sort_jnp

    xla_migrate = j_cell2d.migrate_cells

    def batcher_migrate(*args, sort_fn=None, **kw):
        return xla_migrate(*args, sort_fn=sort_fn or batcher_sort_jnp, **kw)
    monkeypatch.setattr(j_cell2d, "migrate_cells", batcher_migrate)

    species, laser, kw = _config(lambdapic_tpu)
    jsim = lambdapic_tpu.Simulation3D(npatch_x=1, npatch_y=1, npatch_z=1,
                                      **kw)
    jsim.add_species(species)
    j_seen, t_seen = [], []
    jprobe = j_callback(stage="_push_momentum")(
        lambda s: j_seen.append(s.itime))
    jsim.run(NSTEPS, callbacks=[laser, jprobe])
    jstate = jax.device_get(jsim.state)

    tsim = _port_run(NSTEPS, [_probe(t_seen)])
    tstate = state_to_numpy(tsim.state, dimension=3)
    assert j_seen == [t for t, _ in t_seen] == list(range(NSTEPS))
    # the callback saw this step's gathered fields of every alive electron
    assert t_seen[-1][1] == tsim.npart_alive[0]
    for k in FIELDS:
        ref = np.asarray(getattr(jstate.fields, k))
        np.testing.assert_allclose(getattr(tstate.fields, k), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=k)
    for jp, tp in zip(jstate.particles, tstate.particles):
        assert int(tp.overflow.sum()) == int(np.asarray(jp.overflow).sum())
        compare_slots({k: np.asarray(v)[0, 0, 0] for k, v in jp.data.items()},
                      np.asarray(jp.alive)[0, 0, 0],
                      {k: v[0, 0, 0] for k, v in tp.data.items()},
                      tp.alive[0, 0, 0], rtol=1e-9,
                      keys=("x", "y", "z", "w", "ux", "uy", "uz",
                            "inv_gamma", "ex_part", "ey_part", "bz_part"))
