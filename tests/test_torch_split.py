"""The port's split particle path (a host callback at an inner stage is
due: one sub-segment per stage, lambdapic_torch/simulation/step.py::
seg_particles_sub) on the CPU, float64, on
lambdapic_torch.testing.tiny_laser_target (48 x 32 cells, electrons and
protons, PML, GaussianLaser2D).

- split run (an ``_interpolator`` probe every step) against the fused run
  (kernel B2's plain version): both re-bin in the Batcher order and push
  op for op alike, so after one step the particles are equal bit for bit;
  J and rho agree to 1e-12 of their peak (the per-stage deposit sums into
  the padded current, B2 into tile panels), and as that rounding feeds
  back through the fields, the particles after four steps agree to rtol
  1e-11 (compare_slots) with alive masks and ids equal in place;
- the same under LAMBDAPIC_MIG_FUSED=0 (the fast migrate_cells sorting
  through sort_cells) equals the default split run bit for bit;
- split run against the JAX package's split run, the JAX side's
  re-binning sort swapped for the Batcher list (as in
  tests/test_torch_step_qed.py): slots after canonicalisation to rtol
  1e-9, fields to rtol 1e-9 of their peak;
- a ``_push_momentum`` callback that zeroes uz takes effect;
- get_particles exposes ``ex_part`` after a split step, not after a fused
  one;
- Simulation3D takes exact migration and inner-stage callbacks and
  refuses QED in 3D, naming ROADMAP item 9.
"""
import numpy as np
import pytest
import torch

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.testing import compare_slots, tiny_laser_target
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


def _port_run(cbs=(), nsteps=NSTEPS, **kw):
    import lambdapic_torch
    t_species._ALL_SPECIES.clear()
    sim, laser = tiny_laser_target(lambdapic_torch, device="cpu", **kw)
    sim.run(nsteps, callbacks=[laser, *cbs])
    return sim


def _probe(seen, stage="_interpolator"):
    from lambdapic_torch import callback
    return callback(stage=stage)(lambda s: seen.append(
        (s.itime, s.get_particles(0)["ex_part"].size)))


def test_split_equals_fused(monkeypatch):
    # one step: the same particles bit for bit
    a = state_to_numpy(_port_run(nsteps=1).state)
    b = state_to_numpy(_port_run([_probe([])], nsteps=1).state)
    for pa, pb in zip(a.particles, b.particles):
        np.testing.assert_array_equal(pb.alive, pa.alive)
        for k in pa.data:
            if not k.endswith("_part"):
                np.testing.assert_array_equal(pb.data[k], pa.data[k],
                                              err_msg=k)
    # four steps: J's rounding feeds back through the fields
    seen = []
    fused = _port_run()
    split = _port_run([_probe(seen)])
    # the probe saw every step, and this step's gathered fields of every
    # alive electron (re-binning is the only stage that drops particles)
    assert [t for t, _ in seen] == list(range(NSTEPS))
    assert seen[-1][1] == split.npart_alive[0]
    a, b = state_to_numpy(fused.state), state_to_numpy(split.state)
    for k in FIELDS:
        # the fused run skips the rho deposit (the laser is rho-free) and
        # recomputes rho on demand; the split step always deposits it
        ref = fused.get_field("rho") if k == "rho" else getattr(a.fields, k)
        np.testing.assert_allclose(getattr(b.fields, k), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=k)
    assert sum(int(p.overflow.sum()) for p in b.particles) > 0   # merges
    for pa, pb in zip(a.particles, b.particles):
        np.testing.assert_array_equal(pb.alive, pa.alive)
        np.testing.assert_array_equal(pb.data["id_lo"], pa.data["id_lo"])
        compare_slots(pa.data, pa.alive, pb.data, pb.alive, rtol=1e-11)
        assert int(pb.overflow.sum()) == int(pa.overflow.sum())
    # the sort_cells route of the re-binning gives the same steps
    monkeypatch.setenv("LAMBDAPIC_MIG_FUSED", "0")
    c = state_to_numpy(_port_run([_probe([])]).state)
    for pb, pc in zip(b.particles, c.particles):
        np.testing.assert_array_equal(pc.alive, pb.alive)
        for k in pb.data:
            np.testing.assert_array_equal(pc.data[k], pb.data[k], err_msg=k)
    np.testing.assert_array_equal(c.fields.jx, b.fields.jx)


def test_split_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    import jax
    import lambdapic_tpu
    from lambdapic_tpu.ops import cell2d as j_cell2d
    from lambdapic_tpu.simulation.callbacks import callback as j_callback
    from test_torch_cellstep import batcher_sort_jnp

    xla_migrate = j_cell2d.migrate_cells

    def batcher_migrate(*args, sort_fn=None, **kw):
        return xla_migrate(*args, sort_fn=sort_fn or batcher_sort_jnp, **kw)
    monkeypatch.setattr(j_cell2d, "migrate_cells", batcher_migrate)

    j_seen, t_seen = [], []
    jsim, laser = tiny_laser_target(lambdapic_tpu, npatch_x=1, npatch_y=1)
    jprobe = j_callback(stage="_interpolator")(
        lambda s: j_seen.append(s.itime))
    jsim.run(NSTEPS, callbacks=[laser, jprobe])
    jstate = jax.device_get(jsim.state)
    tsim = _port_run([_probe(t_seen)])
    tstate = state_to_numpy(tsim.state)
    assert j_seen == [t for t, _ in t_seen]
    for k in FIELDS:
        ref = np.asarray(getattr(jstate.fields, k))
        np.testing.assert_allclose(getattr(tstate.fields, k), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=k)
    for jp, tp in zip(jstate.particles, tstate.particles):
        assert int(tp.overflow.sum()) == int(np.asarray(jp.overflow).sum())
        compare_slots({k: np.asarray(v)[0, 0] for k, v in jp.data.items()},
                      np.asarray(jp.alive)[0, 0],
                      {k: v[0, 0] for k, v in tp.data.items()},
                      tp.alive[0, 0], rtol=1e-9,
                      keys=("x", "y", "w", "ux", "uy", "uz", "inv_gamma",
                            "ex_part", "ey_part", "bz_part"))
    assert sum(int(p.overflow.sum()) for p in tstate.particles) > 0


def test_push_momentum_callback_takes_effect():
    from lambdapic_torch import callback

    @callback(stage="_push_momentum")
    def kill_uz(sim):
        parts = list(sim.state.particles)
        p0 = parts[0]
        parts[0] = p0.replace(data={**p0.data,
                                    "uz": torch.zeros_like(p0.data["uz"])})
        sim.state = sim.state.replace(particles=tuple(parts))

    sim = _port_run([kill_uz], nsteps=3)
    assert np.abs(sim.get_particles(0)["uz"]).max() == 0.0
    # the electrons start with uz = 0.3 cos(2 pi y / Ly)
    assert np.abs(_port_run(nsteps=3).get_particles(0)["uz"]).max() > 0.1


def test_get_particles_exposes_fields_after_split_only():
    from lambdapic_torch import callback
    on_third = callback(stage="_interpolator",
                        interval=lambda s: s.itime == 2)(lambda s: None)
    sim = _port_run([on_third], nsteps=3)
    p = sim.get_particles(0)
    assert "ex_part" in p and p["ex_part"].shape == p["x"].shape
    assert np.abs(p["ex_part"]).max() > 0
    sim.run(2, callbacks=[on_third])         # fused steps from here
    assert "ex_part" not in sim.get_particles(0)
    assert "ex_part" not in _port_run().get_particles(0)


def test_3d_refuses_exact_and_inner_callbacks():
    """Since the 3D per-stage engine was ported, Simulation3D takes
    cell_migration="exact" and inner-stage callbacks (both run a step);
    since QED in 3D was ported it takes a photon species too (a step on
    each path). What it still refuses, naming ROADMAP item 9, is a photon
    species with Breit-Wheeler pairs and a species with spin."""
    import lambdapic_torch as lt
    kw = dict(nx=16, ny=8, nz=8, dx=1e-7, dy=1e-7, dz=1e-7, tiling="cell",
              device="cpu")

    def profile(x, y, z):
        return 1e25

    sim = lt.Simulation3D(cell_migration="exact", **kw)
    sim.add_species([lt.Electron(density=profile, ppc=1)])
    sim.run(1)
    assert sim.itime == 1 and sim.npart_alive[0] > 0
    t_species._ALL_SPECIES.clear()
    seen = []
    sim = lt.Simulation3D(**kw)
    sim.add_species([lt.Electron(density=profile, ppc=1)])
    probe = lt.callback(stage="_qed")(lambda s: seen.append(s.itime))
    sim.run(1, callbacks=[probe])
    assert seen == [0]
    for migration in ("exact", "fast"):
        t_species._ALL_SPECIES.clear()
        sim = lt.Simulation3D(cell_migration=migration, **kw)
        sim.add_species([lt.Photon(capacity=1024)])
        sim.run(1)
        assert sim.itime == 1 and sim.npart_alive == [0]
    t_species._ALL_SPECIES.clear()
    pho = lt.Photon(capacity=1024)
    pho.set_bw_pair(electron=lt.Electron(), positron=lt.Electron())
    sim = lt.Simulation3D(**kw)
    sim.add_species([pho])
    with pytest.raises(NotImplementedError, match="item 9"):
        sim.initialize()
    t_species._ALL_SPECIES.clear()
    sim = lt.Simulation3D(**kw)
    sim.add_species([lt.Electron(density=profile, ppc=1,
                                 polarization=(0.0, 0.0, 1.0))])
    with pytest.raises(NotImplementedError, match="item 9"):
        sim.initialize()
