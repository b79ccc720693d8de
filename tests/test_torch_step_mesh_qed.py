"""The port's QED step and per-stage engine on a 2 x 2 device mesh against
the JAX package on the same mesh of virtual CPU devices, 2D, float64,
the port's shards all on the CPU (``initialize(devices=[cpu] * 4)``).

- QED (fused engine: kernel B2's want_chi, default and photon modes in
  the mesh dispatches, K6's plain version): tests/test_qed.py::
  _periodic_sim's configuration (periodic 32 x 32, 2 x 2 patches, strong
  Bz for chi ~ 1), radiating electrons with their photons, from the same
  seed. Each shard folds its row-major index into
  the species' key and numbers its newborns from its own next_id with
  id_hi its index.
- exact + QED: tests/test_torch_step.py's tiny laser-target
  (``testing.tiny_laser_target``) with ``cell_migration="exact"``, its
  electrons radiating into a photon species and a gamma-2000 electron
  beam in a strong Bz added, so that photons are born.
- split: the tiny laser-target with a callback at ``_push_momentum``
  (the per-stage sub-segments, B6's plain version with the cross-device
  strips, K7).

A draw belongs to a slot, so each cell's slots must be in the same order
on both sides: the JAX side runs its XLA cell path on the CPU
(LAMBDAPIC_FIELDS_PALLAS=0) with the fast re-binning's sort swapped, for
these tests only, for the Batcher list the port uses (as in
tests/test_torch_step_qed.py); the exact scheme sorts stably on both
sides. The laser cases put ``jax.lax.optimization_barrier`` on the JAX
laser's input, the workaround of tests/test_torch_step_mesh.py for XLA's
CPU miscompile of seg_fields_2 on an x-split mesh. Slots are compared
shard by shard after canonicalisation by (dead, id_hi, id_lo): alive and
ids equal, floats to rtol 1e-11 with a floor of 1e-14 of each
attribute's peak (the QED payloads and chi to rtol 1e-10), fields to
1e-11 of their peak, the overflow and next_id counters per shard equal.
"""
import numpy as np
import pytest
import torch

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.testing import (QED_PAYLOADS, SLOT_FLOATS,
                                     compare_mesh_slots, tiny_laser_target,
                                     torch_threads)

CPU = torch.device("cpu")
MESH = (2, 2)
FIELDS = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz")


@pytest.fixture(autouse=True)
def clear_registries():
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()
    yield
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()


@pytest.fixture
def batcher_jax(monkeypatch):
    """The JAX package's XLA cell path with the Batcher-order sort, and
    the laser workaround."""
    import jax
    from lambdapic_tpu.models import laser as j_laser
    from lambdapic_tpu.ops import cell2d as j_cell2d
    from test_torch_cellstep import batcher_sort_jnp
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    xla_migrate = j_cell2d.migrate_cells

    def batcher_migrate(*args, sort_fn=None, **kw):
        return xla_migrate(*args, sort_fn=sort_fn or batcher_sort_jnp, **kw)
    monkeypatch.setattr(j_cell2d, "migrate_cells", batcher_migrate)
    apply = j_laser.Laser.apply
    monkeypatch.setattr(
        j_laser.Laser, "apply", lambda self, f, *a: apply(
            self, jax.lax.optimization_barrier(f), *a))


def _init(sim, pkg):
    import jax
    if pkg.__name__ == "lambdapic_tpu":
        sim.initialize(devices=jax.devices()[:4])
    else:
        sim.initialize(devices=[CPU] * 4)


def _beam(sim, pkg, n, x_range, y_range, seed=1):
    """Electrons of Lorentz factor 2000 along x and a uniform Bz set for
    chi ~ 1 (tests/test_qed.py)."""
    from lambdapic_torch.constants import c, e, hbar, m_e
    gamma = 2000.0
    ux = np.sqrt(gamma**2 - 1)
    rng = np.random.default_rng(seed)
    coords = {"x": rng.uniform(*x_range, n), "y": rng.uniform(*y_range, n)}
    attrs = {"w": np.ones(n), "ux": np.full(n, ux), "uy": np.zeros(n),
             "uz": np.zeros(n), "inv_gamma": np.full(n, 1 / gamma)}
    sim.set_particles_global(0, coords, attrs)
    bz = 1.0 / (e * hbar / (m_e**2 * c**3) * c * ux)
    sim.set_field("bz", np.full((sim.nx, sim.ny), bz))


def _periodic_qed(pkg, **extra):
    """tests/test_qed.py::_periodic_sim with radiating electrons and
    their photons, initialised, the electron beam set."""
    bc = {k: "periodic" for k in ("xmin", "xmax", "ymin", "ymax")}
    pho = pkg.Photon(capacity=4096)
    ele = pkg.Electron(radiation="photons")
    ele.set_photon(pho)
    sim = pkg.Simulation(nx=32, ny=32, dx=1e-7, dy=1e-7, npatch_x=2,
                         npatch_y=2, boundary_conditions=bc, random_seed=3,
                         precision="double", tiling="cell", **extra)
    sim.add_species([ele, pho])
    _init(sim, pkg)
    _beam(sim, pkg, 200, (0.3e-6, 2.9e-6), (0.3e-6, 2.9e-6))
    return sim


def _laser_qed(pkg, **extra):
    """The tiny laser-target, its electrons radiating into photons, a
    gamma-2000 electron beam in a strong Bz in place of its fill."""
    sim, laser = tiny_laser_target(pkg, npatch_x=2, npatch_y=2, **extra)
    ele, prot = sim.species
    pho = pkg.Photon(capacity=4096)
    ele.radiation = "photons"
    ele.set_photon(pho)
    sim.add_species([pho])
    _init(sim, pkg)
    _beam(sim, pkg, 150, (0.5e-6, 2.0e-6), (0.2e-6, 1.4e-6), seed=2)
    return sim, laser


def _states(jsim, tsim):
    import jax
    return jax.device_get(jsim.state), state_to_numpy(
        tsim.state, mesh=tsim.mesh, cpml=tsim.cpml, grid=tsim.grid)


def _compare(jsim, tsim, qed_species=(), photon=None):
    jstate, tstate = _states(jsim, tsim)
    assert tsim.itime == jsim.itime
    for jp, tp in zip(jstate.particles, tstate.particles):
        np.testing.assert_array_equal(np.asarray(tp.overflow),
                                      np.asarray(jp.overflow))
        np.testing.assert_array_equal(np.asarray(tp.next_id),
                                      np.asarray(jp.next_id))
    assert tsim.npart_alive == jsim.npart_alive
    for k in FIELDS:
        ref = np.asarray(getattr(jstate.fields, k))
        np.testing.assert_allclose(getattr(tstate.fields, k), ref, rtol=0,
                                   atol=1e-11 * np.abs(ref).max(), err_msg=k)
    for i, (jp, tp) in enumerate(zip(jstate.particles, tstate.particles)):
        ref = {k: np.asarray(v) for k, v in jp.data.items()}
        keys = tuple(k for k in SLOT_FLOATS if k in tp.data)
        compare_mesh_slots(ref, np.asarray(jp.alive), tp.data, tp.alive,
                           MESH, rtol=1e-11, keys=keys)
        if i in qed_species:
            compare_mesh_slots(ref, np.asarray(jp.alive), tp.data, tp.alive,
                               MESH, rtol=1e-10,
                               keys=QED_PAYLOADS + ("chi",))
    if photon is None:
        return tstate
    # photons were born on every shard whose electrons fired, carrying
    # that shard's index as id_hi, with inv_gamma = 1/|u|
    ph = tstate.particles[photon]
    born = 0
    for c in np.ndindex(MESH):
        alive = ph.alive[c]
        ids = ph.data["id_hi"][c][alive]
        if int(ph.next_id[c]) > 0:
            assert (ids == np.ravel_multi_index(c, MESH)).any()
        born += int(ph.next_id[c])
        u = np.sqrt(sum(ph.data[k][c][alive]**2 for k in ("ux", "uy",
                                                           "uz")))
        np.testing.assert_allclose(ph.data["inv_gamma"][c][alive], 1 / u,
                                   rtol=1e-12)
    assert born > 10 and sum(int(n > 0) for n in ph.next_id.reshape(-1)) > 1
    return tstate


def test_qed_mesh_step_matches_jax(batcher_jax):
    import lambdapic_tpu
    import lambdapic_torch
    jsim = _periodic_qed(lambdapic_tpu)
    jsim.run(5)
    with torch_threads(1):
        tsim = _periodic_qed(lambdapic_torch, device="cpu")
        tsim.run(5)
    assert tsim._builder.transients_valid == {0: False, 1: False}
    _compare(jsim, tsim, qed_species=(0,), photon=1)


def test_exact_qed_mesh_step_matches_jax(batcher_jax):
    import lambdapic_tpu
    import lambdapic_torch
    jsim, laser = _laser_qed(lambdapic_tpu, cell_migration="exact")
    jsim.run(3, callbacks=[laser])
    with torch_threads(1):
        tsim, laser = _laser_qed(lambdapic_torch, device="cpu",
                                 cell_migration="exact")
        tsim.run(3, callbacks=[laser])
    assert tsim._builder.transients_valid == {0: True, 1: False, 2: False}
    _compare(jsim, tsim, qed_species=(0,), photon=2)
    assert "ex_part" in tsim.get_particles(0)


def test_split_mesh_step_matches_jax(batcher_jax):
    import lambdapic_tpu
    import lambdapic_torch
    from lambdapic_tpu.simulation.callbacks import callback as j_callback
    j_seen, t_seen = [], []
    jsim, laser = tiny_laser_target(lambdapic_tpu, npatch_x=2, npatch_y=2)
    _init(jsim, lambdapic_tpu)
    jsim.run(4, callbacks=[laser, j_callback(stage="_push_momentum")(
        lambda s: j_seen.append(s.itime))])
    j_species._ALL_SPECIES.clear()
    with torch_threads(1):
        tsim, laser = tiny_laser_target(lambdapic_torch, device="cpu",
                                        npatch_x=2, npatch_y=2)
        _init(tsim, lambdapic_torch)
        tsim.run(4, callbacks=[laser, lambdapic_torch.callback(
            stage="_push_momentum")(lambda s: t_seen.append(s.itime))])
    assert j_seen == t_seen == list(range(4))
    assert tsim._builder.transients_valid == {0: True, 1: True}
    tstate = _compare(jsim, tsim)
    # particles crossed the shards' faces
    moved = sum(int((p.data["id_hi"][c][p.alive[c]]
                     != np.ravel_multi_index(c, MESH)).sum())
                for p in tstate.particles for c in np.ndindex(MESH))
    assert moved > 0
