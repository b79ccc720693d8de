"""The port's 2D cell-engine step on a 2 x 2 device mesh against the JAX
package on the same mesh of virtual CPU devices, and against its own
one-device run.

Both Simulations run tests/test_torch_step.py's tiny laser-target for
five steps in float64 from the same seed, with npatch_x = npatch_y = 2
(the port's shards all on the CPU: ``initialize(devices=[cpu] * 4)``).
The JAX side runs its XLA cell path and XLA fields under shard_map; its
stable lax.sort pairs merges differently from the Batcher order, so the
test asserts that no merge happened. Fields to rtol 1e-10 of each
component's peak (the current sums run in another order), particles
slot for slot after canonicalisation, shard by shard, to rtol 1e-9.

A fault of the reference's toolchain, worked around here: with jax 0.9.0
on the CPU, XLA compiles the JAX seg_fields_2 (B half-step, laser,
E half-step in one jit) on a mesh that splits x so that the laser's row
update zeroes by on the first row of the second x shard; the B update
and the laser, each compiled alone, give the global result. The test
puts ``jax.lax.optimization_barrier`` on the laser's input fields, which
changes nothing that is computed (ROADMAP §3).

The mesh run against the one-device run (the counterpart of
tests/parallel/test_parity.py): the same global particles, through
``set_particles_global``, on one device and on the mesh; shard-local
positions round differently from global ones, so particles are matched
by id in global units to 1e-9 cells and fields to 1e-9 of their peak.
"""
import numpy as np
import pytest
import torch

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_from_numpy, state_to_numpy
from lambdapic_torch.testing import compare_mesh_slots, torch_threads
from test_torch_step import FIELDS, _config

NSTEPS = 5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clear_registries():
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()
    yield
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()


def _port(mesh=(2, 2), **extra):
    import lambdapic_torch
    species, laser, kw = _config(lambdapic_torch)
    sim = lambdapic_torch.Simulation(device="cpu", npatch_x=mesh[0],
                                     npatch_y=mesh[1], **{**kw, **extra})
    sim.add_species(species)
    sim.initialize(devices=[CPU] * (mesh[0] * mesh[1]))
    return sim, laser


def test_mesh_laser_target_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    import jax
    import lambdapic_tpu
    from lambdapic_tpu.models import laser as j_laser

    apply = j_laser.Laser.apply
    monkeypatch.setattr(
        j_laser.Laser, "apply", lambda self, f, *a: apply(
            self, jax.lax.optimization_barrier(f), *a))

    species, laser, kw = _config(lambdapic_tpu)
    jsim = lambdapic_tpu.Simulation(npatch_x=2, npatch_y=2, **kw)
    jsim.add_species(species)
    jsim.initialize(devices=jax.devices()[:4])
    jstate0 = jax.device_get(jsim.state)
    jsim.run(NSTEPS, callbacks=[laser])
    jstate = jax.device_get(jsim.state)

    with torch_threads(1):
        tsim, laser = _port()
        # the fill is the JAX package's per-device fill, bit for bit
        t0 = state_to_numpy(tsim.state, mesh=tsim.mesh, cpml=tsim.cpml,
                            grid=tsim.grid)
        for jp, tp in zip(jstate0.particles, t0.particles):
            for k, v in jp.data.items():
                np.testing.assert_array_equal(tp.data[k], np.asarray(v), k)
            np.testing.assert_array_equal(tp.alive, np.asarray(jp.alive))
        tsim.run(NSTEPS, callbacks=[laser])
    tstate = state_to_numpy(tsim.state, mesh=tsim.mesh, cpml=tsim.cpml,
                            grid=tsim.grid)
    assert tsim.itime == jsim.itime == NSTEPS
    assert [int(np.asarray(p.overflow).sum()) for p in jstate.particles] \
        == [0, 0]
    assert [int(np.asarray(p.overflow).sum()) for p in tstate.particles] \
        == [0, 0]
    for k in FIELDS:
        ref = np.asarray(getattr(jstate.fields, k))
        np.testing.assert_allclose(getattr(tstate.fields, k), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max(), err_msg=k)
    for k, v in jstate.fields.psi.items():
        ref = np.asarray(v)
        np.testing.assert_allclose(tstate.fields.psi[k], ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max(), err_msg=k)
    assert np.abs(np.asarray(jstate.fields.ey)).max() > 0
    for jp, tp in zip(jstate.particles, tstate.particles):
        compare_mesh_slots({k: np.asarray(v) for k, v in jp.data.items()},
                           np.asarray(jp.alive), tp.data, tp.alive, (2, 2),
                           rtol=1e-9)
    # particles crossed the shards' faces: some ids left their shard
    moved = 0
    for jp in jstate.particles:
        ids_hi = np.asarray(jp.data["id_hi"])
        alive = np.asarray(jp.alive)
        for c in np.ndindex(2, 2):
            moved += int((ids_hi[c][alive[c]] != np.ravel_multi_index(
                c, (2, 2))).sum())
    assert moved > 0
    for k in ("x", "y", "ux"):
        np.testing.assert_allclose(np.sort(tsim.get_particles(0)[k]),
                                   np.sort(jsim.get_particles(0)[k]),
                                   rtol=1e-9, atol=1e-12)
    assert tsim.npart_alive == jsim.npart_alive
    assert tsim.load_imbalance() == pytest.approx(jsim.load_imbalance(),
                                                  rel=1e-12)
    # the carry-over round trip, bit for bit, psi included
    back = state_to_numpy(state_from_numpy(jstate, CPU, mesh=tsim.mesh,
                                           cpml=tsim.cpml, grid=tsim.grid),
                          mesh=tsim.mesh, cpml=tsim.cpml, grid=tsim.grid)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(back.fields, k),
                                      np.asarray(getattr(jstate.fields, k)))
    for k, v in jstate.fields.psi.items():
        np.testing.assert_array_equal(back.fields.psi[k], np.asarray(v))
    for jp, bp in zip(jstate.particles, back.particles):
        for k, v in jp.data.items():
            np.testing.assert_array_equal(bp.data[k], np.asarray(v), k)
        np.testing.assert_array_equal(bp.next_id, np.asarray(jp.next_id))
        np.testing.assert_array_equal(bp.overflow, np.asarray(jp.overflow))


def _ids(p):
    return p["id_lo"].astype(np.int64) * 64 + p["id_hi"].astype(np.int64)


def test_mesh_run_equals_one_device_run():
    """The one-device fill, handed to a 2 x 2 mesh through
    ``set_particles_global``: after five steps the same particles (matched
    through their starting positions, as the ids are renumbered) sit at
    the same global positions with the same momenta, and the fields
    agree."""
    with torch_threads(1):
        one, laser = _port(mesh=(1, 1))
        mesh, laser2 = _port()
        match = []
        for ispec in range(2):
            p = one.get_particles(ispec)
            coords = {k: p[k] for k in ("x", "y")}
            mesh.set_particles_global(
                ispec, coords, {k: v for k, v in p.items() if k not in coords})
            q = mesh.get_particles(ispec)
            o1 = np.lexsort((p["y"], p["x"]))
            o2 = np.lexsort((q["y"], q["x"]))
            np.testing.assert_allclose(q["x"][o2], p["x"][o1], rtol=1e-15)
            match.append(dict(zip(_ids(q)[o2].tolist(),
                                  _ids(p)[o1].tolist())))
        one.run(NSTEPS, callbacks=[laser])
        mesh.run(NSTEPS, callbacks=[laser2])
    assert one.npart_alive == mesh.npart_alive
    for k in FIELDS:
        a, b = one.get_field(k), mesh.get_field(k)
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-9 * max(np.abs(a).max(), 1e-300),
                                   err_msg=k)
    for ispec in range(2):
        a, b = one.get_particles(ispec), mesh.get_particles(ispec)
        where = {i: n for n, i in enumerate(_ids(a).tolist())}
        idx = np.array([where[match[ispec][i]] for i in _ids(b).tolist()])
        for k, d in (("x", one.dx), ("y", one.dy)):
            np.testing.assert_allclose(b[k] / d, a[k][idx] / d, rtol=0,
                                       atol=1e-9, err_msg=k)
        for k in ("ux", "uy", "uz", "w"):
            np.testing.assert_allclose(b[k], a[k][idx], rtol=1e-9,
                                       atol=1e-12, err_msg=k)


@pytest.mark.parametrize("case", ["tiled", "devices", "breit_wheeler"])
def test_mesh_refusals(case):
    """On a mesh the port runs the cell engine, fused or per-stage, with
    QED photon emission; the tiled engine raises naming ROADMAP item 15d,
    Breit-Wheeler pairs item 9 (refused on every device count), and a
    mesh larger than its device list raises."""
    import lambdapic_torch
    from lambdapic_torch.testing import tiny_laser_target
    kw = dict(device="cpu", npatch_x=2, npatch_y=2)
    devices = [CPU] * 4
    if case == "tiled":
        sim = lambdapic_torch.Simulation(nx=64, ny=32, dx=1e-7, dy=1e-7,
                                         tiling=(16, 16), **kw)
        sim.add_species([lambdapic_torch.Electron(
            density=lambda x, y: 1e26 + 0 * x, ppc=1)])
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1, item 15d"):
            sim.initialize(devices=devices)
    elif case == "breit_wheeler":
        ele = lambdapic_torch.Electron()
        pos = lambdapic_torch.Species(name="positron", charge=1, mass=1.0)
        pho = lambdapic_torch.Photon(capacity=256)
        pho.set_bw_pair(electron=ele, positron=pos)
        sim = lambdapic_torch.Simulation(nx=32, ny=32, dx=1e-7, dy=1e-7,
                                         tiling="cell", **kw)
        sim.add_species([ele, pos, pho])
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1, item 9"):
            sim.initialize(devices=devices)
    else:
        sim, _ = tiny_laser_target(lambdapic_torch, **kw)
        with pytest.raises(ValueError, match="need 4 devices"):
            sim.initialize(devices=[CPU] * 3)
        sim3 = lambdapic_torch.Simulation3D(
            nx=16, ny=16, nz=16, dx=1e-7, dy=1e-7, dz=1e-7, tiling="cell",
            npatch_z=2, **kw)
        with pytest.raises(ValueError, match="need 8 devices"):
            sim3.initialize(devices=[CPU] * 4)


def test_shard_and_unshard_a_one_device_state():
    """testing.shard_state splits a one-device state onto a mesh (local
    cell units, psi on the shards' PML rows) and unshard_state joins it
    back bit for bit; the twin's fields equal the one-device fields."""
    from lambdapic_torch.testing import mesh_twin, unshard_state
    with torch_threads(1):
        one, laser = _port(mesh=(1, 1))
        one.run(3, callbacks=[laser])
        twin = mesh_twin(one, (2, 2), [CPU] * 4)
    back = unshard_state(twin.state, twin.grid, twin.mesh, CPU)
    for k in FIELDS + ("rho",):
        assert torch.equal(getattr(back.fields, k),
                           getattr(one.state.fields, k)), k
    for k in FIELDS:
        np.testing.assert_array_equal(twin.get_field(k), one.get_field(k))
    # rho is deposited anew from the shard-local positions
    rho = one.get_field("rho")
    np.testing.assert_allclose(twin.get_field("rho"), rho, rtol=0,
                               atol=1e-12 * np.abs(rho).max())
    for a, b in zip(back.particles, one.state.particles):
        assert torch.equal(a.alive, b.alive)
        for k in b.data:
            assert torch.equal(a.data[k], b.data[k]), k
    glob = state_to_numpy(twin.state, mesh=twin.mesh, cpml=twin.cpml,
                          grid=twin.grid)
    for k, v in one.state.fields.psi.items():
        np.testing.assert_array_equal(glob.fields.psi[k], v.numpy())


def test_mesh_set_field_and_grow_capacity():
    """On a mesh set_field cuts the global array into the shards and
    re-capacity grows every shard to one capacity; the run goes on with
    the same particles."""
    with torch_threads(1):
        sim, laser = _port()
        value = np.arange(32 * 32, dtype=np.float64).reshape(32, 32)
        sim.set_field("ez", value)
        np.testing.assert_array_equal(sim.get_field("ez"), value)
        cap = sim._species_static[0].cap
        n0 = sim.npart_alive
        assert sim._grow_capacity(0, cap + 5)
        assert {sh.particles[0].cap for sh in sim.state.shards} == \
            {cap + 6} == {sim._species_static[0].cap}
        assert sim.npart_alive == n0
        sim.run(2, callbacks=[laser])
    assert sim.npart_alive == n0
