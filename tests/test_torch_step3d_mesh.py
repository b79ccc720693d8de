"""The port's 3D cell-engine step on a 2 x 2 x 2 device mesh against the
JAX package on the same mesh of virtual CPU devices: tests/
test_torch_step3d.py's tiny 3D laser-target (32 x 16 x 16 cells, shards
of 16 x 8 x 8) for four steps in float64 from the same seed. The port's
step runs three dispatches a species (x, then y and z, each after the
edge exchange of the previous one's output) and the fold with strips on
all three axes.

As in tests/test_torch_step_mesh.py the JAX laser gets an optimization
barrier on its input fields (an XLA CPU fault on x-split meshes, ROADMAP
§3), and the test asserts that no merge happened (lax.sort pairs merges
differently from the Batcher order). Fields to rtol 1e-10 of each
component's peak, particles slot for slot, shard by shard, to rtol 1e-9.
"""
import numpy as np
import pytest
import torch

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.testing import compare_mesh_slots, torch_threads
from test_torch_step3d import FIELDS, NSTEPS, _config

MESH = (2, 2, 2)


@pytest.fixture(autouse=True)
def clear_registries():
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()
    yield
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()


def test_mesh_laser_target_3d_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    import jax
    import lambdapic_tpu
    import lambdapic_torch
    from lambdapic_torch.ops.cellslab import cell_step
    from lambdapic_tpu.models import laser as j_laser

    apply = j_laser.Laser.apply
    monkeypatch.setattr(
        j_laser.Laser, "apply", lambda self, f, *a: apply(
            self, jax.lax.optimization_barrier(f), *a))
    species, laser, kw = _config(lambdapic_tpu)
    jsim = lambdapic_tpu.Simulation3D(npatch_x=2, npatch_y=2, npatch_z=2,
                                      **kw)
    jsim.add_species(species)
    jsim.initialize(devices=jax.devices()[:8])
    jsim.run(NSTEPS, callbacks=[laser])
    jstate = jax.device_get(jsim.state)

    species, laser, kw = _config(lambdapic_torch)
    tsim = lambdapic_torch.Simulation3D(device="cpu", npatch_x=2, npatch_y=2,
                                        npatch_z=2, **kw)
    tsim.add_species(species)
    with torch_threads(1):
        tsim.initialize(devices=[torch.device("cpu")] * 8)
        tsim.run(NSTEPS, callbacks=[laser])
    tstate = state_to_numpy(tsim.state, dimension=3, mesh=tsim.mesh,
                            cpml=tsim.cpml, grid=tsim.grid)
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
                                   atol=1e-10 * max(np.abs(ref).max(), 1e-300),
                                   err_msg=k)
    assert np.abs(np.asarray(jstate.fields.jx)).max() > 0
    for jp, tp in zip(jstate.particles, tstate.particles):
        compare_mesh_slots({k: np.asarray(v) for k, v in jp.data.items()},
                           np.asarray(jp.alive), tp.data, tp.alive, MESH,
                           rtol=1e-9)
    # electrons left their shard along every mesh axis
    for jp in jstate.particles[:1]:
        ids_hi = np.asarray(jp.data["id_hi"])
        alive = np.asarray(jp.alive)
        moved = [0, 0, 0]
        for c in np.ndindex(MESH):
            src = np.array(np.unravel_index(ids_hi[c][alive[c]], MESH)).T
            moved = [m + int((src[:, a] != c[a]).sum())
                     for a, m in enumerate(moved)]
        assert min(moved) > 0, moved
    assert tsim.npart_alive == jsim.npart_alive
