"""The port's particle stage and rim fold on a device mesh (the plain
versions of kernel B2's cross-device and multi-dispatch modes, K4, and of
kernel B3's cross-device strips, K5) against the JAX package's XLA cell
path under shard_map on the same mesh of virtual CPU devices.

Oracle, per shard: push_position -> migrate_cells(plan of HaloSpecs, the
Batcher list swapped in as tests/test_torch_cellstep.py does) -> gather
-> boris_push -> push_position -> deposit_cell -> halo_reduce across the
mesh. Port: ``cellslab.cell_step_mesh`` (x edge columns from the x
neighbours, one dispatch per split y / z axis with the edge exchange in
between) and ``fold_reduce_plain`` with the mesh. Comparison: each
cell's slots sorted by (dead, id_lo); alive and ids equal, other
attributes to rtol 1e-11 with a floor of 1e-14 of the peak, merge
counts equal; J to rtol 1e-12 of its peak.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from lambdapic_torch.ops.cellslab import (cell_step_mesh, cell_step_plain,
                                          dispatch_groups, fold_reduce,
                                          fold_reduce_plain)
from lambdapic_torch.parallel.halo import HaloSpec as THaloSpec
from lambdapic_torch.parallel.mesh import Mesh
from lambdapic_torch.testing import (compare_mesh_slots, mesh_to_numpy,
                                     mesh_to_torch, random_mesh_cells,
                                     torch_threads)
from test_torch_cellstep import batcher_sort_jnp, shard_map

Q, M, DT = -1.602e-19, 9.109e-31, 1.1e-16
DX = 5e-8          # c dt / dx ~ 0.66 in 2D
G = 3
NAMES = ("px", "py", "pz")


def jax_mesh_reference(data, alive, eb_pad, mesh_shape, periodic):
    """The JAX XLA cell path for one species on the mesh; numpy (data,
    alive, n_lost per shard, J interior per shard), all under leading
    mesh axes."""
    from lambdapic_tpu.constants import c as c_light
    from lambdapic_tpu.ops import cell2d, cell3d
    from lambdapic_tpu.ops.pusher import (boris_push, push_position_2d,
                                          push_position_3d)
    from lambdapic_tpu.parallel.halo import HaloSpec, halo_reduce

    nd = len(mesh_shape)
    names = NAMES[:nd]
    n = int(np.prod(mesh_shape))
    mesh = JMesh(np.array(jax.devices()[:n]).reshape(mesh_shape), names)
    specs = tuple(HaloSpec(names[i], mesh_shape[i], periodic[i])
                  for i in range(nd))
    nloc = alive.shape[nd + 1:]
    plan = tuple((nloc[i], specs[i], "xyz"[i]) for i in range(nd))
    axes = "xyz"[:nd]
    h = [c_light * DT / DX / 2] * nd
    lead = (1,) * nd

    def push(d, ux, uy, uz, ig):
        if nd == 2:
            return push_position_2d(d["x"], d["y"], ux, uy, ig, *h)
        return push_position_3d(d["x"], d["y"], d["z"], ux, uy, uz, ig, *h)

    def run(eb, d, al):
        eb = eb.reshape(eb.shape[nd:])
        d = {k: v.reshape(v.shape[nd:]) for k, v in d.items()}
        al = al.reshape(al.shape[nd:])
        d.update(zip(axes, push(d, d["ux"], d["uy"], d["uz"],
                                d["inv_gamma"])))
        d, al, n_lost = cell2d.migrate_cells(d, al, plan, recompute_ig=True,
                                             sort_fn=batcher_sort_jnp)
        pos = [d[a] for a in axes]
        if nd == 2:
            eb_p = cell2d.gather_cell_2d(eb, *pos, G)
        else:
            eb_p = cell3d.gather_cell_3d(eb, *pos, G)
        ux, uy, uz, ig = boris_push(d["ux"], d["uy"], d["uz"], *eb_p, Q, M,
                                    DT)
        d.update(ux=ux, uy=uy, uz=uz, inv_gamma=ig)
        d.update(zip(axes, push(d, ux, uy, uz, ig)))
        w = jnp.where(al, d["w"], 0.0)
        pos = [d[a] for a in axes]
        if nd == 2:
            jpad = cell2d.deposit_cell_2d(*pos, ux, uy, uz, ig, w, q=Q,
                                          dx=DX, dy=DX, dt=DT, g=G)
        else:
            jpad = cell3d.deposit_cell_3d(*pos, ux, uy, uz, ig, w, q=Q,
                                          dx=DX, dy=DX, dz=DX, dt=DT, g=G)
        j = halo_reduce(jpad, G, tuple(range(1, nd + 1)), specs)
        return ({k: v.reshape(lead + v.shape) for k, v in d.items()},
                al.reshape(lead + al.shape), n_lost.reshape(lead),
                j.reshape(lead + j.shape))

    spec = P(*names)
    f = jax.jit(shard_map(run, mesh, in_specs=(spec, spec, spec),
                          out_specs=(spec, spec, spec, spec)))
    d, al, n_lost, j = f(jnp.asarray(eb_pad),
                         {k: jnp.asarray(v) for k, v in data.items()},
                         jnp.asarray(alive))
    return ({k: np.asarray(v) for k, v in d.items()}, np.asarray(al),
            np.asarray(n_lost), np.asarray(j))


def port_mesh(data, alive, eb_pad, mesh_shape, periodic, step=None):
    nd = len(mesh_shape)
    n = int(np.prod(mesh_shape))
    mesh = Mesh(tuple(mesh_shape), NAMES[:nd], (torch.device("cpu"),) * n)
    specs = tuple(THaloSpec(NAMES[i], mesh_shape[i], periodic[i])
                  for i in range(nd))
    shards = mesh_to_torch(data, alive, mesh, torch.float64)
    ebs = [torch.as_tensor(eb_pad[mesh.coords(i)]) for i in range(n)]
    outs = cell_step_mesh(ebs, [d for d, _ in shards], [a for _, a in shards],
                          mesh, specs, q=Q, m=M, dt=DT, dx=DX, dy=DX,
                          dz=DX if nd == 3 else None, g=G, step=step)
    nloc = alive.shape[nd + 1:]
    j = fold_reduce_plain([o[3] for o in outs], nloc, None, mesh, specs)
    return outs, j, mesh, specs


CASES = [
    # (mesh, cap, nloc, periodic, crowded)
    ((2, 2), 4, (8, 8), (True, True), False),
    ((2, 2), 6, (9, 8), (False, False), True),
    ((1, 2, 1), 4, (4, 4, 4), (False, True, True), True),
    ((2, 2, 2), 4, (4, 4, 4), (True, False, True), False),
]


@pytest.mark.parametrize("mesh_shape,cap,nloc,periodic,crowded", CASES)
def test_cell_step_mesh_plain_matches_jax(mesh_shape, cap, nloc, periodic,
                                          crowded):
    nd = len(mesh_shape)
    data, alive, eb_pad = random_mesh_cells(
        mesh_shape, cap, nloc, seed=7 + cap, crowded=crowded,
        n_frac=0.9 if crowded else 0.4)
    ref, ref_alive, ref_lost, ref_j = jax_mesh_reference(
        data, alive, eb_pad, mesh_shape, periodic)
    with torch_threads(1):
        outs, j, mesh, specs = port_mesh(data, alive, eb_pad, mesh_shape,
                                         periodic, step=cell_step_plain)
    got, got_alive = mesh_to_numpy([(o[0], o[1]) for o in outs], mesh_shape)
    compare_mesh_slots(ref, ref_alive, got, got_alive, mesh_shape,
                       rtol=1e-11)
    lost = np.array([int(o[2]) for o in outs]).reshape(mesh_shape)
    np.testing.assert_array_equal(lost, ref_lost)
    if crowded:
        assert ref_lost.sum() > 0
    # one dispatch per split y / z axis, and particles crossed shard faces
    assert len(dispatch_groups(mesh_shape)) == 1 + sum(
        p > 1 for p in mesh_shape[1:])
    assert sum(int((got["id_hi"][c][got_alive[c]]
                    != np.ravel_multi_index(c, mesh_shape)).sum())
               for c in np.ndindex(mesh_shape)) > 0
    jj = np.stack([t.numpy() for t in j]).reshape(ref_j.shape)
    scale = np.abs(ref_j).max()
    np.testing.assert_allclose(jj, ref_j, rtol=0, atol=1e-12 * scale)
    # on CPU shards the wrappers run the plain versions
    with torch_threads(1):
        outs2, j2, _, _ = port_mesh(data, alive, eb_pad, mesh_shape,
                                    periodic)
        j3 = fold_reduce([o[3] for o in outs2], alive.shape[nd + 1:], None,
                         mesh, specs)
    for a, b, c in zip(j, j2, j3):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_mesh_corner_movers_reach_the_diagonal_shard():
    """A particle at a shard's corner moving diagonally lands in the
    diagonal neighbour's corner cell (x dispatch, then the y exchange of
    the x output), and its current reaches that shard's corner nodes."""
    mesh_shape, cap, nloc = (2, 2), 4, (8, 8)
    data, alive, eb_pad = random_mesh_cells(mesh_shape, cap, nloc, seed=3,
                                            n_frac=0.0)
    eb_pad[...] = 0.0
    # one particle in shard (0, 0)'s top corner cell, moving +x +y
    c = (0, 0, 0, 7, 7)
    alive[c] = True
    data["x"][c], data["y"][c] = 7.45, 7.45
    data["ux"][c], data["uy"][c], data["uz"][c] = 5.0, 5.0, 0.0
    data["w"][c] = 1.0
    data["inv_gamma"][c] = 1 / np.sqrt(51.0)
    with torch_threads(1):
        outs, j, _, _ = port_mesh(data, alive, eb_pad, mesh_shape,
                                  (True, True), step=cell_step_plain)
    got, got_alive = mesh_to_numpy([(o[0], o[1]) for o in outs], mesh_shape)
    where = np.argwhere(got_alive)
    assert len(where) == 1 and tuple(where[0][:2]) == (1, 1)
    assert tuple(where[0][3:]) == (0, 0)
    total = sum(float(t[3].sum()) for t in j)
    assert abs(total - Q / DX**2) < 1e-12 * abs(Q / DX**2)
