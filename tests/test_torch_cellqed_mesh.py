"""The plain version of kernel B2's ``want_chi`` and ``photon`` modes in the
dispatches of a device mesh (K6) against the JAX package's XLA cell path
under shard_map on the same mesh of virtual CPU devices, 2D and 3D.

Oracle, per shard (as tests/test_torch_cellqed.py on one device, with the
mesh plan of HaloSpecs): push_position -> migrate_cells(sort_fn=Batcher)
-> want_chi: gather -> calculate_chi (at the post-migration pre-push
momenta and inv_gamma) -> boris_push -> push_position; photon:
photon_push -> push_position. Port: ``cellslab.cell_step_mesh`` with
``want_chi`` (chi and ig0 from the last dispatch only, tau, delta and
event carried through the edge columns of every dispatch) or ``photon``
(every dispatch field-free, no panels). The states are crowded (merges)
or random, and particles cross the shards' faces and corners.

Float64; each cell's slots compared after canonicalisation by (dead,
id_hi, id_lo): alive and ids equal, other attributes to rtol 1e-11 with a
floor of 1e-14 of their peak, the QED payloads exactly, chi to rtol 1e-10
and ig0 to rtol 1e-12; merge counts equal.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from lambdapic_torch.ops.cellslab import (cell_step, cell_step_mesh,
                                          cell_step_plain, dispatch_groups)
from lambdapic_torch.parallel.halo import HaloSpec as THaloSpec
from lambdapic_torch.parallel.mesh import Mesh
from lambdapic_torch.testing import (QED_PAYLOADS, compare_mesh_slots,
                                     mesh_to_numpy, mesh_to_torch,
                                     random_mesh_cells, torch_threads)
from test_torch_cellstep import batcher_sort_jnp, shard_map

Q, M, DT = -1.602e-19, 9.109e-31, 1.1e-16
DX = 5e-8          # c dt / dx ~ 0.66 in 2D
G = 3
NAMES = ("px", "py", "pz")


def jax_mesh_qed(data, alive, eb_pad, mesh_shape, periodic, photon):
    """The JAX XLA cell path of one radiating (or photon) species on the
    mesh: numpy (data, alive, n_lost, chi, ig0) under leading mesh axes."""
    from lambdapic_tpu.constants import c as c_light
    from lambdapic_tpu.models.qed import calculate_chi
    from lambdapic_tpu.ops import cell2d, cell3d
    from lambdapic_tpu.ops.pusher import (boris_push, photon_push,
                                          push_position_2d, push_position_3d)
    from lambdapic_tpu.parallel.halo import HaloSpec

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

    def push(d, ig):
        if nd == 2:
            return push_position_2d(d["x"], d["y"], d["ux"], d["uy"], ig, *h)
        return push_position_3d(d["x"], d["y"], d["z"], d["ux"], d["uy"],
                                d["uz"], ig, *h)

    def run(eb, d, al):
        eb = eb.reshape(eb.shape[nd:])
        d = {k: v.reshape(v.shape[nd:]) for k, v in d.items()}
        al = al.reshape(al.shape[nd:])
        d.update(zip(axes, push(d, d["inv_gamma"])))
        d, al, n_lost = cell2d.migrate_cells(d, al, plan,
                                             recompute_ig=not photon,
                                             sort_fn=batcher_sort_jnp)
        if photon:
            ig = photon_push(d["ux"], d["uy"], d["uz"])
            d.update(zip(axes, push(d, ig)))
            d["inv_gamma"] = ig
            chi = ig0 = jnp.zeros_like(ig)
        else:
            pos = [d[a] for a in axes]
            gather = cell2d.gather_cell_2d if nd == 2 \
                else cell3d.gather_cell_3d
            eb_p = gather(eb, *pos, G)
            ig0 = d["inv_gamma"]
            chi = calculate_chi(*eb_p, d["ux"], d["uy"], d["uz"], ig0)
            ux, uy, uz, ig = boris_push(d["ux"], d["uy"], d["uz"], *eb_p, Q,
                                        M, DT)
            d.update(ux=ux, uy=uy, uz=uz)
            d.update(zip(axes, push(d, ig)))
            d["inv_gamma"] = ig
        return ({k: v.reshape(lead + v.shape) for k, v in d.items()},
                al.reshape(lead + al.shape), n_lost.reshape(lead),
                chi.reshape(lead + chi.shape), ig0.reshape(lead + ig0.shape))

    spec = P(*names)
    f = jax.jit(shard_map(run, mesh, in_specs=(spec, spec, spec),
                          out_specs=(spec,) * 5))
    d, al, n_lost, chi, ig0 = f(jnp.asarray(eb_pad),
                                {k: jnp.asarray(v) for k, v in data.items()},
                                jnp.asarray(alive))
    return ({k: np.asarray(v) for k, v in d.items()}, np.asarray(al),
            np.asarray(n_lost), np.asarray(chi), np.asarray(ig0))


def port_mesh_qed(data, alive, eb_pad, mesh_shape, periodic, photon,
                  step=cell_step_plain):
    nd = len(mesh_shape)
    n = int(np.prod(mesh_shape))
    mesh = Mesh(tuple(mesh_shape), NAMES[:nd], (torch.device("cpu"),) * n)
    specs = tuple(THaloSpec(NAMES[i], mesh_shape[i], periodic[i])
                  for i in range(nd))
    shards = mesh_to_torch(data, alive, mesh, torch.float64)
    ebs = None if photon else [torch.as_tensor(eb_pad[mesh.coords(i)])
                               for i in range(n)]
    return cell_step_mesh(ebs, [d for d, _ in shards], [a for _, a in shards],
                          mesh, specs, q=0.0 if photon else Q,
                          m=0.0 if photon else M, dt=DT, dx=DX, dy=DX,
                          dz=DX if nd == 3 else None, g=G,
                          want_chi=not photon, photon=photon, step=step)


def mesh_state(mesh_shape, cap, nloc, crowded, photon, seed):
    data, alive, eb_pad = random_mesh_cells(
        mesh_shape, cap, nloc, seed=seed, crowded=crowded,
        n_frac=0.9 if crowded else 0.4, qed=not photon, umax=50.0,
        field=5e13)
    if photon:
        u2 = data["ux"]**2 + data["uy"]**2 + data["uz"]**2
        data["inv_gamma"] = np.where(u2 > 0, 1 / np.sqrt(np.maximum(u2,
                                                                    1e-30)),
                                     1.0)
    return data, alive, eb_pad


CASES = [
    # (mesh, cap, nloc, periodic, crowded)
    ((2, 2), 4, (8, 8), (True, True), False),
    ((2, 2), 6, (9, 8), (False, False), True),
    ((1, 2, 2), 4, (4, 4, 4), (False, True, False), True),
    ((2, 2, 2), 4, (4, 4, 4), (True, False, True), False),
]


@pytest.mark.parametrize("photon", [False, True], ids=["want_chi", "photon"])
@pytest.mark.parametrize("mesh_shape,cap,nloc,periodic,crowded", CASES)
def test_cell_step_mesh_qed_plain_matches_jax(mesh_shape, cap, nloc,
                                              periodic, crowded, photon):
    nd = len(mesh_shape)
    data, alive, eb_pad = mesh_state(mesh_shape, cap, nloc, crowded, photon,
                                     seed=11 + cap + nd)
    ref, ref_alive, ref_lost, ref_chi, ref_ig0 = jax_mesh_qed(
        data, alive, eb_pad, mesh_shape, periodic, photon)
    with torch_threads(1):
        outs = port_mesh_qed(data, alive, eb_pad, mesh_shape, periodic,
                             photon)
    got, got_alive = mesh_to_numpy([(o[0], o[1]) for o in outs], mesh_shape)
    keys = ("x", "y", "z", "w", "ux", "uy", "uz", "inv_gamma")
    if photon:
        assert all(o[3] is None for o in outs)
    else:
        # chi and ig0 of the last dispatch, compared as slot attributes
        lead = tuple(mesh_shape)
        got["chi_out"] = np.stack([o[4][0].numpy() for o in outs]).reshape(
            lead + got_alive.shape[nd:])
        got["ig0_out"] = np.stack([o[4][1].numpy() for o in outs]).reshape(
            lead + got_alive.shape[nd:])
        ref = dict(ref, chi_out=ref_chi, ig0_out=ref_ig0)
        compare_mesh_slots(ref, ref_alive, got, got_alive, mesh_shape,
                           rtol=0, keys=QED_PAYLOADS)
        compare_mesh_slots(ref, ref_alive, got, got_alive, mesh_shape,
                           rtol=1e-10, keys=("chi_out",))
        compare_mesh_slots(ref, ref_alive, got, got_alive, mesh_shape,
                           rtol=1e-12, keys=("ig0_out",))
        assert (ref_chi[ref_alive] > 1e-3).any()
    compare_mesh_slots(ref, ref_alive, got, got_alive, mesh_shape,
                       rtol=1e-11, keys=keys)
    lost = np.array([int(o[2]) for o in outs]).reshape(mesh_shape)
    np.testing.assert_array_equal(lost, ref_lost)
    if crowded:
        assert ref_lost.sum() > 0
    # particles crossed the shards' faces, through every dispatch
    assert len(dispatch_groups(mesh_shape)) == 1 + sum(
        p > 1 for p in mesh_shape[1:])
    assert sum(int((got["id_hi"][c][got_alive[c]]
                    != np.ravel_multi_index(c, mesh_shape)).sum())
               for c in np.ndindex(mesh_shape)) > 0
    if photon:
        u = np.sqrt(got["ux"]**2 + got["uy"]**2 + got["uz"]**2)
        np.testing.assert_allclose(got["inv_gamma"][got_alive],
                                   1 / u[got_alive], rtol=1e-14)
        assert (got["inv_gamma"][~got_alive] == 1).all()
    # on CPU shards the wrapper runs the plain version
    with torch_threads(1):
        outs2 = port_mesh_qed(data, alive, eb_pad, mesh_shape, periodic,
                              photon, step=cell_step)
    for a, b in zip(outs, outs2):
        assert torch.equal(a[1], b[1])
        for k in a[0]:
            assert torch.equal(a[0][k], b[0][k]), k
        if not photon:
            assert torch.equal(a[4][0], b[4][0]) and torch.equal(a[3], b[3])


def test_cell_step_mesh_modes_exclude_each_other():
    data, alive, eb_pad = mesh_state((2, 2), 4, (4, 4), False, False, 1)
    with pytest.raises(ValueError, match="exclude"):
        mesh = Mesh((2, 2), NAMES[:2], (torch.device("cpu"),) * 4)
        specs = tuple(THaloSpec(NAMES[i], 2, True) for i in range(2))
        shards = mesh_to_torch(data, alive, mesh, torch.float64)
        cell_step_mesh(None, [d for d, _ in shards], [a for _, a in shards],
                       mesh, specs, q=Q, m=M, dt=DT, dx=DX, dy=DX, g=G,
                       want_chi=True, photon=True)
