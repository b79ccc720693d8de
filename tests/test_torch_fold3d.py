"""Kernel B3's mesh form in 3D (K5) through its launches' plain versions:
the strip cut (``fold_cut_3d_plain``), the pending add after each
exchange (``fold_pend_3d_plain``) and the fold with the received strips
(``fold3_plain``), composed with ``exchange_strips`` on a mesh of CPU
shards.

Rules (float64): the cut equals the guard nodes of ``fold_panels_3d``
bit for bit; the composed launches equal ``fold_reduce_plain`` with the
mesh (``halo_reduce``) bit for bit, since they add the same terms in its
order; against the JAX package's XLA deposit and ``halo_reduce`` under
``shard_map`` on the same mesh of virtual CPU devices, J to 1e-12 of its
peak (the port deposits into tile panels, JAX into the padded J, so the
sums run in another order). Shards of 8^3 cells, one torch thread.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from lambdapic_torch.ops.cellslab import (deposit_panels_3d,
                                          fold3_plain, fold_cut_3d_plain,
                                          fold_panels_3d, fold_pend_3d_plain,
                                          fold_reduce, fold_reduce_plain,
                                          panel_shape, strip_shape)
from lambdapic_torch.parallel.halo import HaloSpec, exchange_strips
from lambdapic_torch.parallel.mesh import Mesh
from lambdapic_torch.testing import mesh_to_torch, random_mesh_cells, \
    torch_threads
from test_torch_cellstep import shard_map

Q, DT = -1.602e-19, 1.1e-16
DX, DY, DZ = 5e-8, 6e-8, 5.5e-8
G = 3
NAMES = ("px", "py", "pz")
NLOC = (8, 8, 8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


def _mesh(mesh_shape, periodic):
    n = int(np.prod(mesh_shape))
    mesh = Mesh(tuple(mesh_shape), NAMES, (torch.device("cpu"),) * n)
    specs = tuple(HaloSpec(NAMES[i], mesh_shape[i], periodic[i])
                  for i in range(3))
    return mesh, specs


def _panels(n, seed, ncomp=3):
    """Seeded random panels, every node (guards and corners) nonzero."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=panel_shape(ncomp, *NLOC)))
            for _ in range(n)]


@pytest.mark.parametrize("strip", list(itertools.product((False, True),
                                                         repeat=3)))
def test_cut_is_the_guard_nodes_of_the_fold(strip):
    """Each strip axis's lo and hi strips are the padded current's guard
    rows (padded 0, 1 and n + 2, n + 3), padded along a strip axis
    exchanged after it and interior along the others; bitwise."""
    rims = _panels(1, seed=sum(strip), ncomp=4)[0]
    pad = fold_panels_3d(rims, *NLOC)
    cut = fold_cut_3d_plain(rims, NLOC, strip)
    for ax in range(3):
        if not strip[ax]:
            assert cut[ax] is None
            continue
        for side, got in enumerate(cut[ax]):
            idx = [slice(None)]
            for b, n in enumerate(NLOC):
                if b == ax:
                    idx.append(slice(n + 2, n + 4) if side else slice(0, 2))
                elif strip[b] and b < ax:
                    idx.append(slice(None))
                else:
                    idx.append(slice(2, n + 2))
            assert got.shape == strip_shape(4, NLOC, strip, ax)
            assert torch.equal(got, pad[tuple(idx)]), (ax, side)


MESHES = [(2, 2, 2), (1, 1, 2), (1, 2, 1), (2, 1, 1), (2, 2, 1)]
PERIODIC = [(True, True, True), (False, False, False), (True, False, True)]


@pytest.mark.parametrize("periodic", PERIODIC)
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_launches_compose_to_halo_reduce(mesh_shape, periodic):
    """Cut, exchange, pending add, exchange, ..., fold with the received
    strips: every shard's J equals fold_reduce_plain's with the mesh bit
    for bit, and so does fold_reduce's CPU path, which runs them."""
    mesh, specs = _mesh(mesh_shape, periodic)
    rims = _panels(mesh.size, seed=mesh.size + sum(periodic))
    strip = tuple(sp.size > 1 or sp.periodic for sp in specs)
    pending = [fold_cut_3d_plain(r, NLOC, strip) for r in rims]
    received = [[None] * 3 for _ in rims]
    for ax in (2, 1, 0):
        if not strip[ax]:
            continue
        lo, hi = exchange_strips([p[ax][0] for p in pending],
                                 [p[ax][1] for p in pending], specs[ax], mesh)
        for i in range(mesh.size):
            received[i][ax] = (lo[i], hi[i])
            fold_pend_3d_plain(pending[i], lo[i], hi[i], ax, NLOC, strip)
    got = [fold3_plain(r, NLOC, strip, rec) for r, rec in zip(rims, received)]
    ref = fold_reduce_plain(rims, NLOC, None, mesh, specs)
    wrapped = fold_reduce(rims, NLOC, None, mesh, specs)
    for a, b, c in zip(got, ref, wrapped):
        assert a.shape == (3,) + NLOC
        assert torch.equal(a, b) and torch.equal(c, b)


def test_corner_reaches_the_diagonal_shard():
    """Only shard (0, 0, 0) holds current, on its guard corner nodes
    (padded n + 2, n + 3 along every axis): on an open 2 x 2 x 2 mesh it
    lands on shard (1, 1, 1)'s first two rows of every axis, through the
    z, y and x exchanges, and nowhere else."""
    mesh, specs = _mesh((2, 2, 2), (False,) * 3)
    rims = [torch.zeros(panel_shape(3, *NLOC), dtype=torch.float64)
            for _ in range(mesh.size)]
    # padded n + 2, n + 3 = panel 0 nodes 10, 11 along each axis (n = 8)
    rims[0][:, 0, 0, 0, 10:, 10:, 10:] = torch.arange(
        1.0, 25.0, dtype=torch.float64).view(3, 2, 2, 2)
    got = fold_reduce(rims, NLOC, None, mesh, specs)
    ref = fold_reduce_plain(rims, NLOC, None, mesh, specs)
    far = mesh.index((1, 1, 1))
    for i, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b)
        if i != far:
            assert not a.any(), i
    corner = got[far][:, :2, :2, :2]
    assert torch.equal(corner, rims[0][:, 0, 0, 0, 10:, 10:, 10:])
    assert float(got[far].abs().sum()) == float(corner.abs().sum())


def _jax_deposit_halo(data, alive, mesh_shape, periodic):
    """The JAX package's XLA deposit into the padded J and halo_reduce
    across the mesh, under shard_map; numpy J per shard under leading
    mesh axes."""
    from lambdapic_tpu.ops import cell3d
    from lambdapic_tpu.parallel.halo import HaloSpec as JHaloSpec, \
        halo_reduce
    n = int(np.prod(mesh_shape))
    jmesh = JMesh(np.array(jax.devices()[:n]).reshape(mesh_shape), NAMES)
    specs = tuple(JHaloSpec(NAMES[i], mesh_shape[i], periodic[i])
                  for i in range(3))

    def run(d, al):
        d = {k: v.reshape(v.shape[3:]) for k, v in d.items()}
        al = al.reshape(al.shape[3:])
        w = jnp.where(al, d["w"], 0.0)
        jpad = cell3d.deposit_cell_3d(
            d["x"], d["y"], d["z"], d["ux"], d["uy"], d["uz"],
            d["inv_gamma"], w, q=Q, dx=DX, dy=DY, dz=DZ, dt=DT, g=G)
        j = halo_reduce(jpad, G, (1, 2, 3), specs)
        return j.reshape((1, 1, 1) + j.shape)

    spec = P(*NAMES)
    f = jax.jit(shard_map(run, jmesh, in_specs=(spec, spec),
                          out_specs=spec))
    keys = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")
    return np.asarray(f({k: jnp.asarray(data[k]) for k in keys},
                        jnp.asarray(alive)))


def test_mesh_fold_matches_jax_deposit_and_halo_reduce():
    """Particles of every shard deposited into tile panels by the port
    (deposit_panels_3d) and folded across a periodic-x, open-y, periodic-z
    2 x 2 x 2 mesh by the composed launches, against the JAX package's
    deposit_cell_3d and halo_reduce under shard_map: J to 1e-12 of its
    peak."""
    mesh_shape, periodic = (2, 2, 2), (True, False, True)
    data, alive, _ = random_mesh_cells(mesh_shape, 4, NLOC, seed=21,
                                       n_frac=0.6)
    ref = _jax_deposit_halo(data, alive, mesh_shape, periodic)
    mesh, specs = _mesh(mesh_shape, periodic)
    shards = mesh_to_torch(data, alive, mesh, torch.float64)
    rims = []
    for d, a in shards:
        w = torch.where(a, d["w"], 0.0)
        rims.append(deposit_panels_3d(
            *[d[k] for k in ("x", "y", "z", "ux", "uy", "uz", "inv_gamma")],
            w, q=Q, dx=DX, dy=DY, dz=DZ, dt=DT))
    got = fold_reduce(rims, NLOC, None, mesh, specs)
    got = np.stack([j.numpy() for j in got]).reshape(ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * scale)
