"""The port's 3D cell operations, particle stage (plain version of kernel
B2 in 3D) and rim fold (plain version of kernel B3 in 3D) against the JAX
package's XLA cell path.

Oracle: push_position_3d -> migrate_cell_3d(sort_fn=Batcher network) ->
gather_cell_3d -> boris_push -> push_position_3d -> deposit_cell_3d ->
halo_reduce, inside shard_map on a one-device mesh, with the Batcher
compare-exchange list of the TPU kernel applied in jnp (stable lax.sort
places tied keys differently, which changes merge pairings). Comparison:
each cell's slots sorted by (dead, id_lo); alive and ids equal, other
attributes to rtol 1e-11 (with compare_slots' floor of 1e-14 of each
attribute's peak), merge counts equal; J, gathered fields and the padded
deposit to 1e-12 of their peak (sums run in another order).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map as _shard_map

    def shard_map(f, mesh, in_specs, out_specs):
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False)
except ImportError:
    from jax.experimental.shard_map import shard_map as _shard_map

    def shard_map(f, mesh, in_specs, out_specs):
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_rep=False)

from test_torch_cellstep import batcher_sort_jnp as _batcher_sort_jnp
from lambdapic_torch.ops import cell3d as t_cell3d
from lambdapic_torch.ops.cell2d import batcher_network
from lambdapic_torch.ops.cellslab import (cell_step, cell_step_plain,
                                          deposit_panels_3d, fold_reduce,
                                          fold_reduce_plain, panel_shape)
from lambdapic_torch.parallel.halo import halo_reduce
from lambdapic_torch.testing import compare_slots, random_cell_state, \
    to_numpy, to_torch
from lambdapic_torch.testing import torch_threads

Q, M, DT = -1.602e-19, 9.109e-31, 1.1e-16
DX, DY, DZ = 5e-8, 6e-8, 5.5e-8      # c dt / d ~ 0.66, 0.55, 0.6
G = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: beside the other test processes a full pool
    waits on their threads (lambdapic_torch.testing.torch_threads)."""
    with torch_threads(1):
        yield


def batcher_sort_jnp(key, payloads):
    """Sort (key, *payloads) along the slot axis with the TPU kernel's
    compare-exchange list, swapping on a strict ka > kb (a stage of
    disjoint exchanges at a time, test_torch_cellstep.batcher_sort_jnp)."""
    return _batcher_sort_jnp(key, payloads,
                             ces=batcher_network(key.shape[0]))


def test_batcher_list_is_the_tpu_kernels():
    from lambdapic_tpu.ops.cellpallas import _batcher_network
    for cap in (4, 6):
        n2 = 1
        while n2 < cap:
            n2 *= 2
        assert list(batcher_network(cap)) == _batcher_network(n2, cap)


def _state(cap, nx, ny, nz, seed, **kw):
    data, alive, eb_pad = random_cell_state(cap, nx, ny, nz, g=G, seed=seed,
                                            **kw)
    td, ta = to_torch(data, alive, torch.float64, "cpu")
    return data, alive, eb_pad, td, ta


def test_gather_cell_3d_matches_jax():
    from lambdapic_tpu.ops.cell3d import gather_cell_3d
    data, alive, eb_pad, td, ta = _state(3, 6, 5, 7, seed=2)
    ref = gather_cell_3d(jnp.asarray(eb_pad), jnp.asarray(data["x"]),
                         jnp.asarray(data["y"]), jnp.asarray(data["z"]), G)
    got = t_cell3d.gather_cell_3d(torch.as_tensor(eb_pad), td["x"], td["y"],
                                  td["z"], G)
    for r, g_ in zip(ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(g_.numpy(), r, rtol=0,
                                   atol=1e-12 * np.abs(r).max())
    assert np.abs(np.asarray(ref[0])[alive]).max() > 0


def test_deposit_cell_3d_matches_jax():
    from lambdapic_tpu.ops.cell3d import deposit_cell_3d
    data, alive, _, td, ta = _state(3, 6, 5, 7, seed=3, spread=0.99)
    names = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma")
    w = np.where(alive, data["w"], 0.0)
    kw = dict(q=Q, dx=DX, dy=DY, dz=DZ, dt=DT, g=G)
    ref = np.asarray(deposit_cell_3d(*[jnp.asarray(data[k]) for k in names],
                                     jnp.asarray(w), **kw))
    got = t_cell3d.deposit_cell_3d(*[td[k] for k in names],
                                   torch.as_tensor(w), **kw).numpy()
    for c in range(4):
        scale = np.abs(ref[c]).max()
        assert scale > 0
        np.testing.assert_allclose(got[c], ref[c], rtol=0, atol=1e-12 * scale)


def jax_reference(data, alive, eb_pad, periodic):
    """The JAX XLA cell path for one species in 3D; returns numpy
    (data, alive, n_lost, J interior (4, nx, ny, nz))."""
    from lambdapic_tpu.constants import c as c_light
    from lambdapic_tpu.ops.cell3d import (deposit_cell_3d, gather_cell_3d,
                                          migrate_cell_3d)
    from lambdapic_tpu.ops.pusher import boris_push, push_position_3d
    from lambdapic_tpu.parallel.halo import HaloSpec, halo_reduce as j_reduce

    cap, nx, ny, nz = alive.shape
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("px", "py", "pz"))
    specs = tuple(HaloSpec(n, 1, per)
                  for n, per in zip(("px", "py", "pz"), periodic))
    h = [c_light * DT / d / 2 for d in (DX, DY, DZ)]

    def run(eb, d, al):
        d = dict(d)
        d["x"], d["y"], d["z"] = push_position_3d(
            d["x"], d["y"], d["z"], d["ux"], d["uy"], d["uz"],
            d["inv_gamma"], *h)
        d, al, n_lost = migrate_cell_3d(d, al, specs, nx, ny, nz,
                                        recompute_ig=True,
                                        sort_fn=batcher_sort_jnp)
        eb_p = gather_cell_3d(eb, d["x"], d["y"], d["z"], G)
        ux, uy, uz, ig = boris_push(d["ux"], d["uy"], d["uz"], *eb_p, Q, M, DT)
        x, y, z = push_position_3d(d["x"], d["y"], d["z"], ux, uy, uz, ig, *h)
        w = jnp.where(al, d["w"], 0.0)
        jpad = deposit_cell_3d(x, y, z, ux, uy, uz, ig, w, q=Q, dx=DX, dy=DY,
                               dz=DZ, dt=DT, g=G)
        j = j_reduce(jpad, G, (1, 2, 3), specs)
        d.update(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, inv_gamma=ig)
        return d, al, n_lost.reshape(1, 1, 1), j

    f = jax.jit(shard_map(run, mesh, in_specs=(P(), P(), P()),
                          out_specs=(P(), P(), P("px", "py", "pz"), P())))
    d, al, n_lost, j = f(jnp.asarray(eb_pad),
                         {k: jnp.asarray(v) for k, v in data.items()},
                         jnp.asarray(alive))
    return ({k: np.asarray(v) for k, v in d.items()}, np.asarray(al),
            int(np.asarray(n_lost).sum()), np.asarray(j))


CASES = [
    # (cap, nx, ny, nz, periodic, n_frac, expect_merges)
    (4, 8, 6, 10, (True, True, True), 0.4, None),
    (4, 8, 6, 10, (False, False, False), 0.4, None),
    (4, 8, 6, 10, (True, False, True), 0.9, True),
]


@pytest.mark.parametrize("cap,nx,ny,nz,periodic,n_frac,merges", CASES)
def test_cell_step_plain_3d_matches_jax(cap, nx, ny, nz, periodic, n_frac,
                                        merges):
    data, alive, eb_pad, td, ta = _state(cap, nx, ny, nz, seed=cap + nx,
                                         n_frac=n_frac)
    ref, ref_alive, ref_lost, ref_j = jax_reference(data, alive, eb_pad,
                                                    periodic)
    kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DY, dz=DZ, g=G, periodic=periodic)
    d, a, n_lost, rims = cell_step_plain(torch.as_tensor(eb_pad), td, ta, **kw)
    got, got_alive = to_numpy(d, a)
    compare_slots(ref, ref_alive, got, got_alive, rtol=1e-11)
    assert int(n_lost) == ref_lost
    if merges:
        assert ref_lost > 0
    # guard on the test itself: particles changed cells along every axis
    for axis in range(3):
        idx = np.broadcast_to(np.arange(alive.shape[1 + axis]).reshape(
            [-1 if i == 1 + axis else 1 for i in range(4)]), alive.shape)
        before = dict(zip(data["id_lo"][alive].tolist(), idx[alive].tolist()))
        after = dict(zip(got["id_lo"][got_alive].tolist(),
                         idx[got_alive].tolist()))
        assert sum(before[i] != c for i, c in after.items()) > 0, axis
    assert rims.shape == panel_shape(4, nx, ny, nz)
    j = fold_reduce_plain(rims, (nx, ny, nz), periodic).numpy()
    scale = np.abs(ref_j).max()
    np.testing.assert_allclose(j, ref_j, rtol=0, atol=1e-12 * scale)
    # the wrappers take the plain versions for CPU tensors
    d2, a2, n2, rims2 = cell_step(torch.as_tensor(eb_pad), td, ta, **kw)
    assert torch.equal(rims2, rims) and torch.equal(a2, a) \
        and int(n2) == int(n_lost)
    assert torch.equal(fold_reduce(rims, (nx, ny, nz), periodic),
                       fold_reduce_plain(rims, (nx, ny, nz), periodic))


def test_species_chain_and_no_rho_3d():
    """3D panels chained through rims_in sum the species' currents;
    without rho the panels carry jx, jy, jz only."""
    nx, ny, nz = 8, 6, 10
    periodic = (True, False, True)
    outs = []
    rims = None
    for seed in (1, 2):
        data, alive, eb_pad, td, ta = _state(4, nx, ny, nz, seed=seed)
        kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DY, dz=DZ, g=G,
                  periodic=periodic)
        eb = torch.as_tensor(eb_pad)
        single = cell_step_plain(eb, td, ta, **kw)[3]
        rims = cell_step_plain(eb, td, ta, rims_in=rims, **kw)[3]
        no_rho = cell_step_plain(eb, td, ta, with_rho=False, **kw)[3]
        assert no_rho.shape[0] == 3
        torch.testing.assert_close(no_rho, single[:3], rtol=0, atol=0)
        outs.append(fold_reduce_plain(single, (nx, ny, nz), periodic))
    total = fold_reduce_plain(rims, (nx, ny, nz), periodic)
    torch.testing.assert_close(total, outs[0] + outs[1], rtol=1e-12,
                               atol=1e-12 * float(total.abs().max()))


@pytest.mark.parametrize("periodic", [(True, True, True),
                                      (False, True, False),
                                      (False, False, False)])
def test_fold_3d_matches_halo_reduce_of_deposit(periodic):
    """3D panels folded by B3's plain version equal the padded-J deposit
    followed by halo_reduce (the JAX package's fold); the grid is not a
    multiple of the tile along any axis."""
    nx, ny, nz = 10, 12, 9
    data, alive, _, td, ta = _state(4, nx, ny, nz, seed=5, spread=0.99)
    args = [td[k] for k in ("x", "y", "z", "ux", "uy", "uz", "inv_gamma")]
    w = torch.where(ta, td["w"], 0.0)
    kw = dict(q=Q, dx=DX, dy=DY, dz=DZ, dt=DT)
    jpad = t_cell3d.deposit_cell_3d(*args, w, g=G, **kw)
    ref = halo_reduce(jpad, G, (1, 2, 3), periodic)
    pan = deposit_panels_3d(*args, w, **kw)
    got = fold_reduce_plain(pan, (nx, ny, nz), periodic)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-12 * float(ref.abs().max()))
