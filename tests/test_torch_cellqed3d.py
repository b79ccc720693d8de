"""The plain versions of kernel B2's ``want_chi`` and ``photon`` modes on
3D slots against the JAX package's XLA cell path with the Batcher-order
sort (the 3D form of tests/test_torch_cellqed.py).

Oracle, want_chi: push_position_3d -> cell3d.migrate_cell_3d(sort_fn=
Batcher, recompute_ig=True) -> gather_cell_3d -> calculate_chi (at the
post-migration pre-push momenta and inv_gamma) -> boris_push ->
push_position_3d -> deposit_cell_3d. The species carries the QED payloads
tau, delta and event, different in every slot: they ride the re-binning
and take the placed slot's value on a merge. Oracle, photon:
push_position_3d -> migrate_cell_3d(recompute_ig=False) -> photon_push ->
push_position_3d, with no rims.

Float64; slots compared after canonicalisation (alive and ids equal,
other attributes to rtol 1e-11, the QED payloads exactly), chi to rtol
1e-10 and ig0 to rtol 1e-12, merge counts equal, J to 1e-12 of its peak.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from test_torch_cell3d import batcher_sort_jnp, shard_map
from lambdapic_torch.ops.cellslab import (cell_step, cell_step_plain,
                                          extra_payloads, fold_reduce_plain)
from lambdapic_torch.testing import QED_PAYLOADS, add_qed_payloads, \
    compare_slots, photon_cell_state, random_cell_state, to_numpy, to_torch
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


def qed_state(cap, nx, ny, nz, n_frac, seed):
    """A random 3D cell state with QED payloads that differ per slot, and
    fields strong enough to give chi of order 1e-3..1."""
    data, alive, eb_pad = random_cell_state(cap, nx, ny, nz, g=G,
                                            n_frac=n_frac, seed=seed,
                                            umax=50.0, field=5e13)
    return add_qed_payloads(data, seed + 100), alive, eb_pad


def jax_reference(data, alive, eb_pad, periodic, photon):
    from lambdapic_tpu.constants import c as c_light
    from lambdapic_tpu.models.qed import calculate_chi
    from lambdapic_tpu.ops.cell3d import (deposit_cell_3d, gather_cell_3d,
                                          migrate_cell_3d)
    from lambdapic_tpu.ops.pusher import (boris_push, photon_push,
                                          push_position_3d)
    from lambdapic_tpu.parallel.halo import HaloSpec, halo_reduce

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
                                        recompute_ig=not photon,
                                        sort_fn=batcher_sort_jnp)
        if photon:
            ig = photon_push(d["ux"], d["uy"], d["uz"])
            d["x"], d["y"], d["z"] = push_position_3d(
                d["x"], d["y"], d["z"], d["ux"], d["uy"], d["uz"], ig, *h)
            d["inv_gamma"] = ig
            z = jnp.zeros((4, nx, ny, nz))
            return d, al, n_lost.reshape(1, 1, 1), z, z[0], z[0]
        eb_p = gather_cell_3d(eb, d["x"], d["y"], d["z"], G)
        ig0 = d["inv_gamma"]
        chi = calculate_chi(*eb_p, d["ux"], d["uy"], d["uz"], ig0)
        ux, uy, uz, ig = boris_push(d["ux"], d["uy"], d["uz"], *eb_p, Q, M,
                                    DT)
        x, y, z = push_position_3d(d["x"], d["y"], d["z"], ux, uy, uz, ig,
                                   *h)
        w = jnp.where(al, d["w"], 0.0)
        jpad = deposit_cell_3d(x, y, z, ux, uy, uz, ig, w, q=Q, dx=DX, dy=DY,
                               dz=DZ, dt=DT, g=G)
        j = halo_reduce(jpad, G, (1, 2, 3), specs)
        d.update(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, inv_gamma=ig)
        return d, al, n_lost.reshape(1, 1, 1), j, chi, ig0

    f = jax.jit(shard_map(run, mesh, in_specs=(P(), P(), P()),
                          out_specs=(P(), P(), P("px", "py", "pz"), P(), P(),
                                     P())))
    d, al, n_lost, j, chi, ig0 = f(
        jnp.asarray(eb_pad), {k: jnp.asarray(v) for k, v in data.items()},
        jnp.asarray(alive))
    return ({k: np.asarray(v) for k, v in d.items()}, np.asarray(al),
            int(np.asarray(n_lost).sum()), np.asarray(j), np.asarray(chi),
            np.asarray(ig0))


CASES = [
    # (cap, nx, ny, nz, periodic, n_frac)
    (8, 8, 8, 8, (True, True, True), 0.4),
    (8, 8, 8, 8, (False, False, False), 0.5),
    (8, 8, 8, 8, (True, False, True), 0.9),     # merges
]


def _canon_dense(arr, d, alive):
    """A per-slot array in the (dead, id_lo) slot order of compare_slots."""
    key = (~alive).astype(np.int64) * (1 << 40) + d["id_lo"].astype(np.int64)
    order = np.argsort(key, axis=0, kind="stable")
    return np.take_along_axis(arr, order, axis=0), \
        np.take_along_axis(alive, order, axis=0)


@pytest.mark.parametrize("cap,nx,ny,nz,periodic,n_frac", CASES)
def test_want_chi_plain_3d_matches_jax(cap, nx, ny, nz, periodic, n_frac):
    data, alive, eb_pad = qed_state(cap, nx, ny, nz, n_frac,
                                    seed=cap + nx + int(10 * n_frac))
    ref, ref_alive, ref_lost, ref_j, ref_chi, ref_ig0 = jax_reference(
        data, alive, eb_pad, periodic, photon=False)
    td, ta = to_torch(data, alive, torch.float64, "cpu")
    assert extra_payloads(td) == ("delta", "event", "tau")
    kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DY, dz=DZ, g=G, periodic=periodic,
              want_chi=True)
    d, a, n_lost, rims, (chi, ig0) = cell_step_plain(
        torch.as_tensor(eb_pad), td, ta, **kw)
    got, got_alive = to_numpy(d, a)
    compare_slots(ref, ref_alive, got, got_alive, rtol=1e-11)
    compare_slots(ref, ref_alive, got, got_alive, rtol=0, keys=QED_PAYLOADS)
    assert int(n_lost) == ref_lost
    if n_frac > 0.8:
        assert ref_lost > 0
    rc, ra = _canon_dense(ref_chi, ref, ref_alive)
    gc, ga = _canon_dense(chi.numpy(), got, got_alive)
    np.testing.assert_allclose(gc[ga], rc[ra], rtol=1e-10, atol=1e-300)
    assert (rc[ra] > 1e-3).any()
    ri, _ = _canon_dense(ref_ig0, ref, ref_alive)
    gi, _ = _canon_dense(ig0.numpy(), got, got_alive)
    np.testing.assert_allclose(gi[ga], ri[ra], rtol=1e-12)
    j = fold_reduce_plain(rims, (nx, ny, nz), periodic).numpy()
    np.testing.assert_allclose(j, ref_j, rtol=0,
                               atol=1e-12 * np.abs(ref_j).max())
    # the wrapper takes the plain version for CPU tensors
    out = cell_step(torch.as_tensor(eb_pad), td, ta, **kw)
    assert torch.equal(out[4][0], chi) and torch.equal(out[3], rims)


@pytest.mark.parametrize("cap,nx,ny,nz,periodic,n_frac", CASES)
def test_photon_plain_3d_matches_jax(cap, nx, ny, nz, periodic, n_frac):
    data, alive = photon_cell_state(cap, nx, ny, nz, n_frac=n_frac,
                                    seed=cap + ny + int(10 * n_frac) + 1)
    eb_pad = np.zeros((6, nx + 2 * G, ny + 2 * G, nz + 2 * G))
    ref, ref_alive, ref_lost, *_ = jax_reference(data, alive, eb_pad,
                                                 periodic, photon=True)
    td, ta = to_torch(data, alive, torch.float64, "cpu")
    kw = dict(q=0.0, m=0.0, dt=DT, dx=DX, dy=DY, dz=DZ, g=G,
              periodic=periodic, photon=True)
    d, a, n_lost, rims = cell_step_plain(None, td, ta, **kw)
    assert rims is None
    got, got_alive = to_numpy(d, a)
    compare_slots(ref, ref_alive, got, got_alive, rtol=1e-11)
    assert int(n_lost) == ref_lost
    if n_frac > 0.8:
        assert ref_lost > 0
    # inv_gamma is 1/|u| on alive slots and 1 on dead ones
    u = np.sqrt(got["ux"]**2 + got["uy"]**2 + got["uz"]**2)
    np.testing.assert_allclose(got["inv_gamma"][got_alive],
                               1 / u[got_alive], rtol=1e-14)
    assert (got["inv_gamma"][~got_alive] == 1).all()
    out = cell_step(None, td, ta, **kw)
    assert out[3] is None and torch.equal(out[1], a)


def test_modes_exclude_each_other_3d():
    data, alive, eb_pad = qed_state(4, 6, 6, 6, 0.4, seed=1)
    td, ta = to_torch(data, alive, torch.float64, "cpu")
    with pytest.raises(ValueError, match="exclude"):
        cell_step(torch.as_tensor(eb_pad), td, ta, q=Q, m=M, dt=DT, dx=DX,
                  dy=DY, dz=DZ, g=G, periodic=(True,) * 3, want_chi=True,
                  photon=True)
