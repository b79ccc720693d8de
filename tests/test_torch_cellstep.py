"""The port's particle stage (plain version of kernel B2) and rim fold
(plain version of kernel B3) against the JAX package's XLA cell path.

Oracle: push_position_2d -> migrate_cells(sort_fn=Batcher network) ->
gather_cell_2d -> boris_push -> push_position_2d -> deposit_cell_2d ->
halo_reduce, inside shard_map on a one-device mesh. The Batcher network
below is the compare-exchange list of the TPU kernel
(ops/cellpallas.py::_batcher_network), applied in jnp: the TPU kernel
sorts with it, and stable lax.sort places tied keys differently, which
changes merge pairings. Comparison: each cell's slots sorted by
(dead, id_lo); alive and ids equal, other attributes to rtol 1e-11, merge
counts equal; J to 1e-12 of its peak (slot sums run in another order).
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

from lambdapic_torch.ops import cell2d as t_cell2d
from lambdapic_torch.ops.cellslab import (cell_step, cell_step_plain,
                                          fold_reduce, fold_reduce_plain)
from lambdapic_torch.testing import compare_slots, random_cell_state, \
    sparse_cell_state, to_numpy, to_torch
from lambdapic_torch.testing import torch_threads

Q, M, DT = -1.602e-19, 9.109e-31, 1.1e-16
DX = 5e-8          # c dt / dx ~ 0.66
G = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: beside the other test processes a full pool
    waits on their threads (lambdapic_torch.testing.torch_threads)."""
    with torch_threads(1):
        yield


def batcher_network(n: int, cap: int):
    """Batcher odd-even mergesort compare-exchange list for n = 2^k
    slots, skipping exchanges whose upper index >= cap."""
    ces = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        a, b = i + j, i + j + k
                        if b < cap:
                            ces.append((a, b))
            k //= 2
        p *= 2
    return ces


def batcher_stages(ces, cap):
    """The compare-exchange list cut into stages of consecutive exchanges
    on disjoint slots, as numpy arrays over the cap slots: each slot's
    partner in the stage (itself if it has none) and whether it is the
    lower slot of its pair. Exchanges on disjoint slots commute, so a
    stage run at once is the list run in order."""
    stages, cur, used = [], [], set()
    for a, b in ces:
        if a in used or b in used:
            stages.append(cur)
            cur, used = [], set()
        cur.append((a, b))
        used.update((a, b))
    if cur:
        stages.append(cur)
    out = []
    for st in stages:
        partner = np.arange(cap)
        low = np.zeros(cap, bool)
        for a, b in st:
            partner[a], partner[b], low[a] = b, a, True
        out.append((partner, low))
    return out


def batcher_sort_jnp(key, payloads, ces=None):
    """Sort (key, *payloads) along the slot axis with the Batcher list
    (``ces``, by default this file's ``batcher_network``), swapping on a
    strict ka > kb. The exchange decisions depend on the keys alone, so
    the network runs on (key, slot index), a stage of disjoint exchanges
    at a time (each slot reads its partner's key and takes it where the
    pair swaps), and the payloads are permuted once at the end: bitwise
    the same as carrying them through every exchange, in a few ops a
    stage instead of a few a payload and exchange."""
    cap = key.shape[0]
    if ces is None:
        n2 = 1
        while n2 < cap:
            n2 *= 2
        ces = batcher_network(n2, cap)
    bshape = (cap,) + (1,) * (key.ndim - 1)
    idx = jnp.broadcast_to(jnp.arange(cap, dtype=jnp.int32).reshape(bshape),
                           key.shape)
    for partner, low in batcher_stages(ces, cap):
        kp, ip = key[partner], idx[partner]
        lo = jnp.asarray(low.reshape(bshape))
        swap = jnp.where(lo, key > kp, kp > key)
        key = jnp.where(swap, kp, key)
        idx = jnp.where(swap, ip, idx)
    return key, [jnp.take_along_axis(p, idx, axis=0) for p in payloads]


@pytest.mark.parametrize("cap", [4, 6, 20, 33])
def test_batcher_network_matches_tpu_kernel(cap):
    from lambdapic_tpu.ops.cellpallas import _batcher_network
    n2 = 1
    while n2 < cap:
        n2 *= 2
    assert batcher_network(n2, cap) == _batcher_network(n2, cap)
    assert list(t_cell2d.batcher_network(cap)) == _batcher_network(n2, cap)


def jax_reference(data, alive, eb_pad, periodic):
    """The JAX XLA cell path for one species; returns numpy
    (data, alive, n_lost, J interior (4, nx, ny))."""
    from lambdapic_tpu.constants import c as c_light
    from lambdapic_tpu.ops.cell2d import (deposit_cell_2d, gather_cell_2d,
                                          migrate_cells)
    from lambdapic_tpu.ops.pusher import boris_push, push_position_2d
    from lambdapic_tpu.parallel.halo import HaloSpec, halo_reduce

    cap, nx, ny = alive.shape
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("px", "py"))
    specs = (HaloSpec("px", 1, periodic[0]), HaloSpec("py", 1, periodic[1]))
    plan = ((nx, specs[0], "x"), (ny, specs[1], "y"))
    h = c_light * DT / DX / 2

    def run(eb, d, al):
        d = dict(d)
        d["x"], d["y"] = push_position_2d(d["x"], d["y"], d["ux"], d["uy"],
                                          d["inv_gamma"], h, h)
        d, al, n_lost = migrate_cells(d, al, plan, recompute_ig=True,
                                      sort_fn=batcher_sort_jnp)
        eb_p = gather_cell_2d(eb, d["x"], d["y"], G)
        ux, uy, uz, ig = boris_push(d["ux"], d["uy"], d["uz"], *eb_p, Q, M, DT)
        x, y = push_position_2d(d["x"], d["y"], ux, uy, ig, h, h)
        w = jnp.where(al, d["w"], 0.0)
        jpad = deposit_cell_2d(x, y, ux, uy, uz, ig, w, q=Q, dx=DX, dy=DX,
                               dt=DT, g=G)
        j = halo_reduce(jpad, G, (1, 2), specs)
        d.update(x=x, y=y, ux=ux, uy=uy, uz=uz, inv_gamma=ig)
        return d, al, n_lost.reshape(1, 1), j

    f = jax.jit(shard_map(run, mesh, in_specs=(P(), P(), P()),
                          out_specs=(P(), P(), P("px", "py"), P())))
    d, al, n_lost, j = f(jnp.asarray(eb_pad),
                         {k: jnp.asarray(v) for k, v in data.items()},
                         jnp.asarray(alive))
    return ({k: np.asarray(v) for k, v in d.items()}, np.asarray(al),
            int(np.asarray(n_lost).sum()), np.asarray(j))


CASES = [
    # (cap, nx, ny, periodic, n_frac, expect_merges)
    (4, 16, 16, (True, True), 0.4, None),
    (6, 16, 24, (False, False), 0.4, None),
    (4, 20, 16, (True, False), 0.9, True),
    (8, 16, 16, (False, True), 0.85, True),
]


@pytest.mark.parametrize("cap,nx,ny,periodic,n_frac,merges", CASES)
def test_cell_step_plain_matches_jax(cap, nx, ny, periodic, n_frac, merges):
    data, alive, eb_pad = random_cell_state(cap, nx, ny, g=G, n_frac=n_frac,
                                            seed=cap + nx)
    ref, ref_alive, ref_lost, ref_j = jax_reference(data, alive, eb_pad,
                                                    periodic)
    td, ta = to_torch(data, alive, torch.float64, "cpu")
    d, a, n_lost, rims = cell_step_plain(
        torch.as_tensor(eb_pad), td, ta, q=Q, m=M, dt=DT, dx=DX, dy=DX, g=G,
        periodic=periodic)
    got, got_alive = to_numpy(d, a)
    compare_slots(ref, ref_alive, got, got_alive, rtol=1e-11)
    assert int(n_lost) == ref_lost
    if merges:
        assert ref_lost > 0
    j = fold_reduce_plain(rims, (nx, ny), periodic).numpy()
    scale = np.abs(ref_j).max()
    np.testing.assert_allclose(j, ref_j, rtol=0, atol=1e-12 * scale)
    # the wrappers take the plain versions for CPU tensors
    d2, a2, n2, rims2 = cell_step(
        torch.as_tensor(eb_pad), td, ta, q=Q, m=M, dt=DT, dx=DX, dy=DX, g=G,
        periodic=periodic)
    assert torch.equal(rims2, rims) and torch.equal(a2, a) and int(n2) == int(n_lost)
    assert torch.equal(fold_reduce(rims, (nx, ny), periodic),
                       fold_reduce_plain(rims, (nx, ny), periodic))


@pytest.mark.parametrize("case", ["band", "corner", "wrap", "open",
                                  "crowded"])
def test_cell_step_plain_matches_jax_sparse(case):
    """The plain version against the JAX XLA cell path on the sparse
    states that kernel B2's gpu tests hold the kernel to (empty tiles
    beside occupied ones, arrivals into empty tiles, faces, merges), 8
    slots a cell."""
    data, alive, eb_pad, periodic = sparse_cell_state(case, 8, seed=8)
    ref, ref_alive, ref_lost, ref_j = jax_reference(data, alive, eb_pad,
                                                    periodic)
    td, ta = to_torch(data, alive, torch.float64, "cpu")
    d, a, n_lost, rims = cell_step_plain(
        torch.as_tensor(eb_pad), td, ta, q=Q, m=M, dt=DT, dx=DX, dy=DX, g=G,
        periodic=periodic)
    got, got_alive = to_numpy(d, a)
    compare_slots(ref, ref_alive, got, got_alive, rtol=1e-11)
    assert int(n_lost) == ref_lost
    if case == "crowded":
        assert ref_lost > 0
    if case == "open":
        assert got_alive.sum() < alive.sum()
    j = fold_reduce_plain(rims, tuple(alive.shape[1:]), periodic).numpy()
    np.testing.assert_allclose(j, ref_j, rtol=0,
                               atol=1e-12 * np.abs(ref_j).max())


def test_occupied_cell_state():
    """The seeded sparse inputs: occupied cells hold exactly per_cell
    alive slots, the others none; dead slots carry zero floats and
    inv_gamma 1."""
    from lambdapic_torch.testing import band_mask, occupied_cell_state
    mask = band_mask(24, 20, 5, 4)
    assert mask.sum() == 4 * 20 and mask[5:9].all()
    data, alive, _ = occupied_cell_state(12, mask, 7, seed=3)
    counts = alive.sum(0)
    assert (counts[mask] == 7).all() and (counts[~mask] == 0).all()
    for k in ("x", "y", "z", "w", "ux", "uy", "uz"):
        assert (data[k][~alive] == 0).all()
    assert (data["inv_gamma"][~alive] == 1).all()
    with pytest.raises(ValueError):
        occupied_cell_state(4, mask, 5)


def test_species_chain_and_no_rho():
    """Panels chained through rims_in sum the species' currents; without
    rho the panels carry jx, jy, jz only."""
    nx = ny = 16
    periodic = (True, False)
    outs = []
    rims = None
    for seed in (1, 2):
        data, alive, eb_pad = random_cell_state(4, nx, ny, g=G, seed=seed)
        td, ta = to_torch(data, alive, torch.float64, "cpu")
        kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DX, g=G, periodic=periodic)
        single = cell_step_plain(torch.as_tensor(eb_pad), td, ta, **kw)[3]
        rims = cell_step_plain(torch.as_tensor(eb_pad), td, ta, rims_in=rims,
                               **kw)[3]
        no_rho = cell_step_plain(torch.as_tensor(eb_pad), td, ta,
                                 with_rho=False, **kw)[3]
        assert no_rho.shape[0] == 3
        torch.testing.assert_close(no_rho, single[:3], rtol=0, atol=0)
        outs.append(fold_reduce_plain(single, (nx, ny), periodic))
    total = fold_reduce_plain(rims, (nx, ny), periodic)
    torch.testing.assert_close(total, outs[0] + outs[1], rtol=1e-12,
                               atol=1e-12 * float(total.abs().max()))


def test_fold_matches_halo_reduce_of_deposit():
    """Panels folded by B3's plain version equal the padded-J deposit
    followed by halo_reduce (the JAX package's fold)."""
    from lambdapic_torch.ops.cellslab import deposit_panels
    from lambdapic_torch.parallel.halo import halo_reduce
    nx, ny = 20, 36
    data, alive, _ = random_cell_state(4, nx, ny, g=G, seed=5, spread=0.99)
    td, ta = to_torch(data, alive, torch.float64, "cpu")
    args = [td[k] for k in ("x", "y", "ux", "uy", "uz", "inv_gamma")]
    w = torch.where(ta, td["w"], 0.0)
    for periodic in ((True, True), (False, True), (False, False)):
        jpad = t_cell2d.deposit_cell_2d(*args, w, q=Q, dx=DX, dy=DX, dt=DT,
                                        g=G)
        ref = halo_reduce(jpad, G, (1, 2), periodic)
        pan = deposit_panels(*args, w, q=Q, dx=DX, dy=DX, dt=DT)
        got = fold_reduce_plain(pan, (nx, ny), periodic)
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-12 * float(ref.abs().max()))
