"""The plain versions of the per-stage kernels B4-B7
(lambdapic_torch/ops/cellpallas.py) and the exact re-binning against the
JAX package's functions, on the same numpy-seeded inputs (float64, CPU).

- B4 plain vs JAX gather_cell_2d + boris_push + push_position_2d (the
  first half push at 1/sqrt(1 + u^2) when do_pos1) on the alive slots,
  the dead values (0, inv_gamma 1) in the dead ones;
- B5 plain vs JAX deposit_cell_2d: 1e-12 of the current's peak (the slot
  sums run in another order);
- the exact migrate_cells vs JAX migrate_cells(exact=True), slot for slot
  without canonicalisation: both sort stably, so alive masks and ids
  match in place, with overflow merges and rows past 2 cap dropped;
- the fast migrate_cells (Batcher order) and migrate_cells_fused's plain
  route vs JAX migrate_cells(sort_fn=<the Batcher list in jnp>), with
  merges;
- batcher_sort and sort_cells' plain route vs the TPU kernel's
  _batcher_network list applied in jnp.

Floats: lambdapic_torch.testing.compare_slots (rtol 1e-11, a floor of
1e-14 of each attribute's peak); merge counts equal.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_torch_cellstep import DT, DX, G, M, Q, batcher_sort_jnp, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from lambdapic_torch.ops import cell2d as t_cell2d
from lambdapic_torch.ops import cellpallas as t_cp
from lambdapic_torch.testing import (compare_slots, crowded_cell_state,
                                     random_cell_state, to_numpy, to_torch)
from lambdapic_torch.testing import torch_threads

EB = ("ex_part", "ey_part", "ez_part", "bx_part", "by_part", "bz_part")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: beside the other test processes a full pool
    waits on their threads (lambdapic_torch.testing.torch_threads)."""
    with torch_threads(1):
        yield


def _ids(data):
    return {k: data[k] for k in ("id_lo", "id_hi")}


@pytest.mark.parametrize("want_eb,do_pos1", [(False, False), (True, False),
                                             (False, True)])
def test_b4_plain_matches_jax(want_eb, do_pos1):
    from lambdapic_tpu.constants import c as c_light
    from lambdapic_tpu.ops.cell2d import gather_cell_2d
    from lambdapic_tpu.ops.pusher import boris_push, push_position_2d
    data, alive, eb_pad = random_cell_state(5, 20, 18, g=G, seed=3,
                                            field=5e13)
    h = c_light * DT / DX / 2

    @jax.jit
    def ref(eb, x, y, ux, uy, uz):
        if do_pos1:
            ig = 1.0 / jnp.sqrt(1.0 + ux**2 + uy**2 + uz**2)
            x, y = push_position_2d(x, y, ux, uy, ig, h, h)
        e = gather_cell_2d(eb, x, y, G)
        ux, uy, uz, ig = boris_push(ux, uy, uz, *e, Q, M, DT)
        x, y = push_position_2d(x, y, ux, uy, ig, h, h)
        return (x, y, ux, uy, uz, ig) + (tuple(e) if want_eb else ())

    names = ("x", "y", "ux", "uy", "uz", "inv_gamma") + \
        (EB if want_eb else ())
    args = [data[k] for k in ("x", "y", "ux", "uy", "uz")]
    want = dict(zip(names, (np.asarray(v) for v in ref(
        jnp.asarray(eb_pad), *(jnp.asarray(a) for a in args)))))
    targs = [torch.as_tensor(a) for a in args]
    kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DX, g=G, want_eb=want_eb,
              do_pos1=do_pos1, alive=torch.as_tensor(alive))
    got = t_cp.fused_push_cell_2d_plain(torch.as_tensor(eb_pad), *targs, **kw)
    assert len(got) == len(names)
    got = dict(zip(names, (t.numpy() for t in got)))
    compare_slots({**want, **_ids(data)}, alive, {**got, **_ids(data)},
                  alive, rtol=1e-11, keys=names)
    # every dead slot holds the dead values
    assert (~alive).any()
    for k in names:
        dead = 1.0 if k == "inv_gamma" else 0.0
        np.testing.assert_array_equal(got[k][~alive], dead, err_msg=k)
    # the fields reach the particles
    assert np.abs(got["ux"] - data["ux"]).max() > 0.1
    # the wrapper takes the plain version for CPU tensors
    before = dict(t_cp.fused_push_cell_2d.launches_by_mode)
    again = t_cp.fused_push_cell_2d(torch.as_tensor(eb_pad), *targs, **kw)
    assert t_cp.fused_push_cell_2d.launches_by_mode == before
    for k, t in zip(names, again):
        np.testing.assert_array_equal(t.numpy(), got[k], err_msg=k)


def test_b5_plain_matches_jax():
    from lambdapic_tpu.ops.cell2d import deposit_cell_2d
    data, alive, _ = random_cell_state(6, 20, 36, g=G, seed=5, spread=0.99)
    w = np.where(alive, data["w"], 0.0)
    args = [data[k] for k in ("x", "y", "ux", "uy", "uz", "inv_gamma")] + [w]
    kw = dict(q=Q, dx=DX, dy=0.8 * DX, dt=DT, g=G)
    ref = np.asarray(jax.jit(lambda *a: deposit_cell_2d(*a, **kw))(
        *(jnp.asarray(a) for a in args)))
    before = t_cp.deposit_cell_2d_k.launches
    got = t_cp.deposit_cell_2d_k(*(torch.as_tensor(a) for a in args),
                                 alive=torch.as_tensor(alive), **kw)
    assert t_cp.deposit_cell_2d_k.launches == before
    assert got.shape == ref.shape == (4, 20 + 2 * G, 36 + 2 * G)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def jax_migrate(data, alive, periodic, **kw):
    """JAX migrate_cells on a one-device mesh; numpy (data, alive,
    n_lost)."""
    from lambdapic_tpu.ops.cell2d import migrate_cells
    from lambdapic_tpu.parallel.halo import HaloSpec
    cap, nx, ny = alive.shape
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("px", "py"))
    specs = (HaloSpec("px", 1, periodic[0]), HaloSpec("py", 1, periodic[1]))
    plan = ((nx, specs[0], "x"), (ny, specs[1], "y"))

    def run(d, al):
        d, al, n_lost = migrate_cells(d, al, plan, **kw)
        return d, al, n_lost.reshape(1, 1)

    f = jax.jit(shard_map(run, mesh, in_specs=(P(), P()),
                          out_specs=(P(), P(), P("px", "py"))))
    d, al, n = f({k: jnp.asarray(v) for k, v in data.items()},
                 jnp.asarray(alive))
    return ({k: np.asarray(v) for k, v in d.items()}, np.asarray(al),
            int(np.asarray(n).sum()))


def _plan(nx, ny, periodic):
    return ((nx, periodic[0], "x"), (ny, periodic[1], "y"))


def _port_migrate(fn, data, alive, periodic, **kw):
    td, ta = to_torch(data, alive, torch.float64, "cpu")
    d, a, n = fn(td, ta, _plan(*alive.shape[1:], periodic), **kw)
    return (*to_numpy(d, a), int(n))


EXACT_CASES = [
    # (cap, nx, ny, periodic, n_frac, overflow)
    (8, 18, 12, (True, True), 0.15, False),
    (4, 18, 10, (True, True), 1.0, True),
    (4, 15, 12, (False, True), 0.9, True),
]


@pytest.mark.parametrize("cap,nx,ny,periodic,n_frac,overflow", EXACT_CASES)
def test_exact_migrate_matches_jax(cap, nx, ny, periodic, n_frac, overflow):
    data, alive, _ = crowded_cell_state(cap, nx, ny, seed=cap + nx,
                                        n_frac=n_frac)
    ref, ref_alive, ref_lost = jax_migrate(data, alive, periodic,
                                           recompute_ig=True, exact=True)
    got, got_alive, lost = _port_migrate(t_cell2d.migrate_cells, data, alive,
                                         periodic, exact=True)
    # slot for slot in place: both sort stably
    np.testing.assert_array_equal(got_alive, ref_alive)
    for k in ("id_lo", "id_hi"):
        np.testing.assert_array_equal(got[k][got_alive], ref[k][ref_alive])
    compare_slots(ref, ref_alive, got, got_alive, rtol=1e-11)
    assert lost == ref_lost
    n0, n1 = int(alive.sum()), int(got_alive.sum())
    w0 = np.asarray(data["w"])[alive].sum()
    w1 = np.asarray(got["w"])[got_alive].sum()
    if not overflow:
        # lossless while no cell's total exceeds cap
        assert lost == 0 and n1 == n0
        np.testing.assert_allclose(w1, w0, rtol=1e-13)
    elif periodic == (True, True):
        # rows cap..2cap-1 merge (weight kept), rows >= 2cap drop (lost)
        assert lost > 0 and n1 + lost == n0 and w1 < w0
    else:
        assert lost > 0


MIG_CASES = [
    # (cap, nx, ny, periodic, n_frac, photon)
    (4, 16, 16, (True, True), 0.3, False),
    (4, 20, 16, (True, False), 0.9, False),
    (8, 16, 12, (False, True), 0.85, False),
    (6, 12, 16, (False, False), 0.8, True),
    # the edges of kernel B6's 2D tiles (csrc/migrate.cu), the shapes
    # tests/test_torch_kernels.py holds the kernel on: x one cell and y
    # over one row, not a multiple of 4; x two cells, y a multiple of 4; x
    # over several tiles at 16 and 20 slots; the tile's limit of 32 slots;
    # one slot above it
    (8, 1, 299, (True, False), 0.9, False),
    (4, 2, 260, (False, True), 0.9, True),
    (16, 17, 132, (False, True), 0.9, False),
    (20, 9, 70, (True, True), 1.0, True),
    (32, 6, 65, (False, False), 1.0, False),
    (33, 5, 9, (True, False), 1.0, True),
]


@pytest.mark.parametrize("cap,nx,ny,periodic,n_frac,photon", MIG_CASES)
def test_fast_migrate_matches_jax_batcher(cap, nx, ny, periodic, n_frac,
                                          photon):
    data, alive, _ = crowded_cell_state(cap, nx, ny, n_frac=n_frac,
                                        seed=cap + nx)
    if photon:
        u2 = data["ux"]**2 + data["uy"]**2 + data["uz"]**2
        data["inv_gamma"] = np.where(u2 > 0, 1 / np.sqrt(np.maximum(
            u2, 1e-30)), 1.0)
    ref, ref_alive, ref_lost = jax_migrate(data, alive, periodic,
                                           recompute_ig=not photon,
                                           sort_fn=batcher_sort_jnp)
    assert ref_lost > 0
    keys = ("x", "y", "z", "w", "ux", "uy", "uz", "inv_gamma")
    for fn in (t_cell2d.migrate_cells, t_cp.migrate_cells_fused):
        before = t_cp.migrate_axis.launches
        got, got_alive, lost = _port_migrate(fn, data, alive, periodic,
                                             recompute_ig=not photon)
        assert t_cp.migrate_axis.launches == before
        compare_slots(ref, ref_alive, got, got_alive, rtol=1e-11, keys=keys)
        assert lost == ref_lost
    # the fast scheme's sort through sort_cells' plain route
    got, got_alive, lost = _port_migrate(
        t_cell2d.migrate_cells, data, alive, periodic,
        recompute_ig=not photon, sort_fn=t_cp.sort_cells)
    compare_slots(ref, ref_alive, got, got_alive, rtol=1e-11, keys=keys)
    assert lost == ref_lost


@pytest.mark.parametrize("cap", [13, 16, 20])
def test_batcher_sort_matches_tpu_network(cap):
    from lambdapic_tpu.ops.cellpallas import _batcher_network
    n2 = 1
    while n2 < cap:
        n2 *= 2
    rng = np.random.default_rng(cap)
    shape = (cap, 6, 5)
    key = rng.integers(0, 5, shape).astype(np.int32)
    fl = rng.normal(size=shape)
    ids = rng.integers(-2**31, 2**31, shape).astype(np.int32)

    def jnp_sort(k, pays):
        rows_k = [k[a] for a in range(cap)]
        rows_v = [[p[a] for a in range(cap)] for p in pays]
        for a, b in _batcher_network(n2, cap):
            swap = rows_k[a] > rows_k[b]
            rows_k[a], rows_k[b] = (jnp.where(swap, rows_k[b], rows_k[a]),
                                    jnp.where(swap, rows_k[a], rows_k[b]))
            for v in rows_v:
                v[a], v[b] = (jnp.where(swap, v[b], v[a]),
                              jnp.where(swap, v[a], v[b]))
        return jnp.stack(rows_k), [jnp.stack(v) for v in rows_v]

    rk, (rf, ri) = jax.jit(jnp_sort)(jnp.asarray(key),
                                     [jnp.asarray(fl), jnp.asarray(ids)])
    for fn in (t_cell2d.batcher_sort, t_cp.sort_cells):
        gk, (gf, gi) = fn(torch.as_tensor(key),
                          [torch.as_tensor(fl), torch.as_tensor(ids)])
        np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(gf.numpy(), np.asarray(rf))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    assert t_cell2d.batcher_network(cap) == tuple(_batcher_network(n2, cap))
