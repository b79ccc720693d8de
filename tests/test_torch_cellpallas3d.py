"""The plain versions of the per-stage kernels in 3D (B4, B5, B6, B7 on
3D slots; lambdapic_torch/ops/cellpallas.py) and the exact re-binning of
3D slots against the JAX package's functions, on the same numpy-seeded
inputs (float64, CPU).

- B4 3D plain vs JAX gather_cell_3d + boris_push + push_position_3d (the
  first half push at 1/sqrt(1 + u^2) when do_pos1), the XLA oracle of
  tests/core/test_cellpallas.py::test_fused_push_3d_matches_xla, on the
  alive slots (the port's B4 takes the alive mask and gives the dead ones
  its dead values, which are checked exactly);
- B5 3D plain vs JAX deposit_cell_3d: 1e-12 of the current's peak (the
  slot sums run in another order);
- the fast 3D re-binning (cell2d.migrate_cells on three axes,
  migrate_cells_fused's plain route, migrate_cell_3d(sort_fn=sort_cells)
  through sort_cells' plain route) vs JAX migrate_cell_3d(sort_fn=<the
  Batcher list in jnp>), the oracle of tests/core/test_mig_fused.py, with
  periodic and open faces and merges;
- the exact 3D re-binning (migrate_cell_3d(exact=True)) vs JAX
  migrate_cell_3d(exact=True), slot for slot in place (both keep the
  stable order), with cells over capacity so that rows merge and drop.

Floats: lambdapic_torch.testing.compare_slots (rtol 1e-11, a floor of
1e-14 of each attribute's peak); merge counts equal.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from test_torch_cell3d import (DT, DX, DY, DZ, G, M, Q, batcher_sort_jnp,
                               shard_map)

from lambdapic_torch.ops import cell2d as t_cell2d
from lambdapic_torch.ops import cell3d as t_cell3d
from lambdapic_torch.ops import cellpallas as t_cp
from lambdapic_torch.testing import (add_qed_payloads, compare_slots,
                                     crowded_cell_state, random_cell_state,
                                     to_numpy, to_torch, torch_threads)

EB = ("ex_part", "ey_part", "ez_part", "bx_part", "by_part", "bz_part")
KEYS = ("x", "y", "z", "w", "ux", "uy", "uz", "inv_gamma")



@pytest.fixture(autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


def _ids(data):
    return {k: data[k] for k in ("id_lo", "id_hi")}


@pytest.mark.parametrize("want_eb,do_pos1", [(False, False), (True, False),
                                             (False, True)])
def test_b4_3d_plain_matches_jax(want_eb, do_pos1):
    from lambdapic_tpu.constants import c as c_light
    from lambdapic_tpu.ops.cell3d import gather_cell_3d
    from lambdapic_tpu.ops.pusher import boris_push, push_position_3d
    data, alive, eb_pad = random_cell_state(4, 7, 6, 9, g=G, seed=3,
                                            field=5e13)
    h = [c_light * DT / d / 2 for d in (DX, DY, DZ)]

    @jax.jit
    def ref(eb, x, y, z, ux, uy, uz):
        if do_pos1:
            ig = 1.0 / jnp.sqrt(1.0 + ux**2 + uy**2 + uz**2)
            x, y, z = push_position_3d(x, y, z, ux, uy, uz, ig, *h)
        e = gather_cell_3d(eb, x, y, z, G)
        ux, uy, uz, ig = boris_push(ux, uy, uz, *e, Q, M, DT)
        x, y, z = push_position_3d(x, y, z, ux, uy, uz, ig, *h)
        return (x, y, z, ux, uy, uz, ig) + (tuple(e) if want_eb else ())

    names = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma") + \
        (EB if want_eb else ())
    args = [data[k] for k in ("x", "y", "z", "ux", "uy", "uz")]
    want = dict(zip(names, (np.asarray(v) for v in ref(
        jnp.asarray(eb_pad), *(jnp.asarray(a) for a in args)))))
    targs = [torch.as_tensor(a) for a in args]
    kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DY, dz=DZ, g=G, want_eb=want_eb,
              do_pos1=do_pos1, alive=torch.as_tensor(alive))
    got = t_cp.fused_push_cell_3d_plain(torch.as_tensor(eb_pad), *targs, **kw)
    assert len(got) == len(names)
    got = dict(zip(names, (t.numpy() for t in got)))
    compare_slots({**want, **_ids(data)}, alive, {**got, **_ids(data)},
                  alive, rtol=1e-11, keys=names)
    assert (~alive).any()
    for k in names:
        dead = 1.0 if k == "inv_gamma" else 0.0
        np.testing.assert_array_equal(got[k][~alive], dead, err_msg=k)
    # the fields reach the particles
    assert np.abs(got["ux"] - data["ux"]).max() > 0.1
    # the wrapper takes the plain version for CPU tensors
    before = dict(t_cp.fused_push_cell_3d.launches_by_mode)
    again = t_cp.fused_push_cell_3d(torch.as_tensor(eb_pad), *targs, **kw)
    assert t_cp.fused_push_cell_3d.launches_by_mode == before
    for k, t in zip(names, again):
        np.testing.assert_array_equal(t.numpy(), got[k], err_msg=k)


def test_gather_3d_by_slot_chunks_is_bitwise(monkeypatch):
    """gather_cell_3d takes a large state a few slots at a time; the
    values do not depend on the chunk."""
    data, alive, eb_pad = random_cell_state(5, 6, 5, 7, g=G, seed=4)
    td, _ = to_torch(data, alive, torch.float64, "cpu")
    args = (torch.as_tensor(eb_pad), td["x"], td["y"], td["z"], G)
    whole = t_cell3d.gather_cell_3d(*args)
    monkeypatch.setattr(t_cell3d, "GATHER_CHUNK", 2 * 6 * 5 * 7)
    chunked = t_cell3d.gather_cell_3d(*args)
    for a, b in zip(whole, chunked):
        assert a.shape == b.shape == (5, 6, 5, 7)
        assert torch.equal(a, b)


def test_b5_3d_plain_matches_jax():
    from lambdapic_tpu.ops.cell3d import deposit_cell_3d
    data, alive, _ = random_cell_state(5, 6, 8, 7, g=G, seed=5, spread=0.99)
    w = np.where(alive, data["w"], 0.0)
    args = [data[k] for k in ("x", "y", "z", "ux", "uy", "uz",
                              "inv_gamma")] + [w]
    kw = dict(q=Q, dx=DX, dy=DY, dz=DZ, dt=DT, g=G)
    ref = np.asarray(jax.jit(lambda *a: deposit_cell_3d(*a, **kw))(
        *(jnp.asarray(a) for a in args)))
    before = t_cp.deposit_cell_3d_k.launches
    got = t_cp.deposit_cell_3d_k(*(torch.as_tensor(a) for a in args),
                                 alive=torch.as_tensor(alive), **kw)
    assert t_cp.deposit_cell_3d_k.launches == before
    assert got.shape == ref.shape == (4, 6 + 2 * G, 8 + 2 * G, 7 + 2 * G)
    for c in range(4):
        assert np.abs(ref[c]).max() > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def jax_migrate_3d(data, alive, periodic, **kw):
    """JAX migrate_cell_3d on a one-device mesh; numpy (data, alive,
    n_lost)."""
    from lambdapic_tpu.ops.cell3d import migrate_cell_3d
    from lambdapic_tpu.parallel.halo import HaloSpec
    cap, nx, ny, nz = alive.shape
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("px", "py", "pz"))
    specs = tuple(HaloSpec(n, 1, per)
                  for n, per in zip(("px", "py", "pz"), periodic))

    def run(d, al):
        d, al, n_lost = migrate_cell_3d(d, al, specs, nx, ny, nz, **kw)
        return d, al, n_lost.reshape(1, 1, 1)

    f = jax.jit(shard_map(run, mesh, in_specs=(P(), P()),
                          out_specs=(P(), P(), P("px", "py", "pz"))))
    d, al, n = f({k: jnp.asarray(v) for k, v in data.items()},
                 jnp.asarray(alive))
    return ({k: np.asarray(v) for k, v in d.items()}, np.asarray(al),
            int(np.asarray(n).sum()))


def _port(fn, data, alive, periodic, **kw):
    td, ta = to_torch(data, alive, torch.float64, "cpu")
    d, a, n = fn(td, ta, periodic, **kw)
    return (*to_numpy(d, a), int(n))


def _plan(alive, periodic):
    return tuple(zip(alive.shape[1:], periodic, "xyz"))


MIG_CASES = [
    # (cap, nx, ny, nz, periodic, n_frac, photon)
    (4, 9, 6, 7, (True, True, True), 0.9, False),
    (6, 9, 5, 6, (False, True, False), 0.85, False),
    (4, 12, 5, 5, (False, False, False), 0.8, True),
    # the edges of kernel B6's 3D tiles (csrc/migrate.cu: 8 cells along
    # the axis by 32, 16 or 8 along z at up to 8, 16 or 32 slots a cell),
    # the shapes tests/test_torch_kernels3d.py holds the kernel on: x one
    # cell and z over one tile, not a multiple of it; x over two tiles, y
    # two cells, z a multiple of 4 (16-byte copies); z one cell; the
    # tile's limit of 32 slots; one slot above it
    (8, 1, 5, 37, (True, False, True), 0.9, False),
    (9, 19, 2, 40, (False, True, True), 0.9, True),
    (17, 10, 3, 1, (True, True, False), 0.9, False),
    (32, 5, 9, 12, (False, False, True), 1.0, True),
    (33, 4, 3, 5, (True, False, False), 1.0, False),
]


@pytest.mark.parametrize("cap,nx,ny,nz,periodic,n_frac,photon", MIG_CASES)
def test_fast_migrate_3d_matches_jax_batcher(cap, nx, ny, nz, periodic,
                                             n_frac, photon):
    data, alive, _ = crowded_cell_state(cap, nx, ny, nz, n_frac=n_frac,
                                        seed=cap + nx)
    data = add_qed_payloads(data, seed=cap)
    if photon:
        u2 = data["ux"]**2 + data["uy"]**2 + data["uz"]**2
        data["inv_gamma"] = np.where(u2 > 0, 1 / np.sqrt(np.maximum(
            u2, 1e-30)), 1.0)
    ref, ref_alive, ref_lost = jax_migrate_3d(data, alive, periodic,
                                              recompute_ig=not photon,
                                              sort_fn=batcher_sort_jnp)
    assert ref_lost > 0
    keys = KEYS + ("tau", "delta", "event")
    for fn in (t_cell2d.migrate_cells, t_cp.migrate_cells_fused):
        before = t_cp.migrate_axis.launches
        got, got_alive, lost = _port(
            lambda d, a, per, **kw: fn(d, a, _plan(a, per), **kw), data,
            alive, periodic, recompute_ig=not photon)
        assert t_cp.migrate_axis.launches == before
        compare_slots(ref, ref_alive, got, got_alive, rtol=1e-11, keys=keys)
        assert lost == ref_lost
    # migrate_cell_3d's sort_fn: the fast scheme sorting through
    # sort_cells' plain route (kernel B7 on the card), on 3D slots
    before = t_cp.sort_cells.launches
    got, got_alive, lost = _port(t_cell3d.migrate_cell_3d, data, alive,
                                 periodic, recompute_ig=not photon,
                                 sort_fn=t_cp.sort_cells)
    assert t_cp.sort_cells.launches == before
    compare_slots(ref, ref_alive, got, got_alive, rtol=1e-11, keys=keys)
    assert lost == ref_lost
    # particles crossed cells along every axis of more than one cell
    for axis in range(3):
        if alive.shape[1 + axis] == 1:
            continue
        idx = np.broadcast_to(np.arange(alive.shape[1 + axis]).reshape(
            [-1 if i == 1 + axis else 1 for i in range(4)]), alive.shape)
        before = dict(zip(data["id_lo"][alive].tolist(), idx[alive].tolist()))
        after = dict(zip(got["id_lo"][got_alive].tolist(),
                         idx[got_alive].tolist()))
        assert sum(before[i] != c for i, c in after.items()) > 0, axis


EXACT_CASES = [
    # (cap, nx, ny, nz, periodic, n_frac, overflow)
    (8, 9, 6, 5, (True, True, True), 0.06, False),
    (4, 9, 5, 6, (True, True, True), 1.0, True),
    (4, 12, 6, 5, (False, True, False), 0.9, True),
]


@pytest.mark.parametrize("cap,nx,ny,nz,periodic,n_frac,overflow",
                         EXACT_CASES)
def test_exact_migrate_3d_matches_jax(cap, nx, ny, nz, periodic, n_frac,
                                      overflow):
    data, alive, _ = crowded_cell_state(cap, nx, ny, nz, seed=cap + nx,
                                        n_frac=n_frac)
    ref, ref_alive, ref_lost = jax_migrate_3d(data, alive, periodic,
                                              recompute_ig=True, exact=True)
    got, got_alive, lost = _port(t_cell3d.migrate_cell_3d, data, alive,
                                 periodic, exact=True)
    # slot for slot in place: both keep the stable order
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
    elif all(periodic):
        # rows cap..2cap-1 merge (weight kept), rows >= 2cap drop (lost)
        assert lost > 0 and n1 + lost == n0 and w1 < w0
    else:
        assert lost > 0
