"""The port's tiled 2D operations (lambdapic_torch/ops/tiled2d.py and
simulation/initfill.py::bin_tiled) against the JAX package's, float64 on
the CPU, on the same seeded inputs.

Tolerances: the window cuts are copies and are equal; gather_tiled and
deposit_tiled (and kernel B9's plain version, which takes the alive mask
and is given w = 7 in the dead slots) rtol 1e-12 with a floor of 1e-14
of each output's peak (the dense contractions sum in another order); fold_windows, bin_tiled,
migrate_tiled and insert_tiled are equal, slot for slot, dead slots
included, with n_lost equal: both sides sort stably (JAX's lax.sort is
stable on the CPU), so the slot order is the same. The one exception is
inv_gamma recomputed from u by migrate_tiled(recompute_ig=True), where
XLA's 1/sqrt rounds differently in the last bit (rtol 4e-16).

The JAX migrate_tiled runs on a one-device plan: in the overflow case
inside a 1 x 1 shard_map, as tests/core/test_tiled2d.py runs it, in the
others under a 1 x 1 vmap naming the same mesh axes (the shard_map
compiles for about 30 s a case on the CPU, the vmap in about 5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdapic_tpu.ops import tiled2d as jt
from lambdapic_tpu.parallel.halo import HaloSpec
from lambdapic_tpu.simulation import initfill as jinit
from lambdapic_torch.core.grid import Grid
from lambdapic_torch.ops import tiled2d as tt
from lambdapic_torch.ops import tiled2d_kernels as tk
from lambdapic_torch.simulation import initfill as tinit
from lambdapic_torch.testing import (tiled_fill_state, tiled_state,
                                     to_numpy, to_torch)
from lambdapic_torch.testing import torch_threads

# (tx, ty, ntx, nty, h, cap_t): the two tile shapes, halos 3 and 5
CASES = [(8, 8, 4, 3, 3, 128), (16, 8, 3, 4, 5, 256)]
Q, DX, DY = -1.602e-19, 5e-8, 4e-8
DT = 0.95 / np.sqrt(DX**-2 + DY**-2) / 2.99792458e8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: beside the other test processes a full pool
    waits on their threads (lambdapic_torch.testing.torch_threads)."""
    with torch_threads(1):
        yield


def _cfgs(case):
    tx, ty, ntx, nty, h, cap = case
    return (jt.TileCfg(tx=tx, ty=ty, ntx=ntx, nty=nty, cap_t=cap, h=h),
            tt.TileCfg(tx=tx, ty=ty, ntx=ntx, nty=nty, cap_t=cap, h=h))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, rtol=1e-12, floor=1e-14, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=floor * np.abs(ref).max(), err_msg=msg)


@pytest.mark.parametrize("case", CASES)
def test_windows_match_jax(case):
    jc, tc = _cfgs(case)
    rng = np.random.default_rng(0)
    nxp, nyp = jc.ntx * jc.tx + 2 * jc.h, jc.nty * jc.ty + 2 * jc.h
    f = rng.normal(size=(3, nxp, nyp))
    got = tt.extract_windows(_t(f), tc).numpy()
    np.testing.assert_array_equal(got, np.asarray(jt.extract_windows(
        jnp.asarray(f), jc)))
    if tc.ty >= 2 * tc.h:
        blocks = rng.normal(size=(4, jc.ntx, jc.nty, jc.wx, jc.wy))
        np.testing.assert_array_equal(
            tt.fold_windows(_t(blocks), tc).numpy(),
            np.asarray(jt.fold_windows(jnp.asarray(blocks), jc)))
    else:
        with pytest.raises(ValueError, match="2\\*halo"):
            tt.fold_windows(torch.zeros(4, tc.ntx, tc.nty, tc.wx, tc.wy), tc)


@pytest.mark.parametrize("case", CASES)
def test_gather_and_deposit_match_jax(case):
    jc, tc = _cfgs(case)
    d, alive, eb_pad = tiled_state(tc, seed=1, drift=tc.h - 2)
    windows = np.asarray(jt.extract_windows(jnp.asarray(eb_pad), jc))
    ref = jt.gather_tiled(jnp.asarray(windows), jnp.asarray(d["x"]),
                          jnp.asarray(d["y"]), jc)
    got = tt.gather_tiled(_t(windows), _t(d["x"]), _t(d["y"]), tc)
    for k, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, msg=f"component {k}")
    # dead slots gather exactly 0 (they sit at x = y = 0, outside every
    # window but that of tile (0, 0))
    dead = ~alive
    dead[0, 0] = False
    assert all(float(g.numpy()[dead].__abs__().max()) == 0 for g in got)

    args = [d[k] for k in ("x", "y", "ux", "uy", "uz", "inv_gamma", "w")]
    kw = dict(q=Q, dx=DX, dy=DY, dt=DT)
    ref = np.asarray(jt.deposit_tiled(*map(jnp.asarray, args), jc, **kw))
    got = tt.deposit_tiled(*map(_t, args), tc, **kw).numpy()
    for k, name in enumerate(("jx", "jy", "jz", "rho")):
        _close(got[k], ref[k], msg=name)
    assert np.abs(ref[3]).max() > 0
    # kernel B9's entry point on CPU tensors (its plain version) takes the
    # alive mask and keeps a dead slot's w out of the sums
    margs = list(map(_t, args))
    margs[6] = torch.where(_t(alive), margs[6], 7.0)
    got = tk.deposit_tiled_k(*margs, _t(alive), tc, **kw).numpy()
    for k, name in enumerate(("jx", "jy", "jz", "rho")):
        _close(got[k], ref[k], msg=f"masked {name}")


def _jax_migrate(d, alive, jc, periodic, nx, ny, shard_map=False, **kw):
    """The JAX migrate_tiled on a one-device plan: inside a 1 x 1
    shard_map, or (quicker to compile) under a 1 x 1 vmap that names the
    same mesh axes for its ppermute and axis_index."""
    from jax.sharding import Mesh, PartitionSpec as P
    specs = (HaloSpec("px", 1, periodic[0]), HaloSpec("py", 1, periodic[1]))
    jd = {k: jnp.asarray(v)[None, None] for k, v in d.items()}

    def local(dd, a):
        return jt.migrate_tiled(dd, a, jc, specs, nx, ny, **kw)

    if shard_map:
        try:
            from jax import shard_map as smap
        except ImportError:
            from jax.experimental.shard_map import shard_map as smap
        mesh = Mesh(np.asarray(jax.devices()[:1], dtype=object).reshape(1, 1),
                    ("px", "py"))

        def local_sm(dd, a):
            dd = {k: v.reshape(v.shape[2:]) for k, v in dd.items()}
            dd, a, lost = local(dd, a.reshape(a.shape[2:]))
            return ({k: v[None, None] for k, v in dd.items()}, a[None, None],
                    lost.reshape(1, 1))

        dspec = {k: P("px", "py") for k in jd}
        fn = smap(local_sm, mesh=mesh, in_specs=(dspec, P("px", "py")),
                  out_specs=(dspec, P("px", "py"), P("px", "py")),
                  check_vma=False)
    else:
        fn = jax.vmap(jax.vmap(local, axis_name="py"), axis_name="px")
    d2, a2, lost = fn(jd, jnp.asarray(alive)[None, None])
    return ({k: np.asarray(v)[0, 0] for k, v in d2.items()},
            np.asarray(a2)[0, 0], int(np.asarray(lost).ravel()[0]))


# (case, periodic x/y, crowd a tile so that donors overflow their slab,
# inv_gamma recomputed, QED payloads and gathered-field slots carried)
MIGRATE = [(CASES[0], (True, True), False, False, True),
           (CASES[1], (False, False), False, True, False),
           (CASES[0], (False, True), True, True, False)]


@pytest.mark.parametrize("case,periodic,crowd,recompute,qed", MIGRATE)
def test_migrate_tiled_matches_jax(case, periodic, crowd, recompute, qed):
    jc, tc = _cfgs(case)
    d, alive, _ = tiled_state(tc, seed=2, drift=1.0, qed=qed)
    if crowd:
        # fill tile (1, 1) and send most of it up in x: more donors than
        # the m-slab holds
        alive[1, 1] = True
        n = alive.shape[-1]
        d["x"][1, 1] = tc.tx + np.linspace(tc.tx - 0.4, tc.tx + 0.4, n)
        d["w"][1, 1] = 1.0
    nx, ny = tc.ntx * tc.tx, tc.nty * tc.ty
    ref, ra, rlost = _jax_migrate(d, alive, jc, periodic, nx, ny,
                                  shard_map=crowd, recompute_ig=recompute)
    td, ta = to_torch(d, alive, torch.float64, "cpu")
    got, ga, glost = tt.migrate_tiled(td, ta, tc, periodic, nx, ny,
                                      recompute_ig=recompute)
    got, ga = to_numpy(got, ga)
    assert glost == rlost
    np.testing.assert_array_equal(ga, ra)
    for k in ref:
        if recompute and k == "inv_gamma":
            # recomputed from u on both sides: XLA's 1/sqrt rounds
            # differently from torch's in the last bit
            np.testing.assert_allclose(got[k], ref[k], rtol=4e-16)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (rlost > 0) == crowd
    # particles changed tile
    tile = np.broadcast_to(np.arange(tc.ntx * tc.nty).reshape(
        tc.ntx, tc.nty, 1), alive.shape)
    before = dict(zip(d["id_lo"][alive].tolist(), tile[alive].tolist()))
    after = dict(zip(ref["id_lo"][ra].tolist(), tile[ra].tolist()))
    assert sum(before[i] != t for i, t in after.items()) > 0


@pytest.mark.parametrize("case", CASES)
def test_insert_tiled_matches_jax(case):
    jc, tc = _cfgs(case)
    child, calive, _ = tiled_state(tc, seed=3, drift=0.0)
    parent, palive, _ = tiled_state(tc, seed=4, drift=0.0, n_frac=0.6)
    rng = np.random.default_rng(5)
    valid = palive & (rng.uniform(0, 1, palive.shape) < 0.5)
    # tile (0, 1) has no room: its newborns overflow
    calive[0, 1] = True
    new = {k: parent[k] * 0.5 for k in ("x", "y", "w", "ux", "uy", "uz")}
    new["inv_gamma"] = np.full(valid.shape, 0.25)
    next_id = 1000
    ref = jt.insert_tiled({k: jnp.asarray(v) for k, v in child.items()},
                          jnp.asarray(calive), jnp.uint32(next_id),
                          {k: jnp.asarray(v) for k, v in new.items()},
                          jnp.asarray(valid), device_id=jnp.int32(0))
    td, ta = to_torch(child, calive, torch.float64, "cpu")
    got = tt.insert_tiled(td, ta, torch.tensor(next_id),
                          {k: _t(v) for k, v in new.items()}, _t(valid))
    gd, ga = to_numpy(got[0], got[1])
    np.testing.assert_array_equal(ga, np.asarray(ref[1]))
    for k in ref[0]:
        np.testing.assert_array_equal(gd[k], np.asarray(ref[0][k]),
                                      err_msg=k)
    assert int(got[2]) == int(ref[2])
    assert int(got[3]) == int(ref[3]) > 0


def test_bin_tiled_matches_jax():
    grid = Grid(dimension=2, nx=48, ny=32, dx=1.0, dy=1.0, npatch_x=1,
                npatch_y=1, n_guard=3, cpml_thickness=6,
                boundary_conditions=tuple((n, "pml") for n in
                                          ("xmin", "xmax", "ymin", "ymax")))
    rng = np.random.default_rng(6)
    n, cap = 900, 1024
    arrays = {k: np.zeros((1, 1, cap)) for k in
              ("x", "y", "w", "ux", "uy", "uz", "inv_gamma")}
    arrays["x"][0, 0, :n] = rng.uniform(-0.5, 47.5, n)
    arrays["y"][0, 0, :n] = rng.uniform(-0.5, 31.5, n)
    arrays["w"][0, 0, :n] = rng.uniform(0.5, 1.5, n)
    arrays["inv_gamma"][...] = 1.0
    counts = np.full((1, 1), n)
    for tile, cap_t in (((16, 8), None), ((8, 16), 256)):
        got = tinit.bin_tiled({k: v.copy() for k, v in arrays.items()},
                              counts, grid, *tile, factor=1.6, cap_t=cap_t)
        ref = jinit.bin_tiled({k: v.copy() for k, v in arrays.items()},
                              counts, grid, *tile, factor=1.6, cap_t=cap_t)
        assert got[2] == ref[2]
        np.testing.assert_array_equal(got[1], ref[1])
        for k in ref[0]:
            np.testing.assert_array_equal(got[0][k], ref[0][k], err_msg=k)


def test_fill_state_is_bin_tiled_layout():
    """testing.tiled_fill_state (the tiled kernels' ``fill`` state) lays
    its particles out as the port's and the JAX package's bin_tiled leave
    the fill: the same particles in the fill's flat order (cell by cell,
    y fastest) binned by both give its slots, masks and cap_t."""
    cfg = tt.TileCfg(tx=8, ty=8, ntx=3, nty=2, cap_t=768, h=3)
    d, alive, _ = tiled_fill_state(cfg, seed=7, per_cell=4, first_tile=1)
    grid = Grid(dimension=2, nx=24, ny=16, dx=1.0, dy=1.0, npatch_x=1,
                npatch_y=1, n_guard=3, cpml_thickness=6,
                boundary_conditions=tuple((n, "pml") for n in
                                          ("xmin", "xmax", "ymin", "ymax")))
    names = ("x", "y", "w", "ux", "uy", "uz", "inv_gamma")
    cell = (np.floor(d["x"] + 0.5) * 16 + np.floor(d["y"] + 0.5))[alive]
    order = np.argsort(cell, kind="stable")
    n = int(alive.sum())
    arrays = {k: np.zeros((1, 1, 1024)) for k in names}
    arrays["inv_gamma"][...] = 1.0
    for k in names:
        arrays[k][0, 0, :n] = d[k][alive][order]
    counts = np.full((1, 1), n)
    for binner in (tinit.bin_tiled, jinit.bin_tiled):
        out, out_alive, cap_t = binner(
            {k: v.copy() for k, v in arrays.items()}, counts, grid, 8, 8,
            cap_t=cfg.cap_t)
        assert cap_t == cfg.cap_t
        np.testing.assert_array_equal(out_alive[0, 0], alive)
        for k in names:
            np.testing.assert_array_equal(out[k][0, 0], d[k], err_msg=k)
