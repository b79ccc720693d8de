"""The port's nonlinear Compton QED (models/qed.py, ops/cell2d.py::
insert_cells) against the JAX package's functions, float64 on the CPU.

Tolerances: rtol 1e-12 for chi, the rate, the delta samplers and tau
(the two packages' log1p, log10, pow and arcsin may round the last bit
differently); the event flags, the slots, ids and counts of the
insertion exactly. The Chebyshev fits are the same numpy code, so their
coefficients are equal.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lambdapic_tpu.models import qed as jq
from lambdapic_torch import random as jr
from lambdapic_torch.core.state import ids_to_numpy, ids_to_torch
from lambdapic_torch.models import qed as tq
from lambdapic_torch.ops.cell2d import insert_cells
from lambdapic_torch.testing import torch_threads

RTOL = 1e-12


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: beside the other test processes a full pool
    waits on their threads (lambdapic_torch.testing.torch_threads)."""
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def tables():
    return jq._make_tables("photon", jnp.float64), \
        tq._make_tables("photon", torch.float64)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, ref, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=1e-300)


def test_chi_and_fits(tables):
    jt, tt = tables
    assert tq.CHI_FACTOR == jq.CHI_FACTOR
    np.testing.assert_array_equal(tt.rate_coef, np.asarray(jt.rate_coef))
    np.testing.assert_array_equal(tt.inv_coef, np.asarray(jt.inv_coef))
    assert (tt.rate_c0, tt.inv_c0, tt.log_chi_min, tt.log_chi_max) == \
        (jt.rate_c0, jt.inv_c0, jt.log_chi_min, jt.log_chi_max)
    rng = np.random.default_rng(0)
    f = [rng.normal(0, 1e13, 50) for _ in range(3)] + \
        [rng.normal(0, 1e5, 50) for _ in range(3)]
    u = [rng.normal(0, 500, 50) for _ in range(3)]
    ig = 1 / np.sqrt(1 + sum(a**2 for a in u))
    _close(tq.calculate_chi(*map(_t, f + u + [ig])),
           jq.calculate_chi(*map(jnp.asarray, f + u + [ig])))


def test_rate_and_samplers(tables):
    jt, tt = tables
    rng = np.random.default_rng(1)
    chi = 10**rng.uniform(-4.5, 1.8, (8, 6, 5))
    chi[0, 0, :2] = (0.0, 1e-40)            # below the table
    r = rng.uniform(0, 1, chi.shape)
    for tf, jf in ((tq._total_rate, jq._total_rate),
                   (tq._total_rate_table, jq._total_rate_table)):
        _close(tf(_t(chi), tt), jf(jnp.asarray(chi), jt))
    for tf, jf in ((tq._sample_delta, jq._sample_delta),
                   (tq._sample_delta_table, jq._sample_delta_table)):
        _close(tf(_t(chi), _t(r), tt), jf(jnp.asarray(chi), jnp.asarray(r),
                                          jt))


@pytest.mark.parametrize("most", [2, 5])
def test_sparse_sampler(tables, most):
    """Event counts per cell at most the JAX sampler's K (its compacted
    evaluation) and above K (its dense fallback), K = cap // 4 = 2 at
    cap 8: the port's sampler (the event slots packed into one row)
    against the JAX sparse sampler, and against where(event, dense, 0) on
    both sides."""
    jt, tt = tables
    cap = 8
    rng = np.random.default_rng(most)
    chi = 10**rng.uniform(-3, 1.5, (cap, 7, 6))
    r = rng.uniform(0, 1, chi.shape)
    ev = np.zeros(chi.shape, bool)
    for c in np.ndindex(chi.shape[1:]):
        k = rng.integers(0, 3)
        ev[(rng.choice(cap, k, replace=False),) + c] = True
    ev[:, 3, 3] = False
    ev[(rng.choice(cap, most, replace=False), 3, 3)] = True
    assert (ev.sum(0).max() > 2) == (most > 2)
    got = tq._sample_delta_sparse(_t(chi), _t(r), _t(ev), tt)
    ref = jq._sample_delta_sparse(jnp.asarray(chi), jnp.asarray(r),
                                  jnp.asarray(ev), jt)
    _close(got, ref)
    dense_t = torch.where(_t(ev), tq._sample_delta(_t(chi), _t(r), tt), 0.0)
    dense_j = jnp.where(jnp.asarray(ev),
                        jq._sample_delta(jnp.asarray(chi), jnp.asarray(r),
                                         jt), 0.0)
    _close(got, dense_t)
    _close(ref, dense_j)
    assert (got.numpy()[~ev] == 0).all() and (got.numpy()[ev] > 0).all()


def test_update_tau(tables):
    jt, tt = tables
    rng = np.random.default_rng(3)
    shape = (10, 8, 7)
    chi = 10**rng.uniform(-4, 1, shape)
    tau = np.where(rng.uniform(0, 1, shape) < 0.5, 0.0,
                   rng.uniform(0.01, 0.5, shape))
    tau[0, 0, 0] = np.nan
    ig = 1 / rng.uniform(10, 3e3, shape)
    alive = rng.uniform(0, 1, shape) < 0.8
    jkeys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(5), 101), 3)
    tkeys = jr.split(jr.fold_in(jr.PRNGKey(5), 101), 3)
    ref = jq._update_tau(jnp.asarray(tau), jnp.asarray(ig), jnp.asarray(chi),
                         jnp.asarray(alive), 3e-15, jkeys, jt, True)
    got = tq._update_tau(_t(tau), _t(ig), _t(chi), _t(alive), 3e-15, tkeys,
                         tt, True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert 0 < int(got[1].sum()) < int(alive.sum())
    _close(got[0], ref[0])
    _close(got[2], ref[2])


def _jax_compton():
    return jq.NonlinearComptonLCFA(0, 1, 0, jnp.float64)


def test_newborns_and_recoil():
    rng = np.random.default_rng(4)
    shape = (6, 5, 4)
    ed = {k: rng.normal(0, 100, shape) for k in
          ("x", "y", "w", "ux", "uy", "uz", "inv_gamma", "event")}
    ed["delta"] = np.where(rng.uniform(0, 1, shape) < 0.4,
                           rng.uniform(0, 1, shape), 0.0)
    ev = ed["delta"] > 0
    jp, tp = _jax_compton(), tq.NonlinearComptonLCFA(0, 1, torch.float64)
    ref = jp.photon_newborns({k: jnp.asarray(v) for k, v in ed.items()}, 2)
    got = tp.photon_newborns({k: _t(v) for k, v in ed.items()}, 2)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k], rtol=1e-15)
    ref = jp.apply_recoil({k: jnp.asarray(v) for k, v in ed.items()},
                          jnp.asarray(ev))
    got = tp.apply_recoil({k: _t(v) for k, v in ed.items()}, _t(ev))
    for k in ref:
        _close(got[k], ref[k], rtol=1e-15)
    assert (got["event"].numpy() == 0).all()


@pytest.mark.parametrize("next_id", [0, 1000, 2**32 - 5])
def test_insert_cells(next_id):
    """Slot for slot with ids, dropped counts and next_id, including a
    full cell and a cell with more newborns than free slots."""
    from lambdapic_tpu.ops import cell2d as jc
    rng = np.random.default_rng(next_id % 97)
    cap_c, cap_s, nx, ny = 4, 6, 5, 7
    alive = rng.uniform(0, 1, (cap_c, nx, ny)) < 0.5
    alive[:, 0, 0] = True
    shape = alive.shape
    data = {k: rng.normal(size=shape) for k in
            ("x", "y", "z", "w", "ux", "uy", "uz", "inv_gamma", "ex_part")}
    data["id_lo"] = rng.integers(0, 2**32, shape, dtype=np.uint64
                                 ).astype(np.uint32)
    data["id_hi"] = np.zeros(shape, np.uint32)
    valid = rng.uniform(0, 1, (cap_s, nx, ny)) < 0.5
    valid[:, 1, 1] = True
    valid[:, 0, 0] = True
    new = {k: rng.normal(size=valid.shape) for k in
           ("x", "y", "w", "ux", "uy", "uz", "inv_gamma")}
    ref = jc.insert_cells({k: jnp.asarray(v) for k, v in data.items()},
                          jnp.asarray(alive), jnp.asarray(next_id, jnp.uint32),
                          {k: jnp.asarray(v) for k, v in new.items()},
                          jnp.asarray(valid), device_id=jnp.int32(0))
    td = {k: (ids_to_torch(v, "cpu") if k.startswith("id") else _t(v))
          for k, v in data.items()}
    got = insert_cells(td, _t(alive), torch.tensor(next_id),
                       {k: _t(v) for k, v in new.items()}, _t(valid))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(got[2]) == int(ref[2]) and int(got[3]) == int(ref[3]) > 0
    for k in data:
        g = ids_to_numpy(got[0][k]) if k.startswith("id") else got[0][k]
        np.testing.assert_array_equal(np.asarray(g), np.asarray(ref[0][k]),
                                      err_msg=k)


def test_update_chi_and_events():
    """The event update from gathered fields stored on the particles (the
    JAX XLA path's form), against the JAX method with the same key."""
    rng = np.random.default_rng(6)
    shape = (8, 6, 5)
    d = {k: rng.normal(0, 3e13, shape) for k in ("ex_part", "ey_part",
                                                  "ez_part")}
    d.update({k: rng.normal(0, 1e5, shape) for k in ("bx_part", "by_part",
                                                      "bz_part")})
    d.update({k: rng.normal(0, 2e3, shape) for k in ("ux", "uy", "uz")})
    d["inv_gamma"] = 1 / np.sqrt(1 + d["ux"]**2 + d["uy"]**2 + d["uz"]**2)
    d["tau"] = np.where(rng.uniform(0, 1, shape) < 0.5, 0.0,
                        rng.uniform(0.01, 0.3, shape))
    d["delta"] = np.zeros(shape)
    d["event"] = np.zeros(shape)
    alive = rng.uniform(0, 1, shape) < 0.7
    ref, _ = _jax_compton().update_chi_and_events(
        {k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(alive),
        jax.random.PRNGKey(11), 1e-16)
    got, _ = tq.NonlinearComptonLCFA(0, 1, torch.float64).update_chi_and_events(
        {k: _t(v) for k, v in d.items()}, _t(alive), jr.PRNGKey(11), 1e-16)
    np.testing.assert_array_equal(got["event"].numpy(),
                                  np.asarray(ref["event"]))
    assert got["event"].sum() > 0
    for k in ("chi", "tau", "delta"):
        _close(got[k], ref[k])
