"""lambdapic_torch.random against jax.random, bit for bit: keys from
seeds, fold_in, split and uniform draws in float32 and float64, and the
key chain of one QED step (seed -> step -> species -> device 0 -> 101 ->
three keys -> draws over the (cap, nx, ny) slots)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lambdapic_torch import random as jr

SEEDS = [0, 1, 3, 12345, 2**31 + 5, 2**40 + 7]


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split(seed):
    jk, tk = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    for data in (0, 7, 101, 2**32 - 1):
        np.testing.assert_array_equal(jr.fold_in(tk, data).numpy(),
                                      _np(jax.random.fold_in(jk, data)))
    # a data word given as a tensor takes the tensor path of the hash
    np.testing.assert_array_equal(
        jr.fold_in(tk, torch.tensor(77)).numpy(),
        _np(jax.random.fold_in(jk, 77)))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(jr.split(tk, num).numpy(),
                                      _np(jax.random.split(jk, num)))


@pytest.mark.parametrize("shape", [(7,), (4, 5, 3), (20, 16, 12)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform(shape, dtype):
    for seed in SEEDS[:4]:
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 9)
        tk = jr.fold_in(jr.PRNGKey(seed), 9)
        ref = np.asarray(jax.random.uniform(jk, shape, dtype=jnp.dtype(dtype)))
        got = jr.uniform(tk, shape, getattr(torch, dtype)).numpy()
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        assert got.min() >= 0 and got.max() < 1
        # draws at some flat positions only: the same values
        idx = torch.tensor(np.random.default_rng(seed).choice(
            ref.size, min(ref.size, 9), replace=False))
        np.testing.assert_array_equal(
            jr.uniform(tk, shape, getattr(torch, dtype), index=idx).numpy(),
            ref.reshape(-1)[idx.numpy()])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_one_qed_step_key_chain(dtype):
    """The draws of models/qed.py::_update_tau for species 2 at step 17 of
    a run seeded 1234, over (cap, nx, ny) = (12, 9, 10)."""
    shape = (12, 9, 10)
    jk = jax.random.PRNGKey(1234)
    for d in (17, 2, 0):
        jk = jax.random.fold_in(jk, d)
    jkeys = jax.random.split(jax.random.fold_in(jk, 101), 3)
    from lambdapic_torch.models.qed import species_key
    tkeys = jr.split(jr.fold_in(species_key(jr.PRNGKey(1234), 17, 2), 101), 3)
    np.testing.assert_array_equal(tkeys.numpy(), _np(jkeys))
    for j, t in zip(jkeys, tkeys):
        np.testing.assert_array_equal(
            jr.uniform(t, shape, getattr(torch, dtype)).numpy(),
            np.asarray(jax.random.uniform(j, shape, dtype=jnp.dtype(dtype))))


def test_bad_key_is_refused():
    with pytest.raises(ValueError):
        jr.fold_in(torch.zeros(3, dtype=torch.int64), 1)
    with pytest.raises(ValueError):
        jr.uniform(jr.PRNGKey(0), (3,), torch.float16)
