"""Counter-based random numbers, bit for bit those of ``jax.random``
(jax 0.9.0 defaults: the ``threefry2x32`` generator with
``jax_threefry_partitionable=True``).

A key is an explicit ``(2,)`` int64 tensor holding two uint32 words; there
is no global state. The hash works on int64 tensors and keeps each word
in [0, 2**32) by masking, so the same code gives the same bits on the CPU
and on a CUDA device. A key that lies on the CPU is read as two Python
integers: folding and splitting it then run on the host without a device
launch, and ``uniform`` draws on whatever ``device`` it is asked for.
Provided: ``PRNGKey``, ``fold_in``, ``split`` and ``uniform`` (float32
and float64, on [0, 1)).

The QED step draws with these (``models/qed.py::_update_tau``), so a run
of the port and one of the JAX package from the same seed make the same
draws in the same slots.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u32(v: int) -> int:
    return int(v) & MASK


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the count words (x1, x2)
    under the key words (k1, k2): jax's ``_threefry2x32_lowering``. Each
    argument is a Python int or an int64 tensor (of one shape, or 0-d),
    every word in [0, 2**32)."""
    ks = [k1, k2, k1 ^ k2 ^ _PARITY]
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed: its 64-bit two's complement split into
    (high, low) words, as ``jax.random.PRNGKey`` with 64-bit integers
    enabled (non-negative seeds below 2**31 give the same key either
    way)."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & MASK], dtype=torch.int64,
                        device=device)


def _words(key: torch.Tensor):
    """The key's two words: Python ints for a key on the CPU, 0-d tensors
    otherwise (reading those would wait for the device)."""
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(f"a key is a (2,) int64 tensor, got {key.dtype} "
                         f"{tuple(key.shape)}")
    if key.device.type == "cpu":
        return tuple(int(v) for v in key.tolist())
    return key[0], key[1]


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]
            ) -> torch.Tensor:
    """A new key from ``key`` and a 32-bit integer (``jax.random.fold_in``:
    the hash of the count pair (0, data)), on the key's device."""
    k1, k2 = _words(key)
    if isinstance(data, torch.Tensor):
        d = data.to(key.device) & MASK
    else:
        d = _u32(data)
    if isinstance(k1, int) and isinstance(d, int):
        return torch.tensor(threefry2x32(k1, k2, 0, d), dtype=torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    a, b = threefry2x32(k1, k2, zero, zero + d)
    return torch.stack([a, b])


def _counts(shape: Sequence[int], device, index=None):
    """The flat row-major index of every element of ``shape`` (or the
    flat positions ``index`` only) as a uint64, split into (high, low)
    uint32 words (jax's ``iota_2x32_shape``)."""
    n = math.prod(shape)
    if n > (1 << 62):
        raise ValueError(f"shape {tuple(shape)} too large")
    if index is None:
        iota = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    else:
        iota = index.to(device=device, dtype=torch.int64)
    return iota >> 32, iota & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys, shape (num, 2) (``jax.random.split``), on the
    key's device."""
    k1, k2 = _words(key)
    if isinstance(k1, int):
        return torch.tensor([threefry2x32(k1, k2, i >> 32, i & MASK)
                             for i in range(num)], dtype=torch.int64
                            ).reshape(num, 2)
    hi, lo = _counts((num,), key.device)
    a, b = threefry2x32(k1, k2, hi, lo)
    return torch.stack([a, b], dim=1)


def uniform(key: torch.Tensor, shape: Sequence[int],
            dtype=torch.float32, device=None,
            index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform floats on [0, 1) (``jax.random.uniform`` with its default
    bounds) on ``device`` (default: the key's): the mantissa bits of a
    draw under the exponent of 1.0, minus 1.0. With ``index`` (int64 flat
    positions in ``shape``) only the draws at those positions are made,
    as a 1D tensor: ``uniform(key, shape)`` flattened, at ``index`` (the
    generator is counter-based, so a draw costs nothing elsewhere)."""
    shape = tuple(shape)
    k1, k2 = _words(key)
    hi, lo = _counts(shape, device or key.device, index)
    a, b = threefry2x32(k1, k2, hi, lo)
    if dtype == torch.float32:
        bits = ((a ^ b) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        # the top 52 of the 64 bits (a << 32 | b): a's 32 and b's top 20
        bits = (a << 20) | (b >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise ValueError(f"uniform: dtype {dtype} (float32 or float64)")
