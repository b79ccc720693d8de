"""Shifted-neighbour access for the Yee stencils (counterpart of
lambdapic_tpu/ops/shifts.py): out-of-range reads wrap when periodic,
else read zero."""
from __future__ import annotations

import torch


def shift(f: torch.Tensor, axis: int, by: int, periodic: bool) -> torch.Tensor:
    """``g[..., i, ...] = f[..., i+by, ...]`` along ``axis``."""
    if by == 0:
        return f
    if periodic:
        return torch.roll(f, -by, dims=axis)
    n = f.shape[axis]
    zshape = list(f.shape)
    zshape[axis] = abs(by)
    z = torch.zeros(zshape, dtype=f.dtype, device=f.device)
    if by > 0:
        return torch.cat([f.narrow(axis, by, n - by), z], dim=axis)
    return torch.cat([z, f.narrow(axis, 0, n + by)], dim=axis)


def diff_lo(f: torch.Tensor, axis: int, periodic: bool) -> torch.Tensor:
    """f[i] - f[i-1] along axis (backward difference)."""
    return f - shift(f, axis, -1, periodic)


def diff_hi(f: torch.Tensor, axis: int, periodic: bool) -> torch.Tensor:
    """f[i+1] - f[i] along axis (forward difference)."""
    return shift(f, axis, +1, periodic) - f
