"""Shifted-neighbour access for the Yee stencils (counterpart of
lambdapic_tpu/ops/shifts.py): out-of-range reads wrap when periodic,
else read zero, unless the caller hands in the rows past the edge (a
neighbour shard's, ``edge``)."""
from __future__ import annotations

import torch


def shift(f: torch.Tensor, axis: int, by: int, periodic: bool,
          edge: torch.Tensor = None) -> torch.Tensor:
    """``g[..., i, ...] = f[..., i+by, ...]`` along ``axis``; ``edge``
    holds the |by| rows past the end that ``by`` reaches (a neighbour
    shard's rows, or zeros past an open face)."""
    if by == 0:
        return f
    n = f.shape[axis]
    if edge is not None:
        if by > 0:
            return torch.cat([f.narrow(axis, by, n - by), edge], dim=axis)
        return torch.cat([edge, f.narrow(axis, 0, n + by)], dim=axis)
    if periodic:
        return torch.roll(f, -by, dims=axis)
    zshape = list(f.shape)
    zshape[axis] = abs(by)
    z = torch.zeros(zshape, dtype=f.dtype, device=f.device)
    if by > 0:
        return torch.cat([f.narrow(axis, by, n - by), z], dim=axis)
    return torch.cat([z, f.narrow(axis, 0, n + by)], dim=axis)


def diff_lo(f: torch.Tensor, axis: int, periodic: bool,
            edge: torch.Tensor = None) -> torch.Tensor:
    """f[i] - f[i-1] along axis (backward difference)."""
    return f - shift(f, axis, -1, periodic, edge)


def diff_hi(f: torch.Tensor, axis: int, periodic: bool,
            edge: torch.Tensor = None) -> torch.Tensor:
    """f[i+1] - f[i] along axis (forward difference)."""
    return shift(f, axis, +1, periodic, edge) - f
