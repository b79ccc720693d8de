"""Guard cells on one device (counterpart of lambdapic_tpu/parallel/halo.py
for a 1 x 1 mesh): ``halo_pad`` fills g guard cells per side from the
periodic wrap or with zeros at open faces; ``halo_reduce`` folds the
guard rims of a padded array back onto the interior (periodic wrap) or
drops them (open faces). Axes go in order for the pad and in reverse
order for the reduce, so corners travel through both."""
from __future__ import annotations

from typing import Sequence

import torch


def halo_pad(f: torch.Tensor, g: int, spatial_axes: Sequence[int],
             periodic: Sequence[bool]) -> torch.Tensor:
    for axis, per in zip(spatial_axes, periodic):
        n = f.shape[axis]
        if per:
            lo = f.narrow(axis, n - g, g)
            hi = f.narrow(axis, 0, g)
        else:
            zshape = list(f.shape)
            zshape[axis] = g
            lo = hi = torch.zeros(zshape, dtype=f.dtype, device=f.device)
        f = torch.cat([lo, f, hi], dim=axis)
    return f


def halo_reduce(f: torch.Tensor, g: int, spatial_axes: Sequence[int],
                periodic: Sequence[bool]) -> torch.Tensor:
    for axis, per in reversed(list(zip(spatial_axes, periodic))):
        n_pad = f.shape[axis]
        n = n_pad - 2 * g
        core = f.narrow(axis, g, n)
        if per:
            zshape = list(core.shape)
            zshape[axis] = n - g
            z = torch.zeros(zshape, dtype=f.dtype, device=f.device)
            # my high rim wraps onto my first rows, my low rim onto my last
            add_lo = torch.cat([f.narrow(axis, n_pad - g, g), z], dim=axis)
            add_hi = torch.cat([z, f.narrow(axis, 0, g)], dim=axis)
            core = core + add_lo + add_hi
        f = core
    return f
