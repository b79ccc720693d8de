"""Guard cells (counterpart of lambdapic_tpu/parallel/halo.py).

``halo_pad`` fills g guard cells per side from the neighbours' interiors
(the periodic wrap, or zeros at open global faces); ``halo_reduce`` folds
the guard rims of a padded array onto the neighbours' interiors (or drops
them at open global faces). Axes go in order for the pad and in reverse
order for the reduce, so corners travel through two (three) exchanges.

Each function takes either one tensor and a periodic flag per axis (one
device: the neighbour is the shard itself) or a sharded array, a list of
per-shard tensors, with a ``HaloSpec`` per axis and the ``Mesh``; the
sharded form copies strips between shards with ``mesh.ppermute`` where
the JAX functions ppermute inside ``shard_map``. A 1 x 1 mesh gives the
one-device results.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from .mesh import Mesh, axis_index, ppermute


@dataclass(frozen=True)
class HaloSpec:
    """Static exchange description for one mesh axis."""

    axis_name: str       # 'px' | 'py' | 'pz'
    size: int            # number of shards along the axis
    periodic: bool       # global boundary condition on this axis


def halo_specs(grid) -> Tuple[HaloSpec, ...]:
    """One HaloSpec per spatial axis of ``grid``."""
    return tuple(HaloSpec(name, size, grid.periodic(ax))
                 for name, size, ax in zip(grid.axis_names, grid.mesh_shape,
                                           grid.axes))


def _zeros_like_strip(f: torch.Tensor, axis: int, g: int) -> torch.Tensor:
    zshape = list(f.shape)
    zshape[axis] = g
    return torch.zeros(zshape, dtype=f.dtype, device=f.device)


def exchange_strips(strips_lo: Sequence[torch.Tensor],
                    strips_hi: Sequence[torch.Tensor], spec: HaloSpec,
                    mesh: Mesh) -> Tuple[List[torch.Tensor],
                                         List[torch.Tensor]]:
    """Swap boundary strips with both neighbours along one mesh axis.
    Returns (lo_halo, hi_halo) per shard: lo_halo is the lower
    neighbour's high strip, hi_halo the upper neighbour's low strip;
    zeros past an open global face."""
    lo_halo = ppermute(strips_hi, mesh, spec.axis_name, +1)
    hi_halo = ppermute(strips_lo, mesh, spec.axis_name, -1)
    if not spec.periodic:
        for i in range(mesh.size):
            c = axis_index(mesh, i, spec.axis_name)
            if c == 0:
                lo_halo[i] = torch.zeros_like(lo_halo[i])
            if c == spec.size - 1:
                hi_halo[i] = torch.zeros_like(hi_halo[i])
    return lo_halo, hi_halo


def halo_pad(f, g: int, spatial_axes: Sequence[int], specs,
             mesh: Mesh = None):
    """Pad with g guard cells per side along each spatial axis."""
    if mesh is None:
        return _pad_one(f, g, spatial_axes, specs)
    fs = list(f)
    for axis, spec in zip(spatial_axes, specs):
        n = fs[0].shape[axis]
        lo, hi = exchange_strips([t.narrow(axis, 0, g) for t in fs],
                                 [t.narrow(axis, n - g, g) for t in fs],
                                 spec, mesh)
        fs = [torch.cat([a, t, b], dim=axis) for a, t, b in zip(lo, fs, hi)]
    return fs


def _pad_one(f: torch.Tensor, g: int, spatial_axes: Sequence[int],
             periodic: Sequence[bool]) -> torch.Tensor:
    for axis, per in zip(spatial_axes, periodic):
        n = f.shape[axis]
        if per:
            lo = f.narrow(axis, n - g, g)
            hi = f.narrow(axis, 0, g)
        else:
            lo = hi = _zeros_like_strip(f, axis, g)
        f = torch.cat([lo, f, hi], dim=axis)
    return f


def halo_reduce(f, g: int, spatial_axes: Sequence[int], specs,
                mesh: Mesh = None):
    """Fold the g-wide guard rims of a padded array onto the neighbours'
    interiors and return the interior (reference sync_currents)."""
    if mesh is None:
        return _reduce_one(f, g, spatial_axes, specs)
    fs = list(f)
    for axis, spec in reversed(list(zip(spatial_axes, specs))):
        n_pad = fs[0].shape[axis]
        # my low rim belongs to the lower neighbour's interior tail
        from_lo, from_hi = exchange_strips(
            [t.narrow(axis, 0, g) for t in fs],
            [t.narrow(axis, n_pad - g, g) for t in fs], spec, mesh)
        fs = [_add_rims(t, g, axis, lo, hi)
              for t, lo, hi in zip(fs, from_lo, from_hi)]
    return fs


def _add_rims(f: torch.Tensor, g: int, axis: int, add_lo: torch.Tensor,
              add_hi: torch.Tensor) -> torch.Tensor:
    """The interior of ``f`` along ``axis`` plus ``add_lo`` on its first g
    rows and ``add_hi`` on its last g, as zero-extended adds (right even
    where the interior is narrower than 2g)."""
    n = f.shape[axis] - 2 * g
    core = f.narrow(axis, g, n)
    z = _zeros_like_strip(core, axis, n - g)
    return core + torch.cat([add_lo, z], dim=axis) + \
        torch.cat([z, add_hi], dim=axis)


def _reduce_one(f: torch.Tensor, g: int, spatial_axes: Sequence[int],
                periodic: Sequence[bool]) -> torch.Tensor:
    for axis, per in reversed(list(zip(spatial_axes, periodic))):
        n_pad = f.shape[axis]
        n = n_pad - 2 * g
        core = f.narrow(axis, g, n)
        if per:
            # my high rim wraps onto my first rows, my low rim onto my last
            f = _add_rims(f, g, axis, f.narrow(axis, n_pad - g, g),
                          f.narrow(axis, 0, g))
        else:
            f = core
    return f


def halo_pad_stack(fields, g: int, specs, mesh: Mesh = None):
    """Stack same-shape fields along a leading axis and pad them with one
    exchange per mesh axis. With a mesh ``fields`` is a sequence of
    sharded arrays (one list of shards per field)."""
    if mesh is None:
        stacked = torch.stack(list(fields), dim=0)
        return halo_pad(stacked, g, tuple(range(1, stacked.ndim)), specs)
    stacked = [torch.stack(list(per_shard), dim=0)
               for per_shard in zip(*fields)]
    return halo_pad(stacked, g, tuple(range(1, stacked[0].ndim)), specs,
                    mesh)
