"""The device mesh of a sharded run (counterpart of
lambdapic_tpu/parallel/mesh.py).

The JAX package runs one controller over a ``jax.sharding.Mesh`` and
turns collectives into copies between shards inside ``shard_map``. The
port keeps that single-controller model: one process drives every shard,
a sharded array is a list of per-shard tensors in the mesh's row-major
order, each on its shard's device, and a collective is a loop over the
shards that copies tensors between them (``ppermute``, ``psum``). A
device list may name one card several times, so a 2 x 2 mesh runs on one
card; on a CPU device list the same code runs the kernels' plain
versions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.grid import Grid


@dataclass(frozen=True)
class Mesh:
    """A mesh of shards: its shape, its axis names ('px', 'py'[, 'pz'])
    and one device per shard, row-major (shard i sits at
    ``np.unravel_index(i, shape)``)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, i: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(i, self.shape))

    def index(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.shape))

    def axis(self, axis) -> int:
        """The position of a mesh axis given by position or name."""
        return self.axis_names.index(axis) if isinstance(axis, str) else axis

    def neighbour(self, i: int, axis, shift: int) -> int:
        """The shard ``shift`` steps from shard ``i`` along ``axis``, on
        the ring of that axis."""
        ax = self.axis(axis)
        c = list(self.coords(i))
        c[ax] = (c[ax] + shift) % self.shape[ax]
        return self.index(c)


def make_mesh(grid: Grid, devices: Optional[Sequence] = None) -> Mesh:
    """The ('px','py'[,'pz']) mesh of ``grid`` on the first
    prod(mesh_shape) devices of ``devices`` (default: every visible CUDA
    card, one shard each). An explicit list may repeat a device."""
    shape = grid.mesh_shape
    n = int(np.prod(shape))
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(
            f"need {n} devices for patch mesh {shape}, have {len(devices)}")
    for d in devices[:n]:
        if d.type == "cuda" and (not torch.cuda.is_available() or
                                 (d.index or 0) >= torch.cuda.device_count()):
            raise RuntimeError(f"mesh device {d} is not available")
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported mesh device {d}")
    return Mesh(shape=tuple(shape), axis_names=grid.axis_names,
                devices=tuple(devices[:n]))


def auto_patches(nx: int, ny: int, nz: Optional[int] = None,
                 n_devices: Optional[int] = None) -> Tuple[int, ...]:
    """A patch (device) grid for the available devices, one patch per
    device (default: every visible CUDA card): the factorisation of
    n_devices with the least halo surface, every patch at least 8 cells
    wide."""
    if n_devices is None:
        n_devices = max(torch.cuda.device_count(), 1)
    dims = 2 if nz is None else 3
    best = None
    for px in range(1, n_devices + 1):
        if n_devices % px:
            continue
        rest = n_devices // px
        if dims == 2:
            candidates = [(px, rest)]
        else:
            candidates = [(px, py, rest // py)
                          for py in range(1, rest + 1) if rest % py == 0]
        for cand in candidates:
            ns = (nx, ny) if dims == 2 else (nx, ny, nz)
            if any(n % p or n // p < 8 for n, p in zip(ns, cand)):
                continue
            # halo surface ~ sum over axes of (cells orthogonal to axis) * (p-1)
            locs = [n // p for n, p in zip(ns, cand)]
            surface = 0.0
            for ax in range(dims):
                cross = 1.0
                for k in range(dims):
                    if k != ax:
                        cross *= locs[k]
                surface += cross * (cand[ax] - 1)
            if best is None or surface < best[0]:
                best = (surface, cand)
    if best is None:
        return (1, 1) if dims == 2 else (1, 1, 1)
    return best[1]


def axis_index(mesh: Mesh, i: int, axis) -> int:
    """Shard ``i``'s coordinate along a mesh axis (``lax.axis_index``)."""
    return mesh.coords(i)[mesh.axis(axis)]


def ppermute(shards: Sequence[torch.Tensor], mesh: Mesh, axis, shift: int
             ) -> List[torch.Tensor]:
    """Shift along a mesh axis: shard i receives the tensor of the shard
    ``shift`` steps below it on the axis's ring (``shift=+1`` is
    ``lax.ppermute`` with the perm [(j, j+1)]), copied to shard i's
    device. A tensor that stays on its device is copied all the same, so
    no two shards share storage."""
    out = []
    for i in range(mesh.size):
        src = shards[mesh.neighbour(i, axis, -shift)]
        dev = mesh.devices[i]
        out.append(src.to(dev, non_blocking=True, copy=True))
    return out


def psum(values: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum over every shard, on the first shard's device."""
    dev = mesh.devices[0]
    total = values[0].to(dev)
    for v in values[1:]:
        total = total + v.to(dev)
    return total
