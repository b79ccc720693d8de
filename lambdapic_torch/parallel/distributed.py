"""Gathering sharded arrays to the host (the single-process part of
lambdapic_tpu/parallel/distributed.py).

The port drives every shard from one process (``parallel/mesh.py``), so
the accessors gather shards with plain copies. The multi-process form
(``torch.distributed`` over NCCL, one process per card:
``init_distributed``, ``put_global``, ``warm_collectives`` and
``is_main_process``) is not ported yet (ROADMAP item 15).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .mesh import Mesh


def host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def to_host(shards: Sequence[torch.Tensor], mesh: Mesh,
            first_axis: int = None) -> np.ndarray:
    """A sharded array on the host. With ``first_axis`` the shards are
    blocks of one global array whose mesh axes are its axes
    ``first_axis``, ``first_axis + 1``, ... (fields: 0; a (C, nx, ny)
    stack: 1); without it the result stacks the shards under leading
    mesh axes, the JAX package's layout of per-device arrays
    (``mesh_shape + shard shape``)."""
    blocks = np.empty(mesh.shape, dtype=object)
    for i in range(mesh.size):
        blocks[mesh.coords(i)] = host(shards[i])
    if first_axis is None:
        return np.stack([blocks[c] for c in np.ndindex(mesh.shape)]
                        ).reshape(mesh.shape + blocks.flat[0].shape)
    return _assemble(blocks, first_axis)


def _assemble(blocks: np.ndarray, axis: int) -> np.ndarray:
    """Concatenate a mesh-shaped object array of blocks along the array
    axes ``axis``, ``axis + 1``, ... (one per mesh axis)."""
    if blocks.ndim == 1:
        return np.concatenate(list(blocks), axis=axis)
    return np.concatenate([_assemble(blocks[k], axis + 1)
                           for k in range(blocks.shape[0])], axis=axis)


def split_blocks(a: np.ndarray, mesh: Mesh, first_axis: int = 0):
    """The shards of a global host array whose mesh axes are its axes
    ``first_axis``, ... (the inverse of ``to_host(..., first_axis)``), in
    row-major shard order, as numpy views."""
    out = []
    for i in range(mesh.size):
        c = mesh.coords(i)
        idx = [slice(None)] * a.ndim
        for k, (ck, pk) in enumerate(zip(c, mesh.shape)):
            n = a.shape[first_axis + k] // pk
            idx[first_axis + k] = slice(ck * n, (ck + 1) * n)
        out.append(a[tuple(idx)])
    return out
