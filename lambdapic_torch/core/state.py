"""Simulation state as dataclasses of tensors (counterpart of
lambdapic_tpu/core/state.py).

Layouts are the JAX package's, without its device-mesh axes: a
one-device run holds one ``SimulationState``, a sharded run a
``MeshState`` of one ``SimulationState`` per shard (row-major over the
mesh, each on its shard's device) with shard-local shapes:

- fields are interior-only ``(nx, ny[, nz])`` tensors; CPML psi arrays
  are slab-restricted along their PML axis (``ops/cpml.py::psi_regions``),
  e.g. ``psi_ey_x`` is ``(w_x, ny[, nz])``;
- cell-engine particles are per-cell slots ``(cap_c, nx, ny[, nz])``, the
  tiled 2D engine's per-tile slots ``(ntx, nty, cap_t)`` (the slot axis
  last; ``ParticlesState.tiled``); ``alive`` is bool; the 64-bit particle
  id is carried as two int32 tensors ``id_lo`` / ``id_hi`` holding the
  JAX package's uint32 bit patterns
  (torch's uint32 lacks gather and add on the CPU);
- ``next_id`` and ``overflow`` are 0-d int64 tensors (the JAX package's
  per-device uint32 / int32 counters), one per shard.

``state_from_numpy`` / ``state_to_numpy`` carry a state across from and
back to the JAX package's layout (``jax.device_get(sim.state)``): global
fields and psi, particle arrays under leading mesh axes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np
import torch

from .grid import Grid
from .species import Species

ID_KEYS = ("id_lo", "id_hi")


@dataclass
class FieldsState:
    """EM field tensors, interior only (no guard cells)."""

    ex: torch.Tensor
    ey: torch.Tensor
    ez: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor
    bz: torch.Tensor
    jx: torch.Tensor
    jy: torch.Tensor
    jz: torch.Tensor
    rho: torch.Tensor
    # CPML auxiliary arrays, keys like 'psi_ey_x'; empty when periodic
    psi: Dict[str, torch.Tensor] = field(default_factory=dict)

    def replace(self, **kw) -> "FieldsState":
        return dataclasses.replace(self, **kw)


@dataclass
class ParticlesState:
    """Slot arrays of one species: ``data[attr]`` is ``(cap_c, nx, ny[,
    nz])`` per cell, or with ``tiled`` ``(ntx, nty, cap_t)`` per tile.
    ``tiled`` is set from Simulation.tiling where the state is binned, and
    StepBuilder refuses a state whose layout is not its tile_cfg's."""

    data: Dict[str, torch.Tensor]
    alive: torch.Tensor
    next_id: torch.Tensor
    overflow: torch.Tensor
    tiled: bool = False

    @property
    def slot_axis(self) -> int:
        return self.alive.ndim - 1 if self.tiled else 0

    @property
    def cap(self) -> int:
        return self.alive.shape[self.slot_axis]

    def replace(self, **kw) -> "ParticlesState":
        return dataclasses.replace(self, **kw)


@dataclass
class SimulationState:
    fields: FieldsState
    particles: Tuple[ParticlesState, ...]

    def replace(self, **kw) -> "SimulationState":
        return dataclasses.replace(self, **kw)


@dataclass
class MeshState:
    """The state of a sharded run: one shard-local SimulationState per
    shard of the mesh, in its row-major order."""

    shards: Tuple[SimulationState, ...]

    def replace(self, **kw) -> "MeshState":
        return dataclasses.replace(self, **kw)


# E/B component pairs carried by the CPML psi arrays of each PML axis
PSI_COMPONENTS = {
    "x": ("ey", "ez", "by", "bz"),
    "y": ("ex", "ez", "bx", "bz"),
    "z": ("ex", "ey", "bx", "by"),
}


def zeros_fields(grid: Grid, dtype, device, cpml=None,
                 shape=None) -> FieldsState:
    """All-zero fields of ``shape`` (default the global grid; a shard's
    local shape with that shard's ``ops/cpml.py::shard_cpml``); one
    slab-restricted psi array per transverse E/B component on each axis
    that has a PML face."""
    shape = tuple(grid.shape if shape is None else shape)

    def z():
        return torch.zeros(shape, dtype=dtype, device=device)

    psi = {}
    if cpml is not None:
        for axis, ax in enumerate(grid.axes):
            if cpml.axis(ax) is None:
                continue
            pshape = list(shape)
            pshape[axis] = cpml.psi_width(ax)
            for comp in PSI_COMPONENTS[ax]:
                psi[f"psi_{comp}_{ax}"] = torch.zeros(
                    pshape, dtype=dtype, device=device)
    return FieldsState(ex=z(), ey=z(), ez=z(), bx=z(), by=z(), bz=z(),
                       jx=z(), jy=z(), jz=z(), rho=z(), psi=psi)


def ids_to_torch(a: np.ndarray, device) -> torch.Tensor:
    """uint32 id bit patterns -> int32 tensor (same bits)."""
    return torch.from_numpy(
        np.array(a, dtype=np.uint32).view(np.int32)).to(device)


def ids_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def cell_particles(species: Species, arrays: Dict[str, np.ndarray],
                   alive_np: np.ndarray, dtype, device, tiled: bool = False,
                   shard: int = 0) -> ParticlesState:
    """ParticlesState of one shard from host cell-binned arrays
    ``(cap_c, nx, ny[, nz])`` (``simulation/initfill.py::bin_cells``), or
    with ``tiled`` tile-binned ones ``(ntx, nty, cap_t)`` (``bin_tiled``):
    id_lo is the flat slot index and id_hi the shard's flat index, as the
    JAX package's ``Simulation._tiled_state`` numbers them."""
    shape = alive_np.shape
    data = {}
    for attr in species.attrs():
        a = arrays.get(attr)
        if a is None:
            a = np.zeros(shape, dtype=np.float64)
        data[attr] = torch.as_tensor(np.asarray(a, np.float64),
                                     dtype=dtype).to(device)
    iota = np.arange(int(np.prod(shape)), dtype=np.uint32).reshape(shape)
    data["id_lo"] = ids_to_torch(iota, device)
    data["id_hi"] = torch.full(shape, shard, dtype=torch.int32, device=device)
    return ParticlesState(
        data=data, alive=torch.as_tensor(alive_np, dtype=torch.bool).to(device),
        next_id=torch.tensor(int(alive_np.sum()), dtype=torch.int64,
                             device=device),
        overflow=torch.zeros((), dtype=torch.int64, device=device),
        tiled=tiled)


def _fields_from_numpy(f, conv, psi) -> FieldsState:
    return FieldsState(
        **{k: conv(getattr(f, k)) for k in
           ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")},
        psi=psi)


def _particles_from_numpy(p, lead, device, dtype, tiled) -> ParticlesState:
    """One shard's ParticlesState from the JAX arrays of species ``p`` at
    mesh index ``lead``."""
    data = {}
    for k, v in p.data.items():
        v = np.array(np.asarray(v)[lead])
        data[k] = (ids_to_torch(v, device) if k in ID_KEYS
                   else torch.as_tensor(v, dtype=dtype).to(device))
    return ParticlesState(
        data=data,
        alive=torch.as_tensor(np.array(np.asarray(p.alive)[lead])).to(device),
        next_id=torch.tensor(int(np.asarray(p.next_id)[lead]),
                             dtype=torch.int64, device=device),
        overflow=torch.tensor(int(np.asarray(p.overflow)[lead]),
                              dtype=torch.int64, device=device),
        tiled=tiled)


def state_from_numpy(np_state, device, dtype=None, dimension: int = 2,
                     tiled: bool = False, mesh=None, cpml=None, grid=None):
    """Build the port's state from a JAX package state whose leaves are
    numpy arrays (``jax.device_get(sim.state)``). ``dtype`` defaults to
    the fields' dtype.

    A one-device state (a 1 x 1 mesh, or the tiled 2D engine's with
    ``tiled``) gives a SimulationState on ``device``. With ``mesh`` (the
    port's ``parallel/mesh.py::Mesh``) the state is split into a
    MeshState, shard i on ``mesh.devices[i]`` (``device`` is not read):
    fields cut into blocks, each shard's psi the rows of its PML slabs
    (``ops/cpml.py::psi_rows``, which needs the global ``cpml`` and the
    ``grid``), particles and counters taken at the shard's mesh index."""
    f = np_state.fields
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, np.asarray(f.ex).dtype)).dtype
    if mesh is None:
        lead = (0,) * dimension
        for p in np_state.particles:
            if np.asarray(p.alive).shape[:dimension] != (1,) * dimension:
                raise ValueError(
                    f"state has a device mesh "
                    f"{np.asarray(p.alive).shape[:dimension]}; pass the "
                    "port's mesh= to split it into shards")

        def fld(a):
            return torch.as_tensor(np.array(a), dtype=dtype).to(device)

        fields = _fields_from_numpy(
            f, fld, {k: fld(v) for k, v in f.psi.items()})
        return SimulationState(fields=fields, particles=tuple(
            _particles_from_numpy(p, lead, device, dtype, tiled)
            for p in np_state.particles))
    from ..ops.cpml import psi_rows
    from ..parallel.distributed import split_blocks
    if f.psi and (cpml is None or grid is None):
        raise ValueError("state_from_numpy: a mesh state with psi needs "
                         "the global cpml and grid")
    comps = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")
    blocks = {k: split_blocks(np.asarray(getattr(f, k)), mesh)
              for k in comps}
    shards = []
    for i in range(mesh.size):
        dev = mesh.devices[i]
        coords = mesh.coords(i)

        def put(a):
            return torch.as_tensor(np.array(a), dtype=dtype).to(dev)

        psi = {}
        for key, v in f.psi.items():
            ax = key[-1]
            k = "xyz".index(ax)
            v = np.asarray(v)
            idx = []
            for kk in range(dimension):
                if kk == k:
                    idx.append(psi_rows(cpml, grid, ax, coords[k]))
                else:
                    n = v.shape[kk] // mesh.shape[kk]
                    idx.append(np.arange(coords[kk] * n,
                                         (coords[kk] + 1) * n))
            psi[key] = put(v[np.ix_(*idx)])
        fields = FieldsState(**{k: put(blocks[k][i]) for k in comps},
                             psi=psi)
        shards.append(SimulationState(fields=fields, particles=tuple(
            _particles_from_numpy(p, coords, dev, dtype, tiled)
            for p in np_state.particles)))
    return MeshState(shards=tuple(shards))


def state_to_numpy(state, dimension: int = 2, mesh=None, cpml=None,
                   grid=None):
    """The port's state in the JAX package's numpy layout: particle
    arrays under their mesh axes, ids as uint32, the counters in their
    per-device shapes and types. A MeshState needs its ``mesh`` (and, with
    psi, the global ``cpml`` and ``grid``): fields and psi are assembled
    into global arrays."""
    def host(t):
        return t.detach().cpu().numpy()

    def counters(p_shards, k, dt):
        return np.array([int(getattr(p, k)) for p in p_shards],
                        dt).reshape(lead)

    if mesh is None:
        shards, lead = (state,), (1,) * dimension
    else:
        shards, lead = state.shards, tuple(mesh.shape)
    comps = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")
    if mesh is None:
        f = state.fields
        fields = SimpleNamespace(
            **{k: host(getattr(f, k)) for k in comps},
            psi={k: host(v) for k, v in f.psi.items()})
    else:
        from ..ops.cpml import psi_rows
        from ..parallel.distributed import to_host
        fs = [s.fields for s in shards]
        out = {k: to_host([getattr(x, k) for x in fs], mesh, 0)
               for k in comps}
        psi = {}
        for key in fs[0].psi:
            ax = key[-1]
            k = "xyz".index(ax)
            gshape = list(out["ex"].shape)
            gshape[k] = cpml.psi_width(ax)
            a = np.zeros(gshape, dtype=out["ex"].dtype)
            for i, x in enumerate(fs):
                coords = mesh.coords(i)
                idx = []
                for kk in range(dimension):
                    if kk == k:
                        idx.append(psi_rows(cpml, grid, ax, coords[k]))
                    else:
                        n = grid.local_shape[kk]
                        idx.append(np.arange(coords[kk] * n,
                                             (coords[kk] + 1) * n))
                a[np.ix_(*idx)] = host(x.psi[key])
            psi[key] = a
        fields = SimpleNamespace(**out, psi=psi)
    parts = []
    for ispec in range(len(shards[0].particles)):
        ps = [s.particles[ispec] for s in shards]
        data = {}
        for k in ps[0].data:
            arrs = [ids_to_numpy(p.data[k]) if k in ID_KEYS
                    else host(p.data[k]) for p in ps]
            data[k] = np.stack(arrs).reshape(lead + arrs[0].shape)
        alive = np.stack([host(p.alive) for p in ps])
        parts.append(SimpleNamespace(
            data=data, alive=alive.reshape(lead + alive.shape[1:]),
            next_id=counters(ps, "next_id", np.uint32),
            overflow=counters(ps, "overflow", np.int32)))
    return SimpleNamespace(fields=fields, particles=tuple(parts))
