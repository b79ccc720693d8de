"""Simulation state as dataclasses of tensors (counterpart of
lambdapic_tpu/core/state.py).

Layouts are the JAX package's, without its device-mesh axes (the port
runs on one device):

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
  per-device uint32 / int32 counters of a one-device mesh).

``state_from_numpy`` / ``state_to_numpy`` carry a state across from and
back to the JAX package's layout (``jax.device_get(sim.state)``).
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


# E/B component pairs carried by the CPML psi arrays of each PML axis
PSI_COMPONENTS = {
    "x": ("ey", "ez", "by", "bz"),
    "y": ("ex", "ez", "bx", "bz"),
    "z": ("ex", "ey", "bx", "by"),
}


def zeros_fields(grid: Grid, dtype, device, cpml=None) -> FieldsState:
    """All-zero fields; one slab-restricted psi array per transverse
    E/B component on each axis that has a PML face."""
    shape = grid.shape

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
                   alive_np: np.ndarray, dtype, device, tiled: bool = False
                   ) -> ParticlesState:
    """ParticlesState from host cell-binned arrays ``(cap_c, nx, ny[, nz])``
    (``simulation/initfill.py::bin_cells``), or with ``tiled`` tile-binned
    ones ``(ntx, nty, cap_t)`` (``bin_tiled``): ids are the flat slot
    index, as the JAX package's ``Simulation._tiled_state`` numbers
    them."""
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
    data["id_hi"] = torch.zeros(shape, dtype=torch.int32, device=device)
    return ParticlesState(
        data=data, alive=torch.as_tensor(alive_np, dtype=torch.bool).to(device),
        next_id=torch.tensor(int(alive_np.sum()), dtype=torch.int64,
                             device=device),
        overflow=torch.zeros((), dtype=torch.int64, device=device),
        tiled=tiled)


def _strip_mesh(a: np.ndarray, nmesh: int) -> np.ndarray:
    if a.shape[:nmesh] != (1,) * nmesh:
        raise ValueError(
            f"state has a device mesh {a.shape[:nmesh]}; the port takes "
            "one-device states only")
    return a.reshape(a.shape[nmesh:])


def state_from_numpy(np_state, device, dtype=None, dimension: int = 2,
                     tiled: bool = False) -> SimulationState:
    """Build the port's state from a JAX package state whose leaves are
    numpy arrays (``jax.device_get(sim.state)`` of a one-device cell
    engine run, or with ``tiled`` of the tiled 2D engine). ``dtype``
    defaults to the fields' dtype."""
    f = np_state.fields
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, np.asarray(f.ex).dtype)).dtype

    def fld(a):
        return torch.as_tensor(np.array(a), dtype=dtype).to(device)

    fields = FieldsState(
        **{k: fld(getattr(f, k)) for k in
           ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")},
        psi={k: fld(v) for k, v in f.psi.items()})
    parts = []
    for p in np_state.particles:
        data = {}
        for k, v in p.data.items():
            v = _strip_mesh(np.array(v), dimension)
            data[k] = (ids_to_torch(v, device) if k in ID_KEYS
                       else torch.as_tensor(v, dtype=dtype).to(device))
        parts.append(ParticlesState(
            data=data,
            alive=torch.as_tensor(_strip_mesh(np.array(p.alive), dimension)
                                  ).to(device),
            next_id=torch.tensor(int(np.asarray(p.next_id).sum()),
                                 dtype=torch.int64, device=device),
            overflow=torch.tensor(int(np.asarray(p.overflow).sum()),
                                  dtype=torch.int64, device=device),
            tiled=tiled))
    return SimulationState(fields=fields, particles=tuple(parts))


def state_to_numpy(state: SimulationState, dimension: int = 2):
    """The port's state in the JAX package's numpy layout: particle
    arrays get back their one-device mesh axes, ids become uint32, and
    the counters their per-device shapes and types."""
    lead = (1,) * dimension

    def host(t):
        return t.detach().cpu().numpy()

    f = state.fields
    fields = SimpleNamespace(
        **{k: host(getattr(f, k)) for k in
           ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")},
        psi={k: host(v) for k, v in f.psi.items()})
    parts = []
    for p in state.particles:
        data = {}
        for k, v in p.data.items():
            a = ids_to_numpy(v) if k in ID_KEYS else host(v)
            data[k] = a.reshape(lead + a.shape)
        parts.append(SimpleNamespace(
            data=data,
            alive=host(p.alive).reshape(lead + tuple(p.alive.shape)),
            next_id=np.full(lead, int(p.next_id), np.uint32),
            overflow=np.full(lead, int(p.overflow), np.int32)))
    return SimpleNamespace(fields=fields, particles=tuple(parts))
