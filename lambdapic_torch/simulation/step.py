"""One step of the cell engine on one device (counterpart of the fused
cell path of lambdapic_tpu/simulation/step.py::StepBuilder).

    seg_fields_1   E += dt/2 ; B += dt/2                 kernel B1 x2
    seg_particles  pad E,B with guard cells; per species the whole
                   particle stage (half push, re-binning along x, y[, z],
                   gather, Boris, half push, deposit into tile panels,
                   chained across species)             kernel B2 per species
                   fold the summed panels into J        kernel B3
    seg_fields_2   B += dt/2 ; lasers ; E += dt/2        kernel B1 x2

The grid's dimension (2 or 3) selects the 2D or the 3D form of each
kernel. Host callbacks can run between the segments. The split particle path,
QED, collisions, the tiled and scatter engines and multi-step chunking
are not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from ..core.grid import Grid
from ..core.state import SimulationState
from ..ops.cellslab import cell_step, fold_reduce
from ..ops.cpml import CPMLCoeffs
from ..ops.fieldskernel import half_coeffs, update_bfield_k, update_efield_k
from ..parallel.halo import halo_pad


@dataclass(frozen=True)
class SpeciesStatic:
    """Per-species constants of the step."""

    name: str
    q: float
    m: float
    pusher: str
    cap: int


class StepBuilder:
    def __init__(self, grid: Grid, cpml: Optional[CPMLCoeffs], dt: float,
                 species: Sequence[SpeciesStatic], lasers: Sequence = (),
                 with_rho: bool = True, dtype=torch.float32,
                 device: torch.device = torch.device("cpu")):
        self.grid = grid
        self.cpml = cpml
        self.dt = dt
        self.species = tuple(species)
        self.lasers = tuple(lasers)
        # deposit rho in the hot loop; when False the deposit carries
        # jx, jy, jz only and Simulation.get_field("rho") recomputes rho
        self.with_rho = with_rho
        self.periodic = grid.periodic_axes
        self.spatial_axes = tuple(range(1, grid.dimension + 1))
        # B1's coefficient rows, built once per device and type
        self._coeffs = {}
        if torch.device(device).type == "cuda":
            self._coeffs = {w: half_coeffs(grid, cpml, w, dtype, device)
                            for w in ("e", "b")}

    def _half(self, f, which: str):
        fn = update_efield_k if which == "e" else update_bfield_k
        return fn(f, self.grid, self.dt / 2, self.cpml,
                  self._coeffs.get(which))

    def pad_eb(self, f) -> torch.Tensor:
        """The six E/B components with n_guard guard cells per side."""
        eb = torch.stack([f.ex, f.ey, f.ez, f.bx, f.by, f.bz], dim=0)
        return halo_pad(eb, self.grid.n_guard, self.spatial_axes,
                        self.periodic)

    def seg_fields_1(self, state: SimulationState, scalars: Dict
                     ) -> SimulationState:
        f = self._half(state.fields, "e")
        f = self._half(f, "b")
        return state.replace(fields=f)

    def seg_particles(self, state: SimulationState, scalars: Dict
                      ) -> SimulationState:
        grid = self.grid
        f = state.fields
        eb_pad = self.pad_eb(f)
        rims = None
        parts = []
        dz = grid.dz if grid.dimension == 3 else None
        for sp, p in zip(self.species, state.particles):
            data, alive, n_lost, rims = cell_step(
                eb_pad, p.data, p.alive, q=sp.q, m=sp.m, dt=self.dt,
                dx=grid.dx, dy=grid.dy, dz=dz, g=grid.n_guard,
                periodic=self.periodic, rims_in=rims,
                with_rho=self.with_rho)
            parts.append(p.replace(data=data, alive=alive,
                                   overflow=p.overflow + n_lost))
        if rims is not None:
            j = fold_reduce(rims, grid.shape, self.periodic)
            rep = dict(jx=j[0], jy=j[1], jz=j[2])
            if j.shape[0] == 4:
                rep["rho"] = j[3]
            f = f.replace(**rep)
        return state.replace(fields=f, particles=tuple(parts))

    def seg_fields_2(self, state: SimulationState, scalars: Dict
                     ) -> SimulationState:
        f = self._half(state.fields, "b")
        for i, laser in enumerate(self.lasers):
            f = laser.apply(f, self.grid, self.dt, scalars.get(f"laser{i}", {}))
        f = self._half(f, "e")
        return state.replace(fields=f)

    def full_step(self, state: SimulationState, scalars: Dict
                  ) -> SimulationState:
        state = self.seg_fields_1(state, scalars)
        state = self.seg_particles(state, scalars)
        return self.seg_fields_2(state, scalars)
