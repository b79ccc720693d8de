"""One step of the cell engine on one device (counterpart of the fused
cell path of lambdapic_tpu/simulation/step.py::StepBuilder).

    seg_fields_1   E += dt/2 ; B += dt/2                 kernel B1 x2
    seg_particles  pad E,B with guard cells; per species the whole
                   particle stage (half push, re-binning along x, y[, z],
                   gather, Boris, half push, deposit into tile panels,
                   chained across species)             kernel B2 per species
                     a radiating species: B2 want_chi, then its QED
                       events (models/qed.py, plain torch)
                     a photon species: B2 photon (no field, no current)
                   QED creation: newborn photons into dead photon slots
                     of their parents' cells, parents recoil (plain torch)
                   fold the summed panels into J        kernel B3
    seg_fields_2   B += dt/2 ; lasers ; E += dt/2        kernel B1 x2

The grid's dimension (2 or 3) selects the 2D or the 3D form of each
kernel (QED in 2D only so far). Host callbacks can run between the
segments. The split particle path, Breit-Wheeler pairs, collisions, the
tiled and scatter engines and multi-step chunking are not ported yet
(ROADMAP queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from ..core.grid import Grid
from ..core.state import SimulationState
from ..models.qed import species_key
from ..ops.cell2d import insert_cells
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
                 device: torch.device = torch.device("cpu"),
                 qed_processes: Sequence = (),
                 base_key: Optional[torch.Tensor] = None):
        self.grid = grid
        self.cpml = cpml
        self.dt = dt
        self.species = tuple(species)
        self.lasers = tuple(lasers)
        # deposit rho in the hot loop; when False the deposit carries
        # jx, jy, jz only and Simulation.get_field("rho") recomputes rho
        self.with_rho = with_rho
        # QED: the processes (models/qed.py) and the run's base key (on the
        # CPU, so the per-step key folds run on the host)
        self.qed_processes = tuple(qed_processes)
        self.base_key = base_key
        if self.qed_processes and base_key is None:
            raise ValueError("QED processes need the run's base key")
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
        for ispec, (sp, p) in enumerate(zip(self.species, state.particles)):
            kw = dict(dt=self.dt, dx=grid.dx, dy=grid.dy, dz=dz,
                      g=grid.n_guard, periodic=self.periodic)
            if sp.pusher == "photon":
                data, alive, n_lost, _ = cell_step(
                    None, p.data, p.alive, q=0.0, m=0.0, photon=True, **kw)
                parts.append(p.replace(data=data, alive=alive,
                                       overflow=p.overflow + n_lost))
                continue
            procs = [pr for pr in self.qed_processes if pr.ispec == ispec]
            outs = cell_step(eb_pad, p.data, p.alive, q=sp.q, m=sp.m,
                             rims_in=rims, with_rho=self.with_rho,
                             want_chi=bool(procs), **kw)
            data, alive, n_lost, rims = outs[:4]
            if procs:
                chi, ig0 = outs[4]
                key = species_key(self.base_key, scalars["itime"], ispec)
                for proc in procs:
                    data, alive = proc.update_events_from_chi(
                        data, alive, key, self.dt, chi, ig0)
            parts.append(p.replace(data=data, alive=alive,
                                   overflow=p.overflow + n_lost))
        # QED creation after every species has deposited: the deposit used
        # the pre-recoil momenta, and newborns are first pushed next step
        for proc in self.qed_processes:
            parts = self.qed_creation(proc, parts)
        if rims is not None:
            j = fold_reduce(rims, grid.shape, self.periodic)
            rep = dict(jx=j[0], jy=j[1], jz=j[2])
            if j.shape[0] == 4:
                rep["rho"] = j[3]
            f = f.replace(**rep)
        return state.replace(fields=f, particles=tuple(parts))

    def qed_creation(self, proc, parts):
        """Photon birth of one Compton process: each event of the parent
        species adds a photon (the parent's position and weight, momentum
        delta * u) to a dead photon slot of the parent's cell, and the
        parent recoils. Newborns without a free slot are counted in the
        photons' overflow."""
        parts = list(parts)
        e, ph = parts[proc.ispec], parts[proc.photon_ispec]
        ev = e.alive & (e.data["event"] > 0)
        new = proc.photon_newborns(e.data, self.grid.dimension)
        phdata, phalive, phnext, lost = insert_cells(
            ph.data, ph.alive, ph.next_id, new, ev)
        parts[proc.ispec] = e.replace(data=proc.apply_recoil(e.data, ev))
        parts[proc.photon_ispec] = ph.replace(
            data=phdata, alive=phalive, next_id=phnext,
            overflow=ph.overflow + lost)
        return parts

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
