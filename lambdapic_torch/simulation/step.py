"""One step of the cell engine (counterpart of the cell path of
lambdapic_tpu/simulation/step.py::StepBuilder): ``StepBuilder`` on one
device, below; ``MeshStepBuilder`` (at the end) on a device mesh.

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

The per-stage engine (2D and 3D) takes a species off B2 where the JAX
package does so for a reason that is not tiling:

- ``cell_migration="exact"`` (every step): half push, the exact
  re-binning (``cell2d.migrate_cells(exact=True)``, plain torch as it is
  XLA in JAX), then gather + Boris + half push (kernel B4; with the six
  gathered fields for a radiating species, whose QED events follow) and
  the deposit into the padded current (kernel B5). A photon species
  takes the half push, the exact re-binning, 1/|u| and the half push.
  The species' padded currents are summed and folded by ``halo_reduce``.
- the split step (a host callback at an inner stage is due):
  ``seg_particles_sub`` runs one sub-stage over all species at a time
  (``callbacks.INNER_SUBSTAGES``): p1 half push + re-binning (kernel B6
  per axis, or with LAMBDAPIC_MIG_FUSED=0 the fast ``migrate_cells``
  sorting through kernel B7), interp (gather into ``*_part``), qed, mom
  (Boris or 1/|u|), p2 half push, deposit (kernel B5, QED creation, J).
  The sub-stages talk through the particle arrays.

The tiled 2D engine (``tile_cfg``, particles in (ntx, nty, cap_t) tile
slots; lambdapic_tpu/simulation/step.py's tiled branch of
make_species_block) runs per species: half push, the gather of E and B
(kernel B8, photons included), the QED events, Boris (1/|u| for
photons), half push, the deposit into per-tile windows (kernel B9)
folded into a padded current (``fold_windows``, plain torch), and the
re-binning between tiles (``tiled2d.migrate_tiled``, plain torch, as it
is XLA in JAX) unless the step is built with ``migrate=False`` (the
steps between re-binnings of ``rebin_interval``). QED newborns join
their parents' tiles (``insert_tiled``). The split step runs the same
sub-stages one at a time and re-bins in its deposit sub-stage.

The grid's dimension (2 or 3) selects the 2D or the 3D form of each
kernel, QED included. Host callbacks can run between the segments.
Breit-Wheeler pairs, collisions, the scatter engine and multi-step
chunking are not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional, Sequence

import torch

from ..constants import c as c_light
from ..core.grid import Grid
from ..core.state import ParticlesState, SimulationState
from ..models.qed import species_key
from ..ops.cell2d import gather_cell_2d, insert_cells
from ..ops.cell3d import gather_cell_3d
from ..ops.cellpallas import (deposit_cell_2d_k, deposit_cell_3d_k,
                              fused_push_cell_2d, fused_push_cell_3d,
                              migrate_cells_mesh, migrate_fn)
from ..ops.cellslab import cell_step, cell_step_mesh, fold_reduce
from ..ops.cpml import CPMLCoeffs
from ..ops.fieldskernel import half_coeffs, update_bfield_k, update_efield_k
from ..ops.pusher import (boris_push, photon_push, push_position_2d,
                          push_position_3d)
from ..ops.tiled2d import (TileCfg, fold_windows, insert_tiled,
                           migrate_tiled)
from ..ops.tiled2d_kernels import deposit_tiled_k, gather_tiled_k
from ..parallel.halo import halo_pad, halo_reduce
from .callbacks import INNER_SUBSTAGES

# the sub-stages of the per-stage engine, in order
ALL_SUBSTAGES: FrozenSet[str] = frozenset(s for s, _ in INNER_SUBSTAGES)
# the gathered-field slots the per-stage engine writes
EB_PART = ("ex_part", "ey_part", "ez_part", "bx_part", "by_part", "bz_part")


@dataclass(frozen=True)
class SpeciesStatic:
    """Per-species constants of the step; ``cap`` is the length of the
    slot axis (slots a cell, or a tile under tiling)."""

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
                 base_key: Optional[torch.Tensor] = None,
                 cell_migration: str = "fast",
                 tile_cfg: Optional[TileCfg] = None):
        self.grid = grid
        # the tiled 2D engine's tiling (cap_t is each species' own); None
        # for the cell engine
        self.tile_cfg = tile_cfg
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
        # "exact": every species takes the per-stage engine every step
        self.cell_migration = cell_migration
        # per species: whether its *_part slots hold the fields gathered in
        # the last step (Simulation.get_particles exposes them only then)
        self.transients_valid: Dict[int, bool] = {}
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

    def _species_key(self, scalars: Dict, ispec: int,
                     didx: int = 0) -> torch.Tensor:
        return species_key(self.base_key, scalars["itime"], ispec, didx)

    def _procs(self, ispec: int):
        return [pr for pr in self.qed_processes if pr.ispec == ispec]

    def _check_layout(self, state: SimulationState):
        """The slot layout is the tiling's (``tile_cfg``, from Simulation.
        tiling, the one owner); a state binned the other way is refused."""
        tiled = self.tile_cfg is not None
        for sp, p in zip(self.species, state.particles):
            if p.tiled != tiled:
                raise ValueError(
                    f"species {sp.name}: slots binned "
                    f"{'per tile' if p.tiled else 'per cell'}, but the step "
                    f"is built for the {'tiled' if tiled else 'cell'} engine")

    def seg_particles(self, state: SimulationState, scalars: Dict,
                      migrate: bool = True) -> SimulationState:
        """The particle stage of every species, QED creation and J.
        ``migrate=False`` (tiled engine only) skips the re-binning."""
        self._check_layout(state)
        if self.tile_cfg is not None:
            return self._particles_tiled(state, scalars, ALL_SUBSTAGES,
                                         migrate)
        grid = self.grid
        f = state.fields
        eb_pad = self.pad_eb(f)
        rims = jpad = None
        parts = []
        dz = grid.dz if grid.dimension == 3 else None
        for ispec, (sp, p) in enumerate(zip(self.species, state.particles)):
            procs = self._procs(ispec)
            if self.cell_migration == "exact":
                p, jp = self.species_stages(ispec, p, eb_pad, scalars,
                                            ALL_SUBSTAGES)
                parts.append(p)
                jpad = _add(jpad, jp)
                self.transients_valid[ispec] = bool(procs)
                continue
            self.transients_valid[ispec] = False
            kw = dict(dt=self.dt, dx=grid.dx, dy=grid.dy, dz=dz,
                      g=grid.n_guard, periodic=self.periodic)
            if sp.pusher == "photon":
                data, alive, n_lost, _ = cell_step(
                    None, p.data, p.alive, q=0.0, m=0.0, photon=True, **kw)
                parts.append(p.replace(data=data, alive=alive,
                                       overflow=p.overflow + n_lost))
                continue
            outs = cell_step(eb_pad, p.data, p.alive, q=sp.q, m=sp.m,
                             rims_in=rims, with_rho=self.with_rho,
                             want_chi=bool(procs), **kw)
            data, alive, n_lost, rims = outs[:4]
            if procs:
                chi, ig0 = outs[4]
                key = self._species_key(scalars, ispec)
                for proc in procs:
                    data, alive = proc.update_events_from_chi(
                        data, alive, key, self.dt, chi, ig0)
            parts.append(p.replace(data=data, alive=alive,
                                   overflow=p.overflow + n_lost))
        # QED creation after every species has deposited: the deposit used
        # the pre-recoil momenta, and newborns are first pushed next step
        for proc in self.qed_processes:
            parts = self.qed_creation(proc, parts)
        j = None
        if rims is not None:
            j = fold_reduce(rims, grid.shape, self.periodic)
        if self.cell_migration == "exact":
            j2 = self.reduce_j(jpad, f.ex)
            j = j2 if j is None else j + j2[:j.shape[0]]
        if j is not None:
            f = f.replace(**_current(j))
        return state.replace(fields=f, particles=tuple(parts))

    def reduce_j(self, jpad: Optional[torch.Tensor], like: torch.Tensor
                 ) -> torch.Tensor:
        """The interior (4, nx, ny) current of the species-summed padded
        currents of the per-stage engine (zeros, of ``like``'s type and
        device, when no species deposited: the JAX package sums zero
        currents of neutral species there)."""
        g = self.grid.n_guard
        if jpad is None:
            jpad = torch.zeros((4,) + tuple(n + 2 * g for n in self.grid.shape),
                               dtype=like.dtype, device=like.device)
        # halo_reduce leaves a view when a face is open; kernel B1 takes
        # contiguous fields
        return halo_reduce(jpad, g, self.spatial_axes,
                           self.periodic).contiguous()

    def seg_particles_sub(self, state: SimulationState, scalars: Dict,
                          stages: FrozenSet[str]) -> SimulationState:
        """One sub-segment of the split particle path (a host callback at
        an inner stage is due; lambdapic_tpu/simulation/step.py::
        seg_particles_sub): the sub-stages ``stages`` of the per-stage
        engine over every species. The deposit sub-stage also runs the
        QED creation and sets J and rho."""
        self._check_layout(state)
        if self.tile_cfg is not None:
            return self._particles_tiled(state, scalars, stages, True)
        f = state.fields
        eb_pad = self.pad_eb(f) if "interp" in stages else None
        jpad = None
        parts = []
        for ispec, p in enumerate(state.particles):
            p, jp = self.species_stages(ispec, p, eb_pad, scalars, stages)
            parts.append(p)
            jpad = _add(jpad, jp)
            self.transients_valid[ispec] = True
        if "deposit" in stages:
            for proc in self.qed_processes:
                parts = self.qed_creation(proc, parts)
            f = f.replace(**_current(self.reduce_j(jpad, f.ex)))
        return state.replace(fields=f, particles=tuple(parts))

    def migrate_scheme(self) -> str:
        """The per-stage engine's re-binning (``cellpallas.migrate_fn``):
        "exact", "fused" (kernel B6 per axis) or, with
        LAMBDAPIC_MIG_FUSED=0, "sort" (the fast scheme sorting through
        kernel B7)."""
        if self.cell_migration == "exact":
            return "exact"
        return "fused" if os.environ.get("LAMBDAPIC_MIG_FUSED", "1") != "0" \
            else "sort"

    def half_push(self, data: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """The first half push of the positions at the stored inv_gamma
        (sub-stage "p1" before its re-binning); a new dict."""
        grid = self.grid
        moms = ("ux", "uy", "uz")[:grid.dimension]
        h = [c_light * self.dt / d / 2 for d in grid.deltas]
        push_pos = push_position_3d if grid.dimension == 3 \
            else push_position_2d
        pos = push_pos(*(data[a] for a in grid.axes),
                       *(data[k] for k in moms), data["inv_gamma"], *h)
        return {**data, **dict(zip(grid.axes, pos))}

    def species_stages(self, ispec: int, p: ParticlesState,
                       eb_pad: Optional[torch.Tensor], scalars: Dict,
                       stages: FrozenSet[str], didx: int = 0,
                       rebinned: bool = False):
        """The per-stage engine for one 2D or 3D species (the non-slab
        cell branch of lambdapic_tpu/simulation/step.py::
        make_species_block), restricted to the sub-stages ``stages``; the
        QED draws of the shard of row-major index ``didx``. ``rebinned``:
        "p1" has run already (a mesh runs it across its shards). Returns
        (particles, the padded (4, nx+2g, ny+2g[, nz+2g]) current or
        None)."""
        grid = self.grid
        nd = grid.dimension
        three_d = nd == 3
        axes = grid.axes
        sp = self.species[ispec]
        dt, g = self.dt, grid.n_guard
        h = [c_light * dt / d / 2 for d in grid.deltas]
        push_pos = push_position_3d if three_d else push_position_2d
        photon = sp.pusher == "photon"
        procs = self._procs(ispec)
        split = stages != ALL_SUBSTAGES
        data, alive = dict(p.data), p.alive
        lost = 0
        if "p1" in stages and not rebinned:
            plan = tuple(zip(grid.shape, self.periodic, axes))
            data, alive, lost = migrate_fn(self.migrate_scheme())(
                self.half_push(data), alive, plan, recompute_ig=not photon)
        key = self._species_key(scalars, ispec, didx) if procs else None
        pos = tuple(data[a] for a in axes)
        if not split and not photon:
            # gather + Boris + half push in kernel B4; a radiating species
            # also gets the gathered fields for its QED events, which read
            # the pre-push momenta still in ``data``
            # B4 pushes the alive slots only and gives the dead ones its
            # dead values (see csrc/push2d.cu, csrc/push3d.cu)
            kw = dict(q=sp.q, m=sp.m, dt=dt, dx=grid.dx, dy=grid.dy, g=g,
                      alive=alive, want_eb=bool(procs), do_pos1=False)
            if three_d:
                outs = fused_push_cell_3d(eb_pad, *pos, data["ux"],
                                          data["uy"], data["uz"],
                                          dz=grid.dz, **kw)
            else:
                outs = fused_push_cell_2d(eb_pad, *pos, data["ux"],
                                          data["uy"], data["uz"], **kw)
            pos, (ux, uy, uz), ig = outs[:nd], outs[nd:nd + 3], outs[nd + 3]
            if procs:
                data.update(zip(EB_PART, outs[nd + 4:]))
                for proc in procs:
                    data, alive = proc.update_chi_and_events(data, alive,
                                                             key, dt)
        else:
            eb = None
            if "interp" in stages:
                # a photon's gathered fields are read only by callbacks
                # of the split step
                if split or not photon:
                    gather = gather_cell_3d if three_d else gather_cell_2d
                    eb = gather(eb_pad, *pos, g)
                    data.update(zip(EB_PART, eb))
            if "qed" in stages:
                for proc in procs:
                    data, alive = proc.update_chi_and_events(data, alive,
                                                             key, dt)
            ux, uy, uz = data["ux"], data["uy"], data["uz"]
            ig = data["inv_gamma"]
            if "mom" in stages:
                if photon:
                    ig = photon_push(ux, uy, uz)
                else:
                    if eb is None:
                        eb = tuple(data[k] for k in EB_PART)
                    ux, uy, uz, ig = boris_push(ux, uy, uz, *eb, sp.q, sp.m,
                                                dt)
            if "p2" in stages:
                pos = push_pos(*pos, *(ux, uy, uz)[:nd], ig, *h)
        data.update(zip(axes, pos))
        data.update(ux=ux, uy=uy, uz=uz, inv_gamma=ig)
        jpad = None
        if sp.q != 0.0 and "deposit" in stages:
            w = torch.where(alive, data["w"], 0.0)
            kw = dict(q=sp.q, dx=grid.dx, dy=grid.dy, dt=dt, g=g,
                      alive=alive)
            if three_d:
                jpad = deposit_cell_3d_k(*pos, ux, uy, uz, ig, w, dz=grid.dz,
                                         **kw)
            else:
                jpad = deposit_cell_2d_k(*pos, ux, uy, uz, ig, w, **kw)
        return p.replace(data=data, alive=alive,
                         overflow=p.overflow + lost), jpad

    def _particles_tiled(self, state: SimulationState, scalars: Dict,
                         stages: FrozenSet[str], migrate: bool
                         ) -> SimulationState:
        """The sub-stages ``stages`` of the tiled engine over every
        species; the deposit sub-stage also runs the QED creation and sets
        J and rho."""
        f = state.fields
        eb_pad = self.pad_eb(f) if "interp" in stages else None
        jpad = None
        parts = []
        for ispec, p in enumerate(state.particles):
            p, jp = self.tiled_stages(ispec, p, eb_pad, scalars, stages,
                                      migrate)
            parts.append(p)
            jpad = _add(jpad, jp)
            self.transients_valid[ispec] = bool(self._procs(ispec)) or \
                stages != ALL_SUBSTAGES
        if "deposit" in stages:
            for proc in self.qed_processes:
                parts = self.qed_creation(proc, parts)
            f = f.replace(**_current(self.reduce_j(jpad, f.ex)))
        return state.replace(fields=f, particles=tuple(parts))

    def tiled_stages(self, ispec: int, p: ParticlesState,
                     eb_pad: Optional[torch.Tensor], scalars: Dict,
                     stages: FrozenSet[str], migrate: bool = True):
        """The tiled engine for one 2D species (the tiled branch of
        lambdapic_tpu/simulation/step.py::make_species_block), restricted
        to the sub-stages ``stages``. Returns (particles, the padded (4,
        nx+2h, ny+2h) current or None)."""
        grid = self.grid
        sp = self.species[ispec]
        dt = self.dt
        cfg = dataclasses.replace(self.tile_cfg, cap_t=p.cap)
        hx, hy = c_light * dt / grid.dx / 2, c_light * dt / grid.dy / 2
        photon = sp.pusher == "photon"
        procs = self._procs(ispec)
        split = stages != ALL_SUBSTAGES
        data, alive = dict(p.data), p.alive
        pos = (data["x"], data["y"])
        if "p1" in stages:
            pos = push_position_2d(*pos, data["ux"], data["uy"],
                                   data["inv_gamma"], hx, hy)
        if "interp" in stages:
            eb = gather_tiled_k(eb_pad, *pos, cfg)
            if procs or split:
                data.update(zip(EB_PART, eb))
        else:
            eb = tuple(data[k] for k in EB_PART)
        if "qed" in stages and procs:
            key = self._species_key(scalars, ispec)
            for proc in procs:
                data, alive = proc.update_chi_and_events(data, alive, key, dt)
        ux, uy, uz = data["ux"], data["uy"], data["uz"]
        ig = data["inv_gamma"]
        if "mom" in stages:
            if photon:
                ig = photon_push(ux, uy, uz)
            else:
                ux, uy, uz, ig = boris_push(ux, uy, uz, *eb, sp.q, sp.m, dt)
        if "p2" in stages:
            pos = push_position_2d(*pos, ux, uy, ig, hx, hy)
        data.update(x=pos[0], y=pos[1], ux=ux, uy=uy, uz=uz, inv_gamma=ig)
        jpad = None
        lost = 0
        if "deposit" in stages:
            if sp.q != 0.0:
                w = torch.where(alive, data["w"], 0.0)
                win = deposit_tiled_k(*pos, ux, uy, uz, ig, w, cfg, q=sp.q,
                                      dx=grid.dx, dy=grid.dy, dt=dt)
                jpad = fold_windows(win, cfg)
            if migrate:
                data, alive, lost = migrate_tiled(
                    data, alive, cfg, self.periodic, grid.nx, grid.ny,
                    recompute_ig=not photon)
        return p.replace(data=data, alive=alive,
                         overflow=p.overflow + lost), jpad

    def qed_creation(self, proc, parts, device_id: Optional[int] = None):
        """Photon birth of one Compton process: each event of the parent
        species adds a photon (the parent's position and weight, momentum
        delta * u) to a dead photon slot of the parent's cell (or tile,
        under tiling), and the parent recoils. Newborns without a free
        slot are counted in the photons' overflow. On a mesh ``device_id``
        is the shard's row-major index, the newborns' id_hi."""
        parts = list(parts)
        e, ph = parts[proc.ispec], parts[proc.photon_ispec]
        ev = e.alive & (e.data["event"] > 0)
        new = proc.photon_newborns(e.data, self.grid.dimension)
        if self.tile_cfg is not None:
            phdata, phalive, phnext, lost = insert_tiled(
                ph.data, ph.alive, ph.next_id, new, ev)
        else:
            phdata, phalive, phnext, lost = insert_cells(
                ph.data, ph.alive, ph.next_id, new, ev, device_id=device_id)
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

    def full_step(self, state: SimulationState, scalars: Dict,
                  migrate: bool = True) -> SimulationState:
        state = self.seg_fields_1(state, scalars)
        state = self.seg_particles(state, scalars, migrate)
        return self.seg_fields_2(state, scalars)


def _add(total: Optional[torch.Tensor], t: Optional[torch.Tensor]):
    if t is None:
        return total
    return t if total is None else total + t


def _current(j: torch.Tensor) -> Dict[str, torch.Tensor]:
    rep = dict(jx=j[0], jy=j[1], jz=j[2])
    if j.shape[0] == 4:
        rep["rho"] = j[3]
    return rep


class MeshStepBuilder:
    """One step of the cell engine on a device mesh (the cell path of
    lambdapic_tpu/simulation/step.py::StepBuilder with a mesh of more
    than one shard), on a MeshState, shard by shard between the
    exchanges:

        seg_fields_1   per shard E += dt/2, then B += dt/2: the plain
                       Yee updates of ops/maxwell.py with the neighbour
                       rows their differences reach (the JAX package runs
                       its XLA fields on a mesh, not kernel B1)
        seg_particles  pad E,B: halo_pad of the six components across the
                       mesh; per species ``cellslab.cell_step_mesh``
                       (kernel B2 per shard and dispatch, the edge columns
                       exchanged in between), panels chained across
                       species per shard:
                         a radiating species: B2 want_chi on the last
                           dispatch, then its QED events per shard with
                           the shard's key (K6)
                         a photon species: B2 photon on every dispatch
                       QED creation per shard (the newborns' id_hi the
                         shard's index, next_id the shard's own)
                       one fold of the summed panels with the strip
                       exchange (kernel B3's mesh form)
        seg_fields_2   B += dt/2 ; lasers (on the shards at the xmin
                       face) ; E += dt/2

    The per-stage engine on a mesh (``cell_migration="exact"`` every
    step, and the split step's ``seg_particles_sub`` when a host callback
    at an inner stage is due): per species the half push and the
    re-binning across the shards (``cellpallas.migrate_cells_mesh``: the
    exact scheme with the neighbours' donors, or kernel B6 with the
    cross-device strips, K7), then the one-device sub-stages per shard
    (``StepBuilder.species_stages``: kernel B4, or the gather, QED, Boris
    and half push; kernel B5 into the shard's padded current), QED
    creation per shard, and the species-summed padded currents folded
    across the mesh by ``halo_reduce``.

    ``n_lost`` adds to each shard's overflow counter; the accessors sum
    them (psum)."""

    def __init__(self, grid: Grid, mesh, cpml: Optional[CPMLCoeffs],
                 dt: float, species: Sequence[SpeciesStatic],
                 lasers: Sequence = (), with_rho: bool = True,
                 qed_processes: Sequence = (),
                 base_key: Optional[torch.Tensor] = None,
                 cell_migration: str = "fast"):
        from ..ops.cpml import shard_cpml
        from ..parallel.halo import halo_specs
        self.grid = grid
        self.mesh = mesh
        self.dt = dt
        self.species = tuple(species)
        self.lasers = tuple(lasers)
        self.with_rho = with_rho
        self.cell_migration = cell_migration
        self.specs = halo_specs(grid)
        self.spatial_axes = tuple(range(1, grid.dimension + 1))
        self.cpmls = [shard_cpml(cpml, grid, mesh.coords(i))
                      for i in range(mesh.size)]
        # the one-device stage of a shard: its sub-stages after the
        # re-binning, its QED events and creation (no fields, no B1)
        self.local = StepBuilder(grid, None, dt, species, with_rho=with_rho,
                                 qed_processes=qed_processes,
                                 base_key=base_key,
                                 cell_migration=cell_migration)
        self.qed_processes = self.local.qed_processes
        self.transients_valid: Dict[int, bool] = {}

    # -- fields ------------------------------------------------------------
    def _edges(self, fs, which: str):
        """Per shard, the neighbour rows the ``which`` ("e" or "b") update
        reads (ops/maxwell.py's E_EDGES / B_EDGES): for E the lower
        neighbour's last row of a B component, for B the upper neighbour's
        first row of an E component; zeros past an open face."""
        from ..ops.maxwell import B_EDGES, E_EDGES
        from ..parallel.mesh import axis_index, ppermute
        nd = self.grid.dimension
        shift = +1 if which == "e" else -1
        out = [{} for _ in fs]
        for name, axis in (E_EDGES if which == "e" else B_EDGES):
            if axis >= nd:
                continue
            spec = self.specs[axis]
            n = getattr(fs[0], name).shape[axis]
            at = n - 1 if which == "e" else 0
            rows = ppermute([getattr(f, name).narrow(axis, at, 1)
                             for f in fs], self.mesh, spec.axis_name, shift)
            edge = 0 if which == "e" else spec.size - 1
            for i, r in enumerate(rows):
                if not spec.periodic and \
                        axis_index(self.mesh, i, spec.axis_name) == edge:
                    r = torch.zeros_like(r)
                out[i][(name, axis)] = r
        return out

    def _half(self, fs, which: str):
        from ..ops.maxwell import update_bfield, update_efield
        fn = update_efield if which == "e" else update_bfield
        edges = self._edges(fs, which)
        return [fn(f, self.grid, self.dt / 2, c, edges=e)
                for f, c, e in zip(fs, self.cpmls, edges)]

    @staticmethod
    def _with_fields(state, fs):
        return state.replace(shards=tuple(
            s.replace(fields=f) for s, f in zip(state.shards, fs)))

    def seg_fields_1(self, state, scalars: Dict):
        fs = [s.fields for s in state.shards]
        return self._with_fields(state, self._half(self._half(fs, "e"), "b"))

    def seg_fields_2(self, state, scalars: Dict):
        fs = self._half([s.fields for s in state.shards], "b")
        for i, laser in enumerate(self.lasers):
            fs = laser.apply_sharded(fs, self.grid, self.dt,
                                     scalars.get(f"laser{i}", {}), self.mesh)
        return self._with_fields(state, self._half(fs, "e"))

    # -- particles ---------------------------------------------------------
    def pad_eb(self, fs):
        """The six E/B components of every shard with n_guard guard cells
        per side, filled from the neighbour shards."""
        eb = [torch.stack([f.ex, f.ey, f.ez, f.bx, f.by, f.bz], dim=0)
              for f in fs]
        return halo_pad(eb, self.grid.n_guard, self.spatial_axes, self.specs,
                        self.mesh)

    def seg_particles(self, state, scalars: Dict):
        if self.cell_migration == "exact":
            return self.seg_particles_sub(state, scalars, ALL_SUBSTAGES)
        grid = self.grid
        shards = state.shards
        fs = [s.fields for s in shards]
        eb_pads = self.pad_eb(fs)
        dz = grid.dz if grid.dimension == 3 else None
        rims = None
        parts = [list(s.particles) for s in shards]
        for ispec, sp in enumerate(self.species):
            self.transients_valid[ispec] = False
            procs = self.local._procs(ispec)
            photon = sp.pusher == "photon"
            outs = cell_step_mesh(
                None if photon else eb_pads,
                [s.particles[ispec].data for s in shards],
                [s.particles[ispec].alive for s in shards], self.mesh,
                self.specs, q=sp.q, m=sp.m, dt=self.dt, dx=grid.dx,
                dy=grid.dy, dz=dz, g=grid.n_guard,
                rims_in=None if photon else rims, with_rho=self.with_rho,
                want_chi=bool(procs), photon=photon)
            for i, o in enumerate(outs):
                data, alive, n_lost = o[:3]
                if procs:
                    chi, ig0 = o[4]
                    key = self.local._species_key(scalars, ispec, i)
                    for proc in procs:
                        data, alive = proc.update_events_from_chi(
                            data, alive, key, self.dt, chi, ig0)
                p = parts[i][ispec]
                parts[i][ispec] = p.replace(data=data, alive=alive,
                                            overflow=p.overflow + n_lost)
            if not photon:
                rims = [o[3] for o in outs]
            del outs
        del eb_pads
        self._create(parts)
        if rims is not None:
            js = fold_reduce(rims, grid.local_shape, None, self.mesh,
                             self.specs)
            fs = [f.replace(**_current(j)) for f, j in zip(fs, js)]
        return state.replace(shards=tuple(
            s.replace(fields=f, particles=tuple(p))
            for s, f, p in zip(shards, fs, parts)))

    def _create(self, parts) -> None:
        """QED creation on every shard (``parts``: a list of species per
        shard, replaced in place), after every species has deposited."""
        for i in range(self.mesh.size):
            for proc in self.qed_processes:
                parts[i] = self.local.qed_creation(proc, parts[i],
                                                   device_id=i)

    def seg_particles_sub(self, state, scalars: Dict,
                          stages: FrozenSet[str]):
        """The sub-stages ``stages`` of the per-stage engine over every
        species and shard (the whole stage of ``cell_migration="exact"``,
        or one sub-segment of the split step); the deposit sub-stage also
        runs the QED creation and sets J and rho."""
        shards = state.shards
        fs = [s.fields for s in shards]
        eb_pads = self.pad_eb(fs) if "interp" in stages else None
        n = self.mesh.size
        jpads = [None] * n
        parts = [list(s.particles) for s in shards]
        for ispec in range(len(self.species)):
            ps = [pp[ispec] for pp in parts]
            if "p1" in stages:
                ps = self._push_rebin(ispec, ps)
            if stages != {"p1"}:
                for i in range(n):
                    ps[i], jp = self.local.species_stages(
                        ispec, ps[i], None if eb_pads is None else eb_pads[i],
                        scalars, stages, didx=i, rebinned=True)
                    jpads[i] = _add(jpads[i], jp)
            for i in range(n):
                parts[i][ispec] = ps[i]
            self.transients_valid[ispec] = stages != ALL_SUBSTAGES or \
                bool(self.local._procs(ispec))
        del eb_pads
        if "deposit" in stages:
            self._create(parts)
            js = self.reduce_j(jpads, fs)
            fs = [f.replace(**_current(j)) for f, j in zip(fs, js)]
        return state.replace(shards=tuple(
            s.replace(fields=f, particles=tuple(p))
            for s, f, p in zip(shards, fs, parts)))

    def _push_rebin(self, ispec: int, ps):
        """Sub-stage "p1" on every shard: StepBuilder.half_push, then the
        re-binning of StepBuilder.migrate_scheme across the shards."""
        outs = migrate_cells_mesh(
            [self.local.half_push(p.data) for p in ps],
            [p.alive for p in ps], self.mesh, self.specs,
            recompute_ig=self.species[ispec].pusher != "photon",
            scheme=self.local.migrate_scheme())
        return [p.replace(data=d, alive=a, overflow=p.overflow + n)
                for p, (d, a, n) in zip(ps, outs)]

    def reduce_j(self, jpads, fs):
        """Per shard the interior current of the species-summed padded
        currents (4, nloc+2g, ...) of the per-stage engine, the guard rims
        folded onto the neighbour shards by ``halo_reduce`` (zeros where no
        species deposited, as on one device)."""
        g = self.grid.n_guard
        shape = (4,) + tuple(n + 2 * g for n in self.grid.local_shape)
        jpads = [torch.zeros(shape, dtype=f.ex.dtype, device=f.ex.device)
                 if j is None else j for j, f in zip(jpads, fs)]
        # halo_reduce leaves views; kernel-free fields take them, but keep
        # the shards' J contiguous as on one device
        return [j.contiguous() for j in halo_reduce(
            jpads, g, self.spatial_axes, self.specs, self.mesh)]

    def full_step(self, state, scalars: Dict, migrate: bool = True):
        if not migrate:
            raise ValueError("the cell engine re-bins every step; "
                             "migrate=False is the tiled engine's")
        state = self.seg_fields_1(state, scalars)
        state = self.seg_particles(state, scalars)
        return self.seg_fields_2(state, scalars)
