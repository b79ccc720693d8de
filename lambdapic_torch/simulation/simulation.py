"""The Simulation and Simulation3D entry points, cell engine on one device
(counterpart of a subset of lambdapic_tpu/simulation/simulation.py).

The public surface mirrors the JAX package: construct with grid,
boundary and timing parameters, add Species, call ``run()`` with
callbacks. The state lives on ``device`` (default "cuda"; pass
device="cpu" to run the plain PyTorch versions of the kernels). Options
the port does not have yet raise NotImplementedError naming the ROADMAP
item that will bring them.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import random as jr
from ..constants import c as c_light
from ..core.grid import Grid
from ..core.species import Electron, Photon, Species, _ALL_SPECIES
from ..core.state import (ID_KEYS, SimulationState, cell_particles,
                          ids_to_numpy, zeros_fields)
from ..ops.cell2d import deposit_cell_2d
from ..ops.cell3d import deposit_cell_3d
from ..ops.cpml import CPMLParams, build_cpml
from ..parallel.halo import halo_reduce
from .callbacks import INNER_SUBSTAGES, SimulationCallbacks
from .initfill import (bin_cells, count_macro_particles, fill_species,
                       pick_capacity)
from .step import SpeciesStatic, StepBuilder

logger = logging.getLogger("lambdapic_torch")


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to lambdapic_torch yet (ROADMAP queue 1, "
        f"item {item})")


def resolve_device(device) -> torch.device:
    """The device a Simulation runs on: CUDA unless the caller asks for
    the CPU. There is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lambdapic_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _validate_config(s: "Simulation") -> None:
    """The JAX package's SimulationConfig checks, written out."""
    def positive(name, strict=True, integer=False):
        v = getattr(s, name)
        if integer and (isinstance(v, bool) or not isinstance(v, int)):
            raise ValueError(f"{name} must be an integer, got {v!r}")
        if not isinstance(v, (int, float)) or (v <= 0 if strict else v < 0):
            raise ValueError(f"{name} must be {'>' if strict else '>='} 0, "
                             f"got {v!r}")

    three_d = s.dimension == 3
    for name in ("nx", "ny", "n_guard", "cpml_thickness") + \
            (("nz",) if three_d else ()):
        positive(name, integer=True)
    for name in ("dx", "dy") + (("dz",) if three_d else ()):
        positive(name)
    for name in ("npatch_x", "npatch_y") + (("npatch_z",) if three_d else ()):
        positive(name, strict=False, integer=True)
    if s.migration_buffer is not None:
        positive("migration_buffer", integer=True)
    if not isinstance(s.enable_timer, bool):
        raise ValueError(f"enable_timer must be a bool, got {s.enable_timer!r}")
    if s.tiling_backend not in ("auto", "pallas", "xla"):
        raise ValueError("tiling_backend must be 'auto', 'pallas' or 'xla', "
                         f"got {s.tiling_backend!r}")
    if not 0 < s.recap_threshold <= 1:
        raise ValueError(f"recap_threshold must be in (0, 1], got "
                         f"{s.recap_threshold!r}")
    if s.nsteps is not None:
        positive("nsteps", integer=True)
    if s.sim_time is not None:
        positive("sim_time")
    if not 0 < s.dt_cfl <= 1:
        raise ValueError(f"dt_cfl must be in (0, 1], got {s.dt_cfl!r}")
    if s.precision not in ("single", "double"):
        raise ValueError(f"precision must be 'single' or 'double', got "
                         f"{s.precision!r}")
    if not s.particle_capacity_factor > 1.0:
        raise ValueError("particle_capacity_factor must be > 1")
    if s.nsteps is not None and s.sim_time is not None:
        raise ValueError(
            "Cannot specify both nsteps and sim_time. Use only one.")


@dataclass
class Simulation:
    """2D PIC simulation on one device, cell engine.

    Parameters mirror lambdapic_tpu.Simulation. ``device``: "cuda"
    (default) or "cpu". Only ``tiling="cell"`` is ported.

    Arguments of the JAX Simulation that the cell engine never reads are
    accepted and validated, so a user script ports unchanged:
    ``migration_buffer`` (the scatter engine's buffer) and
    ``recap_threshold`` (the scatter and tiled engines' occupancy trigger;
    cell-mode re-capacity goes by merge pressure). ``tiling_backend`` must
    stay "auto" (CUDA kernels on a card, their plain versions on the CPU),
    and ``enable_timer=True`` waits for the timer utilities.
    """

    nx: int
    ny: int
    dx: float
    dy: float
    npatch_x: int = 0
    npatch_y: int = 0
    nsteps: Optional[int] = None
    sim_time: Optional[float] = None
    dt_cfl: float = 0.95
    n_guard: int = 3
    boundary_conditions: Optional[Dict[str, str]] = None
    cpml_thickness: int = 6
    log_file: Optional[str] = None
    truncate_log: bool = True
    enable_timer: bool = False
    random_seed: Optional[int] = None
    precision: str = "single"
    particle_capacity_factor: float = 2.0
    migration_buffer: Optional[int] = None
    tiling: Optional[object] = None
    tiling_backend: str = "auto"
    rebin_interval: int = 1
    cell_migration: str = "fast"
    deposit_rho: object = "auto"
    step_chunk: object = "auto"
    recap_interval: int = 10
    recap_threshold: float = 0.75
    device: Optional[object] = None

    dimension = 2

    def __post_init__(self):
        if self.boundary_conditions is None:
            self.boundary_conditions = {"xmin": "pml", "xmax": "pml",
                                        "ymin": "pml", "ymax": "pml"}
        _validate_config(self)
        self.device = resolve_device(self.device)
        if self.log_file is not None:
            handler = logging.FileHandler(
                self.log_file, mode="w" if self.truncate_log else "a")
            logger.addHandler(handler)
        # dt from CFL
        inv2 = self.dx**-2 + self.dy**-2
        if self.dimension == 3:
            inv2 += self.dz**-2
        self.dt = self.dt_cfl * inv2**-0.5 / c_light

        self.species: List[Species] = []
        self.itime = 0
        self.time = 0.0
        self.initialized = False
        self.state: Optional[SimulationState] = None
        if self.random_seed is not None:
            self._seed_effective = int(self.random_seed)
        else:
            self._seed_effective = int(
                np.random.SeedSequence().generate_state(1)[0])
        # the base key of the in-step draws (QED), kept on the CPU
        self._base_key = jr.PRNGKey(self._seed_effective)
        self._qed_processes: list = []
        self._overflow_seen: Dict[int, int] = {}
        self._occ_seen: Dict[int, int] = {}
        self._loss_reported: Dict[int, int] = {}
        self._builder: Optional[StepBuilder] = None

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.precision == "double" else torch.float32

    @property
    def Lx(self):
        return self.nx * self.dx

    @property
    def Ly(self):
        return self.ny * self.dy

    def add_species(self, species: Sequence[Species]):
        for s in species:
            if not isinstance(s, Species):
                raise TypeError(f"not a Species: {s!r}")
            if s not in self.species:
                s.ispec = len(self.species)
                self.species.append(s)
        return self

    def _add_default_species_if_empty(self):
        if self.species:
            return
        compatible = [s for s in _ALL_SPECIES if s.is_compatible(self.dimension)]
        if compatible:
            logger.info(f"Auto-adding {len(compatible)} species created in "
                        f"script: {[s.name for s in compatible]}")
            self.add_species(compatible)

    def _check_supported(self):
        if self.tiling != "cell":
            raise _todo(f"tiling={self.tiling!r} (the scatter and tiled "
                        "engines)", "12 and 13")
        if self.cell_migration not in ("fast", "exact"):
            raise ValueError(f"cell_migration must be 'fast' or 'exact', got "
                             f"{self.cell_migration!r}")
        if self.rebin_interval != 1:
            raise NotImplementedError(
                "cell binning re-bins every step (rebin_interval=1)")
        if self.step_chunk not in ("auto", 1):
            raise _todo("multi-step chunking (step_chunk)", "16")
        if self.tiling_backend != "auto":
            raise _todo(f"tiling_backend={self.tiling_backend!r} (a forced "
                        "backend; the port picks its CUDA kernels on a card "
                        "and their plain versions on the CPU)", "13")
        if self.enable_timer:
            raise _todo("enable_timer (utils/timer.py)", "6")
        if any(getattr(self, "npatch_" + ax, 0) not in (0, 1)
               for ax in "xyz"[: self.dimension]):
            raise _todo("device meshes (npatch_x/npatch_y/npatch_z > 1)", "15")
        for sp in self.species:
            if isinstance(sp, Photon) and sp.has_qed:
                raise _todo(f"Breit-Wheeler pair production (photon species "
                            f"{sp.name})", "9")
            if sp.has_spin:
                raise _todo(f"spin (species {sp.name})", "9")
            if sp.pusher not in ("boris", "photon"):
                raise _todo(f"pusher {sp.pusher!r} (species {sp.name})", "9")

    def _make_grid(self) -> Grid:
        extra = {}
        if self.dimension == 3:
            extra = dict(nz=self.nz, dz=self.dz, npatch_z=1)
        g = Grid(dimension=self.dimension, nx=self.nx, ny=self.ny,
                 dx=self.dx, dy=self.dy, npatch_x=1, npatch_y=1,
                 n_guard=self.n_guard, cpml_thickness=self.cpml_thickness,
                 boundary_conditions=tuple(
                     sorted(self.boundary_conditions.items())), **extra)
        g.validate()
        if g.n_guard < 2:
            raise ValueError("cell binning needs n_guard >= 2 (the "
                             "post-rebin deposit stencil spans +-2)")
        return g

    def initialize(self):
        """Build grid, fields and cell-binned particles."""
        self._add_default_species_if_empty()
        self._check_supported()
        self.npatch_x = self.npatch_y = 1
        if self.dimension == 3:
            self.npatch_z = 1
        self.grid = self._make_grid()
        logger.info(f"Domain: {self.grid.shape} cells on {self.device}, "
                    f"dt={self.dt:.3e}s")
        any_pml = any(v == "pml" for v in self.grid.bc.values())
        self.cpml = build_cpml(self.grid, self.dt,
                               CPMLParams(thickness=self.cpml_thickness)) \
            if any_pml else None
        fields = zeros_fields(self.grid, self.dtype, self.device, self.cpml)
        parts = []
        self._species_static = []
        for ispec, sp in enumerate(self.species):
            counts = count_macro_particles(self.grid, sp)
            cap = pick_capacity(counts, self.particle_capacity_factor)
            if sp.capacity is not None:
                cap = max(cap, int(np.ceil(sp.capacity / 128) * 128))
            arrays, counts = fill_species(self.grid, sp, self._seed_effective,
                                          ispec, cap)
            cap_c = None
            if sp.capacity is not None:
                cap_c = max(4, int(np.ceil(
                    sp.capacity / int(np.prod(self.grid.shape)) / 2) * 2))
            arrays, alive_np, cap_c = bin_cells(
                arrays, counts, self.grid,
                factor=self.particle_capacity_factor, cap_c=cap_c)
            dev0 = (0,) * self.dimension       # the one-device mesh
            arrays = {k: v[dev0] for k, v in arrays.items()}
            parts.append(cell_particles(sp, arrays, alive_np[dev0],
                                        self.dtype, self.device))
            self._species_static.append(SpeciesStatic(
                name=sp.name, q=sp.q, m=sp.m, pusher=sp.pusher, cap=cap_c))
            logger.info(f"Species {sp.name}: {int(counts.sum()):,} macro "
                        f"particles, {cap_c} slots per cell")
        self.state = SimulationState(fields=fields, particles=tuple(parts))
        self._loss_reported.clear()
        self._overflow_seen.clear()
        self._occ_seen.clear()
        self._init_qed()
        self._sync_qed_child_caps()
        self.initialized = True

    def _init_qed(self):
        """The QED processes of the species' wiring: a radiating electron
        with a photon species emits into it (nonlinear Compton)."""
        from ..models.qed import NonlinearComptonLCFA
        self._qed_processes = []
        for sp in self.species:
            if isinstance(sp, Electron):
                if sp.radiation == "photons" and sp.photon is not None:
                    if sp.photon not in self.species:
                        raise ValueError(
                            f"species {sp.name} emits into {sp.photon.name}, "
                            "which was not added to the Simulation")
                    self._qed_processes.append(NonlinearComptonLCFA(
                        sp.ispec, sp.photon.ispec, self.dtype))
                elif sp.radiation == "ll":
                    logger.warning(
                        "continuous (LL) radiation is a stub (as in the "
                        "reference, radiation.py:240-276); ignored")
        if self._qed_processes:
            logger.info(f"QED processes: {len(self._qed_processes)}")

    def _sync_qed_child_caps(self):
        """Floor each QED child species' capacity (the photons of a
        radiating electron) at its parent's: newborns arrive in bursts that
        scale with the parent population, before any re-capacity can see
        them."""
        for proc in self._qed_processes:
            pcap = self._species_static[proc.ispec].cap
            if self._species_static[proc.photon_ispec].cap < pcap:
                self._grow_capacity(proc.photon_ispec, pcap)

    def _build_stepper(self, lasers):
        fresh = self._builder.transients_valid if self._builder else {}
        self._builder = StepBuilder(
            self.grid, self.cpml, self.dt, self._species_static, lasers,
            with_rho=self._with_rho, dtype=self.dtype, device=self.device,
            qed_processes=self._qed_processes, base_key=self._base_key,
            cell_migration=self.cell_migration)
        self._builder.transients_valid.update(fresh)

    def _scalars(self, lasers) -> dict:
        sc = {f"laser{i}": laser.host_scalars(self)
              for i, laser in enumerate(lasers)}
        sc["itime"] = self.itime
        return sc

    def _handle_nsteps(self, nsteps, sim_time):
        if nsteps is not None and sim_time is not None:
            raise ValueError("Cannot specify both nsteps and sim_time")
        if nsteps is None and sim_time is None:
            if self.nsteps is not None:
                return self.nsteps
            if self.sim_time is not None:
                return int(self.sim_time / self.dt)
            raise ValueError("Must provide either nsteps or sim_time")
        if sim_time is not None:
            return int(sim_time / self.dt)
        return nsteps + self.itime

    def _resolve_deposit_rho(self, callbacks) -> bool:
        """"auto" keeps the every-step rho deposit unless every callback
        is rho-free."""
        v = self.deposit_rho
        if v == "auto":
            return not all(getattr(cb, "rho_free", False) for cb in callbacks)
        return bool(v)

    def run(self, nsteps: Optional[int] = None,
            sim_time: Optional[float] = None,
            callbacks: Optional[Sequence] = None, stop_callback=None):
        """Main loop: one step at a time, host callbacks between the
        step's segments. On a step where a callback at an inner stage is
        due, the particle stage splits into its sub-segments
        (``callbacks.INNER_SUBSTAGES``) with the callbacks of each stage
        run right after it; other steps keep the fused path."""
        callbacks = list(callbacks or [])
        if not self.initialized:
            self.initialize()
        lasers = [cb for cb in callbacks
                  if getattr(cb, "is_device_callback", False)]
        cbs = SimulationCallbacks(callbacks, self)
        with_rho = self._resolve_deposit_rho(callbacks)
        if self._builder is None or \
                getattr(self, "_active_lasers", None) != lasers or \
                getattr(self, "_with_rho", None) != with_rho:
            self._active_lasers = lasers
            self._with_rho = with_rho
            self._build_stepper(lasers)
        builder = self._builder
        nsteps_total = self._handle_nsteps(nsteps, sim_time)

        cbs.run("init")
        while self.itime < nsteps_total:
            self.istep = self.itime
            cbs.run("start")
            sc = self._scalars(lasers)
            split = any(cbs.due(st) for _, st in INNER_SUBSTAGES if st)
            if not (split or cbs.due("maxwell_1")
                    or cbs.due("current_deposition")
                    or cbs.due("qed_create_particles")):
                self.state = builder.full_step(self.state, sc)
            else:
                self.state = builder.seg_fields_1(self.state, sc)
                cbs.run("maxwell_1")
                if split:
                    # one sub-segment per stage; its callbacks may read and
                    # replace self.state before the next
                    for sub, stage in INNER_SUBSTAGES:
                        self.state = builder.seg_particles_sub(
                            self.state, sc, frozenset((sub,)))
                        if stage is not None:
                            cbs.run(stage)
                else:
                    self.state = builder.seg_particles(self.state, sc)
                cbs.run("current_deposition")
                cbs.run("qed_create_particles")
                self.state = builder.seg_fields_2(self.state, sc)
            cbs.run("maxwell_2")
            cbs.run("end")
            self.time += self.dt
            self.itime += 1
            if self.recap_interval and self.itime % self.recap_interval == 0:
                self._maybe_recap()
            if stop_callback is not None and stop_callback():
                return "stop by callback"
        self._sync()
        self._check_overflow()
        cbs.run("final")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- cell-mode re-capacity ------------------------------------------
    def _maybe_recap(self):
        """Grow a species' per-cell capacity 1.5x under sustained merge
        pressure (more than 0.5% of its population merged since the last
        check); single hot cells reaching capacity are left to the
        weight-conserving merges."""
        grew = False
        for ispec, p in enumerate(self.state.particles):
            cap = self._species_static[ispec].cap
            ov = int(p.overflow)
            per_cell = p.alive.sum(dim=0, dtype=torch.int32)
            occ, total = int(per_cell.max()), int(per_cell.sum())
            influx = max(0, occ - self._occ_seen.get(ispec, 0))
            self._occ_seen[ispec] = occ
            new_ov = ov - self._overflow_seen.get(ispec, 0)
            trigger = new_ov > 0.005 * max(total, 1)
            if new_ov > 0:
                self._overflow_seen[ispec] = ov
                log = logger.warning if trigger else logger.debug
                log(f"species {self.species[ispec].name}: {new_ov} particles "
                    f"merged (occupancy {occ}/{cap}, alive {total})")
            if trigger:
                grew |= self._grow_capacity(
                    ispec, max(int(math.ceil(cap * 1.5)),
                               occ + 4 * max(influx, 1)))
        if grew:
            self._build_stepper(getattr(self, "_active_lasers", []))

    def _grow_capacity(self, ispec: int, new_cap: int) -> bool:
        """Pad the slot axis with dead slots (inv_gamma 1, everything else
        0). Slot order within a cell carries no physics, so the state is
        unchanged. Returns whether the capacity grew."""
        import dataclasses
        p = self.state.particles[ispec]
        old = p.cap
        new_cap = int(new_cap) + (int(new_cap) & 1)   # keep it even
        if new_cap <= old:
            return False

        def pad(t, fill):
            extra = torch.full((new_cap - old,) + tuple(t.shape[1:]), fill,
                               dtype=t.dtype, device=t.device)
            return torch.cat([t, extra], dim=0)

        data = {k: pad(v, 1 if k == "inv_gamma" else 0)
                for k, v in p.data.items()}
        parts = list(self.state.particles)
        parts[ispec] = p.replace(data=data, alive=pad(p.alive, False))
        self.state = self.state.replace(particles=tuple(parts))
        self._species_static[ispec] = dataclasses.replace(
            self._species_static[ispec], cap=new_cap)
        logger.info(f"species {self.species[ispec].name}: capacity grown "
                    f"{old} -> {new_cap}")
        return True

    def _check_overflow(self):
        """Warn when a species' cumulative merge count has advanced."""
        for ispec, p in enumerate(self.state.particles):
            ov = int(p.overflow)
            if ov > self._loss_reported.get(ispec, 0):
                self._loss_reported[ispec] = ov
                logger.warning(
                    f"species {self.species[ispec].name}: {ov} particle "
                    "merges so far (cumulative) from per-cell capacity "
                    "pressure (charge/momentum conserved)")

    # -- data access ----------------------------------------------------
    def total_rho(self) -> torch.Tensor:
        """Charge density of all charged species at the current
        positions, through the plain deposit (used when the hot loop
        runs without the rho deposit)."""
        g = self.grid.n_guard
        jtot = None
        for sp, p in zip(self._species_static, self.state.particles):
            if sp.q == 0.0:
                continue
            d = p.data
            w = torch.where(p.alive, d["w"], 0.0)
            if self.dimension == 2:
                j4 = deposit_cell_2d(d["x"], d["y"], d["ux"], d["uy"],
                                     d["uz"], d["inv_gamma"], w, q=sp.q,
                                     dx=self.dx, dy=self.dy, dt=self.dt, g=g)
            else:
                j4 = deposit_cell_3d(d["x"], d["y"], d["z"], d["ux"],
                                     d["uy"], d["uz"], d["inv_gamma"], w,
                                     q=sp.q, dx=self.dx, dy=self.dy,
                                     dz=self.dz, dt=self.dt, g=g)
            jtot = j4 if jtot is None else jtot + j4
        if jtot is None:
            return torch.zeros(self.grid.shape, dtype=self.dtype,
                               device=self.device)
        return halo_reduce(jtot, g, tuple(range(1, self.dimension + 1)),
                           self.grid.periodic_axes)[3]

    def get_field(self, name: str) -> np.ndarray:
        """Host copy of a field. When the hot loop runs without the rho
        deposit, rho is recomputed from the current particles."""
        if name == "rho" and not getattr(self, "_with_rho", True):
            return self.total_rho().cpu().numpy()
        return getattr(self.state.fields, name).cpu().numpy()

    def set_field(self, name: str, value) -> None:
        """Replace one field with ``value`` (the grid's shape), cast to
        the run's type on its device."""
        f = self.state.fields
        old = getattr(f, name)
        t = torch.as_tensor(np.asarray(value), dtype=self.dtype).to(
            self.device)
        if tuple(t.shape) != tuple(old.shape):
            raise ValueError(f"set_field {name}: shape {tuple(t.shape)}, "
                             f"expected {tuple(old.shape)}")
        self.state = self.state.replace(fields=f.replace(**{name: t}))

    def get_particles(self, ispec: int) -> Dict[str, np.ndarray]:
        """Host copies of one species' alive particles, flattened:
        positions in SI metres (wrapped into the box along periodic axes,
        as stored positions may trail the mid-step re-binning by up to half
        a cell), ids as uint32. The gathered-field slots (``*_part``) are
        exposed only where the last step filled them: after a split step,
        and for a radiating species of the per-stage engine."""
        p = self.state.particles[ispec]
        alive = p.alive.reshape(-1).cpu().numpy()
        fresh = self._builder is not None and \
            self._builder.transients_valid.get(ispec, False)
        out = {}
        for k, v in p.data.items():
            if k.endswith("_part") and not fresh:
                continue
            a = ids_to_numpy(v) if k in ID_KEYS else v.cpu().numpy()
            a = a.reshape(-1)
            if k in self.grid.axes:
                ax = self.grid.axes.index(k)
                d = self.grid.deltas[ax]
                a = a * d
                if self.grid.periodic(k):
                    L = self.grid.shape[ax] * d
                    a = (a + 0.5 * d) % L - 0.5 * d
            out[k] = a[alive]
        return out

    def set_particles_global(self, ispec: int,
                             coords_si: Dict[str, np.ndarray],
                             attrs: Dict[str, np.ndarray]) -> None:
        """Replace one species' population by the particles given (SI
        positions in ``coords_si``, other arrays in ``attrs``), binned
        into cells; ids restart at the flat slot index. Capacity floors:
        the species' present capacity and 8; QED children follow their
        parent's."""
        import dataclasses
        if not self.initialized:
            raise RuntimeError("set_particles_global needs an initialised "
                               "Simulation (call initialize() first)")
        sp = self.species[ispec]
        st = self._species_static[ispec]
        # flat arrays of the one device (mesh_shape + (n,)), positions in
        # cell units, as bin_cells takes them
        lead = self.grid.mesh_shape
        n = len(np.asarray(coords_si[self.grid.axes[0]]))
        arrays = {a: np.zeros(lead + (n,)) for a in sp.attrs()}
        arrays["inv_gamma"][...] = 1.0
        for k, v in attrs.items():
            if k in arrays:
                arrays[k][...] = np.asarray(v)
        for ax, d in zip(self.grid.axes, self.grid.deltas):
            arrays[ax][...] = np.asarray(coords_si[ax]) / d
        arrays, alive_np, cap_c = bin_cells(
            arrays, np.full(lead, n), self.grid,
            factor=self.particle_capacity_factor, cap_c=max(st.cap, 8))
        if cap_c != st.cap:
            self._species_static[ispec] = dataclasses.replace(st, cap=cap_c)
        dev0 = (0,) * self.dimension
        arrays = {k: v[dev0] for k, v in arrays.items()}
        parts = list(self.state.particles)
        parts[ispec] = cell_particles(sp, arrays, alive_np[dev0], self.dtype,
                                      self.device)
        self.state = self.state.replace(particles=tuple(parts))
        self._sync_qed_child_caps()
        self._builder = None

    @property
    def npart_alive(self) -> List[int]:
        return [int(p.alive.sum()) for p in self.state.particles]


@dataclass
class Simulation3D(Simulation):
    """3D PIC simulation on one device, cell engine (counterpart of
    lambdapic_tpu.Simulation3D)."""

    nz: int = 0
    dz: float = 0.0
    npatch_z: int = 0

    dimension = 3

    def __post_init__(self):
        if self.nz <= 0 or self.dz <= 0:
            raise ValueError("Simulation3D requires nz and dz")
        if self.boundary_conditions is None:
            self.boundary_conditions = {
                "xmin": "pml", "xmax": "pml", "ymin": "pml", "ymax": "pml",
                "zmin": "pml", "zmax": "pml"}
        super().__post_init__()

    @property
    def Lz(self):
        return self.nz * self.dz

    @property
    def nz_per_patch(self):
        return self.grid.nz_loc


Simulation2D = Simulation
