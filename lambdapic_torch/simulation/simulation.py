"""The Simulation and Simulation3D entry points: the cell engine in 2D
and 3D and the tiled 2D engine on one device, and the cell engine on a
device mesh (counterpart of a subset of
lambdapic_tpu/simulation/simulation.py).

The public surface mirrors the JAX package: construct with grid,
boundary and timing parameters, add Species, call ``run()`` with
callbacks. The state lives on ``device`` (default "cuda"; pass
device="cpu" to run the plain PyTorch versions of the kernels).
``npatch_x/npatch_y[/npatch_z]`` split the grid over a mesh of devices,
``initialize(devices=...)`` names them (one process drives every shard,
and a list may repeat a device: ``[torch.device("cpu")] * 4`` runs a
2 x 2 mesh on the CPU, ``[torch.device("cuda", 0)] * 4`` on one card);
npatch 0 takes one patch per visible card (``parallel/mesh.py::
auto_patches``). Options the port does not have yet raise
NotImplementedError naming the ROADMAP item that will bring them.
"""
from __future__ import annotations

import dataclasses
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
from ..core.state import (ID_KEYS, MeshState, SimulationState,
                          cell_particles, ids_to_numpy, zeros_fields)
from ..ops.cell2d import deposit_cell_2d
from ..ops.cell3d import deposit_cell_3d
from ..ops.cpml import CPMLParams, build_cpml, shard_cpml
from ..ops.tiled2d import TileCfg, fold_windows
from ..ops.tiled2d_kernels import deposit_tiled_k
from ..parallel import mesh as pmesh
from ..parallel.distributed import split_blocks, to_host
from ..parallel.halo import halo_reduce, halo_specs
from .callbacks import INNER_SUBSTAGES, SimulationCallbacks
from .initfill import (bin_cells, bin_tiled, count_macro_particles,
                       distribute_global_particles, fill_species, grow_minor,
                       pick_capacity)
from .step import MeshStepBuilder, SpeciesStatic, StepBuilder

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
    """2D PIC simulation, cell engine (``tiling="cell"``, on one device or
    a device mesh) or tiled engine (``tiling=(TX, TY)`` with
    ``rebin_interval``, one device).

    Parameters mirror lambdapic_tpu.Simulation. ``device``: "cuda"
    (default) or "cpu".

    Arguments of the JAX Simulation that the ported engines never read are
    accepted and validated, so a user script ports unchanged:
    ``migration_buffer`` (the scatter engine's buffer) and, for the cell
    engine, ``recap_threshold`` (the tiled engine's occupancy trigger;
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
        # a SimulationState, or on a device mesh a MeshState
        self.state = None
        self.mesh: Optional[pmesh.Mesh] = None
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

    @property
    def _tiled(self) -> bool:
        return self.tiling is not None and self.tiling != "cell"

    def _check_supported(self):
        if self.tiling is None:
            raise _todo("tiling=None (the scatter engine)", "12")
        if self._tiled:
            t = self.tiling
            if not (isinstance(t, (tuple, list)) and len(t) == 2 and all(
                    isinstance(v, int) and not isinstance(v, bool) and v > 0
                    for v in t)):
                raise ValueError("tiling must be 'cell', None or a pair of "
                                 f"positive ints (TX, TY), got {t!r}")
            if self.dimension != 2:
                raise NotImplementedError(
                    "tiling=(TX, TY) is 2D-only, as in lambdapic_tpu (ROADMAP "
                    "queue 1, item 13 ported the 2D tiled engine)")
        if self.cell_migration not in ("fast", "exact"):
            raise ValueError(f"cell_migration must be 'fast' or 'exact', got "
                             f"{self.cell_migration!r}")
        if not self._tiled and self.rebin_interval != 1:
            raise NotImplementedError(
                "cell binning re-bins every step (rebin_interval=1)")
        if isinstance(self.rebin_interval, bool) or not isinstance(
                self.rebin_interval, int) or self.rebin_interval < 1:
            raise ValueError("rebin_interval must be an int >= 1, got "
                             f"{self.rebin_interval!r}")
        if self.step_chunk not in ("auto", 1):
            raise _todo("multi-step chunking (step_chunk)", "16")
        if self.tiling_backend != "auto":
            raise _todo(f"tiling_backend={self.tiling_backend!r} (a forced "
                        "backend; the port picks its CUDA kernels on a card "
                        "and their plain versions on the CPU)", "13")
        if self.enable_timer:
            raise _todo("enable_timer (utils/timer.py)", "6")
        for sp in self.species:
            if isinstance(sp, Photon) and sp.has_qed:
                raise _todo(f"Breit-Wheeler pair production (photon species "
                            f"{sp.name})", "9")
            if sp.has_spin:
                raise _todo(f"spin (species {sp.name})", "9")
            if sp.pusher not in ("boris", "photon"):
                raise _todo(f"pusher {sp.pusher!r} (species {sp.name})", "9")

    def _check_mesh_supported(self):
        """What runs on a device mesh: the cell engine, fused or per-stage
        (``cell_migration="exact"``, inner-stage callbacks), with QED
        photon emission; the tiled engine waits for ROADMAP item 15d
        (Breit-Wheeler and spin, refused everywhere, for item 9)."""
        if self._tiled:
            raise _todo("tiling=(TX, TY) on a device mesh (the tiled "
                        "engine's cross-device tile slabs)", "15d")

    def _auto_patch(self, devices):
        """npatch 0: one patch per device of ``devices`` (default every
        visible CUDA card, or one CPU)."""
        axes = ("x", "y", "z")[: self.dimension]
        if all(getattr(self, "npatch_" + ax) for ax in axes):
            return
        if devices is not None:
            n = len(devices)
        elif self.device.type == "cuda":
            n = torch.cuda.device_count()
        else:
            n = 1
        shape = pmesh.auto_patches(self.nx, self.ny, getattr(self, "nz", None)
                                   if self.dimension == 3 else None,
                                   n_devices=max(n, 1))
        for ax, p in zip(axes, shape):
            setattr(self, "npatch_" + ax, p)
        logger.info(f"Auto patches: {shape}")

    def _make_grid(self) -> Grid:
        extra = {}
        if self.dimension == 3:
            extra = dict(nz=self.nz, dz=self.dz, npatch_z=self.npatch_z)
        g = Grid(dimension=self.dimension, nx=self.nx, ny=self.ny,
                 dx=self.dx, dy=self.dy, npatch_x=self.npatch_x,
                 npatch_y=self.npatch_y,
                 n_guard=self.n_guard, cpml_thickness=self.cpml_thickness,
                 boundary_conditions=tuple(
                     sorted(self.boundary_conditions.items())), **extra)
        g.validate()
        if self._tiled:
            self._validate_tiling(g)
        elif g.n_guard < 2:
            raise ValueError("cell binning needs n_guard >= 2 (the "
                             "post-rebin deposit stencil spans +-2)")
        return g

    def _validate_tiling(self, g: Grid):
        """The tiled engine's constraints (lambdapic_tpu Simulation.
        _validate_tiling): tiles divide the grid, TX and TY >= 2 n_guard,
        and the tile halo covers the drift of rebin_interval steps."""
        tx, ty = self.tiling
        if g.nx_loc % tx or g.ny_loc % ty:
            raise ValueError(
                f"per-device grid ({g.nx_loc}x{g.ny_loc}) must be divisible "
                f"by the tile size ({tx}x{ty})")
        if tx < 2 * g.n_guard or ty < 2 * g.n_guard:
            raise ValueError("tile size must be >= 2*n_guard")
        if self.rebin_interval > 1:
            max_cdt = c_light * self.dt / min(self.dx, self.dy)
            need = 2 + math.ceil(self.rebin_interval * max_cdt - 1e-12)
            if g.n_guard < need:
                raise ValueError(
                    f"rebin_interval={self.rebin_interval} needs n_guard >="
                    f" {need} (tile halo must cover the accumulated CFL "
                    f"drift); got {g.n_guard}")

    def _tile_cfg(self) -> Optional[TileCfg]:
        """The tiling of the tiled engine (cap_t is each species' own),
        None for the cell engine."""
        if not self._tiled:
            return None
        tx, ty = self.tiling
        return TileCfg(tx=tx, ty=ty, ntx=self.grid.nx // tx,
                       nty=self.grid.ny // ty, cap_t=0, h=self.grid.n_guard)

    def _bin(self, arrays, counts, cap_floor: Optional[int]):
        """Bin flat per-device arrays into the engine's slot layout, the
        slot axis at least ``cap_floor`` long (a Species(capacity=) or the
        present capacity). Returns (arrays of every device under leading
        mesh axes, alive, slots)."""
        if self._tiled:
            arrays, alive_np, cap = bin_tiled(
                arrays, counts, self.grid, *self.tiling,
                factor=self.particle_capacity_factor)
            if cap_floor is not None and cap_floor > cap:
                old, cap = cap, cap_floor
                arrays = {k: grow_minor(v, cap) for k, v in arrays.items()}
                arrays["inv_gamma"][..., old:] = 1.0
                alive_np = grow_minor(alive_np, cap)
        else:
            arrays, alive_np, cap = bin_cells(
                arrays, counts, self.grid,
                factor=self.particle_capacity_factor, cap_c=cap_floor)
        return arrays, alive_np, cap

    def _particles(self, sp, arrays, alive_np):
        """One species' ParticlesState of every shard (a list, or the one
        device's state) from binned host arrays under mesh axes."""
        out = []
        for i, dev in enumerate(self._devices):
            c = np.unravel_index(i, self.grid.mesh_shape)
            out.append(cell_particles(sp, {k: v[c] for k, v in
                                           arrays.items()}, alive_np[c],
                                      self.dtype, dev, tiled=self._tiled,
                                      shard=i))
        return out if self.mesh is not None else out[0]

    @property
    def _devices(self):
        return self.mesh.devices if self.mesh is not None else (self.device,)

    def _shards(self) -> List[SimulationState]:
        """The state of every shard (the one device's state alone)."""
        if self.mesh is None:
            return [self.state]
        return list(self.state.shards)

    def _set_shards(self, shards) -> None:
        self.state = MeshState(shards=tuple(shards)) \
            if self.mesh is not None else shards[0]

    def initialize(self, devices=None):
        """Build grid, mesh, fields and cell- or tile-binned particles.
        ``devices``: the mesh's devices, one per patch, row-major (may
        repeat a device); default every visible CUDA card, or the
        Simulation's device for a one-patch run."""
        self._add_default_species_if_empty()
        self._check_supported()
        self._auto_patch(devices)
        self.grid = self._make_grid()
        self.mesh = None
        if self.grid.n_shards > 1:
            self._check_mesh_supported()
            self.mesh = pmesh.make_mesh(self.grid, devices)
            for d in self.mesh.devices:
                if d.type != self.device.type:
                    raise ValueError(f"mesh device {d} is not a "
                                     f"{self.device.type} device, as the "
                                     "Simulation's device is")
        elif devices is not None:
            self.device = resolve_device(pmesh.make_mesh(
                self.grid, devices).devices[0])
        logger.info(f"Domain: {self.grid.shape} cells, mesh "
                    f"{self.grid.mesh_shape} on "
                    f"{sorted(set(map(str, self._devices)))}, "
                    f"dt={self.dt:.3e}s")
        any_pml = any(v == "pml" for v in self.grid.bc.values())
        self.cpml = build_cpml(self.grid, self.dt,
                               CPMLParams(thickness=self.cpml_thickness)) \
            if any_pml else None
        if self.mesh is None:
            fields = [zeros_fields(self.grid, self.dtype, self.device,
                                   self.cpml)]
        else:
            fields = [zeros_fields(self.grid, self.dtype, dev,
                                   shard_cpml(self.cpml, self.grid,
                                              self.mesh.coords(i)),
                                   shape=self.grid.local_shape)
                      for i, dev in enumerate(self.mesh.devices)]
        parts = []
        self._species_static = []
        for ispec, sp in enumerate(self.species):
            counts = count_macro_particles(self.grid, sp)
            cap = pick_capacity(counts, self.particle_capacity_factor)
            if sp.capacity is not None:
                cap = max(cap, int(np.ceil(sp.capacity / 128) * 128))
            arrays, counts = fill_species(self.grid, sp, self._seed_effective,
                                          ispec, cap)
            # Species(capacity=): a per-device floor, spread uniformly over
            # the cells (or tiles)
            floor = None
            if sp.capacity is not None and self._tiled:
                ntiles = (self.grid.nx // self.tiling[0]) * (
                    self.grid.ny // self.tiling[1])
                floor = int(np.ceil(sp.capacity / ntiles / 128) * 128)
            elif sp.capacity is not None:
                floor = max(4, int(np.ceil(
                    sp.capacity / int(np.prod(self.grid.local_shape)) / 2)
                    * 2))
            arrays, alive_np, cap_c = self._bin(arrays, counts, floor)
            parts.append(self._particles(sp, arrays, alive_np))
            self._species_static.append(SpeciesStatic(
                name=sp.name, q=sp.q, m=sp.m, pusher=sp.pusher, cap=cap_c))
            logger.info(f"Species {sp.name}: {int(counts.sum()):,} macro "
                        f"particles, {cap_c} slots per "
                        + ("tile" if self._tiled else "cell"))
        if self.mesh is None:
            self.state = SimulationState(fields=fields[0],
                                         particles=tuple(parts))
        else:
            self.state = MeshState(shards=tuple(
                SimulationState(fields=f, particles=tuple(p[i] for p in parts))
                for i, f in enumerate(fields)))
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
        if self.mesh is not None:
            self._builder = MeshStepBuilder(
                self.grid, self.mesh, self.cpml, self.dt,
                self._species_static, lasers, with_rho=self._with_rho,
                qed_processes=self._qed_processes, base_key=self._base_key,
                cell_migration=self.cell_migration)
            self._builder.transients_valid.update(fresh)
            return
        self._builder = StepBuilder(
            self.grid, self.cpml, self.dt, self._species_static, lasers,
            with_rho=self._with_rho, dtype=self.dtype, device=self.device,
            qed_processes=self._qed_processes, base_key=self._base_key,
            cell_migration=self.cell_migration, tile_cfg=self._tile_cfg())
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
                # the tiled engine re-bins on the last step of each block
                # of rebin_interval steps (the segmented and split steps
                # always re-bin: early re-binning is always safe)
                R = self.rebin_interval
                self.state = builder.full_step(
                    self.state, sc, migrate=self.itime % R == R - 1)
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
        for dev in set(self._devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- re-capacity ------------------------------------------------------
    def _maybe_recap(self):
        """Grow a species' slots a cell (or a tile) 1.5x or to the
        occupancy plus four intervals' influx. The cell engine grows under
        sustained merge pressure (more than 0.5% of its population merged
        since the last check; single hot cells reaching capacity are left
        to the weight-conserving merges); the tiled engine on any loss, or
        before the fullest tile's occupancy plus twice the last interval's
        influx passes ``recap_threshold`` of the capacity. On a mesh the
        counts are summed over the shards and every shard grows to one
        capacity."""
        grew = False
        for ispec in range(len(self.species)):
            ps = [sh.particles[ispec] for sh in self._shards()]
            cap = self._species_static[ispec].cap
            ov = sum(int(p.overflow) for p in ps)
            per_slot = [p.alive.sum(dim=p.slot_axis, dtype=torch.int32)
                        for p in ps]
            occ = max(int(t.max()) for t in per_slot)
            total = sum(int(t.sum()) for t in per_slot)
            influx = max(0, occ - self._occ_seen.get(ispec, 0))
            self._occ_seen[ispec] = occ
            new_ov = ov - self._overflow_seen.get(ispec, 0)
            if self._tiled:
                trigger = new_ov > 0 or \
                    occ + 2 * influx > self.recap_threshold * cap
            else:
                trigger = new_ov > 0.005 * max(total, 1)
            if new_ov > 0:
                self._overflow_seen[ispec] = ov
                log = logger.warning if trigger else logger.debug
                verb = "lost" if self._tiled else "merged"
                log(f"species {self.species[ispec].name}: {new_ov} particles "
                    f"{verb} (occupancy {occ}/{cap}, alive {total})")
            if trigger:
                grew |= self._grow_capacity(
                    ispec, max(int(math.ceil(cap * 1.5)),
                               occ + 4 * max(influx, 1)))
        if grew:
            self._build_stepper(getattr(self, "_active_lasers", []))

    def _grow_capacity(self, ispec: int, new_cap: int) -> bool:
        """Pad the slot axis (the first for cells, the last for tiles) with
        dead slots (inv_gamma 1, everything else 0), on every shard. Slot
        order within a cell or tile carries no physics, so the state is
        unchanged. Returns whether the capacity grew."""
        shards = self._shards()
        old = shards[0].particles[ispec].cap
        new_cap = int(new_cap) + (int(new_cap) & 1)   # keep it even
        if new_cap <= old:
            return False
        out = []
        for sh in shards:
            p = sh.particles[ispec]
            axis = p.slot_axis

            def pad(t, fill):
                shape = list(t.shape)
                shape[axis] = new_cap - old
                extra = torch.full(shape, fill, dtype=t.dtype,
                                   device=t.device)
                return torch.cat([t, extra], dim=axis)

            data = {k: pad(v, 1 if k == "inv_gamma" else 0)
                    for k, v in p.data.items()}
            parts = list(sh.particles)
            parts[ispec] = p.replace(data=data, alive=pad(p.alive, False))
            out.append(sh.replace(particles=tuple(parts)))
        self._set_shards(out)
        self._species_static[ispec] = dataclasses.replace(
            self._species_static[ispec], cap=new_cap)
        logger.info(f"species {self.species[ispec].name}: capacity grown "
                    f"{old} -> {new_cap} (slot axis "
                    f"{shards[0].particles[ispec].slot_axis})")
        return True

    def _check_overflow(self):
        """Warn when a species' cumulative merge count has advanced."""
        for ispec in range(len(self.species)):
            ov = sum(int(sh.particles[ispec].overflow)
                     for sh in self._shards())
            if ov > self._loss_reported.get(ispec, 0):
                self._loss_reported[ispec] = ov
                if self._tiled:
                    logger.warning(
                        f"species {self.species[ispec].name}: {ov} "
                        "particles lost so far (cumulative) to tile "
                        "capacity overflow; increase "
                        "particle_capacity_factor")
                else:
                    logger.warning(
                        f"species {self.species[ispec].name}: {ov} particle "
                        "merges so far (cumulative) from per-cell capacity "
                        "pressure (charge/momentum conserved)")

    # -- data access ----------------------------------------------------
    def _padded_rho(self, sh: SimulationState):
        """The species-summed padded current of one shard's particles at
        their current positions, through the plain deposit (None when no
        species is charged)."""
        g = self.grid.n_guard
        jtot = None
        for sp, p in zip(self._species_static, sh.particles):
            if sp.q == 0.0:
                continue
            d = p.data
            if self._tiled:
                cfg = dataclasses.replace(self._tile_cfg(), cap_t=p.cap)
                j4 = fold_windows(deposit_tiled_k(
                    d["x"], d["y"], d["ux"], d["uy"], d["uz"],
                    d["inv_gamma"], d["w"], p.alive, cfg, q=sp.q, dx=self.dx,
                    dy=self.dy, dt=self.dt), cfg)
                jtot = j4 if jtot is None else jtot + j4
                continue
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
        return jtot

    def total_rho(self):
        """Charge density of all charged species at the current
        positions, through the plain deposit (used when the hot loop
        runs without the rho deposit); on a mesh a list of the shards'."""
        g = self.grid.n_guard
        axes = tuple(range(1, self.dimension + 1))
        js = [self._padded_rho(sh) for sh in self._shards()]
        if js[0] is None:
            out = [torch.zeros(self.grid.local_shape, dtype=self.dtype,
                               device=dev) for dev in self._devices]
        elif self.mesh is None:
            out = [halo_reduce(js[0], g, axes, self.grid.periodic_axes)[3]]
        else:
            out = [j[3] for j in halo_reduce(js, g, axes,
                                             halo_specs(self.grid),
                                             self.mesh)]
        return out if self.mesh is not None else out[0]

    def get_field(self, name: str) -> np.ndarray:
        """Host copy of a field (assembled from the shards on a mesh).
        When the hot loop runs without the rho deposit, rho is recomputed
        from the current particles."""
        if name == "rho" and not getattr(self, "_with_rho", True):
            t = self.total_rho()
        elif self.mesh is None:
            t = getattr(self.state.fields, name)
        else:
            t = [getattr(sh.fields, name) for sh in self.state.shards]
        if self.mesh is None:
            return t.cpu().numpy()
        return to_host(t, self.mesh, 0)

    def set_field(self, name: str, value) -> None:
        """Replace one field with ``value`` (the grid's shape), cast to
        the run's type on its device (cut into the shards on a mesh)."""
        value = np.asarray(value)
        if tuple(value.shape) != tuple(self.grid.shape):
            raise ValueError(f"set_field {name}: shape {tuple(value.shape)}, "
                             f"expected {tuple(self.grid.shape)}")
        blocks = [value] if self.mesh is None else \
            split_blocks(value, self.mesh)
        out = []
        for sh, blk, dev in zip(self._shards(), blocks, self._devices):
            t = torch.as_tensor(np.array(blk), dtype=self.dtype).to(dev)
            out.append(sh.replace(fields=sh.fields.replace(**{name: t})))
        self._set_shards(out)

    def get_particles(self, ispec: int) -> Dict[str, np.ndarray]:
        """Host copies of one species' alive particles, flattened shard by
        shard (row-major over the mesh): positions in global SI metres
        (a shard's local cell units plus its offset, wrapped into the box
        along periodic axes, as stored positions may trail the mid-step
        re-binning by up to half a cell), ids as uint32. The gathered-field
        slots (``*_part``) are exposed only where the last step filled
        them: after a split step, and for a radiating species of the
        per-stage engine."""
        fresh = self._builder is not None and \
            self._builder.transients_valid.get(ispec, False)
        cols: Dict[str, list] = {}
        for i, sh in enumerate(self._shards()):
            p = sh.particles[ispec]
            alive = p.alive.reshape(-1).cpu().numpy()
            off = np.unravel_index(i, self.grid.mesh_shape)
            for k, v in p.data.items():
                if k.endswith("_part") and not fresh:
                    continue
                a = ids_to_numpy(v) if k in ID_KEYS else v.cpu().numpy()
                a = a.reshape(-1)
                if k in self.grid.axes:
                    ax = self.grid.axes.index(k)
                    d = self.grid.deltas[ax]
                    nloc = self.grid.local_shape[ax]
                    a = (a + off[ax] * nloc) * d
                    if self.grid.periodic(k):
                        L = self.grid.shape[ax] * d
                        a = (a + 0.5 * d) % L - 0.5 * d
                cols.setdefault(k, []).append(a[alive])
        return {k: np.concatenate(v) for k, v in cols.items()}

    def set_particles_global(self, ispec: int,
                             coords_si: Dict[str, np.ndarray],
                             attrs: Dict[str, np.ndarray]) -> None:
        """Replace one species' population by the particles given (SI
        positions in ``coords_si``, other arrays in ``attrs``), each on the
        shard that holds it, binned into cells (or tiles); ids restart at
        the flat slot index (id_hi the shard's). Capacity floors: the
        species' present capacity, and 8 slots a cell; QED children follow
        their parent's."""
        if not self.initialized:
            raise RuntimeError("set_particles_global needs an initialised "
                               "Simulation (call initialize() first)")
        sp = self.species[ispec]
        st = self._species_static[ispec]
        arrays, counts, _ = distribute_global_particles(
            self.grid, sp, coords_si, attrs,
            factor=self.particle_capacity_factor)
        floor = st.cap if self._tiled else max(st.cap, 8)
        arrays, alive_np, cap_c = self._bin(arrays, counts, floor)
        if cap_c != st.cap:
            self._species_static[ispec] = dataclasses.replace(st, cap=cap_c)
        new = self._particles(sp, arrays, alive_np)
        new = new if self.mesh is not None else [new]
        out = []
        for sh, p in zip(self._shards(), new):
            parts = list(sh.particles)
            parts[ispec] = p
            out.append(sh.replace(particles=tuple(parts)))
        self._set_shards(out)
        self._sync_qed_child_caps()
        self._builder = None

    @property
    def npart_alive(self) -> List[int]:
        return [sum(int(sh.particles[ispec].alive.sum())
                    for sh in self._shards())
                for ispec in range(len(self.species))]

    def load_imbalance(self) -> float:
        """(max - min) / mean of the shards' alive-particle counts (the
        JAX package's metric; the mesh is static, so imbalance is reported
        for the user to act on, not rebalanced)."""
        per = np.array([sum(int(p.alive.sum()) for p in sh.particles)
                        for sh in self._shards()], dtype=np.float64)
        mean = per.mean()
        if mean == 0:
            return 0.0
        return float((per.max() - per.min()) / mean)


@dataclass
class Simulation3D(Simulation):
    """3D PIC simulation, cell engine, on one device or a device mesh
    (counterpart of lambdapic_tpu.Simulation3D)."""

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
