"""Static grid geometry, 2D and 3D (counterpart of lambdapic_tpu/core/grid.py).

The global grid is split into ``npatch_x x npatch_y (x npatch_z)``
shards of ``nx_loc x ny_loc (x nz_loc)`` cells, one per device of the
mesh (``parallel/mesh.py``); a one-device run is the 1 x 1 (x 1) mesh.
Coordinate conventions are the JAX package's: cell centres of the global
grid sit at ``i*dx``, and particle positions are stored in units of the
cell size, relative to the shard's origin (local cell centres at
0..nx_loc-1, shard [-0.5, nx_loc-0.5)), so float32 positions keep ~1e-4
cells whatever the shard's place in the domain.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class Grid:
    """Static geometry shared by all operators."""

    dimension: int
    nx: int
    ny: int
    dx: float
    dy: float
    npatch_x: int
    npatch_y: int
    n_guard: int
    cpml_thickness: int
    boundary_conditions: Tuple[Tuple[str, str], ...]  # (name, 'pml'|'periodic')
    nz: int = 1
    dz: float = 1.0
    npatch_z: int = 1

    @property
    def bc(self) -> Dict[str, str]:
        return dict(self.boundary_conditions)

    @property
    def nx_loc(self) -> int:
        return self.nx // self.npatch_x

    @property
    def ny_loc(self) -> int:
        return self.ny // self.npatch_y

    @property
    def nz_loc(self) -> int:
        return self.nz // self.npatch_z

    @property
    def Lx(self) -> float:
        return self.nx * self.dx

    @property
    def Ly(self) -> float:
        return self.ny * self.dy

    @property
    def Lz(self) -> float:
        return self.nz * self.dz

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The mesh axis names, ('px', 'py'[, 'pz'])."""
        return ("px", "py", "pz")[: self.dimension]

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return (self.nx_loc, self.ny_loc, self.nz_loc)[: self.dimension]

    @property
    def n_shards(self) -> int:
        n = 1
        for p in self.mesh_shape:
            n *= p
        return n

    @property
    def axes(self) -> str:
        """The spatial axis names, "xy" or "xyz"."""
        return "xyz"[: self.dimension]

    def periodic(self, axis: str) -> bool:
        return self.bc.get(axis + "min", "pml") == "periodic"

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.nx, self.ny, self.nz)[: self.dimension]

    @property
    def deltas(self) -> Tuple[float, ...]:
        return (self.dx, self.dy, self.dz)[: self.dimension]

    @property
    def periodic_axes(self) -> Tuple[bool, ...]:
        return tuple(self.periodic(ax) for ax in self.axes)

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        return (self.npatch_x, self.npatch_y, self.npatch_z)[: self.dimension]

    def validate(self):
        if self.dimension not in (2, 3):
            raise ValueError(f"dimension must be 2 or 3, got {self.dimension}")
        if self.nx % self.npatch_x:
            raise ValueError(
                f"nx ({self.nx}) must be divisible by npatch_x ({self.npatch_x})")
        if self.ny % self.npatch_y:
            raise ValueError(
                f"ny ({self.ny}) must be divisible by npatch_y ({self.npatch_y})")
        if self.dimension == 3 and self.nz % self.npatch_z:
            raise ValueError(
                f"nz ({self.nz}) must be divisible by npatch_z ({self.npatch_z})")
        for n_loc, name in ((self.nx_loc, "x"), (self.ny_loc, "y"),
                            (self.nz_loc, "z"))[: self.dimension]:
            if n_loc < self.n_guard:
                raise ValueError(
                    f"per-device n{name} ({n_loc}) must be >= n_guard "
                    f"({self.n_guard})")
        for (bname, kind) in self.boundary_conditions:
            if kind not in ("pml", "periodic"):
                raise ValueError(f"unsupported boundary {bname}={kind}")
        for ax in self.axes:
            kinds = {self.bc.get(ax + "min"), self.bc.get(ax + "max")}
            if "periodic" in kinds and len(kinds) > 1:
                raise ValueError(
                    f"{ax}: periodic boundary must be set on both sides")
