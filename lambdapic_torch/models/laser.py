"""Laser injection through an absorbing source plane, 2D and 3D
(counterpart of lambdapic_tpu/models/laser.py).

Lasers act at stage ``_laser`` (between the second B half-step and the
final E half-step) and write bx/by/bz one column (in 3D one y-z plane)
behind the source plane at x index ``cpml_thickness + 2`` with a radiating-boundary update.
Quantities that need float64 time precision (the carrier phase) are
computed on the host each step as float32 scalars (``host_scalars``), as
the JAX package passes them; transverse profiles are built once in
float64 and rounded to the field type.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from scipy.special import factorial, genlaguerre

from ..constants import c, e, epsilon_0, m_e, pi
from ..core.grid import Grid
from ..core.state import FieldsState
from ..ops.shifts import shift
from ..simulation.callbacks import DeviceCallback


def _t(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float64) if not np.isscalar(v)
                           else float(v), dtype=like.dtype).to(like.device)


class Laser(DeviceCallback):
    """Base laser."""

    stage = "_laser"

    def __init__(self) -> None:
        self.disabled = False
        self.side = "xmin"
        self.tstop = np.inf           # in c*t units
        self.y0: Optional[float] = None
        self.z0: Optional[float] = None

    def host_scalars(self, sim) -> dict:
        """Per-step scalars: on/off gate and carrier phase (float64 host
        math, float32 values)."""
        time = sim.time
        on = 1.0
        if self.disabled or c * time >= self.tstop:
            self.disabled = True
            on = 0.0
        return {"on": np.float32(on), **self._host_scalars(time)}

    def _host_scalars(self, time: float) -> dict:
        raise NotImplementedError

    def _sources(self, grid: Grid, sc: dict, like: torch.Tensor):
        """(ey_source, ez_source) on the boundary plane, each (ny,) or
        (ny, nz)."""
        raise NotImplementedError

    def _boundary_coords(self, grid: Grid):
        """(y, z, r) on the injection plane, centred on (y0, z0)."""
        y0 = self.y0 if self.y0 is not None else grid.Ly / 2
        ys = np.arange(grid.ny) * grid.dy - grid.dy / 2 - y0
        if grid.dimension == 2:
            return ys, 0.0, np.abs(ys)
        z0 = self.z0 if self.z0 is not None else grid.Lz / 2
        zs = np.arange(grid.nz) * grid.dz - grid.dz / 2 - z0
        Y, Z = np.meshgrid(ys, zs, indexing="ij")
        return Y, Z, np.sqrt(Y**2 + Z**2)

    def _transverse_mask(self, grid: Grid) -> np.ndarray:
        """Exclude the y (and z) PML slabs."""
        t = grid.cpml_thickness
        bc = grid.bc
        my = np.ones(grid.ny, dtype=bool)
        if bc.get("ymin") == "pml":
            my[:t] = False
        if bc.get("ymax") == "pml":
            my[grid.ny - t:] = False
        if grid.dimension == 2:
            return my
        mz = np.ones(grid.nz, dtype=bool)
        if bc.get("zmin") == "pml":
            mz[:t] = False
        if bc.get("zmax") == "pml":
            mz[grid.nz - t:] = False
        return my[:, None] & mz[None, :]

    def apply(self, f: FieldsState, grid: Grid, dt: float, sc: dict
              ) -> FieldsState:
        """Radiating-boundary source update. The update reads the tail
        guard cell left of the domain, which is zero on a PML xmin
        boundary, written here as an explicit 0."""
        col = grid.cpml_thickness + 2
        ey_src, ez_src = self._sources(grid, sc, f.ey)
        on = _t(sc["on"], f.ey)
        mask = torch.as_tensor(self._transverse_mask(grid)).to(f.ey.device)
        cdt_dx = c * dt / grid.dx
        den = 1.0 / ((cdt_dx + 1.0) * c)
        per_y = grid.periodic("y")

        bx_col = f.bx[col]
        dbx_y = (bx_col - shift(bx_col, 0, -1, per_y)) / grid.dy
        if grid.dimension == 2:
            bz_new = den * (
                4.0 * ey_src
                + 2.0 * (f.ey[0] + c * 0.5 * f.bz[0])
                - 2.0 * f.ey[col]
                + (dt / epsilon_0) * f.jy[col]
                + (cdt_dx - 1.0) * c * f.bz[col]
            )
        else:
            dbx_z = (bx_col - shift(bx_col, 1, -1, grid.periodic("z"))
                     ) / grid.dz
            bz_new = den * (
                4.0 * ey_src
                + 2.0 * (f.ey[0] + c * 0.5 * f.bz[0])
                - 2.0 * f.ey[col]
                - (dt * c**2) * dbx_z
                + (dt / epsilon_0) * f.jy[col]
                + (cdt_dx - 1.0) * c * f.bz[col]
            )
        by_new = den * (
            - 4.0 * ez_src
            - 2.0 * (f.ez[0] - c * 0.5 * f.by[0])
            + 2.0 * f.ez[col]
            - (dt * c**2) * dbx_y
            - (dt / epsilon_0) * f.jz[col]
            + (cdt_dx - 1.0) * c * f.by[col]
        )
        bx_new = f.bx[0]

        sel = mask & (on > 0)
        out = {}
        for name, new in (("bz", bz_new), ("by", by_new), ("bx", bx_new)):
            arr = getattr(f, name).clone()
            arr[col - 1] = torch.where(sel, new, arr[col - 1])
            out[name] = arr
        return f.replace(**out)

    def apply_sharded(self, fields, grid: Grid, dt: float, sc: dict, mesh):
        """``apply`` on a sharded run (a list of shard-local FieldsState on
        ``mesh``): the x rows 0 .. col of the shards at the xmin face are
        joined into one strip of the global transverse extent, ``apply``
        updates its row col - 1, and the shards take their parts back,
        bit for bit the global update. The source plane must lie in the
        first x shard."""
        col = grid.cpml_thickness + 2
        if col >= grid.nx_loc:
            raise ValueError(
                f"laser source plane (x index {col}) lies beyond the first x "
                f"shard ({grid.nx_loc} cells); use fewer x patches")
        face = [i for i in range(mesh.size) if mesh.coords(i)[0] == 0]
        names = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")
        dev = mesh.devices[face[0]]

        def strip(name):
            blocks = {mesh.coords(i)[1:]: getattr(fields[i], name)[:col + 1]
                      .to(dev) for i in face}
            rows = []
            for jy in range(mesh.shape[1]):
                if grid.dimension == 2:
                    rows.append(blocks[(jy,)])
                else:
                    rows.append(torch.cat([blocks[(jy, kz)] for kz in
                                           range(mesh.shape[2])], dim=2))
            return torch.cat(rows, dim=1)

        strip_f = fields[face[0]].replace(
            **{n: strip(n) for n in names}, psi={})
        new = self.apply(strip_f, grid, dt, sc)
        out = list(fields)
        for i in face:
            c = mesh.coords(i)
            sl = [slice(c[k] * n, (c[k] + 1) * n)
                  for k, n in enumerate(grid.local_shape)][1:]
            upd = {}
            for name in ("bz", "by", "bx"):
                arr = getattr(fields[i], name).clone()
                arr[col - 1] = getattr(new, name)[(col - 1,) + tuple(sl)].to(
                    arr.device)
                upd[name] = arr
            out[i] = fields[i].replace(**upd)
        return out

    def __add__(self, other):
        """Compose two lasers of one side into one source."""
        if not isinstance(other, Laser):
            raise TypeError(f"Cannot add Laser with {type(other)}")
        if self.side != other.side:
            raise TypeError("Cannot add lasers from different sides")
        return _CombinedLaser(self, other)


class _CombinedLaser(Laser):
    """Sum of two laser sources."""

    def __init__(self, laser1: Laser, laser2: Laser):
        super().__init__()
        self.laser1 = laser1
        self.laser2 = laser2
        self.side = laser1.side
        self.tstop = max(laser1.tstop, laser2.tstop)

    def host_scalars(self, sim) -> dict:
        s1 = self.laser1.host_scalars(sim)
        s2 = self.laser2.host_scalars(sim)
        on = np.float32(max(float(s1["on"]), float(s2["on"])))
        if self.laser1.disabled and self.laser2.disabled:
            self.disabled = True
            on = np.float32(0.0)
        return {"on": on, "s1": s1, "s2": s2}

    def _sources(self, grid, sc, like):
        ey1, ez1 = self.laser1._sources(grid, sc["s1"], like)
        ey2, ez2 = self.laser2._sources(grid, sc["s2"], like)
        on1 = _t(sc["s1"]["on"], like)
        on2 = _t(sc["s2"]["on"], like)
        return on1 * ey1 + on2 * ey2, on1 * ez1 + on2 * ez2


def _ellipticity_split(ellipticity: float):
    """Cycle-averaged-intensity-conserving major/minor amplitudes."""
    norm = math.sqrt(1 + ellipticity**2)
    return 1.0 / norm, ellipticity / norm


class SimpleLaser(Laser):
    """sin^2-envelope laser with a Gaussian transverse profile."""

    def __init__(self, a0: float, w0: float, ctau: float,
                 y0: Optional[float] = None, z0: Optional[float] = None,
                 angle_y: float = 0.0, angle_z: float = 0.0,
                 tstop: Optional[float] = None, pol_angle: float = 0.0,
                 ellipticity: float = 0.0, cep: float = 0.0,
                 l0: float = 0.8e-6, side: str = "xmin"):
        super().__init__()
        if any(p <= 0 for p in [a0, l0, w0, ctau]):
            raise ValueError("All parameters (a0, l0, w0, ctau) must be positive")
        if side != "xmin":
            raise NotImplementedError("Invalid side: only 'xmin' is supported.")
        if abs(angle_y) >= pi / 2:
            raise ValueError("Angle_y must be in range (-pi/2, pi/2)")
        if angle_z != 0:
            raise NotImplementedError("Angle_z is not implemented")
        if abs(ellipticity) > 1:
            raise ValueError("Ellipticity must be in range [-1, 1]")
        self.a0 = a0
        self.l0 = l0
        self.omega0 = 2 * pi * c / l0
        self.w0 = w0
        self.ctau = ctau
        self.y0 = y0
        self.z0 = z0
        self.angle_y = angle_y
        self.angle_z = angle_z
        self.tstop = 2 * ctau if tstop is None else c * tstop
        self.E0 = a0 * m_e * c * self.omega0 / e
        self.pol_angle = pol_angle
        self.ellipticity = ellipticity
        self.cep = cep
        self.side = side
        self.k0 = self.omega0 / c
        self.ky = self.k0 * math.sin(angle_y)
        self.kz = 0.0

    def _host_scalars(self, time: float) -> dict:
        return {
            "ct": np.float32(c * time),
            "phase0": np.float32(math.fmod(self.omega0 * time + self.cep,
                                           2 * pi)),
        }

    def _sources(self, grid, sc, like):
        y, z, r = self._boundary_coords(grid)
        r_rot = np.sqrt((y / math.cos(self.angle_y))**2 + np.square(z))
        transverse_phase = -(self.ky * y + self.kz * np.asarray(z))
        amp_static = _t(self.E0 * np.exp(-r_rot**2 / self.w0**2), like)
        tphase = _t(transverse_phase, like)
        y_t = _t(y, like)

        ct = _t(sc["ct"], like)
        t_rot = ct - y_t * math.sin(self.angle_y)
        tprof = torch.sin(t_rot / (2 * self.ctau) * pi)**2 * (
            t_rot < 2 * self.ctau)
        amp = amp_static * tprof
        phase = _t(sc["phase0"], like) + tphase

        major, minor = _ellipticity_split(self.ellipticity)
        cp, sp = math.cos(self.pol_angle), math.sin(self.pol_angle)
        ey = amp * (major * cp * torch.sin(phase)
                    - minor * sp * torch.cos(phase)) * math.cos(self.angle_y)
        ez = amp * (major * sp * torch.sin(phase)
                    + minor * cp * torch.cos(phase)) * math.cos(self.angle_z)
        return ey, ez


class SimpleLaser2D(SimpleLaser):
    ...


class SimpleLaser3D(SimpleLaser):
    ...


class GaussianLaser(Laser):
    """Gaussian beam with waist evolution, Gouy phase, curvature and
    Laguerre-Gaussian modes."""

    def __init__(self, a0: float, l0: float, w0: float, ctau: float,
                 x0: Optional[float] = None, y0: Optional[float] = None,
                 z0: Optional[float] = None, tstop: Optional[float] = None,
                 pol_angle: float = 0.0, ellipticity: float = 0.0,
                 cep: float = 0.0, focus_position: float = 0.0,
                 side: str = "xmin", l: int = 0, p: int = 0):
        super().__init__()
        if any(par <= 0 for par in [a0, l0, w0, ctau]):
            raise ValueError("All parameters (a0, l0, w0, ctau) must be positive")
        if side != "xmin":
            raise ValueError("Invalid side: only 'xmin' is implemented.")
        if abs(ellipticity) > 1:
            raise ValueError("Ellipticity must be in range [-1, 1]")
        if not isinstance(p, int) or p < 0:
            raise ValueError("Number of radial nodes p must be a non-negative integer")
        if not isinstance(l, int):
            raise ValueError("Azimuthal index l must be an integer")
        self.a0 = a0
        self.l0 = l0
        self.omega0 = 2 * pi * c / l0
        self.k0 = self.omega0 / c
        self.w0 = w0
        self.ctau = ctau
        self.x0 = 3 * ctau if x0 is None else x0
        self.y0 = y0
        self.z0 = z0
        self.tstop = 6 * ctau if tstop is None else c * tstop
        self.E0 = a0 * m_e * c * self.omega0 / e
        self.pol_angle = pol_angle
        self.ellipticity = ellipticity
        self.cep = cep
        self.focus_position = focus_position
        self.side = side
        self.zR = pi * w0**2 / l0
        self._is_lg = False
        self.l = l
        self.p = p
        if l != 0 or p > 0:
            self._is_lg = True
            self.lg_norm = math.sqrt(
                2 * factorial(p) / (pi * factorial(p + abs(l))))
            self.lg_norm /= math.sqrt(2 / pi)
            self.laguerre = genlaguerre(p, abs(l))

    def _gaussian_beam_params(self, z):
        """(w, R, psi) at distance z from the focus."""
        z = z - self.focus_position
        w = self.w0 * math.sqrt(1 + (z / self.zR)**2)
        R = z * (1 + (self.zR / z)**2) if abs(z) > 1e-10 else math.inf
        psi = math.atan(z / self.zR)
        return w, R, psi

    def _host_scalars(self, time: float) -> dict:
        tprof = math.exp(-((c * time - self.x0)**2) / self.ctau**2)
        return {
            "tprof": np.float32(tprof),
            "phase0": np.float32(math.fmod(self.omega0 * time + self.cep,
                                           2 * pi)),
        }

    def _sources(self, grid, sc, like):
        y, z, r = self._boundary_coords(grid)
        x_rel = grid.cpml_thickness * grid.dx
        bw, bR, bpsi = self._gaussian_beam_params(x_rel)
        if self._is_lg:
            phi = np.arctan2(np.asarray(z) if grid.dimension == 3 else 0.0, y)
            rr = np.sqrt(2) * r / bw
            amp_lg = self.lg_norm * rr**abs(self.l) * self.laguerre(rr**2)
            phase_lg = self.l * phi
        else:
            amp_lg = 1.0
            phase_lg = 0.0
        amp_static = self.E0 * (self.w0 / bw) * np.exp(-r**2 / bw**2) * amp_lg
        phase_static = (- self.k0 * x_rel
                        - self.k0 * r**2 / (2 * bR)
                        - (2 * self.p + abs(self.l) + 1) * bpsi
                        - phase_lg)
        amp_static = _t(amp_static, like)
        phase_static = _t(np.mod(phase_static, 2 * pi), like)

        amp = amp_static * _t(sc["tprof"], like)
        phase = _t(sc["phase0"], like) + phase_static

        major, minor = _ellipticity_split(self.ellipticity)
        cp, sp = math.cos(self.pol_angle), math.sin(self.pol_angle)
        ey = amp * (major * cp * torch.sin(phase) - minor * sp * torch.cos(phase))
        ez = amp * (major * sp * torch.sin(phase) + minor * cp * torch.cos(phase))
        return ey, ez


class GaussianLaser2D(GaussianLaser):
    ...


class GaussianLaser3D(GaussianLaser):
    ...
