"""Convolutional PML coefficients (counterpart of lambdapic_tpu/ops/cpml.py).

Global 1D coefficient profiles (kappa, b, c per axis, for the E- and
B-staggered positions) are identity (kappa=1, b=1, c=0) outside the PML
slabs. Grading: m=3, ma=1, sigma_max_val = sigma_max * c * 0.8 * (m+1) / d,
kappa = 1 + (kappa_max-1) pos^m, sigma = sigma_max_val pos^m,
a = a_max (1-pos)^ma, with integer positions for E and half-integer for
B, and the xmax B slab shifted one cell inward. Host numpy, float64.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..constants import c as c_light
from ..core.grid import Grid


@dataclass(frozen=True)
class CPMLParams:
    thickness: int = 6
    kappa_max: float = 20.0
    a_max: float = 0.15
    sigma_max: float = 0.7
    m: int = 3
    ma: int = 1


def _face_profiles(n: int, d: float, dt: float, p: CPMLParams,
                   lo: bool, hi: bool):
    """(kappa_e, b_e, c_e, kappa_b, b_b, c_b), float64 arrays of length n;
    c includes the 1/d factor."""
    t = p.thickness
    kappa_e = np.ones(n)
    sigma_e = np.zeros(n)
    a_e = np.zeros(n)
    kappa_b = np.ones(n)
    sigma_b = np.zeros(n)
    a_b = np.zeros(n)
    sigma_maxval = p.sigma_max * c_light * 0.8 * (p.m + 1.0) / d

    def fill(pos, sl, kappa, sigma, a):
        pos_m = pos ** p.m
        pos_ma = (1 - pos) ** p.ma
        kappa[sl] = 1 + (p.kappa_max - 1) * pos_m
        sigma[sl] = sigma_maxval * pos_m
        a[sl] = p.a_max * pos_ma

    if lo:
        pos = 1.0 - np.arange(t, dtype=float) / t
        fill(pos, np.s_[:t], kappa_e, sigma_e, a_e)
        pos = 1.0 - (np.arange(t, dtype=float) + 0.5) / t
        fill(pos, np.s_[:t], kappa_b, sigma_b, a_b)
    if hi:
        pos = 1.0 - np.arange(t, dtype=float)[::-1] / t
        fill(pos, np.s_[n - t:n], kappa_e, sigma_e, a_e)
        pos = 1.0 - (np.arange(t, dtype=float) + 0.5)[::-1] / t
        fill(pos, np.s_[n - t - 1:n - 1], kappa_b, sigma_b, a_b)

    def bc_coeffs(kappa, sigma, a):
        b = np.exp(-(sigma / kappa + a) * dt)
        denom = sigma + kappa * a
        with np.errstate(divide="ignore", invalid="ignore"):
            cc = (b - 1.0) * sigma / kappa / denom / d
        cc = np.where(denom > 0, cc, 0.0)
        return b, cc

    b_e, c_e = bc_coeffs(kappa_e, sigma_e, a_e)
    b_b, c_b = bc_coeffs(kappa_b, sigma_b, a_b)
    return kappa_e, b_e, c_e, kappa_b, b_b, c_b


def psi_regions(prof: Dict[str, np.ndarray]) -> tuple:
    """Contiguous runs of rows where the psi recursion can be nonzero
    (c_e != 0 or c_b != 0) along one axis: ((start, width), ...). psi
    stays exactly zero elsewhere, so slab-restricted storage equals the
    full arrays."""
    nz = (prof["c_e"] != 0) | (prof["c_b"] != 0)
    idx = np.flatnonzero(nz)
    if idx.size == 0:
        return ()
    splits = np.flatnonzero(np.diff(idx) > 1)
    starts = [int(idx[0])] + [int(idx[s + 1]) for s in splits]
    ends = [int(idx[s]) for s in splits] + [int(idx[-1])]
    return tuple((s, e - s + 1) for s, e in zip(starts, ends))


@dataclass(frozen=True)
class CPMLCoeffs:
    """Host-precomputed float64 coefficient profiles, one entry per axis
    that has at least one PML face."""

    # axis name 'x'|'y'|'z' -> dict with kappa_e, b_e, c_e, kappa_b, b_b, c_b
    profiles: Dict[str, Dict[str, np.ndarray]]

    def axis(self, ax: str) -> Optional[Dict[str, np.ndarray]]:
        return self.profiles.get(ax)

    def regions(self, ax: str) -> tuple:
        prof = self.profiles.get(ax)
        return psi_regions(prof) if prof is not None else ()

    def psi_width(self, ax: str) -> int:
        """Total slab rows along ``ax`` (the slab-psi array extent)."""
        return sum(w for _, w in self.regions(ax))


def build_cpml(grid: Grid, dt: float, params: CPMLParams) -> CPMLCoeffs:
    bc = grid.bc
    profiles: Dict[str, Dict[str, np.ndarray]] = {}
    for name, n, n_loc, d in (("x", grid.nx, grid.nx_loc, grid.dx),
                              ("y", grid.ny, grid.ny_loc, grid.dy),
                              ("z", grid.nz, grid.nz_loc, grid.dz)
                              )[: grid.dimension]:
        lo = bc.get(name + "min") == "pml"
        hi = bc.get(name + "max") == "pml"
        if not (lo or hi):
            continue
        if params.thickness >= n_loc:
            raise ValueError(
                f"PML thickness ({params.thickness}) must be smaller than "
                f"the per-device shard size along {name} ({n_loc})")
        ke, be, ce, kb, bb, cb = _face_profiles(n, d, dt, params, lo, hi)
        profiles[name] = dict(
            kappa_e=ke, b_e=be, c_e=ce, kappa_b=kb, b_b=bb, c_b=cb)
    return CPMLCoeffs(profiles=profiles)


def shard_cpml(cpml: Optional[CPMLCoeffs], grid: Grid,
               coords) -> Optional[CPMLCoeffs]:
    """The coefficients of the shard at mesh ``coords``: each axis's
    profiles cut to the shard's rows, so ``regions`` and ``psi_width``
    give the PML rows the shard holds (none where the shard touches no
    PML face: its psi arrays are then empty along that axis)."""
    if cpml is None:
        return None
    profiles = {}
    for ax, prof in cpml.profiles.items():
        k = grid.axes.index(ax)
        n = grid.local_shape[k]
        lo = coords[k] * n
        profiles[ax] = {key: v[lo:lo + n] for key, v in prof.items()}
    return CPMLCoeffs(profiles=profiles)


def psi_rows(cpml: CPMLCoeffs, grid: Grid, ax: str, coord: int) -> np.ndarray:
    """The rows of the global slab-restricted psi of axis ``ax`` (indices
    along its slab axis) that the shard at ``coord`` along that axis
    holds, in the order of the shard's own slab psi."""
    k = grid.axes.index(ax)
    n = grid.local_shape[k]
    lo, hi = coord * n, (coord + 1) * n
    rows, off = [], 0
    for s, w in cpml.regions(ax):
        a, b = max(s, lo), min(s + w, hi)
        if a < b:
            rows.extend(range(off + a - s, off + b - s))
        off += w
    return np.asarray(rows, dtype=np.int64)
