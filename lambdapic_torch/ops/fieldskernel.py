"""Kernel B1 wrapper: the fields half-step (counterpart of
lambdapic_tpu/ops/fieldspallas.py, whose Pallas kernel ``_update_half``
this replaces; CUDA sources ``csrc/fields.cu`` for 2D grids and
``csrc/fields3d.cu`` for 3D grids).

``update_efield_k`` / ``update_bfield_k`` take and return a FieldsState
like ``ops/maxwell.py::update_efield`` / ``update_bfield``. On CUDA
tensors they launch the kernel; on CPU tensors they run that plain
version. Each kernel launch adds one to ``update_half_k.launches``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..constants import c as c_light, epsilon_0
from ..core.grid import Grid
from ..core.state import FieldsState
from . import kernel_lib
from .cpml import CPMLCoeffs
from .maxwell import B_PAIRS, E_PAIRS, update_bfield, update_efield


@dataclass
class HalfCoeffs:
    """Device coefficient rows of one half-step kind ('e' or 'b'):
    1/kappa per x row and y column (and z line in 3D), the psi
    recursion's b and c, and the row maps (grid row -> psi row, or -1)."""

    ikx: torch.Tensor
    iky: torch.Tensor
    bx: torch.Tensor
    cx: torch.Tensor
    by: torch.Tensor
    cy: torch.Tensor
    rx: torch.Tensor
    ry: torch.Tensor
    wx: int
    wy: int
    ikz: Optional[torch.Tensor] = None
    bz: Optional[torch.Tensor] = None
    cz: Optional[torch.Tensor] = None
    rz: Optional[torch.Tensor] = None
    wz: int = 0


def half_coeffs(grid: Grid, cpml: Optional[CPMLCoeffs], which: str, dtype,
                device) -> HalfCoeffs:
    rows = {}
    for ax, n in zip(grid.axes, grid.shape):
        prof = cpml.axis(ax) if cpml is not None else None
        ik = np.ones(n)
        b = np.ones(n)
        cc = np.zeros(n)
        rmap = np.full(n, -1, np.int32)
        w = 0
        if prof is not None:
            ik = 1.0 / prof["kappa_" + which]
            b = prof["b_" + which]
            cc = prof["c_" + which]
            for start, width in cpml.regions(ax):
                rmap[start:start + width] = np.arange(w, w + width)
                w += width
        rows[ax] = [torch.as_tensor(v, dtype=dtype).to(device)
                    for v in (ik, b, cc)] + [
            torch.as_tensor(rmap).to(device), w]
    (ikx, bx, cx, rx, wx), (iky, by, cy, ry, wy) = rows["x"], rows["y"]
    extra = {}
    if grid.dimension == 3:
        extra = dict(zip(("ikz", "bz", "cz", "rz", "wz"), rows["z"]))
    return HalfCoeffs(ikx=ikx, iky=iky, bx=bx, cx=cx, by=by, cy=cy,
                      rx=rx, ry=ry, wx=wx, wy=wy, **extra)


def update_half_k(fields: FieldsState, grid: Grid, dt: float,
                  cpml: Optional[CPMLCoeffs], which: str,
                  coeffs: Optional[HalfCoeffs] = None) -> FieldsState:
    """One E (which='e') or B ('b') half-step through kernel B1."""
    ex = fields.ex
    if ex.device.type == "cpu":
        fn = update_efield if which == "e" else update_bfield
        return fn(fields, grid, dt, cpml)
    if ex.device.type != "cuda":
        raise ValueError(f"update_half_k: unsupported device {ex.device}")
    if ex.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"update_half_k: dtype {ex.dtype}")
    if coeffs is None:
        coeffs = half_coeffs(grid, cpml, which, ex.dtype, ex.device)
    shape = grid.shape
    names = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz")
    ins = [getattr(fields, k) for k in names]
    for k, t in zip(names, ins):
        kernel_lib.check(t, k, shape, ex.dtype, ex.device)
    pairs = E_PAIRS if which == "e" else B_PAIRS
    psi = dict(fields.psi)
    psi_ptrs = []
    widths = (coeffs.wx, coeffs.wy, coeffs.wz)
    for axis, ax in enumerate(grid.axes):
        w = widths[axis]
        pshape = shape[:axis] + (w,) + shape[axis + 1:]
        keys = [p[0] for p in pairs[ax]]
        if w == 0:
            psi_ptrs += [None] * 4
            continue
        for k in keys:
            kernel_lib.check(psi[k], k, pshape, ex.dtype, ex.device)
        outs = [torch.empty(pshape, dtype=ex.dtype, device=ex.device)
                for _ in keys]
        psi_ptrs += [psi[k] for k in keys] + outs
        psi.update(zip(keys, outs))
    outs = [torch.empty(shape, dtype=ex.dtype, device=ex.device)
            for _ in range(3)]
    fac = dt * c_light**2 if which == "e" else dt
    tgt = ("ex", "ey", "ez") if which == "e" else ("bx", "by", "bz")
    if grid.dimension == 3:
        kernel_lib.call(
            "fields3d", "lp_fields_half_3d",
            ins + outs + psi_ptrs + [
                coeffs.ikx, coeffs.iky, coeffs.ikz, coeffs.bx, coeffs.cx,
                coeffs.by, coeffs.cy, coeffs.bz, coeffs.cz, coeffs.rx,
                coeffs.ry, coeffs.rz],
            [grid.nx, grid.ny, grid.nz, *grid.periodic_axes,
             0 if which == "e" else 1, coeffs.wx, coeffs.wy, coeffs.wz,
             ex.dtype == torch.float64],
            [fac, dt / epsilon_0, grid.dx, grid.dy, grid.dz], ex.device)
        update_half_k.launches += 1
        return fields.replace(psi=psi, **dict(zip(tgt, outs)))
    kernel_lib.call(
        "fields", "lp_fields_half",
        ins + outs + psi_ptrs + [coeffs.ikx, coeffs.iky, coeffs.bx, coeffs.cx,
                                 coeffs.by, coeffs.cy, coeffs.rx, coeffs.ry],
        [grid.nx, grid.ny, grid.periodic("x"), grid.periodic("y"),
         0 if which == "e" else 1, coeffs.wx, coeffs.wy,
         ex.dtype == torch.float64],
        [fac, dt / epsilon_0, grid.dx, grid.dy], ex.device)
    update_half_k.launches += 1
    return fields.replace(psi=psi, **dict(zip(tgt, outs)))


update_half_k.launches = 0


def update_efield_k(fields: FieldsState, grid: Grid, dt: float,
                    cpml: Optional[CPMLCoeffs] = None,
                    coeffs: Optional[HalfCoeffs] = None) -> FieldsState:
    """Kernel counterpart of ops/maxwell.py::update_efield."""
    return update_half_k(fields, grid, dt, cpml, "e", coeffs)


def update_bfield_k(fields: FieldsState, grid: Grid, dt: float,
                    cpml: Optional[CPMLCoeffs] = None,
                    coeffs: Optional[HalfCoeffs] = None) -> FieldsState:
    """Kernel counterpart of ops/maxwell.py::update_bfield."""
    return update_half_k(fields, grid, dt, cpml, "b", coeffs)
