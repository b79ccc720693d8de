"""Yee FDTD half-steps with CPML (counterpart of lambdapic_tpu/ops/maxwell.py,
2D and 3D, slab-restricted psi storage).

This is the plain PyTorch version of kernel B1 (``ops/fieldskernel.py``,
``csrc/fields.cu``). Each call advances E or B by ``dt`` as passed in (the
step passes dt/2 twice per step): curl differences, the kappa-scaled
interior update, then the psi recursion and psi correction on the PML
slab rows of each axis.

On a device mesh the JAX package runs these XLA updates, not its fused
kernel B1 (lambdapic_tpu/simulation/step.py's ``_fields_pl_mesh``,
``_maxwell_fns``), and so does the port: each shard updates its block
with the neighbour rows its differences reach handed in as ``edges``
(``{(component, axis): row}``, the lower neighbour's last row of a B
component for the E update, the upper neighbour's first row of an E
component for the B update; zeros past an open face) and its psi on the
PML rows it holds (``ops/cpml.py::shard_cpml``). That is bit for bit the
global update.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..constants import c as c_light, epsilon_0
from ..core.grid import Grid
from ..core.state import FieldsState
from .cpml import CPMLCoeffs
from .shifts import diff_hi, diff_lo

# (psi key, curl source field, corrected target field, sign) per PML axis
E_PAIRS = {
    "x": (("psi_ey_x", "bz", "ey", -1), ("psi_ez_x", "by", "ez", +1)),
    "y": (("psi_ex_y", "bz", "ex", +1), ("psi_ez_y", "bx", "ez", -1)),
    "z": (("psi_ex_z", "by", "ex", -1), ("psi_ey_z", "bx", "ey", +1)),
}
# the neighbour rows each update reads across a shard's faces
E_EDGES = (("bz", 0), ("bz", 1), ("by", 0), ("bx", 1), ("by", 2), ("bx", 2))
B_EDGES = (("ez", 0), ("ez", 1), ("ey", 0), ("ex", 1), ("ey", 2), ("ex", 2))
B_PAIRS = {
    "x": (("psi_by_x", "ez", "by", +1), ("psi_bz_x", "ey", "bz", -1)),
    "y": (("psi_bx_y", "ez", "bx", -1), ("psi_bz_y", "ex", "bz", +1)),
    "z": (("psi_bx_z", "ey", "bx", +1), ("psi_by_z", "ex", "by", -1)),
}


def _bcast(arr_1d, axis: int, like: torch.Tensor) -> torch.Tensor:
    shape = [1] * like.ndim
    shape[axis] = len(arr_1d)
    return torch.as_tensor(arr_1d, dtype=like.dtype).to(like.device).reshape(shape)


def _diff_region(f, axis: int, start: int, width: int, periodic: bool,
                 hi: bool, edge=None):
    """Rows [start, start+width) of diff_lo(f) (hi=False) or diff_hi(f)
    (hi=True) along ``axis``, from a (width+1)-row slice; ``edge`` is the
    row past the end a difference reaches (see the module docstring)."""
    n = f.shape[axis]
    if hi:
        if start + width < n:
            sl = f.narrow(axis, start, width + 1)
        else:
            last = f.narrow(axis, 0, 1)
            if edge is not None:
                last = edge
            elif not periodic:
                last = torch.zeros_like(last)
            sl = torch.cat([f.narrow(axis, start, n - start), last], dim=axis)
    else:
        if start > 0:
            sl = f.narrow(axis, start - 1, width + 1)
        else:
            prev = f.narrow(axis, n - 1, 1)
            if edge is not None:
                prev = edge
            elif not periodic:
                prev = torch.zeros_like(prev)
            sl = torch.cat([prev, f.narrow(axis, 0, width)], dim=axis)
    return sl.narrow(axis, 1, width) - sl.narrow(axis, 0, width)


def _psi_axis_update(psi, fb, cpml: CPMLCoeffs, ax: str, axis: int,
                     which: str, fac, periodic: bool, pairs, edges):
    """One axis's psi recursion and field correction on slab-restricted
    psi arrays. Mutates ``psi`` and ``fb`` (name -> tensor) in place."""
    prof = cpml.axis(ax)
    ref = fb[pairs[0][1]]
    if psi[pairs[0][0]].shape[axis] == ref.shape[axis] and \
            cpml.psi_width(ax) != ref.shape[axis]:
        raise ValueError("full-size psi arrays are not supported; the port "
                         "stores psi on the PML slab rows only")
    off = 0
    new_parts = {key: [] for key, *_ in pairs}
    for start, width in cpml.regions(ax):
        b = _bcast(prof["b_" + which][start:start + width], axis, ref)
        cc = _bcast(prof["c_" + which][start:start + width], axis, ref)
        for key, src, tgt, sign in pairs:
            p_old = psi[key].narrow(axis, off, width)
            d = _diff_region(fb[src], axis, start, width, periodic,
                             hi=(which == "b"), edge=edges.get((src, axis)))
            p = b * p_old + cc * d
            new_parts[key].append(p)
            t = fb[tgt].clone()
            t.narrow(axis, start, width).add_(sign * fac * p)
            fb[tgt] = t
        off += width
    for key, parts in new_parts.items():
        psi[key] = parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def _kappa_factors(cpml: Optional[CPMLCoeffs], which: str, like):
    """Per-axis 1/kappa broadcastables (1.0 where the axis has no PML)."""
    out = []
    for axis, ax in enumerate("xyz"[: like.ndim]):
        prof = cpml.axis(ax) if cpml is not None else None
        if prof is None:
            out.append(torch.tensor(1.0, dtype=like.dtype, device=like.device))
        else:
            out.append(_bcast(1.0 / prof["kappa_" + which], axis, like))
    return out


def update_efield(fields: FieldsState, grid: Grid, dt: float,
                  cpml: Optional[CPMLCoeffs] = None,
                  edges: Optional[dict] = None) -> FieldsState:
    """Advance E by dt, then the CPML psi_e recursion. ``edges``: a
    shard's neighbour rows (``E_EDGES``, see the module docstring)."""
    ed = edges or {}
    per = grid.periodic_axes
    ex, ey, ez = fields.ex, fields.ey, fields.ez
    bx, by, bz = fields.bx, fields.by, fields.bz
    bf = torch.tensor(dt * c_light**2, dtype=ex.dtype, device=ex.device)
    jf = torch.tensor(dt / epsilon_0, dtype=ex.dtype, device=ex.device)
    inv_kx, inv_ky, *rest = _kappa_factors(cpml, "e", ex)

    dbz_y = diff_lo(bz, 1, per[1], ed.get(('bz', 1))) / grid.dy
    dbz_x = diff_lo(bz, 0, per[0], ed.get(('bz', 0))) / grid.dx
    dby_x = diff_lo(by, 0, per[0], ed.get(('by', 0))) / grid.dx
    dbx_y = diff_lo(bx, 1, per[1], ed.get(('bx', 1))) / grid.dy
    if grid.dimension == 2:
        ex = ex + bf * inv_ky * dbz_y - jf * fields.jx
        ey = ey - bf * inv_kx * dbz_x - jf * fields.jy
        ez = ez + bf * (inv_kx * dby_x - inv_ky * dbx_y) - jf * fields.jz
    else:
        inv_kz = rest[0]
        dby_z = diff_lo(by, 2, per[2], ed.get(('by', 2))) / grid.dz
        dbx_z = diff_lo(bx, 2, per[2], ed.get(('bx', 2))) / grid.dz
        ex = ex + bf * (inv_ky * dbz_y - inv_kz * dby_z) - jf * fields.jx
        ey = ey + bf * (inv_kz * dbx_z - inv_kx * dbz_x) - jf * fields.jy
        ez = ez + bf * (inv_kx * dby_x - inv_ky * dbx_y) - jf * fields.jz

    psi = dict(fields.psi)
    if cpml is not None:
        fb = {"ex": ex, "ey": ey, "ez": ez, "bx": bx, "by": by, "bz": bz}
        for axis, ax in enumerate(grid.axes):
            if cpml.regions(ax):
                _psi_axis_update(psi, fb, cpml, ax, axis, "e", bf, per[axis],
                                 E_PAIRS[ax], ed)
        ex, ey, ez = fb["ex"], fb["ey"], fb["ez"]
    return fields.replace(ex=ex, ey=ey, ez=ez, psi=psi)


def update_bfield(fields: FieldsState, grid: Grid, dt: float,
                  cpml: Optional[CPMLCoeffs] = None,
                  edges: Optional[dict] = None) -> FieldsState:
    """Advance B by dt, then the CPML psi_b recursion. ``edges``: a
    shard's neighbour rows (``B_EDGES``)."""
    ed = edges or {}
    per = grid.periodic_axes
    ex, ey, ez = fields.ex, fields.ey, fields.ez
    bx, by, bz = fields.bx, fields.by, fields.bz
    dtc = torch.tensor(dt, dtype=bx.dtype, device=bx.device)
    inv_kx, inv_ky, *rest = _kappa_factors(cpml, "b", bx)

    dez_y = diff_hi(ez, 1, per[1], ed.get(('ez', 1))) / grid.dy
    dez_x = diff_hi(ez, 0, per[0], ed.get(('ez', 0))) / grid.dx
    dey_x = diff_hi(ey, 0, per[0], ed.get(('ey', 0))) / grid.dx
    dex_y = diff_hi(ex, 1, per[1], ed.get(('ex', 1))) / grid.dy
    if grid.dimension == 2:
        bx = bx - dtc * inv_ky * dez_y
        by = by + dtc * inv_kx * dez_x
        bz = bz - (dtc * inv_kx * dey_x - dtc * inv_ky * dex_y)
    else:
        inv_kz = rest[0]
        dey_z = diff_hi(ey, 2, per[2], ed.get(('ey', 2))) / grid.dz
        dex_z = diff_hi(ex, 2, per[2], ed.get(('ex', 2))) / grid.dz
        bx = bx - (dtc * inv_ky * dez_y - dtc * inv_kz * dey_z)
        by = by - (dtc * inv_kz * dex_z - dtc * inv_kx * dez_x)
        bz = bz - (dtc * inv_kx * dey_x - dtc * inv_ky * dex_y)

    psi = dict(fields.psi)
    if cpml is not None:
        fb = {"ex": ex, "ey": ey, "ez": ez, "bx": bx, "by": by, "bz": bz}
        for axis, ax in enumerate(grid.axes):
            if cpml.regions(ax):
                _psi_axis_update(psi, fb, cpml, ax, axis, "b", dtc, per[axis],
                                 B_PAIRS[ax], ed)
        bx, by, bz = fb["bx"], fb["by"], fb["bz"]
    return fields.replace(bx=bx, by=by, bz=bz, psi=psi)
