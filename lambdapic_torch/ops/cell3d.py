"""Cell-binned particle operations, 3D (counterpart of
lambdapic_tpu/ops/cell3d.py).

Layout: per-cell slots ``(cap_c, nx, ny, nz)``; slot (s, i, j, k) holds a
particle whose home cell is (i, j, k). The binning contract is
``ops/cell2d.py``'s: particles are re-binned at the mid-step position, so
gather deltas lie in [-0.5, 0.5) and both Esirkepov segment ends stay on
the 5-tap stencil {-2..2} per axis.

These functions compose into the plain PyTorch version of kernel B2 in 3D
(``ops/cellslab.py``): half push -> ``migrate_cell_3d`` (x, y, then z) ->
``gather_cell_3d`` -> Boris -> half push -> ``deposit_cell_3d``. They are
written op for op like the JAX functions, so the two packages round
alike.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..constants import c as c_light
from .cell2d import _DOFF, _GOFF, _HOFF, _m2, _scalar, migrate_cells


def _deltas(x, y, z):
    """Cell-local offsets: delta = pos - cell index, per axis."""
    kw = dict(dtype=x.dtype, device=x.device)
    ix = torch.arange(x.shape[1], **kw)[None, :, None, None]
    iy = torch.arange(x.shape[2], **kw)[None, None, :, None]
    iz = torch.arange(x.shape[3], **kw)[None, None, None, :]
    return x - ix, y - iy, z - iz


# slots times cells that gather_cell_3d takes in one pass: its taps hold 21
# arrays of that size, so at the 3D slice's 33.5 M cells it goes a slot at
# a time
GATHER_CHUNK = 1 << 25


def gather_cell_3d(eb_pad: torch.Tensor, x, y, z, g: int):
    """eb_pad (6, nx+2g, ny+2g, nz+2g); x, y, z (cap_c, nx, ny, nz).
    Returns the six gathered components. Yee staggering:

        ex: (hx,gy,gz)  ey: (gx,hy,gz)  ez: (gx,gy,hz)
        bx: (gx,hy,hz)  by: (hx,gy,hz)  bz: (hx,hy,gz)

    Slots go GATHER_CHUNK // cells at a time (each slot's value is the
    same whatever the chunk)."""
    cap, nx, ny, nz = x.shape
    step = max(1, GATHER_CHUNK // max(1, nx * ny * nz))
    if step < cap:
        out = [torch.empty_like(x) for _ in range(6)]
        for s in range(0, cap, step):
            part = gather_cell_3d(eb_pad, x[s:s + step], y[s:s + step],
                                  z[s:s + step], g)
            for o, t in zip(out, part):
                o[s:s + step] = t
        return tuple(out)
    dx, dy, dz = _deltas(x, y, z)
    gx = {o: _m2(o - dx) for o in _GOFF}
    hx = {o: _m2(o + 0.5 - dx) for o in _HOFF}
    gy = {o: _m2(o - dy) for o in _GOFF}
    hy = {o: _m2(o + 0.5 - dy) for o in _HOFF}
    gz = {o: _m2(o - dz) for o in _GOFF}
    hz = {o: _m2(o + 0.5 - dz) for o in _HOFF}
    comps = ((0, hx, gy, gz), (1, gx, hy, gz), (2, gx, gy, hz),
             (3, gx, hy, hz), (4, hx, gy, hz), (5, hx, hy, gz))
    out = []
    for c, wx, wy, wz in comps:
        acc = torch.zeros_like(x)
        for oy, tyo in wy.items():
            for oz, tzo in wz.items():
                tyz = tyo * tzo
                for ox, txo in wx.items():
                    f = eb_pad[c, g + ox:g + ox + nx, g + oy:g + oy + ny,
                               g + oz:g + oz + nz]
                    acc = acc + txo * tyz * f[None]
        out.append(acc)
    return tuple(out)


def deposit_offsets_3d(x, y, z, ux, uy, uz, inv_gamma, w, *, q: float,
                       dx: float, dy: float, dz: float, dt: float,
                       with_rho: bool = True):
    """Esirkepov deposit from the 3D cell layout, per stencil offset:
    yields ((ox, oy, oz), contribution) with contribution (C, nx, ny, nz)
    the slot-summed (jx, jy, jz[, rho]) that cell (i, j, k) adds to node
    (i+ox, j+oy, k+oz). Closed forms as in the JAX package:

        jx = -q w/(dy dz dt) cumsum_ox(DSx) (ay S0z + cy DSz)
        jy = -q w/(dx dz dt) cumsum_oy(DSy) (ax S0z + cx DSz)
        jz = -q w/(dx dy dt) cumsum_oz(DSz) (ax S0y + cx DSy)
        rho = q w/(dx dy dz) S1x S1y S1z
        a = S0 + DS/2,  c = S0/2 + DS/3

    Requires home-cell binning; dead slots must carry w == 0."""
    dxl, dyl, dzl = _deltas(x, y, z)
    vx_c = ux * inv_gamma * _scalar(c_light * dt / dx, x)
    vy_c = uy * inv_gamma * _scalar(c_light * dt / dy, x)
    vz_c = uz * inv_gamma * _scalar(c_light * dt / dz, x)

    def axis_taps(d, v):
        s0 = {o: _m2(o - (d - 0.5 * v)) for o in _DOFF}
        s1 = {o: _m2(o - (d + 0.5 * v)) for o in _DOFF}
        ds = {o: s1[o] - s0[o] for o in _DOFF}
        a = {o: s0[o] + 0.5 * ds[o] for o in _DOFF}
        cc = {o: 0.5 * s0[o] + ds[o] / 3.0 for o in _DOFF}
        run = {}
        acc = torch.zeros_like(d)
        for o in _DOFF:
            acc = acc + ds[o]
            run[o] = acc
        return s0, s1, ds, a, cc, run

    s0x, s1x, dsx, ax, cx, runx = axis_taps(dxl, vx_c)
    s0y, s1y, dsy, ay, cy, runy = axis_taps(dyl, vy_c)
    s0z, s1z, dsz, az, cz, runz = axis_taps(dzl, vz_c)

    cd = _scalar(q / (dx * dy * dz), x) * w
    fdx = _scalar(q / (dy * dz * dt), x) * w
    fdy = _scalar(q / (dx * dz * dt), x) * w
    fdz = _scalar(q / (dx * dy * dt), x) * w

    # pair products with the w-scaled prefactor folded in, hoisted out of
    # the inner-axis loop as the JAX function hoists them
    for oy in _DOFF:
        for oz in _DOFF:
            px = -fdx * (ay[oy] * s0z[oz] + cy[oy] * dsz[oz])
            pr = cd * (s1y[oy] * s1z[oz]) if with_rho else None
            for ox in _DOFF:
                py = -fdy * (ax[ox] * s0z[oz] + cx[ox] * dsz[oz])
                pz = -fdz * (ax[ox] * s0y[oy] + cx[ox] * dsy[oy])
                parts = [(runx[ox] * px).sum(0), (runy[oy] * py).sum(0),
                         (runz[oz] * pz).sum(0)]
                if with_rho:
                    parts.append((s1x[ox] * pr).sum(0))
                yield (ox, oy, oz), torch.stack(parts)


def deposit_cell_3d(x, y, z, ux, uy, uz, inv_gamma, w, *, q: float,
                    dx: float, dy: float, dz: float, dt: float,
                    g: int) -> torch.Tensor:
    """Padded (4, nx+2g, ny+2g, nz+2g) jx, jy, jz, rho: each offset's
    slot-reduced contribution is slice-added into the padded grid."""
    cap, nx, ny, nz = x.shape
    jpad = torch.zeros((4, nx + 2 * g, ny + 2 * g, nz + 2 * g),
                       dtype=x.dtype, device=x.device)
    for (ox, oy, oz), cell in deposit_offsets_3d(
            x, y, z, ux, uy, uz, inv_gamma, w, q=q, dx=dx, dy=dy, dz=dz,
            dt=dt):
        jpad[:, g + ox:g + ox + nx, g + oy:g + oy + ny,
             g + oz:g + oz + nz] += cell
    return jpad


def migrate_cell_3d(data: Dict[str, torch.Tensor], alive: torch.Tensor,
                    periodic: Sequence[bool], *, recompute_ig: bool = True,
                    exact: bool = False, sort_fn=None
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                               torch.Tensor]:
    """3D re-binning along x, then y, then z (see
    ``cell2d.migrate_cells``): the fast overwrite-merge scheme sorting
    with ``sort_fn`` (the Batcher list when None), or with ``exact`` the
    lossless scheme."""
    cap, nx, ny, nz = alive.shape
    return migrate_cells(
        data, alive,
        ((nx, periodic[0], "x"), (ny, periodic[1], "y"),
         (nz, periodic[2], "z")), recompute_ig=recompute_ig, exact=exact,
        sort_fn=sort_fn)
