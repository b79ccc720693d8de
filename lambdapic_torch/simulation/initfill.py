"""Host-side particle initialisation (counterpart of
lambdapic_tpu/simulation/initfill.py, bit for bit).

Density / ppc profiles are evaluated with numpy at the cell centres, ppc
particles are placed uniformly inside each selected cell with weight
w = density * dV / ppc, and the momentum profiles are evaluated at the
particle positions. Randomness is ``default_rng([seed, ispec, device])``.
Arrays keep the JAX package's leading device-mesh axes (all 1 here) so
both packages produce identical arrays; the state constructor strips them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core.grid import Grid
from ..core.species import Species


def _device_axes_si(grid: Grid, dev_idx: Tuple[int, ...]):
    xs = (dev_idx[0] * grid.nx_loc + np.arange(grid.nx_loc)) * grid.dx
    ys = (dev_idx[1] * grid.ny_loc + np.arange(grid.ny_loc)) * grid.dy
    if grid.dimension == 2:
        return xs, ys
    zs = (dev_idx[2] * grid.nz_loc + np.arange(grid.nz_loc)) * grid.dz
    return xs, ys, zs


def count_macro_particles(grid: Grid, sp: Species) -> np.ndarray:
    """Per-device macroparticle counts."""
    counts = np.zeros(grid.mesh_shape, dtype=np.int64)
    if sp.density is None or (isinstance(sp.ppc, int) and sp.ppc == 0):
        return counts
    dens_fn = Species.vectorized_profile(sp.density, grid.dimension)
    ppc_fn = Species.vectorized_profile(sp.ppc, grid.dimension)
    for dev_idx in np.ndindex(grid.mesh_shape):
        coords = np.meshgrid(*_device_axes_si(grid, dev_idx), indexing="ij")
        dens = dens_fn(*coords)
        ppc = ppc_fn(*coords).astype(np.int64)
        counts[dev_idx] = np.where(dens > sp.density_min, ppc, 0).sum()
    return counts


def fill_species(grid: Grid, sp: Species, seed: int, ispec: int,
                 cap: int) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Zero-padded per-device particle arrays of shape mesh_shape +
    (cap,). Returns (arrays, counts)."""
    mshape = grid.mesh_shape
    attrs = sp.attrs()
    arrays = {a: np.zeros(mshape + (cap,), dtype=np.float64) for a in attrs}
    arrays["inv_gamma"][...] = 1.0
    counts = np.zeros(mshape, dtype=np.int64)
    if sp.density is None or (isinstance(sp.ppc, int) and sp.ppc == 0):
        return arrays, counts

    dens_fn = Species.vectorized_profile(sp.density, grid.dimension)
    ppc_fn = Species.vectorized_profile(sp.ppc, grid.dimension)
    mom_fns = [None if prof is None
               else Species.vectorized_profile(prof, grid.dimension)
               for prof in (sp.momentum or (None, None, None))]

    dV = grid.dx * grid.dy * (grid.dz if grid.dimension == 3 else 1.0)
    ds = grid.deltas

    for flat_dev, dev_idx in enumerate(np.ndindex(mshape)):
        coords = np.meshgrid(*_device_axes_si(grid, dev_idx), indexing="ij")
        dens = dens_fn(*coords)
        ppc = ppc_fn(*coords).astype(np.int64)
        n_per_cell = np.where(dens > sp.density_min, np.maximum(ppc, 0), 0)
        total = int(n_per_cell.sum())
        if total == 0:
            continue
        if total > cap:
            raise ValueError(
                f"species {sp.name}: {total} particles on device {dev_idx} "
                f"exceed capacity {cap}")
        flat_n = n_per_cell.reshape(-1)
        cell_ids = np.repeat(np.arange(flat_n.size), flat_n)
        rng = np.random.default_rng([int(seed), int(ispec), int(flat_dev)])
        cell_multi = np.unravel_index(cell_ids, n_per_cell.shape)
        w = dens.reshape(-1)[cell_ids] * dV / np.maximum(
            ppc.reshape(-1)[cell_ids], 1)
        arrays["w"][dev_idx][:total] = w
        pos_si = []
        for d, (cname, ci, dd) in enumerate(zip(grid.axes, cell_multi, ds)):
            u = rng.uniform(-0.5, 0.5, total)
            arrays[cname][dev_idx][:total] = ci + u
            pos_si.append((dev_idx[d] * n_per_cell.shape[d] + ci + u) * dd)
        u3 = [np.zeros(total) if fn is None else fn(*pos_si)
              for fn in mom_fns]
        arrays["ux"][dev_idx][:total] = u3[0]
        arrays["uy"][dev_idx][:total] = u3[1]
        arrays["uz"][dev_idx][:total] = u3[2]
        arrays["inv_gamma"][dev_idx][:total] = 1.0 / np.sqrt(
            1.0 + u3[0]**2 + u3[1]**2 + u3[2]**2)
        counts[dev_idx] = total
    return arrays, counts


def pick_capacity(counts: np.ndarray, factor: float, minimum: int = 128
                  ) -> int:
    """Uniform per-device capacity of the flat arrays, rounded up to a
    multiple of 128."""
    peak = int(counts.max()) if counts.size else 0
    cap = max(minimum, int(np.ceil(peak * factor)))
    return int(np.ceil(cap / 128) * 128)


def bin_cells(arrays: Dict[str, np.ndarray], counts: np.ndarray,
              grid: Grid, factor: float = 2.0,
              cap_c: Optional[int] = None):
    """Re-bin flat per-device arrays (mesh_shape + (cap,)) into the
    per-cell slot layout mesh_shape + (cap_c, nx, ny[, nz]). ``cap_c`` is a
    floor; the automatic value is even (the migration's dead-slot
    parity split alternates). Returns (arrays, alive, cap_c)."""
    nloc = (grid.nx_loc, grid.ny_loc, grid.nz_loc)[: grid.dimension]
    ncells = int(np.prod(nloc))
    mshape = grid.mesh_shape
    occ_max = 0
    binned = {}
    for dev in np.ndindex(mshape):
        n = int(counts[dev])
        idx = [np.clip(np.floor(arrays[c][dev][:n] + 0.5).astype(np.int64),
                       0, nl - 1) for c, nl in zip(grid.axes, nloc)]
        flat = idx[0]
        for ax in range(1, len(nloc)):
            flat = flat * nloc[ax] + idx[ax]
        order = np.argsort(flat, kind="stable")
        fs = flat[order]
        # slot index = position within the particle's cell run
        slot = np.arange(n) - np.searchsorted(fs, fs, side="left")
        occ_max = max(occ_max, int(slot.max()) + 1 if n else 0)
        binned[dev] = (order, fs, slot)
    auto = max(4, int(np.ceil(occ_max * factor / 2) * 2))
    cap_c = auto if cap_c is None else max(cap_c, auto)

    out = {k: np.zeros(mshape + (cap_c,) + nloc, dtype=v.dtype)
           for k, v in arrays.items()}
    if "inv_gamma" in out:
        out["inv_gamma"][...] = 1.0
    alive = np.zeros(mshape + (cap_c,) + nloc, dtype=bool)
    for dev in np.ndindex(mshape):
        order, fs, slot = binned[dev]
        n = len(order)
        for k, v in arrays.items():
            out[k][dev].reshape(cap_c, ncells)[slot, fs] = v[dev][:n][order]
        alive[dev].reshape(cap_c, ncells)[slot, fs] = True
    return out, alive, cap_c
