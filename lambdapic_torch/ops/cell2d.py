"""Cell-binned particle operations, 2D (counterpart of
lambdapic_tpu/ops/cell2d.py).

Layout: particles live in per-cell slots ``(cap_c, nx, ny)``; slot
(s, ix, iy) holds a particle with floor(x + 0.5) == ix after re-binning.
Particles are re-binned at the mid-step position, so the gather deltas
lie in [-0.5, 0.5) and both Esirkepov segment ends lie on the 5-tap
stencil {-2..2}.

These functions compose into the plain PyTorch version of kernel B2
(``ops/cellslab.py``): half push -> ``migrate_cells`` (x then y) ->
``gather_cell_2d`` -> Boris -> half push -> ``deposit_cell_2d``. They are
written op for op like the JAX functions, so the two packages round
alike.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..constants import c as c_light

_GOFF = (-1, 0, 1)           # integer-staggered taps
_HOFF = (-2, -1, 0, 1)       # half-staggered taps (<=3 nonzero)
_DOFF = (-2, -1, 0, 1, 2)    # deposit taps

# attributes rewritten before any post-migration read; not carried
# through the re-binning (the Boris push recomputes inv_gamma)
TRANSIENT = frozenset({"ex_part", "ey_part", "ez_part",
                       "bx_part", "by_part", "bz_part", "chi",
                       "inv_gamma"})
MERGED = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma")
SANITIZED = ("x", "y", "z", "w", "ux", "uy", "uz")


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _m2(d):
    ad = torch.abs(d)
    return torch.where(ad <= 0.5, 0.75 - d * d,
                       torch.where(ad < 1.5, 0.5 * (1.5 - ad) ** 2,
                                   torch.zeros_like(d)))


def _deltas(x, y):
    """Cell-local offsets: delta = x - ix with ix the cell's index."""
    ix = torch.arange(x.shape[1], dtype=x.dtype, device=x.device)[None, :, None]
    iy = torch.arange(x.shape[2], dtype=x.dtype, device=x.device)[None, None, :]
    return x - ix, y - iy


def gather_cell_2d(eb_pad: torch.Tensor, x, y, g: int):
    """eb_pad (6, nx+2g, ny+2g); x, y (cap_c, nx, ny). Returns the six
    gathered components, each (cap_c, nx, ny)."""
    cap, nx, ny = x.shape
    dx, dy = _deltas(x, y)
    gx = {o: _m2(o - dx) for o in _GOFF}
    hx = {o: _m2(o + 0.5 - dx) for o in _HOFF}
    gy = {o: _m2(o - dy) for o in _GOFF}
    hy = {o: _m2(o + 0.5 - dy) for o in _HOFF}
    comps = ((0, hx, gy), (1, gx, hy), (2, gx, gy),
             (3, gx, hy), (4, hx, gy), (5, hx, hy))
    out = []
    for c, wx, wy in comps:
        acc = torch.zeros_like(x)
        for ox, txo in wx.items():
            for oy, tyo in wy.items():
                f = eb_pad[c, g + ox:g + ox + nx, g + oy:g + oy + ny]
                acc = acc + txo * tyo * f[None]
        out.append(acc)
    return tuple(out)


def deposit_offsets(x, y, ux, uy, uz, inv_gamma, w, *, q: float, dx: float,
                    dy: float, dt: float, with_rho: bool = True):
    """Esirkepov deposit from the cell layout, per stencil offset: yields
    ((ox, oy), contribution) with contribution (C, nx, ny) the slot-summed
    (jx, jy, jz[, rho]) that cell (ix, iy) adds to node (ix+ox, iy+oy).
    Requires home-cell binning; dead slots must carry w == 0."""
    dxl, dyl = _deltas(x, y)
    vx_c = ux * inv_gamma * _scalar(c_light * dt / dx, x)
    vy_c = uy * inv_gamma * _scalar(c_light * dt / dy, x)
    vz = uz * inv_gamma * _scalar(c_light, x)

    s0x = {o: _m2(o - (dxl - 0.5 * vx_c)) for o in _DOFF}
    s1x = {o: _m2(o - (dxl + 0.5 * vx_c)) for o in _DOFF}
    s0y = {o: _m2(o - (dyl - 0.5 * vy_c)) for o in _DOFF}
    s1y = {o: _m2(o - (dyl + 0.5 * vy_c)) for o in _DOFF}

    cd = _scalar(q / (dx * dy), x) * w
    fdx = _scalar(q / (dy * dt), x) * w
    fdy = _scalar(q / (dx * dt), x) * w
    cvz = cd * vz

    fx_run = {}
    acc = torch.zeros_like(x)
    for o in _DOFF:
        acc = acc + (s1x[o] - s0x[o])
        fx_run[o] = -fdx * acc
    gy_run = {}
    acc = torch.zeros_like(x)
    for o in _DOFF:
        acc = acc + (s1y[o] - s0y[o])
        gy_run[o] = -fdy * acc

    for ox in _DOFF:
        dsx = s1x[ox] - s0x[ox]
        ax = s0x[ox] + 0.5 * dsx
        for oy in _DOFF:
            dsy = s1y[oy] - s0y[oy]
            by = s0y[oy] + 0.5 * dsy
            parts = [(fx_run[ox] * by).sum(0),
                     (ax * gy_run[oy]).sum(0),
                     (cvz * (ax * by + dsx * dsy / 12.0)).sum(0)]
            if with_rho:
                parts.append((cd * s1x[ox] * s1y[oy]).sum(0))
            yield (ox, oy), torch.stack(parts)


def deposit_cell_2d(x, y, ux, uy, uz, inv_gamma, w, *, q: float, dx: float,
                    dy: float, dt: float, g: int) -> torch.Tensor:
    """Padded (4, nx+2g, ny+2g) jx, jy, jz, rho: each offset's
    slot-reduced contribution is slice-added into the padded grid."""
    cap, nx, ny = x.shape
    jpad = torch.zeros((4, nx + 2 * g, ny + 2 * g), dtype=x.dtype,
                       device=x.device)
    for (ox, oy), cell in deposit_offsets(x, y, ux, uy, uz, inv_gamma, w,
                                          q=q, dx=dx, dy=dy, dt=dt):
        jpad[:, g + ox:g + ox + nx, g + oy:g + oy + ny] += cell
    return jpad


# ----------------------------------------------------------------------
# re-binning
# ----------------------------------------------------------------------

@lru_cache(maxsize=None)
def batcher_network(cap: int) -> Tuple[Tuple[int, int], ...]:
    """Batcher odd-even mergesort compare-exchange list for the next
    power of two >= cap, skipping exchanges whose upper index >= cap
    (virtual +inf entries) — the list of
    lambdapic_tpu/ops/cellpallas.py::_batcher_network."""
    n = 1
    while n < cap:
        n *= 2
    ces = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        a, b = i + j, i + j + k
                        if b < cap:
                            ces.append((a, b))
            k //= 2
        p *= 2
    return tuple(ces)


def batcher_sort(key: torch.Tensor, payloads: Sequence[torch.Tensor]):
    """Sort (key, *payloads) along the slot axis with the Batcher
    network, swapping on a strict ``ka > kb`` only. The exchange
    decisions depend on the keys alone, so the network runs on (key,
    slot index) and the payloads are permuted once at the end — bitwise
    the same as carrying them through every exchange."""
    cap = key.shape[0]
    key = key.clone()
    idx = torch.arange(cap, device=key.device).reshape(
        (cap,) + (1,) * (key.ndim - 1)).expand(key.shape).clone()
    for a, b in batcher_network(cap):
        ka, kb = key[a].clone(), key[b].clone()
        ia, ib = idx[a].clone(), idx[b].clone()
        swap = ka > kb
        key[a] = torch.where(swap, kb, ka)
        key[b] = torch.where(swap, ka, kb)
        idx[a] = torch.where(swap, ib, ia)
        idx[b] = torch.where(swap, ia, ib)
    return key, [torch.gather(p, 0, idx) for p in payloads]


def _roll_in(a: torch.Tensor, dim: int, direction: int) -> torch.Tensor:
    return torch.roll(a, direction, dims=dim)


def _weight_floor(w: torch.Tensor) -> float:
    return 1e-300 if w.dtype == torch.float64 else 1e-30


def _exact_dest(alive, val_lo, val_hi):
    """The rows of the exact scheme's stable sort (lambdapic_tpu/ops/
    cell2d.py:231-279), without the sort. Each cell sorts [residents;
    lo arrivals; hi arrivals] (3 cap rows) by the keys 0 alive resident,
    1 valid arrival, 2 empty, keeping each key's rows in order. A row's
    place is the count of rows of smaller keys plus its rank among its
    own key's rows, so the permutation follows from three prefix sums:
    the alive residents come first, then the valid lo and hi arrivals,
    then the empty residents, lo and hi rows.

    Returns (dests, total): each block's (cap, *cells) destination row,
    clamped to 2 cap (rows past 2 cap are never read), and the cells'
    count of keys below 2."""
    cap = alive.shape[0]
    rows = torch.arange(cap, device=alive.device).reshape(
        (cap,) + (1,) * (alive.ndim - 1))
    counts = [b.sum(0, dtype=torch.int64) for b in (alive, val_lo, val_hi)]
    total = counts[0] + counts[1] + counts[2]
    valid_base = (0, counts[0], counts[0] + counts[1])
    empty_base = (total, total + cap - counts[0],
                  total + 2 * cap - counts[0] - counts[1])
    dests = []
    for b, vb, eb in zip((alive, val_lo, val_hi), valid_base, empty_base):
        rank = torch.cumsum(b, dim=0)
        dest = torch.where(b, vb + rank - 1, eb + rows - rank)
        dests.append(torch.clamp(dest, max=2 * cap))
    return dests, total


def _exact_axis(data, alive, names, out_lo, out_hi, move, valid_in):
    """One axis of the exact scheme (lambdapic_tpu/ops/cell2d.py:
    231-279), one payload at a time: ``move(t, name, direction)`` rolls
    payload ``name`` one cell along the axis, ``valid_in(mask,
    direction)`` says where an arrival is valid. Only the destinations and the merge mask
    live for the whole axis, so the temporaries are a few payloads' size,
    not several times the state. Returns (data, alive, n_lost)."""
    cap = alive.shape[0]
    val_lo = valid_in(out_hi, +1)
    val_hi = valid_in(out_lo, -1)
    alive = alive & ~(out_lo | out_hi)
    dests, total = _exact_dest(alive, val_lo, val_hi)
    del val_lo, val_hi
    rows = torch.arange(cap, device=alive.device).reshape(
        (cap,) + (1,) * (alive.ndim - 1))
    kept_alive = rows < total
    # reversed alignment: overflow row cap + j -> kept row cap - 1 - j
    valid_m = (2 * cap - 1 - rows) < total
    n_lost = torch.clamp(total - cap, min=0).sum()

    def sorted_rows(k):
        """Rows 0 .. 2 cap - 1 of the sorted [residents; lo; hi] of
        payload k: (kept rows, overflow rows in reversed alignment)."""
        out = torch.empty((2 * cap + 1,) + tuple(alive.shape[1:]),
                          dtype=data[k].dtype, device=data[k].device)
        out.scatter_(0, dests[0], data[k])
        out.scatter_(0, dests[1], move(torch.where(out_hi, data[k], 0), k,
                                       +1))
        out.scatter_(0, dests[2], move(torch.where(out_lo, data[k], 0), k,
                                       -1))
        return out[:cap], out[cap:2 * cap].flip(0)

    kept = {}
    if "w" in names:
        kept_w, ofl_w = sorted_rows("w")
        w_of = torch.where(valid_m, ofl_w, 0.0)
        del ofl_w
        wsum = kept_w + w_of
        wsafe = torch.clamp(wsum, min=_weight_floor(wsum))
    for k in names:
        if k == "w":
            continue
        kept[k], ofl = sorted_rows(k)
        if "w" in names and k in MERGED:
            kept[k] = torch.where(
                valid_m, (kept_w * kept[k] + w_of * ofl) / wsafe, kept[k])
        del ofl
    if "w" in names:
        kept["w"] = wsum
    return {**data, **kept}, kept_alive, n_lost


def _exact_edge(edge: Dict[str, torch.Tensor], coord: str, index: int,
                direction: int, names):
    """A neighbour shard's edge column for the exact scheme: (the mask of
    its slots that leave towards this shard, {payload: its values there,
    0 elsewhere}), as that shard computes them at its own cell
    ``index``; ``direction`` +1 for the lower neighbour's donors (they
    move up), -1 for the upper one's."""
    al = edge["alive"] != 0
    local = edge[coord] - torch.tensor(float(index), dtype=edge[coord].dtype,
                                       device=al.device)
    mask = al & (local >= 0.5) if direction > 0 else al & (local < -0.5)
    return mask, {k: torch.where(mask, edge[k], 0) for k in names}


def edge_keys(edge: Dict[str, torch.Tensor], axis: int, coord: str,
              index: int, parity: torch.Tensor) -> torch.Tensor:
    """The 5-way re-binning keys of a neighbour shard's edge column
    (``edge["alive"]`` and its payloads, one cell wide along ``axis``), as
    that shard computes them at its own cell ``index``."""
    al = edge["alive"] != 0
    local = edge[coord] - torch.tensor(float(index), dtype=edge[coord].dtype,
                                       device=al.device)
    out_hi = al & (local >= 0.5)
    out_lo = al & (local < -0.5)
    return torch.where(out_hi, 0, torch.where(
        out_lo, 4, torch.where(al, 2, torch.where(parity, 1, 3))))


def migrate_cells(data: Dict[str, torch.Tensor], alive: torch.Tensor,
                  plan, *, recompute_ig: bool = True, exact: bool = False,
                  sort_fn=None, edges: Optional[Dict] = None,
                  finish: bool = True):
    """Re-bin particles to their home cells: lambdapic_tpu/ops/cell2d.py::
    migrate_cells on one shard. ``plan`` = ((nloc, periodic, coord), ...)
    per cell axis to re-bin, in order (2D: x, y; 3D: x, y, z).

    The fast overwrite-merge scheme (default) sorts with ``sort_fn``
    (``batcher_sort`` when None; kernel B7, ``ops/cellpallas.py::
    sort_cells``, on the per-stage path). Per axis: one cap-wide sort by
    the 5-way key

        0: donor(+1)  1: dead(even slot)  2: stay  3: dead(odd)  4: donor(-1)

    (dead-slot parity from the slot index before the sort), then the
    sorted arrays shift one cell each way and arrivals overwrite the
    receiver's slot, lo arrivals first; two or three particles landing
    on one slot merge into one (w summed, coordinates and momenta
    weight-averaged) and count in ``n_lost``. Arrivals through a periodic
    wrap shift their coordinate by -+nloc; at open edges they are
    absorbed.

    ``edges`` maps an axis (0 x, 1 y, 2 z) to the
    (lo, hi) edge columns of the neighbour shards along it: dicts of
    ``alive`` (zero past an open global face) and every carried payload,
    one cell wide along the axis, lo the lower neighbour's last column and
    hi the upper neighbour's first. They take the place of the wrap: each
    is sorted with the keys its shard gives it, and its donors arrive with
    the -+nloc coordinate shift (the JAX package's ppermute of the rolled
    edge slab, ops/tiled2d.py::_roll_with_edge_exchange). In the exact
    scheme each neighbour's donors towards this shard arrive instead, as
    the JAX package's ``send`` rolls them across the shard face.

    ``finish=False`` leaves the dead slots and inv_gamma as the last axis
    placed them (a re-binning that continues on another dispatch, see
    ops/cellslab.py::cell_step); inv_gamma is then dropped.

    ``exact=True`` is the lossless scheme (``cell_migration="exact"``):
    per axis, donors leave their cell as dedicated buffers and each cell
    orders [residents; lo arrivals; hi arrivals] (3 cap rows, keys 0
    resident, 1 arrival, 2 empty) as lax.sort's stable sort does (the
    permutation from prefix sums, ``_exact_dest``), a payload at a time.
    Nothing is lost while a cell's total stays <= cap; an alive row
    cap + j beyond that merges into kept row cap - 1 - j (weights summed,
    coordinates and momenta weight-averaged) and rows >= 2 cap are
    dropped; both count in ``n_lost``.

    Returns (data, alive, n_lost)."""
    cap = alive.shape[0]
    n_lost = torch.zeros((), dtype=torch.int64, device=alive.device)
    transient = set(TRANSIENT) if recompute_ig else set(TRANSIENT) - {"inv_gamma"}
    names = sorted(k for k in data if k not in transient)
    ndim = alive.ndim - 1
    parity = ((torch.arange(cap, device=alive.device) & 1) == 0).reshape(
        (cap,) + (1,) * ndim)
    edges = edges or {}

    for nloc, periodic, coord in plan:
        axis = "xyz".index(coord)
        pos = data[coord]
        nt = pos.shape[1 + axis]
        ishape = [1] * (1 + ndim)
        ishape[1 + axis] = nt
        idx = torch.arange(nt, dtype=pos.dtype, device=pos.device).reshape(ishape)
        local = pos - idx
        out_hi = alive & (local >= 0.5)
        out_lo = alive & (local < -0.5)
        cells = torch.arange(nt, device=pos.device).reshape(ishape)
        from_wrap = cells == 0
        to_wrap = cells == nt - 1
        edge_lo = edge_hi = None
        if axis in edges and exact:
            # the neighbours' donors: their edge column's payloads masked
            # to the slots that leave towards this shard, as they send them
            lo, hi = edges[axis]
            edge_lo = _exact_edge(lo, coord, nt - 1, +1, names)
            edge_hi = _exact_edge(hi, coord, 0, -1, names)
        elif axis in edges:
            # the neighbours' edge columns, sorted as their shards sort them
            lo, hi = edges[axis]
            skl, spl = (sort_fn or batcher_sort)(
                edge_keys(lo, axis, coord, nt - 1, parity).to(torch.int32),
                [lo[k] for k in names])
            skh, sph = (sort_fn or batcher_sort)(
                edge_keys(hi, axis, coord, 0, parity).to(torch.int32),
                [hi[k] for k in names])
            edge_lo = (skl, dict(zip(names, spl)))
            edge_hi = (skh, dict(zip(names, sph)))

        def rolled(t, direction, edge):
            """``t`` rolled one cell along the axis; with neighbour edges,
            the column that wrapped is the neighbour's."""
            moved = _roll_in(t, 1 + axis, direction)
            if edge is None:
                return moved
            at = 0 if direction > 0 else nt - 1
            return torch.cat([edge, moved.narrow(1 + axis, 1, nt - 1)]
                             if at == 0 else
                             [moved.narrow(1 + axis, 0, nt - 1), edge],
                             dim=1 + axis)

        def move(t, k, direction):
            """Payload ``k`` rolled one cell along the axis; an arrival
            through the wrap (or from a neighbour shard) shifts its
            coordinate by -+nloc."""
            edge = edge_lo if direction > 0 else edge_hi
            moved = rolled(t, direction, None if edge is None else edge[1][k])
            if k != coord:
                return moved
            wrapped = from_wrap if direction > 0 else to_wrap
            adj = _scalar(-nloc if direction > 0 else nloc, pos)
            return torch.where(wrapped, moved + adj, moved)

        def valid_in(mask, direction, edge_mask=None):
            """Where an arrival from ``mask``'s slots is valid: the open
            faces absorb what crosses them."""
            valid = rolled(mask, direction, edge_mask)
            if not periodic and edge_mask is None:
                wrapped = from_wrap if direction > 0 else to_wrap
                valid = valid & ~wrapped
            return valid

        if exact:
            def valid_exact(mask, direction):
                edge = edge_lo if direction > 0 else edge_hi
                return valid_in(mask, direction,
                                None if edge is None else edge[0])
            data, alive, lost = _exact_axis(data, alive, names, out_lo,
                                            out_hi, move, valid_exact)
            n_lost = n_lost + lost
            continue

        key = torch.where(out_hi, 0, torch.where(
            out_lo, 4, torch.where(alive, 2, torch.where(parity, 1, 3))))
        skey, spay = (sort_fn or batcher_sort)(key.to(torch.int32),
                                               [data[k] for k in names])
        sdata = dict(zip(names, spay))
        del spay
        val_lo = valid_in(skey == 0, +1,
                          None if edge_lo is None else edge_lo[0] == 0)
        val_hi = valid_in(skey == 4, -1,
                          None if edge_hi is None else edge_hi[0] == 4)
        stay = skey == 2
        del skey

        n_src = (val_lo.to(torch.int32) + val_hi.to(torch.int32)
                 + stay.to(torch.int32))
        multi = n_src >= 2
        n_lost = n_lost + torch.clamp(n_src - 1, min=0).sum()
        del n_src
        w_lo = torch.where(val_lo, move(sdata["w"], "w", +1), 0.0)
        w_hi = torch.where(val_hi, move(sdata["w"], "w", -1), 0.0)
        w_res = torch.where(stay, sdata["w"], 0.0)
        wsum = w_lo + w_hi + w_res
        wsafe = torch.clamp(wsum, min=_weight_floor(wsum))
        # a payload at a time: one payload's arrivals are live at once
        new = {}
        for k in names:
            own = sdata.pop(k)
            in_lo, in_hi = move(own, k, +1), move(own, k, -1)
            placed = torch.where(val_lo, in_lo,
                                 torch.where(val_hi, in_hi, own))
            if k in MERGED:
                merged = (w_lo * in_lo + w_hi * in_hi + w_res * own) / wsafe
                placed = torch.where(multi, merged, placed)
            elif k == "w":
                placed = torch.where(multi, wsum, placed)
            new[k] = placed
            del own, in_lo, in_hi
        data = {**data, **new}
        alive = val_lo | val_hi | stay

    if not finish:
        if recompute_ig:
            data.pop("inv_gamma", None)
        return data, alive, n_lost
    for k in SANITIZED:
        if k in data:
            data[k] = torch.where(alive, data[k], torch.zeros_like(data[k]))
    if recompute_ig:
        data["inv_gamma"] = 1.0 / torch.sqrt(
            1.0 + data["ux"]**2 + data["uy"]**2 + data["uz"]**2)
    elif "inv_gamma" in data:
        data["inv_gamma"] = torch.where(alive, data["inv_gamma"],
                                        torch.ones_like(data["inv_gamma"]))
    return data, alive, n_lost


# ----------------------------------------------------------------------
# in-step creation
# ----------------------------------------------------------------------

def _u32_to_i32(v: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 tensor of the same bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def insert_cells(data: Dict[str, torch.Tensor], alive: torch.Tensor,
                 next_id: torch.Tensor, new_vals: Dict[str, torch.Tensor],
                 valid: torch.Tensor, device_id: Optional[int] = None):
    """Cell-aligned in-step creation (QED photon birth), the default
    ``select`` scheme of lambdapic_tpu/ops/cell2d.py::insert_cells, for 2D
    and 3D slots. A newborn sits at its parent's slot in the parent
    species' layout and shares its parent's position, so its home cell is
    the parent's: the newborn of intra-cell rank r (among ``valid`` parent
    slots, in slot order) fills the child's dead slot of dead-rank r.
    Newborns beyond the cell's free slots are dropped and counted.

    data/alive: child species, (cap_c, *cells). new_vals/valid:
    (cap_src, *cells) newborn values at parent slots. Ids are sequential
    from ``next_id`` in (cell, slot) order, uint32 arithmetic carried in
    the int32 id tensors; id_hi is ``device_id``, the shard's row-major
    index on a mesh (0 on the one device, and when None): a newborn belongs
    to the shard that made it, whatever id_hi the resident immigrants
    carry. ``next_id`` is the shard's own counter. Keys of ``data`` absent
    from ``new_vals`` start at 0 (inv_gamma at 1). Returns (data, alive,
    next_id, n_lost)."""
    vi = valid.to(torch.int64)
    intra = torch.cumsum(vi, dim=0) - vi               # exclusive, per cell
    counts = vi.sum(0)                                 # (*cells,)
    flat = counts.reshape(-1)
    base = (torch.cumsum(flat, 0) - flat).reshape(counts.shape)
    rank = base[None] + intra
    ids = _u32_to_i32(next_id + rank)

    di = (~alive).to(torch.int64)
    dead_rank = torch.cumsum(di, dim=0) - di           # exclusive
    fill = (~alive) & (dead_rank < counts[None])
    # source slot of each filled child slot: the valid parent slot whose
    # intra-cell rank equals the child slot's dead rank (row cap_s of the
    # table collects the invalid slots and is never read for a fill)
    cap_s = valid.shape[0]
    slot = torch.arange(cap_s, device=valid.device).reshape(
        (cap_s,) + (1,) * (valid.ndim - 1)).expand(valid.shape)
    table = torch.full((cap_s + 1,) + tuple(valid.shape[1:]), cap_s,
                       dtype=torch.int64, device=valid.device)
    table.scatter_(0, torch.where(valid, intra, cap_s), slot.clone())
    src = table.gather(0, torch.clamp(dead_rank, max=cap_s))
    src = torch.clamp(src, max=cap_s - 1)

    def newborn_value(k, arr):
        if k == "id_lo":
            return ids
        if k == "id_hi":
            return torch.full(valid.shape, device_id or 0,
                              dtype=arr.dtype, device=arr.device)
        if k in new_vals:
            return torch.where(valid, new_vals[k].to(arr.dtype), 0)
        if k == "inv_gamma":
            return torch.ones(valid.shape, dtype=arr.dtype, device=arr.device)
        return torch.zeros(valid.shape, dtype=arr.dtype, device=arr.device)

    out = {}
    for k in sorted(data):
        arr = data[k]
        nv = newborn_value(k, arr)
        out[k] = torch.where(fill, nv.gather(0, src), arr)
    n_lost = torch.clamp(counts - di.sum(0), min=0).sum()
    return out, alive | fill, (next_id + counts.sum()) & 0xFFFFFFFF, n_lost
