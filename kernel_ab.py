#!/usr/bin/env python3
"""Time the one-device kernels B2 and B3, the per-stage kernels B4 and
B5 (3D and 2D), the re-binning kernel B6 (and K7), the 3D fold B3 (and
K5) and the tiled engine's B8 and B9 of a lambdapic_torch tree, and the
3D QED slice's per-stage steps that run B4 3D and B5 3D.

    python3 kernel_ab.py ROOT [b2] [stage3] [steps3d] [migrate2]
                         [migrate3] [variants] [fold3] [stage2] [tiled]

ROOT is the directory that holds the ``lambdapic_torch`` package to time
(``.`` for this checkout; an unpacked ``git archive <commit>
lambdapic_torch`` for another version, with this checkout's
``lambdapic_torch/testing.py`` copied over its own, which makes the
inputs, and for ``steps3d`` ``lambdapic_tpu/models/
optical_depth_tables.npz`` beside it, the QED tables the port reads). Its kernels are built from that tree's sources into that tree's
``_build/``. Two versions are compared by running this script for each in
one call on one card, in turns (parent, change, change, parent), since
cards and calls differ. The groups named after ROOT run (``b2`` and
``stage3`` without any).

Inputs are seeded cell states (``testing.random_cell_state`` and
``testing.occupied_cell_state``), float32, open faces, strong random
fields so that particles cross cells:

- 2D ``uniform``: 1024 x 1024 cells of 20 slots, 3% of the slots alive
  in every cell (the dense-sparse worst case);
- 2D ``band``: 1024 x 1024 cells of 20 slots, a 62-column band across all
  of y at 10 alive slots a cell, every other cell empty (the 2D slice's
  foil: 94% of the cells empty);
- 2D ``qed``: 512 x 512 cells of 82 slots, 90% of the cells holding 10
  alive slots (the 2D QED slice's photons' capacity);
- 3D: 256 x 128 x 128 cells of 8 slots at 30%.

Group ``b2``: B2 runs on each state in its three modes: default,
``want_chi`` (with a QED species' three extra payloads) and ``photon``
(inv_gamma = 1/|u|, the same extras). Prints one ``AB`` line per state
and mode with B2's mean ms a call from CUDA events (host issue included;
B3's beside the uniform 2D and the 3D default) and one ``AB-split`` line
per ``__global__`` function with its device ms a call from
torch.profiler.

Group ``stage3``: B4 3D (default and ``want_eb``, no first half push, as
the per-stage step calls it) and B5 3D on the 3D state and on ``3D
exact``, a state at the exact 3D slice's shape and occupancy, made on the
card from a seed: 512 x 256 x 256 cells of 4 slots, the cells of x >= 26
(95%) holding 1, 2 or 3 alive slots (2 on average), momenta up to 0.2,
fields up to 1e12. A tree whose wrappers take ``alive`` is given the
mask (the per-stage step's call); the parent's kernels take none. Lines
``AB-stage3 <state> <kernel> <ms>`` (CUDA events) and ``AB-split``.

Group ``stage2``: B4 2D (default and ``want_eb``, no first half push,
as the per-stage step calls it) and B5 2D on the 2D states ``uniform``,
``band`` and ``qed`` and on ``2D qed70`` (512 x 512 cells of 70 slots,
90% of the cells holding 10 alive slots: the exact QED slice's electron
capacity, above B4's and B5's 64-slot bit mask). A tree whose wrappers
take ``alive`` is given the mask; the parent's kernels take none. Lines
``AB-stage2 <state> <kernel> <ms>`` (CUDA events) with the bound of
chip_smoke.stage_bounds (the mask form: the mask, the alive slots'
payloads, the gather's nodes, every output slot or J written once),
``AB-split`` per ``__global__`` function, ``AB-stage2 <state> write6``
and ``write12`` (six or twelve arrays of the slots' size zero-filled by
torch: the rate this card reaches for B4's writes alone) and, on a tree
whose push2d.cu holds their texts, the ablations of STAGE2_ABLATIONS
(the tap source, particles a round, blocks an SM) and of
STAGE2_B5_ABLATIONS (B5's blocks an SM), each built beside it by text
substitution and held bit for bit against the tree's library.

Group ``steps3d``: chip_smoke.py's 3D QED configuration (256 x 128 x
128 cells, radiating electrons, protons and photons, float32, seed 0,
built by this checkout's ``chip_smoke.make_slice_qed_3d`` from ROOT's
package) through Simulation3D.run on its two per-stage paths:
``split``, STEPS3D_FUSED fused steps and then split steps (a
_push_momentum callback due every step: B6, the plain gather, QED and
Boris, B5 3D), as chip_smoke.py's split 3D QED phase; ``exact``,
cell_migration="exact" from its own fill (B4 3D, with want_eb for the
electrons, and B5 3D). After STEPS3D_WARM steps of the path, lines
``AB-steps3d <path> <step ms> ...`` give the mean step over STEPS3D_TIMED
steps (host clock, synchronised) and, from torch.profiler over one more
step, the device ms of the step, of B5 3D (deposit3d + fold_pad3) and of
B4 3D (push3d).

Group ``migrate3``: kernel B6 on 3D slots (the fast re-binning, open
faces, the electrons' nine carried payloads: x, y, z, w, ux, uy, uz,
id_lo, id_hi; inv_gamma recomputed on the last axis) on the 3D state and
on ``3D exact``, and K7 (B6 with the neighbour shards' edge columns) on
the 3D state as one shard of the split mesh 3D slice (its 256 x 128 x
128 shard shape), each axis given edge columns taken from the state's
own last (lo) and first (hi) columns along it. Lines ``AB-migrate3
<state> <what> <ms a call> x <ms> y <ms> z <ms>`` (CUDA events): what
``B6`` (one ``migrate_cells_fused`` call of three axes, then each axis
alone), ``K7`` (the same with the edge columns), ``copy`` (a plain copy of
the arrays one axis reads and writes: the mask and every payload, the rate
this card reaches for those bytes) and the ablations of ROOT's
``csrc/migrate.cu``, built beside it by text substitution (ABLATIONS;
``sort``: keys and sort only, one mask byte written a slot; ``place``: the
placement without payloads, only the mask written; in the tile design
also ``stream``: every payload streamed and written back to its own slot,
no placement), with the bound of one axis (its mask and payloads read and
written once over 3.35 TB/s; for K7 the two edge columns read once too,
the mean of the axes). The ablations are those of the design that
re-bins the group's slots in ROOT's source (``migrate_design``: the tile
kernel's, or where 2D slots still run one thread a cell, that design's
``sort`` and ``place``).

Group ``migrate2``: the same for B6 on 2D slots, on the 2D ``band`` and
``uniform`` states (1024 x 1024 cells of 20 slots, the 2D slice's
electron capacity; nine carried payloads: x, y, z, w, ux, uy, uz, id_lo,
id_hi), lines ``AB-migrate2 <state> <what> <ms a call> x <ms> y <ms>``,
and K7 2D on ``2D band 512^2``, the quarter of ``band`` that holds the
band, as the busiest 512 x 512 shard of the split mesh 2D slice's 2 x 2
mesh, with edge columns taken from its own faces.

Group ``fold3``: B3 3D through ``fold_reduce`` on seeded random panels
(made on the card) at the 3D slice's shape, three components (jx, jy,
jz) of 512 x 256 x 256 cells in float32, T = 8, open faces; and K5 3D
through ``fold_reduce`` with a 2 x 2 x 2 mesh of the one card (shards of
256 x 128 x 128 cells, the mesh 3D slice's, open faces, the same kind of
panels). Lines ``AB-fold3 B3 <ms a call>`` and ``AB-fold3 K5 <ms a call
of the whole mesh> (<ms a shard>)`` (CUDA events), ``AB-split fold3
<what> <device ms a call> <launches a call> <kernel>`` (torch.profiler,
every kernel and copy of the call), ``AB-fold3 copy`` (a plain copy of
the panels: the rate this card reaches for those bytes) and the
ablations of FOLD3_ABLATIONS whose texts the tree's fold3d.cu holds
(``AB-fold3 ablate-<name>``, built beside it by text substitution; the
library is held bit for bit against the tree's after them). Bounds: the
panels read once and J written once over 3.35 TB/s; K5 adds its strips.

Group ``tiled``: B8 (``gather_tiled_k``) and B9 (``deposit_tiled_k``)
at bench.py's ``--tiling 32,32`` shapes (24 x 24 tiles of 32 x 32 cells,
halo 5, cap_t 16,384, float32, the electrons' charge, the tiled slice's
dx and dt) on three states made by ``lambdapic_torch/testing.py``:
``fill`` (``tiled_fill_state``: each tile of x index 8 or more holds
10,240 alive slots, ten a cell, cell by cell, as ``bin_tiled`` leaves the
fill; the first third of the tiles empty), ``shuffled`` (the same
particles in random slot order) and ``random`` (``tiled_state``'s: 40% of
every tile's slots alive, drift 3 cells). A tree whose B9 takes the alive
mask is given it; the parent's is given w zeroed in the dead slots.
Lines ``AB-tiled <state> <kernel> <ms>`` (CUDA events) with the bound of
``chip_smoke.tiled_bounds`` (the one ``chip_smoke.py::tiled_rows``
prints), ``AB-split`` per ``__global__`` function, ``AB-tiled <state>
write6`` (B8's six output arrays zero-filled by torch: the floor of its
writes on this card) and the ablations of TILED_ABLATIONS whose texts the
tree's sources hold (built beside it by text substitution; timing floors,
their results are not checked): B9 ``stores`` (the shared-memory atomic
adds made as plain read-modify-writes) and ``interleaved`` (lanes walk
the alive list interleaved, as the parent's threads walked the slots); B8
``noload`` (no window load). ``AB-sass`` lines count the shared-memory
atomic opcodes (``ATOMS.*``) in the tree's built B9 library, from
``cuobjdump -sass``.

Group ``variants``: on a tree whose 2D slots run the tile kernel, B6
(and K7) of each variant of VARIANTS (tile shapes, the dead-tile
shortcut, the inv_gamma sum, blocks an SM) on migrate2's and migrate3's
states, built by text substitution of ROOT's ``csrc/migrate.cu`` (one
nvcc each, at once), each held bit for bit against the plain version on
the state before it is timed; lines ``AB-variants <variant> <state>
<what> ...`` as migrate2's.
"""
import sys


def timed(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_split(fn, iters: int):
    """{kernel name: (device ms a call, launches a call)} of ``iters``
    calls of ``fn`` from torch.profiler; only records after a marker
    kernel count (the profiler may drop the first stretch of a window,
    so a profile that recorded nothing after the marker is taken again
    with 1, then 4 seconds of untimed calls ahead of the marker)."""
    import time
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    out = {}
    for margin in (0.0, 1.0, 4.0):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            while time.time() - t0 < margin:
                fn()
                torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        events = [e for e in prof.events()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
        marks = [e.time_range.start for e in events
                 if "spin_kernel" in e.name]
        out = {}
        for e in events:
            if marks and e.time_range.start > marks[-1]:
                ms, n = out.get(e.name, (0.0, 0))
                out[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        if out:
            break
    return {k: (ms / iters, n / iters) for k, (ms, n) in out.items()}


# (name, slots a cell, cells) of each timed state
STATES = (("2D uniform", 20, (1024, 1024)), ("2D band", 20, (1024, 1024)),
          ("2D qed", 82, (512, 512)), ("3D", 8, (256, 128, 128)))


def make_state(name, cap, n):
    """(data, alive, eb_pad) of a state of STATES."""
    import numpy as np
    from lambdapic_torch.testing import (band_mask, occupied_cell_state,
                                         random_cell_state)
    if name == "2D band":
        return occupied_cell_state(cap, band_mask(*n, n[0] // 2, 62), 10,
                                   seed=1)
    if name == "2D qed":
        occ = np.random.default_rng(3).uniform(size=n) < 0.9
        return occupied_cell_state(cap, occ, 10, seed=1)
    return random_cell_state(cap, *n, n_frac=0.03 if len(n) == 2 else 0.3,
                             seed=1)


# fused steps of the 3D QED slice ahead of its split steps (chip_smoke.py
# runs 200 and its window before them), and split or exact steps run
# untimed, then timed
STEPS3D_FUSED, STEPS3D_WARM, STEPS3D_TIMED = 200, 2, 5

GROUPS = ("b2", "stage3", "steps3d", "migrate2", "migrate3", "variants",
          "fold3", "stage2", "tiled")


def main() -> int:
    if len(sys.argv) < 2 or any(g not in GROUPS for g in sys.argv[2:]):
        print(__doc__, file=sys.stderr)
        return 2
    groups = sys.argv[2:] or ["b2", "stage3"]
    sys.path.insert(0, sys.argv[1])
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import lambdapic_torch
    print(f"package {lambdapic_torch.__file__}", flush=True)
    dev = torch.device("cuda:0")
    if "b2" in groups:
        time_b2(dev)
    if "stage3" in groups:
        time_stage3(dev)
    if "steps3d" in groups:
        time_steps3d(dev)
    if "migrate2" in groups:
        time_migrate(dev, 2)
    if "migrate3" in groups:
        time_migrate(dev, 3)
    if "variants" in groups:
        time_variants(dev)
    if "fold3" in groups:
        time_fold3(dev)
    if "stage2" in groups:
        time_stage2(dev)
    if "tiled" in groups:
        time_tiled(dev)
    return 0


def time_b2(dev):
    import torch
    from lambdapic_torch.ops import kernel_lib
    from lambdapic_torch.ops.cellslab import cell_step, fold_reduce
    from lambdapic_torch.testing import add_qed_payloads, to_torch
    kernel_lib.build(["cellstep", "cellstep3d", "fold", "fold3d"])
    q, m, dt, dx = -1.602e-19, 9.109e-31, 1.1e-16, 5e-8
    for name, cap, n in STATES:
        iters = 20 if len(n) == 2 else 5
        d, a, eb = make_state(name, cap, n)
        td, ta = to_torch(d, a, torch.float32, dev)
        ebt = torch.as_tensor(eb, dtype=torch.float32).to(dev)
        del eb
        kw = dict(q=q, m=m, dt=dt, dx=dx, dy=dx, g=3,
                  periodic=(False,) * len(n), with_rho=False)
        if len(n) == 3:
            kw["dz"] = dx
        b2 = timed(lambda: cell_step(ebt, td, ta, **kw), iters)
        if name in ("2D uniform", "3D"):
            rims = cell_step(ebt, td, ta, **kw)[3]
            b3 = timed(lambda: fold_reduce(rims, n, kw["periodic"]), 50)
            print(f"AB {name[:2]} B2 {b2:.4f} ms B3 {b3:.4f} ms", flush=True)
            del rims
        else:
            print(f"AB {name} B2 {b2:.4f} ms", flush=True)
        qd, _ = to_torch(add_qed_payloads(d, seed=2), a, torch.float32, dev)
        del d
        u2 = qd["ux"]**2 + qd["uy"]**2 + qd["uz"]**2
        pd = dict(qd, inv_gamma=torch.where(
            u2 > 0, 1 / torch.sqrt(u2.clamp_min(1e-30)), 1.0))
        del u2
        calls = {"default": lambda: cell_step(ebt, td, ta, **kw),
                 "want_chi": lambda: cell_step(ebt, qd, ta, want_chi=True,
                                               **kw),
                 "photon": lambda: cell_step(
                     None, pd, ta, **dict(kw, q=0.0, m=0.0, photon=True))}
        for mode, fn in calls.items():
            if mode != "default":
                print(f"AB {name} B2 {mode} {timed(fn, iters):.4f} ms",
                      flush=True)
            for k, (ms, nl) in sorted(device_split(fn, iters).items(),
                                      key=lambda kv: -kv[1][0]):
                print(f"AB-split {name} {mode} {ms:.4f} ms {nl:g} launches "
                      f"{k[:90]}", flush=True)
        del td, ta, ebt, qd, pd, calls
        torch.cuda.empty_cache()


def exact3d_state(dev, seed=11):
    """The ``3D exact`` state on the card: (slots dict, alive, eb_pad)."""
    import torch
    cap, n, g = 4, (512, 256, 256), 3
    gen = torch.Generator(device=dev).manual_seed(seed)

    def uni(lo, hi, shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
    count = torch.randint(1, 4, n, generator=gen, device=dev)
    count[:26] = 0
    slot = torch.arange(cap, device=dev).view(cap, 1, 1, 1)
    alive = slot < count
    del count
    d = {}
    for ax, k in enumerate("xyz"):
        shape = [1, 1, 1, 1]
        shape[ax + 1] = n[ax]
        cell = torch.arange(n[ax], device=dev, dtype=torch.float32)
        d[k] = torch.where(alive, uni(-0.45, 0.45, (cap,) + n)
                           + cell.view(shape), 0.0)
    for k in ("ux", "uy", "uz"):
        d[k] = torch.where(alive, uni(-0.2, 0.2, (cap,) + n), 0.0)
    d["inv_gamma"] = 1 / torch.sqrt(1 + d["ux"]**2 + d["uy"]**2
                                    + d["uz"]**2)
    d["w"] = torch.where(alive, uni(0.5, 1.5, (cap,) + n), 0.0)
    eb = uni(-1e12, 1e12, (6,) + tuple(k + 2 * g for k in n))
    return d, alive, eb


def time_stage3(dev):
    """B4 3D (default, want_eb) and B5 3D on the 3D and 3D exact states."""
    import inspect
    import torch
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops import kernel_lib
    from lambdapic_torch.testing import to_torch
    kernel_lib.build(["push3d", "deposit3d"])
    for lib in ("push3d", "deposit3d"):
        for line in kernel_lib.build_log(lib).splitlines():
            if "registers" in line or "spill" in line:
                print(f"AB-ptxas {lib} {line.strip()}", flush=True)
    masked = "alive" in inspect.signature(cp.fused_push_cell_3d).parameters
    q, m, dt, dx = -1.602e-19, 9.109e-31, 1.1e-16, 5e-8
    for name in ("3D", "3D exact"):
        if name == "3D":
            d, a, eb = make_state("3D", 8, (256, 128, 128))
            td, ta = to_torch(d, a, torch.float32, dev)
            ebt = torch.as_tensor(eb, dtype=torch.float32).to(dev)
            del d, a, eb
        else:
            td, ta, ebt = exact3d_state(dev)
        alive = {"alive": ta} if masked else {}
        args = [td[k] for k in ("x", "y", "z", "ux", "uy", "uz")]
        w = torch.where(ta, td["w"], 0.0)
        k4 = dict(q=q, m=m, dt=dt, dx=dx, dy=dx, dz=dx, g=3, do_pos1=False,
                  **alive)
        a8 = args + [td["inv_gamma"], w]
        k5 = dict(q=q, dx=dx, dy=dx, dz=dx, dt=dt, g=3, **alive)
        calls = {"B4": lambda: cp.fused_push_cell_3d(ebt, *args, **k4),
                 "B4 want_eb": lambda: cp.fused_push_cell_3d(
                     ebt, *args, want_eb=True, **k4),
                 "B5": lambda: cp.deposit_cell_3d_k(*a8, **k5)}
        print(f"AB-stage3 {name}: {int(ta.sum())} of {ta.numel()} slots "
              f"alive, mask given: {masked}", flush=True)
        for kname, fn in calls.items():
            print(f"AB-stage3 {name} {kname} {timed(fn, 10):.4f} ms",
                  flush=True)
            for k, (ms, nl) in sorted(device_split(fn, 5).items(),
                                      key=lambda kv: -kv[1][0]):
                print(f"AB-split {name} {kname} {ms:.4f} ms {nl:g} launches "
                      f"{k[:90]}", flush=True)
            torch.cuda.empty_cache()
        del td, ta, ebt, args, a8, w, calls
        torch.cuda.empty_cache()


# B4 2D's and B5 2D's states (name, slots a cell, cells): STATES' 2D
# ones and ``2D qed70``, 512 x 512 cells of 70 slots (the exact QED 2D
# slice's electrons: B4 reads the alive bytes a round at a time above 64
# slots, B5 counts them), 90% of the cells holding 10 alive slots
STAGE2_STATES = STATES[:3] + (("2D qed70", 70, (512, 512)),)
# Ablations of B4 2D (csrc/push2d.cu), timed in group stage2: name ->
# [(text, replacement)], every text required. ``global``: the taps read
# from the padded fields in device memory through L1 (as B2's rebin2y
# reads them), no shared window; ``stage1024``: rounds of up to 1024
# particles (512 in the source); ``lb2``, ``lb3``: 2 or 3 blocks an SM
# asked of the register allocation (4 in the source).
STAGE2_ABLATIONS = {
    "global": [("  load_window(win, a.eb, a.nx, a.ny, a.g, x0, y0, tid);\n",
                ""),
               ("gather_eb<T, int>(win, TX - 1, TY - 1, 2, lx, ly, ",
                "gather_eb(a.eb, a.nx, a.ny, a.g, ix, iy, "),
               ("constexpr int WINDOW_REALS = 6 * WX * WY;",
                "constexpr int WINDOW_REALS = 0;")],
    "stage1024": [("constexpr int STAGE = 512;",
                   "constexpr int STAGE = 1024;")],
    "lb2": [("__launch_bounds__(THREADS, 4) push(",
             "__launch_bounds__(THREADS, 2) push(")],
    "lb3": [("__launch_bounds__(THREADS, 4) push(",
             "__launch_bounds__(THREADS, 3) push(")],
}

# Ablations of B5 2D (csrc/deposit2d.cu's deposit, cell2d.cuh's tile
# deposit): ``lb1``, ``lb3``: 1 or 3 blocks an SM asked of the register
# allocation (2 in the source; at 2 the float32 kernel spills).
STAGE2_B5_ABLATIONS = {
    "lb1": [("__launch_bounds__(TILE * TILE, 2)\n    deposit(",
             "__launch_bounds__(TILE * TILE, 1)\n    deposit(")],
    "lb3": [("__launch_bounds__(TILE * TILE, 2)\n    deposit(",
             "__launch_bounds__(TILE * TILE, 3)\n    deposit(")],
}


def make_stage2_state(name, cap, n):
    """(data, alive, eb_pad) of a state of STAGE2_STATES."""
    if name != "2D qed70":
        return make_state(name, cap, n)
    import numpy as np
    from lambdapic_torch.testing import occupied_cell_state
    occ = np.random.default_rng(3).uniform(size=n) < 0.9
    return occupied_cell_state(cap, occ, 10, seed=1)


def time_stage2(dev):
    """Group stage2: B4 2D (default and want_eb, no first half push, as
    the per-stage step calls it) and B5 2D on STAGE2_STATES, given the
    alive mask where the tree's wrappers take it; the ablations of
    STAGE2_ABLATIONS whose texts the tree's push2d.cu holds, each held
    bit for bit against the tree's library first."""
    import inspect
    import os
    import torch
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops import kernel_lib
    from lambdapic_torch.testing import to_torch
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    kernel_lib.build(["push2d", "deposit2d"])
    for lib in ("push2d", "deposit2d"):
        ptxas_lines(lib, kernel_lib.build_log(lib),
                    key=("4push", "7deposit", "8fold_pad"))
    masked = "alive" in inspect.signature(cp.fused_push_cell_2d).parameters
    src = (kernel_lib.CSRC / "push2d.cu").read_text()
    have = {k: v for k, v in STAGE2_ABLATIONS.items()
            if all(old in src for old, _ in v)}
    libs = build_variants(have, "ablate-push2d", lib="push2d") if have \
        else {}
    src5 = (kernel_lib.CSRC / "deposit2d.cu").read_text()
    have5 = {k: v for k, v in STAGE2_B5_ABLATIONS.items()
             if all(old in src5 for old, _ in v)}
    libs5 = build_variants(have5, "ablate-deposit2d", lib="deposit2d") \
        if have5 else {}
    q, m, dt, dx = -1.602e-19, 9.109e-31, 1.1e-16, 5e-8
    for name, cap, n in STAGE2_STATES:
        d, a, eb = make_stage2_state(name, cap, n)
        td, ta = to_torch(d, a, torch.float32, dev)
        ebt = torch.as_tensor(eb, dtype=torch.float32).to(dev)
        del d, a, eb
        alive = {"alive": ta} if masked else {}
        args = [td[k] for k in ("x", "y", "ux", "uy", "uz")]
        w = torch.where(ta, td["w"], 0.0)
        a7 = args + [td["inv_gamma"], w]
        k4 = dict(q=q, m=m, dt=dt, dx=dx, dy=dx, g=3, do_pos1=False,
                  **alive)
        k5 = dict(q=q, dx=dx, dy=dx, dt=dt, g=3, **alive)
        calls = {"B4": lambda: cp.fused_push_cell_2d(ebt, *args, **k4),
                 "B4 want_eb": lambda: cp.fused_push_cell_2d(
                     ebt, *args, want_eb=True, **k4),
                 "B5": lambda: cp.deposit_cell_2d_k(*a7, **k5)}
        bounds = chip_smoke.stage_bounds(td, ta, td, ta, 3)
        print(f"AB-stage2 {name}: {int(ta.sum())} of {ta.numel()} slots "
              f"alive, {int(ta.any(0).sum())} of {ta[0].numel()} cells "
              f"occupied, mask given: {masked}", flush=True)
        for kname, fn in calls.items():
            ms = timed(fn, 10)
            print(f"AB-stage2 {name} {kname} {ms:.4f} ms; bound "
                  f"{bounds[kname][0]:.4f} ms ({bounds[kname][2]} bytes, "
                  f"{100 * bounds[kname][0] / ms:.1f}%)", flush=True)
            for k, (t, nl) in sorted(device_split(fn, 5).items(),
                                     key=lambda kv: -kv[1][0]):
                print(f"AB-split {name} {kname} {t:.4f} ms {nl:g} launches "
                      f"{k[:90]}", flush=True)
        # the rate of this card for B4's writes alone: every output array
        # of the slots' size zero-filled
        outs = [torch.empty_like(td["x"]) for _ in range(12)]
        for nout in (6, 12):
            ms = timed(lambda: [o.zero_() for o in outs[:nout]], 10)
            print(f"AB-stage2 {name} write{nout} {ms:.4f} ms "
                  f"({nout * outs[0].numel() * 4 / ms / 1e9:.3f} TB/s)",
                  flush=True)
        del outs
        if libs:
            refs = [[t.clone() for t in calls[k]()]
                    for k in ("B4", "B4 want_eb")]
            for vname, so in libs.items():
                use_lib(so, "push2d")
                same = all(torch.equal(x, y) for k, r in
                           zip(("B4", "B4 want_eb"), refs)
                           for x, y in zip(calls[k](), r))
                t4 = timed(calls["B4"], 10)
                t4e = timed(calls["B4 want_eb"], 10)
                print(f"AB-stage2 {name} ablate-{vname} B4 {t4:.4f} ms, "
                      f"want_eb {t4e:.4f} ms; bitwise the tree's: {same}",
                      flush=True)
            use_lib(None, "push2d")
            del refs
        if libs5:
            ref = calls["B5"]().clone()
            for vname, so in libs5.items():
                use_lib(so, "deposit2d")
                same = torch.equal(calls["B5"](), ref)
                t5 = timed(calls["B5"], 10)
                print(f"AB-stage2 {name} ablate-{vname} B5 {t5:.4f} ms; "
                      f"bitwise the tree's: {same}", flush=True)
            use_lib(None, "deposit2d")
            del ref
        del td, ta, ebt, args, a7, w, calls
        torch.cuda.empty_cache()


def time_steps3d(dev):
    """The 3D QED slice's split and exact per-stage steps (see the module
    docstring)."""
    import os
    import time
    import torch
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from lambdapic_torch import callback
    hook = callback(stage="_push_momentum")(lambda s: None)
    for path in ("split", "exact"):
        sim, laser, _, _ = chip_smoke.make_slice_qed_3d(
            dev, cell_migration="exact" if path == "exact" else "fast")
        sim.initialize()
        cbs = [laser]
        if path == "split":
            sim.run(nsteps=STEPS3D_FUSED, callbacks=cbs)
            cbs = [laser, hook]
        sim.run(nsteps=STEPS3D_WARM, callbacks=cbs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(nsteps=STEPS3D_TIMED, callbacks=cbs)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / STEPS3D_TIMED
        split = device_split(lambda: sim.run(nsteps=1, callbacks=cbs), 1)
        busy = sum(ms for ms, _ in split.values())
        b5 = sum(ms for k, (ms, _) in split.items()
                 if "deposit3d" in k or "fold_pad3" in k)
        b4 = sum(ms for k, (ms, _) in split.items() if "push3d" in k)
        print(f"AB-steps3d {path} {step_ms:.3f} ms a step at step "
              f"{sim.itime}; device {busy:.3f} ms, B5 3D {b5:.4f} ms, B4 3D "
              f"{b4:.4f} ms; alive {sim.npart_alive}, slots "
              f"{[p.cap for p in sim.state.particles]}", flush=True)
        del sim, split
        torch.cuda.empty_cache()


# Ablations of B6 (csrc/migrate.cu), by the design that re-binds the
# group's slots (``migrate_design``): name -> [(text, replacement)], every
# text required. The tile design (3D slots up to 32 slots a cell since PR
# 13, 2D ones too where the source sends them there) and the
# one-thread-a-cell design (every other launch). ``stream``: keys, sort
# and every payload streamed, each output slot taking its own input slot
# (no placement, no merge).
ABLATIONS = {
    "migrate_tile(": {
        "sort": [("const bool vlo = lo_ok && (klo >> SLOT_BITS) == 0;",
                  "const bool vlo = false;"),
                 ("const bool vhi = hi_ok && (khi >> SLOT_BITS) == 4;",
                  "const bool vhi = false;"),
                 ("const int nstream = a.nf + a.ni;",
                  "const int nstream = 1;"),
                 ("for (int j = 0; j < nstream; ++j) {",
                  "for (int j = 0; j < 0; ++j) {")],
        "place": [("const int nstream = a.nf + a.ni;",
                   "const int nstream = 1;"),
                  ("for (int j = 0; j < nstream; ++j) {",
                   "for (int j = 0; j < 0; ++j) {")],
        "stream": [("const unsigned kind = vlo ? 1u : (vhi ? 2u : 0u);",
                    "const unsigned kind = 0u;"),
                   ("const int ks = vlo ? klo : (vhi ? khi : kown);",
                    "const int ks = p;"),
                   ("(n_src > 1 ? M_MULTI : 0)", "0u")]},
    "migrate_cell(a, cell, k, ks, merges)": {
        "sort": [("const int klo = k[p], kown = k[ks + p], khi = k[2 * ks + p];",
                  "const int klo = k[p], kown = k[ks + p], khi = k[2 * ks + p];"
                  " a.alive_out[(long long)p * a.ncell + cell] = (unsigned "
                  "char)(((klo ^ kown ^ khi) >> 16) & 1); continue;")],
        "place": [("for (int f = 0; f < a.nf; ++f) {",
                   "for (int f = 0; f < 0; ++f) {"),
                  ("for (int t = 0; t < a.ni; ++t) {",
                   "for (int t = 0; t < 0; ++t) {"),
                  ("if (a.final_ && a.recompute_ig)", "if (false)")]},
}

# The source's sign that 2D slots run the tile kernel (its dispatch of 2D
# slots (nx, ny) as 3D slots (1, nx, ny)).
TILE_2D = "tile::launch<T>(a, 1, (int)nx, (int)ny, axis + 1, st)"


def migrate_design(src, nd):
    """The ABLATIONS key of the design that re-bins ``nd``-D slots of up
    to 32 slots a cell in the source text ``src``."""
    if "migrate_tile(" in src and (nd == 3 or TILE_2D in src):
        return "migrate_tile("
    if "migrate_cell(a, cell, k, ks, merges)" in src:
        return "migrate_cell(a, cell, k, ks, merges)"
    raise RuntimeError("kernel_ab: csrc/migrate.cu holds no known design")


# Variants of this tree's csrc/migrate.cu timed in group ``variants``, by
# rank: name -> [(text, replacement)] (``base``: the source as it is). 2D:
# the tile shapes of the 2D slices' 20 slots (capacity class 24; ``no24``
# runs them in class 32), a 64 KiB ring, the dead-tile shortcut off, 1 +
# u^2 summed in registers at every class, two blocks an SM above 16 slots,
# four at every class; 3D: the shortcut at every class, inv_gamma
# recomputed from the written ux and uy at every class.
D24X = "template <> struct Dims<24, 0> { static constexpr int W = 32, S = 4; };"
D24Z = "template <> struct Dims<24, 2> { static constexpr int W = 128, S = 1; };"
C24 = ("  if (a.cap <= 24)\n    return pick<T, 24>(a, g, nouter, vec, st, z, "
       "nz);\n")
NODEAD = [("if constexpr (MAXC > 8) live = __syncthreads_or(al_bits != 0);",
           "")]
SUM_U = "constexpr bool SUM_U = Sh::ITEMS <= 8;"
VARIANTS = {
    2: {"base": [],
        "no24": [(C24, "")],
        "x24w16s8": [(D24X, D24X.replace("W = 32, S = 4", "W = 16, S = 8"))],
        "x24w8s16": [(D24X, D24X.replace("W = 32, S = 4", "W = 8, S = 16"))],
        "z24w64s2": [(D24Z, D24Z.replace("W = 128, S = 1", "W = 64, S = 2"))],
        "z24w256": [(D24Z, D24Z.replace("W = 128", "W = 256"))],
        "ring64": [("RING = 48 * 1024;", "RING = 64 * 1024;")],
        "nodead": NODEAD,
        "sumu": [(SUM_U, "constexpr bool SUM_U = true;")],
        "lb2": [("__launch_bounds__(THREADS, MAXC <= 4 ? 4 : 3)",
                 "__launch_bounds__(THREADS, MAXC <= 4 ? 4 : "
                 "(MAXC > 16 ? 2 : 3))")],
        "lb4": [("__launch_bounds__(THREADS, MAXC <= 4 ? 4 : 3)",
                 "__launch_bounds__(THREADS, 4)")]},
    3: {"base": [],
        "dead": [("if constexpr (MAXC > 8) live", "live")],
        "reread": [(SUM_U, "constexpr bool SUM_U = false;")]},
}


def build_variants(variants, tag, lib="migrate"):
    """{name: built library path} of this tree's csrc/<lib>.cu with each
    variant's text substitutions, one nvcc each, all at once, into
    _build/<tag>-<name>/."""
    import subprocess
    from lambdapic_torch.ops import kernel_lib
    src = (kernel_lib.CSRC / f"{lib}.cu").read_text()
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"kernel_ab: {tag} {name}: {old!r} not in "
                                   f"csrc/{lib}.cu")
            text = text.replace(old, new)
        d = kernel_lib.BUILD / f"{tag}-{name}"
        d.mkdir(parents=True, exist_ok=True)
        so = d / f"lib{lib}.so"
        cu = d / f"{lib}.cu"
        if so.exists() and cu.exists() and cu.read_text() == text:
            procs[name] = (so, None)   # built by an earlier run
            continue
        so.unlink(missing_ok=True)
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [kernel_lib.nvcc_path(), *kernel_lib.FLAGS, "-I",
             str(kernel_lib.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, p) in procs.items():
        if p is None:
            out[name] = so
            continue
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"kernel_ab: {tag} {name}:\n{log}")
        if name == "base":
            ptxas_lines(f"{tag}-{name}", log)
        out[name] = so
    return out


def ablation_libs(tags, nd):
    """{ablation name: built library path} of this tree's csrc/migrate.cu
    for the design that re-bins ``nd``-D slots (``migrate_design``)."""
    from lambdapic_torch.ops import kernel_lib
    src = (kernel_lib.CSRC / "migrate.cu").read_text()
    subs = ABLATIONS[migrate_design(src, nd)]
    return build_variants({k: v for k, v in subs.items() if k in tags},
                          f"ablate{nd}d")


def use_lib(path, lib="migrate"):
    """Point library ``lib``'s wrappers at the library ``path`` (None: the
    tree's own)."""
    import ctypes
    from lambdapic_torch.ops import kernel_lib
    for key in [k for k in kernel_lib._FNS if k[0] == lib]:
        del kernel_lib._FNS[key]
    if path is None:
        kernel_lib._LIBS.pop(lib, None)
    else:
        kernel_lib._LIBS[lib] = ctypes.CDLL(str(path))


def self_edges(td, ta, names):
    """{axis: (lo, hi)} edge columns of a state taken from its own last
    (lo) and first (hi) columns along each axis, as cellslab.edge_columns
    gives them (alive as int32)."""
    import torch
    edges = {}
    for ax in range(ta.dim() - 1):
        n = ta.shape[1 + ax]
        edges[ax] = tuple(
            {"alive": ta.narrow(1 + ax, c, 1).to(torch.int32).contiguous(),
             **{k: td[k].narrow(1 + ax, c, 1).contiguous() for k in names}}
            for c in (n - 1, 0))
    return edges


def migrate_states(dev, nd):
    """(name, data, alive, whats) of group migrate2's (nd 2) or migrate3's
    (nd 3) states, float32 on the card, with int32 ids; ``whats`` the
    timings a state takes (``B6``: one-device B6; ``K7``: B6 with edge
    columns taken from its own faces)."""
    import torch
    from lambdapic_torch.testing import to_torch
    if nd == 2:
        for name in ("2D band", "2D uniform"):
            d, a, _ = make_state(name, 20, (1024, 1024))
            td, ta = to_torch(d, a, torch.float32, dev)
            del d, a
            yield name, td, ta, ("B6",)
            if name == "2D band":
                # the busiest 512^2 shard of the split mesh 2D slice's 2 x 2
                # mesh: the quarter that holds the band
                q = (slice(None), slice(512, 1024), slice(0, 512))
                yield ("2D band 512^2", {k: v[q].contiguous()
                                         for k, v in td.items()},
                       ta[q].contiguous(), ("K7",))
            del td, ta
            torch.cuda.empty_cache()
        return
    d, a, _ = make_state("3D", 8, (256, 128, 128))
    td, ta = to_torch(d, a, torch.float32, dev)
    del d, a
    yield "3D", td, ta, ("B6", "K7")
    del td, ta
    torch.cuda.empty_cache()
    td, ta, eb = exact3d_state(dev)
    del eb
    n = ta.numel()
    td["id_lo"] = torch.arange(n, dtype=torch.int32, device=dev).view(
        ta.shape)
    td["id_hi"] = torch.zeros_like(td["id_lo"])
    yield "3D exact", td, ta, ("B6",)


class MigrateTimer:
    """Times B6 on one state of group migrate2 or migrate3: one
    ``migrate_cells_fused`` call of every axis, then each axis alone (CUDA
    events), with or without edge columns, and a plain copy of one axis's
    arrays."""

    def __init__(self, group, name, td, ta):
        from lambdapic_torch.ops.cell2d import TRANSIENT
        self.group, self.name, self.td, self.ta = group, name, td, ta
        self.nd = ta.dim() - 1
        self.names = sorted(k for k in td if k not in TRANSIENT)
        self.plan = tuple(zip(ta.shape[1:], (False,) * self.nd, "xyz"))
        self.per_slot = 1 + sum(td[k].element_size() for k in self.names)
        # an axis's mask and payloads read and written once (and the two
        # edge columns read once with edges)
        self.bound = 2 * ta.numel() * self.per_slot / 3.35e12 * 1e3

    def calls(self, edges):
        from lambdapic_torch.ops import cellpallas as cp
        td, ta, plan, nd = self.td, self.ta, self.plan, self.nd
        e = edges or {}
        axes = [lambda ax=ax: cp.migrate_cells_fused(
            td, ta, (plan[ax],), finish=ax == nd - 1,
            edges={ax: e[ax]} if ax in e else None) for ax in range(nd)]
        return [lambda: cp.migrate_cells_fused(td, ta, plan,
                                               edges=edges)] + axes

    def report(self, what, edges=None, iters=10, device=False):
        """One line: CUDA events ms of the call of every axis and of each
        axis alone (host issue included); with ``device`` also each
        axis's device ms of the B6 launch from torch.profiler."""
        import torch
        fns = self.calls(edges)
        ms = [timed(f, iters) for f in fns]
        axes = " ".join(f"{'xyz'[i]} {m:.4f}" for i, m in enumerate(ms[1:]))
        if device:
            dev = [sum(t for k, (t, _) in device_split(f, iters).items()
                       if "migrate" in k) for f in fns[1:]]
            axes += "; device " + " ".join(
                f"{'xyz'[i]} {m:.4f}" for i, m in enumerate(dev))
        bound = self.bound
        if edges:
            # the two edge columns (an int32 mask) read once, the mean of
            # the axes
            cols = [self.ta.numel() // n for n in self.ta.shape[1:]]
            bound += 2 * sum(cols) / self.nd * (3 + self.per_slot) \
                / 3.35e12 * 1e3
        print(f"AB-{self.group} {self.name} {what} {ms[0]:.4f} ms {axes}; "
              f"bound an axis {bound:.4f} ms ({int(self.ta.sum())} of "
              f"{self.ta.numel()} slots alive, {self.ta.shape[0]} a cell)",
              flush=True)
        torch.cuda.empty_cache()
        return ms

    def copy(self):
        import torch
        src = [self.ta] + [self.td[k] for k in self.names]
        dst = [torch.empty_like(t) for t in src]

        def run():
            for s, t in zip(src, dst):
                t.copy_(s)
        ms = timed(run, 10)
        print(f"AB-{self.group} {self.name} copy {ms:.4f} ms an axis's "
              f"arrays ({2 * self.ta.numel() * self.per_slot / ms / 1e9:.3f}"
              f" TB/s); bound {self.bound:.4f} ms", flush=True)
        del src, dst
        torch.cuda.empty_cache()

    def same_as_plain(self, edges=None):
        """Whether B6 (the library in use) gives the plain version's
        arrays bit for bit, every axis in one call."""
        import torch
        from lambdapic_torch.ops import cellpallas as cp
        from lambdapic_torch.ops.cell2d import migrate_cells
        got = cp.migrate_cells_fused(self.td, self.ta, self.plan, edges=edges)
        ref = migrate_cells(self.td, self.ta, self.plan, edges=edges)
        ok = torch.equal(got[1], ref[1]) and int(got[2]) == int(ref[2]) \
            and sorted(got[0]) == sorted(ref[0]) \
            and all(torch.equal(got[0][k], ref[0][k]) for k in ref[0])
        del got, ref
        torch.cuda.empty_cache()
        return ok


def ptxas_lines(tag, log, key="migrate_"):
    """One ``AB-ptxas`` line per __global__ function of a build log: its
    name from ``key`` (or the first of a tuple of keys that it holds) on,
    its registers and spills."""
    fn, spill = "", ""
    for line in log.splitlines():
        if "entry function" in line and "'" in line:
            fn = line.split("'")[1]
            for k in (key,) if isinstance(key, str) else key:
                if k in fn:
                    fn = fn[fn.find(k):]
                    break
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            regs = line[line.find("Used"):].split(",")[0]
            print(f"AB-ptxas {tag} {fn[:40]} {regs}; {spill}", flush=True)


def migrate_build():
    from lambdapic_torch.ops import kernel_lib
    kernel_lib.build(["migrate"])
    ptxas_lines("migrate", kernel_lib.build_log("migrate"))


def time_migrate(dev, nd):
    """Group migrate2 (nd 2) or migrate3 (nd 3): see the module
    docstring."""
    group = f"migrate{nd}"
    migrate_build()
    libs = ablation_libs(("sort", "place", "stream"), nd)
    for name, td, ta, whats in migrate_states(dev, nd):
        t = MigrateTimer(group, name, td, ta)
        if "B6" in whats:
            t.report("B6", device=True)
        if "K7" in whats:
            t.report("K7", self_edges(td, ta, t.names), device=True)
        t.copy()
        if "B6" in whats:
            for abl, so in libs.items():
                use_lib(so)
                t.report(f"ablate-{abl}")
            use_lib(None)
        del t, td, ta


def time_variants(dev):
    """Group variants: B6 (and K7) of each variant of VARIANTS on group
    migrate2's and migrate3's states, each held bit for bit against the
    plain version first (not on ``3D exact``, whose plain version takes
    most of the card); lines ``AB-variants <variant> <state> <what> ...``
    as migrate2's."""
    from lambdapic_torch.ops import kernel_lib
    src = (kernel_lib.CSRC / "migrate.cu").read_text()
    if migrate_design(src, 2) != "migrate_tile(":
        print("AB-variants: this tree runs no 2D tile kernel", flush=True)
        return
    migrate_build()
    for nd, variants in VARIANTS.items():
        libs = build_variants(variants, f"variants{nd}d")
        for name, td, ta, whats in migrate_states(dev, nd):
            for var, so in libs.items():
                use_lib(so)
                t = MigrateTimer(f"variants {var}", name, td, ta)
                for what in whats:
                    edges = self_edges(td, ta, t.names) if what == "K7" \
                        else None
                    if name != "3D exact" and not t.same_as_plain(edges):
                        print(f"AB-variants {var} {name} {what}: differs "
                              "from the plain version", flush=True)
                        continue
                    t.report(what, edges, device=True)
                    del edges
                del t
            use_lib(None)
            del td, ta


# Ablations and variants of B3 3D (csrc/fold3d.cu's fold3_pencil), timed
# in group fold3: name -> [(text, replacement)], every text required.
# ``nowrite``: the panel stream and the sums, no J written; ``single``:
# one panel in flight a block (no double buffering); ``nostage``: no panel
# copied (the sums of whatever shared memory holds), every J row written;
# ``rt1``, ``rt2``, ``rt8``: 1, 2 or 8 z tiles a column written out at
# once (4 in the source; at 1 each column's 32-byte row of a tile still
# goes out as one sector a pair of threads).
FOLD3_ABLATIONS = {
    "nowrite": [("        if (ci >= nx || cj >= ny || z < z0 || z >= z1) "
                 "continue;", "        continue;")],
    "single": [("      cp_wait<1>();", "      cp_wait<0>();")],
    "nostage": [("      if (off >= 0) cp16(", "      if (off < -1) cp16(")],
    "rt1": [("constexpr int RT = 4;", "constexpr int RT = 1;")],
    "rt2": [("constexpr int RT = 4;", "constexpr int RT = 2;")],
    "rt8": [("constexpr int RT = 4;", "constexpr int RT = 8;")],
}
# B3 3D's state (the 3D slice) and K5 3D's shards (the mesh 3D slice's)
FOLD3_SHAPE, FOLD3_MESH = (512, 256, 256), (2, 2, 2)


def time_fold3(dev):
    """Group fold3: see the module docstring."""
    import torch
    from lambdapic_torch.ops import kernel_lib
    from lambdapic_torch.ops.cellslab import fold_reduce, panel_shape
    from lambdapic_torch.parallel.halo import HaloSpec
    from lambdapic_torch.parallel.mesh import Mesh
    kernel_lib.build(["fold3d"])
    ptxas_lines("fold3d", kernel_lib.build_log("fold3d"), key="fold3")
    gen = torch.Generator(device=dev).manual_seed(3)
    shape, ncomp, bps = FOLD3_SHAPE, 3, 3.35e12
    rims = torch.randn(panel_shape(ncomp, *shape), generator=gen,
                       device=dev)
    per = (False,) * 3
    pan_b = rims.numel() * 4
    bound = (pan_b + ncomp * 4 * shape[0] * shape[1] * shape[2]) / bps * 1e3

    def b3():
        return fold_reduce(rims, shape, per)
    ms = timed(b3, 20)
    print(f"AB-fold3 B3 {ms:.4f} ms; bound {bound:.4f} ms "
          f"({100 * bound / ms:.1f}%)", flush=True)
    for k, (t, n) in sorted(device_split(b3, 20).items(),
                            key=lambda kv: -kv[1][0]):
        print(f"AB-split fold3 B3 {t:.4f} ms {n:g} launches {k[:90]}",
              flush=True)
    dst = torch.empty_like(rims)
    cms = timed(lambda: dst.copy_(rims), 20)
    print(f"AB-fold3 copy {cms:.4f} ms for the panels "
          f"({2 * pan_b / cms / 1e9:.3f} TB/s)", flush=True)
    del dst
    src = (kernel_lib.CSRC / "fold3d.cu").read_text()
    have = {k: v for k, v in FOLD3_ABLATIONS.items()
            if all(old in src for old, _ in v)}
    if have:
        libs = build_variants(have, "ablate-fold3", lib="fold3d")
        ref = b3()
        for name, so in libs.items():
            use_lib(so, "fold3d")
            t = timed(b3, 20)
            dt = sum(v for k, (v, _) in device_split(b3, 20).items()
                     if "fold3" in k)
            print(f"AB-fold3 ablate-{name} {t:.4f} ms, device {dt:.4f} ms",
                  flush=True)
        use_lib(None, "fold3d")
        if not torch.equal(b3(), ref):
            print("AB-fold3: the tree's library differs after the "
                  "ablations", flush=True)
        del ref
    else:
        print("AB-fold3: this tree's fold3d.cu holds none of the "
              "ablations' texts", flush=True)
    del rims
    torch.cuda.empty_cache()
    names = ("px", "py", "pz")
    n = int(torch.tensor(FOLD3_MESH).prod())
    nloc = tuple(k // m for k, m in zip(shape, FOLD3_MESH))
    mesh = Mesh(FOLD3_MESH, names, (dev,) * n)
    specs = tuple(HaloSpec(names[i], FOLD3_MESH[i], False) for i in range(3))
    shards = [torch.randn(panel_shape(ncomp, *nloc), generator=gen,
                          device=dev) for _ in range(n)]
    cells = nloc[0] * nloc[1] * nloc[2]
    strip_b = sum(2 * 2 * ncomp * cells // nloc[ax] * 4 for ax in range(3))
    k5_bound = (shards[0].numel() * 4 + ncomp * cells * 4 + 2 * strip_b) \
        / bps * 1e3

    def k5():
        return fold_reduce(shards, nloc, None, mesh, specs)
    ms = timed(k5, 20)
    print(f"AB-fold3 K5 {ms:.4f} ms ({ms / n:.4f} a shard); bound a shard "
          f"{k5_bound:.4f} ms", flush=True)
    for k, (t, c) in sorted(device_split(k5, 20).items(),
                            key=lambda kv: -kv[1][0]):
        print(f"AB-split fold3 K5 {t:.4f} ms {c:g} launches {k[:90]}",
              flush=True)
    del shards
    torch.cuda.empty_cache()



# bench.py's --tiling 32,32 laser-target: (tx, ty, ntx, nty, h, cap_t)
TILED_AB = (32, 32, 24, 24, 5, 16384)
TILED_STATES = ("fill", "shuffled", "random")
# (name, library, text substitutions) of the tiled group's ablations; an
# entry is built where its texts are in the tree's source, so each
# design (the parent's and this one) has its own
TILED_ABLATIONS = [
    ("stores", "deposit_tiled",
     [("atomicAdd(acc + cx * wy + cy, v);", "acc[cx * wy + cy] += v;")]),
    ("interleaved", "deposit_tiled",
     [("const int stride = 1, span = run;",
       "const int stride = THREADS, span = 1;")]),
    ("noload", "gather_tiled",
     [("      load_windows(a, ti, tj, win);", "      ;")]),
    ("noload", "gather_tiled",
     [("for (int k = threadIdx.x; k < 6 * nw; k += blockDim.x) {",
       "for (int k = threadIdx.x; k < 0; k += blockDim.x) {")]),
]


def sass_atoms(lib):
    """``AB-sass`` lines: each shared-memory atomic opcode of library
    ``lib`` as built for this tree, with its count."""
    import os
    import re
    import subprocess
    from collections import Counter
    from lambdapic_torch.ops import kernel_lib
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        print(f"AB-sass {lib}: no cuobjdump", flush=True)
        return
    out = subprocess.run([tool, "-sass", str(kernel_lib._target(lib))],
                         capture_output=True, text=True).stdout
    ops = Counter(re.findall(r"\b(ATOMS\.[A-Z0-9_.]+)", out))
    print(f"AB-sass {lib}: " + (", ".join(f"{k} x {v}" for k, v in
                                        sorted(ops.items())) or "no ATOMS"),
          flush=True)


def time_tiled(dev):
    """Group tiled: B8 and B9 on TILED_STATES (see the module
    docstring)."""
    import inspect
    import os
    import torch
    from lambdapic_torch.ops import kernel_lib
    from lambdapic_torch.ops import tiled2d_kernels as tk
    from lambdapic_torch.ops.tiled2d import TileCfg
    from lambdapic_torch.testing import (tiled_fill_state, tiled_state,
                                         to_torch)
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    kernel_lib.build(["gather_tiled", "deposit_tiled"])
    for lib in ("gather_tiled", "deposit_tiled"):
        ptxas_lines(lib, kernel_lib.build_log(lib), key=("gather", "deposit"))
    sass_atoms("deposit_tiled")
    masked = "alive" in inspect.signature(tk.deposit_tiled_k).parameters
    libs = {}
    for lib in ("gather_tiled", "deposit_tiled"):
        src = (kernel_lib.CSRC / f"{lib}.cu").read_text()
        have = {name: subs for name, lb, subs in TILED_ABLATIONS
                if lb == lib and all(old in src for old, _ in subs)}
        if have:
            libs[lib] = build_variants(have, f"ablate-{lib}", lib=lib)
    tx, ty, ntx, nty, h, cap = TILED_AB
    cfg = TileCfg(tx=tx, ty=ty, ntx=ntx, nty=nty, cap_t=cap, h=h)
    # the tiled slice's cell and step (chip_smoke.make_slice_tiled)
    dx = 0.8e-6 / 16
    kw = dict(q=-1.602176634e-19, dx=dx, dy=dx,
              dt=0.95 * dx / 2**0.5 / 2.99792458e8)
    for state in TILED_STATES:
        if state == "random":
            d, a, eb = tiled_state(cfg, seed=1, drift=h - 2)
        else:
            d, a, eb = tiled_fill_state(cfg, seed=1, first_tile=8,
                                        shuffle=state == "shuffled")
        td, ta = to_torch(d, a, torch.float32, dev)
        ebt = torch.as_tensor(eb, dtype=torch.float32).to(dev)
        del d, a, eb
        x, y = td["x"], td["y"]
        dargs = [td[k] for k in ("x", "y", "ux", "uy", "uz", "inv_gamma")]
        if masked:
            dargs += [td["w"], ta]
        else:
            dargs += [torch.where(ta, td["w"], 0.0)]
        calls = {"B8": lambda: tk.gather_tiled_k(ebt, x, y, cfg),
                 "B9": lambda: tk.deposit_tiled_k(*dargs, cfg, **kw)}
        bounds = chip_smoke.tiled_bounds(cfg, ta, ebt.numel(), 4)
        print(f"AB-tiled {state}: {int(ta.sum())} of {ta.numel()} slots "
              f"alive, {int(ta.any(-1).sum())} of {ntx * nty} tiles "
              f"occupied, mask given: {masked}", flush=True)
        for kname, fn in calls.items():
            ms = timed(fn, 20)
            b_ms, nbytes, _ = bounds[kname]
            print(f"AB-tiled {state} {kname} {ms:.4f} ms; bound {b_ms:.4f} "
                  f"ms ({nbytes} bytes, {100 * b_ms / ms:.1f}%)", flush=True)
            for k, (t, nl) in sorted(device_split(fn, 5).items(),
                                     key=lambda kv: -kv[1][0]):
                print(f"AB-split {state} {kname} {t:.4f} ms {nl:g} launches "
                      f"{k[:90]}", flush=True)
        outs = [torch.empty_like(x) for _ in range(6)]
        ms = timed(lambda: [o.zero_() for o in outs], 20)
        print(f"AB-tiled {state} write6 {ms:.4f} ms "
              f"({6 * x.numel() * 4 / ms / 1e9:.3f} TB/s)", flush=True)
        del outs
        for lib, kname in (("gather_tiled", "B8"), ("deposit_tiled", "B9")):
            for vname, so in libs.get(lib, {}).items():
                use_lib(so, lib)
                print(f"AB-tiled {state} ablate-{vname} {kname} "
                      f"{timed(calls[kname], 20):.4f} ms", flush=True)
            use_lib(None, lib)
        del td, ta, ebt, dargs, calls, x, y
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
