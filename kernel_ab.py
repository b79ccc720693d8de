#!/usr/bin/env python3
"""Time the one-device kernels B2 and B3, and the per-stage 3D kernels B4
and B5, of a lambdapic_torch tree, and the 3D QED slice's per-stage
steps that run B4 3D and B5 3D.

    python3 kernel_ab.py ROOT [b2] [stage3] [steps3d] [migrate3]

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
written once over 3.35 TB/s).
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

GROUPS = ("b2", "stage3", "steps3d", "migrate3")


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
    if "migrate3" in groups:
        time_migrate3(dev)
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


# Ablations of B6 (csrc/migrate.cu), by the design the source holds (the
# first marker string found): name -> [(text, replacement)], every text
# required. The tile design of 3D slots up to 32 slots a cell and the
# one-thread-a-cell design (a tree without the tile design runs it for
# every B6 launch; one with it, for 2D slots and above 32 slots a cell). ``stream``: keys, sort and every payload streamed, each output
# slot taking its own input slot (no placement, no merge).
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


def ablation_libs(tags):
    """{ablation name: built library path} of this tree's csrc/migrate.cu,
    one nvcc each, all at once, into _build/ablate-<name>/."""
    import subprocess
    from lambdapic_torch.ops import kernel_lib
    src = (kernel_lib.CSRC / "migrate.cu").read_text()
    design = [k for k in ABLATIONS if k in src]
    if not design:
        raise RuntimeError("kernel_ab: csrc/migrate.cu holds no known design")
    procs = {}
    for name, subs in ABLATIONS[design[0]].items():
        if name not in tags:
            continue
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"kernel_ab: ablation {name}: {old!r} "
                                   "not in csrc/migrate.cu")
            text = text.replace(old, new)
        d = kernel_lib.BUILD / f"ablate-{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "migrate.cu").write_text(text)
        so = d / "libmigrate.so"
        procs[name] = (so, subprocess.Popen(
            [kernel_lib.nvcc_path(), *kernel_lib.FLAGS, "-I",
             str(kernel_lib.CSRC), "-o", str(so), str(d / "migrate.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"kernel_ab: ablation {name}:\n{log}")
        out[name] = so
    return out


def use_migrate_lib(path):
    """Point B6's wrapper at the library ``path`` (None: the tree's own)."""
    import ctypes
    from lambdapic_torch.ops import kernel_lib
    kernel_lib._FNS.pop(("migrate", "lp_migrate_axis"), None)
    if path is None:
        kernel_lib._LIBS.pop("migrate", None)
    else:
        kernel_lib._LIBS["migrate"] = ctypes.CDLL(str(path))


def migrate3_states(dev):
    """(name, data, alive) of group migrate3's states, float32 on the card,
    with int32 ids; the 3D state's inv_gamma as random_cell_state gives it."""
    import torch
    from lambdapic_torch.testing import to_torch
    d, a, _ = make_state("3D", 8, (256, 128, 128))
    td, ta = to_torch(d, a, torch.float32, dev)
    del d, a
    yield "3D", td, ta
    del td, ta
    torch.cuda.empty_cache()
    td, ta, eb = exact3d_state(dev)
    del eb
    n = ta.numel()
    td["id_lo"] = torch.arange(n, dtype=torch.int32, device=dev).view(
        ta.shape)
    td["id_hi"] = torch.zeros_like(td["id_lo"])
    yield "3D exact", td, ta


def time_migrate3(dev):
    """Group migrate3 (see the module docstring)."""
    import torch
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops import kernel_lib
    from lambdapic_torch.ops.cell2d import TRANSIENT
    kernel_lib.build(["migrate"])
    for line in kernel_lib.build_log("migrate").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"AB-ptxas migrate {line.strip()}", flush=True)
    libs = ablation_libs(("sort", "place", "stream"))
    for name, td, ta in migrate3_states(dev):
        cells = tuple(ta.shape[1:])
        names = sorted(k for k in td if k not in TRANSIENT)
        plan = tuple(zip(cells, (False,) * 3, "xyz"))
        per_slot = 1 + sum(td[k].element_size() for k in names)
        bound = 2 * ta.numel() * per_slot / 3.35e12 * 1e3

        def calls(edges):
            e = edges or {}
            axes = [lambda ax=ax: cp.migrate_cells_fused(
                td, ta, (plan[ax],), finish=ax == 2,
                edges={ax: e[ax]} if ax in e else None) for ax in range(3)]
            return [lambda: cp.migrate_cells_fused(td, ta, plan,
                                                   edges=edges)] + axes

        def report(what, fns, iters=10):
            ms = [timed(f, iters) for f in fns]
            print(f"AB-migrate3 {name} {what} {ms[0]:.4f} ms x {ms[1]:.4f} "
                  f"y {ms[2]:.4f} z {ms[3]:.4f}; bound an axis {bound:.4f} "
                  f"ms ({int(ta.sum())} of {ta.numel()} slots alive, "
                  f"{ta.shape[0]} a cell)", flush=True)
            torch.cuda.empty_cache()

        report("B6", calls(None))
        if name == "3D":
            edges = {}
            for ax in range(3):
                n = cells[ax]
                col = {"lo": n - 1, "hi": 0}
                edges[ax] = tuple(
                    {"alive": ta.narrow(1 + ax, c, 1).to(torch.int32)
                     .contiguous(),
                     **{k: td[k].narrow(1 + ax, c, 1).contiguous()
                        for k in names}} for c in col.values())
            report("K7", calls(edges))
            del edges
        src = [ta] + [td[k] for k in names]
        dst = [torch.empty_like(t) for t in src]

        def copy():
            for s, t in zip(src, dst):
                t.copy_(s)
        ms = timed(copy, 10)
        print(f"AB-migrate3 {name} copy {ms:.4f} ms an axis's arrays "
              f"({2 * ta.numel() * per_slot / ms / 1e9:.3f} TB/s); bound "
              f"{bound:.4f} ms", flush=True)
        del src, dst
        torch.cuda.empty_cache()
        for abl, so in libs.items():
            use_migrate_lib(so)
            report(f"ablate-{abl}", calls(None))
        use_migrate_lib(None)
        del td, ta
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
