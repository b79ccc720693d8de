#!/usr/bin/env python3
"""Run the lambdapic_torch port on one CUDA card and check it.

    python3 chip_smoke.py [--steps N] [--window W] [--steps-qed N]
                          [--window-qed W] [--steps3d N] [--window3d W]
                          [--steps-exact N] [--window-exact W]
                          [--steps-exact-qed N] [--steps-split N]
                          [--steps-split-sort N] [--steps-split3d N]
                          [--steps-split-sort3d N] [--steps-exact3d N]
                          [--window-exact3d W] [--steps-qed3d N]
                          [--window-qed3d W] [--steps-split-qed3d N]
                          [--steps-exact-qed3d N] [--steps-tiled N]
                          [--window-tiled W] [--steps-tiled-qed N]
                          [--steps-mesh N] [--window-mesh W]
                          [--steps-mesh3d N] [--window-mesh3d W]
                          [--steps-qed-mesh N] [--window-qed-mesh W]
                          [--steps-qed-mesh3d N] [--steps-split-mesh N]
                          [--steps-exact-mesh N] [--steps-split-mesh3d N]
                          [--steps-exact-qed-mesh3d N]
    python3 chip_smoke.py --exact2d-digest N

Phases (any failure exits non-zero):

1. build the CUDA kernels from lambdapic_torch/csrc (one nvcc per source,
   in parallel) and print nvcc's register and spill lines;
2. hold each kernel, in its 2D and its 3D form, against its plain PyTorch
   version on the card: in float64 at small sizes under the CPU tests'
   rules (slot for slot after canonicalisation, with merges in one case),
   and in float32 at each slice's shapes (alive masks and ids identical,
   total weight, J panels);
3. drive the 2D slice, example/laser-target.py at full size without its
   diagnostics (1024 x 1024 cells, three species at 10 particles per cell,
   PML, GaussianLaser2D a0=10, float32), through Simulation.run with the
   launch counters set to 0 just before; check finite fields, particle
   number and weight conservation, and the launches per step
   (B1 4, B2 3, B3 1); time a steady window;
4. time each 2D kernel with CUDA events at the slice's shapes, and its
   plain version once; B2's device time is printed per __global__
   function (rebin2x, rebin2y, deposit2), its bound beside the occupied
   cells and tiles (a device-bound kernel call of at least EVENT_MS is
   profiled only where its split is printed: B2 2D, B2 3D, B5 3D);
5. QED: B2's want_chi and photon modes against their plain versions
   (float64 slot for slot at small sizes, with merges and with QED
   payloads; float32 at the slice's shapes), the in-step draws on the card
   against the CPU (bitwise), and the QED slice, example/photons.py at full
   size without its diagnostics (512 x 512 cells, radiating electrons and
   protons at 10 particles per cell, a photon species, PML, SimpleLaser2D
   a0=300, float32, the example's 100 fs) through Simulation.run
   (launches per step B1 4, B2 3 = want_chi + default + photon, B3 1); a
   creation phase on its own conserves momentum; times of both modes,
   of the plain-torch QED work, and the host synchronisations it adds;
6. the same as 2-4 for the 3D slice, example/laser-target-3d.py at full
   size without its diagnostics (512 x 256 x 256 cells, electrons and
   protons at 2 particles per cell, PML on six faces, GaussianLaser3D
   a0=10, float32), through Simulation3D.run (launches per step B1 4,
   B2 2, B3 1), and for the 3D kernels at its shapes; B2 3D's device
   time is printed per __global__ function (three rebin3 passes and the
   tile kernel tail3; photon3 in place of tail3 in the photon mode);
7. the per-stage engine (2D): after phase 4 the 2D slice goes on through
   split steps (a host callback at _push_momentum due every step:
   launches per step B1 4, B6 6, B5 3; one split step held against one
   fused step from a cloned state; --steps-split-sort more steps with
   LAMBDAPIC_MIG_FUSED=0: B7 6); then B4-B7 against their plain versions
   (float64 at small sizes, float32 at the 2D slice's shapes; B4 and B5
   with the alive mask, as the step calls them: B4 bitwise on the alive
   slots and the dead values in the dead ones, B5 within 1e-5 of J's
   peak in float32), the 2D
   slice with cell_migration="exact" (B1 4, B4 3, B5 3; every alive id
   kept to step 101 but those counted merged or dropped) and the QED
   slice with cell_migration="exact" (B1 4, B4 2 = default + want_eb,
   B5 2; photons emitted), each timed and profiled, and B4-B7 timed at
   the exact slice's final state;
8. the per-stage engine in 3D: after phase 6 the 3D slice goes on through
   split steps (a host callback at _push_momentum due every step:
   launches per step B1 4, B6 6, B5 2; one split particle stage held
   against one fused one on its last 128 x-planes; B6 timed on the
   electrons the split steps re-bin (the B6 3D row's split3d_* keys)
   and its synchronised share of one more split step;
   --steps-split-sort3d more steps with LAMBDAPIC_MIG_FUSED=0: B7 6);
   then B4-B7 on 3D slots
   against their plain versions (float64 at small sizes, float32 at the
   3D slice's shapes; B4 3D and B5 3D with the alive mask, as the step
   calls them: B4 bitwise on the alive slots and the dead values in the
   dead ones), the 3D slice with cell_migration="exact" from its fill
   (B1 4, B4 2, B5 2; every alive id kept but those counted merged or
   dropped and those stored on an open face's edge), timed and profiled,
   and B4-B7 in 3D timed at its final state (B4 3D and B5 3D with their
   per-__global__ split in the kernels line);
9. per-cell capacities above 128: B2 (2D and 3D, default and want_chi),
   B6 (2D and 3D slots) and B7 at 130 and 256 slots a cell, and one case
   with more cells than the sort scratch has rows, against their plain
   versions in float64;
10. QED in 3D: B2 3D's want_chi and photon modes against their plain
   versions (float64 slot for slot at small sizes, float32 at the slice's
   shapes), the draws on the card against the CPU, and this script's 3D
   QED configuration (example/photons.py in 3D at
   example/laser-target-3d.py's resolution, 256 x 128 x 128 cells; no
   script in example/ is 3D QED) through Simulation3D.run to its end
   (launches per step B1 4, B2 3 = want_chi + default + photon, B3 1; the
   gates of the 2D QED slice, the accounting species by species), then
   split steps (a _push_momentum callback: B1 4, B6 9, B5 2 a step; one
   split step held against one fused step from a cloned state) and its
   cell_migration="exact" twin from its own fill (B1 4, B4 2 = default +
   want_eb, B5 2) to 50 steps past its first photon.

11. the tiled 2D engine, right after phase 7: B8 and B9 against their
   plain versions (float64 at small sizes: dead slots, the drift band's
   edges, drifts of 1 and 3 cells, tiles of 8 x 8, 16 x 8 and 32 x 32,
   cap_t 300 and 16,384), bench.py's laser-target in its --tiling 32,32
   form (768 x 768 cells, electrons and protons at ppc 10 for x > Lx/3,
   rebin_interval 4, n_guard 5, capacity factor 1.6, SimpleLaser2D
   a0=30, float32, seed 0) for --steps-tiled (400) steps through
   Simulation.run (launches per step B1 4, B8 2, B9 2; the re-binning on
   every 4th step; ids held a re-binning interval at a time: an id goes
   only near an open face or into the overflow count; particles changed
   tile), its last --window-tiled (50) steps timed and profiled, charge
   continuity from B9's own output, B8 and B9 in float32 at its end state
   and timed there, then bench.py's qed configuration in the same form at
   256 x 256 (a photon species, SimpleLaser2D a0=300) for
   --steps-tiled-qed (200) steps (B1 4, B8 3, B9 2; photons born through
   insert_tiled).

12. the cell engine on a device mesh (every shard on the one card): K4
   (B2's cross-device x edges and one dispatch per split y / z axis) and
   K5 (B3's guard strips) against their plain versions, in float64 on
   small 2D and 3D meshes (slot for slot, merges and corner movers) and
   in float32 at the 2D slice's 2 x 2 shards and on a 2 x 2 x 2 mesh of
   the 3D slice's last x-planes; right after phase 4 (before the split
   steps) the 2D slice's end state on a 2 x 2 mesh for --steps-mesh (20)
   steps (B2 24, B3 12 a step; B1 0: on a mesh the fields are the plain
   Yee updates, as in the JAX package), and right after phase 6 the 3D
   slice's end state on a 2 x 2 x 2 mesh for --steps-mesh3d (6) steps
   (B2 48, B3 32 = 8 folds, 8 strip cuts and 16 pending adds), each
   timed, profiled and held against the same steps
   on one device from the same state: alive counts and weights in
   float32, and fields, ids, positions and momenta in float64 (the 3D on
   its last 64 x-planes); K4's dispatches and K5's launches timed on a
   shard. The slices then go on from their end states as before.

13. QED on a device mesh (K6: B2's want_chi and photon modes in the mesh
   dispatches): K6 against its plain version in float64 on small 2D and
   3D meshes (slot for slot with merges and corner movers, tau, delta and
   event carried, chi and ig0); right after phase 5 the QED slice's state
   at step --steps-qed on a 2 x 2 mesh for --steps-qed-mesh (30) steps,
   the last --window-qed-mesh (10) timed (launches per step B2 24 = 3
   species x 4 shards x 2 dispatches, by the mode each ran want_chi 4 =
   the electrons' tails, photon 8, default 12 = the protons' 8 and the
   electrons' heads; B3 12; B1 0), and right after phase 10 the 3D QED
   slice's state on a 2 x 2 x 2 mesh for --steps-qed-mesh3d (5) steps (B2
   72: want_chi 8, photon 24, default 40; B3 32), each profiled; gates: the draws on every shard against the CPU,
   photons born on the shards that fired with the shard's index as id_hi,
   photon inv_gamma = 1/|u|, a creation phase's sum w u on the shard
   with the most events, and against one device from the same state the photons born
   within 5 sqrt(N) and their sum w |u| within 15%; K6 held against its
   plain version in float32 and timed on the busiest shard.

14. the per-stage engine on a device mesh (K7: B6 with the neighbour
   shards' edge columns): K7 against its plain version in float64 on
   small 2D and 3D meshes with open and periodic faces (bitwise); after
   phase 7 the 2D slice's end state on a 2 x 2 mesh: one split step held
   against one fused step from a cloned state, then --steps-split-mesh
   (10) split steps (B6 24, B5 12 a step), K7 against its plain version
   in float32 at those shards (every launch of one re-binning, axis by
   axis on every shard, on the same input: alive masks, merges and every
   array's alive slots bitwise) and timed, then
   cell_migration="exact" for --steps-exact-mesh (10) steps (B4 12, B5
   12) and float64 twins of the mesh and one-device runs from the same
   state under the mesh gates (ids, positions within 1e-4 cells, momenta
   rtol 1e-4, fields within 1e-4 of their peaks); after phase 8 the 3D
   slice's end state on 2 x 2 x 2 for --steps-split-mesh3d (2) split
   steps (B6 48, B5 3D 16) with K7 in float32 there (as in 2D); and at
   the end of
   phase 10 the exact 3D QED phase's end state on 2 x 2 x 2 for
   --steps-exact-qed-mesh3d (5) steps (B4 3D 16 of them 8 want_eb, B5 3D
   16) with its peak memory.

Prints a ``{"kernels": [...]}`` line with the 2D, the tiled, the
per-stage, the QED, the 3D, the 3D QED, the 3D per-stage and the mesh
kernels (K4 and K5 in 2D and 3D, K6 in both modes and K7 in 2D and 3D; B8's
and B9's bounds also counted from the Pallas calls' shapes at bench.py's
form; each row's "timing" says how its ms was taken, "profiler" or
"events", see kernel_ms; K7's rows add ms_launch and bound_ms_launch, a
launch's share of their shard's axes), the card's name and power limit,
and as its
last line ``{"ok": true, "device": {...}}``.

``--exact2d-digest N`` runs only the 2D slice with cell_migration="exact"
for N steps and prints its peak device memory and a digest of its final
state (to hold two versions of the exact re-binning to the same output).
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
import warnings

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 non-tensor FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# B2's floating-point work per alive particle, counted from cellstep.cu:
# two half pushes and the keys (about 12), six staggered gathers of 9-16
# taps with their spline weights (about 700), Boris (about 60), 5 x 5
# Esirkepov nodes with their shapes (about 600)
FLOPS_PER_PARTICLE = 1400
# the same count from cellstep3d.cu: three half pushes twice and the keys
# (about 30), 21 spline weights and six staggered gathers of 36-48 taps
# (about 900), Boris (about 60), 30 Esirkepov shapes with their derived
# taps and 125 nodes of four channels (about 2300)
FLOPS_PER_PARTICLE_3D = 3300
# B2's QED modes, counted from cellstep.cu the same way: want_chi adds
# ig0 and chi to the default mode's work (about 40); the photon mode does
# two half pushes, the keys and 1/|u| (about 20) and nothing else
FLOPS_CHI = 40
FLOPS_PHOTON = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    if TIMERS:
        log("[time] helpers so far: " + ", ".join(
            f"{k} {v[0]:.1f} s in {v[1]} calls"
            for k, v in sorted(TIMERS.items())))
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# wall seconds and calls of the script's costliest helpers, printed at its
# end (for the time budget)
TIMERS = {}


def cuda_time(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, after one warm-up call."""
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


# __global__ functions of each timed wrapper call, as they appear in
# profiler names, with their launches per call (an E or a B half-step
# launches one of B1's two)
KERNEL_FUNCS = {"B1 E": {"e_half": 1}, "B1 B": {"b_half": 1},
                "B2": {"rebin2x": 1, "rebin2y": 1, "deposit2": 1},
                "B2 photon": {"rebin2x": 1, "rebin2y": 1},
                "B3": {"fold<": 1},
                "B1-3D E": {"e_half3": 1}, "B1-3D B": {"b_half3": 1},
                "B2-3D": {"rebin3": 3, "tail3<": 1},
                "B3-3D": {"fold3_pencil": 1},
                "B8": {"gather<": 1}, "B9": {"deposit<": 1}}


# seconds of untimed calls that precede the timed ones inside the
# profiler's window, attempt by attempt (a profile without them lost its
# first records in nearly every call, so none starts without)
PROFILE_MARGINS = (1.0, 4.0)
# untimed calls at the start of a margin
MARGIN_CALLS = 2
# torch.cuda._sleep's kernel, as it appears in profiler names
SPIN = "spin_kernel"


def device_times(fn, iters: int, expected):
    """Device time of every CUDA kernel that ``iters`` calls of ``fn``
    launch, by name, from torch.profiler: ({name: (total ms, launches
    recorded)}, complete). ``expected``: launches per call of ``fn`` of
    the port's __global__ functions, by the fragment of their names.

    The profiler (Kineto) drops a device record whose time stamp, once
    converted to the host's clock, lies outside the capture window, and
    counts it as "Out-of-range" in its log (KINETO_LOG_LEVEL=1). Where
    the converted device clock runs behind the host's, that loses the
    first stretch of a profile. So the timed calls follow a marker (a
    short spin kernel) and only records that start after it are counted;
    a profile that lacks the marker or an expected launch is taken again
    with PROFILE_MARGINS seconds ahead of the marker (MARGIN_CALLS
    untimed calls of ``fn``, then idle), which are the ones lost, and the
    window closed as much later.
    ``complete`` says whether the last profile recorded every launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    tries = len(PROFILE_MARGINS)
    for attempt, margin in enumerate(PROFILE_MARGINS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the lost stretch is one of time: MARGIN_CALLS untimed calls,
            # then idle to the margin's end (a margin filled with calls of
            # a short kernel put tens of thousands of records in the
            # profile, whose gathering took most of the script's time)
            t0 = time.time()
            calls = 0
            while time.time() - t0 < margin:
                if calls < MARGIN_CALLS:
                    fn()
                    torch.cuda.synchronize()
                    calls += 1
                else:
                    time.sleep(0.01)
            torch.cuda._sleep(1000)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        events = [e for e in prof.events()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
        marks = [e.time_range.start for e in events if SPIN in e.name]
        out = {}
        for e in events:
            if marks and e.time_range.start > marks[-1]:
                ms, n = out.get(e.name, (0.0, 0))
                out[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        seen = {f: sum(n for name, (_, n) in out.items() if f in name)
                for f in expected}
        want = {f: k * iters for f, k in expected.items()}
        if seen == want and out:
            return out, True
        log(f"[profiler] attempt {attempt + 1} of {tries}: recorded {seen} "
            f"of {want} launches")
    return out, False


def short_name(name: str) -> str:
    """A __global__ function's name without its namespace, template
    arguments and parameters, as the profiler prints it."""
    import re
    base = name.replace("(anonymous namespace)::", "")
    base = base[5:] if base.startswith("void ") else base
    return re.match(r"[\w:]*", base).group(0).split("::")[-1] or name[:40]


def split_text(times, iters: int, funcs) -> str:
    """' = f1 ms + f2 ms ...': device ms a call of each __global__
    function of ``times`` (device_times' records of ``iters`` calls) that
    ``funcs`` names, the port's kernels' split."""
    parts = {}
    for name, (ms, _) in times.items():
        if any(f in name for f in funcs):
            k = short_name(name)
            parts[k] = parts.get(k, 0.0) + ms / iters
    return " = " + " + ".join(f"{k} {v:.4f}" for k, v in sorted(
        parts.items(), key=lambda kv: -kv[1])) if parts else ""


# a call at least this long (ms) whose launches the host issued in at
# most half that time is timed with CUDA events alone unless its
# per-__global__ split is asked for: back-to-back launches then keep the
# device busy, so the events measure its device time to a few percent
# (events against the profiler on an H100 80GB HBM3 at 700 W: B4 1.3795 /
# 1.3871, B6 1.3235 / 1.3125, B7 0.8751 / 0.8712, B8 0.3728 / 0.3576
# ms), and the profile it spares took 3-12 s, most of them taken twice
EVENT_MS = 0.25


def issue_time(fn, iters: int):
    """(ms per call from CUDA events over ``iters`` calls after a warm-up
    call, ms per call the host took to issue them)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issued = (time.perf_counter() - t0) * 1e3 / iters
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, issued


def kernel_ms(fn, iters: int, kernel: str, split: bool = False):
    """(device ms per call, summed over the kernel's __global__ functions
    from a profile that recorded every launch, or None if no profile did;
    wall ms per call from CUDA events, host included). The split of the
    device time over those functions is kept in ``kernel_ms.split`` (see
    split_text; "" without a complete profile). A device-bound call of at
    least EVENT_MS is profiled only with ``split`` (a row or a finding
    that needs the split): otherwise its device ms is the events'. How
    the returned ms was taken ("profiler" or "events") is kept in
    ``kernel_ms.method``, for the kernels row's "timing"."""
    wall, issued = issue_time(fn, iters)
    funcs = KERNEL_FUNCS[kernel]
    kernel_ms.split = ""
    kernel_ms.method = "events"
    if not split and wall >= EVENT_MS and issued <= wall / 2:
        log(f"[time {kernel}] {wall:.4f} ms a call from CUDA events over "
            f"{iters} calls ({', '.join(funcs)}; issued in {issued:.4f} ms "
            "a call)")
        return wall, wall
    times, complete = device_times(fn, iters, funcs)
    if not complete:
        log(f"[time {kernel}] no complete profile: the wall time stands in")
        return None, wall
    kernel_ms.method = "profiler"
    dev = 0.0
    for name, (ms, n) in sorted(times.items(), key=lambda kv: -kv[1][0]):
        if any(f in name for f in funcs):
            dev += ms / iters
            log(f"[time {kernel}] {ms / n * 1e3:10.2f} us a launch, {n} "
                f"launches in {iters} calls  {name[:80]}")
    kernel_ms.split = split_text(times, iters, funcs)
    return dev, wall


kernel_ms.split = ""
kernel_ms.method = "events"


def timing(*methods):
    """A kernels row's "timing": how its ms was taken, "profiler" (the
    device time of its __global__ functions from torch.profiler) or
    "events" (CUDA events around its calls, host issue included); both,
    joined by "+", for a row whose calls were timed in both ways."""
    return "+".join(sorted(set(methods)))


def busy_per_step(fn, expected, steps: int, tag: str, step_ms: float):
    """Device-busy ms per step: the summed device time of every kernel and
    copy in a profile of ``steps`` calls of ``fn`` (one step each), over
    ``steps``. ``expected``: launches per step of the port's __global__
    functions. None, and so logged, if no profile recorded them all."""
    times, complete = device_times(fn, steps, expected)
    for name, (ms, n) in sorted(times.items(), key=lambda kv: -kv[1][0])[:14]:
        if n:
            log(f"[{tag}] {ms / n * 1e3:10.2f} us a launch, {n} recorded in "
                f"{steps} steps  {name[:80]}")
    if not complete:
        log(f"[{tag}] device busy share: not measured (no profile recorded "
            "every launch of the port's kernels)")
        return None
    busy = sum(ms for ms, _ in times.values()) / steps
    log(f"[{tag}] device busy {busy:.3f} ms per step = "
        f"{100 * busy / step_ms:.1f}% of the timed window's step; idle "
        f"{100 * (1 - busy / step_ms):.1f}%")
    return busy


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_build():
    from lambdapic_torch.ops import kernel_lib
    t0 = time.time()
    paths = kernel_lib.build()
    log(f"[build] {len(paths)} libraries in {time.time() - t0:.1f} s")
    for name in paths:
        for line in kernel_lib.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                log(f"[ptxas {name}] {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _random_fields(grid, cpml, dtype, dev, seed):
    import torch
    from lambdapic_torch.core.state import FieldsState, zeros_fields
    rng = np.random.default_rng(seed)
    f = zeros_fields(grid, dtype, dev, cpml)
    vals = {k: torch.as_tensor(rng.normal(size=grid.shape)
                               * (1e-8 if k[0] == "b" else 1.0),
                               dtype=dtype).to(dev)
            for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz",
                      "rho")}
    psi = {k: torch.as_tensor(rng.normal(size=tuple(v.shape)) * 1e-3,
                              dtype=dtype).to(dev) for k, v in f.psi.items()}
    return FieldsState(**vals, psi=psi)


def _fields_err(a, b):
    """Largest |a - b| over E, B and psi, and the same over max|b|."""
    worst_abs, worst_rel = 0.0, 0.0
    pairs = [(getattr(a, k), getattr(b, k)) for k in
             ("ex", "ey", "ez", "bx", "by", "bz")]
    pairs += [(a.psi[k], b.psi[k]) for k in b.psi]
    for x, y in pairs:
        err = float((x - y).abs().max())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(float(y.abs().max()), 1e-300))
    return worst_abs, worst_rel


def check_b1(grid, cpml, dtype, dev, tol, seed=0):
    from lambdapic_torch.ops import maxwell
    from lambdapic_torch.ops.fieldskernel import update_bfield_k, update_efield_k
    f = _random_fields(grid, cpml, dtype, dev, seed)
    dt = 0.95 / np.sqrt(sum(d**-2 for d in grid.deltas)) / 3e8
    worst = (0.0, 0.0)
    for k_fn, p_fn in ((update_efield_k, maxwell.update_efield),
                       (update_bfield_k, maxwell.update_bfield)):
        got = k_fn(f, grid, dt / 2, cpml)
        ref = p_fn(f, grid, dt / 2, cpml)
        err = _fields_err(got, ref)
        if not err[1] <= tol:
            fail(f"B1 {k_fn.__name__} differs from its plain version: "
                 f"{err[1]:.3e} of the peak > {tol}")
        worst = max(worst, err)
    return worst


def check_b2_f64(dev):
    """Slot-for-slot float64 comparisons at small sizes; returns the
    merge count of the case built to merge."""
    import torch
    from lambdapic_torch.ops.cellslab import (cell_step, cell_step_plain,
                                              fold_reduce, fold_reduce_plain)
    from lambdapic_torch.testing import compare_slots, random_cell_state, \
        to_numpy, to_torch
    q, m, dt, d = -1.602e-19, 9.109e-31, 1.1e-16, 5e-8
    merges = 0
    cases = [(4, 16, 16, (True, True), 0.4), (6, 24, 40, (False, False), 0.4),
             (4, 20, 36, (True, False), 0.9), (20, 33, 18, (False, True), 0.5),
             (8, 16, 16, (True, True), 0.85)]
    for cap, nx, ny, per, frac in cases:
        data, alive, eb = random_cell_state(cap, nx, ny, n_frac=frac,
                                            seed=cap + nx)
        td, ta = to_torch(data, alive, torch.float64, dev)
        eb_t = torch.as_tensor(eb).to(dev)
        kw = dict(q=q, m=m, dt=dt, dx=d, dy=d, g=3, periodic=per)
        rin = torch.as_tensor(np.random.default_rng(1).normal(
            size=(4, -(-nx // 16), -(-ny // 16), 20, 20))).to(dev)
        ref = cell_step_plain(eb_t, td, ta, rims_in=rin, **kw)
        got = cell_step(eb_t, td, ta, rims_in=rin, **kw)
        torch.cuda.synchronize()
        compare_slots(*to_numpy(ref[0], ref[1]), *to_numpy(got[0], got[1]),
                      rtol=1e-11)
        if int(got[2]) != int(ref[2]):
            fail(f"B2 merge count {int(got[2])} != plain {int(ref[2])}")
        merges = max(merges, int(ref[2]))
        scale = float(ref[3].abs().max())
        err = float((got[3] - ref[3]).abs().max())
        if not err <= 1e-12 * scale:
            fail(f"B2 panels differ: {err:.3e} > 1e-12 x {scale:.3e}")
        jr = fold_reduce_plain(ref[3], (nx, ny), per)
        jk = fold_reduce(ref[3], (nx, ny), per)
        err = float((jk - jr).abs().max())
        if not err <= 1e-12 * float(jr.abs().max()):
            fail(f"B3 differs from its plain version: {err:.3e}")
    if merges == 0:
        fail("no B2 float64 case merged particles")
    return merges


def compare_b2_f32(eb_pad, p, sp, dt, grid, periodic, want_chi=False):
    """Kernel B2 (in its ``want_chi`` mode: and chi) against its plain
    version at the slice's shapes in float32: alive masks and ids
    identical, merges equal, total weight to 1e-6, J panels (and chi) to
    1e-4 of their peak. The slice's particles start at rest, and a
    particle at rest changes no cell (re-binning comes before the
    momentum push), so one kernel step first gives them momenta; the step
    that is compared then re-bins them across cells."""
    import torch
    from lambdapic_torch.ops.cellslab import cell_step, cell_step_plain
    kw = dict(q=sp.q, m=sp.m, dt=dt, dx=grid.dx, dy=grid.dy, g=grid.n_guard,
              periodic=periodic, with_rho=False, want_chi=want_chi,
              dz=grid.dz if grid.dimension == 3 else None)
    data, alive = cell_step(eb_pad, p.data, p.alive, **kw)[:2]
    ref = cell_step_plain(eb_pad, data, alive, **kw)
    got = cell_step(eb_pad, data, alive, **kw)
    torch.cuda.synchronize()
    moved = int((got[1] != alive).sum())
    if moved == 0:
        fail("B2 float32: the compared step re-binned no particle")
    n_ref, n_got = int(ref[1].sum()), int(got[1].sum())
    if n_ref != n_got or int(ref[2]) != int(got[2]):
        fail(f"B2 float32: alive {n_got} vs {n_ref}, merges {int(got[2])} "
             f"vs {int(ref[2])}")
    w_ref = float(torch.where(ref[1], ref[0]["w"], 0).sum(dtype=torch.float64))
    w_got = float(torch.where(got[1], got[0]["w"], 0).sum(dtype=torch.float64))
    if not abs(w_got - w_ref) <= 1e-6 * abs(w_ref):
        fail(f"B2 float32 total weight {w_got} vs {w_ref}")
    scale = float(ref[3].abs().max())
    err = float((got[3] - ref[3]).abs().max())
    if not err <= 1e-4 * scale:
        fail(f"B2 float32 panels differ: {err:.3e} > 1e-4 x {scale:.3e}")
    # the kernel rounds as the plain version does (--fmad=false, same
    # operation order), so cell assignment and merge pairing match: alive
    # masks and the ids of alive slots are identical
    same = torch.equal(got[1], ref[1]) and all(
        torch.equal(got[0][k][got[1]], ref[0][k][ref[1]])
        for k in ("id_lo", "id_hi"))
    chi = ""
    if want_chi:
        a = got[1]
        chi_err = float((got[4][0][a] - ref[4][0][a]).abs().max())
        chi_peak = float(ref[4][0][a].abs().max())
        chi = f" chi {chi_err:.3e} of peak {chi_peak:.3e};"
        if not chi_err <= 1e-4 * chi_peak:
            fail(f"B2 want_chi float32: chi differs by {chi_err:.3e}")
    log(f"[B2{' want_chi' if want_chi else ''} f32 {grid.dimension}D] "
        f"{moved} slots changed occupancy; alive {n_got} merges "
        f"{int(got[2])} weight rel {abs(w_got - w_ref) / abs(w_ref):.2e} "
        f"panels {err:.3e} of peak {scale:.3e};{chi} slots identical: "
        f"{same}")
    if not same:
        fail("B2 float32: alive masks or ids differ from the plain version")
    return got, ref, err


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def make_slice(dev, seed=0, nx=1024, cell_migration="fast"):
    """example/laser-target.py at full size (nx = ny = 1024), without its
    diagnostics; ``cell_migration="exact"`` for the per-stage engine."""
    from lambdapic_torch import (Electron, GaussianLaser2D, Proton,
                                 Simulation, Species)
    from lambdapic_torch.constants import c, e, epsilon_0, m_e, pi
    um = 1e-6
    l0 = 0.8 * um
    omega0 = 2 * pi * c / l0
    nc = epsilon_0 * m_e * omega0**2 / e**2
    ny = nx
    dx = dy = l0 / 50
    Lx = nx * dx

    def density(n0):
        def _density(x, y):
            ne = 0.0
            if x > Lx / 2 and x < Lx / 2 + 1 * um:
                ne = n0
            return ne
        return _density

    laser = GaussianLaser2D(a0=10, w0=2e-6, l0=0.8e-6, ctau=5e-6,
                            focus_position=Lx / 2, x0=10e-6, ellipticity=1)
    sim = Simulation(tiling="cell", nx=nx, ny=ny, dx=dx, dy=dy,
                     random_seed=seed, device=dev,
                     cell_migration=cell_migration)
    ele = Electron(density=density(10 * nc), ppc=10)
    proton = Proton(density=density(10 * nc / 8 * 2), ppc=10)
    carbon = Species(name="C", charge=6, mass=12 * 1800,
                     density=density(10 * nc / 8), ppc=10)
    sim.add_species([ele, carbon, proton])
    return sim, laser


def gather_nodes(alive, g):
    """Nodes of the padded E/B stack that B2's staggered gather reads
    from the cells holding a particle, summed over the six components:
    taps -1..1 on an integer axis, -2..1 on a half-staggered one."""
    import torch
    occ = alive.any(0)
    nx, ny = occ.shape
    total = 0
    # (half along x, half along y) of ex ey ez bx by bz
    for hx, hy in ((True, False), (False, True), (False, False),
                   (False, True), (True, False), (True, True)):
        need = torch.zeros((nx + 2 * g, ny + 2 * g), dtype=torch.bool,
                           device=occ.device)
        for ox in range(-2 if hx else -1, 2):
            for oy in range(-2 if hy else -1, 2):
                need[g + ox:g + ox + nx, g + oy:g + oy + ny] |= occ
        total += int(need.sum())
    return total


# kernel B2 2D's tiles (csrc/cellstep.cu): a re-binning pass's (x, y) cells
# with sort entries in shared memory, and the deposit's
PASS_TILE = (8, 32)
DEPOSIT_TILE = (16, 16)


def occupancy(alive) -> str:
    """Occupied cells, pass tiles and deposit tiles of 2D slots (the
    tiles that kernel B2 2D works; the others it skips)."""
    import torch.nn.functional as F
    occ = alive.any(0).float()[None, None]
    cells = int(occ.sum())
    out = [f"{cells} of {occ.numel()} cells occupied"]
    for name, (tx, ty) in (("pass", PASS_TILE), ("deposit", DEPOSIT_TILE)):
        t = F.max_pool2d(occ, (tx, ty), ceil_mode=True)
        out.append(f"{int(t.sum())} of {t.numel()} {name} tiles ({tx} x {ty})")
    return ", ".join(out)


def edge_sitters(sim):
    """Per species, the alive particles whose stored float32 position lies
    on or beyond an open face's edge (pos >= n - 0.5 or < -0.5): a position
    drawn within half a float32 step of the box's upper edge rounds onto
    it, and the first re-binning hands such a particle to the open face."""
    import torch
    out = []
    for p in sim.state.particles:
        gone = torch.zeros_like(p.alive)
        for ax, n, per in zip(sim.grid.axes, sim.grid.shape,
                              sim.grid.periodic_axes):
            if not per:
                gone |= (p.data[ax] >= n - 0.5) | (p.data[ax] < -0.5)
        out.append(int((gone & p.alive).sum()))
    return out


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    from lambdapic_torch.ops import (cellpallas, cellslab, fieldskernel,
                                     tiled2d_kernels)
    for fn in (fieldskernel.update_half_k, cellslab.cell_step,
               cellslab.fold_reduce, cellpallas.fused_push_cell_2d,
               cellpallas.deposit_cell_2d_k, cellpallas.migrate_axis,
               cellpallas.sort_cells, cellpallas.fused_push_cell_3d,
               cellpallas.deposit_cell_3d_k, tiled2d_kernels.gather_tiled_k,
               tiled2d_kernels.deposit_tiled_k):
        fn.launches = 0
    for counts in (cellslab.cell_step.launches_by_mode,
                   cellpallas.fused_push_cell_2d.launches_by_mode,
                   cellpallas.fused_push_cell_3d.launches_by_mode):
        for mode in counts:
            counts[mode] = 0


def all_launches():
    """Every kernel wrapper's launch count, by kernel (B4 want_eb: the
    launches of B4 in that mode, also counted in B4)."""
    from lambdapic_torch.ops import cellpallas as cp, cellslab, fieldskernel
    from lambdapic_torch.ops import tiled2d_kernels as tk
    return {"B1": fieldskernel.update_half_k.launches,
            "B2": cellslab.cell_step.launches,
            "B3": cellslab.fold_reduce.launches,
            "B4": cp.fused_push_cell_2d.launches,
            "B4 want_eb": cp.fused_push_cell_2d.launches_by_mode["want_eb"],
            "B5": cp.deposit_cell_2d_k.launches,
            "B6": cp.migrate_axis.launches, "B7": cp.sort_cells.launches,
            "B4 3D": cp.fused_push_cell_3d.launches,
            "B4 3D want_eb":
                cp.fused_push_cell_3d.launches_by_mode["want_eb"],
            "B5 3D": cp.deposit_cell_3d_k.launches,
            "B8": tk.gather_tiled_k.launches,
            "B9": tk.deposit_tiled_k.launches}


def check_launches(tag, steps, per_step, into=None, by_mode=None):
    """Fail unless each kernel launched ``per_step`` times a step (0 for
    kernels not named) over ``steps`` steps, and (``by_mode``) B2 in each
    of its modes as many times a step as given; add the per-stage
    kernels' launches to ``into`` (STAGE_LAUNCHES, the 2D rows, by
    default). Returns the counts."""
    from lambdapic_torch.ops import cellslab
    got = all_launches()
    want = {k: per_step.get(k, 0) * steps for k in got}
    log(f"[{tag}] launches in {steps} steps: {got}")
    if got != want:
        fail(f"{tag}: launch counts {got} != {want}")
    if by_mode is not None:
        modes = dict(cellslab.cell_step.launches_by_mode)
        want = {k: by_mode.get(k, 0) * steps for k in modes}
        log(f"[{tag}] B2 launches by mode: {modes}")
        if modes != want:
            fail(f"{tag}: B2 launches by mode {modes} != {want}")
    into = STAGE_LAUNCHES if into is None else into
    for k in into:
        into[k] += got[k]
    return got


def totals(sim):
    import torch
    out = []
    for p in sim.state.particles:
        out.append((int(p.alive.sum()), int(p.overflow),
                    float(torch.where(p.alive, p.data["w"], 0).sum(
                        dtype=torch.float64))))
    return out


def check_finite(sim, tag, rho=False):
    """Fail unless E, B and J (and ``rho``) are finite everywhere."""
    import torch
    for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz") \
            + (("rho",) if rho else ()):
        if not bool(torch.isfinite(getattr(sim.state.fields, k)).all()):
            fail(f"{tag}: field {k} is not finite")


def check_photon_ig(sim, ip, tag):
    """Fail unless the photons' inv_gamma is 1/|u| (float32 rounding)."""
    import torch
    php = sim.state.particles[ip]
    u = torch.sqrt(sum(php.data[k].double()**2 for k in ("ux", "uy", "uz")))
    a = php.alive
    ig_err = float((php.data["inv_gamma"].double()[a] * u[a] - 1).abs().max())
    log(f"[{tag}] photons: inv_gamma * |u| - 1 at most {ig_err:.2e}")
    if not ig_err <= 1e-6:
        fail(f"{tag}: photon inv_gamma differs from 1/|u| by {ig_err:.2e}")


def run_2d(args, dev):
    """Phases 2-4 for the 2D kernels and the 2D slice; returns the 2D
    kernels' entries of the ``kernels`` line."""
    import torch
    from lambdapic_torch.ops import cellslab, fieldskernel, maxwell
    from lambdapic_torch.ops.cellslab import (cell_step, cell_step_plain,
                                              fold_reduce, fold_reduce_plain,
                                              panel_shape)
    from lambdapic_torch.ops.cpml import CPMLParams, build_cpml
    from lambdapic_torch.core.grid import Grid

    # -- phase 2a: float64, small -------------------------------------------
    for bc in ("pml", "periodic"):
        names = ("xmin", "xmax", "ymin", "ymax")
        grid = Grid(dimension=2, nx=40, ny=36, dx=1e-6, dy=0.8e-6, npatch_x=1,
                    npatch_y=1, n_guard=3, cpml_thickness=6,
                    boundary_conditions=tuple((n, bc) for n in names))
        dt = 0.95 / np.sqrt(grid.dx**-2 + grid.dy**-2) / 3e8
        cpml = build_cpml(grid, dt, CPMLParams()) if bc == "pml" else None
        err = check_b1(grid, cpml, torch.float64, dev, tol=1e-12)
        log(f"[B1 f64 {bc}] max abs {err[0]:.3e}, {err[1]:.3e} of peak")
    merges = check_b2_f64(dev)
    log(f"[B2/B3 f64] slot-exact in 5 cases, merges in the merging case: "
        f"{merges}")

    # -- the slice state ------------------------------------------------------
    t0 = time.time()
    sim, laser = make_slice(dev)
    sim.initialize()
    log(f"[slice] initialised in {time.time() - t0:.1f} s: "
        f"{sim.npart_alive} particles, slots "
        f"{[p.cap for p in sim.state.particles]}, dt {sim.dt:.4e} s")
    grid, cpml = sim.grid, sim.cpml
    periodic = (grid.periodic("x"), grid.periodic("y"))

    # -- phase 2b: float32 at the slice's shapes -------------------------------
    errs = {}
    err = check_b1(grid, cpml, torch.float32, dev, tol=1e-5, seed=1)
    errs["B1"] = err[0]
    log(f"[B1 f32 1024^2] max abs {err[0]:.3e}, {err[1]:.3e} of peak")
    rng = np.random.default_rng(2)
    g = grid.n_guard
    # fields strong enough to move electrons across cells in one step
    eb_pad = torch.as_tensor(rng.uniform(-5e13, 5e13, (6, grid.nx + 2 * g,
                                                        grid.ny + 2 * g)),
                             dtype=torch.float32).to(dev)
    got, ref, errs["B2"] = compare_b2_f32(
        eb_pad, sim.state.particles[0], sim._species_static[0], sim.dt, grid,
        periodic)
    jr = fold_reduce_plain(ref[3], grid.shape, periodic)
    jk = fold_reduce(ref[3], grid.shape, periodic)
    errs["B3"] = float((jk - jr).abs().max())
    if not errs["B3"] <= 1e-5 * float(jr.abs().max()):
        fail(f"B3 float32 differs: {errs['B3']:.3e}")
    log(f"[B3 f32 1024^2] max abs {errs['B3']:.3e} of peak "
        f"{float(jr.abs().max()):.3e}")
    del got, ref, jr, jk

    # -- phase 3: the main path ------------------------------------------------
    # Until the laser front reaches the target (about step 1200) no
    # particle can leave the box: particle number (alive + merged) and
    # weight are checked there. The last --window steps are timed.
    before = totals(sim)
    reset_launches()
    n_timed = min(args.window, args.steps)
    n_a = min(args.steps - n_timed, 1000)
    n_b = args.steps - n_timed - n_a
    t0 = time.time()
    sim.run(nsteps=n_a, callbacks=[laser])
    torch.cuda.synchronize()
    mid = totals(sim)
    sim.run(nsteps=n_b, callbacks=[laser])
    torch.cuda.synchronize()
    t1 = time.time()
    sim.run(nsteps=n_timed, callbacks=[laser])
    torch.cuda.synchronize()
    t2 = time.time()
    launches = {"B1": fieldskernel.update_half_k.launches,
                "B2": cellslab.cell_step.launches,
                "B3": cellslab.fold_reduce.launches}
    after = totals(sim)
    steps = sim.itime
    log(f"[slice] {steps} steps: first {n_a + n_b} in {t1 - t0:.2f} s, "
        f"window {n_timed} in {t2 - t1:.3f} s; launches {launches}")
    want = {"B1": 4 * steps, "B2": 3 * steps, "B3": steps}
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    check_finite(sim, "2D")
    for (n0, m0, w0), (n1, m1, w1), (n2, m2, w2), sp in zip(
            before, mid, after, sim.species):
        log(f"[slice] {sp.name}: alive {n0} -> {n1} (step {n_a}) -> {n2}, "
            f"merges {m1 - m0} -> {m2 - m0}, weight {w0:.7e} -> {w1:.7e} "
            f"-> {w2:.7e}")
        if n1 + (m1 - m0) != n0:
            fail(f"{sp.name}: particles not conserved to step {n_a} ({n0} "
                 f"-> {n1} + {m1 - m0} merges)")
        if not abs(w1 - w0) <= 1e-5 * w0:
            fail(f"{sp.name}: weight not conserved to step {n_a} ({w0} -> "
                 f"{w1})")
        if n2 + (m2 - m0) > n0 or not w2 <= w0 * (1 + 1e-5):
            fail(f"{sp.name}: particles or weight grew ({n0} -> {n2}, "
                 f"{w0} -> {w2})")
    ey_peak = float(sim.state.fields.ey.abs().max())
    step_ms = (t2 - t1) * 1e3 / n_timed
    npart = sum(n for n, _, _ in after)
    log(f"[slice] step {step_ms:.3f} ms (host clock, synchronised), "
        f"{npart / (step_ms * 1e-3):.4e} pushes/s, peak |ey| {ey_peak:.3e}")
    busy_per_step(lambda: sim.run(nsteps=1, callbacks=[laser]),
                  {"e_half": 2, "b_half": 2, "rebin2x": 3, "rebin2y": 3,
                   "deposit2": 3, "fold<": 1}, 10, "profile", step_ms)

    # -- phase 4: kernel times at the slice's shapes ---------------------------
    f = sim.state.fields
    coeffs = sim._builder._coeffs
    dt = sim.dt
    e_k = lambda: fieldskernel.update_efield_k(f, grid, dt / 2, cpml,
                                               coeffs["e"])
    b_k = lambda: fieldskernel.update_bfield_k(f, grid, dt / 2, cpml,
                                               coeffs["b"])
    dev_e, wall_e = kernel_ms(e_k, args.iters, "B1 E")
    tm_e = kernel_ms.method
    dev_b, wall_b = kernel_ms(b_k, args.iters, "B1 B")
    tm_b1 = timing(tm_e, kernel_ms.method)
    ms_b1 = (dev_e + dev_b) / 2 if dev_e and dev_b else (wall_e + wall_b) / 2
    log(f"[time B1] device {ms_b1:.4f} ms per launch, wall "
        f"{(wall_e + wall_b) / 2:.4f} ms per call")
    plain_b1 = (cuda_time(lambda: maxwell.update_efield(f, grid, dt / 2, cpml), 1)
                + cuda_time(lambda: maxwell.update_bfield(f, grid, dt / 2, cpml),
                            1)) / 2
    isz = f.ex.element_size()
    cell = grid.nx * grid.ny * isz

    def psi_bytes(prefix):
        return sum(v.numel() * isz for k, v in f.psi.items()
                   if k.startswith(prefix))
    # E half: 9 fields read, 3 written, its four psi slabs read and
    # written; B half: 6 read, 3 written, its own four; bound per launch
    # is the mean of the two
    bound_b1 = ((12 * cell + 2 * psi_bytes("psi_e"))
                + (9 * cell + 2 * psi_bytes("psi_b"))) / 2 / HBM_BPS * 1e3

    p = sim.state.particles[0]
    sp = sim._species_static[0]
    eb_pad = sim._builder.pad_eb(f)
    kw = dict(q=sp.q, m=sp.m, dt=dt, dx=grid.dx, dy=grid.dy, g=g,
              periodic=periodic, with_rho=sim._builder.with_rho)
    dev_b2, wall_b2 = kernel_ms(
        lambda: cell_step(eb_pad, p.data, p.alive, **kw), args.iters, "B2",
        split=True)
    ms_b2, tm_b2 = dev_b2 or wall_b2, kernel_ms.method
    log(f"[time B2] device {ms_b2:.4f} ms per launch{kernel_ms.split}, wall "
        f"{wall_b2:.4f} ms per call")
    plain_b2 = cuda_time(lambda: cell_step_plain(eb_pad, p.data, p.alive,
                                                 **kw), 1)
    ncomp = 4 if sim._builder.with_rho else 3
    pshape = panel_shape(ncomp, grid.nx, grid.ny)
    pan_b = int(np.prod(pshape)) * isz
    out = cell_step(eb_pad, p.data, p.alive, **kw)
    rims = out[3]
    slots = p.alive.numel()
    n_alive = int(p.alive.sum())
    # B2's answer depends on the alive mask and on alive slots' payloads
    # only (a dead slot is never a source and leaves zeroed), so it must
    # read the mask (1 B a slot), x y z w ux uy uz inv_gamma and the two
    # int32 ids of each alive slot, and the E/B nodes that the gather
    # reaches from occupied cells; it writes every slot once (mask, eight
    # reals, two ids) and the panels
    slot_b = 1 + 8 * isz + 2 * 4
    bytes_b2 = (slots + n_alive * (slot_b - 1) + slots * slot_b
                + gather_nodes(out[1], g) * isz + pan_b)
    ops_ms_b2 = n_alive * FLOPS_PER_PARTICLE / F32_FLOPS * 1e3
    bound_b2 = max(bytes_b2 / HBM_BPS * 1e3, ops_ms_b2)
    by_b2 = "bytes" if bound_b2 > ops_ms_b2 else "operations"
    log(f"[bound B2] {n_alive} of {slots} slots alive: {bytes_b2} bytes, "
        f"{bytes_b2 / HBM_BPS * 1e3:.4f} ms; operations {ops_ms_b2:.4f} ms; "
        f"{occupancy(p.alive)}")
    del out
    dev_b3, wall_b3 = kernel_ms(
        lambda: fold_reduce(rims, grid.shape, periodic), args.iters, "B3")
    ms_b3, tm_b3 = dev_b3 or wall_b3, kernel_ms.method
    log(f"[time B3] device {ms_b3:.4f} ms per launch, wall {wall_b3:.4f} ms "
        "per call")
    plain_b3 = cuda_time(lambda: fold_reduce_plain(rims, grid.shape,
                                                   periodic), 1)
    bound_b3 = (pan_b + ncomp * cell) / HBM_BPS * 1e3
    per_step = {k: v // steps for k, v in launches.items()}
    kernels = [
        dict(name="B1 fields half-step", route="cuda",
             source="lambdapic_torch/csrc/fields.cu",
             replaces="lambdapic_tpu/ops/fieldspallas.py:152",
             launches=launches["B1"], max_abs_err=errs["B1"], ms=ms_b1,
             timing=tm_b1, plain_ms=plain_b1, bound_ms=bound_b1,
             bound_by="bytes", library_ms=None),
        dict(name="B2 cell particle stage", route="cuda",
             source="lambdapic_torch/csrc/cellstep.cu",
             replaces="lambdapic_tpu/ops/cellslab.py:546",
             launches=launches["B2"], max_abs_err=errs["B2"], ms=ms_b2,
             timing=tm_b2, plain_ms=plain_b2, bound_ms=bound_b2,
             bound_by=by_b2, library_ms=None),
        dict(name="B3 rim fold", route="cuda",
             source="lambdapic_torch/csrc/fold.cu",
             replaces="lambdapic_tpu/ops/cellslab.py:2098",
             launches=launches["B3"], max_abs_err=errs["B3"], ms=ms_b3,
             timing=tm_b3, plain_ms=plain_b3, bound_ms=bound_b3,
             bound_by="bytes", library_ms=None),
    ]
    log(f"[kernels 2D] launches per step {per_step}")
    del rims, eb_pad
    kernels += run_mesh_2d(args, sim, laser)
    run_split(args, sim, laser)
    kernels += run_stages_mesh_2d(args, sim, laser)
    return kernels


# ---------------------------------------------------------------------------
# QED: example/photons.py
# ---------------------------------------------------------------------------

# the example's simulated time
QED_SIM_TIME = 100e-15
# steps per chunk of the checked start of the QED slice, and the least
# distance (cells) from an open face that a moving particle may have for
# the chunk to count as loss-free: c dt per step is 0.67 cells per axis
CHUNK_QED = 4
MARGIN_QED = 3.0
QED_CASES = [(4, 16, 16, (True, True), 0.4), (6, 24, 40, (False, False), 0.5),
             (8, 16, 16, (False, True), 0.85), (20, 33, 18, (True, False), 0.5)]


def check_b2_qed_f64(dev, cases):
    """B2's want_chi and photon modes against their plain versions, float64
    slot for slot (compare_slots' rule at rtol 1e-11, chi and ig0
    included; the QED payloads exactly) at small sizes, 2D or 3D by the
    cases (cap, *cells, periodic, n_frac): periodic, open and mixed faces,
    a case built to merge, QED payloads that differ per slot (photons
    carry them too). Returns (the merges of each mode, whether every
    array on alive slots was bitwise equal)."""
    import torch
    from lambdapic_torch.ops.cellslab import (cell_step, cell_step_plain,
                                              panel_shape)
    from lambdapic_torch.testing import (QED_PAYLOADS, SLOT_FLOATS,
                                         add_qed_payloads, compare_slots,
                                         photon_cell_state, random_cell_state,
                                         to_numpy, to_torch)
    q, m, dt = -1.602e-19, 9.109e-31, 1.1e-16
    merges = {"want_chi": 0, "photon": 0}
    bitwise = True

    def check(tag, ref, got, keys):
        nonlocal bitwise
        rn, gn = to_numpy(ref[0], ref[1]), to_numpy(got[0], got[1])
        compare_slots(*rn, *gn, rtol=1e-11, keys=keys)
        compare_slots(*rn, *gn, rtol=0, keys=QED_PAYLOADS)
        a = got[1]
        bitwise &= torch.equal(got[1], ref[1]) and all(
            torch.equal(got[0][k][a], ref[0][k][a]) for k in ref[0])
        if int(got[2]) != int(ref[2]):
            fail(f"B2 {tag} merges {int(got[2])} != plain {int(ref[2])}")
        merges[tag] = max(merges[tag], int(ref[2]))

    for cap, *cells, per, frac in cases:
        d = dict(dx=5e-8, dy=5e-8) if len(cells) == 2 else \
            dict(dx=5e-8, dy=6e-8, dz=5.5e-8)
        data, alive, eb = random_cell_state(cap, *cells, n_frac=frac,
                                            seed=cap + cells[0], umax=50.0,
                                            field=5e13)
        td, ta = to_torch(add_qed_payloads(data, seed=cap), alive,
                          torch.float64, dev)
        eb_t = torch.as_tensor(eb).to(dev)
        rin = torch.as_tensor(np.random.default_rng(1).normal(
            size=panel_shape(4, *cells))).to(dev)
        kw = dict(q=q, m=m, dt=dt, g=3, periodic=per, rims_in=rin,
                  want_chi=True, **d)
        ref = cell_step_plain(eb_t, td, ta, **kw)
        got = cell_step(eb_t, td, ta, **kw)
        torch.cuda.synchronize()
        for out in (ref, got):
            out[0]["chi"], out[0]["ig0"] = out[4]
        check("want_chi", ref, got, SLOT_FLOATS + ("chi", "ig0"))
        err = float((got[3] - ref[3]).abs().max())
        if not err <= 1e-12 * float(ref[3].abs().max()):
            fail(f"B2 want_chi panels differ: {err:.3e}")

        pdata, palive = photon_cell_state(cap, *cells, n_frac=frac,
                                          seed=cap + cells[1])
        td, ta = to_torch(add_qed_payloads(pdata, seed=cap), palive,
                          torch.float64, dev)
        kw = dict(q=0.0, m=0.0, dt=dt, g=3, periodic=per, photon=True, **d)
        ref = cell_step_plain(None, td, ta, **kw)
        got = cell_step(None, td, ta, **kw)
        torch.cuda.synchronize()
        if got[3] is not None:
            fail("B2 photon returned panels")
        check("photon", ref, got, SLOT_FLOATS)
    if min(merges.values()) == 0:
        fail(f"a B2 QED float64 mode merged no particle: {merges}")
    return merges, bitwise


def make_slice_qed(dev, seed=0, cell_migration="fast"):
    """example/photons.py at full size (512 x 512 cells, 100 fs), without
    its diagnostics and its log file; its npho callback kept. Returns
    (sim, laser, npho callback, photon species)."""
    from lambdapic_torch import (Electron, Photon, Proton, SimpleLaser2D,
                                 Simulation, callback)
    from lambdapic_torch.constants import c, e, epsilon_0, m_e, pi
    um = 1e-6
    l0 = 0.8 * um
    omega0 = 2 * pi * c / l0
    nc = epsilon_0 * m_e * omega0**2 / e**2
    nx = ny = 512
    dx = dy = l0 / 20

    def density(n0):
        def _density(x, y):
            ne = 0.0
            if x > 2 * um:
                ne = n0
            return ne
        return _density

    laser = SimpleLaser2D(a0=300, w0=2e-6, l0=0.8e-6, ctau=5e-6)
    sim = Simulation(tiling="cell", nx=nx, ny=ny, dx=dx, dy=dy,
                     sim_time=QED_SIM_TIME, random_seed=seed, device=dev,
                     cell_migration=cell_migration)
    ele = Electron(density=density(5 * nc), ppc=10, radiation="photons")
    pho = Photon(capacity=1 << 20)
    ele.set_photon(pho)
    proton = Proton(density=density(5 * nc), ppc=10)
    sim.add_species([ele, proton, pho])

    @callback(interval=10e-15)
    def npho(sim):
        log(f"[slice QED] step {sim.itime}: nphoton = "
            f"{sim.npart_alive[pho.ispec]}")
    return sim, laser, npho, pho


def face_margin(sim, moving=1e-3, species=None):
    """Least distance, in cells, from an open face of any alive particle
    that moves (|u| > ``moving``), over all species (or the species of
    index ``species``)."""
    import torch
    best = float("inf")
    parts = sim.state.particles
    for p in parts if species is None else (parts[species],):
        u2 = sum(p.data[k].double()**2 for k in ("ux", "uy", "uz"))
        m = p.alive & (u2 > moving**2)
        for ax, n, per in zip(sim.grid.axes, sim.grid.shape,
                              sim.grid.periodic_axes):
            if per or not bool(m.any()):
                continue
            pos = p.data[ax][m].double()
            best = min(best, float(torch.minimum(pos + 0.5,
                                                 (n - 0.5) - pos).min()))
    return best


def momentum(p):
    """Sum of w u over a species' alive slots, float64, per component."""
    import torch
    w = torch.where(p.alive, p.data["w"], 0).to(torch.float64)
    return np.array([float((w * p.data[k].to(torch.float64)).sum())
                     for k in ("ux", "uy", "uz")])


def qed_events(sim, proc):
    """The radiating species after one want_chi launch and its event
    update on the current state (the first half of a QED step's work),
    and that launch's chi. The simulation's state is not changed."""
    from lambdapic_torch.models.qed import species_key
    from lambdapic_torch.ops.cellslab import cell_step
    grid, st = sim.grid, sim._species_static[proc.ispec]
    e = sim.state.particles[proc.ispec]
    out = cell_step(sim._builder.pad_eb(sim.state.fields), e.data, e.alive,
                    q=st.q, m=st.m, dt=sim.dt, dx=grid.dx, dy=grid.dy,
                    dz=grid.dz if grid.dimension == 3 else None,
                    g=grid.n_guard, periodic=grid.periodic_axes,
                    with_rho=sim._builder.with_rho, want_chi=True)
    key = species_key(sim._base_key, sim.itime, proc.ispec)
    data, alive = proc.update_events_from_chi(out[0], out[1], key, sim.dt,
                                              *out[4])
    return e.replace(data=data, alive=alive), out


def check_creation(sim, proc):
    """One creation phase on its own, on the current state after a
    want_chi launch and the event update: electrons lose exactly what the
    newborn photons carry (sum of w delta u over the events), the photons
    gain it, less what newborns without a free slot would have carried,
    so sum w u over electrons + photons holds to float32 rounding; the
    newborns carry their parents' weight. Returns (events, dropped,
    relative change of the total)."""
    import torch
    parts = list(sim.state.particles)
    e, _ = qed_events(sim, proc)
    parts[proc.ispec] = e
    ph = parts[proc.photon_ispec]
    ev = e.alive & (e.data["event"] > 0)
    n_ev = int(ev.sum())
    if n_ev == 0:
        fail("QED creation check: no event at this step")
    w = torch.where(ev, e.data["w"], 0).to(torch.float64)
    carried = np.array([float((w * e.data["delta"].to(torch.float64)
                               * e.data[k].to(torch.float64)).sum())
                        for k in ("ux", "uy", "uz")])
    scale = float((w * torch.sqrt(sum(e.data[k].to(torch.float64)**2
                                      for k in ("ux", "uy", "uz")))).sum())
    newborn_max = float((w * e.data["delta"].to(torch.float64)
                         * torch.sqrt(sum(e.data[k].to(torch.float64)**2
                                          for k in ("ux", "uy", "uz")))
                         ).max())
    e0, p0 = momentum(e), momentum(ph)
    out = sim._builder.qed_creation(proc, parts)
    e1, p1 = momentum(out[proc.ispec]), momentum(out[proc.photon_ispec])
    nph = out[proc.photon_ispec]
    dropped = int(nph.overflow) - int(ph.overflow)
    new = nph.alive & ~ph.alive
    tol = 1e-6 * scale
    if not np.abs((e0 - e1) - carried).max() <= tol:
        fail(f"QED creation: electrons lost {e0 - e1}, events carried "
             f"{carried}")
    slack = tol + dropped * newborn_max
    if not np.abs((p1 - p0) - carried).max() <= slack:
        fail(f"QED creation: photons gained {p1 - p0}, events carried "
             f"{carried}, {dropped} newborns dropped")
    if int(new.sum()) != n_ev - dropped:
        fail(f"QED creation: {int(new.sum())} newborn slots for {n_ev} "
             f"events and {dropped} dropped")
    w_new = float(torch.where(new, nph.data["w"], 0).sum(dtype=torch.float64))
    w_ev = float(w.sum())
    if dropped == 0 and not abs(w_new - w_ev) <= 1e-6 * w_ev:
        fail(f"QED creation: newborn weight {w_new} != parents' {w_ev}")
    change = float(np.abs((e1 + p1) - (e0 + p0)).max()) / scale
    log(f"[QED creation] step {sim.itime}: {n_ev} events, {dropped} "
        f"newborns dropped, newborn weight {w_new:.7e} (parents "
        f"{w_ev:.7e}); sum w u over electrons + photons changed by "
        f"{change:.3e} of the events' sum w |u|")
    return n_ev, dropped, change


def x_planes(p, x0, n):
    """A species' slots on the x-planes x0 .. x0+n-1 (every payload, x
    re-based) as a state of their own."""
    from types import SimpleNamespace
    data = {k: v[:, x0:x0 + n].contiguous() for k, v in p.data.items()}
    data["x"] = data["x"] - float(x0)
    return SimpleNamespace(data=data, alive=p.alive[:, x0:x0 + n].contiguous())


def compare_b2_qed_f32(sim, proc, planes=None):
    """The want_chi kernel (electrons) and the photon kernel (photons)
    against their plain versions in float32 on a 2D or 3D QED slice's
    final state, with its fields: alive masks and the ids of alive slots
    identical, merges equal. With ``planes`` = (x0, n) want_chi is held
    on the x-planes x0 .. x0+n-1 only, their faces open (in 3D its plain
    version's gather and 125-offset deposit temporaries at the whole end
    state do not fit the card beside it); the photon mode, which gathers
    and deposits nothing, always on the whole state. Returns {mode: the
    largest chi difference (want_chi), the largest photon position
    difference (photon)}."""
    import dataclasses
    import torch
    from lambdapic_torch.ops.cellslab import cell_step, cell_step_plain
    errs = {}
    for ispec, mode in ((proc.ispec, "want_chi"), (proc.photon_ispec,
                                                   "photon")):
        grid = sim.grid
        eb_pad = sim._builder.pad_eb(sim.state.fields)
        p, st = sim.state.particles[ispec], sim._species_static[ispec]
        if planes is not None and mode == "want_chi":
            x0, n = planes
            grid = dataclasses.replace(grid, nx=n)
            eb_pad = eb_pad[:, x0:x0 + n + 2 * grid.n_guard].contiguous()
            p = x_planes(p, *planes)
        shape_s = "x".join(str(n) for n in grid.shape)
        kw = dict(q=st.q, m=st.m, dt=sim.dt, dx=grid.dx, dy=grid.dy,
                  dz=grid.dz if grid.dimension == 3 else None,
                  g=grid.n_guard, periodic=grid.periodic_axes,
                  with_rho=False, **{mode: True})
        ebp = None if mode == "photon" else eb_pad
        del eb_pad
        ref = cell_step_plain(ebp, p.data, p.alive, **kw)
        got = cell_step(ebp, p.data, p.alive, **kw)
        torch.cuda.synchronize()
        moved = int((got[1] != p.alive).sum())
        same = torch.equal(got[1], ref[1]) and all(
            torch.equal(got[0][k][got[1]], ref[0][k][ref[1]])
            for k in ("id_lo", "id_hi"))
        if mode == "want_chi":
            a = got[1]
            err = float((got[4][0][a] - ref[4][0][a]).abs().max())
            peak = float(ref[4][0][a].abs().max())
            errs[mode] = err
            extra = f"chi max abs diff {err:.3e} of peak {peak:.3e}"
        else:
            a = got[1]
            err = max(float((got[0][k][a] - ref[0][k][a]).abs().max())
                      for k in grid.axes)
            errs[mode] = err
            extra = f"positions max abs diff {err:.3e} cells"
        log(f"[B2 {mode} f32 {shape_s}] {int(p.alive.sum())} alive in "
            f"{p.alive.numel()} slots, {moved} slots changed occupancy, "
            f"merges {int(got[2])} (plain {int(ref[2])}); {extra}; alive "
            f"masks and ids identical: {same}")
        if moved == 0:
            fail(f"B2 {mode} float32: the compared step re-binned nothing")
        if not same or int(got[2]) != int(ref[2]):
            fail(f"B2 {mode} float32: alive masks, ids or merges differ "
                 "from the plain version")
        del ref, got, ebp, p
        torch.cuda.empty_cache()
    return errs


def check_draws(sim, proc, dev):
    """One step's three uniform draws of the radiating species at its
    (cap, nx, ny), on the card and on the CPU: bitwise equal."""
    import torch
    from lambdapic_torch import random as jr
    from lambdapic_torch.models.qed import species_key
    shape = tuple(sim.state.particles[proc.ispec].alive.shape)
    keys = jr.split(jr.fold_in(species_key(sim._base_key, sim.itime,
                                           proc.ispec), 101), 3)
    for i, k in enumerate(keys):
        card = jr.uniform(k, shape, sim.dtype, device=dev)
        host = jr.uniform(k, shape, sim.dtype, device="cpu")
        if not torch.equal(card.cpu(), host):
            n = int((card.cpu() != host).sum())
            fail(f"draw {i} at {shape}: {n} values differ card vs CPU")
    log(f"[draws] three uniform draws of step {sim.itime} at {shape}, "
        f"{sim.dtype}: card and CPU bitwise equal")


def count_syncs(fn):
    """Host synchronisations that one call of ``fn`` makes, as CUDA's
    sync debug mode reports them (a read of a device value, or a copy
    from pageable host memory, which waits for the stream): for each, the
    innermost line of the port's code that led to it."""
    import traceback
    import torch
    found = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if "lambdapic_torch" in f.filename]
        where = ours[-1] if ours else None
        found.append(f"{where.filename.split('/')[-1]}:{where.lineno}"
                     if where else f"{filename.split('/')[-1]}:{lineno}")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found


def run_qed(args, dev):
    """Phase 5: B2's QED modes against their plain versions, the draws,
    the QED slice through Simulation.run with its checks, and the QED
    modes' and the plain-torch QED work's times; returns the QED kernels'
    entries of the ``kernels`` line."""
    import torch
    from lambdapic_torch.models.qed import species_key
    from lambdapic_torch.ops import cellslab, fieldskernel

    merges, bitwise = check_b2_qed_f64(dev, QED_CASES)
    log(f"[B2 QED f64] want_chi and photon slot-exact in {len(QED_CASES)} "
        f"cases each (chi, ig0, tau, delta, event included); merges in the "
        f"merging case {merges}; every array bitwise equal: {bitwise}")

    # -- the slice state ------------------------------------------------------
    t0 = time.time()
    sim, laser, npho, pho = make_slice_qed(dev)
    sim.initialize()
    torch.cuda.synchronize()
    proc = sim._qed_processes[0]
    steps_all = args.steps_qed or int(QED_SIM_TIME / sim.dt)
    log(f"[slice QED] initialised in {time.time() - t0:.1f} s: "
        f"{sim.npart_alive} particles, slots "
        f"{[p.cap for p in sim.state.particles]}, dt {sim.dt:.4e} s, "
        f"{int(QED_SIM_TIME / sim.dt)} steps in the example's "
        f"{QED_SIM_TIME:.0e} s")
    log("[slice QED] cut from example/photons.py: ExtractSpeciesDensity and "
        "PlotFields (diagnostics, ROADMAP queue 1 item 6) and its log file "
        "photons.log; kept: the grid, species, laser, sim_time and the npho "
        "callback; random_seed fixed at 0")
    check_draws(sim, proc, dev)

    # -- the main path ---------------------------------------------------------
    # Particle number is checked while nothing can have reached a face: the
    # first steps run in chunks of CHUNK_QED, and after each chunk the
    # least distance of a moving particle (any photon, a massive particle
    # with |u| > 1e-3) from an open face is taken; a particle moves less
    # than 0.68 cells a step, so while that distance stays above
    # MARGIN_QED no particle has left. At the last such chunk (at most step
    # 200): electrons and protons alive + merged = the start (less the
    # particles stored on an open face's edge), their weight unchanged;
    # photons alive + merged + dropped newborns = photons born. The last
    # --window-qed steps are timed.
    ie, ip = proc.ispec, proc.photon_ispec
    before = totals(sim)
    on_edge = edge_sitters(sim)
    born0 = int(sim.state.particles[ip].next_id)
    log(f"[slice QED] particles stored on an open face's edge: {on_edge}")
    reset_launches()
    n_timed = min(args.window_qed, steps_all)
    n_a = min(steps_all - n_timed, 200)
    n_b = steps_all - n_timed - n_a
    t0 = time.time()
    check, margin = None, float("inf")
    while sim.itime < n_a:
        sim.run(nsteps=min(CHUNK_QED, n_a - sim.itime),
                callbacks=[laser, npho])
        if margin >= MARGIN_QED:
            margin = face_margin(sim)
            if margin >= MARGIN_QED:
                check = (sim.itime, totals(sim),
                         int(sim.state.particles[ip].next_id) - born0)
    torch.cuda.synchronize()
    if n_b:
        sim.run(nsteps=n_b, callbacks=[laser, npho])
    torch.cuda.synchronize()
    t1 = time.time()
    sim.run(nsteps=n_timed, callbacks=[laser, npho])
    torch.cuda.synchronize()
    t2 = time.time()
    launches = {"B1": fieldskernel.update_half_k.launches,
                "B2": cellslab.cell_step.launches,
                "B3": cellslab.fold_reduce.launches}
    by_mode = dict(cellslab.cell_step.launches_by_mode)
    after = totals(sim)
    steps = sim.itime
    born = int(sim.state.particles[ip].next_id) - born0
    log(f"[slice QED] {steps} steps: first {n_a + n_b} in {t1 - t0:.2f} s, "
        f"window {n_timed} in {t2 - t1:.3f} s; launches {launches}, B2 by "
        f"mode {by_mode}; photons born {born}")
    want = {"B1": 4 * steps, "B2": 3 * steps, "B3": steps}
    want_mode = {"default": steps, "want_chi": steps, "photon": steps}
    if launches != want or by_mode != want_mode:
        fail(f"QED launch counts {launches} {by_mode} != {want} {want_mode}")
    check_finite(sim, "QED")
    if born == 0:
        fail("no photon emitted")
    if check is None or check[2] == 0:
        fail(f"no step with photons born before a moving particle came "
             f"within {MARGIN_QED} cells of an open face ({check})")
    n_chk, mid, born_mid = check
    log(f"[slice QED] particle number checked at step {n_chk}, the last "
        f"chunk end with every moving particle {MARGIN_QED}+ cells from the "
        f"open faces; {born_mid} photons born by then")
    for (n0, m0, w0), (n1, m1, w1), (n2, m2, w2), edge, sp in zip(
            before, mid, after, on_edge, sim.species):
        log(f"[slice QED] {sp.name}: alive {n0} -> {n1} (step {n_chk}) -> "
            f"{n2}, merged or dropped {m1 - m0} -> {m2 - m0}, weight "
            f"{w0:.7e} -> {w1:.7e} -> {w2:.7e}, slots per cell "
            f"{sim.state.particles[sp.ispec].cap}")
        if sp.ispec == ip:
            # every newborn is alive, merged into another or dropped
            if n1 + (m1 - m0) != born_mid + n0:
                fail(f"photons: {n1} alive + {m1 - m0} merged or dropped != "
                     f"{born_mid} born by step {n_chk}")
            continue
        if n1 + (m1 - m0) != n0 - edge:
            fail(f"QED {sp.name}: particles not conserved to step {n_chk} "
                 f"({n0} - {edge} on an edge -> {n1} + {m1 - m0} merges)")
        if not abs(w1 - w0) <= 1e-5 * w0:
            fail(f"QED {sp.name}: weight not conserved to step {n_chk} ({w0} "
                 f"-> {w1})")
    check_photon_ig(sim, ip, "slice QED")
    step_ms = (t2 - t1) * 1e3 / n_timed
    npart = sum(n for n, _, _ in after)
    ey_peak = float(sim.state.fields.ey.abs().max())
    log(f"[slice QED] step {step_ms:.3f} ms (host clock, synchronised), "
        f"{npart / (step_ms * 1e-3):.4e} pushes/s ({npart} alive particles "
        f"of three species), peak |ey| {ey_peak:.3e}")
    busy_per_step(lambda: sim.run(nsteps=1, callbacks=[laser]),
                  {"e_half": 2, "b_half": 2, "rebin2x": 3, "rebin2y": 3,
                   "deposit2": 2, "fold<": 1}, 5, "profile QED", step_ms)

    # -- checks beside the main path, on its final state ------------------------
    n_ev, dropped, change = check_creation(sim, proc)
    errs = compare_b2_qed_f32(sim, proc)
    torch.cuda.empty_cache()

    # -- the plain-torch QED work: device time and host synchronisations --------
    _, outs = qed_events(sim, proc)
    e = sim.state.particles[ie]
    key = species_key(sim._base_key, sim.itime, ie)

    def qed_work():
        data, alive = proc.update_events_from_chi(outs[0], outs[1], key,
                                                  sim.dt, *outs[4])
        parts = list(sim.state.particles)
        parts[ie] = e.replace(data=data, alive=alive)
        return sim._builder.qed_creation(proc, parts)
    wall_qed = cuda_time(qed_work, 5)
    # the profile must hold the marker and the timed calls' kernels
    times, _ = device_times(qed_work, 5, {})
    dev_qed = (sum(ms for ms, _ in times.values()) / 5) if times else None
    n_launch = sum(n for _, n in times.values()) / 5
    for name, (ms, n) in sorted(times.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[QED plain] {ms / 5:8.3f} ms a step in {n // 5} launches  "
            f"{name[:70]}")
    syncs = count_syncs(qed_work)
    syncs_step = count_syncs(
        lambda: sim._builder.full_step(sim.state, sim._scalars([laser])))
    dev_s = "not measured" if dev_qed is None else f"{dev_qed:.3f} ms"
    log(f"[QED plain] device {dev_s} per step in {n_launch:.0f} kernel "
        f"launches, wall {wall_qed:.3f} ms (CUDA events; draws, rate, "
        f"sampler, insertion, recoil); host synchronisations: {len(syncs)} "
        f"in the QED work {syncs}, {len(syncs_step)} in a whole step "
        f"(StepBuilder.full_step) {syncs_step}")
    del outs
    torch.cuda.empty_cache()

    # -- B2's QED modes timed at the slice's shapes ------------------------------
    kernels = time_b2_qed_modes(sim, proc, args.iters, by_mode, errs)
    log(f"[kernels QED] launches per step B1 {launches['B1'] // steps}, B2 "
        f"{launches['B2'] // steps} ({ {k: v // steps for k, v in by_mode.items()} }), "
        f"B3 {launches['B3'] // steps}; creation check: {n_ev} events, "
        f"{dropped} dropped, total change {change:.2e}")
    kernels += run_qed_mesh(
        args, sim, laser, (2, 2), args.steps_qed_mesh, args.window_qed_mesh,
        {"rebin2x": 12, "rebin2y": 12, "deposit2": 8, "fold<": 4,
         "strips<": 8})
    return kernels


# ---------------------------------------------------------------------------
# the per-stage engine: kernels B4-B7, exact migration, the split step
# ---------------------------------------------------------------------------

# B4's and B5's floating-point work per alive particle, counted from
# csrc/push2d.cu and csrc/deposit2d.cu as for B2: B4 six staggered gathers
# of 9-16 taps with their spline weights (about 700), Boris (about 60) and
# the half push (about 6); B5 the 5 x 5 Esirkepov nodes of four channels
# with their shapes (about 600). B6 and B7 move data; a merge is a handful
# of operations a merged slot.
FLOPS_B4 = 770
FLOPS_B5 = 600
# launches of the per-stage kernels on the per-stage paths (exact, exact
# QED, split, split with LAMBDAPIC_MIG_FUSED=0), summed for the kernels line
STAGE_LAUNCHES = {"B4": 0, "B4 want_eb": 0, "B5": 0, "B6": 0, "B7": 0}
# per-stage kernels' float32 errors and times, filled by the phases
STAGE = {}
KERNEL_FUNCS.update({"B4": {"push<": 1}, "B5": {"deposit<": 1, "fold_pad": 1},
                     "B6": {"migrate_tile": 2}, "B7": {"sort_cells": 1}})
# the cases of tests/test_torch_kernels.py
STAGE_CASES = [(13, 18, 10, (True, True), 0.5), (16, 15, 12, (False, True), 0.9),
               (20, 12, 16, (True, False), 1.0), (4, 33, 18, (False, False), 0.9),
               (8, 1, 299, (True, False), 0.9), (4, 2, 260, (False, True), 0.9),
               (16, 17, 132, (False, True), 0.9), (20, 9, 70, (True, True), 1.0),
               (32, 6, 65, (False, False), 1.0), (33, 5, 9, (True, False), 1.0)]


def _close(a, b, rtol, floor):
    """max |a - b| and whether |a - b| <= rtol |b| + floor * peak(b)."""
    import torch
    if a.numel() == 0:
        return 0.0, True
    d = (a.double() - b.double()).abs()
    peak = float(b.double().abs().max())
    ok = bool((d <= rtol * b.double().abs() + floor * peak).all())
    return float(d.max()), ok


def check_b6_f64(dev, cap, cells, per, frac):
    """B6 (migrate_cells_fused) against its plain version in float64 on a
    crowded 2D or 3D state with QED payloads, for a species that recomputes
    inv_gamma and for a photon species that carries it: every array equal.
    Returns the larger merge count."""
    import torch
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import migrate_cells
    from lambdapic_torch.testing import (add_qed_payloads, crowded_cell_state,
                                         to_torch)
    merges = 0
    for photon in (False, True):
        data, alive, _ = crowded_cell_state(cap, *cells, n_frac=frac,
                                            seed=cap + cells[0])
        data = add_qed_payloads(data, seed=cap)
        if photon:
            u2 = data["ux"]**2 + data["uy"]**2 + data["uz"]**2
            data["inv_gamma"] = np.where(
                u2 > 0, 1 / np.sqrt(np.maximum(u2, 1e-30)), 1.0)
        td, ta = to_torch(data, alive, torch.float64, dev)
        plan = tuple(zip(cells, per, "xyz"))
        ref = migrate_cells(td, ta, plan, recompute_ig=not photon)
        got = cp.migrate_cells_fused(td, ta, plan, recompute_ig=not photon)
        same = torch.equal(got[1], ref[1]) and sorted(got[0]) == \
            sorted(ref[0]) and all(torch.equal(got[0][k], ref[0][k])
                                   for k in ref[0])
        if not same or int(got[2]) != int(ref[2]):
            fail(f"B6 f64 ({len(cells)}D, cap {cap}, periodic {per}, photon "
                 f"{photon}) differs from its plain version")
        merges = max(merges, int(ref[2]))
    return merges


def check_b7(dev, cap, shape):
    """B7 against its plain version on slots of ``shape`` (any rank):
    random int32 keys, float64, float32, int32 and bool payloads, every
    array equal."""
    import torch
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import batcher_sort
    rng = np.random.default_rng(cap)
    key = torch.as_tensor(rng.integers(-3, 6, shape).astype(np.int32)).to(dev)
    pays = [torch.as_tensor(rng.normal(size=shape)).to(dev),
            torch.as_tensor(rng.normal(size=shape), dtype=torch.float32
                            ).to(dev),
            torch.as_tensor(rng.integers(-2**31, 2**31, shape).astype(
                np.int32)).to(dev),
            torch.as_tensor(rng.uniform(size=shape) < 0.5).to(dev)]
    rk, rp = batcher_sort(key, pays)
    gk, gp = cp.sort_cells(key, pays)
    if not (torch.equal(gk, rk) and all(torch.equal(a, b)
                                        for a, b in zip(gp, rp))):
        fail(f"B7 on slots {shape} differs from its plain version")


def check_stage_f64(dev):
    """B4 (both modes, with and without the first half push, given the
    alive mask) bitwise with the dead values in the dead slots, B5 (given
    the mask) to 1e-12 of the peak, B6 (periodic and open faces, merges,
    caps 4, 13, 16, 20, a photon species' carried inv_gamma) and B7 (caps
    13, 16, 20, float, int32 and bool payloads) array for array equal, all
    against their plain versions in float64 at small sizes. Returns the
    largest B6 merge count."""
    import torch
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import deposit_cell_2d
    from lambdapic_torch.testing import random_cell_state, to_torch
    q, m, dt, d = -1.602e-19, 9.109e-31, 1.1e-16, 5e-8
    data, alive, eb = random_cell_state(5, 33, 18, seed=7, field=5e13)
    td, ta = to_torch(data, alive, torch.float64, dev)
    eb = torch.as_tensor(eb).to(dev)
    args = [td[k] for k in ("x", "y", "ux", "uy", "uz")]
    for want_eb in (False, True):
        for do_pos1 in (False, True):
            kw = dict(q=q, m=m, dt=dt, dx=d, dy=0.9 * d, g=3, alive=ta,
                      want_eb=want_eb, do_pos1=do_pos1)
            ref = cp.fused_push_cell_2d_plain(eb, *args, **kw)
            got = cp.fused_push_cell_2d(eb, *args, **kw)
            dead = all(bool((a[~ta] == (1.0 if i == 5 else 0.0)).all())
                       for i, a in enumerate(got))
            if not (dead and all(torch.equal(a, b)
                                 for a, b in zip(got, ref))):
                fail(f"B4 f64 (want_eb {want_eb}, do_pos1 {do_pos1}) "
                     f"differs from its plain version; dead slots hold the "
                     f"dead values: {dead}")
    for cap, nx, ny, g in ((6, 24, 40, 3), (20, 33, 18, 2)):
        data, alive, _ = random_cell_state(cap, nx, ny, seed=cap, spread=0.99)
        td, ta = to_torch(data, alive, torch.float64, dev)
        w = torch.where(ta, td["w"], 0.0)
        a7 = [td[k] for k in ("x", "y", "ux", "uy", "uz", "inv_gamma")] + [w]
        kw = dict(q=q, dx=d, dy=1.1 * d, dt=dt, g=g)
        ref = deposit_cell_2d(*a7, **kw)
        got = cp.deposit_cell_2d_k(*a7, alive=ta, **kw)
        err = float((got - ref).abs().max())
        if not err <= 1e-12 * float(ref.abs().max()):
            fail(f"B5 f64 differs from its plain version by {err:.3e}")
    merges = max(check_b6_f64(dev, cap, (nx, ny), per, frac)
                 for cap, nx, ny, per, frac in STAGE_CASES)
    if merges == 0:
        fail("no B6 float64 case merged particles")
    for cap in (13, 16, 20):
        check_b7(dev, cap, (cap, 17, 9))
    return merges


def five_way_key(pos, alive, axis):
    """The re-binning's 5-way key of ops/cell2d.py::migrate_cells along
    ``axis`` of 2D or 3D slots (the sort key B7 takes on the split
    path)."""
    import torch
    cap, nt = alive.shape[0], alive.shape[1 + axis]
    ishape = [1] * alive.ndim
    ishape[1 + axis] = nt
    local = pos - torch.arange(nt, dtype=pos.dtype,
                               device=pos.device).reshape(ishape)
    parity = ((torch.arange(cap, device=alive.device) & 1) == 0
              ).reshape([cap] + [1] * (alive.ndim - 1))
    key = torch.where(alive & (local >= 0.5), 0, torch.where(
        alive & (local < -0.5), 4, torch.where(
            alive, 2, torch.where(parity, 1, 3))))
    return key.to(torch.int32)


def stage_inputs(sim):
    """The per-stage kernels' inputs from species 0 (the electrons) of a
    2D slice: the stored state with its first half push applied (B6's and
    B7's input), and that state re-binned by the plain version (B4's and
    B5's input). Returns (pushed data, alive, re-binned data, alive)."""
    from lambdapic_torch.constants import c
    from lambdapic_torch.ops.cell2d import migrate_cells
    from lambdapic_torch.ops.pusher import push_position_2d
    grid = sim.grid
    p = sim.state.particles[0]
    d = dict(p.data)
    d["x"], d["y"] = push_position_2d(d["x"], d["y"], d["ux"], d["uy"],
                                      d["inv_gamma"], c * sim.dt / grid.dx / 2,
                                      c * sim.dt / grid.dy / 2)
    plan = tuple(zip(grid.shape, grid.periodic_axes, ("x", "y")))
    rd, ra, _ = migrate_cells(d, p.alive, plan)
    return d, p.alive, rd, ra


def check_stage_f32(sim):
    """B4-B7 against their plain versions at the 2D slice's shapes
    (1024^2, 20 slots a cell, float32), on its electrons given momenta by
    one B2 step in strong random fields (as compare_b2_f32): B6 and B7
    equal array for array (alive masks, ids and payloads), B4 (both modes,
    given the alive mask as the step calls it) bitwise on the alive slots
    and the dead values (0, inv_gamma 1) in the dead ones, B5 (given the
    mask) to 1e-5 of the current's peak. Returns the largest absolute
    errors."""
    import torch
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import batcher_sort, deposit_cell_2d, \
        migrate_cells
    from lambdapic_torch.ops.cellslab import cell_step
    grid = sim.grid
    g = grid.n_guard
    per = grid.periodic_axes
    sp = sim._species_static[0]
    rng = np.random.default_rng(2)
    eb_pad = torch.as_tensor(rng.uniform(-5e13, 5e13, (6, grid.nx + 2 * g,
                                                        grid.ny + 2 * g)),
                             dtype=torch.float32).to(sim.device)
    p0 = sim.state.particles[0]
    data, alive = cell_step(eb_pad, p0.data, p0.alive, q=sp.q, m=sp.m,
                            dt=sim.dt, dx=grid.dx, dy=grid.dy, g=g,
                            periodic=per, with_rho=False)[:2]
    saved = sim.state
    sim.state = saved.replace(particles=(p0.replace(data=data, alive=alive),)
                              + saved.particles[1:])
    d, a, _, _ = stage_inputs(sim)
    sim.state = saved
    plan = tuple(zip(grid.shape, per, ("x", "y")))
    ref = migrate_cells(d, a, plan)
    got = cp.migrate_cells_fused(d, a, plan)
    torch.cuda.synchronize()
    moved = int((got[1] != a).sum())
    same = torch.equal(got[1], ref[1]) and all(
        torch.equal(got[0][k], ref[0][k]) for k in ref[0])
    log(f"[B6 f32 1024^2] {moved} slots changed occupancy, merges "
        f"{int(got[2])} (plain {int(ref[2])}); every array equal: {same}")
    if moved == 0 or not same or int(got[2]) != int(ref[2]):
        fail("B6 float32 differs from its plain version (or moved nothing)")
    from lambdapic_torch.ops.cell2d import TRANSIENT
    names = sorted(k for k in d if k not in TRANSIENT)
    key = five_way_key(d["x"], a, 0)
    rk, rp = batcher_sort(key, [d[k] for k in names])
    gk, gp = cp.sort_cells(key, [d[k] for k in names])
    if not (torch.equal(gk, rk) and all(torch.equal(x, y)
                                        for x, y in zip(gp, rp))):
        fail("B7 float32 differs from its plain version")
    log(f"[B7 f32 1024^2] {len(names)} payloads sorted by the x key: equal")
    del gp, rp, got
    rd, ra = ref[0], ref[1]
    errs = {"B6": 0.0, "B7": 0.0}
    args = [rd[k] for k in ("x", "y", "ux", "uy", "uz")]
    for want_eb in (False, True):
        # the per-stage step's call: the alive mask, the dead slots given
        # the dead values (0, inv_gamma 1)
        kw = dict(q=sp.q, m=sp.m, dt=sim.dt, dx=grid.dx, dy=grid.dy, g=g,
                  alive=ra, want_eb=want_eb, do_pos1=False)
        r4 = cp.fused_push_cell_2d_plain(eb_pad, *args, **kw)
        g4 = cp.fused_push_cell_2d(eb_pad, *args, **kw)
        tag = "B4 want_eb" if want_eb else "B4"
        errs[tag] = max(float((x - y).abs().max()) for x, y in zip(g4, r4))
        bitwise = all(torch.equal(x[ra], y[ra]) for x, y in zip(g4, r4))
        dead = all(bool((x[~ra] == (1.0 if i == 5 else 0.0)).all())
                   for i, x in enumerate(g4))
        log(f"[{tag} f32 1024^2] max abs {errs[tag]:.3e}; alive slots "
            f"bitwise equal: {bitwise}; dead slots hold the dead values: "
            f"{dead}")
        if not (bitwise and dead):
            fail(f"{tag} float32 differs from its plain version")
    w = torch.where(ra, rd["w"], 0.0)
    a7 = list(r4[:6]) + [w]
    kw = dict(q=sp.q, dx=grid.dx, dy=grid.dy, dt=sim.dt, g=g)
    r5 = deposit_cell_2d(*a7, **kw)
    g5 = cp.deposit_cell_2d_k(*a7, alive=ra, **kw)
    errs["B5"] = float((g5 - r5).abs().max())
    scale = float(r5.abs().max())
    log(f"[B5 f32 1024^2] max abs {errs['B5']:.3e} of peak {scale:.3e}")
    if not errs["B5"] <= 1e-5 * scale:
        fail(f"B5 float32 differs: {errs['B5']:.3e} > 1e-5 x {scale:.3e}")
    return errs


def ids_of(p):
    """Sorted id_lo of a species' alive slots (int64, on the card)."""
    import torch
    return torch.sort(p.data["id_lo"][p.alive].to(torch.int64)).values


def check_ids_kept(tag, ids0, ov0, sim, gone=None):
    """Every alive id of the start is alive now, less one id a merge or
    drop (the overflow count's advance) and the ``gone`` (per species,
    default none) that left through an open face; no id appears from
    nowhere."""
    import torch
    for i, p in enumerate(sim.state.particles):
        ids1 = ids_of(p)
        lost = int(p.overflow) - ov0[i]
        left = gone[i] if gone else 0
        ok = len(ids1) + lost + left == len(ids0[i]) and bool(
            torch.isin(ids1, ids0[i]).all())
        if lost == 0 and left == 0:
            ok = ok and torch.equal(ids1, ids0[i])
        log(f"[{tag}] {sim.species[i].name}: {len(ids0[i])} ids -> "
            f"{len(ids1)} alive + {lost} merged or dropped + {left} out "
            f"through a face; kept: {ok}")
        if not ok:
            fail(f"{tag}: {sim.species[i].name} lost or gained ids")


def stage_bounds(d, a, rd, ra, g):
    """Byte and operation bounds (ms) of B4 (both modes), B5, B6 (per axis
    launch) and B7 on the timed inputs of 2D or 3D slots: each input read
    once, each output written once; a dead slot's payloads are read where
    the answer depends on them (B6 and B7 carry them), the E/B nodes the
    gather reaches from occupied cells. Returns {kernel: (bound ms,
    "bytes" or "operations", bytes, flops)}."""
    from lambdapic_torch.ops.cell2d import TRANSIENT
    nd = ra.ndim - 1
    isz = d["x"].element_size()
    slots = a.numel()
    n_alive = int(ra.sum())
    nodes = (gather_nodes if nd == 2 else gather_nodes_3d)(ra, g) * isz
    nxp = int(np.prod([n + 2 * g for n in ra.shape[1:]]))
    flops4, flops5 = (FLOPS_B4, FLOPS_B5) if nd == 2 else \
        (FLOPS_B4_3D, FLOPS_B5_3D)
    out = {}
    # B4 (with the alive mask) reads the mask and the alive slots'
    # positions and momenta, writes every slot's positions, momenta and
    # inv_gamma (and the six fields with want_eb)
    for tag, n_out in (("B4", nd + 4), ("B4 want_eb", nd + 10)):
        nbytes = slots + (nd + 3) * n_alive * isz + nodes + \
            n_out * slots * isz
        out[tag] = (nbytes, n_alive * flops4)
    # B5 reads the alive mask, the positions, momenta, inv_gamma and w of
    # the alive slots, and writes the padded current
    out["B5"] = (slots + (nd + 5) * n_alive * isz + 4 * nxp * isz,
                 n_alive * flops5)
    pay = sum(v.element_size() for k, v in d.items() if k not in TRANSIENT)
    out["B6"] = (2 * slots * (1 + pay), 0)
    out["B7"] = (2 * slots * (pay + 4), 0)
    res = {}
    for k, (nbytes, flops) in out.items():
        b_ms, o_ms = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
        res[k] = (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations",
                  nbytes, flops)
    return res


def time_stage_kernels(sim, iters):
    """Device ms per launch of B4 (both modes), B5, B6 (per axis) and B7,
    their plain versions' ms (one call, CUDA events) and their bounds, on
    the electrons of the slice's present state; stored in STAGE."""
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import batcher_sort, deposit_cell_2d, \
        migrate_cells
    grid = sim.grid
    g = grid.n_guard
    sp = sim._species_static[0]
    d, a, rd, ra = stage_inputs(sim)
    eb_pad = sim._builder.pad_eb(sim.state.fields)
    plan = tuple(zip(grid.shape, grid.periodic_axes, ("x", "y")))
    args = [rd[k] for k in ("x", "y", "ux", "uy", "uz")]
    import torch
    w = torch.where(ra, rd["w"], 0.0)
    a7 = [rd[k] for k in ("x", "y", "ux", "uy", "uz", "inv_gamma")] + [w]
    k5 = dict(q=sp.q, dx=grid.dx, dy=grid.dy, dt=sim.dt, g=g)
    from lambdapic_torch.ops.cell2d import TRANSIENT
    names = sorted(k for k in d if k not in TRANSIENT)
    key = five_way_key(d["x"], a, 0)
    pays = [d[k] for k in names]
    calls = {}
    # B4 and B5 as the per-stage step calls them: with the alive mask
    for tag, want_eb in (("B4", False), ("B4 want_eb", True)):
        kw = dict(q=sp.q, m=sp.m, dt=sim.dt, dx=grid.dx, dy=grid.dy, g=g,
                  alive=ra, want_eb=want_eb, do_pos1=False)
        calls[tag] = ("B4", lambda kw=kw: cp.fused_push_cell_2d(
            eb_pad, *args, **kw), lambda kw=kw: cp.fused_push_cell_2d_plain(
            eb_pad, *args, **kw), 1)
    calls["B5"] = ("B5", lambda: cp.deposit_cell_2d_k(*a7, alive=ra, **k5),
                   lambda: deposit_cell_2d(*a7, **k5), 1)
    calls["B6"] = ("B6", lambda: cp.migrate_cells_fused(d, a, plan),
                   lambda: migrate_cells(d, a, plan), 2)
    calls["B7"] = ("B7", lambda: cp.sort_cells(key, pays),
                   lambda: batcher_sort(key, pays), 1)
    bounds = stage_bounds(d, a, rd, ra, g)
    for tag, (funcs, fn, plain_fn, per_call) in calls.items():
        dev_ms, wall = kernel_ms(fn, iters, funcs)
        ms = (dev_ms or wall) / per_call
        plain = cuda_time(plain_fn, 1) / per_call
        bound, by, nbytes, _ = bounds[tag]
        STAGE.setdefault("time", {})[tag] = dict(
            ms=ms, timing=kernel_ms.method, plain_ms=plain, bound_ms=bound,
            bound_by=by)
        log(f"[time {tag}] device {ms:.4f} ms per launch (wall "
            f"{wall / per_call:.4f}); plain {plain:.3f} ms; bound "
            f"{bound:.5f} ms ({by}, {nbytes} bytes; {int(ra.sum())} of "
            f"{ra.numel()} slots alive); {ms / bound:.1f}x the bound")


def stage_rows():
    """The kernels line's rows of B4-B7."""
    src = {"B4": ("B4 gather+Boris+push 2D", "push2d.cu", "cellpallas.py:308"),
           "B4 want_eb": ("B4 want_eb 2D", "push2d.cu", "cellpallas.py:308"),
           "B5": ("B5 deposit 2D", "deposit2d.cu", "cellpallas.py:420"),
           "B6": ("B6 re-binning axis 2D", "migrate.cu",
                  "cellpallas.py:860"),
           "B7": ("B7 slot sort", "sortcells.cu", "cellpallas.py:769")}
    rows = []
    for tag, (name, cu, rep) in src.items():
        t = STAGE["time"][tag]
        launches = STAGE_LAUNCHES[tag]
        if tag == "B4":
            launches -= STAGE_LAUNCHES["B4 want_eb"]
        rows.append(dict(
            name=name, route="cuda", source=f"lambdapic_torch/csrc/{cu}",
            replaces=f"lambdapic_tpu/ops/{rep}", launches=launches,
            max_abs_err=STAGE["err"][tag], ms=t["ms"], timing=t["timing"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None))
    return rows


def run_exact(args, dev):
    """[kernels per-stage] and [slice exact]: B4-B7 against their plain
    versions (float64 small, float32 at the 2D slice's shapes), then the
    2D slice with cell_migration="exact" through Simulation.run."""
    import torch
    t0 = time.time()
    merges = check_stage_f64(dev)
    log(f"[kernels per-stage] f64: B4 (4 modes) bitwise equal; B5 within "
        f"1e-12 of the peak; B6 ({len(STAGE_CASES)} cases x 2, merges up to "
        f"{merges}) and B7 (caps 13, 16, 20) equal array for array; "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    sim, laser = make_slice(dev, cell_migration="exact")
    sim.initialize()
    log(f"[slice exact] initialised in {time.time() - t0:.1f} s: "
        f"{sim.npart_alive} particles, slots "
        f"{[p.cap for p in sim.state.particles]}")
    STAGE["err"] = check_stage_f32(sim)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: exact re-binning + B4 + B5 per species ---------------
    steps = args.steps_exact
    n_timed = min(args.window_exact, steps)
    n_a = min(steps - n_timed, 1000)
    n_b = steps - n_timed - n_a
    ids0 = [ids_of(p) for p in sim.state.particles]
    ov0 = [int(p.overflow) for p in sim.state.particles]
    reset_launches()
    t0 = time.time()
    # one exact step, then the rest of the quiet stretch before the laser
    # front reaches the target: nothing leaves the box, every id is kept
    # but for the merges and drops counted in the overflow
    sim.run(nsteps=1, callbacks=[laser])
    check_ids_kept("slice exact step 1", ids0, ov0, sim)
    sim.run(nsteps=n_a - 1, callbacks=[laser])
    check_ids_kept(f"slice exact step {n_a}", ids0, ov0, sim)
    sim.run(nsteps=n_b, callbacks=[laser])
    torch.cuda.synchronize()
    t1 = time.time()
    sim.run(nsteps=n_timed, callbacks=[laser])
    torch.cuda.synchronize()
    t2 = time.time()
    check_launches("slice exact", sim.itime, {"B1": 4, "B4": 3, "B5": 3})
    check_finite(sim, "exact", rho=True)
    after = totals(sim)
    step_ms = (t2 - t1) * 1e3 / n_timed
    npart = sum(n for n, _, _ in after)
    log(f"[slice exact] {sim.itime} steps: first {n_a + n_b} in "
        f"{t1 - t0:.2f} s, window {n_timed} in {t2 - t1:.3f} s; step "
        f"{step_ms:.3f} ms (host clock, synchronised), "
        f"{npart / (step_ms * 1e-3):.4e} pushes/s; alive, overflow, weight "
        f"{after}; peak |ey| {float(sim.state.fields.ey.abs().max()):.3e}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    busy_per_step(lambda: sim.run(nsteps=1, callbacks=[laser]),
                  {"e_half": 2, "b_half": 2, "push<": 3, "deposit<": 3,
                   "fold_pad": 3}, 5, "profile exact", step_ms)
    time_stage_kernels(sim, args.iters)
    del sim
    torch.cuda.empty_cache()


def exact2d_digest(steps, dev):
    """The 2D slice with cell_migration="exact" for ``steps`` steps from
    its fill, alone: the peak device memory of those steps and a SHA-256
    digest of the final state (every field and particle array, bytes as
    stored), which holds two versions of the exact re-binning to the same
    output when each runs this on one card."""
    import hashlib
    import torch
    sim, laser = make_slice(dev, cell_migration="exact")
    sim.initialize()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    sim.run(nsteps=steps, callbacks=[laser])
    torch.cuda.synchronize()
    t1 = time.time()
    h = hashlib.sha256()
    f = sim.state.fields
    for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho"):
        h.update(getattr(f, k).cpu().numpy().tobytes())
    for p in sim.state.particles:
        for k in sorted(p.data):
            h.update(p.data[k].cpu().numpy().tobytes())
        h.update(p.alive.cpu().numpy().tobytes())
        h.update(p.overflow.cpu().numpy().tobytes())
    log(f"[exact2d digest] {steps} steps in {t1 - t0:.2f} s; state "
        f"{base / 2**30:.3f} GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB; overflow {[int(p.overflow) for p in sim.state.particles]}; "
        f"sha256 {h.hexdigest()}")


def run_exact_qed(args, dev):
    """[slice exact QED]: example/photons.py's configuration with
    cell_migration="exact" through Simulation.run (B4 want_eb for the
    radiating electrons, B4 default for the protons, B5 for both; photons
    re-bin exactly in plain torch and deposit nothing)."""
    import torch
    t0 = time.time()
    sim, laser, npho, pho = make_slice_qed(dev, cell_migration="exact")
    sim.initialize()
    log(f"[slice exact QED] initialised in {time.time() - t0:.1f} s: "
        f"{sim.npart_alive} particles, slots "
        f"{[p.cap for p in sim.state.particles]}")
    steps = args.steps_exact_qed
    n_timed = min(50, steps)
    reset_launches()
    t0 = time.time()
    sim.run(nsteps=steps - n_timed, callbacks=[laser, npho])
    torch.cuda.synchronize()
    t1 = time.time()
    sim.run(nsteps=n_timed, callbacks=[laser, npho])
    torch.cuda.synchronize()
    t2 = time.time()
    check_launches("slice exact QED", sim.itime,
                   {"B1": 4, "B4": 2, "B4 want_eb": 1, "B5": 2})
    check_finite(sim, "exact QED")
    born = int(sim.state.particles[pho.ispec].next_id)
    after = totals(sim)
    step_ms = (t2 - t1) * 1e3 / n_timed
    npart = sum(n for n, _, _ in after)
    log(f"[slice exact QED] {sim.itime} steps in {t2 - t0:.2f} s; photons "
        f"born {born}, alive {sim.npart_alive[pho.ispec]}; window step "
        f"{step_ms:.3f} ms (host clock), {npart / (step_ms * 1e-3):.4e} "
        f"pushes/s; alive, overflow, weight {after}; slots "
        f"{[p.cap for p in sim.state.particles]}")
    if born == 0:
        fail("exact QED: no photon emitted")
    busy_per_step(lambda: sim.run(nsteps=1, callbacks=[laser]),
                  {"e_half": 2, "b_half": 2, "push<": 2, "deposit<": 2,
                   "fold_pad": 2}, 3, "profile exact QED", step_ms)
    del sim
    torch.cuda.empty_cache()


def clone_state(st, device=None):
    """A copy of a SimulationState, on ``device`` (the state's own when
    None)."""
    def cp(t):
        return t.clone() if device is None else t.to(device, copy=True)
    fl = st.fields
    names = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")
    fields = fl.replace(psi={k: cp(v) for k, v in fl.psi.items()},
                        **{k: cp(getattr(fl, k)) for k in names})
    parts = tuple(p.replace(data={k: cp(v) for k, v in p.data.items()},
                            alive=cp(p.alive), next_id=cp(p.next_id),
                            overflow=cp(p.overflow))
                  for p in st.particles)
    return st.replace(fields=fields, particles=parts)


def check_split_fused(tag, split, fused, currents):
    """Hold the state after a split particle stage against the state after
    a fused one: alive masks, ids and merge counts equal, the particles'
    values within rtol 1e-5 (a floor of 1e-6 of the peak), the
    ``currents`` within 1e-5 of their peak. Returns (the largest value
    difference, the largest current difference over its peak)."""
    import torch
    worst = 0.0
    for i, (ps, pf) in enumerate(zip(split.particles, fused.particles)):
        if not (torch.equal(ps.alive, pf.alive) and all(
                torch.equal(ps.data[k][ps.alive], pf.data[k][pf.alive])
                for k in ("id_lo", "id_hi"))):
            fail(f"{tag}: species {i} alive masks or ids differ")
        if int(ps.overflow) != int(pf.overflow):
            fail(f"{tag}: species {i} merge counts differ")
        for k in ("x", "y", "z", "w", "ux", "uy", "uz", "inv_gamma"):
            e, ok = _close(ps.data[k][ps.alive], pf.data[k][pf.alive], 1e-5,
                           1e-6)
            worst = max(worst, e)
            if not ok:
                fail(f"{tag}: species {i} {k} differs by {e:.3e}")
    jerr = 0.0
    for k in currents:
        a, b = getattr(split.fields, k), getattr(fused.fields, k)
        e = float((a - b).abs().max())
        peak = max(float(b.abs().max()), 1e-300)
        jerr = max(jerr, e / peak)
        if not e <= 1e-5 * peak:
            fail(f"{tag}: {k} differs by {e:.3e}")
    return worst, jerr


def sub_segment_ms(sim, callbacks, reps, tag):
    """Wall ms of each sub-segment of a split step, with the card
    synchronised at every boundary (device work included; the host's
    share is the step's idle share), the mean of ``reps`` steps run
    through Simulation.run with ``callbacks``."""
    import torch
    from lambdapic_torch import callback
    marks = []
    stages = ("maxwell_1", "_push_position_1", "_interpolator", "_qed",
              "_push_momentum", "_push_position_2", "current_deposition",
              "end")

    def mark(s):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    probes = [callback(stage=st)(mark) for st in ("start",) + stages]
    sim.run(nsteps=reps, callbacks=list(callbacks) + probes)
    per = np.diff(np.array(marks).reshape(reps, -1), axis=1).mean(0) * 1e3
    names = ("fields 1", "p1", "interp", "qed", "mom", "p2", "deposit",
             "fields 2")
    log(f"[{tag}] sub-segment wall ms (card synchronised at each boundary, "
        f"mean of {reps} steps): " + ", ".join(
            f"{nm} {v:.3f}" for nm, v in zip(names, per)))


def split_steps_sorted(sim, callbacks, n, tag, per_step, into=None):
    """``n`` split steps through Simulation.run with LAMBDAPIC_MIG_FUSED=0
    (the fast re-binning sorting through B7 instead of B6), their
    launches checked against ``per_step`` (see check_launches)."""
    import os
    import torch
    os.environ["LAMBDAPIC_MIG_FUSED"] = "0"
    try:
        reset_launches()
        t0 = time.time()
        sim.run(nsteps=n, callbacks=callbacks)
        torch.cuda.synchronize()
        t1 = time.time()
    finally:
        del os.environ["LAMBDAPIC_MIG_FUSED"]
    check_launches(tag, n, per_step, into=into)
    log(f"[{tag}] {n} split steps with LAMBDAPIC_MIG_FUSED=0: "
        f"{(t1 - t0) * 1e3 / n:.3f} ms a step (host clock, synchronised)")


def split_vs_fused_step(sim, laser, hook, tag):
    """One split step (``hook``, a callback at an inner stage, due) against
    one fused (B2) step of ``sim`` from a cloned state, through
    Simulation.run, re-capacity held off; the simulation goes on from
    the fused step. See check_split_fused."""
    import torch
    recap, sim.recap_interval = sim.recap_interval, 0
    saved, itime, t_sim = clone_state(sim.state), sim.itime, sim.time
    sim.run(nsteps=1, callbacks=[laser, hook])
    split = sim.state
    sim.state, sim.itime, sim.time = saved, itime, t_sim
    sim.run(nsteps=1, callbacks=[laser])
    fused = sim.state
    sim.recap_interval = recap
    torch.cuda.synchronize()
    worst, jerr = check_split_fused(f"{tag}: split vs fused", split, fused,
                                    ("jx", "jy", "jz"))
    log(f"[{tag}] one split step vs one fused (B2) step from step {itime}: "
        f"alive masks, ids and merges equal; particle values within rtol "
        f"1e-5 (largest difference {worst:.3e}); J within {jerr:.2e} of its "
        f"peak")
    del split, saved
    torch.cuda.empty_cache()


def run_split(args, sim, laser):
    """[slice split]: the 2D slice's Simulation continued with a host
    callback at _push_momentum due every step (the split particle path:
    B6 per axis and species, the plain gather and Boris, B5), first one
    split step against one fused (B2) step from a cloned state, then
    --steps-split steps through Simulation.run, then --steps-split-sort
    steps with LAMBDAPIC_MIG_FUSED=0 (B7 instead of B6)."""
    import torch
    from lambdapic_torch import callback
    hook = callback(stage="_push_momentum")(lambda s: None)

    # -- one split step against one fused step from the same state ----------
    split_vs_fused_step(sim, laser, hook, "slice split")

    # -- the split path through Simulation.run --------------------------------
    n = args.steps_split
    reset_launches()
    t0 = time.time()
    sim.run(nsteps=n, callbacks=[laser, hook])
    torch.cuda.synchronize()
    t1 = time.time()
    check_launches("slice split", n, {"B1": 4, "B5": 3, "B6": 6})
    step_ms = (t1 - t0) * 1e3 / n
    npart = sum(sim.npart_alive)
    log(f"[slice split] {n} split steps from step {sim.itime - n}: "
        f"{step_ms:.3f} ms a step (host clock, synchronised), "
        f"{npart / (step_ms * 1e-3):.4e} pushes/s")
    busy_per_step(lambda: sim.run(nsteps=1, callbacks=[laser, hook]),
                  {"e_half": 2, "b_half": 2, "migrate_tile": 6,
                   "deposit<": 3, "fold_pad": 3}, 5, "profile split", step_ms)
    sub_segment_ms(sim, [laser, hook], 5, "slice split")

    # -- the re-binning through B7 ---------------------------------------------
    split_steps_sorted(sim, [laser, hook], args.steps_split_sort,
                       "slice split B7", {"B1": 4, "B5": 3, "B7": 6})
    check_finite(sim, "split")


# ---------------------------------------------------------------------------
# 3D
# ---------------------------------------------------------------------------

# default 3D step count: 201 of the example's 1001 (cut to pay for the
# phases of QED and the per-stage engine on a mesh)
STEPS_3D = 201


def check_b2_f64_3d(dev):
    """Slot-for-slot float64 comparisons of the 3D kernels B2 and B3 at
    small sizes (periodic, open, mixed faces, a case built to merge, a
    grid that no tile divides); returns the merging case's merge count."""
    import torch
    from lambdapic_torch.ops.cellslab import (cell_step, cell_step_plain,
                                              fold_reduce, fold_reduce_plain,
                                              panel_shape)
    from lambdapic_torch.testing import compare_slots, random_cell_state, \
        to_numpy, to_torch
    q, m, dt = -1.602e-19, 9.109e-31, 1.1e-16
    dx, dy, dz = 5e-8, 6e-8, 5.5e-8
    merges = 0
    cases = [(4, 16, 8, 8, (True, True, True), 0.4),
             (6, 12, 10, 20, (False, False, False), 0.4),
             (4, 10, 18, 9, (True, False, True), 0.9),
             (20, 9, 8, 11, (False, True, False), 0.5),
             (8, 8, 16, 8, (True, True, True), 0.85)]
    for cap, nx, ny, nz, per, frac in cases:
        data, alive, eb = random_cell_state(cap, nx, ny, nz, n_frac=frac,
                                            seed=cap + nx)
        td, ta = to_torch(data, alive, torch.float64, dev)
        eb_t = torch.as_tensor(eb).to(dev)
        kw = dict(q=q, m=m, dt=dt, dx=dx, dy=dy, dz=dz, g=3, periodic=per)
        rin = torch.as_tensor(np.random.default_rng(1).normal(
            size=panel_shape(4, nx, ny, nz))).to(dev)
        ref = cell_step_plain(eb_t, td, ta, rims_in=rin, **kw)
        got = cell_step(eb_t, td, ta, rims_in=rin, **kw)
        torch.cuda.synchronize()
        compare_slots(*to_numpy(ref[0], ref[1]), *to_numpy(got[0], got[1]),
                      rtol=1e-11)
        if int(got[2]) != int(ref[2]):
            fail(f"B2 3D merge count {int(got[2])} != plain {int(ref[2])}")
        merges = max(merges, int(ref[2]))
        scale = float(ref[3].abs().max())
        err = float((got[3] - ref[3]).abs().max())
        if not err <= 1e-12 * scale:
            fail(f"B2 3D panels differ: {err:.3e} > 1e-12 x {scale:.3e}")
        jr = fold_reduce_plain(ref[3], (nx, ny, nz), per)
        jk = fold_reduce(ref[3], (nx, ny, nz), per)
        err = float((jk - jr).abs().max())
        if not err <= 1e-12 * float(jr.abs().max()):
            fail(f"B3 3D differs from its plain version: {err:.3e}")
    if merges == 0:
        fail("no 3D B2 float64 case merged particles")
    return merges


def make_slice_3d(dev, seed=0):
    """example/laser-target-3d.py at full size (512 x 256 x 256), without
    its diagnostics. The density is the example's step profile written
    with np.where, so the 33.5 M cells are evaluated in one numpy call
    instead of one Python call each."""
    from lambdapic_torch import Electron, GaussianLaser3D, Proton, Simulation3D
    from lambdapic_torch.constants import c, e, epsilon_0, m_e, pi
    um = 1e-6
    l0 = 0.8 * um
    omega0 = 2 * pi * c / l0
    nc = epsilon_0 * m_e * omega0**2 / e**2
    nx, ny, nz = 512, 256, 256
    dx, dy, dz = l0 / 20, l0 / 10, l0 / 10
    Lx = nx * dx

    def density(n0):
        def _density(x, y, z):
            return np.where(x > 1 * um, n0, 0.0)
        return _density

    laser = GaussianLaser3D(a0=10, w0=2e-6, l0=0.8e-6, ctau=5e-6,
                            focus_position=Lx / 2, x0=10e-6)
    sim = Simulation3D(tiling="cell", nx=nx, ny=ny, nz=nz, dx=dx, dy=dy,
                       dz=dz, random_seed=seed, device=dev)
    ele = Electron(density=density(1 * nc), ppc=2)
    proton = Proton(density=density(1 * nc), ppc=2)
    sim.add_species([ele, proton])
    return sim, laser


def gather_nodes_3d(alive, g):
    """Nodes of the padded 3D E/B stack that B2's staggered gather reads
    from the cells holding a particle, summed over the six components."""
    import torch
    occ = alive.any(0)
    nx, ny, nz = occ.shape
    total = 0
    # (half along x, y, z) of ex ey ez bx by bz
    for hx, hy, hz in ((1, 0, 0), (0, 1, 0), (0, 0, 1),
                       (0, 1, 1), (1, 0, 1), (1, 1, 0)):
        need = torch.zeros((nx + 2 * g, ny + 2 * g, nz + 2 * g),
                           dtype=torch.bool, device=occ.device)
        for ox in range(-2 if hx else -1, 2):
            for oy in range(-2 if hy else -1, 2):
                for oz in range(-2 if hz else -1, 2):
                    need[g + ox:g + ox + nx, g + oy:g + oy + ny,
                         g + oz:g + oz + nz] |= occ
        total += int(need.sum())
    return total


def sub_volume(p, grid, sub):
    """The last ``sub`` x-planes of a species' slots as a state of their
    own (x re-based), with the grid that goes with it."""
    import dataclasses
    from types import SimpleNamespace
    from lambdapic_torch.ops.cellslab import FLOAT_PAYLOADS, ID_PAYLOADS
    x0 = grid.nx - sub
    data = {k: p.data[k][:, x0:].contiguous()
            for k in FLOAT_PAYLOADS + ("inv_gamma",) + ID_PAYLOADS}
    data["x"] = data["x"] - float(x0)
    return (SimpleNamespace(data=data, alive=p.alive[:, x0:].contiguous()),
            dataclasses.replace(grid, nx=sub))


# The plain version of 3D kernel B2 holds temporaries many times the state
# (125 deposit offsets, the gather's taps), so at the slice's 512 x 256 x
# 256 cells it does not fit the card. It is held against the kernel on the
# last COMPARE_PLANES_3D x-planes of the initial state (4 slots a cell) and
# timed on the last PLAIN_PLANES_3D x-planes of the final state (8 slots a
# cell, beside the slice's own 40 GiB). Both are fixed: running out of
# memory fails the run.
COMPARE_PLANES_3D = 256
PLAIN_PLANES_3D = 128


def compare_b2_f32_3d(sim, dev):
    """Kernel B2 (3D) against its plain version in float32 on the last
    COMPARE_PLANES_3D x-planes of the slice's electrons. Returns (kernel
    panels, max panel error, the sub-grid)."""
    import torch
    g = sim.grid.n_guard
    p, sgrid = sub_volume(sim.state.particles[0], sim.grid,
                          COMPARE_PLANES_3D)
    rng = np.random.default_rng(3)
    # fields strong enough to move electrons across cells in one step
    eb_pad = torch.as_tensor(
        rng.uniform(-5e13, 5e13, (6,) + tuple(n + 2 * g for n in sgrid.shape)
                    ).astype(np.float32)).to(dev)
    got, ref, err = compare_b2_f32(eb_pad, p, sim._species_static[0], sim.dt,
                                   sgrid, sgrid.periodic_axes)
    log(f"[B2 f32 3D] compared on {sgrid.shape} cells, {p.alive.numel()} "
        "slots")
    return got[3], err, sgrid


def run_3d(args, dev):
    """Phase 5: the 3D kernels against their plain versions, the 3D slice
    through Simulation3D.run, and the 3D kernels' times and bounds;
    returns the 3D kernels' entries of the ``kernels`` line, the slice's
    Simulation3D and laser, and a host copy of its fill."""
    import torch
    from lambdapic_torch.ops import cellslab, fieldskernel, maxwell
    from lambdapic_torch.ops.cellslab import (cell_step, cell_step_plain,
                                              fold_reduce, fold_reduce_plain,
                                              panel_shape)
    from lambdapic_torch.ops.cpml import CPMLParams, build_cpml
    from lambdapic_torch.core.grid import Grid

    # -- float64, small -----------------------------------------------------
    faces = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")
    for name, bc in (("pml", ("pml",) * 6), ("periodic", ("periodic",) * 6),
                     ("mixed", ("pml", "pml", "periodic", "periodic", "pml",
                                "pml"))):
        grid = Grid(dimension=3, nx=20, ny=18, nz=22, dx=1e-6, dy=0.8e-6,
                    dz=1.2e-6, npatch_x=1, npatch_y=1, npatch_z=1, n_guard=3,
                    cpml_thickness=6,
                    boundary_conditions=tuple(zip(faces, bc)))
        dt = 0.95 / np.sqrt(sum(d**-2 for d in grid.deltas)) / 3e8
        cpml = build_cpml(grid, dt, CPMLParams()) if name != "periodic" \
            else None
        err = check_b1(grid, cpml, torch.float64, dev, tol=1e-12)
        log(f"[B1 3D f64 {name}] max abs {err[0]:.3e}, {err[1]:.3e} of peak")
    merges = check_b2_f64_3d(dev)
    log(f"[B2/B3 3D f64] slot-exact in 5 cases, merges in the merging case: "
        f"{merges}")

    # -- the slice state ------------------------------------------------------
    t0 = time.time()
    sim, laser = make_slice_3d(dev)
    sim.initialize()
    torch.cuda.synchronize()
    log(f"[slice 3D] initialised in {time.time() - t0:.1f} s (host numpy "
        f"fill and binning, then copied to the card): {sim.npart_alive} "
        f"particles, slots {[p.cap for p in sim.state.particles]}, "
        f"dt {sim.dt:.4e} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    grid, cpml = sim.grid, sim.cpml
    periodic = grid.periodic_axes
    g = grid.n_guard
    shape_s = "x".join(str(n) for n in grid.shape)

    # -- float32 at the slice's shapes -----------------------------------------
    errs = {}
    err = check_b1(grid, cpml, torch.float32, dev, tol=1e-5, seed=1)
    errs["B1"] = err[0]
    log(f"[B1 3D f32 {shape_s}] max abs {err[0]:.3e}, {err[1]:.3e} of peak")
    torch.cuda.empty_cache()
    rims, errs["B2"], sgrid = compare_b2_f32_3d(sim, dev)
    jr = fold_reduce_plain(rims, sgrid.shape, sgrid.periodic_axes)
    jk = fold_reduce(rims, sgrid.shape, sgrid.periodic_axes)
    errs["B3"] = float((jk - jr).abs().max())
    if not errs["B3"] <= 1e-5 * float(jr.abs().max()):
        fail(f"B3 3D float32 differs: {errs['B3']:.3e}")
    log(f"[B3 3D f32 {'x'.join(str(n) for n in sgrid.shape)}] max abs "
        f"{errs['B3']:.3e} of peak {float(jr.abs().max()):.3e}")
    del rims, jr, jk
    torch.cuda.empty_cache()
    # the fill, kept on the host for the exact 3D slice (run_exact_3d),
    # with the laser as it starts (a laser switches itself off for good
    # once its time is up)
    t0 = time.time()
    fill = dict(state=clone_state(sim.state, "cpu"),
                static=list(sim._species_static), laser=copy.deepcopy(laser))
    log(f"[slice 3D] fill copied to the host in {time.time() - t0:.1f} s")

    # -- the main path ---------------------------------------------------------
    # The plasma fills the box from x = 1 um to its open faces and starts
    # at rest. In the first steps nothing can reach a face (the laser
    # enters 17 cells before the plasma edge, 25 cells from xmin): particle
    # number (alive + merged) and weight are checked there. The last
    # --window3d steps are timed.
    before = totals(sim)
    on_edge = edge_sitters(sim)
    log(f"[slice 3D] particles stored on an open face's edge: {on_edge}")
    reset_launches()
    steps_all = args.steps3d
    n_timed = min(args.window3d, steps_all)
    n_a = min(steps_all - n_timed, 20)
    n_b = steps_all - n_timed - n_a
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sim.run(nsteps=n_a, callbacks=[laser])
    torch.cuda.synchronize()
    mid = totals(sim)
    if n_b:
        sim.run(nsteps=n_b, callbacks=[laser])
    torch.cuda.synchronize()
    t1 = time.time()
    sim.run(nsteps=n_timed, callbacks=[laser])
    torch.cuda.synchronize()
    t2 = time.time()
    launches = {"B1": fieldskernel.update_half_k.launches,
                "B2": cellslab.cell_step.launches,
                "B3": cellslab.fold_reduce.launches}
    after = totals(sim)
    steps = sim.itime
    log(f"[slice 3D] {steps} steps of the example's 1001: first {n_a + n_b} "
        f"in {t1 - t0:.2f} s, window {n_timed} in {t2 - t1:.3f} s; launches "
        f"{launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = {"B1": 4 * steps, "B2": 2 * steps, "B3": steps}
    if launches != want:
        fail(f"3D launch counts {launches} != {want}")
    check_finite(sim, "3D")
    for (n0, m0, w0), (n1, m1, w1), (n2, m2, w2), edge, sp in zip(
            before, mid, after, on_edge, sim.species):
        log(f"[slice 3D] {sp.name}: alive {n0} -> {n1} (step {n_a}) -> {n2}, "
            f"merges {m1 - m0} -> {m2 - m0}, weight {w0:.7e} -> {w1:.7e} "
            f"-> {w2:.7e}, slots per cell {sim.state.particles[sp.ispec].cap}")
        if n1 + (m1 - m0) != n0 - edge:
            fail(f"3D {sp.name}: particles not conserved to step {n_a} ({n0} "
                 f"- {edge} on an edge -> {n1} + {m1 - m0} merges)")
        if not abs(w1 - w0) <= 1e-5 * w0:
            fail(f"3D {sp.name}: weight not conserved to step {n_a} ({w0} -> "
                 f"{w1})")
        if n2 + (m2 - m0) > n0 or not w2 <= w0 * (1 + 1e-5):
            fail(f"3D {sp.name}: particles or weight grew ({n0} -> {n2}, "
                 f"{w0} -> {w2})")
    ey_peak = float(sim.state.fields.ey.abs().max())
    jx_peak = float(sim.state.fields.jx.abs().max())
    if not (ey_peak > 0 and jx_peak > 0):
        fail(f"3D: the laser did not reach the plasma (peak |ey| {ey_peak}, "
             f"peak |jx| {jx_peak})")
    step_ms = (t2 - t1) * 1e3 / n_timed
    npart = sum(n for n, _, _ in after)
    log(f"[slice 3D] step {step_ms:.3f} ms (host clock, synchronised), "
        f"{npart / (step_ms * 1e-3):.4e} pushes/s, peak |ey| {ey_peak:.3e}, "
        f"peak |jx| {jx_peak:.3e}")
    busy_per_step(lambda: sim.run(nsteps=1, callbacks=[laser]),
                  {"e_half3": 2, "b_half3": 2, "rebin3": 6, "tail3<": 2,
                   "fold3_pencil": 1}, 3, "profile 3D", step_ms)

    # -- kernel times at the slice's shapes -------------------------------------
    f = sim.state.fields
    coeffs = sim._builder._coeffs
    dt = sim.dt
    iters = args.iters3d
    e_k = lambda: fieldskernel.update_efield_k(f, grid, dt / 2, cpml,
                                               coeffs["e"])
    b_k = lambda: fieldskernel.update_bfield_k(f, grid, dt / 2, cpml,
                                               coeffs["b"])
    dev_e, wall_e = kernel_ms(e_k, iters, "B1-3D E")
    tm_e = kernel_ms.method
    dev_b, wall_b = kernel_ms(b_k, iters, "B1-3D B")
    tm_b1 = timing(tm_e, kernel_ms.method)
    ms_b1 = (dev_e + dev_b) / 2 if dev_e and dev_b else (wall_e + wall_b) / 2
    log(f"[time B1 3D] device {ms_b1:.4f} ms per launch, wall "
        f"{(wall_e + wall_b) / 2:.4f} ms per call")
    plain_b1 = (cuda_time(lambda: maxwell.update_efield(f, grid, dt / 2, cpml), 1)
                + cuda_time(lambda: maxwell.update_bfield(f, grid, dt / 2, cpml),
                            1)) / 2
    torch.cuda.empty_cache()
    isz = f.ex.element_size()
    cell = int(np.prod(grid.shape)) * isz

    def psi_bytes(prefix):
        return sum(v.numel() * isz for k, v in f.psi.items()
                   if k.startswith(prefix))
    # E half: 9 fields read, 3 written, its six psi slabs read and written;
    # B half: 6 read, 3 written, its own six; the mean of the two
    bound_b1 = ((12 * cell + 2 * psi_bytes("psi_e"))
                + (9 * cell + 2 * psi_bytes("psi_b"))) / 2 / HBM_BPS * 1e3

    p = sim.state.particles[0]
    sp = sim._species_static[0]
    eb_pad = sim._builder.pad_eb(f)
    kw = dict(q=sp.q, m=sp.m, dt=dt, dx=grid.dx, dy=grid.dy, dz=grid.dz, g=g,
              periodic=periodic, with_rho=sim._builder.with_rho)
    dev_b2, wall_b2 = kernel_ms(
        lambda: cell_step(eb_pad, p.data, p.alive, **kw), iters, "B2-3D",
        split=True)
    ms_b2, tm_b2 = dev_b2 or wall_b2, kernel_ms.method
    log(f"[time B2 3D] device {ms_b2:.4f} ms per launch, wall {wall_b2:.4f} "
        "ms per call")
    ncomp = 4 if sim._builder.with_rho else 3
    pan_b = int(np.prod(panel_shape(ncomp, *grid.shape))) * isz
    out = cell_step(eb_pad, p.data, p.alive, **kw)
    rims = out[3]
    slots = p.alive.numel()
    n_alive = int(p.alive.sum())
    # counted as the 2D bound: the alive mask, the alive slots' payloads,
    # the E/B nodes gathered from occupied cells; every slot and the panels
    # written once
    slot_b = 1 + 8 * isz + 2 * 4
    bytes_b2 = (slots + n_alive * (slot_b - 1) + slots * slot_b
                + gather_nodes_3d(out[1], g) * isz + pan_b)
    ops_ms_b2 = n_alive * FLOPS_PER_PARTICLE_3D / F32_FLOPS * 1e3
    bound_b2 = max(bytes_b2 / HBM_BPS * 1e3, ops_ms_b2)
    by_b2 = "bytes" if bound_b2 > ops_ms_b2 else "operations"
    log(f"[bound B2 3D] {n_alive} of {slots} slots alive: {bytes_b2} bytes, "
        f"{bytes_b2 / HBM_BPS * 1e3:.4f} ms; operations {ops_ms_b2:.4f} ms")
    del out
    torch.cuda.empty_cache()
    # the plain version is timed on the timed state's last PLAIN_PLANES_3D
    # x-planes, and the kernel on the same planes beside it
    psub, pgrid = sub_volume(p, grid, PLAIN_PLANES_3D)
    eb_sub = eb_pad[:, grid.nx - pgrid.nx:].contiguous()
    kw_sub = dict(kw, periodic=pgrid.periodic_axes)
    plain_b2 = cuda_time(lambda: cell_step_plain(eb_sub, psub.data,
                                                 psub.alive, **kw_sub), 1)
    torch.cuda.empty_cache()
    sub_b2 = cuda_time(lambda: cell_step(eb_sub, psub.data, psub.alive,
                                         **kw_sub), iters)
    plain_cells = list(pgrid.shape)
    log(f"[time B2 3D] on {'x'.join(str(n) for n in plain_cells)} cells "
        f"with {p.cap} slots each: plain version {plain_b2:.1f} ms, kernel "
        f"{sub_b2:.3f} ms (wall, CUDA events)")
    del psub, eb_sub
    torch.cuda.empty_cache()
    dev_b3, wall_b3 = kernel_ms(
        lambda: fold_reduce(rims, grid.shape, periodic), iters, "B3-3D")
    ms_b3, tm_b3 = dev_b3 or wall_b3, kernel_ms.method
    log(f"[time B3 3D] device {ms_b3:.4f} ms per launch, wall {wall_b3:.4f} "
        "ms per call")
    plain_b3 = cuda_time(lambda: fold_reduce_plain(rims, grid.shape,
                                                   periodic), 1)
    # B3's plain version does fit at the slice's full shape: hold the
    # kernel against it there too, on the timed species' panels
    jr = fold_reduce_plain(rims, grid.shape, periodic)
    err_b3 = float((fold_reduce(rims, grid.shape, periodic) - jr).abs().max())
    if not err_b3 <= 1e-5 * float(jr.abs().max()):
        fail(f"B3 3D float32 differs at {shape_s}: {err_b3:.3e}")
    log(f"[B3 3D f32 {shape_s}] max abs {err_b3:.3e} of peak "
        f"{float(jr.abs().max()):.3e}")
    errs["B3"] = max(errs["B3"], err_b3)
    del jr
    bound_b3 = (pan_b + ncomp * cell) / HBM_BPS * 1e3
    per_step = {k: v // steps for k, v in launches.items()}
    kernels = [
        dict(name="B1 fields half-step, 3D", route="cuda",
             source="lambdapic_torch/csrc/fields3d.cu",
             replaces="lambdapic_tpu/ops/fieldspallas.py:207",
             launches=launches["B1"], max_abs_err=errs["B1"], ms=ms_b1,
             timing=tm_b1, plain_ms=plain_b1, bound_ms=bound_b1,
             bound_by="bytes", library_ms=None),
        dict(name="B2 cell particle stage, 3D", route="cuda",
             source="lambdapic_torch/csrc/cellstep3d.cu",
             replaces="lambdapic_tpu/ops/cellslab.py:546",
             launches=launches["B2"], max_abs_err=errs["B2"], ms=ms_b2,
             timing=tm_b2, plain_ms=plain_b2, plain_cells=plain_cells,
             ms_at_plain_cells=sub_b2, bound_ms=bound_b2, bound_by=by_b2,
             library_ms=None),
        dict(name="B3 rim fold, 3D", route="cuda",
             source="lambdapic_torch/csrc/fold3d.cu",
             replaces="lambdapic_tpu/ops/cellslab.py:2098",
             launches=launches["B3"], max_abs_err=errs["B3"], ms=ms_b3,
             timing=tm_b3, plain_ms=plain_b3, bound_ms=bound_b3,
             bound_by="bytes", library_ms=None),
    ]
    log(f"[kernels 3D] launches per step {per_step}")
    return kernels, sim, laser, fill

# ---------------------------------------------------------------------------
# the per-stage engine in 3D: kernels B4-B7 on 3D slots, the 3D slice with
# exact migration and the 3D slice's split step
# ---------------------------------------------------------------------------

# B4's and B5's floating-point work per alive particle in 3D, counted from
# csrc/push3d.cu and csrc/cell3d.cuh as for B2 in 3D: B4 21 spline weights
# and six staggered gathers of 36-48 taps (about 900), Boris (about 60) and
# the half push (about 9); B5 30 Esirkepov shapes with their derived taps
# and 125 nodes of four channels (about 2300)
FLOPS_B4_3D = 970
FLOPS_B5_3D = 2300
# launches of the per-stage kernels on the 3D per-stage paths (exact 3D,
# split 3D, split 3D with LAMBDAPIC_MIG_FUSED=0), summed for the kernels
# line; their float32 errors and times, filled by the phases
STAGE3_LAUNCHES = {"B4 3D": 0, "B4 3D want_eb": 0, "B5 3D": 0, "B6": 0,
                   "B7": 0}
STAGE3 = {}
KERNEL_FUNCS.update({"B4 3D": {"push3d": 1},
                     "B5 3D": {"deposit3d": 1, "fold_pad3": 1},
                     "B6 3D": {"migrate_tile": 3}, "K7": {"migrate_tile": 1}})
# the float64 cases of tests/test_torch_kernels3d.py
STAGE3_CASES = [(4, 12, 7, 9, (True, True, True), 0.9),
                (13, 9, 6, 5, (False, True, False), 0.5),
                (16, 9, 5, 6, (True, False, True), 0.9),
                (20, 6, 5, 7, (False, False, False), 1.0),
                (8, 1, 5, 37, (True, False, True), 0.9),
                (9, 19, 2, 40, (False, True, True), 0.9),
                (17, 10, 3, 1, (True, True, False), 0.9),
                (32, 5, 9, 12, (False, False, True), 1.0),
                (33, 4, 3, 5, (True, False, False), 1.0)]
# B5's plain version holds some 90 arrays of the slots' size (the taps of
# the 125 offsets), so at the 3D slice's size it is held against the
# kernel, and timed, on the last STAGE3_PLANES x-planes; the split step is
# held against the fused step on as many planes (a clone of the state at 8
# slots a cell does not fit beside it)
STAGE3_PLANES = 128


def check_stage3_f64(dev):
    """B4 in 3D (both modes, with and without the first half push, given
    the alive mask) bitwise, B5 in 3D (given the mask) within 1e-12 of
    the peak, B6 on 3D slots (caps 4,
    13, 16, 20, periodic and open faces, merges, a photon species' carried
    inv_gamma) and B7 on 3D slots (caps 4-20; float, int32 and bool
    payloads) array for array, all against their plain versions in
    float64 at small sizes. Returns the largest B6 merge count."""
    import torch
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell3d import deposit_cell_3d
    from lambdapic_torch.testing import random_cell_state, to_torch
    q, m, dt = -1.602e-19, 9.109e-31, 1.1e-16
    dx, dy, dz = 5e-8, 6e-8, 5.5e-8
    data, alive, eb = random_cell_state(5, 13, 10, 9, seed=7, field=5e13)
    td, ta = to_torch(data, alive, torch.float64, dev)
    eb = torch.as_tensor(eb).to(dev)
    args = [td[k] for k in ("x", "y", "z", "ux", "uy", "uz")]
    for want_eb in (False, True):
        for do_pos1 in (False, True):
            kw = dict(q=q, m=m, dt=dt, dx=dx, dy=dy, dz=dz, g=3,
                      want_eb=want_eb, do_pos1=do_pos1, alive=ta)
            ref = cp.fused_push_cell_3d_plain(eb, *args, **kw)
            got = cp.fused_push_cell_3d(eb, *args, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                fail(f"B4 3D f64 (want_eb {want_eb}, do_pos1 {do_pos1}) "
                     "differs from its plain version")
    for cap, nx, ny, nz, g in ((4, 16, 8, 8, 3), (6, 10, 18, 9, 2),
                               (20, 9, 8, 11, 4)):
        data, alive, _ = random_cell_state(cap, nx, ny, nz, seed=cap,
                                           spread=0.99)
        td, ta = to_torch(data, alive, torch.float64, dev)
        w = torch.where(ta, td["w"], 0.0)
        a8 = [td[k] for k in ("x", "y", "z", "ux", "uy", "uz",
                              "inv_gamma")] + [w]
        kw = dict(q=q, dx=dx, dy=dy, dz=dz, dt=dt, g=g)
        ref = deposit_cell_3d(*a8, **kw)
        got = cp.deposit_cell_3d_k(*a8, alive=ta, **kw)
        err = float((got - ref).abs().max())
        if not err <= 1e-12 * float(ref.abs().max()):
            fail(f"B5 3D f64 differs from its plain version by {err:.3e}")
    merges = max(check_b6_f64(dev, cap, (nx, ny, nz), per, frac)
                 for cap, nx, ny, nz, per, frac in STAGE3_CASES)
    if merges == 0:
        fail("no B6 3D float64 case merged particles")
    for cap in (4, 7, 13, 16, 20):
        check_b7(dev, cap, (cap, 9, 7, 5))
    return merges


def stage3_inputs(sim, p):
    """The per-stage kernels' inputs from one species ``p`` of a 3D
    slice: its slots with the first half push applied (B6's and B7's
    input), and those re-binned by the plain version (B4's and B5's
    input). Returns (pushed data, alive, re-binned data, alive)."""
    from lambdapic_torch.constants import c
    from lambdapic_torch.ops.cell2d import migrate_cells
    from lambdapic_torch.ops.pusher import push_position_3d
    grid = sim.grid
    d = dict(p.data)
    h = [c * sim.dt / dd / 2 for dd in grid.deltas]
    d["x"], d["y"], d["z"] = push_position_3d(
        d["x"], d["y"], d["z"], d["ux"], d["uy"], d["uz"], d["inv_gamma"],
        *h)
    plan = tuple(zip(grid.shape, grid.periodic_axes, "xyz"))
    rd, ra, _ = migrate_cells(d, p.alive, plan)
    return d, p.alive, rd, ra


def last_planes(ts, x0, xs=()):
    """The x-planes from x0 on of the slot arrays ``ts`` (contiguous),
    positions in ``xs`` (indices into ``ts``) re-based to the cut."""
    out = [t[:, x0:].contiguous() for t in ts]
    for i in xs:
        out[i] = out[i] - float(x0)
    return out


def check_stage3_f32(sim):
    """B4-B7 against their plain versions at the 3D slice's shapes
    (512 x 256 x 256, float32), on its electrons given momenta by one B2
    step in strong random fields: B6 (a step that re-bins) and B7 equal
    array for array (alive masks, ids and payloads), B4 with the alive
    mask bitwise on the alive slots and the dead values in the dead ones,
    B5 with the mask on the last STAGE3_PLANES x-planes to 1e-5 of the
    current's peak.
    Returns the largest absolute errors."""
    import torch
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import TRANSIENT, batcher_sort, \
        migrate_cells
    from lambdapic_torch.ops.cell3d import deposit_cell_3d
    from lambdapic_torch.ops.cellslab import cell_step
    grid = sim.grid
    g = grid.n_guard
    per = grid.periodic_axes
    sp = sim._species_static[0]
    dev = sim.device
    gen = torch.Generator(device=dev).manual_seed(2)
    eb_pad = (torch.rand((6,) + tuple(n + 2 * g for n in grid.shape),
                         generator=gen, device=dev) - 0.5) * 1e14
    p0 = sim.state.particles[0]
    data, alive = cell_step(eb_pad, p0.data, p0.alive, q=sp.q, m=sp.m,
                            dt=sim.dt, dx=grid.dx, dy=grid.dy, dz=grid.dz,
                            g=g, periodic=per, with_rho=False)[:2]
    d, a, _, _ = stage3_inputs(sim, p0.replace(data=data, alive=alive))
    del data, alive
    plan = tuple(zip(grid.shape, per, "xyz"))
    ref = migrate_cells(d, a, plan)
    got = cp.migrate_cells_fused(d, a, plan)
    torch.cuda.synchronize()
    moved = int((got[1] != a).sum())
    same = torch.equal(got[1], ref[1]) and all(
        torch.equal(got[0][k], ref[0][k]) for k in ref[0])
    log(f"[B6 f32 3D] {moved} slots changed occupancy, merges "
        f"{int(got[2])} (plain {int(ref[2])}); every array equal: {same}")
    if moved == 0 or not same or int(got[2]) != int(ref[2]):
        fail("B6 3D float32 differs from its plain version (or moved "
             "nothing)")
    del got
    names = sorted(k for k in d if k not in TRANSIENT)
    key = five_way_key(d["x"], a, 0)
    rk, rp = batcher_sort(key, [d[k] for k in names])
    gk, gp = cp.sort_cells(key, [d[k] for k in names])
    if not (torch.equal(gk, rk) and all(torch.equal(x, y)
                                        for x, y in zip(gp, rp))):
        fail("B7 float32 on 3D slots differs from its plain version")
    log(f"[B7 f32 3D] {len(names)} payloads sorted by the x key: equal")
    del gp, rp, gk, rk, key, d
    rd, ra = ref[0], ref[1]
    args = [rd[k] for k in ("x", "y", "z", "ux", "uy", "uz")]
    err4 = {}
    for want_eb in (True, False):
        # the per-stage step's call: the alive mask, the dead slots given
        # the dead values (0, inv_gamma 1)
        kw = dict(q=sp.q, m=sp.m, dt=sim.dt, dx=grid.dx, dy=grid.dy,
                  dz=grid.dz, g=g, want_eb=want_eb, do_pos1=False, alive=ra)
        r4 = cp.fused_push_cell_3d_plain(eb_pad, *args, **kw)
        g4 = cp.fused_push_cell_3d(eb_pad, *args, **kw)
        tag = "B4 3D want_eb" if want_eb else "B4 3D"
        err4[tag] = max(float((x - y).abs().max()) for x, y in zip(g4, r4))
        bitwise = all(torch.equal(x[ra], y[ra]) for x, y in zip(g4, r4))
        dead = all(bool((x[~ra] == (1.0 if i == 6 else 0.0)).all())
                   for i, x in enumerate(g4))
        log(f"[{tag} f32] max abs {err4[tag]:.3e}; alive slots bitwise "
            f"equal: {bitwise}; dead slots hold the dead values: {dead}")
        if not (bitwise and dead):
            fail(f"{tag} float32 differs from its plain version")
        del g4
        if want_eb:
            del r4
    del args
    x0 = grid.nx - STAGE3_PLANES
    w = torch.where(ra, rd["w"], 0.0)
    a8 = last_planes(list(r4) + [w, ra], x0, xs=(0,))
    a8, mask = a8[:-1], a8[-1]
    del r4, w, ref, rd
    kw = dict(q=sp.q, dx=grid.dx, dy=grid.dy, dz=grid.dz, dt=sim.dt, g=g)
    r5 = deposit_cell_3d(*a8, **kw)
    g5 = cp.deposit_cell_3d_k(*a8, alive=mask, **kw)
    err5 = float((g5 - r5).abs().max())
    scale = float(r5.abs().max())
    log(f"[B5 3D f32 last {STAGE3_PLANES} x-planes] max abs {err5:.3e} of "
        f"peak {scale:.3e}")
    if not (scale > 0 and err5 <= 1e-5 * scale):
        fail(f"B5 3D float32 differs: {err5:.3e} > 1e-5 x {scale:.3e}")
    return {**err4, "B5 3D": err5, "B6": 0.0, "B7": 0.0}


def time_stage3_kernels(sim, iters):
    """Device ms per launch of B4 in 3D (both modes), B5 in 3D, B6 (per
    axis) and B7 on the electrons of the 3D slice's present state, their plain
    versions' ms (one call, CUDA events; B5's on the last STAGE3_PLANES
    x-planes, beside the kernel's time there) and their bounds; stored in
    STAGE3."""
    import torch
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import TRANSIENT, batcher_sort, \
        migrate_cells
    from lambdapic_torch.ops.cell3d import deposit_cell_3d
    grid = sim.grid
    g = grid.n_guard
    sp = sim._species_static[0]
    d, a, rd, ra = stage3_inputs(sim, sim.state.particles[0])
    eb_pad = sim._builder.pad_eb(sim.state.fields)
    plan = tuple(zip(grid.shape, grid.periodic_axes, "xyz"))
    args = [rd[k] for k in ("x", "y", "z", "ux", "uy", "uz")]
    w = torch.where(ra, rd["w"], 0.0)
    a8 = [rd[k] for k in ("x", "y", "z", "ux", "uy", "uz", "inv_gamma")] \
        + [w]
    k5 = dict(q=sp.q, dx=grid.dx, dy=grid.dy, dz=grid.dz, dt=sim.dt, g=g)
    names = sorted(k for k in d if k not in TRANSIENT)
    key = five_way_key(d["x"], a, 0)
    pays = [d[k] for k in names]
    # B4 and B5 as the per-stage step calls them: with the alive mask
    k4 = dict(q=sp.q, m=sp.m, dt=sim.dt, dx=grid.dx, dy=grid.dy, dz=grid.dz,
              g=g, want_eb=False, do_pos1=False, alive=ra)
    k4e = dict(k4, want_eb=True)
    calls = {
        "B4 3D": ("B4 3D", lambda: cp.fused_push_cell_3d(eb_pad, *args, **k4),
                  lambda: cp.fused_push_cell_3d_plain(eb_pad, *args, **k4),
                  1),
        "B4 3D want_eb": (
            "B4 3D", lambda: cp.fused_push_cell_3d(eb_pad, *args, **k4e),
            lambda: cp.fused_push_cell_3d_plain(eb_pad, *args, **k4e), 1),
        "B5 3D": ("B5 3D", lambda: cp.deposit_cell_3d_k(*a8, alive=ra, **k5),
                  None, 1),
        "B6": ("B6 3D", lambda: cp.migrate_cells_fused(d, a, plan),
               lambda: migrate_cells(d, a, plan), 3),
        "B7": ("B7", lambda: cp.sort_cells(key, pays),
               lambda: batcher_sort(key, pays), 1)}
    bounds = stage_bounds(d, a, rd, ra, g)
    n_alive = int(ra.sum())
    for tag, (funcs, fn, plain_fn, per_call) in calls.items():
        dev_ms, wall = kernel_ms(fn, iters, funcs, split=tag == "B5 3D")
        ms = (dev_ms or wall) / per_call
        extra = {"timing": kernel_ms.method}
        if tag in ("B4 3D", "B4 3D want_eb"):
            # one __global__ function: its time is the call's
            kernel_ms.split = f" = push3d {ms:.4f} ({kernel_ms.method})"
        if tag in ("B4 3D", "B4 3D want_eb", "B5 3D"):
            # the per-__global__ split of B4 3D and B5 3D
            extra["split"] = kernel_ms.split.lstrip(" =")
        if plain_fn is None:
            # B5: plain and kernel on the last STAGE3_PLANES x-planes
            sub = last_planes(a8 + [ra], grid.nx - STAGE3_PLANES, xs=(0,))
            sub, sub_alive = sub[:-1], sub[-1]
            torch.cuda.empty_cache()
            plain = cuda_time(lambda: deposit_cell_3d(*sub, **k5), 1)
            sub_ms = cuda_time(lambda: cp.deposit_cell_3d_k(
                *sub, alive=sub_alive, **k5), iters)
            extra.update(plain_cells=[STAGE3_PLANES] + list(grid.shape[1:]),
                         ms_at_plain_cells=sub_ms)
            del sub, sub_alive
        else:
            plain = cuda_time(plain_fn, 1) / per_call
        torch.cuda.empty_cache()
        bound, by, nbytes, flops = bounds[tag.replace(" 3D", "")]
        STAGE3.setdefault("time", {})[tag] = dict(
            ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, **extra)
        at_plain = (f" on {extra['plain_cells']} cells (kernel there "
                    f"{extra['ms_at_plain_cells']:.4f} ms)"
                    if "plain_cells" in extra else "")
        log(f"[time {tag}] device {ms:.4f} ms per launch{kernel_ms.split} "
            f"(wall {wall / per_call:.4f}); plain {plain:.3f} ms{at_plain}; "
            f"bound {bound:.5f} ms ({by}: {nbytes} bytes, {flops} flops; "
            f"{n_alive} of {ra.numel()} slots alive, {ra.shape[0]} a cell); "
            f"{ms / bound:.1f}x the bound")


def stage3_rows():
    """The kernels line's rows of B4-B7 in 3D."""
    src = {"B4 3D": ("B4 gather+Boris+push 3D", "push3d.cu",
                     "cellpallas.py:523"),
           "B4 3D want_eb": ("B4 want_eb 3D", "push3d.cu",
                             "cellpallas.py:523"),
           "B5 3D": ("B5 deposit 3D", "deposit3d.cu", "cellpallas.py:635"),
           "B6": ("B6 re-binning axis 3D", "migrate.cu", "cellpallas.py:860"),
           "B7": ("B7 slot sort 3D", "sortcells.cu", "cellpallas.py:769")}
    rows = []
    for tag, (name, cu, rep) in src.items():
        t = dict(STAGE3["time"][tag])
        if tag == "B6":
            # the split 3D slice's electrons, whose launches the step runs
            t.update(STAGE3.get("b6 split", {}))
        launches = STAGE3_LAUNCHES[tag]
        if tag == "B4 3D":
            launches -= STAGE3_LAUNCHES["B4 3D want_eb"]
        rows.append(dict(
            name=name, route="cuda", source=f"lambdapic_torch/csrc/{cu}",
            replaces=f"lambdapic_tpu/ops/{rep}", launches=launches,
            max_abs_err=STAGE3["err"][tag], library_ms=None, **t))
    return rows


def compare_split_fused_3d(sim):
    """One split particle stage (the sub-stages one by one: B6, the plain
    gather and Boris, B5) against one fused one (B2, B3) of the 3D slice's
    present state, cut to its last STAGE3_PLANES x-planes (the fields
    too; the cut's faces are open, as the slice's), through a StepBuilder
    of the cut grid: alive masks, ids and merge counts equal, values
    within rtol 1e-5, J within 1e-5 of its peak."""
    import dataclasses
    import torch
    from lambdapic_torch.core.state import SimulationState
    from lambdapic_torch.simulation.callbacks import INNER_SUBSTAGES
    from lambdapic_torch.simulation.step import StepBuilder
    grid = sim.grid
    x0 = grid.nx - STAGE3_PLANES
    sgrid = dataclasses.replace(grid, nx=STAGE3_PLANES)
    f = sim.state.fields
    names = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")
    fields = f.replace(psi={}, **{k: getattr(f, k)[x0:].contiguous()
                                  for k in names})
    parts = []
    for p in sim.state.particles:
        keys = sorted(p.data)
        cut = last_planes([p.data[k] for k in keys], x0,
                          xs=(keys.index("x"),))
        parts.append(p.replace(data=dict(zip(keys, cut)),
                               alive=p.alive[:, x0:].contiguous()))
    state = SimulationState(fields=fields, particles=tuple(parts))
    b = StepBuilder(sgrid, None, sim.dt, sim._species_static,
                    with_rho=True, dtype=sim.dtype, device=sim.device)
    sc = {"itime": sim.itime}
    fused = b.seg_particles(state, sc)
    split = state
    for sub, _ in INNER_SUBSTAGES:
        split = b.seg_particles_sub(split, sc, frozenset((sub,)))
    torch.cuda.synchronize()
    moved = sum(int((ps.alive != p.alive).sum())
                for p, ps in zip(state.particles, split.particles))
    worst, jerr = check_split_fused("split vs fused 3D", split, fused,
                                    ("jx", "jy", "jz", "rho"))
    log(f"[slice split 3D] one split particle stage vs one fused (B2, B3) "
        f"from step {sim.itime} on the last {STAGE3_PLANES} x-planes "
        f"({'x'.join(str(n) for n in sgrid.shape)} cells, slots "
        f"{[p.cap for p in state.particles]}): {moved} slots changed "
        f"occupancy; alive masks, ids and merges equal; values within rtol "
        f"1e-5 (largest difference {worst:.3e}); J and rho within "
        f"{jerr:.2e} of their peak")


def time_b6_split_3d(sim, callbacks):
    """B6 on the electrons of the split 3D slice as its split steps see
    them (their slots a cell as the slice has grown them): device ms a launch by
    CUDA events over one call of the three axes, and the bound of the same
    state (the mask and every carried payload of every slot read and
    written once an axis); then B6's synchronised share of one split step
    through Simulation.run, each B6 call between two synchronisations.
    Stored in STAGE3["b6 split"], the B6 3D row's split3d_* keys."""
    import torch
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import TRANSIENT
    grid = sim.grid
    p = sim.state.particles[0]
    plan = tuple(zip(grid.shape, grid.periodic_axes, "xyz"))
    ms = cuda_time(lambda: cp.migrate_cells_fused(p.data, p.alive, plan),
                   3) / 3
    pay = sum(v.element_size() for k, v in p.data.items()
              if k not in TRANSIENT)
    nbytes = 2 * p.alive.numel() * (1 + pay)
    bound = nbytes / HBM_BPS * 1e3
    torch.cuda.empty_cache()
    spent = []
    fused = cp.migrate_cells_fused

    def synchronised(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fused(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out
    cp.migrate_cells_fused = synchronised
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(nsteps=1, callbacks=callbacks)
        torch.cuda.synchronize()
        step = time.perf_counter() - t0
    finally:
        cp.migrate_cells_fused = fused
    STAGE3["b6 split"] = dict(split3d_ms=ms, split3d_bound_ms=bound,
                              split3d_slots=p.cap,
                              split3d_step_share=sum(spent) / step)
    log(f"[time B6 3D split] the split 3D slice's electrons at step "
        f"{sim.itime - 1} ({p.cap} slots a cell, {int(p.alive.sum())} of "
        f"{p.alive.numel()} alive): {ms:.4f} ms a launch (CUDA events, "
        f"three axes a call); bound {bound:.5f} ms ({nbytes} bytes a "
        f"launch); {ms / bound:.2f}x the bound")
    log(f"[slice split 3D] B6 synchronised: {sum(spent) * 1e3:.3f} ms in "
        f"{len(spent)} calls of a {step * 1e3:.3f} ms step "
        f"({100 * sum(spent) / step:.1f}%; the step with each B6 call "
        "between two synchronisations)")


def run_split_3d(args, sim, laser):
    """[slice split 3D]: the 3D slice's Simulation3D continued with a host
    callback at _push_momentum due every step (the split particle path:
    B6 per axis and species, the plain gather and Boris, B5 in 3D): one
    split particle stage against one fused one on a cut volume, then
    --steps-split3d steps through Simulation3D.run, then
    --steps-split-sort3d steps with LAMBDAPIC_MIG_FUSED=0 (B7 instead of
    B6)."""
    import torch
    from lambdapic_torch import callback
    hook = callback(stage="_push_momentum")(lambda s: None)
    compare_split_fused_3d(sim)
    torch.cuda.empty_cache()

    # -- the split path through Simulation3D.run -------------------------------
    n = args.steps_split3d
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    sim.run(nsteps=n, callbacks=[laser, hook])
    torch.cuda.synchronize()
    t1 = time.time()
    check_launches("slice split 3D", n, {"B1": 4, "B5 3D": 2, "B6": 6},
                   into=STAGE3_LAUNCHES)
    step_ms = (t1 - t0) * 1e3 / n
    npart = sum(sim.npart_alive)
    log(f"[slice split 3D] {n} split steps from step {sim.itime - n}: "
        f"{step_ms:.3f} ms a step (host clock, synchronised), "
        f"{npart / (step_ms * 1e-3):.4e} pushes/s; slots "
        f"{[p.cap for p in sim.state.particles]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    busy_per_step(lambda: sim.run(nsteps=1, callbacks=[laser, hook]),
                  {"e_half3": 2, "b_half3": 2, "migrate_tile": 6,
                   "deposit3d": 2, "fold_pad3": 2}, 2, "profile split 3D",
                  step_ms)
    sub_segment_ms(sim, [laser, hook], 2, "slice split 3D")
    time_b6_split_3d(sim, [laser, hook])

    # -- the re-binning through B7 ---------------------------------------------
    split_steps_sorted(sim, [laser, hook], args.steps_split_sort3d,
                       "slice split 3D B7", {"B1": 4, "B5 3D": 2, "B7": 6},
                       into=STAGE3_LAUNCHES)
    check_finite(sim, "split 3D")


def run_exact_3d(args, dev, sim, fill):
    """[kernels per-stage 3D] and [slice exact 3D]: B4-B7 on 3D slots
    against their plain versions (float64 small, float32 at the 3D
    slice's shapes), then the 3D slice with cell_migration="exact"
    through Simulation3D.run from its fill (``fill``: the host copy of the
    state Simulation3D.initialize() made, the species' slots and the
    laser as it started, kept from the fast 3D slice so as not to fill
    the box twice), and B4-B7 timed at its final state."""
    import torch
    laser = fill["laser"]
    t0 = time.time()
    merges = check_stage3_f64(dev)
    log(f"[kernels per-stage 3D] f64: B4 (4 modes) bitwise equal; B5 within "
        f"1e-12 of the peak; B6 ({len(STAGE3_CASES)} cases x 2, merges up to "
        f"{merges}) and B7 (caps 4-20) equal array for array; "
        f"{time.time() - t0:.1f} s")
    sim.state = clone_state(fill["state"], dev)
    sim._species_static = list(fill["static"])
    sim.itime, sim.time = 0, 0.0
    sim.cell_migration = "exact"
    sim._builder = None
    for seen in (sim._overflow_seen, sim._occ_seen, sim._loss_reported):
        seen.clear()
    torch.cuda.synchronize()
    log(f"[slice exact 3D] state of the fill restored: {sim.npart_alive} "
        f"particles, slots {[p.cap for p in sim.state.particles]}")
    STAGE3["err"] = check_stage3_f32(sim)
    torch.cuda.empty_cache()

    # -- the main path: exact re-binning + B4 + B5 per species ---------------
    torch.cuda.reset_peak_memory_stats()
    steps = args.steps_exact3d
    n_timed = min(args.window_exact3d, steps)
    gone = edge_sitters(sim)
    ids0 = [ids_of(p) for p in sim.state.particles]
    ov0 = [int(p.overflow) for p in sim.state.particles]
    reset_launches()
    t0 = time.time()
    sim.run(nsteps=steps - n_timed, callbacks=[laser])
    torch.cuda.synchronize()
    t1 = time.time()
    sim.run(nsteps=n_timed, callbacks=[laser])
    torch.cuda.synchronize()
    t2 = time.time()
    check_launches("slice exact 3D", sim.itime,
                   {"B1": 4, "B4 3D": 2, "B5 3D": 2}, into=STAGE3_LAUNCHES)
    # the fill sits at rest and the laser does not reach it in these steps:
    # only the particles stored on an open face's edge leave
    check_ids_kept("slice exact 3D", ids0, ov0, sim, gone)
    check_finite(sim, "exact 3D", rho=True)
    ey_peak = float(sim.state.fields.ey.abs().max())
    if not ey_peak > 0:
        fail("exact 3D: the laser injected no field")
    after = totals(sim)
    step_ms = (t2 - t1) * 1e3 / n_timed
    npart = sum(n for n, _, _ in after)
    log(f"[slice exact 3D] {sim.itime} steps: first {steps - n_timed} in "
        f"{t1 - t0:.2f} s, window {n_timed} in {t2 - t1:.3f} s; step "
        f"{step_ms:.3f} ms (host clock, synchronised), "
        f"{npart / (step_ms * 1e-3):.4e} pushes/s; n_lost (merged or "
        f"dropped) {[int(p.overflow) - o for p, o in zip(sim.state.particles, ov0)]}; "
        f"alive, overflow, weight {after}; slots "
        f"{[p.cap for p in sim.state.particles]}; peak |ey| {ey_peak:.3e}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    busy_per_step(lambda: sim.run(nsteps=1, callbacks=[laser]),
                  {"e_half3": 2, "b_half3": 2, "push3d": 2, "deposit3d": 2,
                   "fold_pad3": 2}, 3, "profile exact 3D", step_ms)
    time_stage3_kernels(sim, args.iters3d)


# ---------------------------------------------------------------------------
# per-cell capacities above 128: the sorting kernels' scratch variant
# ---------------------------------------------------------------------------

BIGCAP_CAPS = (130, 256)
# 2D and 3D cells of the case with more cells than the scratch has rows
# (33,792 on 132 SMs)
BIGCAP_CELLS = ((200, 180), (36, 32, 32))


def check_b2_bigcap(dev, cap, cells, per, frac, modes):
    """Kernel B2 (2D or 3D by ``cells``) against its plain version in
    float64 at ``cap`` slots a cell, with QED payloads, in each of
    ``modes`` ("default", "want_chi"), array for array in place: alive
    masks equal, on alive slots ids equal and every other payload (chi
    and ig0 too) to rtol 1e-11 with a floor of 1e-14 of its peak, merges
    equal and not 0, panels to 1e-12 of their peak. Returns the merge
    count."""
    import torch
    from lambdapic_torch.ops.cellslab import cell_step, cell_step_plain
    from lambdapic_torch.testing import (add_qed_payloads, random_cell_state,
                                         to_torch)
    data, alive, eb = random_cell_state(cap, *cells, n_frac=frac,
                                        seed=cap + cells[0], umax=50.0,
                                        field=5e13)
    if int(alive.sum(0).max()) <= 128:
        fail(f"bigcap B2 case {cap} {cells}: no cell holds more than 128")
    td, ta = to_torch(add_qed_payloads(data, seed=cap), alive, torch.float64,
                      dev)
    eb = torch.as_tensor(eb).to(dev)
    d3 = dict(dz=5.5e-8) if len(cells) == 3 else {}
    merges = 0
    for mode in modes:
        kw = dict(q=-1.602e-19, m=9.109e-31, dt=1.1e-16, dx=5e-8, dy=6e-8,
                  g=3, periodic=per, want_chi=mode == "want_chi", **d3)
        ref = cell_step_plain(eb, td, ta, **kw)
        got = cell_step(eb, td, ta, **kw)
        torch.cuda.synchronize()
        if mode == "want_chi":
            for out in (ref, got):
                out[0]["chi"], out[0]["ig0"] = out[4]
        a = ref[1]
        if not torch.equal(got[1], a) or sorted(got[0]) != sorted(ref[0]):
            fail(f"bigcap B2 {mode} {cells} cap {cap}: alive masks differ")
        for k, v in ref[0].items():
            if v.dtype == torch.int32:
                ok = torch.equal(got[0][k][a], v[a])
            else:
                ok = _close(got[0][k][a], v[a], 1e-11, 1e-14)[1]
            if not ok:
                fail(f"bigcap B2 {mode} {cells} cap {cap}: {k} differs")
        if int(got[2]) != int(ref[2]) or int(ref[2]) == 0:
            fail(f"bigcap B2 {mode} {cells} cap {cap}: merges "
                 f"{int(got[2])} vs plain {int(ref[2])}")
        err = float((got[3] - ref[3]).abs().max())
        if not err <= 1e-12 * float(ref[3].abs().max()):
            fail(f"bigcap B2 {mode} {cells} cap {cap}: panels differ {err:.3e}")
        merges = int(ref[2])
    return merges


def run_bigcap(dev):
    """[kernels bigcap]: every sorting kernel above 128 slots a cell, in
    float64 against its plain version: B2 2D (default and want_chi), B2
    3D (default and want_chi), B6 on 2D and 3D slots (a crowded state
    with QED payloads, also as a photon species) and B7 on 2D and 3D
    slots, at caps 130 and 256; then one case of each with more cells
    than the scratch has rows, so that the grid-stride loop over the cells
    takes several turns."""
    from lambdapic_torch.ops.cellslab import key_scratch
    t0 = time.time()
    for cap in BIGCAP_CAPS:
        frac = 1.0 if cap < 200 else 0.9
        m2 = check_b2_bigcap(dev, cap, (12, 10), (True, False), frac,
                             ("default", "want_chi"))
        m3 = check_b2_bigcap(dev, cap, (5, 4, 6), (False, True, False), frac,
                             ("default", "want_chi"))
        m6 = max(check_b6_f64(dev, cap, (9, 7), (False, True), frac),
                 check_b6_f64(dev, cap, (4, 5, 3), (True, False, True), frac))
        check_b7(dev, cap, (cap, 17, 9))
        check_b7(dev, cap, (cap, 5, 4, 3))
        log(f"[kernels bigcap] cap {cap}: B2 2D and 3D (default, want_chi) "
            f"slot for slot, merges {m2} and {m3}; B6 2D and 3D (merges up to "
            f"{m6}) and B7 2D and 3D array for array")
    cap = BIGCAP_CAPS[0]
    big2, big3 = BIGCAP_CELLS
    rows = key_scratch(cap, int(np.prod(big2)), dev, "sortcells")[1]
    if rows >= int(np.prod(big2)) or rows >= int(np.prod(big3)):
        fail(f"bigcap: the scratch has {rows} rows, not fewer than the cells")
    m2 = check_b2_bigcap(dev, cap, big2, (True, False), 1.0, ("default",))
    m3 = check_b2_bigcap(dev, cap, big3, (False, True, True), 1.0,
                         ("default",))
    m6 = check_b6_f64(dev, cap, big2, (False, True), 1.0)
    check_b7(dev, cap, (cap,) + big2)
    log(f"[kernels bigcap] cap {cap} on {big2} and {big3} cells, more than "
        f"the scratch's {rows} rows: B2 2D and 3D slot for slot (merges {m2}, "
        f"{m3}), B6 2D (merges {m6}) and B7 array for array; "
        f"{time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# QED in 3D: the 3D QED configuration of this script
# ---------------------------------------------------------------------------

# cells of the 3D QED configuration: example/laser-target-3d.py's
# resolution (dx = l0/20, dy = dz = l0/10) in a 10.24 um cube
QED3_SHAPE = (256, 128, 128)
# x-planes on which B2 3D's QED modes are held against (and timed beside)
# their plain versions at the slice's end state
QED3_PLANES = 128
KERNEL_FUNCS.update({"B2-3D photon": {"rebin3": 3, "photon3<": 1}})
# the photon mode of cellstep3d.cu: two half pushes along three axes and
# the keys (about 18) and 1/|u| (about 7)
FLOPS_PHOTON_3D = 25
# the float64 cases of tests/test_torch_kernels3d.py's QED tests
QED3_CASES = [(8, 8, 8, 8, (True, True, True), 0.4),
              (12, 9, 6, 10, (False, False, False), 0.5),
              (8, 8, 8, 8, (True, False, True), 0.9),
              (20, 6, 5, 7, (False, True, False), 0.5)]


def compare_b2_want_chi_f32_3d(sim, proc):
    """compare_b2_f32 in B2 3D's want_chi mode at the 3D QED slice's
    shapes, on its radiating electrons, in strong random fields (|E| up
    to 5e13 V/m, |B| up to 5e13 V/m / c, so chi stays finite in float32).
    Returns the largest chi difference on alive slots."""
    import torch
    from lambdapic_torch.constants import c
    grid = sim.grid
    g = grid.n_guard
    gen = torch.Generator(device=sim.device).manual_seed(4)
    eb_pad = (torch.rand((6,) + tuple(n + 2 * g for n in grid.shape),
                         generator=gen, device=sim.device) - 0.5) * 1e14
    eb_pad[3:] /= c
    got, ref, _ = compare_b2_f32(eb_pad, sim.state.particles[proc.ispec],
                                 sim._species_static[proc.ispec], sim.dt,
                                 grid, grid.periodic_axes, want_chi=True)
    a = got[1]
    return float((got[4][0][a] - ref[4][0][a]).abs().max())


def make_slice_qed_3d(dev, seed=0, cell_migration="fast"):
    """The 3D QED configuration of this script. No script in example/ is
    3D QED: this is example/photons.py carried into 3D at
    example/laser-target-3d.py's resolution, 256 x 128 x 128 cells (dx =
    l0/20, dy = dz = l0/10, l0 = 0.8 um: a 10.24 um cube), photons.py's
    SimpleLaser (a0 = 300, w0 = 2 um, ctau = 5 um) as SimpleLaser3D,
    radiating electrons and protons at 5 nc for x > 2 um with 2 particles
    per cell each, a photon species of capacity 2^20, PML on all faces,
    float32, photons.py's 100 fs, its npho callback kept. Returns (sim,
    laser, npho callback, photon species)."""
    import torch
    from lambdapic_torch import (Electron, Photon, Proton, SimpleLaser3D,
                                 Simulation3D, callback)
    from lambdapic_torch.constants import c, e, epsilon_0, m_e, pi
    um = 1e-6
    l0 = 0.8 * um
    omega0 = 2 * pi * c / l0
    nc = epsilon_0 * m_e * omega0**2 / e**2
    nx, ny, nz = QED3_SHAPE

    def density(n0):
        def _density(x, y, z):
            return np.where(x > 2 * um, n0, 0.0)
        return _density

    laser = SimpleLaser3D(a0=300, w0=2e-6, l0=0.8e-6, ctau=5e-6)
    sim = Simulation3D(tiling="cell", nx=nx, ny=ny, nz=nz, dx=l0 / 20,
                       dy=l0 / 10, dz=l0 / 10, sim_time=QED_SIM_TIME,
                       random_seed=seed, device=dev,
                       cell_migration=cell_migration)
    ele = Electron(density=density(5 * nc), ppc=2, radiation="photons")
    pho = Photon(capacity=1 << 20)
    ele.set_photon(pho)
    proton = Proton(density=density(5 * nc), ppc=2)
    sim.add_species([ele, proton, pho])

    @callback(interval=10e-15)
    def npho(sim):
        log(f"[slice QED 3D] step {sim.itime}: nphoton = "
            f"{sim.npart_alive[pho.ispec]}, slots "
            f"{[p.cap for p in sim.state.particles]}, device memory "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return sim, laser, npho, pho


def photon_planes(sim, proc, n):
    """(x0, n): the n x-planes of the 3D QED slice that hold the most
    alive photons."""
    import torch
    per = sim.state.particles[proc.photon_ispec].alive.sum(
        dim=(0, 2, 3)).to(torch.int64)
    win = torch.cumsum(per, 0)
    win = torch.cat([win[n - 1:n], win[n:] - win[:-n]])
    return int(torch.argmax(win)), n


def time_b2_qed_modes(sim, proc, iters, launches, errs, planes=None):
    """Device ms per launch of B2's want_chi (electrons) and photon
    (photons) modes at a 2D or 3D QED slice's present state, their plain
    versions' ms (one call, CUDA events; with ``planes`` = (x0, n)
    want_chi's on those x-planes only, where the kernel is timed too: in
    3D its plain version's temporaries at the whole state do not fit
    beside it) and
    their bounds; the kernels line's rows (launches from ``launches``,
    the float32 errors from ``errs``, both by mode)."""
    import dataclasses
    import torch
    from lambdapic_torch.ops import cellslab
    from lambdapic_torch.ops.cellslab import (cell_step, cell_step_plain,
                                              panel_shape)
    grid = sim.grid
    nd = grid.dimension
    g = grid.n_guard
    isz = sim.state.fields.ex.element_size()
    eb_pad = sim._builder.pad_eb(sim.state.fields)
    rows = []
    for ispec, mode in ((proc.ispec, "want_chi"), (proc.photon_ispec,
                                                   "photon")):
        p, st = sim.state.particles[ispec], sim._species_static[ispec]
        kw = dict(q=st.q, m=st.m, dt=sim.dt, dx=grid.dx, dy=grid.dy,
                  dz=grid.dz if nd == 3 else None, g=g,
                  periodic=grid.periodic_axes, with_rho=sim._builder.with_rho,
                  **{mode: True})
        ebp = None if mode == "photon" else eb_pad
        funcs = ("B2" if nd == 2 else "B2-3D") + \
            (" photon" if mode == "photon" else "")
        dev_ms, wall = kernel_ms(lambda: cell_step(ebp, p.data, p.alive,
                                                   **kw), iters, funcs)
        split, tm = kernel_ms.split, kernel_ms.method
        ms = dev_ms or wall
        if mode == "want_chi":
            # the default mode on the same slots, for the ratio of the two
            kwd = dict(kw, want_chi=False)
            dev_d, wall_d = kernel_ms(lambda: cell_step(ebp, p.data, p.alive,
                                                        **kwd), iters, funcs)
            log(f"[time B2 {nd}D] the default mode on the same slots: "
                f"{dev_d or wall_d:.4f} ms per launch; want_chi takes "
                f"{ms / (dev_d or wall_d):.3f}x its time")
        at = {}
        if planes is None or mode == "photon":
            plain = cuda_time(lambda: cell_step_plain(ebp, p.data, p.alive,
                                                      **kw), 1)
        else:
            x0, n = planes
            ps = x_planes(p, x0, n)
            kws = dict(kw, periodic=dataclasses.replace(
                grid, nx=n).periodic_axes)
            ebs = None if ebp is None else \
                ebp[:, x0:x0 + n + 2 * g].contiguous()
            torch.cuda.empty_cache()
            plain = cuda_time(lambda: cell_step_plain(ebs, ps.data, ps.alive,
                                                      **kws), 1)
            torch.cuda.empty_cache()
            at = dict(plain_cells=[n] + list(grid.shape[1:]),
                      ms_at_plain_cells=cuda_time(lambda: cell_step(
                          ebs, ps.data, ps.alive, **kws), iters))
            del ps, ebs
        out = cell_step(ebp, p.data, p.alive, **kw)
        slots, n_alive = p.alive.numel(), int(p.alive.sum())
        nx_ = len(cellslab.extra_payloads(p.data))
        # read: the mask, the alive slots' payloads (x y z w ux uy uz
        # inv_gamma, the extra QED payloads, two int32 ids); written:
        # every slot once (mask, the same reals, ids); want_chi also reads
        # the E/B nodes gathered from occupied cells and writes chi, ig0
        # and the panels
        slot_b = 1 + (8 + nx_) * isz + 2 * 4
        nbytes = slots + n_alive * (slot_b - 1) + slots * slot_b
        if mode == "want_chi":
            ncomp = 4 if sim._builder.with_rho else 3
            nodes = (gather_nodes if nd == 2 else gather_nodes_3d)(out[1], g)
            nbytes += (nodes * isz + 2 * slots * isz
                       + int(np.prod(panel_shape(ncomp, *grid.shape))) * isz)
            flops = (FLOPS_PER_PARTICLE if nd == 2
                     else FLOPS_PER_PARTICLE_3D) + FLOPS_CHI
        else:
            flops = FLOPS_PHOTON if nd == 2 else FLOPS_PHOTON_3D
        del out
        ops_ms = n_alive * flops / F32_FLOPS * 1e3
        bound = max(nbytes / HBM_BPS * 1e3, ops_ms)
        by = "bytes" if bound > ops_ms else "operations"
        where = "" if not at else (
            f" on {'x'.join(str(k) for k in at['plain_cells'])} cells "
            f"(x-planes from {planes[0]}; the kernel there "
            f"{at['ms_at_plain_cells']:.3f} ms)")
        log(f"[time B2 {mode} {nd}D] device {ms:.4f} ms per launch{split}, "
            f"wall {wall:.4f} ms; plain {plain:.3f} ms{where}; bound {bound:.4f} "
            f"ms ({by}: {n_alive} of {slots} slots alive, {p.cap} a cell, "
            f"{nbytes} bytes, operations {ops_ms:.4f} ms); "
            f"{ms / bound:.1f}x the bound")
        rows.append(dict(
            name=f"B2 {mode} {nd}D", route="cuda",
            source="lambdapic_torch/csrc/"
                   + ("cellstep.cu" if nd == 2 else "cellstep3d.cu"),
            replaces="lambdapic_tpu/ops/cellslab.py:546",
            launches=launches[mode], max_abs_err=errs[mode], ms=ms,
            timing=tm, plain_ms=plain, bound_ms=bound, bound_by=by,
            library_ms=None, **at))
    return rows


def time_delta_sampler(e, proc):
    """[QED sampler 3D]: the photon energy sampler on the radiating
    species' events of a step (``e`` after qed_events), with uniform
    draws of its own: the port's (the event slots packed into one row)
    against the JAX package's packing, each cell's events in the cell's
    first K = max(2, cap // 4) rows (written out here; where a cell
    holds more than K events the JAX package evaluates every slot
    instead, which does not fit the card at 3D size). Both agree to 1e-5
    of a value where no cell holds more than K; device ms of each (CUDA
    events)."""
    import torch
    from lambdapic_torch.models.qed import _sample_delta, \
        _sample_delta_sparse
    tb = proc.tables
    chi = e.data["chi"]
    event = e.alive & (e.data["event"] > 0)
    gen = torch.Generator(device=chi.device).manual_seed(5)
    r01 = torch.rand(chi.shape, generator=gen, device=chi.device,
                     dtype=chi.dtype)
    cap = chi.shape[0]
    K = min(cap, max(2, cap // 4))

    def k_rows():
        ev = event.to(torch.int64)
        rank = torch.cumsum(ev, dim=0) - ev
        # events past a cell's first K go to the spare row K with the
        # other slots (the two are compared only where no cell has more)
        row = torch.where(event & (rank < K), rank, K)
        top = (K + 1,) + tuple(chi.shape[1:])
        chi_k = torch.zeros(top, dtype=chi.dtype, device=chi.device
                            ).scatter_(0, row, chi)[:K]
        r_k = torch.zeros(top, dtype=r01.dtype, device=r01.device
                          ).scatter_(0, row, r01)[:K]
        d_k = _sample_delta(chi_k, r_k, tb)
        return torch.where(event, d_k.gather(0, torch.clamp(rank, max=K - 1)),
                           0.0)
    most = int(event.sum(0).max())
    got = _sample_delta_sparse(chi, r01, event, tb)
    ref = k_rows()
    # the Chebyshev sum is a matrix product, whose rounding may follow
    # the number of columns: equal to 1e-5 (float32) of each value
    diff = float(((got - ref).abs() / ref.abs().clamp(min=1e-30))
                 [event].max()) if int(event.sum()) else 0.0
    if most <= K and not diff <= 1e-5:
        fail(f"QED sampler: the packed row and the K-row packing differ by "
             f"{diff:.3e} of a value")
    del got, ref
    one_row = cuda_time(lambda: _sample_delta_sparse(chi, r01, event, tb), 3)
    rows_k = cuda_time(k_rows, 3)
    log(f"[QED sampler 3D] {int(event.sum())} events in {event.numel()} "
        f"slots ({cap} a cell), at most {most} in a cell, K = {K}: the event "
        f"slots packed into one row {one_row:.3f} ms, K rows a cell "
        f"{rows_k:.3f} ms (CUDA events, 3 calls); largest difference "
        f"{diff:.3e} of a value"
        + ("" if most <= K else " (a cell holds more than K: the JAX "
           "package would evaluate every slot)"))


def run_qed_3d(args, dev):
    """[kernels QED 3D] and [slice QED 3D]: B2 3D's want_chi and photon
    modes against their plain versions, the draws, and the 3D QED
    configuration through Simulation3D.run to its end with its checks,
    the QED work's time and the modes' times; returns (the kernels line's
    rows, the Simulation3D and its laser)."""
    import torch
    from lambdapic_torch.models.qed import species_key
    t0 = time.time()
    merges, bitwise = check_b2_qed_f64(dev, QED3_CASES)
    log(f"[kernels QED 3D] f64: want_chi and photon slot for slot in "
        f"{len(QED3_CASES)} cases each (chi, ig0, tau, delta, event "
        f"included), merges in the merging case {merges}; every array "
        f"bitwise equal: {bitwise}; {time.time() - t0:.1f} s")

    # -- the slice state ------------------------------------------------------
    t0 = time.time()
    sim, laser, npho, pho = make_slice_qed_3d(dev)
    sim.initialize()
    torch.cuda.synchronize()
    proc = sim._qed_processes[0]
    steps_all = args.steps_qed3d or int(QED_SIM_TIME / sim.dt)
    log(f"[slice QED 3D] initialised in {time.time() - t0:.1f} s: "
        f"{sim.npart_alive} particles, slots "
        f"{[p.cap for p in sim.state.particles]}, dt {sim.dt:.4e} s, "
        f"{int(QED_SIM_TIME / sim.dt)} steps in example/photons.py's "
        f"{QED_SIM_TIME:.0e} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    log("[slice QED 3D] this script's 3D QED configuration (no script in "
        "example/ is 3D QED): example/photons.py in 3D at "
        "example/laser-target-3d.py's resolution, 256 x 128 x 128 cells, "
        "ppc 2; cut: the diagnostics; random_seed fixed at 0")
    check_draws(sim, proc, dev)
    errs = {"want_chi": compare_b2_want_chi_f32_3d(sim, proc)}
    torch.cuda.empty_cache()

    # -- the main path ---------------------------------------------------------
    # As the 2D QED slice, but species by species: the laser's wings reach
    # the plasma at the y and z faces of this box when its centre reaches
    # it, so the electrons and protons are checked at the last 4-step chunk
    # end (at most step 200) with every one of their moving particles more
    # cells from an open face than a particle can cross in a chunk (4 c dt
    # along the finest axis, plus a cell), and the photons at the last such
    # chunk end for the photons, born at the laser's axis. The last
    # --window-qed3d steps are timed.
    from lambdapic_torch.constants import c
    ie, ip = proc.ispec, proc.photon_ispec
    margin_cells = CHUNK_QED * max(c * sim.dt / d for d in sim.grid.deltas) \
        + 1.0
    nspec = len(sim.species)
    before = totals(sim)
    on_edge = edge_sitters(sim)
    born0 = int(sim.state.particles[ip].next_id)
    log(f"[slice QED 3D] particles stored on an open face's edge: {on_edge}")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    n_timed = min(args.window_qed3d, steps_all)
    n_a = min(steps_all - n_timed, 200)
    n_b = steps_all - n_timed - n_a
    t0 = time.time()
    checks, clear = [None] * nspec, [True] * nspec
    while sim.itime < n_a:
        sim.run(nsteps=min(CHUNK_QED, n_a - sim.itime),
                callbacks=[laser, npho])
        for i in range(nspec):
            if clear[i]:
                clear[i] = face_margin(sim, species=i) >= margin_cells
                if clear[i]:
                    checks[i] = (sim.itime, totals(sim)[i],
                                 int(sim.state.particles[ip].next_id) - born0)
    torch.cuda.synchronize()
    if n_b:
        sim.run(nsteps=n_b, callbacks=[laser, npho])
    torch.cuda.synchronize()
    t1 = time.time()
    sim.run(nsteps=n_timed, callbacks=[laser, npho])
    torch.cuda.synchronize()
    t2 = time.time()
    steps = sim.itime
    peak = torch.cuda.max_memory_allocated() / 2**30
    from lambdapic_torch.ops import cellslab
    by_mode = dict(cellslab.cell_step.launches_by_mode)
    check_launches("slice QED 3D", steps, {"B1": 4, "B2": 3, "B3": 1},
                   by_mode={"default": 1, "want_chi": 1, "photon": 1})
    after = totals(sim)
    born = int(sim.state.particles[ip].next_id) - born0
    log(f"[slice QED 3D] {steps} steps: first {n_a + n_b} in {t1 - t0:.2f} s, "
        f"window {n_timed} in {t2 - t1:.3f} s; photons born {born}, alive "
        f"{sim.npart_alive[ip]}; slots reached "
        f"{[p.cap for p in sim.state.particles]}; peak device memory "
        f"{peak:.2f} GiB")
    check_finite(sim, "QED 3D")
    if born == 0:
        fail("QED 3D: no photon emitted")
    if None in checks or checks[ip][2] == 0:
        fail(f"QED 3D: a species had no chunk end with its moving particles "
             f"{margin_cells:.2f}+ cells from the open faces, or the photons "
             f"none with photons born ({checks})")
    for (n0, m0, w0), (n_chk, (n1, m1, w1), born_mid), (n2, m2, w2), edge, \
            sp in zip(before, checks, after, on_edge, sim.species):
        log(f"[slice QED 3D] {sp.name}: alive {n0} -> {n1} (step {n_chk}, "
            f"the last chunk end with its moving particles "
            f"{margin_cells:.2f}+ cells from the open faces; {born_mid} "
            f"photons born by then) -> {n2}, merged or dropped {m1 - m0} -> "
            f"{m2 - m0}, weight {w0:.7e} -> {w1:.7e} -> {w2:.7e}, slots per "
            f"cell {sim.state.particles[sp.ispec].cap}")
        if sp.ispec == ip:
            if n1 + (m1 - m0) != born_mid + n0:
                fail(f"QED 3D photons: {n1} alive + {m1 - m0} merged or "
                     f"dropped != {born_mid} born by step {n_chk}")
            continue
        if n1 + (m1 - m0) != n0 - edge:
            fail(f"QED 3D {sp.name}: particles not conserved to step {n_chk} "
                 f"({n0} - {edge} on an edge -> {n1} + {m1 - m0} merges)")
        if not abs(w1 - w0) <= 1e-5 * w0:
            fail(f"QED 3D {sp.name}: weight not conserved to step {n_chk} "
                 f"({w0} -> {w1})")
    check_photon_ig(sim, ip, "slice QED 3D")
    step_ms = (t2 - t1) * 1e3 / n_timed
    npart = sum(n for n, _, _ in after)
    log(f"[slice QED 3D] step {step_ms:.3f} ms (host clock, synchronised), "
        f"{npart / (step_ms * 1e-3):.4e} pushes/s ({npart} alive particles "
        f"of three species), peak |ey| "
        f"{float(sim.state.fields.ey.abs().max()):.3e}")
    busy_per_step(lambda: sim.run(nsteps=1, callbacks=[laser]),
                  {"e_half3": 2, "b_half3": 2, "rebin3": 9, "tail3<": 2,
                   "photon3<": 1, "fold3_pencil": 1}, 5, "profile QED 3D",
                   step_ms)

    # -- checks beside the main path, on its final state ------------------------
    n_ev, dropped, change = check_creation(sim, proc)
    # B2's plain version in 3D holds temporaries many times the slots (the
    # 125 deposit offsets): at the end state's slots want_chi is held and
    # timed on the QED3_PLANES x-planes with the most photons, the photon
    # mode (no gather, no deposit) on the whole state
    planes = photon_planes(sim, proc, QED3_PLANES)
    torch.cuda.empty_cache()
    errs.update(compare_b2_qed_f32(sim, proc, planes))
    torch.cuda.empty_cache()

    # -- the plain-torch QED work: device time ----------------------------------
    e_ev, outs = qed_events(sim, proc)
    time_delta_sampler(e_ev, proc)
    del e_ev
    e = sim.state.particles[ie]
    key = species_key(sim._base_key, sim.itime, ie)

    def qed_work():
        data, alive = proc.update_events_from_chi(outs[0], outs[1], key,
                                                  sim.dt, *outs[4])
        parts = list(sim.state.particles)
        parts[ie] = e.replace(data=data, alive=alive)
        return sim._builder.qed_creation(proc, parts)
    wall_qed = cuda_time(qed_work, 3)
    times, _ = device_times(qed_work, 3, {})
    dev_qed = (sum(ms for ms, _ in times.values()) / 3) if times else None
    dev_s = "not measured" if dev_qed is None else f"{dev_qed:.3f} ms"
    log(f"[QED plain 3D] device {dev_s} per step, wall {wall_qed:.3f} ms "
        f"(CUDA events; draws, rate, sampler, insertion, recoil); "
        f"{(dev_qed or wall_qed) / step_ms * 100:.1f}% of the step")
    del outs
    torch.cuda.empty_cache()

    rows = time_b2_qed_modes(sim, proc, args.iters3d, by_mode, errs, planes)
    log(f"[kernels QED 3D] launches per step B1 4, B2 3 (want_chi, default, "
        f"photon), B3 1; creation check: {n_ev} events, {dropped} dropped, "
        f"total change {change:.2e}")
    return rows, sim, laser


def run_split_qed_3d(args, sim, laser):
    """[slice split QED 3D]: the 3D QED slice continued with a host
    callback at _push_momentum due every step (B6 per axis and species,
    the plain gather, QED events and Boris, B5 in 3D, the creation): one
    split step against one fused step from a cloned state, then
    --steps-split-qed3d steps through Simulation3D.run."""
    import torch
    from lambdapic_torch import callback
    hook = callback(stage="_push_momentum")(lambda s: None)
    split_vs_fused_step(sim, laser, hook, "slice split QED 3D")
    n = args.steps_split_qed3d
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    sim.run(nsteps=n, callbacks=[laser, hook])
    torch.cuda.synchronize()
    t1 = time.time()
    check_launches("slice split QED 3D", n, {"B1": 4, "B5 3D": 2, "B6": 9},
                   into=STAGE3_LAUNCHES)
    check_finite(sim, "split QED 3D")
    check_photon_ig(sim, sim._qed_processes[0].photon_ispec,
                    "slice split QED 3D")
    step_ms = (t1 - t0) * 1e3 / n
    npart = sum(sim.npart_alive)
    log(f"[slice split QED 3D] {n} split steps from step {sim.itime - n}: "
        f"{step_ms:.3f} ms a step (host clock, synchronised), "
        f"{npart / (step_ms * 1e-3):.4e} pushes/s; slots "
        f"{[p.cap for p in sim.state.particles]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def run_exact_qed_3d(args, dev):
    """[slice exact QED 3D]: the 3D QED configuration with
    cell_migration="exact" from its own fill through Simulation3D.run
    until the first photon is born and --steps-exact-qed3d steps more (B4
    3D want_eb for the radiating electrons, B4 3D default for the
    protons, B5 3D for both; photons re-bin exactly and deposit
    nothing)."""
    import torch
    t0 = time.time()
    sim, laser, npho, pho = make_slice_qed_3d(dev, cell_migration="exact")
    sim.initialize()
    torch.cuda.synchronize()
    log(f"[slice exact QED 3D] initialised in {time.time() - t0:.1f} s: "
        f"{sim.npart_alive} particles, slots "
        f"{[p.cap for p in sim.state.particles]}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    first = None
    while first is None and sim.itime < 400:
        sim.run(nsteps=10, callbacks=[laser, npho])
        if int(sim.state.particles[pho.ispec].next_id) > 0:
            first = sim.itime
    if first is None:
        fail("exact QED 3D: no photon born in 400 steps")
    n_timed = min(20, args.steps_exact_qed3d)
    sim.run(nsteps=args.steps_exact_qed3d - n_timed, callbacks=[laser, npho])
    torch.cuda.synchronize()
    t1 = time.time()
    sim.run(nsteps=n_timed, callbacks=[laser, npho])
    torch.cuda.synchronize()
    t2 = time.time()
    check_launches("slice exact QED 3D", sim.itime,
                   {"B1": 4, "B4 3D": 2, "B4 3D want_eb": 1, "B5 3D": 2},
                   into=STAGE3_LAUNCHES)
    check_finite(sim, "exact QED 3D")
    check_photon_ig(sim, pho.ispec, "slice exact QED 3D")
    born = int(sim.state.particles[pho.ispec].next_id)
    after = totals(sim)
    step_ms = (t2 - t1) * 1e3 / n_timed
    npart = sum(n for n, _, _ in after)
    log(f"[slice exact QED 3D] {sim.itime} steps in {t2 - t0:.2f} s, the "
        f"first photon by step {first}; photons born {born}, alive "
        f"{sim.npart_alive[pho.ispec]}; window step {step_ms:.3f} ms (host "
        f"clock, synchronised), {npart / (step_ms * 1e-3):.4e} pushes/s; "
        f"alive, overflow, weight {after}; slots "
        f"{[p.cap for p in sim.state.particles]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    busy_per_step(lambda: sim.run(nsteps=1, callbacks=[laser]),
                  {"e_half3": 2, "b_half3": 2, "push3d": 2, "deposit3d": 2,
                   "fold_pad3": 2}, 3, "profile exact QED 3D", step_ms)
    run_exact_qed_mesh_3d(args, sim, laser)
    del sim
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the tiled 2D engine: kernels B8, B9 and bench.py's --tiling 32,32 forms
# ---------------------------------------------------------------------------

# bench.py's laser-target with --tiling TX,TY (bench.py:184-190, 208-220):
# 768^2 cells, dx = dy = l0/16, electrons and protons at ppc 10 for
# x > Lx/3, capacity factor 1.6, rebin 4 (so n_guard = tile halo 5); TX,TY
# is the user's choice, taken as 32,32 here
TILED = dict(nx=768, ny=768, tile=32, ppc=10, nspecies=2, factor=1.6,
             halo=5, rebin=4)
# floating-point work a particle: B8 the six staggered gathers with their
# spline weights (as B2 2D's, about 700), B9 the 5 x 5 Esirkepov nodes of
# four channels with their shapes (as B5 2D's, about 600)
FLOPS_B8, FLOPS_B9 = 700, 600
# float64 cases of [kernels tiled] (tx, ty, ntx, nty, h, cap_t): drifts of
# 1 and 3 cells, a cap_t that is not a multiple of 256, bench's 16,384
TILED_CASES = [(8, 8, 4, 3, 3, 300), (16, 8, 3, 4, 5, 256),
               (32, 32, 2, 3, 5, 16384)]
# bench.py's qed configuration (bench.py:243-258) in its --tiling 32,32
# form, the grid cut from 768^2 for time
TILED_QED_NX = 256


def make_slice_tiled(dev, qed=False, nx=TILED["nx"]):
    """bench.py's laser-target (``qed``: its qed configuration) in the
    --tiling 32,32 form with bench.py's defaults (ppc 10, --rebin 4 and
    the n_guard it needs, capacity factor 1.6, --recap 0, float32, seed
    0), built from the port's classes."""
    from lambdapic_torch import (Electron, Photon, Proton, SimpleLaser2D,
                                 Simulation)
    um = 1e-6
    nc = 1.742e27
    t = TILED
    dx = 0.8 * um / 16
    Lx = nx * dx
    n0 = (5 if qed else 10) * nc

    def density(x, y):
        return np.where(x > Lx / 3, n0, 0.0)

    sim = Simulation(nx=nx, ny=nx, dx=dx, dy=dx, random_seed=0,
                     precision="single", tiling=(t["tile"], t["tile"]),
                     rebin_interval=t["rebin"],
                     n_guard=2 + int(np.ceil(t["rebin"] * 0.95 / 2**0.5)),
                     particle_capacity_factor=t["factor"], recap_interval=0,
                     device=dev)
    if qed:
        pho = Photon(capacity=1 << 18)
        ele = Electron(density=density, ppc=t["ppc"], radiation="photons")
        ele.set_photon(pho)
        sim.add_species([ele, Proton(density=density, ppc=t["ppc"]), pho])
        return sim, SimpleLaser2D(a0=300, w0=3 * um, ctau=8 * um)
    sim.add_species([Electron(density=density, ppc=t["ppc"]),
                     Proton(density=density, ppc=t["ppc"])])
    return sim, SimpleLaser2D(a0=30, w0=3 * um, ctau=8 * um)


def _tiled_inputs(case, dtype, dev, seed):
    import torch
    from lambdapic_torch.ops.tiled2d import TileCfg
    from lambdapic_torch.testing import tiled_state, to_torch
    tx, ty, ntx, nty, h, cap = case
    cfg = TileCfg(tx=tx, ty=ty, ntx=ntx, nty=nty, cap_t=cap, h=h)
    d, alive, eb_pad = tiled_state(cfg, seed=seed, drift=h - 2)
    d, alive = to_torch(d, alive, dtype, dev)
    return cfg, d, alive, torch.as_tensor(eb_pad, dtype=dtype).to(dev)


def b8_err(got, ref, rtol, floor):
    """Max abs difference of B8's six components; fails unless each is
    within rtol of the plain value plus ``floor`` of the component's
    peak."""
    err = 0.0
    for k, (g, r) in enumerate(zip(got, ref)):
        d = (g - r).abs()
        lim = rtol * r.abs() + floor * float(r.abs().max())
        if not bool((d <= lim).all()):
            fail(f"B8 component {k}: {float(d.max()):.3e} beyond rtol {rtol} "
                 f"and {floor} of the peak")
        err = max(err, float(d.max()))
    return err


def b9_err(got, ref, tol):
    """Max abs difference of B9's four channels; fails unless each is
    within ``tol`` of its channel's peak (a channel that is 0 everywhere,
    jz where every uz is 0, must be 0 in the kernel's output too)."""
    err = 0.0
    for k, name in enumerate(("jx", "jy", "jz", "rho")):
        peak = float(ref[k].abs().max())
        d = float((got[k] - ref[k]).abs().max())
        if not d <= tol * peak:
            fail(f"B9 {name}: {d:.3e} beyond {tol} of the peak {peak:.3e}")
        err = max(err, d)
    return err


def check_tiled_f64(dev):
    """[kernels tiled], float64: B8 and B9 against their plain versions on
    TILED_CASES (dead slots, the drift band's edges, drifts of 1 and 3
    cells, cap_t 300 and 16,384, tiles of 8 x 8, 16 x 8 and 32 x 32).
    B8 rtol 1e-12 with a floor of 1e-14 of each component's peak; B9
    1e-12 of each channel's peak."""
    import torch
    from lambdapic_torch.ops import tiled2d_kernels as tk
    dt = 0.95 / np.sqrt(2 * 5e-8**-2) / 2.99792458e8
    for case in TILED_CASES:
        cfg, d, alive, eb_pad = _tiled_inputs(case, torch.float64, dev, 1)
        got = tk.gather_tiled_k(eb_pad, d["x"], d["y"], cfg)
        torch.cuda.synchronize()
        e8 = b8_err(got, tk.gather_tiled_plain(eb_pad, d["x"], d["y"], cfg),
                    1e-12, 1e-14)
        dead = ~alive
        dead[0, 0] = False
        if any(float(g[dead].abs().max()) != 0 for g in got):
            fail(f"B8 f64 {case}: a dead slot gathered a nonzero field")
        w = torch.where(alive, d["w"], 0.0)
        args = [d[k] for k in ("x", "y", "ux", "uy", "uz", "inv_gamma")] + [w]
        kw = dict(q=-1.602e-19, dx=5e-8, dy=5e-8, dt=dt)
        got = tk.deposit_tiled_k(*args, cfg, **kw)
        torch.cuda.synchronize()
        e9 = b9_err(got, tk.deposit_tiled(*args, cfg, **kw), 1e-12)
        log(f"[kernels tiled f64] tiles {case[:2]}, h {case[4]}, cap_t "
            f"{case[5]}: B8 max abs {e8:.3e}, B9 max abs {e9:.3e}")
        del got, d, alive, eb_pad


def tiled_operands(sim, ispec=0):
    """B8's and B9's operands at a tiled Simulation's state, species
    ``ispec``: (cfg, eb_pad, x, y, deposit args, deposit kw)."""
    import dataclasses
    import torch
    p = sim.state.particles[ispec]
    sp = sim._species_static[ispec]
    cfg = dataclasses.replace(sim._builder.tile_cfg, cap_t=p.cap)
    d = p.data
    w = torch.where(p.alive, d["w"], 0.0)
    args = [d["x"], d["y"], d["ux"], d["uy"], d["uz"], d["inv_gamma"], w]
    kw = dict(q=sp.q, dx=sim.dx, dy=sim.dy, dt=sim.dt)
    return cfg, sim._builder.pad_eb(sim.state.fields), args, kw


def check_tiled_f32(sim, ispec=0, tag="kernels tiled f32"):
    """[kernels tiled], float32 at a slice's shapes (its end state, species
    ``ispec``): B8 rtol 1e-5 with a floor of 1e-6 of the peak, B9 1e-4 of
    each channel's peak. A photon species, which the step gathers but
    does not deposit, is deposited with the electron's charge, so that B9
    is held on its operands too. Returns the two max abs errors."""
    import torch
    from lambdapic_torch.ops import tiled2d_kernels as tk
    cfg, eb_pad, args, kw = tiled_operands(sim, ispec)
    if kw["q"] == 0.0:
        kw["q"] = -1.602176634e-19
    got = tk.gather_tiled_k(eb_pad, args[0], args[1], cfg)
    torch.cuda.synchronize()
    e8 = b8_err(got, tk.gather_tiled_plain(eb_pad, args[0], args[1], cfg),
                1e-5, 1e-6)
    del got
    torch.cuda.empty_cache()
    got = tk.deposit_tiled_k(*args, cfg, **kw)
    torch.cuda.synchronize()
    e9 = b9_err(got, tk.deposit_tiled(*args, cfg, **kw), 1e-4)
    log(f"[{tag}] {sim.species[ispec].name}: {cfg.ntx} x {cfg.nty} tiles "
        f"of {cfg.cap_t} slots "
        f"({int(sim.state.particles[ispec].alive.sum())} alive): B8 max abs "
        f"{e8:.3e}, B9 max abs {e9:.3e}")
    torch.cuda.empty_cache()
    return e8, e9


def check_continuity(sim, tag):
    """Charge continuity of B9's own output, per charged species at the
    state: rho1 = B9's rho (the shapes S1 at x + v dt/2), rho0 = B9's rho
    with ux, uy negated (exactly the shapes S0 at x - v dt/2), J = B9's
    jx, jy; after fold_windows, (rho1 - rho0)/dt + div J must vanish on
    every node to float32 rounding. Fails beyond 1e-4 of the peak of
    |rho1|/dt; returns the worst ratio."""
    import torch
    from lambdapic_torch.ops.tiled2d import fold_windows
    from lambdapic_torch.ops.tiled2d_kernels import deposit_tiled_k
    worst = 0.0
    for ispec, sp in enumerate(sim._species_static):
        if sp.q == 0.0:
            continue
        cfg, _, args, kw = tiled_operands(sim, ispec)
        j1 = fold_windows(deposit_tiled_k(*args, cfg, **kw), cfg)
        back = list(args)
        back[2], back[3] = -args[2], -args[3]
        rho0 = fold_windows(deposit_tiled_k(*back, cfg, **kw), cfg)[3]
        jx, jy, rho1 = j1[0], j1[1], j1[3]
        div = jx.clone()
        div[1:] -= jx[:-1]
        div /= sim.dx
        djy = jy.clone()
        djy[:, 1:] -= jy[:, :-1]
        div += djy / sim.dy
        res = (rho1 - rho0) / sim.dt + div
        scale = float(rho1.abs().max()) / sim.dt
        ratio = float(res.abs().max()) / scale
        change = float((rho1 - rho0).abs().max()) / sim.dt / scale
        log(f"[{tag}] {sim.species[ispec].name}: continuity residual "
            f"{ratio:.3e} of max|rho|/dt (the largest |d rho/dt| is "
            f"{change:.3e} of it)")
        if not (change > 0 and ratio <= 1e-4):
            fail(f"{tag}: charge continuity of B9 broken ({ratio:.3e})")
        worst = max(worst, ratio)
        del j1, rho0, div, djy, res
    torch.cuda.empty_cache()
    return worst


def tile_of_ids(sim):
    """Per species, a table id_lo -> flat tile index of the alive slots
    (-1 where no alive slot holds the id)."""
    import torch
    out = []
    for p in sim.state.particles:
        ids = p.data["id_lo"].to(torch.int64)
        ntiles = p.alive.shape[0] * p.alive.shape[1]
        tile = torch.arange(ntiles, device=ids.device).reshape(
            p.alive.shape[:2] + (1,)).expand(p.alive.shape)
        table = torch.full((ntiles * p.cap + 1,), -1, dtype=torch.int64,
                           device=ids.device)
        table[ids[p.alive]] = tile[p.alive]
        out.append(table)
    return out


def near_open_face(sim, p, margin):
    """Sorted ids of a species' alive slots within ``margin`` cells of an
    open face."""
    import torch
    near = torch.zeros_like(p.alive)
    for ax, n, per in zip(sim.grid.axes, sim.grid.shape,
                          sim.grid.periodic_axes):
        if not per:
            x = p.data[ax]
            near |= (x < margin - 0.5) | (x >= n - 0.5 - margin)
    return torch.sort(p.data["id_lo"][near & p.alive].to(torch.int64)).values


def run_tiled_steps(sim, laser, n, ids, ov):
    """Run ``n`` steps, a re-binning interval at a time, holding each
    species' ids: an id alive at a chunk's end was alive at its start,
    and of the ids that went, those not within the interval's drift of
    an open face are at most the overflow's advance. Returns the ids that
    left through an open face, per species."""
    import torch
    R = sim.rebin_interval
    margin = R * 0.95 / 2**0.5 + 2
    gone = [0] * len(ids)
    done = 0
    while done < n:
        k = min(R, n - done)
        near = [near_open_face(sim, p, margin) for p in sim.state.particles]
        sim.run(nsteps=k, callbacks=[laser])
        done += k
        for i, p in enumerate(sim.state.particles):
            now = ids_of(p)
            if not bool(torch.isin(now, ids[i]).all()):
                fail(f"slice tiled: {sim.species[i].name} gained an id")
            went = ids[i][~torch.isin(ids[i], now)]
            lost = int(p.overflow) - ov[i]
            far = int((~torch.isin(went, near[i])).sum())
            if far > lost:
                fail(f"slice tiled: {sim.species[i].name}: {far} ids went "
                     f"away from the open faces, {lost} counted lost")
            gone[i] += len(went) - lost
            ids[i], ov[i] = now, int(p.overflow)
    return gone


def tiled_rows(sim, args, launches, errs):
    """[time B8] and [time B9] at the slice's end state (the electrons),
    with their plain versions timed once and their bounds counted from
    the state; returns the kernels line's rows."""
    import torch
    from lambdapic_torch.ops import tiled2d_kernels as tk
    cfg, eb_pad, dargs, kw = tiled_operands(sim)
    p = sim.state.particles[0]
    isz = p.data["x"].element_size()
    slots, n_alive = p.alive.numel(), int(p.alive.sum())
    win = cfg.ntx * cfg.nty * cfg.wx * cfg.wy
    rows = []
    for k, fn, plain, nbytes, flops in (
            ("B8", lambda: tk.gather_tiled_k(eb_pad, dargs[0], dargs[1], cfg),
             lambda: tk.gather_tiled_plain(eb_pad, dargs[0], dargs[1], cfg),
             # eb_pad read once, x and y read and six components written
             # at every slot
             (eb_pad.numel() + 8 * slots) * isz, n_alive * FLOPS_B8),
            ("B9", lambda: tk.deposit_tiled_k(*dargs, cfg, **kw),
             lambda: tk.deposit_tiled(*dargs, cfg, **kw),
             # w of every slot, the six other reals of the alive slots
             # (B9 skips w = 0), the four windows written
             (slots + 6 * n_alive + 4 * win) * isz, n_alive * FLOPS_B9)):
        dev_ms, wall = kernel_ms(fn, args.iters, k)
        ms = dev_ms or wall
        plain_ms = cuda_time(plain, 1)
        torch.cuda.empty_cache()
        b_ms, o_ms = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
        bound = max(b_ms, o_ms)
        log(f"[time {k}] device {ms:.4f} ms per launch, wall {wall:.4f} ms "
            f"per call, plain {plain_ms:.3f} ms; bound {bound:.4f} ms "
            f"({nbytes} bytes, {n_alive} of {slots} slots alive)")
        rows.append(dict(
            name={"B8": "B8 tiled gather", "B9": "B9 tiled deposit"}[k],
            route="cuda",
            source={"B8": "lambdapic_torch/csrc/gather_tiled.cu",
                    "B9": "lambdapic_torch/csrc/deposit_tiled.cu"}[k],
            replaces={"B8": "lambdapic_tpu/ops/tiled2d_pallas.py:193",
                      "B9": "lambdapic_tpu/ops/tiled2d_pallas.py:282"}[k],
            launches=launches[k], max_abs_err=errs[k], ms=ms,
            timing=kernel_ms.method, plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if b_ms >= o_ms else "operations",
            library_ms=None))
    return rows


def count_migrations():
    """Wrap the tiled step's re-binning with a call counter; returns the
    counter (a one-element list) and the function that unwraps it."""
    from lambdapic_torch.simulation import step as step_mod
    real = step_mod.migrate_tiled
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    step_mod.migrate_tiled = counted

    def restore():
        step_mod.migrate_tiled = real
    return calls, restore


def run_tiled(args, dev):
    """[kernels tiled], [slice tiled], [time B8], [time B9]; returns the
    kernels line's B8 and B9 rows."""
    import torch
    t0 = time.time()
    check_tiled_f64(dev)
    log(f"[kernels tiled f64] {time.time() - t0:.1f} s")
    t0 = time.time()
    sim, laser = make_slice_tiled(dev)
    sim.initialize()
    log(f"[slice tiled] initialised in {time.time() - t0:.1f} s: "
        f"{sim.npart_alive} particles, {sim.grid.nx // TILED['tile']} x "
        f"{sim.grid.ny // TILED['tile']} tiles of "
        f"{[p.cap for p in sim.state.particles]} slots, n_guard "
        f"{sim.grid.n_guard}, dt {sim.dt:.4e} s")
    tiles0 = tile_of_ids(sim)
    ids = [ids_of(p) for p in sim.state.particles]
    n_ids0 = [len(i) for i in ids]
    ov = [int(p.overflow) for p in sim.state.particles]
    steps = args.steps_tiled
    n_timed = min(args.window_tiled, steps)
    calls, restore = count_migrations()
    reset_launches()
    t0 = time.time()
    try:
        gone = run_tiled_steps(sim, laser, steps - n_timed, ids, ov)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.time()
        sim.run(nsteps=n_timed, callbacks=[laser])
        torch.cuda.synchronize()
        t2 = time.time()
    finally:
        restore()
    R = sim.rebin_interval
    migrating = sum(1 for i in range(steps) if i % R == R - 1)
    log(f"[slice tiled] {steps} steps, {migrating} of them re-binning: "
        f"migrate_tiled ran {calls[0]} times")
    if calls[0] != 2 * migrating:
        fail(f"slice tiled: {calls[0]} re-binnings, expected {2 * migrating}")
    got = check_launches("slice tiled", steps, {"B1": 4, "B8": 2, "B9": 2})
    check_finite(sim, "slice tiled", rho=True)
    # the window's steps, unchecked while timed: every id that went is
    # counted as lost or out through a face
    tail = [0] * len(ids)
    for i, p in enumerate(sim.state.particles):
        now = ids_of(p)
        if not bool(torch.isin(now, ids[i]).all()):
            fail(f"slice tiled: {sim.species[i].name} gained an id")
        tail[i] = len(ids[i]) - len(now) - (int(p.overflow) - ov[i])
        log(f"[slice tiled] {sim.species[i].name}: {n_ids0[i]} ids -> "
            f"{len(now)} alive + {int(p.overflow)} lost to tile overflow + "
            f"{gone[i] + tail[i]} out through an open face ({gone[i]} of them "
            "held against the faces' reach)")
        if len(now) + int(p.overflow) + gone[i] + tail[i] != n_ids0[i]:
            fail("slice tiled: ids do not add up")
    tiles1 = tile_of_ids(sim)
    moved = [int(((a >= 0) & (b >= 0) & (a != b)).sum())
             for a, b in zip(tiles0, tiles1)]
    log(f"[slice tiled] particles that changed tile: {moved}")
    if not all(m > 0 for m in moved):
        fail("slice tiled: no particle changed tile")
    del tiles0, tiles1
    step_ms = (t2 - t1) * 1e3 / n_timed
    npart = sum(sim.npart_alive)
    log(f"[slice tiled] window {n_timed} steps in {t2 - t1:.3f} s: step "
        f"{step_ms:.3f} ms (host clock, synchronised), "
        f"{npart / (step_ms * 1e-3):.4e} pushes/s, peak |ey| "
        f"{float(sim.state.fields.ey.abs().max()):.3e}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    busy_per_step(lambda: sim.run(nsteps=1, callbacks=[laser]),
                  {"e_half": 2, "b_half": 2, "gather<": 2, "deposit<": 2},
                  8, "profile tiled", step_ms)
    check_continuity(sim, "slice tiled")
    errs = dict(zip(("B8", "B9"), check_tiled_f32(sim)))
    rows = tiled_rows(sim, args, got, errs)
    del sim
    torch.cuda.empty_cache()
    return rows


def run_tiled_qed(args, dev):
    """[slice tiled QED]: bench.py's qed configuration in its --tiling
    32,32 form at TILED_QED_NX^2 through Simulation.run: photons born
    through insert_tiled, launches a step B1 4, B8 3 (photons gathered
    too), B9 2."""
    import torch
    t0 = time.time()
    sim, laser = make_slice_tiled(dev, qed=True, nx=TILED_QED_NX)
    sim.initialize()
    log(f"[slice tiled QED] initialised in {time.time() - t0:.1f} s: "
        f"{sim.npart_alive} particles, tiles of "
        f"{[p.cap for p in sim.state.particles]} slots")
    steps = args.steps_tiled_qed
    n_timed = min(50, steps)
    reset_launches()
    t0 = time.time()
    sim.run(nsteps=steps - n_timed, callbacks=[laser])
    torch.cuda.synchronize()
    t1 = time.time()
    sim.run(nsteps=n_timed, callbacks=[laser])
    torch.cuda.synchronize()
    t2 = time.time()
    check_launches("slice tiled QED", steps, {"B1": 4, "B8": 3, "B9": 2})
    check_finite(sim, "slice tiled QED", rho=True)
    ph = sim.state.particles[2]
    born, alive = int(ph.next_id), int(ph.alive.sum())
    if not (born > 0 and alive > 0):
        fail("slice tiled QED: no photon was born")
    check_photon_ig(sim, 2, "slice tiled QED")
    for ispec in range(len(sim.species)):
        check_tiled_f32(sim, ispec, "kernels tiled QED f32")
    step_ms = (t2 - t1) * 1e3 / n_timed
    log(f"[slice tiled QED] {steps} steps in {t2 - t0:.2f} s; last {n_timed}"
        f" at {step_ms:.3f} ms a step (host clock, synchronised), "
        f"{sum(sim.npart_alive) / (step_ms * 1e-3):.4e} pushes/s; photons "
        f"born {born}, alive {alive}; overflow "
        f"{[int(p.overflow) for p in sim.state.particles]}")
    del sim
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the cell engine on a device mesh: K4 (B2's cross-device and
# multi-dispatch modes) and K5 (B3's cross-device strips), the 2D slice on
# a 2 x 2 mesh and the 3D slice on a 2 x 2 x 2 mesh of the one card
# ---------------------------------------------------------------------------

# (mesh, cap, cells per shard, periodic, crowded): float64 K4/K5 cases,
# with merges in the crowded ones and corner movers in all
MESH_CASES = [((2, 1), 6, (16, 24), (True, False), True),
              ((2, 2), 4, (16, 16), (False, True), False),
              ((2, 2), 8, (17, 16), (True, True), True),
              ((1, 4), 4, (20, 16), (False, False), False),
              ((1, 2, 1), 4, (8, 8, 8), (True, False, True), True),
              ((2, 2, 2), 4, (8, 8, 8), (True, True, False), False),
              ((2, 2, 2), 6, (8, 9, 8), (False, True, True), True),
              ((1, 1, 2), 4, (8, 8, 8), (False, False, True), True)]
# the 3D mesh-versus-one-device gates run in float64 on the last
# MESH_PLANES_F64 x-planes (shards of 32 x 128 x 128): a float64 state of
# the whole 3D grid does not fit the card beside its step's temporaries
MESH_PLANES_F64 = 64
MESH_NAMES = ("px", "py", "pz")


def mesh_of(shape, dev):
    from lambdapic_torch.parallel.mesh import Mesh
    n = int(np.prod(shape))
    return Mesh(tuple(shape), MESH_NAMES[:len(shape)], (dev,) * n)


def reset_mesh_launches():
    from lambdapic_torch.ops import cellslab
    for d in (cellslab.cell_step.launches_by_dispatch,
              cellslab.fold_reduce.launches_by_kind):
        for k in d:
            d[k] = 0


def check_mesh_f64(dev):
    """K4 and K5 against their plain versions in float64 on the small
    meshes of MESH_CASES (every shard on the one card): slot for slot
    after canonicalisation, merges equal, panels and J to 1e-12 of their
    peak. Returns the merges of the crowded cases."""
    import torch
    from lambdapic_torch.ops.cellslab import (cell_step, cell_step_mesh,
                                              cell_step_plain, fold_reduce,
                                              fold_reduce_plain)
    from lambdapic_torch.parallel.halo import HaloSpec
    from lambdapic_torch.testing import (compare_mesh_slots, mesh_to_numpy,
                                         mesh_to_torch, random_mesh_cells)
    q, m, dt, dx, g = -1.602e-19, 9.109e-31, 1.1e-16, 5e-8, 3
    merges = []
    for shape, cap, nloc, per, crowded in MESH_CASES:
        nd = len(shape)
        mesh = mesh_of(shape, dev)
        specs = tuple(HaloSpec(MESH_NAMES[i], shape[i], per[i])
                      for i in range(nd))
        data, alive, eb = random_mesh_cells(shape, cap, nloc,
                                            seed=cap + sum(nloc),
                                            crowded=crowded,
                                            n_frac=0.9 if crowded else 0.4)
        shards = mesh_to_torch(data, alive, mesh, torch.float64)
        ebs = [torch.as_tensor(eb[mesh.coords(i)]).to(dev)
               for i in range(mesh.size)]
        outs = []
        for step, fold in ((cell_step, fold_reduce),
                           (cell_step_plain, fold_reduce_plain)):
            res = cell_step_mesh(ebs, [d for d, _ in shards],
                                 [a for _, a in shards], mesh, specs, q=q,
                                 m=m, dt=dt, dx=dx, dy=dx,
                                 dz=dx if nd == 3 else None, g=g, step=step)
            outs.append((res, fold([r[3] for r in res], nloc, None, mesh,
                                   specs)))
        torch.cuda.synchronize()
        (got, jg), (ref, jr) = outs
        gd, ga = mesh_to_numpy([(r[0], r[1]) for r in got], shape)
        rd, ra = mesh_to_numpy([(r[0], r[1]) for r in ref], shape)
        try:
            compare_mesh_slots(rd, ra, gd, ga, shape, rtol=1e-11)
        except AssertionError as e:
            fail(f"K4 f64 {shape}: {str(e)[:400]}")
        lg, lr = [int(r[2]) for r in got], [int(r[2]) for r in ref]
        if lg != lr:
            fail(f"K4 f64 {shape}: merges {lg} vs {lr}")
        if crowded and sum(lr) == 0:
            fail(f"K4 f64 {shape}: the crowded case merged nothing")
        for a, b in zip(got, ref):
            err = float((a[3] - b[3]).abs().max())
            if not err <= 1e-12 * float(b[3].abs().max()):
                fail(f"K4 f64 {shape}: panels differ by {err:.3e}")
        peak = max(float(b.abs().max()) for b in jr)
        err = max(float((a - b).abs().max()) for a, b in zip(jg, jr))
        if not err <= 1e-12 * peak:
            fail(f"K5 f64 {shape}: J differs by {err:.3e} of {peak:.3e}")
        moved = int(sum(int((np.asarray(gd["id_hi"])[c][ga[c]] !=
                             np.ravel_multi_index(c, shape)).sum())
                        for c in np.ndindex(shape)))
        log(f"[kernels mesh f64 {shape}] slot-exact; {moved} alive slots "
            f"from another shard; merges {sum(lr)}; J {err:.2e} of peak")
        merges.append(sum(lr))
    return merges


def check_shard_f32(tag, twin, ispec=0, mode="default"):
    """K4 and K5 (with ``mode`` "want_chi" or "photon", K6: B2's QED modes
    in the mesh dispatches, stepped from the run's state in its own
    fields, without the random first step) against their plain versions
    in float32 at the slice's
    shard shape, on species ``ispec`` of the mesh run ``twin``, whose
    state is dropped (its slots are freed once the first step has read
    them; the other species and the fields at once). One kernel step of the whole mesh in fields
    strong enough to carry particles across shard faces and corners in
    one step (uniform +-5e13, seed 5) gives the particles momenta. The
    next step then runs dispatch by dispatch as cell_step_mesh runs it:
    every shard's kernel dispatch (the next dispatch's input), and on the
    busiest shard the plain version of the same dispatch on the same
    input, its neighbours' edge columns included. Each dispatch holds
    alive masks and ids identical, merges equal and the total weight to
    1e-6; the tail its panels to 1e-4 of their peak. K5 (the fold and its
    strip adds across the mesh) is held against fold_reduce_plain on the
    kernel's panels, J to 1e-4 of its peak. Returns ((K4 panel error, K5
    J error) as absolute values, the plain dispatches' ms on the busy
    shard, the plain fold's ms a shard), the plain times from CUDA events
    around one call after a warm-up. In the want_chi mode the tail also
    holds chi on the alive slots and returns its largest difference in
    place of the panels'; in the photon mode there are no fields, panels
    or fold: the tail holds positions within 1e-4 cells and momenta and
    inv_gamma within 1e-6 of their peaks, and the largest position
    difference (cells) stands there. The plain time of the want_chi mode
    is its tail's (the head dispatches run the default mode)."""
    import torch
    from lambdapic_torch.ops.cellslab import (
        FLOAT_PAYLOADS, ID_PAYLOADS, cell_step, cell_step_mesh,
        cell_step_plain, dispatch_groups, edge_columns, extra_payloads,
        fold_reduce, fold_reduce_plain)
    want_chi, photon = mode == "want_chi", mode == "photon"
    grid, mesh, specs = twin.grid, twin.mesh, twin._builder.specs
    sp, dt = twin._species_static[ispec], twin.dt
    g = grid.n_guard
    nloc = grid.local_shape
    nd = len(nloc)
    n = mesh.size
    ps = [s.particles[ispec] for s in twin.state.shards]
    datas, alives = [p.data for p in ps], [p.alive for p in ps]
    # the QED modes step in the run's own fields: in random ones of this
    # size a float32 chi overflows, and QED species move at nearly c
    ebs = [None] * n if photon else \
        twin._builder.pad_eb([s.fields for s in twin.state.shards]) \
        if want_chi else None
    twin.state = None
    del ps
    torch.cuda.empty_cache()
    kw = dict(q=sp.q, m=sp.m, dt=dt, dx=grid.dx, dy=grid.dy,
              dz=grid.dz if nd == 3 else None, g=g, with_rho=False,
              photon=photon)
    if mode == "default":
        rng = np.random.default_rng(5)
        dev = mesh.devices[0]
        ebs = [torch.as_tensor(rng.uniform(-5e13, 5e13, (6,) + tuple(
            k + 2 * g for k in nloc)).astype(np.float32)).to(dev)
               for _ in range(n)]
        first = cell_step_mesh(ebs, datas, alives, mesh, specs, **kw)
        del datas, alives
        cur = [r[0] for r in first]
        cur_alive = [r[1] for r in first]
        del first
    else:
        cur, cur_alive = datas, alives
        del datas, alives
    torch.cuda.empty_cache()
    kw["periodic"] = tuple(s.periodic for s in specs)
    if mode == "default":
        busy = int(np.argmax([int(a.sum()) for a in cur_alive]))
    else:
        # the shard with the most particles faster than |u| = 1: in the
        # run's own fields a cold shard re-bins nothing
        busy = int(np.argmax([int((a & (d["ux"]**2 + d["uy"]**2
                                        + d["uz"]**2 > 1)).sum())
                              for d, a in zip(cur, cur_alive)]))
    start = cur_alive[busy].clone()
    names = FLOAT_PAYLOADS + ID_PAYLOADS + extra_payloads(cur[0])
    xe = edge_columns(cur, cur_alive, names + ("inv_gamma",), 0, specs[0],
                      mesh) if specs[0].size > 1 else None
    groups = dispatch_groups(mesh.shape)
    plain_ms = 0.0
    rims = [None] * n
    pan_err = 0.0
    for gi, grp in enumerate(groups):
        last = gi == len(groups) - 1
        yz = None if gi == 0 else edge_columns(cur, cur_alive, names, grp[0],
                                               specs[grp[0]], mesh)

        def disp(step, i):
            return step(ebs[i] if last else None, cur[i], cur_alive[i],
                        edges_lo=xe[i][0] if gi == 0 and xe else None,
                        edges_hi=xe[i][1] if gi == 0 and xe else None,
                        merge_axes=grp, tail=last,
                        yz_edges=None if yz is None else (grp[0],)
                        + tuple(yz[i]), want_chi=want_chi and last, **kw)
        ref = disp(cell_step_plain, busy)
        ms = cuda_time(lambda: disp(cell_step_plain, busy), 1)
        # the plain dispatches that run the mode (want_chi: the tail only)
        if last or not want_chi:
            plain_ms += ms
        got = None
        for i in range(n):
            out = disp(cell_step, i)
            if i == busy:
                got = out
            cur[i], cur_alive[i] = out[0], out[1]
            if last and not photon:
                rims[i] = out[3]
            del out
        torch.cuda.synchronize()
        same = torch.equal(got[1], ref[1]) and all(
            torch.equal(got[0][k][got[1]], ref[0][k][ref[1]])
            for k in ("id_lo", "id_hi"))
        mg, mr = int(got[2]), int(ref[2])
        w = [float(torch.where(r[1], r[0]["w"], 0).sum(dtype=torch.float64))
             for r in (got, ref)]
        msg = ""
        if last and photon:
            a = got[1]
            pan_err = max(float((got[0][k][a] - ref[0][k][a]).abs().max())
                          for k in grid.axes)
            du = [(float((got[0][k][a] - ref[0][k][a]).abs().max()),
                   float(ref[0][k][a].abs().max()))
                  for k in ("ux", "uy", "uz", "inv_gamma")]
            u_err = max(d_ / max(p_, 1e-30) for d_, p_ in du)
            msg = (f"; positions {pan_err:.3e} cells, momenta and "
                   f"inv_gamma {u_err:.3e} of their peaks")
            if not (pan_err <= 1e-4
                    and all(d_ <= 1e-6 * p_ for d_, p_ in du)):
                fail(f"K6 {tag} float32: positions {pan_err:.3e} cells "
                     f"(gate 1e-4) or momenta and inv_gamma {u_err:.3e} of "
                     "their peaks (gate 1e-6) from the plain version")
        elif last:
            peak = float(ref[3].abs().max())
            pan_err = float((got[3] - ref[3]).abs().max())
            msg = f"; panels {pan_err:.3e} of peak {peak:.3e}"
            if want_chi:
                # in these fields float32 chi may cancel to a NaN, in the
                # kernel where the plain version does
                gc, rc = got[4][0][got[1]], ref[4][0][ref[1]]
                fin = torch.isfinite(rc)
                if not torch.equal(fin, torch.isfinite(gc)):
                    fail(f"K6 {tag} float32: chi finite in other slots")
                chi_err = float((gc[fin] - rc[fin]).abs().max())
                chi_peak = float(rc[fin].abs().max())
                msg += (f"; chi {chi_err:.3e} of peak {chi_peak:.3e} "
                        f"({int((~fin).sum())} not finite in both)")
                if not chi_err <= 1e-4 * chi_peak:
                    fail(f"K6 {tag} float32: chi differs by {chi_err:.3e}")
        log(f"[kernels mesh f32 {tag} dispatch {grp}] shard {busy} of {n}, "
            f"{tuple(cur_alive[busy].shape)} slots: merges {mg} vs {mr}; "
            f"weight rel {abs(w[0] - w[1]) / abs(w[1]):.2e}; alive masks "
            f"and ids identical: {same}{msg}; plain {ms:.2f} ms")
        if not same or mg != mr:
            fail(f"K4 {tag} float32 dispatch {grp}: alive masks, ids or "
                 "merges differ from the plain version")
        if not abs(w[0] - w[1]) <= 1e-6 * abs(w[1]):
            fail(f"K4 {tag} float32 dispatch {grp}: total weight {w[0]} "
                 f"vs {w[1]}")
        if last and not photon and not pan_err <= 1e-4 * peak:
            fail(f"K4 {tag} float32: panels differ by {pan_err:.3e}")
        if last and want_chi:
            pan_err = chi_err
        del ref, got, yz
    moved = int((cur_alive[busy] != start).sum())
    del cur, cur_alive, xe, start
    torch.cuda.empty_cache()
    if moved == 0:
        fail(f"K4 {tag} float32: the compared step re-binned nothing")
    if photon:
        log(f"[kernels mesh f32 {tag}] {moved} slots of shard {busy} changed "
            f"occupancy in the compared step; plain: the shard's dispatches "
            f"{plain_ms:.2f} ms")
        del ebs
        torch.cuda.empty_cache()
        return (pan_err, None), plain_ms, None
    jg = fold_reduce(rims, nloc, None, mesh, specs)
    jr = fold_reduce_plain(rims, nloc, None, mesh, specs)
    torch.cuda.synchronize()
    j_peak = max(float(t.abs().max()) for t in jr)
    j_err = max(float((a - b).abs().max()) for a, b in zip(jg, jr))
    del jg, jr
    fold_ms = cuda_time(lambda: fold_reduce_plain(rims, nloc, None, mesh,
                                                  specs), 1) / n
    log(f"[kernels mesh f32 {tag}] {moved} slots of shard {busy} changed "
        f"occupancy in the compared step; K5 J {j_err:.3e} of peak "
        f"{j_peak:.3e}; plain: the shard's dispatches {plain_ms:.2f} ms, "
        f"the fold {fold_ms:.2f} ms a shard")
    if not j_err <= 1e-4 * j_peak:
        fail(f"K5 {tag} float32: J differs by {j_err:.3e}")
    del rims, ebs
    torch.cuda.empty_cache()
    return (pan_err, j_err), plain_ms, fold_ms


def mesh_results(sim):
    """What a mesh run and its one-device twin are compared on: the
    global fields and, per species, the alive particles' ids, positions in
    global cell units and momenta, on the host."""
    fields = {k: sim.get_field(k) for k in
              ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz")}
    parts = []
    for ispec in range(len(sim.species)):
        p = sim.get_particles(ispec)
        key = p["id_lo"].astype(np.int64) * 4096 + p["id_hi"].astype(np.int64)
        order = np.argsort(key)
        parts.append(dict(key=key[order], w=p["w"][order].astype(np.float64),
                          **{a: p[a][order] / d for a, d in
                             zip(sim.grid.axes, sim.grid.deltas)},
                          **{k: p[k][order].astype(np.float64)
                             for k in ("ux", "uy", "uz")}))
    return fields, parts


def compare_mesh_runs(tag, mres, ores, grid):
    """The gates of a mesh run against the one-device run from the same
    state: finite fields, E, B and J within 1e-4 of each component's
    peak; per species the same total weight (1e-6) and alive count but for
    the ids alive in one run only (at most 1e-6 of the alive count, each
    printed with its distance to a cell face); the particles matched by id
    within 1e-4 cells and momenta within rtol 1e-4 (floor 1e-6 of the
    species' peak |u|). Run on float64 twins (compare_on_mesh): in float32
    the two runs' rounding apart flips merges (check_totals). Returns the
    measured differences."""
    mf, mp = mres
    of, op = ores
    out = {}
    for k, a in mf.items():
        b = of[k]
        if not np.isfinite(a).all():
            fail(f"{tag}: field {k} is not finite on the mesh")
        peak = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        out[k] = err / peak if peak else err
        if not err <= 1e-4 * peak:
            fail(f"{tag}: {k} differs by {err:.3e}, peak {peak:.3e}")
    log(f"[{tag}] fields: mesh vs one device, max |diff| / peak "
        + ", ".join(f"{k} {v:.2e}" for k, v in out.items()))
    tol = 1e-4
    for ispec, (a, b) in enumerate(zip(mp, op)):
        common, ia, ib = np.intersect1d(a["key"], b["key"],
                                        assume_unique=True,
                                        return_indices=True)
        only_a = np.setdiff1d(np.arange(len(a["key"])), ia)
        only_b = np.setdiff1d(np.arange(len(b["key"])), ib)
        n = len(b["key"])
        for which, idx, src in (("mesh", only_a, a), ("one device", only_b,
                                                      b)):
            for j in idx[:20]:
                pos = [float(src[ax][j]) for ax in grid.axes]
                face = min(abs((x + 0.5) - round(x + 0.5)) for x in pos)
                log(f"[{tag}] species {ispec}: id {int(src['key'][j])} alive "
                    f"only in the {which} run, at {pos} cells, "
                    f"{face:.2e} cells from a cell face")
        n_only = len(only_a) + len(only_b)
        if n_only > 1e-6 * n:
            fail(f"{tag}: species {ispec}: {n_only} ids alive in one run "
                 f"only (> 1e-6 of {n})")
        if abs(len(a["key"]) - n) > n_only:
            fail(f"{tag}: species {ispec}: alive {len(a['key'])} vs {n}")
        wa, wb = float(a["w"].sum()), float(b["w"].sum())
        if not abs(wa - wb) <= 1e-6 * abs(wb):
            fail(f"{tag}: species {ispec}: total weight {wa} vs {wb}")
        dpos = max(float(np.abs(a[ax][ia] - b[ax][ib]).max())
                   for ax in grid.axes) if len(common) else 0.0
        rms = max(float(np.sqrt(np.mean((a[ax][ia] - b[ax][ib])**2)))
                  for ax in grid.axes) if len(common) else 0.0
        upeak = max(float(np.abs(b[k]).max()) for k in ("ux", "uy", "uz"))
        du = max(float((np.abs(a[k][ia] - b[k][ib])
                        / (np.abs(b[k][ib]) + max(1e-6 * upeak, 1e-300))
                        ).max())
                 for k in ("ux", "uy", "uz")) if len(common) else 0.0
        log(f"[{tag}] species {ispec}: {len(common)} ids in both runs, "
            f"{len(only_a)} in the mesh run only, {len(only_b)} in the "
            f"one-device run only; positions max {dpos:.3e} rms {rms:.3e} "
            f"cells (gate {tol:.3e}); momenta rel {du:.3e} (gate 1e-4); "
            f"weight rel {abs(wa - wb) / abs(wb):.2e}")
        if not dpos <= tol:
            fail(f"{tag}: species {ispec}: positions differ by {dpos:.3e} "
                 f"cells (> {tol:.3e})")
        if not du <= 1e-4:
            fail(f"{tag}: species {ispec}: momenta differ by rtol {du:.3e}")
        out[f"pos{ispec}"], out[f"u{ispec}"] = dpos, du
    return out


def dispatch_ms(tag, twin, iters, ispec=0, mode="default"):
    """Kernel times of one shard's K4 dispatches and K5 launches at the
    slice's per-shard shapes (the shard with the most alive particles of
    species ``ispec``, the twin's present state and fields), from CUDA
    events around ``iters`` calls (for a small launch that includes the
    host's issue time). These launches are not the main path's and are
    not counted there. Returns a dict of ms and the bytes of the
    bounds (counted as PERF.md §6 counts B2's and B3's: the mask, the
    alive slots' payloads, the gather's nodes, one write of every slot
    and of the panels, the edge columns read once; the panels read, the
    strips sent and received, J written). ``mode`` "want_chi" or "photon"
    times B2's QED modes in the dispatches (K6): the want_chi tail also
    writes chi and ig0 (its time "tail" and bytes "bytes_tail" apart:
    the head dispatches run the default mode); the photon dispatches read
    no fields and write no panels, and no fold follows. No profile: no
    row or busy share needs the device split of a dispatch."""
    import torch
    from lambdapic_torch.ops import cellslab
    from lambdapic_torch.ops.cellslab import (FLOAT_PAYLOADS, ID_PAYLOADS,
                                              cell_step, dispatch_groups,
                                              edge_columns, extra_payloads,
                                              panel_shape)
    want_chi, photon = mode == "want_chi", mode == "photon"
    grid, mesh = twin.grid, twin.mesh
    specs = twin._builder.specs
    nd = grid.dimension
    sp = twin._species_static[ispec]
    shards = twin.state.shards
    ebs = [None] * mesh.size if photon else \
        twin._builder.pad_eb([s.fields for s in shards])
    groups = dispatch_groups(mesh.shape)
    kw = dict(q=sp.q, m=sp.m, dt=twin.dt, dx=grid.dx, dy=grid.dy,
              dz=grid.dz if nd == 3 else None, g=grid.n_guard,
              periodic=tuple(s.periodic for s in specs),
              with_rho=twin._builder.with_rho, photon=photon)
    out = {}
    ps = [s.particles[ispec] for s in shards]
    names = FLOAT_PAYLOADS + ID_PAYLOADS + extra_payloads(ps[0].data)
    datas, alives = [p.data for p in ps], [p.alive for p in ps]
    busy = int(np.argmax([int(a.sum()) for a in alives]))
    xe = edge_columns(datas, alives, names + ("inv_gamma",), 0, specs[0],
                      mesh) if specs[0].size > 1 else None
    rims = None
    for gi, grp in enumerate(groups):
        last = gi == len(groups) - 1
        yz = None if gi == 0 else edge_columns(datas, alives, names, grp[0],
                                               specs[grp[0]], mesh)

        def disp(i):
            return cell_step(
                ebs[i] if last else None, datas[i], alives[i],
                merge_axes=grp, tail=last,
                edges_lo=xe[i][0] if gi == 0 and xe else None,
                edges_hi=xe[i][1] if gi == 0 and xe else None,
                yz_edges=None if yz is None else (grp[0],) + tuple(yz[i]),
                want_chi=want_chi and last, **kw)
        out[f"dispatch {grp}"] = cuda_time(lambda: disp(busy), iters)
        if last:
            out["tail"] = out[f"dispatch {grp}"]
        log(f"[time K4 {tag} dispatch {grp}] {out[f'dispatch {grp}']:.4f} "
            f"ms a call (CUDA events), shard {busy} of {mesh.size}")
        if last:
            rims = None if photon else disp(busy)[3]
        else:
            # the next dispatch's input on every shard
            res = [disp(i) for i in range(mesh.size)]
            datas = [{**d, **r[0]} for d, r in zip(datas, res)]
            alives = [r[1] for r in res]
            del res
        del yz
    split = tuple(sp_.size > 1 for sp_ in specs)
    nloc = grid.local_shape
    # the edge columns each dispatch reads: the x edges in the first, a
    # split y or z axis's in its own
    tail_ax = groups[-1][0]
    if photon:
        isz = datas[0]["x"].element_size()
        a0 = ps[busy].alive
        slots, n_alive = a0.numel(), int(a0.sum())
        slot_b = 1 + 8 * isz + 2 * 4
        edge_b = 2 * sum(slots // nloc[ax] for ax in range(nd)
                         if specs[ax].size > 1) * slot_b
        out["bytes_k4"] = (slots + n_alive * (slot_b - 1) + slots * slot_b
                           + edge_b)
        out["alive"] = n_alive
        log(f"[bound K6 photon {tag}] shard {busy}: {n_alive} of {slots} "
            f"slots alive, {out['bytes_k4']} bytes")
        return out
    if nd == 3:
        out.update(k5_3d_ms(tag, rims, nloc, specs, iters, busy))
    else:
        fold_fn = (lambda: cellslab._fold(rims, nloc, kw["periodic"], split))
        out["fold"] = cuda_time(fold_fn, iters)
        q = fold_fn()
        strips = []
        for ax in reversed(range(nd)):
            if split[ax]:
                axis = 1 + ax
                lo = q.narrow(axis, 0, 2).contiguous()
                fn = (lambda q=q, axis=axis, lo=lo: cellslab._fold_strips(
                    q, axis, lo, lo))
                strips.append(cuda_time(fn, iters))
                q = fn()
        out["strips"] = sum(strips)
        log(f"[time K5 {tag}] fold {out['fold']:.4f} ms, strips "
            f"{[round(v, 4) for v in strips]} ms a call (CUDA events), "
            f"shard {busy}")
        del q
    isz = ebs[0].element_size()
    a0 = ps[busy].alive
    slots, n_alive = a0.numel(), int(a0.sum())
    slot_b = 1 + 8 * isz + 2 * 4
    ncomp = 4 if twin._builder.with_rho else 3
    pan_b = int(np.prod(panel_shape(ncomp, *nloc))) * isz
    nodes = gather_nodes(a0, grid.n_guard) if nd == 2 else \
        gather_nodes_3d(a0, grid.n_guard)
    edge_b = 2 * sum(slots // nloc[ax] for ax in range(nd)
                     if specs[ax].size > 1) * slot_b
    out["bytes_k4"] = (slots + n_alive * (slot_b - 1) + slots * slot_b
                       + nodes * isz + pan_b + edge_b
                       + (2 * slots * isz if want_chi else 0))
    # the tail alone (the want_chi launch of K6): its own edges only
    out["bytes_tail"] = out["bytes_k4"] - edge_b + (
        2 * slots // nloc[tail_ax] * slot_b if specs[tail_ax].size > 1
        else 0)
    out["alive"] = n_alive
    cells = int(np.prod(nloc))
    strip_b = sum(2 * 2 * ncomp * cells // nloc[ax] * isz
                  for ax in range(nd) if split[ax])
    out["bytes_k5"] = pan_b + ncomp * cells * isz + 2 * strip_b
    log(f"[bound K4/K5 {tag}] shard {busy}: {n_alive} of {slots} slots alive, "
        f"K4 {out['bytes_k4']} bytes, K5 {out['bytes_k5']} bytes")
    del ebs, rims
    torch.cuda.empty_cache()
    return out


def k5_3d_ms(tag, rims, nloc, specs, iters, busy):
    """K5 3D's launches on one shard's panels ``rims`` (CUDA events around
    ``iters`` calls): the strip cut, the pending adds after the z and y
    exchanges (the shard's own strips standing in for the received ones)
    and the fold with those strips. Returns {"fold": ms, "strips": the
    cut's and the pending adds' ms}."""
    from lambdapic_torch.ops import cellslab
    strip = tuple(sp.size > 1 or sp.periodic for sp in specs)
    cut = cuda_time(lambda: cellslab._fold3_cut(rims, nloc, strip), iters)
    pending = cellslab._fold3_cut(rims, nloc, strip)
    recv = [None if p is None else tuple(t.clone() for t in p)
            for p in pending]
    pends = []
    for ax in (2, 1):
        if strip[ax] and any(strip[:ax]):
            pends.append(cuda_time(
                lambda ax=ax: cellslab._fold3_pend(pending, *recv[ax], ax,
                                                   nloc, strip), iters))
    fold = cuda_time(lambda: cellslab._fold3_mesh(rims, nloc, strip, recv),
                     iters)
    log(f"[time K5 {tag}] cut {cut:.4f} ms, pending adds "
        f"{[round(v, 4) for v in pends]} ms, fold {fold:.4f} ms a call (CUDA "
        f"events), shard {busy}")
    return {"fold": fold, "strips": cut + sum(pends)}


def mesh_rows(tag, nd, launches, errs, t, flops):
    """The kernels line's rows of K4 and K5 (``t`` from dispatch_ms)."""
    k4_ms = sum(v for k, v in t.items() if k.startswith("dispatch"))
    ops_ms = t["alive"] * flops / F32_FLOPS * 1e3
    bound = max(t["bytes_k4"] / HBM_BPS * 1e3, ops_ms)
    k5_ms = t["fold"] + t["strips"]
    sfx = ", 3D" if nd == 3 else ""
    return [
        dict(name=f"K4 B2 mesh dispatches{sfx}", route="cuda",
             source="lambdapic_torch/csrc/" + ("cellstep3d.cu" if nd == 3
                                               else "cellstep.cu"),
             replaces="lambdapic_tpu/ops/cellslab.py:546",
             launches=launches.get("B2", 0), max_abs_err=errs[0], ms=k4_ms,
             timing="events", plain_ms=t["plain"], plain_cells=t["plain_cells"],
             bound_ms=bound,
             bound_by="bytes" if bound > ops_ms else "operations",
             library_ms=None, per="one shard's dispatches of one species"),
        dict(name=f"K5 B3 mesh strips{sfx}", route="cuda",
             source="lambdapic_torch/csrc/" + ("fold3d.cu" if nd == 3
                                               else "fold.cu"),
             replaces="lambdapic_tpu/ops/cellslab.py:2098",
             launches=launches.get("B3", 0), max_abs_err=errs[1], ms=k5_ms,
             timing="events", plain_ms=t["plain_fold"], plain_cells=t["plain_cells"],
             bound_ms=t["bytes_k5"] / HBM_BPS * 1e3, bound_by="bytes",
             library_ms=None,
             per=("one shard's strip cut, pending adds and fold" if nd == 3
                  else "one shard's fold and strip adds")),
    ]


MESH_FIELDS = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz")


def as_double(state):
    """A copy of a SimulationState with every floating tensor in float64
    (on the state's device)."""
    def cast(t):
        return t.double() if t.is_floating_point() else t.clone()
    fl = state.fields
    fields = fl.replace(psi={k: cast(v) for k, v in fl.psi.items()},
                        **{k: cast(getattr(fl, k)) for k in MESH_FIELDS
                           + ("rho",)})
    return state.replace(fields=fields, particles=tuple(
        p.replace(data={k: cast(v) for k, v in p.data.items()})
        for p in state.particles))


_MARK = {}


def mark(tag, what):
    """Log the seconds since the previous mark of ``tag`` (the phase's
    parts, for the script's time budget)."""
    now = time.time()
    log(f"[{tag}] {what}: {now - _MARK.get(tag, now):.1f} s")
    _MARK[tag] = now


def keep_state(sim, laser):
    """(a host copy of the slice's state, its step, time, capacities, a
    copy of its laser); the card is freed of the state."""
    import torch
    _MARK.pop(f"slice mesh {sim.grid.dimension}D", None)
    mark(f"slice mesh {sim.grid.dimension}D", "start")
    keep = (clone_state(sim.state, "cpu"), sim.itime, sim.time,
            list(sim._species_static), copy.deepcopy(laser))
    sim.state = None
    torch.cuda.empty_cache()
    mark(f"slice mesh {sim.grid.dimension}D", "host copy of the state")
    return keep


def drop_state(sim, keep):
    """Free ``sim``'s state and set it back to the kept step, time and
    capacities, with a fresh builder."""
    import torch
    _, itime, now, static, _ = keep
    sim.state = None
    torch.cuda.empty_cache()
    sim.itime, sim.time = itime, now
    sim._species_static = list(static)
    sim._builder = None


def put_back(sim, keep, host):
    """Put ``sim`` (one device) into the kept step, time, capacities and
    the state ``host`` (a host copy), with a fresh builder."""
    drop_state(sim, keep)
    sim.state = clone_state(host, sim.device)


def on_card(host, dev):
    """A kept host state copied to the card whole, so that a mesh twin
    cuts its shards there: slicing each shard's block out of host
    tensors is a strided copy on the host, which took tens of seconds at
    the slices' sizes."""
    return clone_state(host, dev)


def tracked_run(sim, laser, steps, track):
    """``steps`` steps through Simulation.run; after each step whose number
    (1-based) is in ``track`` the fields are copied to the host, and the
    steps between run as one call. Returns {step: fields}."""
    out = {}
    done = 0
    for s in sorted(track):
        if s > done:
            sim.run(s - done, callbacks=[laser])
            done = s
        out[s] = {k: sim.get_field(k) for k in MESH_FIELDS}
    if steps > done:
        sim.run(steps - done, callbacks=[laser])
    return out


def divergence(tag, a, b):
    """Log, at each tracked step, the largest difference of any E, B or J
    component between two tracked runs over that component's peak;
    returns {step: difference}."""
    out = {}
    for s in sorted(a):
        d = 0.0
        for k in MESH_FIELDS:
            peak = float(np.abs(b[s][k]).max())
            if peak:
                d = max(d, float(np.abs(a[s][k] - b[s][k]).max()) / peak)
        out[s] = d
    log(f"[{tag}] max field difference / peak after step: "
        + ", ".join(f"{s} {v:.2e}" for s, v in out.items()))
    return out


def species_totals(sim):
    """Per species (alive count, total weight in float64), over every
    shard."""
    import torch
    out = []
    for ispec in range(len(sim.species)):
        n, w = 0, 0.0
        for sh in sim._shards():
            p = sh.particles[ispec]
            n += int(p.alive.sum())
            w += float(torch.where(p.alive, p.data["w"], 0).sum(
                dtype=torch.float64))
        out.append((n, w))
    return out


def track_steps(steps, window):
    """The tracked steps of a mesh comparison: the first, the last untimed
    one and the last."""
    return tuple(sorted({1, steps - window, steps}))


def b3_mesh_launches(specs):
    """B3's launches a shard and step on a mesh of HaloSpecs ``specs``, by
    kind: in 2D a fold and a strip add a split axis; in 3D a fold, a strip
    cut and a pending add a strip axis (split or periodic) after the
    first (cellslab._fold_reduce_mesh_3d)."""
    if len(specs) == 2:
        return {"fold": 1, "strips": sum(sp.size > 1 for sp in specs),
                "cut": 0, "pend": 0}
    n = sum(sp.size > 1 or sp.periodic for sp in specs)
    return {"fold": 1, "strips": 0, "cut": int(n > 0), "pend": max(n - 1, 0)}


def run_mesh(sim, tag, shape, steps, window, expect, busy_expect, keep):
    """The main path of [slice mesh 2D/3D]: the kept state (``keep``, from
    keep_state) split onto a mesh of ``shape`` on the one card
    (testing.mesh_twin), ``steps`` steps through Simulation.run with the
    launch counters set to 0 just before: the untimed steps first, the
    fields copied to the host after those track_steps names, then the
    last ``window`` timed; launches per step ``expect``, B2 by dispatch and B3
    by launch kind as the mesh implies, finite fields, the peak device
    memory, then a profile of three more steps. Returns (twin, step ms,
    peak GiB, device busy ms, launches, tracked fields, species
    totals)."""
    import torch
    from lambdapic_torch.ops import cellslab
    from lambdapic_torch.testing import mesh_twin
    dev = sim.device
    t0 = time.time()
    nsh = int(np.prod(shape))
    twin = mesh_twin(sim, shape, [dev] * nsh,
                     source=on_card(keep[0], dev))
    log(f"[{tag}] {sim.grid.shape} cells split onto a {shape} mesh of "
        f"{torch.cuda.get_device_name(0)} in {time.time() - t0:.1f} s: "
        f"{twin.npart_alive} particles, shards of {twin.grid.local_shape} "
        "cells")
    mlaser = copy.deepcopy(keep[4])
    reset_launches()
    reset_mesh_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    track = tracked_run(twin, mlaser, steps - window,
                        track_steps(steps, window)[:-1])
    torch.cuda.synchronize()
    t1 = time.time()
    twin.run(window, callbacks=[mlaser])
    torch.cuda.synchronize()
    t2 = time.time()
    peak = torch.cuda.max_memory_allocated() / 2**30
    track[steps] = {k: twin.get_field(k) for k in MESH_FIELDS}
    totals_m = species_totals(twin)
    launches = {k: v for k, v in all_launches().items() if v}
    by_disp = dict(cellslab.cell_step.launches_by_dispatch)
    by_kind = dict(cellslab.fold_reduce.launches_by_kind)
    log(f"[{tag}] {steps} steps: launches {launches}, B2 by dispatch "
        f"{by_disp}, B3 by kind {by_kind}")
    want = {k: v * steps for k, v in expect.items() if v}
    if launches != want:
        fail(f"{tag}: launch counts {launches} != {want}")
    ngroups = 1 + sum(p > 1 for p in shape[1:])
    nspec = len(sim.species)
    want_disp = {"whole": nspec * nsh * steps if ngroups == 1 else 0,
                 "head": nspec * nsh * (ngroups - 1) * steps,
                 "tail": nspec * nsh * steps if ngroups > 1 else 0}
    want_kind = {k: v * nsh * steps
                 for k, v in b3_mesh_launches(twin._builder.specs).items()}
    if by_disp != want_disp or by_kind != want_kind:
        fail(f"{tag}: B2 by dispatch {by_disp} != {want_disp} or B3 by kind "
             f"{by_kind} != {want_kind}")
    step_ms = (t2 - t1) * 1e3 / window
    npart = sum(twin.npart_alive)
    log(f"[{tag}] step {step_ms:.3f} ms (host clock, synchronised, last "
        f"{window} of {steps}), {npart / (step_ms * 1e-3):.4e} pushes/s, "
        f"first {steps - window} steps (fields copied out after each) in "
        f"{t1 - t0:.2f} s; peak device memory {peak:.2f} GiB")
    for i, sh in enumerate(twin.state.shards):
        for k in MESH_FIELDS:
            if not bool(torch.isfinite(getattr(sh.fields, k)).all()):
                fail(f"{tag}: field {k} not finite on shard {i}")
    busy = busy_per_step(lambda: twin.run(1, callbacks=[mlaser]),
                         busy_expect, 3, f"{tag} profile", step_ms)
    return twin, step_ms, peak, busy, launches, track, totals_m


def one_device_tracked(sim, keep, steps, window, tag):
    """The one-device run of ``steps`` steps from the kept state, its
    fields copied out at track_steps; ``sim`` ends without a state, at
    the kept step (drop_state). Returns (tracked fields, species
    totals)."""
    put_back(sim, keep, keep[0])
    track = tracked_run(sim, copy.deepcopy(keep[4]), steps,
                        track_steps(steps, window))
    totals_o = species_totals(sim)
    drop_state(sim, keep)
    return track, totals_o


def check_totals(tag, totals_m, totals_o):
    """The float32 gates of a mesh run against the one-device run: per
    species the total weight within 1e-6 and the alive count within 1e-4.
    Not the float64 gates: shard-local and global float32 coordinates
    round apart, which moves a few particles across a cell face and so
    changes which ones merge (PERF.md §6 has the measured counts, and
    ulp_control the one-device runs' own spread)."""
    for ispec, ((nm, wm), (no, wo)) in enumerate(zip(totals_m, totals_o)):
        log(f"[{tag}] species {ispec}: alive {nm} (mesh) vs {no} (one "
            f"device), weight rel {abs(wm - wo) / abs(wo):.2e}")
        if abs(nm - no) > 1e-4 * no or not abs(wm - wo) <= 1e-6 * abs(wo):
            fail(f"{tag}: species {ispec}: alive {nm} vs {no}, weight {wm} "
                 f"vs {wo}")


def ulp_control(sim, keep, steps, window, tag, otrack, otot):
    """The control of a float32 mesh comparison: the one-device run again
    from the kept state with every particle position moved by one ulp
    (towards +inf), its fields copied out at the same steps. Logs its
    divergence from the unmoved one-device run (``otrack``) and its alive
    counts and weights beside ``otot``: the spread that rounding alone
    gives, which the mesh run's divergence is read against. ``sim`` ends
    without a state, at the kept step (drop_state)."""
    import torch
    put_back(sim, keep, keep[0])
    st = sim.state
    parts = []
    for p in st.particles:
        data = dict(p.data)
        for ax in sim.grid.axes:
            data[ax] = torch.nextafter(data[ax],
                                       data[ax].new_tensor(float("inf")))
        parts.append(p.replace(data=data))
    sim.state = st.replace(particles=tuple(parts))
    del st, parts
    track = tracked_run(sim, copy.deepcopy(keep[4]), steps,
                        track_steps(steps, window))
    totals = species_totals(sim)
    drop_state(sim, keep)
    divergence(f"{tag} control, positions moved one ulp", track, otrack)
    for ispec, ((nc, wc), (no, wo)) in enumerate(zip(totals, otot)):
        log(f"[{tag} control] species {ispec}: alive {nc} (moved) vs {no} "
            f"(one device), weight rel {abs(wc - wo) / abs(wo):.2e}")


def compare_on_mesh(sim, keep, tag, shape, steps):
    """The kept state run ``steps`` steps on the mesh and on one device in
    float64 (the state cast to it), one after the other, the fields of
    every step kept on the host; logs the step-by-step divergence and
    applies compare_mesh_runs's gates to the last step. ``sim`` ends
    without a state, at the kept step (drop_state)."""
    from lambdapic_torch.testing import mesh_twin
    host = as_double(on_card(keep[0], sim.device))
    prec = sim.precision
    sim.precision = "double"
    twin = mesh_twin(sim, shape, [sim.device] * int(np.prod(shape)),
                     source=host)
    every = tuple(sorted({1, steps // 2, steps}))
    mtrack = tracked_run(twin, copy.deepcopy(keep[4]), steps, every)
    mres = mesh_results(twin)
    del twin
    put_back(sim, keep, host)
    otrack = tracked_run(sim, copy.deepcopy(keep[4]), steps, every)
    ores = mesh_results(sim)
    divergence(f"{tag} float64", mtrack, otrack)
    del mtrack, otrack
    compare_mesh_runs(f"{tag} float64", mres, ores, sim.grid)
    sim.precision = prec
    drop_state(sim, keep)


def cut_sim(sim, keep, planes):
    """A one-device twin of ``sim`` on the last ``planes`` x-planes of the
    kept state (its own grid, CPML and zero psi, the same step, time,
    species and laser), and the kept tuple of that cut (on the host)."""
    import torch
    from lambdapic_torch.core.state import zeros_fields
    from lambdapic_torch.ops.cpml import CPMLParams, build_cpml
    state, cgrid = cut_planes(keep[0], sim.grid, planes)
    twin = copy.copy(sim)
    twin.nx = planes
    twin.grid = twin._make_grid()
    twin.cpml = build_cpml(twin.grid, twin.dt,
                           CPMLParams(thickness=twin.cpml_thickness))
    psi = zeros_fields(twin.grid, state.fields.ex.dtype, "cpu",
                       twin.cpml).psi
    state = state.replace(fields=state.fields.replace(psi=psi))
    twin.state = None
    twin._builder = None
    torch.cuda.empty_cache()
    return twin, (state,) + tuple(keep[1:])


def cut_planes(state, grid, planes):
    """The last ``planes`` x-planes of a one-device state (fields and
    every species, x re-based; no psi) with the grid that goes with it."""
    import dataclasses
    x0 = grid.nx - planes
    names = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")
    f = state.fields
    fields = f.replace(psi={}, **{k: getattr(f, k)[x0:].contiguous()
                                  for k in names})
    parts = []
    for p in state.particles:
        data = {k: v[:, x0:].contiguous() for k, v in p.data.items()}
        alive = p.alive[:, x0:].contiguous()
        data["x"] = data["x"] - float(x0)
        parts.append(p.replace(data=data, alive=alive))
    return (state.replace(fields=fields, particles=tuple(parts)),
            dataclasses.replace(grid, nx=planes))


def run_mesh_2d(args, sim, laser):
    """[kernels mesh] (float64 small, float32 at the 2D slice's shards) and
    [slice mesh 2D]: the 2D slice's end state on a 2 x 2 mesh of the one
    card, --steps-mesh steps (launches per step: B2 24 = 3 species x 4
    shards x 2 dispatches, B3 12 = 4 folds + 4 x 2 strip adds; B1 0, the
    mesh's fields being the plain Yee updates, as in the JAX package),
    against the same steps on one device from the same state: in float32
    the alive counts and weights (check_totals; the fields' divergence is
    logged beside ulp_control's, since rounding apart flips a few merges
    that the laser-plasma interaction then amplifies, PERF.md §6), in
    float64 every gate of compare_mesh_runs. K4 and K5 held against their
    plain versions and timed on the busiest 512 x 512 shard
    (check_shard_f32, dispatch_ms). ``sim`` ends in its state from
    before. Returns the K4 and K5 rows."""
    merges = check_mesh_f64(sim.device)
    log(f"[kernels mesh f64] slot-exact in {len(MESH_CASES)} meshes, "
        f"merges in the crowded ones: {merges}")
    tag = "slice mesh 2D"
    shape = (2, 2)
    steps, window = args.steps_mesh, args.window_mesh
    keep = keep_state(sim, laser)
    twin, step_ms, peak, busy, launches, mtrack, mtot = run_mesh(
        sim, tag, shape, steps, window, {"B2": 24, "B3": 12},
        {"rebin2x": 12, "rebin2y": 12, "deposit2": 12, "fold<": 4,
         "strips<": 8}, keep)
    mark(tag, "main path")
    t = dispatch_ms("2D", twin, args.iters)
    cells = list(twin.grid.local_shape)
    errs, k4p, k5p = check_shard_f32("2D 2x2", twin)
    del twin
    t.update(plain=k4p, plain_fold=k5p, plain_cells=cells)
    mark(tag, "kernel checks and times")
    import torch
    put_back(sim, keep, keep[0])
    torch.cuda.synchronize()
    t0 = time.time()
    sim.run(steps, callbacks=[copy.deepcopy(keep[4])])
    torch.cuda.synchronize()
    one_ms = (time.time() - t0) * 1e3 / steps
    log(f"[{tag}] one device from the same state: {one_ms:.3f} ms a step "
        f"(host clock, all {steps} steps)")
    otrack, otot = one_device_tracked(sim, keep, steps, window, tag)
    divergence(f"{tag} float32", mtrack, otrack)
    check_totals(f"{tag} float32", mtot, otot)
    ulp_control(sim, keep, steps, window, f"{tag} float32", otrack, otot)
    del mtrack, otrack
    mark(tag, "float32 comparison")
    compare_on_mesh(sim, keep, tag, shape, steps)
    put_back(sim, keep, keep[0])
    mark(tag, "float64 comparison")
    log(f"[{tag}] summary: mesh {step_ms:.3f} ms a step vs one device "
        f"{one_ms:.3f} ms, device busy {busy} ms a step, peak "
        f"{peak:.2f} GiB")
    return mesh_rows("2D", 2, launches, errs, t, FLOPS_PER_PARTICLE)


def run_mesh_3d(args, sim, laser):
    """[slice mesh 3D] and [kernels mesh f32 3D]: the 3D slice's end
    state on a 2 x 2 x 2 mesh of the one card, --steps-mesh3d steps
    (launches per step: B2 48 = 2 species x 8 shards x 3 dispatches, B3
    32 = 8 folds + 8 strip cuts + 8 x 2 pending adds; B1 0), against the
    same steps on one
    device from a host copy of the state, one run after the other (both
    states need not fit on the card at once): in float32 check_totals and
    the fields' divergence logged beside ulp_control's; every gate of
    compare_mesh_runs in float64 on the last MESH_PLANES_F64 x-planes (a
    float64 state of the whole grid does not fit the card). K4 and K5
    held against their plain versions and timed on the busiest 256 x 128
    x 128 shard (check_shard_f32, dispatch_ms). ``sim`` ends in its state
    from before. Returns the K4 and K5 rows."""
    import torch
    tag = "slice mesh 3D"
    shape = (2, 2, 2)
    steps, window = args.steps_mesh3d, args.window_mesh3d
    keep = keep_state(sim, laser)
    twin, step_ms, peak, busy, launches, mtrack, mtot = run_mesh(
        sim, tag, shape, steps, window, {"B2": 48, "B3": 32},
        {"rebin3": 48, "tail3<": 16, "fold3_pencil": 8, "fold3_cut": 8,
         "fold3_pend": 16}, keep)
    mark(tag, "main path")
    t = dispatch_ms("3D", twin, args.iters3d)
    cells = list(twin.grid.local_shape)
    errs, k4p, k5p = check_shard_f32("3D 2x2x2", twin)
    del twin
    t.update(plain=k4p, plain_fold=k5p, plain_cells=cells)
    mark(tag, "kernel checks and times")
    torch.cuda.empty_cache()
    otrack, otot = one_device_tracked(sim, keep, steps, window, tag)
    divergence(f"{tag} float32", mtrack, otrack)
    check_totals(f"{tag} float32", mtot, otot)
    ulp_control(sim, keep, steps, window, f"{tag} float32", otrack, otot)
    del mtrack, otrack
    mark(tag, "float32 comparison")
    csim, ckeep = cut_sim(sim, keep, MESH_PLANES_F64)
    compare_on_mesh(csim, ckeep, f"{tag} cut {csim.grid.shape}", shape,
                    steps)
    del csim, ckeep
    mark(tag, "float64 comparison")
    put_back(sim, keep, keep[0])
    log(f"[{tag}] summary: mesh {step_ms:.3f} ms a step, device busy "
        f"{busy} ms a step, peak {peak:.2f} GiB")
    return mesh_rows("3D", 3, launches, errs, t, FLOPS_PER_PARTICLE_3D)


# ---------------------------------------------------------------------------
# phases 13 and 14: QED and the per-stage engine on a device mesh (K6, K7)
# ---------------------------------------------------------------------------

# (mesh, slots a cell, cells a shard, periodic faces, crowded) of the
# float64 checks of K6 (B2's want_chi and photon modes in the mesh
# dispatches) and K7 (B6 with the neighbour shards' edge columns)
K6_CASES = [((2, 2), 6, (16, 16), (True, True), True),
            ((2, 2), 4, (17, 16), (False, False), False),
            ((1, 2, 2), 4, (8, 8, 8), (False, True, False), True),
            ((2, 2, 2), 4, (8, 8, 8), (True, False, True), False)]
K7_CASES = [((2, 2), 6, (16, 16), (True, False), True),
            ((4, 2), 4, (8, 12), (False, True), False),
            ((2, 2), 20, (9, 70), (True, True), True),
            ((1, 2, 2), 4, (8, 8, 8), (False, True, False), True),
            ((2, 2, 2), 4, (8, 8, 8), (True, False, True), False)]
# per-stage launches on the mesh paths, for the kernels line's rows
MESH_STAGE_LAUNCHES = {"B6": 0, "B6 3D": 0}
# K6 and K7 measurements by row, filled by the phases
MESH_QED = {}


def mesh_case(shape, cap, nloc, crowded, photon, seed, dev):
    """A float64 state of a case of K6_CASES or K7_CASES on the card:
    (mesh, per-shard (data, alive), per-shard E/B); a radiating
    species' tau, delta and event, or a photon species' inv_gamma = 1/|u|
    (fields strong enough for chi of order 1e-3..1)."""
    import torch
    from lambdapic_torch.testing import mesh_to_torch, random_mesh_cells
    data, alive, eb = random_mesh_cells(
        shape, cap, nloc, seed=seed, crowded=crowded,
        n_frac=0.9 if crowded else 0.4, qed=not photon, umax=50.0,
        field=5e13)
    if photon:
        u2 = data["ux"]**2 + data["uy"]**2 + data["uz"]**2
        data["inv_gamma"] = np.where(u2 > 0, 1 / np.sqrt(np.maximum(
            u2, 1e-30)), 1.0)
    mesh = mesh_of(shape, dev)
    shards = mesh_to_torch(data, alive, mesh, torch.float64)
    ebs = [torch.as_tensor(eb[mesh.coords(i)]).to(dev)
           for i in range(mesh.size)]
    return mesh, shards, ebs


def _dense(ts, shape):
    """Per-shard tensors -> one numpy array under leading mesh axes."""
    return np.stack([t.cpu().numpy() for t in ts]).reshape(
        tuple(shape) + tuple(ts[0].shape))


def check_k6_f64(dev):
    """K6 against its plain version in float64 on the small meshes of
    K6_CASES, both modes: slot for slot after canonicalisation (rtol
    1e-11, the QED payloads exactly, chi 1e-10, ig0 1e-12), merges equal,
    the want_chi panels to 1e-12 of their peak. Returns the largest
    position difference (cells) by dimension."""
    import torch
    from lambdapic_torch.ops.cellslab import (cell_step, cell_step_mesh,
                                              cell_step_plain)
    from lambdapic_torch.parallel.halo import HaloSpec
    from lambdapic_torch.testing import (QED_PAYLOADS, SLOT_FLOATS,
                                         compare_mesh_slots, mesh_to_numpy)
    q, m, dt, dx, g = -1.602e-19, 9.109e-31, 1.1e-16, 5e-8, 3
    errs = {2: 0.0, 3: 0.0}
    for shape, cap, nloc, per, crowded in K6_CASES:
        nd = len(shape)
        for mode in ("want_chi", "photon"):
            photon = mode == "photon"
            mesh, shards, ebs = mesh_case(shape, cap, nloc, crowded,
                                             photon, cap + sum(nloc), dev)
            specs = tuple(HaloSpec(MESH_NAMES[i], shape[i], per[i])
                          for i in range(nd))
            res = [cell_step_mesh(
                None if photon else ebs, [d for d, _ in shards],
                [a for _, a in shards], mesh, specs, q=0.0 if photon else q,
                m=0.0 if photon else m, dt=dt, dx=dx, dy=dx,
                dz=dx if nd == 3 else None, g=g, want_chi=not photon,
                photon=photon, step=step)
                for step in (cell_step, cell_step_plain)]
            torch.cuda.synchronize()
            got, ref = res
            gd, ga = mesh_to_numpy([(r[0], r[1]) for r in got], shape)
            rd, ra = mesh_to_numpy([(r[0], r[1]) for r in ref], shape)
            try:
                compare_mesh_slots(rd, ra, gd, ga, shape, rtol=1e-11,
                                   keys=SLOT_FLOATS)
                if not photon:
                    for d, rs in ((gd, got), (rd, ref)):
                        d["chi_out"] = _dense([r[4][0] for r in rs], shape)
                        d["ig0_out"] = _dense([r[4][1] for r in rs], shape)
                    compare_mesh_slots(rd, ra, gd, ga, shape, rtol=0,
                                       keys=QED_PAYLOADS)
                    compare_mesh_slots(rd, ra, gd, ga, shape, rtol=1e-10,
                                       keys=("chi_out",))
                    compare_mesh_slots(rd, ra, gd, ga, shape, rtol=1e-12,
                                       keys=("ig0_out",))
            except AssertionError as e:
                fail(f"K6 {mode} f64 {shape}: {str(e)[:400]}")
            lg, lr = [int(r[2]) for r in got], [int(r[2]) for r in ref]
            if lg != lr:
                fail(f"K6 {mode} f64 {shape}: merges {lg} vs {lr}")
            if crowded and sum(lr) == 0:
                fail(f"K6 {mode} f64 {shape}: the crowded case merged "
                     "nothing")
            pan = 0.0
            if not photon:
                for a, b in zip(got, ref):
                    pan = max(pan, float((a[3] - b[3]).abs().max())
                              / max(float(b[3].abs().max()), 1e-300))
                if not pan <= 1e-12:
                    fail(f"K6 want_chi f64 {shape}: panels differ by {pan:.3e}"
                         " of their peak")
            err = 0.0
            for (a, al), (b, bl) in zip([(r[0], r[1]) for r in got],
                                        [(r[0], r[1]) for r in ref]):
                if torch.equal(al, bl):
                    err = max([err] + [float((a[k][al] - b[k][bl]).abs().max())
                                       for k in "xyz"[:nd] if bool(al.any())])
            errs[nd] = max(errs[nd], err)
            moved = int(sum(int((gd["id_hi"][c][ga[c]] !=
                                 np.ravel_multi_index(c, shape)).sum())
                            for c in np.ndindex(shape)))
            log(f"[kernels K6 f64 {mode} {shape}] slot-exact; {moved} alive "
                f"slots from another shard; merges {sum(lr)}; positions "
                f"{err:.2e} cells" + ("" if photon else
                                      f"; panels {pan:.2e} of peak"))
    return errs


def check_draws_mesh(twin, proc, dev):
    """The first of the radiating species' uniform draws on shards of a
    mesh run (each key folds the shard's row-major index in), on the card
    and on the CPU: bitwise equal. Every shard in 2D; in 3D the first and
    the last (a shard's draw on the CPU takes seconds at its shape; the
    three draws at the one device's full shape are check_draws')."""
    import torch
    from lambdapic_torch import random as jr
    from lambdapic_torch.models.qed import species_key
    n = twin.mesh.size
    which = range(n) if twin.grid.dimension == 2 else (0, n - 1)
    for i in which:
        sh = twin.state.shards[i]
        shape = tuple(sh.particles[proc.ispec].alive.shape)
        k = jr.split(jr.fold_in(species_key(
            twin._base_key, twin.itime, proc.ispec, i), 101), 3)[0]
        card = jr.uniform(k, shape, twin.dtype, device=dev)
        host = jr.uniform(k, shape, twin.dtype, device="cpu")
        if not torch.equal(card.cpu(), host):
            fail(f"mesh draw of shard {i} at {shape}: "
                 f"{int((card.cpu() != host).sum())} values differ")
    log(f"[draws mesh] the first uniform draw of step {twin.itime} on shards "
        f"{list(which)} of {n} (keys folding the shard index in), "
        f"{twin.dtype}: card and CPU bitwise equal")


def photon_stats(sim, ip):
    """(photons born, sum of w |u| over the alive photons) over every
    shard, float64."""
    import torch
    born, energy = 0, 0.0
    for sh in sim._shards():
        p = sh.particles[ip]
        born += int(p.next_id)
        u = torch.sqrt(sum(p.data[k].double()**2 for k in ("ux", "uy",
                                                           "uz")))
        energy += float(torch.where(p.alive, p.data["w"].double() * u,
                                    0).sum())
    return born, energy


def check_photons_mesh(tag, twin, ip, born0):
    """On every shard whose electrons fired (its next_id advanced past
    ``born0``), alive newborns carry the shard's index as id_hi and
    number from its own next_id; every photon's inv_gamma is 1/|u|."""
    import torch
    fired = 0
    for i, sh in enumerate(twin.state.shards):
        p = sh.particles[ip]
        nb = int(p.next_id) - born0[i]
        if nb <= 0:
            continue
        fired += 1
        lo = p.data["id_lo"].long() & 0xFFFFFFFF
        mine = p.alive & (p.data["id_hi"] == i) & (lo >= born0[i])
        if int(mine.sum()) == 0:
            fail(f"{tag}: shard {i} made {nb} photons, none alive with its "
                 "index as id_hi")
        u = torch.sqrt(sum(p.data[k].double()**2 for k in ("ux", "uy",
                                                           "uz")))
        a = p.alive
        err = float((p.data["inv_gamma"].double()[a] * u[a] - 1).abs().max())
        if not err <= 1e-6:
            fail(f"{tag}: shard {i} photon inv_gamma differs from 1/|u| by "
                 f"{err:.2e}")
    if fired < 2:
        fail(f"{tag}: photons born on {fired} shard(s) only")
    log(f"[{tag}] photons born on {fired} of {twin.mesh.size} shards, each "
        "shard's newborns alive with its index as id_hi; inv_gamma = 1/|u| "
        "within 1e-6")


def check_creation_mesh(tag, twin, proc):
    """One creation phase on its own on the mesh run's shard with the most
    events, after one want_chi step of the radiating species over the
    whole mesh and each shard's event update with its own key: sum w u over electrons and
    photons holds to float32 rounding (the events' sum w delta u moves
    from the electrons to the newborns, less what dropped newborns would
    have carried)."""
    import torch
    from lambdapic_torch.models.qed import species_key
    from lambdapic_torch.ops.cellslab import cell_step_mesh
    b = twin._builder
    grid, st = twin.grid, twin._species_static[proc.ispec]
    shards = twin.state.shards
    eb_pads = b.pad_eb([s.fields for s in shards])
    outs = cell_step_mesh(
        eb_pads, [s.particles[proc.ispec].data for s in shards],
        [s.particles[proc.ispec].alive for s in shards], twin.mesh, b.specs,
        q=st.q, m=st.m, dt=twin.dt, dx=grid.dx, dy=grid.dy,
        dz=grid.dz if grid.dimension == 3 else None, g=grid.n_guard,
        with_rho=b.with_rho, want_chi=True)
    del eb_pads
    # the shard with the most events, each shard's with its own key
    best = None
    for j, o in enumerate(outs):
        key = species_key(twin._base_key, twin.itime, proc.ispec, j)
        d, a = proc.update_events_from_chi(o[0], o[1], key, twin.dt, *o[4])
        n = int((a & (d["event"] > 0)).sum())
        if best is None or n > best[0]:
            best = (n, j, d, a)
    _, i, data, alive = best
    del outs, best
    parts = list(shards[i].particles)
    e = parts[proc.ispec].replace(data=data, alive=alive)
    parts[proc.ispec] = e
    ph = parts[proc.photon_ispec]
    ev = e.alive & (e.data["event"] > 0)
    n_ev = int(ev.sum())
    if n_ev == 0:
        fail(f"{tag}: no event on shard {i}")
    w = torch.where(ev, e.data["w"], 0).double()
    u = [e.data[k].double() for k in ("ux", "uy", "uz")]
    umag = torch.sqrt(sum(c**2 for c in u))
    carried = np.array([float((w * e.data["delta"].double() * c).sum())
                        for c in u])
    scale = float((w * umag).sum())
    newborn_max = float((w * e.data["delta"].double() * umag).max())
    e0, p0 = momentum(e), momentum(ph)
    out = b.local.qed_creation(proc, parts, device_id=i)
    e1, p1 = momentum(out[proc.ispec]), momentum(out[proc.photon_ispec])
    nph = out[proc.photon_ispec]
    dropped = int(nph.overflow) - int(ph.overflow)
    new = nph.alive & ~ph.alive
    tol = 1e-6 * scale
    if not np.abs((e0 - e1) - carried).max() <= tol:
        fail(f"{tag}: electrons lost {e0 - e1}, events carried {carried}")
    if not np.abs((p1 - p0) - carried).max() <= tol + dropped * newborn_max:
        fail(f"{tag}: photons gained {p1 - p0}, events carried {carried}, "
             f"{dropped} newborns dropped")
    if int(new.sum()) != n_ev - dropped:
        fail(f"{tag}: {int(new.sum())} newborn slots for {n_ev} events and "
             f"{dropped} dropped")
    if not bool((nph.data["id_hi"][new] == i).all()):
        fail(f"{tag}: newborns of shard {i} with another id_hi")
    change = float(np.abs((e1 + p1) - (e0 + p0)).max()) / scale
    log(f"[{tag} creation] shard {i}, step {twin.itime}: {n_ev} events, "
        f"{dropped} newborns dropped; newborn id_hi {i}; sum w u over "
        f"electrons + photons changed by {change:.3e} of the events' "
        "sum w |u|")


def k6_rows(nd, t, errs, launches, plain):
    """The kernels line's rows of K6 (``t``: dispatch_ms by mode): the
    launches that ran the mode on the main path; the want_chi row times
    the tail dispatch alone (the heads run the default mode), the photon
    row all of the species' dispatches."""
    rows = []
    flops = {"want_chi": (FLOPS_PER_PARTICLE if nd == 2
                          else FLOPS_PER_PARTICLE_3D) + FLOPS_CHI,
             "photon": FLOPS_PHOTON}
    per = {"want_chi": "one shard's tail dispatch of the radiating species",
           "photon": "one shard's dispatches of the photon species"}
    for mode in ("want_chi", "photon"):
        tm = t[mode]
        if mode == "want_chi":
            ms, nbytes = tm["tail"], tm["bytes_tail"]
        else:
            ms = sum(v for k, v in tm.items() if k.startswith("dispatch"))
            nbytes = tm["bytes_k4"]
        ops_ms = tm["alive"] * flops[mode] / F32_FLOPS * 1e3
        b_ms = nbytes / HBM_BPS * 1e3
        rows.append(dict(
            name=f"K6 B2 {mode} mesh dispatches{', 3D' if nd == 3 else ''}",
            route="cuda", source="lambdapic_torch/csrc/" + (
                "cellstep3d.cu" if nd == 3 else "cellstep.cu"),
            replaces="lambdapic_tpu/ops/cellslab.py:546",
            launches=launches[mode], max_abs_err=errs[mode], ms=ms,
            timing="events", plain_ms=plain[mode], bound_ms=max(b_ms, ops_ms),
            bound_by="bytes" if b_ms >= ops_ms else "operations",
            library_ms=None, per=per[mode] + ", CUDA events"))
    return rows


def mesh_host_copy(twin):
    return [clone_state(sh, "cpu") for sh in twin.state.shards]


def mesh_put(twin, host):
    from lambdapic_torch.core.state import MeshState
    twin.state = MeshState(shards=tuple(
        clone_state(h, d) for h, d in zip(host, twin.mesh.devices)))


def run_qed_mesh(args, sim, laser, shape, steps, window, busy_expect):
    """[slice QED mesh 2D/3D] (phase 13): the QED slice's state (``sim``,
    one device) on a mesh of ``shape`` of the one card, ``steps`` steps
    through Simulation.run with the launch counters set to 0 just before
    (B2 a species, shard and dispatch, counted by the mode it ran:
    want_chi on the radiating electrons' tail and default on their heads,
    default for the protons, photon on every dispatch of the photons; B3
    as b3_mesh_launches counts it a shard), the last ``window`` timed,
    then a profile; gates: the draws per shard against the CPU, photons
    born on the shards that fired with their index as id_hi, inv_gamma =
    1/|u|, one creation phase's sum w u; K6 held against its plain version
    in float32 and timed on the busiest shard; the same steps on one
    device from the same state: photons born within 5 sqrt(N), their sum
    w |u| within 15%. ``sim`` ends in its state from before. Returns the
    K6 rows."""
    import torch
    from lambdapic_torch.ops import cellslab
    from lambdapic_torch.testing import mesh_twin
    nd = len(shape)
    tag = f"slice QED mesh {nd}D"
    dev = sim.device
    nsh = int(np.prod(shape))
    proc = sim._qed_processes[0]
    ie, ip = proc.ispec, proc.photon_ispec
    keep = keep_state(sim, laser)
    _MARK[tag] = time.time()
    twin = mesh_twin(sim, shape, [dev] * nsh,
                     source=on_card(keep[0], dev))
    log(f"[{tag}] {sim.grid.shape} cells at step {twin.itime} split onto a "
        f"{shape} mesh of {torch.cuda.get_device_name(0)}: "
        f"{twin.npart_alive} particles, shards of {twin.grid.local_shape} "
        "cells")
    check_draws_mesh(twin, proc, dev)
    born0 = [int(sh.particles[ip].next_id) for sh in twin.state.shards]
    b0, e0 = photon_stats(twin, ip)
    mlaser = copy.deepcopy(keep[4])
    reset_launches()
    reset_mesh_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    twin.run(steps - window, callbacks=[mlaser])
    torch.cuda.synchronize()
    t1 = time.time()
    twin.run(window, callbacks=[mlaser])
    torch.cuda.synchronize()
    t2 = time.time()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ngroups = 1 + sum(p > 1 for p in shape[1:])
    nspec = len(sim.species)
    by_mode = dict(cellslab.cell_step.launches_by_mode)
    by_disp = dict(cellslab.cell_step.launches_by_dispatch)
    # by the mode each launch ran: want_chi on the radiating electrons'
    # tail only (their heads run the default mode), photon on every
    # dispatch of the photons, default on every other
    got = check_launches(tag, steps, {
        "B2": nspec * nsh * ngroups,
        "B3": nsh * sum(b3_mesh_launches(twin._builder.specs).values())},
                         into={}, by_mode={
                             "want_chi": nsh, "photon": nsh * ngroups,
                             "default": nsh * (nspec - 2) * ngroups
                             + nsh * (ngroups - 1)})
    want_disp = {"whole": 0, "head": nspec * nsh * (ngroups - 1) * steps,
                 "tail": nspec * nsh * steps}
    log(f"[{tag}] B2 by dispatch {by_disp}")
    if by_disp != want_disp:
        fail(f"{tag}: B2 by dispatch {by_disp} != {want_disp}")
    for i, sh in enumerate(twin.state.shards):
        for k in MESH_FIELDS:
            if not bool(torch.isfinite(getattr(sh.fields, k)).all()):
                fail(f"{tag}: field {k} not finite on shard {i}")
    check_photons_mesh(tag, twin, ip, born0)
    b1, e1 = photon_stats(twin, ip)
    step_ms = (t2 - t1) * 1e3 / window
    npart = sum(twin.npart_alive)
    log(f"[{tag}] {steps} steps to step {twin.itime}: step {step_ms:.3f} ms "
        f"(host clock, synchronised, last {window}), {npart / (step_ms * 1e-3):.4e} "
        f"pushes/s; photons born {b1 - b0}; peak device memory {peak:.2f} "
        f"GiB; slots {[p.cap for p in twin.state.shards[0].particles]}")
    busy = busy_per_step(lambda: twin.run(1, callbacks=[mlaser]),
                         busy_expect, 1, f"{tag} profile", step_ms)
    check_creation_mesh(tag, twin, proc)
    mark(tag, "main path and gates")
    # -- K6 on the busiest shard: times, then float32 against the plain -----
    host = mesh_host_copy(twin)
    t = {m: dispatch_ms(f"{nd}D {m}", twin, args.iters if nd == 2
                        else args.iters3d, ispec=i_, mode=m)
         for m, i_ in (("want_chi", ie), ("photon", ip))}
    errs, plain = {}, {}
    for m, i_ in (("want_chi", ie), ("photon", ip)):
        mesh_put(twin, host)
        (err, _), plain[m], _ = check_shard_f32(f"{nd}D QED {m}", twin,
                                                ispec=i_, mode=m)
        errs[m] = err
    del twin, host
    torch.cuda.empty_cache()
    mark(tag, "K6 checks and times")
    # -- the same steps on one device from the same state ---------------------
    put_back(sim, keep, keep[0])
    ob0, oe0 = photon_stats(sim, ip)
    sim.run(steps, callbacks=[copy.deepcopy(keep[4])])
    ob1, oe1 = photon_stats(sim, ip)
    nm, no = b1 - b0, ob1 - ob0
    em, eo = e1 - e0, oe1 - oe0
    log(f"[{tag}] against one device from the same state: photons born "
        f"{nm} (mesh) vs {no}, their sum w|u| grew {em:.6e} vs {eo:.6e}")
    if not abs(nm - no) <= 5 * np.sqrt(max(nm, no, 1)):
        fail(f"{tag}: photons born {nm} on the mesh vs {no} on one device")
    if not abs(em - eo) <= 0.15 * abs(eo):
        fail(f"{tag}: emitted energy {em} on the mesh vs {eo} on one device")
    put_back(sim, keep, keep[0])
    mark(tag, "one-device comparison")
    log(f"[{tag}] summary: mesh {step_ms:.3f} ms a step, device busy {busy} "
        f"ms a step, peak {peak:.2f} GiB")
    launches = {m: by_mode[m] for m in ("want_chi", "photon")}
    MESH_QED[f"qed{nd}"] = dict(step_ms=step_ms, busy=busy, peak=peak)
    return k6_rows(nd, t, errs, launches, plain)


def check_k7_f64(dev):
    """K7 (B6 with the neighbours' edge columns, driven across the mesh by
    migrate_cells_mesh) against its plain version in float64 on the small
    meshes of K7_CASES (open and periodic faces), for a species that
    recomputes inv_gamma and for a photon species that carries it, after
    a shift of every alive particle by up to 0.9 of a cell along each
    axis: every array bitwise equal, merges equal. Returns the merges."""
    import torch
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import migrate_cells
    from lambdapic_torch.parallel.halo import HaloSpec
    merges = []
    for shape, cap, nloc, per, crowded in K7_CASES:
        nd = len(shape)
        for photon in (False, True):
            mesh, shards, _ = mesh_case(shape, cap, nloc, crowded, photon,
                                           2 * cap + sum(nloc), dev)
            specs = tuple(HaloSpec(MESH_NAMES[i], shape[i], per[i])
                          for i in range(nd))
            gen = torch.Generator(device="cpu").manual_seed(cap + nd)
            datas = []
            for d, a in shards:
                d = dict(d)
                for ax in "xyz"[:nd]:
                    if ax == "x" and crowded:
                        continue
                    shift = (torch.rand(a.shape, generator=gen,
                                        dtype=torch.float64) * 1.8 - 0.9)
                    d[ax] = torch.where(a, d[ax] + shift.to(dev), 0.0)
                datas.append(d)
            alives = [a for _, a in shards]
            kw = dict(recompute_ig=not photon)
            got = cp.migrate_cells_mesh(datas, alives, mesh, specs, **kw)
            ref = cp.migrate_cells_mesh(datas, alives, mesh, specs,
                                        scheme=migrate_cells, **kw)
            torch.cuda.synchronize()
            for i, (g_, r_) in enumerate(zip(got, ref)):
                same = torch.equal(g_[1], r_[1]) and \
                    sorted(g_[0]) == sorted(r_[0]) and \
                    all(torch.equal(g_[0][k], r_[0][k]) for k in r_[0])
                if not same or int(g_[2]) != int(r_[2]):
                    fail(f"K7 f64 {shape} photon {photon}: shard {i} "
                         "differs from the plain version")
            n_m = sum(int(r_[2]) for r_ in ref)
            moved = sum(int((r_[0]["id_hi"][r_[1]] != i).sum())
                        for i, r_ in enumerate(ref))
            if crowded and not photon and n_m == 0:
                fail(f"K7 f64 {shape}: the crowded case merged nothing")
            merges.append(n_m)
            log(f"[kernels K7 f64 {shape} periodic {per} photon {photon}] "
                f"bitwise equal on {mesh.size} shards; {moved} alive slots "
                f"from another shard; merges {n_m}")
    return merges


def k7_same(tag, axis, i, got, ref):
    """Fail unless one B6 launch's output ``got`` equals its plain
    version's ``ref`` on the same input: alive masks, merges and payload
    names equal, every payload bitwise equal on the alive slots. Returns
    the largest difference of a float payload there."""
    import torch
    a = got[1]
    if not (torch.equal(a, ref[1]) and int(got[2]) == int(ref[2])
            and sorted(got[0]) == sorted(ref[0])):
        fail(f"K7 {tag} float32 axis {axis}: shard {i}'s alive mask, "
             "merges or payload names differ from the plain version")
    err = 0.0
    for k in ref[0]:
        g_, r_ = got[0][k][a], ref[0][k][a]
        if g_.is_floating_point() and g_.numel():
            err = max(err, float((g_ - r_).abs().max()))
        if not torch.equal(g_, r_):
            fail(f"K7 {tag} float32 axis {axis}: shard {i}'s {k} differs "
                 f"from the plain version on its alive slots (by {err:.3e})")
    return err


def check_k7_f32(tag, twin, iters, ispec=0):
    """K7 against its plain version in float32 at a mesh run's shard
    shapes, on species ``ispec`` of ``twin``: the first half push on every
    shard and a seeded shift of every alive particle by up to 0.9 cells
    along each axis, then the re-binning across the mesh axis by axis as
    migrate_cells_mesh runs it: on every shard the axis's B6 launch with
    the neighbours' edge columns (its output is the next axis's input) and
    its plain version (cell2d.migrate_cells) on the same input, held equal
    by k7_same (bitwise on the alive slots). Each axis's launch on the
    busiest shard timed (kernel_ms: CUDA events, or the profiler's device
    time where the host's issue takes half the call), its plain version
    once, and its
    bound (the mask and the carried payloads of every slot read and
    written once, the two edge columns read once). Returns (the largest
    payload difference measured, ms, plain ms, bytes, how ms was taken)."""
    import torch
    from lambdapic_torch.constants import c as c_light
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import TRANSIENT, migrate_cells
    from lambdapic_torch.ops.cellslab import edge_columns
    from lambdapic_torch.ops.pusher import push_position_2d, push_position_3d
    grid, mesh, specs = twin.grid, twin.mesh, twin._builder.specs
    nd = grid.dimension
    axes = grid.axes
    moms = ("ux", "uy", "uz")[:nd]
    h = [c_light * twin.dt / d / 2 for d in grid.deltas]
    push = push_position_3d if nd == 3 else push_position_2d
    datas, alives = [], []
    gen = torch.Generator(device=mesh.devices[0]).manual_seed(7)
    for sh in twin.state.shards:
        p = sh.particles[ispec]
        d = dict(p.data)
        d.update(zip(axes, push(*(d[a] for a in axes), *(d[k] for k in moms),
                                d["inv_gamma"], *h)))
        # a shift of up to 0.9 cells along every axis, so that the compared
        # re-binning moves particles whatever the run's depth
        for a in axes:
            shift = torch.rand(p.alive.shape, generator=gen,
                               device=p.alive.device, dtype=d[a].dtype)
            d[a] = torch.where(p.alive, d[a] + (shift * 1.8 - 0.9), d[a])
        datas.append(d)
        alives.append(p.alive)
    busy = int(np.argmax([int(a.sum()) for a in alives]))
    names = tuple(sorted(k for k in datas[0] if k not in TRANSIENT))
    pay = sum(datas[0][k].element_size() for k in names)
    cur, cur_alive = list(datas), list(alives)
    ms = plain_ms = err = 0.0
    nbytes = 0
    split = ""
    methods = []
    for axis in range(nd):
        spec = specs[axis]
        edges = edge_columns(cur, cur_alive, names, axis, spec, mesh) \
            if spec.size > 1 else None
        n_ax = cur_alive[0].shape[1 + axis]
        plan = ((n_ax, spec.periodic, axes[axis]),)
        finish = axis == nd - 1

        def run(fn, i):
            return fn(cur[i], cur_alive[i], plan,
                      edges=None if edges is None else {axis: edges[i]},
                      finish=finish)
        # one B6 launch a call: CUDA events, or the profiler's device time
        # where the host's issue takes over half of the call (kernel_ms)
        dev_ms, wall = kernel_ms(lambda: run(cp.migrate_cells_fused, busy),
                                 iters, "K7")
        wall = dev_ms or wall
        methods.append(kernel_ms.method)
        ms += wall
        plain_ms += cuda_time(lambda: run(migrate_cells, busy), 1)
        slots = cur_alive[busy].numel()
        nbytes += 2 * slots * (1 + pay) + (
            2 * (slots // n_ax) * (4 + pay) if edges is not None else 0)
        split += (f" axis {axis}: {wall:.4f} ms ({kernel_ms.method})"
                  f"{' with edges' if edges is not None else ''};")
        outs = []
        for i in range(mesh.size):
            outs.append(run(cp.migrate_cells_fused, i))
            err = max(err, k7_same(tag, axis, i, outs[-1],
                                   run(migrate_cells, i)))
        cur = [{**d, **o[0]} for d, o in zip(cur, outs)]
        cur_alive = [o[1] for o in outs]
        del outs, edges
        torch.cuda.empty_cache()
    moved = sum(int((a != b).sum()) for a, b in zip(cur_alive, alives))
    if moved == 0:
        fail(f"K7 {tag} float32: the compared re-binning moved nothing")
    log(f"[kernels K7 f32 {tag}] every launch on every shard equal to its "
        f"plain version on the same input (alive masks, merges, every "
        f"payload on the alive slots; largest difference {err:.3e}), "
        f"{moved} slots changed occupancy; busiest shard {busy} of "
        f"{mesh.size}, {tuple(alives[busy].shape)} slots:{split} plain "
        f"{plain_ms:.2f} ms; bound {nbytes} bytes = "
        f"{nbytes / HBM_BPS * 1e3:.5f} ms; a launch {ms / nd:.4f} ms, bound "
        f"{nbytes / HBM_BPS * 1e3 / nd:.5f} ms")
    del cur, cur_alive, datas
    torch.cuda.empty_cache()
    return err, ms, plain_ms, nbytes, timing(*methods)


def k7_row(nd, err, ms, plain, nbytes, how, launches, per_step):
    """The kernels line's K7 row: ms, plain_ms and bound_ms of one shard's
    nd axes (one launch each) of one species, and ms_launch and
    bound_ms_launch their mean a launch, beside the launches on the main
    path; logs what a step loses against the bound at ``per_step``
    launches a step."""
    bound = nbytes / HBM_BPS * 1e3
    log(f"[K7 {nd}D] a launch {ms / nd:.4f} ms (one shard's {nd} axes "
        f"{ms:.4f} ms), bound {bound / nd:.5f} ms; {per_step} launches a "
        f"step x (ms - bound) = {per_step * (ms - bound) / nd:.3f} ms a step")
    return dict(
        name=f"K7 B6 mesh strips{', 3D' if nd == 3 else ' 2D'}",
        route="cuda", source="lambdapic_torch/csrc/migrate.cu",
        replaces="lambdapic_tpu/ops/cellpallas.py:860", launches=launches,
        max_abs_err=err, ms=ms, timing=how, plain_ms=plain,
        bound_ms=bound, bound_by="bytes", library_ms=None,
        per="one shard's axes of one species", ms_launch=ms / nd,
        bound_ms_launch=bound / nd)


def clone_mesh(st):
    return st.replace(shards=tuple(clone_state(sh) for sh in st.shards))


def split_vs_fused_mesh(twin, laser, hook, tag):
    """One split mesh step (``hook`` due) against one fused mesh step from
    a cloned state, shard by shard (check_split_fused: alive masks, ids
    and merges equal, values within rtol 1e-5, J within 1e-5 of its
    peak); the run goes on from the fused step."""
    import torch
    recap, twin.recap_interval = twin.recap_interval, 0
    saved, itime, t_sim = clone_mesh(twin.state), twin.itime, twin.time
    twin.run(1, callbacks=[laser, hook])
    split = twin.state
    twin.state, twin.itime, twin.time = saved, itime, t_sim
    twin.run(1, callbacks=[laser])
    fused = twin.state
    twin.recap_interval = recap
    torch.cuda.synchronize()
    worst = jerr = 0.0
    for i, (s, f) in enumerate(zip(split.shards, fused.shards)):
        w, j = check_split_fused(f"{tag}: split vs fused, shard {i}", s, f,
                                 ("jx", "jy", "jz"))
        worst, jerr = max(worst, w), max(jerr, j)
    log(f"[{tag}] one split mesh step vs one fused mesh step from step "
        f"{itime}: alive masks, ids and merges equal on every shard; values "
        f"within rtol 1e-5 (largest {worst:.3e}); J within {jerr:.2e} of its "
        "peak")
    del split, saved
    torch.cuda.empty_cache()


def timed_mesh_run(tag, twin, cbs, steps, window, per_step, busy_expect):
    """``steps`` steps of a mesh run through Simulation.run with the launch
    counters set to 0 just before, the last ``window`` timed; launches
    checked against ``per_step``; finite fields; then a profile of one
    step (these steps issue tens of thousands of plain-torch launches,
    whose profiles take long to gather). Returns (step ms, busy ms, peak
    GiB, launches)."""
    import torch
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    if steps > window:
        twin.run(steps - window, callbacks=cbs)
    torch.cuda.synchronize()
    t1 = time.time()
    twin.run(window, callbacks=cbs)
    torch.cuda.synchronize()
    t2 = time.time()
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = check_launches(tag, steps, per_step, into={})
    for i, sh in enumerate(twin.state.shards):
        for k in MESH_FIELDS:
            if not bool(torch.isfinite(getattr(sh.fields, k)).all()):
                fail(f"{tag}: field {k} not finite on shard {i}")
    step_ms = (t2 - t1) * 1e3 / window
    npart = sum(twin.npart_alive)
    log(f"[{tag}] {steps} steps to step {twin.itime} in {t2 - t0:.2f} s: "
        f"step {step_ms:.3f} ms (host clock, synchronised, last {window}), "
        f"{npart / (step_ms * 1e-3):.4e} pushes/s; peak device memory "
        f"{peak:.2f} GiB")
    busy = busy_per_step(lambda: twin.run(1, callbacks=cbs), busy_expect, 1,
                         f"{tag} profile", step_ms)
    return step_ms, busy, peak, got


def run_stages_mesh_2d(args, sim, laser):
    """Phase 14 in 2D: K7 against its plain version in float64 on small
    meshes; [slice split mesh 2D]: the 2D slice's end state on a 2 x 2
    mesh of the one card, one split step held against one fused step from
    a cloned state, then --steps-split-mesh split steps (a host callback
    at _push_momentum; launches per step B6 24 = 3 species x 4 shards x 2
    axes, B5 12; B1 0) timed and profiled, K7 in float32 at those shards
    and timed; [slice exact mesh 2D]: the same state with
    cell_migration="exact" for --steps-exact-mesh steps (B4 12, B5 12),
    then float64 twins of the mesh and one-device runs from that state
    under compare_mesh_runs's gates (ids, positions within 1e-4 cells,
    momenta rtol 1e-4, fields). ``sim`` ends in its state from before.
    Returns the K7 2D row."""
    import torch
    from lambdapic_torch import callback
    from lambdapic_torch.testing import mesh_twin
    merges = check_k7_f64(sim.device)
    log(f"[kernels K7 f64] bitwise in {2 * len(K7_CASES)} cases; merges "
        f"{merges}")
    dev, shape = sim.device, (2, 2)
    tag = "slice split mesh 2D"
    keep = keep_state(sim, laser)
    _MARK[tag] = time.time()
    twin = mesh_twin(sim, shape, [dev] * 4, source=on_card(keep[0], dev))
    mlaser = copy.deepcopy(keep[4])
    hook = callback(stage="_push_momentum")(lambda s: None)
    split_vs_fused_mesh(twin, mlaser, hook, tag)
    n = args.steps_split_mesh
    step_ms, busy, peak, got = timed_mesh_run(
        tag, twin, [mlaser, hook], n, n, {"B5": 12, "B6": 24},
        {"migrate_tile": 24, "deposit<": 12})
    MESH_STAGE_LAUNCHES["B6"] += got["B6"]
    k7 = check_k7_f32("2D 2x2", twin, args.iters)
    del twin
    torch.cuda.empty_cache()
    mark(tag, "split steps and K7")
    MESH_QED["split2"] = dict(step_ms=step_ms, busy=busy, peak=peak)
    # -- the exact re-binning on the mesh ----------------------------------------
    tag = "slice exact mesh 2D"
    _MARK[tag] = time.time()
    sim.cell_migration = "exact"
    twin = mesh_twin(sim, shape, [dev] * 4, source=on_card(keep[0], dev))
    n = args.steps_exact_mesh
    e_ms, e_busy, e_peak, _ = timed_mesh_run(
        tag, twin, [copy.deepcopy(keep[4])], n, min(n, 10),
        {"B4": 12, "B5": 12}, {"push<": 12, "deposit<": 12})
    del twin
    torch.cuda.empty_cache()
    MESH_QED["exact2"] = dict(step_ms=e_ms, busy=e_busy, peak=e_peak)
    # the float64 twins on the last half of the x-planes (the foil's
    # side), as the 3D mesh phase cuts its own
    csim, ckeep = cut_sim(sim, keep, sim.grid.nx // 2)
    compare_on_mesh(csim, ckeep, f"{tag} cut {csim.grid.shape}", shape, n)
    del csim, ckeep
    sim.cell_migration = "fast"
    put_back(sim, keep, keep[0])
    mark(tag, "exact steps and float64 comparison")
    log(f"[slice stages mesh 2D] summary: split {step_ms:.3f} ms a step "
        f"(busy {busy}), exact {e_ms:.3f} ms (busy {e_busy}), peak "
        f"{max(peak, e_peak):.2f} GiB")
    return [k7_row(2, *k7, MESH_STAGE_LAUNCHES["B6"], 24)]


def run_stages_mesh_3d(args, sim, laser):
    """Phase 14 in 3D: [slice split mesh 3D]: the 3D slice's end state on
    a 2 x 2 x 2 mesh of the one card for --steps-split-mesh3d split steps
    (launches per step B6 48 = 2 species x 8 shards x 3 axes, B5 3D 16),
    timed and profiled; K7 in float32 at those shards (check_k7_f32) and
    timed on the busiest. ``sim`` ends in its
    state from before. Returns the K7 3D row."""
    import torch
    from lambdapic_torch import callback
    from lambdapic_torch.testing import mesh_twin
    tag = "slice split mesh 3D"
    dev, shape = sim.device, (2, 2, 2)
    keep = keep_state(sim, laser)
    _MARK[tag] = time.time()
    twin = mesh_twin(sim, shape, [dev] * 8, source=on_card(keep[0], dev))
    hook = callback(stage="_push_momentum")(lambda s: None)
    n = args.steps_split_mesh3d
    step_ms, busy, peak, got = timed_mesh_run(
        tag, twin, [copy.deepcopy(keep[4]), hook], n, n,
        {"B5 3D": 16, "B6": 48}, {"migrate_tile": 48, "deposit3d": 16})
    MESH_STAGE_LAUNCHES["B6 3D"] += got["B6"]
    k7 = check_k7_f32("3D 2x2x2", twin, args.iters3d)
    del twin
    torch.cuda.empty_cache()
    put_back(sim, keep, keep[0])
    mark(tag, "split steps and K7")
    MESH_QED["split3"] = dict(step_ms=step_ms, busy=busy, peak=peak)
    return [k7_row(3, *k7, MESH_STAGE_LAUNCHES["B6 3D"], 48)]


def run_exact_qed_mesh_3d(args, sim, laser):
    """[slice exact QED mesh 3D] (phase 14): the exact 3D QED phase's end
    state on a 2 x 2 x 2 mesh of the one card, --steps-exact-qed-mesh3d
    steps through Simulation3D.run (launches per step B4 3D 16 = 2 charged
    species x 8 shards, 8 of them want_eb for the radiating electrons, B5
    3D 16; photons re-bin exactly and deposit nothing), its peak memory;
    photons born on the shards that fired, with their index as id_hi.
    ``sim`` ends without a state."""
    import torch
    from lambdapic_torch.testing import mesh_twin
    tag = "slice exact QED mesh 3D"
    dev, shape = sim.device, (2, 2, 2)
    ip = sim._qed_processes[0].photon_ispec
    _MARK[tag] = time.time()
    # the phase's end state is not used again: sharded on the card, freed
    twin = mesh_twin(sim, shape, [dev] * 8)
    sim.state = None
    torch.cuda.empty_cache()
    born0 = [int(sh.particles[ip].next_id) for sh in twin.state.shards]
    n = args.steps_exact_qed_mesh3d
    step_ms, busy, peak, _ = timed_mesh_run(
        tag, twin, [copy.deepcopy(laser)], n, n,
        {"B4 3D": 16, "B4 3D want_eb": 8, "B5 3D": 16},
        {"push3d": 16, "deposit3d": 16})
    check_photons_mesh(tag, twin, ip, born0)
    del twin
    torch.cuda.empty_cache()
    mark(tag, "exact QED mesh steps")
    MESH_QED["exactqed3"] = dict(step_ms=step_ms, busy=busy, peak=peak)


def timed(name, fn):
    def wrapper(*a, **kw):
        t0 = time.time()
        try:
            return fn(*a, **kw)
        finally:
            sec, n = TIMERS.get(name, (0.0, 0))
            TIMERS[name] = (sec + time.time() - t0, n + 1)
    return wrapper


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2001,
                    help="2D slice steps through Simulation.run (the example "
                         "runs 2001)")
    ap.add_argument("--window", type=int, default=200,
                    help="final 2D steps timed as the steady window")
    ap.add_argument("--steps-qed", type=int, default=400,
                    help="QED slice steps through Simulation.run (the "
                         "example runs 100 fs, 1115 steps; photons appear "
                         "by step ~112)")
    ap.add_argument("--window-qed", type=int, default=100,
                    help="final QED steps timed as the steady window")
    ap.add_argument("--steps3d", type=int, default=STEPS_3D,
                    help="3D slice steps through Simulation3D.run (the "
                         "example runs 1001; cut to pay for the mesh "
                         "phases)")
    ap.add_argument("--window3d", type=int, default=20,
                    help="final 3D steps timed as the steady window")
    ap.add_argument("--steps-exact", type=int, default=101,
                    help="steps of the 2D slice with cell_migration='exact' "
                         "(the example runs 2001; cut to keep the script's "
                         "time with the 3D per-stage and 3D QED phases)")
    ap.add_argument("--window-exact", type=int, default=50,
                    help="final exact steps timed as the steady window")
    ap.add_argument("--steps-exact-qed", type=int, default=200,
                    help="steps of the QED slice with cell_migration='exact'")
    ap.add_argument("--steps-split", type=int, default=20,
                    help="split steps (a host callback at _push_momentum) "
                         "continuing the 2D slice")
    ap.add_argument("--steps-split-sort", type=int, default=10,
                    help="split steps with LAMBDAPIC_MIG_FUSED=0 (kernel B7)")
    ap.add_argument("--steps-split3d", type=int, default=3,
                    help="split steps (a host callback at _push_momentum) "
                         "continuing the 3D slice")
    ap.add_argument("--steps-split-sort3d", type=int, default=1,
                    help="3D split steps with LAMBDAPIC_MIG_FUSED=0 (B7)")
    ap.add_argument("--steps-exact3d", type=int, default=10,
                    help="steps of the 3D slice with cell_migration='exact'")
    ap.add_argument("--window-exact3d", type=int, default=5,
                    help="final exact 3D steps timed as the steady window")
    ap.add_argument("--steps-qed3d", type=int, default=200,
                    help="3D QED slice steps through Simulation3D.run "
                         "(example/photons.py's 100 fs are 966 steps here; "
                         "cut to pay for the mesh phases)")
    ap.add_argument("--window-qed3d", type=int, default=50,
                    help="final 3D QED steps timed as the steady window")
    ap.add_argument("--steps-split-qed3d", type=int, default=5,
                    help="split steps (a host callback at _push_momentum) "
                         "continuing the 3D QED slice")
    ap.add_argument("--steps-exact-qed3d", type=int, default=10,
                    help="steps of the 3D QED slice with "
                         "cell_migration='exact' after its first photon")
    ap.add_argument("--steps-tiled", type=int, default=400,
                    help="steps of bench.py's --tiling 32,32 laser-target "
                         "through Simulation.run (the laser front reaches "
                         "the target near step 380)")
    ap.add_argument("--window-tiled", type=int, default=50,
                    help="final tiled steps timed as the steady window")
    ap.add_argument("--steps-tiled-qed", type=int, default=200,
                    help="steps of bench.py's qed configuration in its "
                         "--tiling 32,32 form at 256^2")
    ap.add_argument("--steps-mesh", type=int, default=20,
                    help="steps of the 2D slice's end state on a 2 x 2 mesh "
                         "of the card, and on one device")
    ap.add_argument("--window-mesh", type=int, default=10,
                    help="final 2D mesh steps timed")
    ap.add_argument("--steps-mesh3d", type=int, default=6,
                    help="steps of the 3D slice's end state on a 2 x 2 x 2 "
                         "mesh of the card, and on one device")
    ap.add_argument("--window-mesh3d", type=int, default=3,
                    help="final 3D mesh steps timed")
    ap.add_argument("--steps-qed-mesh", type=int, default=30,
                    help="steps of the QED slice's end state on a 2 x 2 "
                         "mesh of the card, and on one device")
    ap.add_argument("--window-qed-mesh", type=int, default=10,
                    help="final QED mesh steps timed")
    ap.add_argument("--steps-qed-mesh3d", type=int, default=5,
                    help="steps of the 3D QED slice's end state on a "
                         "2 x 2 x 2 mesh, all timed, and on one device")
    ap.add_argument("--steps-split-mesh", type=int, default=10,
                    help="split steps of the 2D slice's end state on a "
                         "2 x 2 mesh")
    ap.add_argument("--steps-exact-mesh", type=int, default=10,
                    help="steps of the 2D slice's end state on a 2 x 2 mesh "
                         "with cell_migration='exact' (and of its float64 "
                         "twins on the mesh and on one device)")
    ap.add_argument("--steps-split-mesh3d", type=int, default=2,
                    help="split steps of the 3D slice's end state on a "
                         "2 x 2 x 2 mesh")
    ap.add_argument("--steps-exact-qed-mesh3d", type=int, default=5,
                    help="steps of the exact 3D QED phase's end state on a "
                         "2 x 2 x 2 mesh")
    ap.add_argument("--exact2d-digest", type=int, default=0, metavar="N",
                    help="run only the 2D slice with cell_migration='exact' "
                         "for N steps and print its peak device memory and "
                         "a digest of its final state, then stop")
    ap.add_argument("--iters", type=int, default=50,
                    help="launches per 2D kernel timing")
    ap.add_argument("--iters3d", type=int, default=5,
                    help="launches per 3D kernel timing")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    if args.exact2d_digest:
        exact2d_digest(args.exact2d_digest, dev)
        return 0
    t_start = time.time()
    from lambdapic_torch import testing
    mod = sys.modules[__name__]
    for name in ("device_times", "cuda_time", "keep_state", "put_back",
                 "compare_on_mesh", "check_shard_f32", "dispatch_ms"):
        setattr(mod, name, timed(name, getattr(mod, name)))
    testing.mesh_twin = timed("mesh_twin", testing.mesh_twin)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    kernels = []

    def done(what):
        torch.cuda.empty_cache()
        log(f"[time] {what} done at {time.time() - t_start:.1f} s")
    kernels += run_2d(args, dev)
    done("2D and split")
    kernels += run_tiled(args, dev)
    done("tiled")
    run_tiled_qed(args, dev)
    done("tiled QED")
    run_exact(args, dev)
    done("exact")
    run_exact_qed(args, dev)
    done("exact QED")
    kernels += stage_rows()
    kernels += run_qed(args, dev)
    done("QED")
    k3, sim3, laser3, fill = run_3d(args, dev)
    kernels += k3
    done("3D")
    kernels += run_mesh_3d(args, sim3, laser3)
    done("mesh 3D")
    run_split_3d(args, sim3, laser3)
    done("split 3D")
    kernels += run_stages_mesh_3d(args, sim3, laser3)
    done("split mesh 3D")
    run_exact_3d(args, dev, sim3, fill)
    del sim3, fill
    done("exact 3D")
    run_bigcap(dev)
    done("bigcap")
    k3, simq, laserq = run_qed_3d(args, dev)
    kernels += k3
    done("QED 3D")
    kernels += run_qed_mesh(
        args, simq, laserq, (2, 2, 2), args.steps_qed_mesh3d,
        args.steps_qed_mesh3d, {"rebin3": 72, "tail3<": 16, "photon3<": 8,
                                "fold3_pencil": 8, "fold3_cut": 8,
                                "fold3_pend": 16})
    done("QED mesh 3D")
    run_split_qed_3d(args, simq, laserq)
    del simq
    done("split QED 3D")
    run_exact_qed_3d(args, dev)
    done("exact QED 3D")
    kernels += stage3_rows()
    log(f"[time] total {time.time() - t_start:.1f} s; of it "
        + ", ".join(f"{k} {v[0]:.1f} s in {v[1]} calls"
                    for k, v in sorted(TIMERS.items())))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(json.dumps({"kernels": kernels}))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
