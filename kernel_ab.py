#!/usr/bin/env python3
"""Time the one-device kernels B2 and B3 of a lambdapic_torch tree.

    python3 kernel_ab.py ROOT

ROOT is the directory that holds the ``lambdapic_torch`` package to time
(``.`` for this checkout; an unpacked ``git archive <commit>
lambdapic_torch`` for another version, with this checkout's
``lambdapic_torch/testing.py`` copied over its own, which makes the
inputs). Its kernels are built from that tree's sources into that tree's
``_build/``. Two versions are compared by running this script for each in
one call on one card, in turns (parent, change, change, parent), since
cards and calls differ.

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

B2 runs on each state in its three modes: default, ``want_chi`` (with a
QED species' three extra payloads) and ``photon`` (inv_gamma = 1/|u|,
the same extras). Prints one ``AB`` line per state and mode with B2's
mean ms a call from CUDA events (host issue included; B3's beside the
uniform 2D and the 3D default) and one ``AB-split`` line per
``__global__`` function with its device ms a call from torch.profiler.
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


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, sys.argv[1])
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import lambdapic_torch
    from lambdapic_torch.ops import kernel_lib
    from lambdapic_torch.ops.cellslab import cell_step, fold_reduce
    from lambdapic_torch.testing import add_qed_payloads, to_torch
    print(f"package {lambdapic_torch.__file__}", flush=True)
    kernel_lib.build(["cellstep", "cellstep3d", "fold", "fold3d"])
    dev = torch.device("cuda:0")
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
