#!/usr/bin/env python3
"""Time the one-device kernels B2 and B3 of a lambdapic_torch tree.

    python3 kernel_ab.py ROOT

ROOT is the directory that holds the ``lambdapic_torch`` package to time
(``.`` for this checkout; an unpacked ``git archive <commit>
lambdapic_torch`` for another version). Its kernels are built from that
tree's sources into that tree's ``_build/``. Two versions are compared by
running this script for each in one call on one card, in turns (parent,
change, change, parent), since cards and calls differ.

Inputs are seeded random cell states (``testing.random_cell_state``):
2D 1024 x 1024 cells of 20 slots at 3% occupancy, 3D 256 x 128 x 128
cells of 8 slots at 30%, float32, open faces, strong random fields so
that particles cross cells. B2 3D runs in its three modes on the same
state: default, ``want_chi`` (with a QED species' three extra payloads)
and ``photon`` (inv_gamma = 1/|u|, the same extras). Prints one ``AB``
line per rank and mode with B2's and B3's mean ms a call from CUDA
events (host issue included), and for B2 3D one ``AB-split`` line per
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
    kernel count (the profiler may drop the first stretch of a window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    marks = [e.time_range.start for e in events if "spin_kernel" in e.name]
    out = {}
    for e in events:
        if marks and e.time_range.start > marks[-1]:
            ms, n = out.get(e.name, (0.0, 0))
            out[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return {k: (ms / iters, n / iters) for k, (ms, n) in out.items()}


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
    from lambdapic_torch.testing import (add_qed_payloads, random_cell_state,
                                         to_torch)
    print(f"package {lambdapic_torch.__file__}", flush=True)
    kernel_lib.build(["cellstep", "cellstep3d", "fold", "fold3d"])
    dev = torch.device("cuda:0")
    q, m, dt, dx = -1.602e-19, 9.109e-31, 1.1e-16, 5e-8
    for name, cap, n, frac, iters in (("2D", 20, (1024, 1024), 0.03, 20),
                                      ("3D", 8, (256, 128, 128), 0.3, 5)):
        d, a, eb = random_cell_state(cap, *n, n_frac=frac, seed=1)
        td, ta = to_torch(d, a, torch.float32, dev)
        ebt = torch.as_tensor(eb, dtype=torch.float32).to(dev)
        kw = dict(q=q, m=m, dt=dt, dx=dx, dy=dx, g=3,
                  periodic=(False,) * len(n), with_rho=False)
        if len(n) == 3:
            kw["dz"] = dx
        b2 = timed(lambda: cell_step(ebt, td, ta, **kw), iters)
        rims = cell_step(ebt, td, ta, **kw)[3]
        b3 = timed(lambda: fold_reduce(rims, n, kw["periodic"]), 50)
        print(f"AB {name} B2 {b2:.4f} ms B3 {b3:.4f} ms", flush=True)
        del rims
        if len(n) == 3:
            qd, _ = to_torch(add_qed_payloads(d, seed=2), a, torch.float32,
                             dev)
            u2 = qd["ux"]**2 + qd["uy"]**2 + qd["uz"]**2
            pd = dict(qd, inv_gamma=torch.where(
                u2 > 0, 1 / torch.sqrt(u2.clamp_min(1e-30)), 1.0))
            calls = {"default": lambda: cell_step(ebt, td, ta, **kw),
                     "want_chi": lambda: cell_step(ebt, qd, ta, want_chi=True,
                                                   **kw),
                     "photon": lambda: cell_step(
                         None, pd, ta, **dict(kw, q=0.0, m=0.0, photon=True))}
            for mode, fn in calls.items():
                if mode != "default":
                    print(f"AB 3D B2 {mode} {timed(fn, iters):.4f} ms",
                          flush=True)
                for k, (ms, nl) in sorted(device_split(fn, iters).items(),
                                          key=lambda kv: -kv[1][0]):
                    print(f"AB-split 3D {mode} {ms:.4f} ms {nl:g} launches "
                          f"{k[:90]}", flush=True)
            del qd, pd
        del td, ta, ebt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
