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
that particles cross cells. Prints one ``AB`` line per rank with B2's
and B3's mean ms a call from CUDA events (host issue included).
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
    from lambdapic_torch.testing import random_cell_state, to_torch
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
        del td, ta, ebt, rims
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
