"""The tiled 2D engine's CUDA kernels B8 (gather_tiled_k) and B9
(deposit_tiled_k) against their plain PyTorch versions, on the card.
Marked ``gpu``: they skip without a CUDA device. On a machine with one
(and without JAX, which tests/conftest.py imports) run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_tiled.py

Tolerances. float64: B8 rtol 1e-12 with a floor of 1e-14 of each
component's peak (the plain version's matrix products sum in another
order); B9 an absolute 1e-12 of each channel's peak (the plain version's
dense cumsum leaves a rounding residue of the telescoping sum on nodes
past the stencil, where the kernel writes exact zeros, and the kernel
sums with atomics in no fixed order). float32: B8 rtol 1e-5 with a floor
of 1e-6 of the peak, B9 1e-4 of each channel's peak.

Cases: dead slots (x = y = 0 outside every window but tile (0, 0)'s),
particles on the edges of the drift band, drifts of 1 cell (h = 3) and
of 3 cells (h = 5: four steps at c dt/dx = 0.67), a cap_t that is not a
multiple of the block's 256 threads, cap_t = 16,384 (bench.py's
--tiling 32,32 laser-target), and tiles of 8 x 8, 16 x 8 and 32 x 32.
The fill's layout (testing.tiled_fill_state: ten particles a cell in
consecutive slots, cell by cell, the first tile row empty), in that
order and shuffled, at cap_t 16,384, 4100 and 659 (neither a multiple of
B9's 4096-slot round nor of its 16-byte mask loads), and a random state
with one tile emptied. B9 is given w = 7 in the dead slots, which its
mask keeps out. The whole step: one tiled Simulation step on the card
against the same step through the plain versions on the card, from a
cloned state.
"""
import numpy as np
import pytest
import torch

from lambdapic_torch.ops import tiled2d_kernels as tk
from lambdapic_torch.ops.tiled2d import TileCfg
from lambdapic_torch.testing import tiled_fill_state, tiled_state, to_torch

pytestmark = pytest.mark.gpu

Q, DX, DY = -1.602e-19, 5e-8, 5e-8
DT = 0.95 / np.sqrt(DX**-2 + DY**-2) / 2.99792458e8
# (tx, ty, ntx, nty, h, cap_t)
CASES = [(8, 8, 4, 3, 3, 300), (16, 8, 3, 4, 5, 256), (32, 32, 2, 3, 5, 16384)]
# the fill's layout (tx, ty, ntx, nty, h, cap_t), tiles of x index 0 empty
FILL_CASES = [(32, 32, 3, 2, 5, 16384), (16, 16, 3, 2, 5, 4100),
              (8, 8, 3, 2, 3, 659)]
TOL = {torch.float64: ((1e-12, 1e-14), 1e-12),
       torch.float32: ((1e-5, 1e-6), 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _inputs(case, dtype, dev, seed, layout="random"):
    """(cfg, data, alive, eb_pad) on the card: tiled_state's random state
    (``empty``: with tile (1, 1) emptied as the re-binning leaves a tile),
    or the fill's layout (``fill``, ``shuffled``)."""
    tx, ty, ntx, nty, h, cap = case
    cfg = TileCfg(tx=tx, ty=ty, ntx=ntx, nty=nty, cap_t=cap, h=h)
    if layout in ("fill", "shuffled"):
        d, alive, eb_pad = tiled_fill_state(cfg, seed=seed, first_tile=1,
                                            shuffle=layout == "shuffled")
    else:
        d, alive, eb_pad = tiled_state(cfg, seed=seed, drift=h - 2)
        if layout == "empty":
            alive[1, 1] = False
            for k, v in d.items():
                v[1, 1] = 1 if k == "inv_gamma" else 0
    d, alive = to_torch(d, alive, dtype, dev)
    return cfg, d, alive, torch.as_tensor(eb_pad, dtype=dtype).to(dev)


def _check_b8(cfg, d, alive, eb_pad, dtype):
    before = tk.gather_tiled_k.launches
    got = tk.gather_tiled_k(eb_pad, d["x"], d["y"], cfg)
    torch.cuda.synchronize()
    assert tk.gather_tiled_k.launches == before + 1
    ref = tk.gather_tiled_plain(eb_pad, d["x"], d["y"], cfg)
    (rtol, floor), _ = TOL[dtype]
    dead = ~alive
    dead[0, 0] = False
    for k, (g, r) in enumerate(zip(got, ref)):
        torch.testing.assert_close(g, r, rtol=rtol,
                                   atol=floor * float(r.abs().max()),
                                   msg=f"component {k}")
        assert float(g[dead].abs().max()) == 0.0
    return got


def _check_b9(cfg, d, alive, dtype, dead_w=0.0):
    w = torch.where(alive, d["w"], dead_w)
    args = [d[k] for k in ("x", "y", "ux", "uy", "uz", "inv_gamma")] + [
        w, alive]
    kw = dict(q=Q, dx=DX, dy=DY, dt=DT)
    before = tk.deposit_tiled_k.launches
    got = tk.deposit_tiled_k(*args, cfg, **kw)
    torch.cuda.synchronize()
    assert tk.deposit_tiled_k.launches == before + 1
    ref = tk.deposit_tiled_plain(*args, cfg, **kw)
    _, tol = TOL[dtype]
    for k, name in enumerate(("jx", "jy", "jz", "rho")):
        peak = float(ref[k].abs().max())
        assert peak > 0, name
        err = float((got[k] - ref[k]).abs().max())
        assert err <= tol * peak, (name, err, peak)
    return got


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", CASES)
def test_b8_matches_plain(cuda, case, dtype):
    _check_b8(*_inputs(case, dtype, cuda, 1), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", CASES)
def test_b9_matches_plain(cuda, case, dtype):
    cfg, d, alive, _ = _inputs(case, dtype, cuda, 2)
    _check_b9(cfg, d, alive, dtype)


@pytest.mark.parametrize("layout", ["fill", "shuffled"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", FILL_CASES)
def test_b8_fill_matches_plain(cuda, case, dtype, layout):
    cfg, d, alive, eb_pad = _inputs(case, dtype, cuda, 3, layout)
    got = _check_b8(cfg, d, alive, eb_pad, dtype)
    # the empty tiles' slots gather exactly 0, tile (0, 0)'s its field
    assert all(float(g[0, 1:].abs().max()) == 0.0 for g in got)


@pytest.mark.parametrize("layout", ["fill", "shuffled"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", FILL_CASES)
def test_b9_fill_matches_plain(cuda, case, dtype, layout):
    cfg, d, alive, _ = _inputs(case, dtype, cuda, 4, layout)
    got = _check_b9(cfg, d, alive, dtype, dead_w=7.0)
    # the empty tiles' windows are exactly 0
    assert float(got[:, 0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_b8_b9_empty_tile(cuda, dtype):
    """A random state with tile (1, 1) emptied: its six gathers and its
    four windows are exactly 0, the rest matches the plain versions."""
    cfg, d, alive, eb_pad = _inputs(CASES[1], dtype, cuda, 5, "empty")
    got = _check_b8(cfg, d, alive, eb_pad, dtype)
    assert all(float(g[1, 1].abs().max()) == 0.0 for g in got)
    win = _check_b9(cfg, d, alive, dtype, dead_w=7.0)
    assert float(win[:, 1, 1].abs().max()) == 0.0


def test_tiled_step_matches_plain_step(cuda):
    """One tiled step through Simulation.run on the card against the same
    step with B8 and B9 swapped for their plain versions on the card."""
    import copy

    from lambdapic_torch.simulation import step as step_mod
    from lambdapic_torch.testing import tiny_tiled_laser_target
    import lambdapic_torch
    from lambdapic_torch.core.species import _ALL_SPECIES
    _ALL_SPECIES.clear()
    sim, laser = tiny_tiled_laser_target(lambdapic_torch, device=cuda)
    sim.run(6, callbacks=[laser])
    saved = copy.deepcopy(sim.state)
    before = (tk.gather_tiled_k.launches, tk.deposit_tiled_k.launches)
    sim.run(1, callbacks=[laser])
    assert (tk.gather_tiled_k.launches - before[0],
            tk.deposit_tiled_k.launches - before[1]) == (2, 2)
    got = sim.state
    sim.state, sim.itime = saved, sim.itime - 1
    sim.time -= sim.dt
    mp = pytest.MonkeyPatch()
    mp.setattr(step_mod, "gather_tiled_k", tk.gather_tiled_plain)
    mp.setattr(step_mod, "deposit_tiled_k", tk.deposit_tiled_plain)
    try:
        sim.run(1, callbacks=[laser])
    finally:
        mp.undo()
    ref = sim.state
    for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho"):
        a, b = getattr(got.fields, k), getattr(ref.fields, k)
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-11 * float(b.abs().max()) + 1e-300,
                                   msg=k)
    for pa, pb in zip(got.particles, ref.particles):
        assert torch.equal(pa.alive, pb.alive)
        for k in pa.data:
            torch.testing.assert_close(pa.data[k], pb.data[k], rtol=1e-11,
                                       atol=1e-14 * float(
                                           pb.data[k].abs().max()) + 1e-300,
                                       msg=k)
