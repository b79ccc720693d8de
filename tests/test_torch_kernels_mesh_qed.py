"""Kernel B2's want_chi and photon modes in the mesh dispatches (K6) and
kernel B6 with the neighbour shards' edge columns (K7) against their
plain PyTorch versions, on the card. Marked ``gpu``: they skip without a
CUDA device. On a machine with one (and without JAX, which
tests/conftest.py imports) run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_mesh_qed.py

Every mesh runs on the one card. The inputs are random shard states whose
particles cross the shards' faces and corners (merges in the crowded
cases), with a radiating species' tau, delta and event or a photon
species' inv_gamma = 1/|u|. Rules: K6 in float64 slot for slot after
canonicalisation (rtol 1e-11, the QED payloads exactly, chi 1e-10, ig0
1e-12), merges equal, panels to 1e-12 of their peak; in float32 alive
masks and ids identical and the attributes to rtol 1e-5. K7 (compiled
with --fmad=false, written as its plain version evaluates it): every
array bitwise equal in float64 and float32.
"""
import numpy as np
import pytest
import torch

from lambdapic_torch.ops import cellpallas as cp
from lambdapic_torch.ops.cell2d import migrate_cells
from lambdapic_torch.ops.cellslab import (cell_step, cell_step_mesh,
                                          cell_step_plain)
from lambdapic_torch.parallel.halo import HaloSpec
from lambdapic_torch.parallel.mesh import Mesh
from lambdapic_torch.testing import (QED_PAYLOADS, compare_mesh_slots,
                                     mesh_to_numpy, mesh_to_torch,
                                     random_mesh_cells)

pytestmark = pytest.mark.gpu

Q, M, DT, DX, G = -1.602e-19, 9.109e-31, 1.1e-16, 5e-8, 3
NAMES = ("px", "py", "pz")
KEYS = ("x", "y", "z", "w", "ux", "uy", "uz", "inv_gamma")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


def mesh_state(shape, cap, nloc, periodic, crowded, photon, dtype, dev,
               seed):
    nd = len(shape)
    mesh = Mesh(tuple(shape), NAMES[:nd], (dev,) * int(np.prod(shape)))
    specs = tuple(HaloSpec(NAMES[i], shape[i], periodic[i])
                  for i in range(nd))
    data, alive, eb = random_mesh_cells(
        shape, cap, nloc, seed=seed, crowded=crowded,
        n_frac=0.9 if crowded else 0.4, qed=not photon, umax=50.0,
        field=5e13)
    if photon:
        u2 = data["ux"]**2 + data["uy"]**2 + data["uz"]**2
        data["inv_gamma"] = np.where(u2 > 0, 1 / np.sqrt(np.maximum(
            u2, 1e-30)), 1.0)
    shards = mesh_to_torch(data, alive, mesh, dtype)
    ebs = [torch.as_tensor(eb[mesh.coords(i)], dtype=dtype).to(dev)
           for i in range(mesh.size)]
    return mesh, specs, shards, ebs


CASES = [
    # (mesh, cap, nloc, periodic, crowded)
    ((2, 2), 6, (16, 16), (True, True), True),
    ((2, 2), 4, (17, 16), (False, False), False),
    ((1, 4), 4, (20, 16), (False, True), False),
    ((1, 2, 2), 4, (8, 8, 8), (False, True, False), True),
    ((2, 2, 2), 4, (8, 8, 8), (True, False, True), False),
]
# K7 at the edges of B6's 3D and 2D tiles. 3D (8 cells along the axis by
# 32, 16 or 8 along z at up to 8, 16 or 32 slots a cell): x over two
# tiles, y two cells, z a multiple of 4 (16-byte copies); x one cell, z
# over one tile and not a multiple of it; y three cells at 17 slots; z one
# cell at the tile kernel's limit of 32 slots; one slot above it
K7_EDGE_CASES = [
    ((2, 1, 2), 9, (19, 2, 40), (False, True, True), True),
    ((1, 2, 2), 8, (1, 9, 37), (True, False, True), True),
    ((2, 2, 1), 17, (5, 3, 12), (True, True, False), True),
    ((2, 1, 1), 32, (3, 4, 1), (False, True, True), True),
    ((1, 1, 2), 33, (3, 2, 5), (True, False, True), True),
    # the same edges of B6's 2D tiles (2D slots as 3D slots (1, nx, ny)):
    # x one cell with y over one row and not a multiple of 4; x two cells,
    # y a multiple of 4; x over several tiles at 16 and 20 slots; the
    # limit of 32 slots; one slot above it
    ((2, 1), 8, (1, 299), (True, False), True),
    ((1, 2), 4, (2, 260), (False, True), True),
    ((2, 2), 16, (17, 132), (False, True), True),
    ((2, 2), 20, (9, 70), (True, True), True),
    ((2, 1), 32, (6, 65), (False, True), True),
    ((1, 2), 33, (5, 9), (True, False), True),
]


def _dense(ts, shape):
    return np.stack([t.cpu().numpy() for t in ts]).reshape(
        tuple(shape) + tuple(ts[0].shape))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["want_chi", "photon"])
@pytest.mark.parametrize("shape,cap,nloc,periodic,crowded", CASES)
def test_k6_matches_plain(cuda, shape, cap, nloc, periodic, crowded, mode,
                          dtype):
    photon = mode == "photon"
    nd = len(shape)
    mesh, specs, shards, ebs = mesh_state(shape, cap, nloc, periodic,
                                          crowded, photon, dtype, cuda,
                                          seed=cap + nd)
    got, ref = [cell_step_mesh(
        None if photon else ebs, [d for d, _ in shards],
        [a for _, a in shards], mesh, specs, q=0.0 if photon else Q,
        m=0.0 if photon else M, dt=DT, dx=DX, dy=DX,
        dz=DX if nd == 3 else None, g=G, want_chi=not photon, photon=photon,
        step=step) for step in (cell_step, cell_step_plain)]
    torch.cuda.synchronize()
    gd, ga = mesh_to_numpy([(r[0], r[1]) for r in got], shape)
    rd, ra = mesh_to_numpy([(r[0], r[1]) for r in ref], shape)
    f64 = dtype == torch.float64
    compare_mesh_slots(rd, ra, gd, ga, shape, rtol=1e-11 if f64 else 1e-5,
                       keys=KEYS, floor=1e-14 if f64 else 1e-6)
    assert [int(r[2]) for r in got] == [int(r[2]) for r in ref]
    if crowded:
        assert sum(int(r[2]) for r in ref) > 0
    if photon:
        assert all(r[3] is None for r in got)
        return
    for d, rs in ((gd, got), (rd, ref)):
        d["chi_out"] = _dense([r[4][0] for r in rs], shape)
        d["ig0_out"] = _dense([r[4][1] for r in rs], shape)
    compare_mesh_slots(rd, ra, gd, ga, shape, rtol=0, keys=QED_PAYLOADS)
    compare_mesh_slots(rd, ra, gd, ga, shape, rtol=1e-10 if f64 else 1e-5,
                       keys=("chi_out",), floor=1e-14 if f64 else 1e-6)
    compare_mesh_slots(rd, ra, gd, ga, shape, rtol=1e-12 if f64 else 1e-6,
                       keys=("ig0_out",))
    for a, b in zip(got, ref):
        peak = float(b[3].abs().max())
        assert float((a[3] - b[3]).abs().max()) <= \
            (1e-12 if f64 else 1e-5) * peak


@pytest.mark.parametrize("mode", ["want_chi", "photon"])
@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)])
def test_k6_launches_by_mode(cuda, shape, mode):
    """Each dispatch counts once in the mode its kernel ran: want_chi on
    the tail only (the heads run the default mode), photon on every
    dispatch."""
    photon = mode == "photon"
    nd = len(shape)
    mesh, specs, shards, ebs = mesh_state(shape, 4, (8,) * nd,
                                          (True,) * nd, False, photon,
                                          torch.float32, cuda, seed=5)
    ngroups = 1 + sum(p > 1 for p in shape[1:])
    before = dict(cell_step.launches_by_mode)
    cell_step_mesh(None if photon else ebs, [d for d, _ in shards],
                   [a for _, a in shards], mesh, specs,
                   q=0.0 if photon else Q, m=0.0 if photon else M, dt=DT,
                   dx=DX, dy=DX, dz=DX if nd == 3 else None, g=G,
                   want_chi=not photon, photon=photon)
    got = {k: v - before[k] for k, v in cell_step.launches_by_mode.items()}
    n = mesh.size
    want = {"photon": n * ngroups, "want_chi": 0, "default": 0} if photon \
        else {"photon": 0, "want_chi": n, "default": n * (ngroups - 1)}
    assert got == want


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("photon", [False, True], ids=["ig", "photon"])
@pytest.mark.parametrize("shape,cap,nloc,periodic,crowded",
                         CASES + K7_EDGE_CASES)
def test_k7_matches_plain(cuda, shape, cap, nloc, periodic, crowded, photon,
                          dtype):
    nd = len(shape)
    mesh, specs, shards, _ = mesh_state(shape, cap, nloc, periodic, crowded,
                                        photon, dtype, cuda, seed=2 * cap)
    gen = torch.Generator(device="cpu").manual_seed(cap + nd)
    datas = []
    for d, a in shards:
        d = dict(d)
        for ax in "xyz"[:nd]:
            shift = torch.rand(a.shape, generator=gen, dtype=torch.float64)
            d[ax] = torch.where(a, d[ax] + (shift * 1.8 - 0.9).to(
                d[ax].dtype).to(cuda), 0.0)
        datas.append(d)
    alives = [a for _, a in shards]
    got = cp.migrate_cells_mesh(datas, alives, mesh, specs,
                                recompute_ig=not photon)
    ref = cp.migrate_cells_mesh(datas, alives, mesh, specs,
                                recompute_ig=not photon,
                                scheme=migrate_cells)
    torch.cuda.synchronize()
    moved = 0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g[1], r[1]) and int(g[2]) == int(r[2])
        assert sorted(g[0]) == sorted(r[0])
        for k in r[0]:
            assert torch.equal(g[0][k], r[0][k]), (i, k)
        moved += int((r[0]["id_hi"][r[1]] != i).sum())
    assert moved > 0


def test_k7_launches_once_per_axis(cuda):
    """One B6 launch per shard and axis, edges or not."""
    shape = (2, 2)
    mesh, specs, shards, _ = mesh_state(shape, 4, (8, 8), (True, False),
                                        False, False, torch.float32, cuda,
                                        seed=1)
    cp.migrate_axis.launches = 0
    cp.migrate_cells_mesh([d for d, _ in shards], [a for _, a in shards],
                          mesh, specs)
    assert cp.migrate_axis.launches == 2 * mesh.size
