"""Kernel B2's cross-device and multi-dispatch modes (K4) and kernel B3's
cross-device strips (K5) against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip without a CUDA device. On a machine with
one (and without JAX, which tests/conftest.py imports) run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_mesh.py

Every mesh runs on the one card, its device list naming cuda:0 once per
shard. The inputs are random shard states whose particles cross the
shards' faces and corners (with merges in the crowded cases). Rules
(float64): slot for slot after canonicalisation (alive and ids equal,
other attributes to rtol 1e-11 with a floor of 1e-14 of the peak), merge
counts equal, panels and J to 1e-12 of their peak (the current sums run
in another order). float32: the same with rtol 1e-5 and 1e-5 of the
peak. K5 in 3D alone (test_k5_3d_*): on the panels of particles in the
cells at the shards' corners, J to 1e-12 (float64) and 1e-6 (float32) of
its peak and bit for bit, since its launches add halo_reduce's terms in
its order.
"""
import itertools

import numpy as np
import pytest
import torch

from lambdapic_torch.ops.cellslab import (cell_step, cell_step_mesh,
                                          cell_step_plain, deposit_panels_3d,
                                          fold_reduce, fold_reduce_plain,
                                          panel_shape)
from lambdapic_torch.parallel.halo import HaloSpec
from lambdapic_torch.parallel.mesh import Mesh
from lambdapic_torch.testing import (compare_mesh_slots, mesh_to_numpy,
                                     mesh_to_torch, random_mesh_cells)

pytestmark = pytest.mark.gpu

Q, M, DT, DX, G = -1.602e-19, 9.109e-31, 1.1e-16, 5e-8, 3
NAMES = ("px", "py", "pz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


def run_both(mesh_shape, cap, nloc, periodic, crowded, dtype, dev, seed=0,
             emptied=None):
    """K4 + K5 and their plain versions on the same shard inputs: (kernel
    outputs, plain outputs), each ((data, alive) per shard, n_lost per
    shard, panels, J per shard). ``emptied``: the mesh coordinates of a
    shard whose particles are all removed first."""
    nd = len(mesh_shape)
    n = int(np.prod(mesh_shape))
    mesh = Mesh(tuple(mesh_shape), NAMES[:nd], (dev,) * n)
    specs = tuple(HaloSpec(NAMES[i], mesh_shape[i], periodic[i])
                  for i in range(nd))
    data, alive, eb = random_mesh_cells(mesh_shape, cap, nloc, seed=seed,
                                        crowded=crowded,
                                        n_frac=0.9 if crowded else 0.4)
    if emptied is not None:
        alive[emptied] = False
        for k in ("x", "y", "z", "w", "ux", "uy", "uz"):
            data[k][emptied] = 0.0
    shards = mesh_to_torch(data, alive, mesh, dtype)
    ebs = [torch.as_tensor(eb[mesh.coords(i)], dtype=dtype).to(dev)
           for i in range(n)]
    out = []
    for step, fold in ((cell_step, fold_reduce),
                       (cell_step_plain, fold_reduce_plain)):
        res = cell_step_mesh(ebs, [d for d, _ in shards],
                             [a for _, a in shards], mesh, specs, q=Q, m=M,
                             dt=DT, dx=DX, dy=DX, dz=DX if nd == 3 else None,
                             g=G, step=step)
        j = fold([r[3] for r in res], nloc, None, mesh, specs)
        out.append(([(r[0], r[1]) for r in res], [int(r[2]) for r in res],
                    [r[3] for r in res], j))
    torch.cuda.synchronize()
    return out


CASES = [
    # (mesh, cap, nloc, periodic, crowded)
    ((2, 1), 6, (16, 24), (True, False), True),
    ((2, 2), 4, (16, 16), (False, True), False),
    ((2, 2), 8, (17, 16), (True, True), True),
    ((1, 4), 4, (20, 16), (False, False), False),
    ((1, 2, 1), 4, (8, 8, 8), (True, False, True), True),
    ((2, 2, 2), 4, (8, 8, 8), (True, True, False), False),
    ((2, 2, 2), 6, (8, 9, 8), (False, True, True), True),
    ((1, 1, 2), 4, (8, 8, 8), (False, False, True), True),
]


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-11),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("mesh_shape,cap,nloc,periodic,crowded", CASES)
def test_k4_k5_match_plain(cuda, mesh_shape, cap, nloc, periodic, crowded,
                           dtype, rtol):
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    got, ref = run_both(mesh_shape, cap, nloc, periodic, crowded, dtype,
                        cuda, seed=cap + sum(nloc))
    gd, ga = mesh_to_numpy(got[0], mesh_shape)
    rd, ra = mesh_to_numpy(ref[0], mesh_shape)
    compare_mesh_slots(rd, ra, gd, ga, mesh_shape, rtol=rtol)
    assert got[1] == ref[1]
    if crowded and dtype == torch.float64:
        assert sum(ref[1]) > 0
    for a, b in zip(got[2], ref[2]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=tol * float(b.abs().max()))
    peak = max(float(b.abs().max()) for b in ref[3])
    for a, b in zip(got[3], ref[3]):
        torch.testing.assert_close(a, b, rtol=0, atol=tol * peak)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-11),
                                        (torch.float32, 1e-5)])
def test_k4_empty_shard_matches_plain(cuda, dtype, rtol):
    """K4 on a 2 x 2 mesh whose shard (0, 0) holds no particle: its tiles
    are empty but for the edge columns its x and y neighbours send it,
    whose arrivals it places (both axes periodic, so it has neighbours on
    every side); rules as test_k4_k5_match_plain."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    shape = (2, 2)
    got, ref = run_both(shape, 8, (32, 40), (True, True), False, dtype, cuda,
                        seed=11, emptied=(0, 0))
    gd, ga = mesh_to_numpy(got[0], shape)
    rd, ra = mesh_to_numpy(ref[0], shape)
    # particles arrived from the neighbours
    assert ra[0, 0].any()
    compare_mesh_slots(rd, ra, gd, ga, shape, rtol=rtol)
    assert got[1] == ref[1]
    for a, b in zip(got[2], ref[2]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=tol * float(b.abs().max()))
    peak = max(float(b.abs().max()) for b in ref[3])
    for a, b in zip(got[3], ref[3]):
        torch.testing.assert_close(a, b, rtol=0, atol=tol * peak)


def test_dispatch_counts(cuda):
    """One launch of kernel B2 a shard and dispatch (a mesh that splits
    only x runs the whole stage in one dispatch), and of B3 a shard
    (fold) plus, in 2D, one a shard and split axis (strips); in 3D one a
    shard (cut) and one a shard and strip axis after the first (pend),
    every axis here being split or periodic."""
    for mesh_shape, nloc, dispatches, strips in (
            ((2, 2), (16, 16), 2, 2), ((2, 1), (16, 16), 1, 1),
            ((2, 2, 2), (8, 8, 8), 3, 3), ((1, 1, 2), (8, 8, 8), 2, 3)):
        n = int(np.prod(mesh_shape))
        cell_step.launches = 0
        cell_step.launches_by_dispatch = dict.fromkeys(
            cell_step.launches_by_dispatch, 0)
        fold_reduce.launches = 0
        fold_reduce.launches_by_kind = dict.fromkeys(
            fold_reduce.launches_by_kind, 0)
        run_both(mesh_shape, 4, nloc, (True,) * len(nloc), False,
                 torch.float64, cuda)
        assert cell_step.launches == n * dispatches
        assert cell_step.launches_by_dispatch == {
            "whole": n if dispatches == 1 else 0,
            "head": n * (dispatches - 1),
            "tail": n if dispatches > 1 else 0}
        if len(nloc) == 2:
            want = {"fold": n, "strips": n * strips, "cut": 0, "pend": 0}
        else:
            want = {"fold": n, "strips": 0, "cut": n,
                    "pend": n * (strips - 1)}
        assert fold_reduce.launches_by_kind == want


def test_mesh_simulation_on_card_matches_cpu(cuda):
    """The tiny 2D laser-target on a 2 x 2 mesh of the one card against
    the same run on a 2 x 2 mesh of the CPU (plain versions), float64:
    fields to 1e-9 of their peak, particles slot for slot."""
    import lambdapic_torch
    from lambdapic_torch.core.state import state_to_numpy
    from lambdapic_torch.testing import tiny_laser_target
    states = []
    for dev in (torch.device("cpu"), cuda):
        lambdapic_torch.core.species._ALL_SPECIES.clear()
        sim, laser = tiny_laser_target(lambdapic_torch, nx=48, ny=32,
                                       device=dev.type, npatch_x=2,
                                       npatch_y=2,
                                       particle_capacity_factor=4.0)
        sim.initialize(devices=[dev] * 4)
        sim.run(4, callbacks=[laser])
        states.append(state_to_numpy(sim.state, mesh=sim.mesh,
                                     cpml=sim.cpml, grid=sim.grid))
    ref, got = states
    for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz"):
        a, b = getattr(got.fields, k), getattr(ref.fields, k)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-9 * np.abs(b).max(), err_msg=k)
    for pr, pg in zip(ref.particles, got.particles):
        compare_mesh_slots(pr.data, pr.alive, pg.data, pg.alive, (2, 2),
                           rtol=1e-9)


K5_MESHES = [(2, 2, 2), (1, 1, 2), (1, 2, 1), (2, 1, 1), (2, 2, 1)]


def _mesh3(mesh_shape, periodic, dev):
    n = int(np.prod(mesh_shape))
    mesh = Mesh(tuple(mesh_shape), NAMES, (dev,) * n)
    specs = tuple(HaloSpec(NAMES[i], mesh_shape[i], periodic[i])
                  for i in range(3))
    return mesh, specs


def corner_panels(mesh, nloc, dtype, seed):
    """Per shard, the panels (deposit_panels_3d) of the particles of a
    random shard state that sit in the cells within two of one of the
    shard's eight corners: their guard nodes reach the diagonal shards."""
    data, alive, _ = random_mesh_cells(mesh.shape, 4, nloc, seed=seed,
                                       n_frac=0.9)
    near = np.zeros(nloc, bool)
    for corner in itertools.product(*[(slice(0, 2), slice(n - 2, n))
                                      for n in nloc]):
        near[corner] = True
    out = []
    for d, a in mesh_to_torch(data, alive & near, mesh, dtype):
        w = torch.where(a, d["w"], 0.0)
        out.append(deposit_panels_3d(
            *[d[k] for k in ("x", "y", "z", "ux", "uy", "uz", "inv_gamma")],
            w, q=Q, dx=DX, dy=DX, dz=DX, dt=DT))
    return out


@pytest.mark.parametrize("nloc", [(8, 8, 8), (9, 8, 17)])
@pytest.mark.parametrize("periodic", [(True, True, True),
                                      (False, False, False)])
@pytest.mark.parametrize("mesh_shape", K5_MESHES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_k5_3d_matches_plain(cuda, mesh_shape, periodic, nloc, dtype, tol):
    """K5 in 3D (strip cut, exchanges, pending adds, fold) against
    fold_reduce_plain with the mesh; launches by kind: a fold and a cut a
    shard, a pending add a shard and strip axis after the first."""
    mesh, specs = _mesh3(mesh_shape, periodic, cuda)
    rims = corner_panels(mesh, nloc, dtype, seed=sum(nloc) + sum(periodic))
    fold_reduce.launches_by_kind = dict.fromkeys(
        fold_reduce.launches_by_kind, 0)
    got = fold_reduce(rims, nloc, None, mesh, specs)
    ref = fold_reduce_plain(rims, nloc, None, mesh, specs)
    torch.cuda.synchronize()
    n = mesh.size
    nstrip = sum(s > 1 or p for s, p in zip(mesh_shape, periodic))
    assert fold_reduce.launches_by_kind == {
        "fold": n, "strips": 0, "cut": n if nstrip else 0,
        "pend": n * max(nstrip - 1, 0)}
    peak = max(float(b.abs().max()) for b in ref)
    assert peak > 0
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=tol * peak)
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k5_3d_corner_reaches_the_diagonal_shard(cuda, dtype):
    """Only shard (0, 0, 0) holds current, on its guard corner nodes: on
    an open 2 x 2 x 2 mesh it lands on shard (1, 1, 1)'s first two rows
    of every axis (three exchanges, two pending adds) and nowhere else."""
    mesh, specs = _mesh3((2, 2, 2), (False,) * 3, cuda)
    nloc = (8, 8, 8)
    rims = [torch.zeros(panel_shape(3, *nloc), dtype=dtype, device=cuda)
            for _ in range(mesh.size)]
    rims[0][:, 0, 0, 0, 10:, 10:, 10:] = torch.arange(
        1.0, 25.0, dtype=dtype, device=cuda).view(3, 2, 2, 2)
    got = fold_reduce(rims, nloc, None, mesh, specs)
    far = mesh.index((1, 1, 1))
    for i, a in enumerate(got):
        if i != far:
            assert not a.any(), i
    corner = got[far][:, :2, :2, :2]
    assert torch.equal(corner, rims[0][:, 0, 0, 0, 10:, 10:, 10:])
    assert float(got[far].abs().sum()) == float(corner.abs().sum())
