"""The port's per-stage CUDA kernels in 3D against their plain PyTorch
versions, on the card. Marked ``gpu``: they skip without a CUDA device.
On a machine with one (and without JAX, which tests/conftest.py imports)
run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels3d.py

Tolerances: B4 3D (default and want_eb modes, with and without the first
half push) runs the plain version's operations in its order, so float64
is bitwise equal and float32 within rtol 1e-5; B5 3D within 1e-12 of the
current's peak in float64 (1e-5 in float32; the sums run in another
order); B6 on 3D slots and B7 on 3D slots move data and merge in the
plain version's order, so every output array is equal, dead slots
included, for caps 4 to 20, with float, int32 and bool payloads. B2 3D
(the cases at the end; its default mode in test_torch_kernels.py) slot
for slot at rtol 1e-11 and panels within 1e-12 of their peak in float64:
its tile kernel adds the stencils with shared-memory atomics, so the
panel sums run in an order that changes from run to run.
"""
import numpy as np
import pytest
import torch

from lambdapic_torch.testing import (add_qed_payloads, compare_slots,
                                     crowded_cell_state, random_cell_state,
                                     to_torch)

pytestmark = pytest.mark.gpu

Q, M, DT = -1.602e-19, 9.109e-31, 1.1e-16
DX, DY, DZ = 5e-8, 6e-8, 5.5e-8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.parametrize("want_eb", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_b4_3d_matches_plain(cuda, want_eb, dtype):
    from lambdapic_torch.ops import cellpallas as cp
    data, alive, eb = random_cell_state(5, 13, 10, 9, seed=7, field=5e13)
    td, _ = to_torch(data, alive, dtype, cuda)
    args = [td[k] for k in ("x", "y", "z", "ux", "uy", "uz")]
    eb = torch.as_tensor(eb, dtype=dtype).to(cuda)
    for do_pos1 in (False, True):
        kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DY, dz=DZ, g=3,
                  want_eb=want_eb, do_pos1=do_pos1)
        ref = cp.fused_push_cell_3d_plain(eb, *args, **kw)
        before = dict(cp.fused_push_cell_3d.launches_by_mode)
        got = cp.fused_push_cell_3d(eb, *args, **kw)
        torch.cuda.synchronize()
        mode = "want_eb" if want_eb else "default"
        assert cp.fused_push_cell_3d.launches_by_mode[mode] == before[mode] + 1
        assert len(got) == len(ref) == (13 if want_eb else 7)
        for a, b in zip(got, ref):
            if dtype == torch.float64:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-5,
                                           atol=1e-6 * float(b.abs().max()))
        assert bool(torch.isfinite(got[6]).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_b5_3d_matches_plain(cuda, dtype, tol):
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell3d import deposit_cell_3d
    for cap, nx, ny, nz, g in ((4, 16, 8, 8, 3), (6, 10, 18, 9, 2),
                               (20, 9, 8, 11, 4)):
        data, alive, _ = random_cell_state(cap, nx, ny, nz, seed=cap,
                                           spread=0.99)
        td, ta = to_torch(data, alive, dtype, cuda)
        w = torch.where(ta, td["w"], 0.0)
        args = [td[k] for k in ("x", "y", "z", "ux", "uy", "uz",
                                "inv_gamma")]
        kw = dict(q=Q, dx=DX, dy=DY, dz=DZ, dt=DT, g=g)
        ref = deposit_cell_3d(*args, w, **kw)
        before = cp.deposit_cell_3d_k.launches
        got = cp.deposit_cell_3d_k(*args, w, **kw)
        torch.cuda.synchronize()
        assert cp.deposit_cell_3d_k.launches == before + 1
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=tol * float(ref.abs().max()))


STAGE3_CASES = [
    # (cap, nx, ny, nz, periodic, n_frac)
    (4, 12, 7, 9, (True, True, True), 0.9),
    (13, 9, 6, 5, (False, True, False), 0.5),
    (16, 9, 5, 6, (True, False, True), 0.9),
    (20, 6, 5, 7, (False, False, False), 1.0),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cap,nx,ny,nz,periodic,n_frac", STAGE3_CASES)
def test_b6_3d_matches_plain(cuda, dtype, cap, nx, ny, nz, periodic,
                             n_frac):
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import migrate_cells
    plan = tuple(zip((nx, ny, nz), periodic, "xyz"))
    for photon in (False, True):
        data, alive, _ = crowded_cell_state(cap, nx, ny, nz, n_frac=n_frac,
                                            seed=cap + nx)
        data = add_qed_payloads(data, seed=cap)
        if photon:
            u2 = data["ux"]**2 + data["uy"]**2 + data["uz"]**2
            data["inv_gamma"] = np.where(u2 > 0, 1 / np.sqrt(np.maximum(
                u2, 1e-30)), 1.0)
        td, ta = to_torch(data, alive, dtype, cuda)
        ref = migrate_cells(td, ta, plan, recompute_ig=not photon)
        before = cp.migrate_axis.launches
        got = cp.migrate_cells_fused(td, ta, plan, recompute_ig=not photon)
        torch.cuda.synchronize()
        assert cp.migrate_axis.launches == before + 3
        assert torch.equal(got[1], ref[1])
        assert sorted(got[0]) == sorted(ref[0])
        for k in ref[0]:
            assert torch.equal(got[0][k], ref[0][k]), k
        assert int(got[2]) == int(ref[2])
        if n_frac > 0.8:
            assert int(ref[2]) > 0


@pytest.mark.parametrize("cap", [4, 7, 13, 16, 20])
def test_b7_3d_matches_plain(cuda, cap):
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import batcher_sort
    rng = np.random.default_rng(cap)
    shape = (cap, 9, 7, 5)
    key = torch.as_tensor(rng.integers(-3, 6, shape).astype(np.int32)).to(cuda)
    pays = [torch.as_tensor(rng.normal(size=shape)).to(cuda),
            torch.as_tensor(rng.normal(size=shape), dtype=torch.float32
                            ).to(cuda),
            torch.as_tensor(rng.integers(-2**31, 2**31, shape).astype(
                np.int32)).to(cuda),
            torch.as_tensor(rng.uniform(size=shape) < 0.5).to(cuda)]
    rk, rp = batcher_sort(key, pays)
    before = cp.sort_cells.launches
    gk, gp = cp.sort_cells(key, pays)
    torch.cuda.synchronize()
    assert cp.sort_cells.launches == before + 1
    assert torch.equal(gk, rk)
    for a, b in zip(gp, rp):
        assert torch.equal(a, b)


def test_per_stage_3d_wrappers_reject_bad_operands(cuda):
    from lambdapic_torch.ops import cellpallas as cp
    data, alive, eb = random_cell_state(4, 8, 8, 8)
    td, ta = to_torch(data, alive, torch.float64, cuda)
    eb = torch.as_tensor(eb).to(cuda)
    with pytest.raises(ValueError):
        cp.fused_push_cell_3d(eb, td["x"].float(), td["y"], td["z"],
                              td["ux"], td["uy"], td["uz"], q=Q, m=M, dt=DT,
                              dx=DX, dy=DY, dz=DZ, g=3)
    with pytest.raises(ValueError):
        cp.deposit_cell_3d_k(*[td[k].transpose(1, 2) for k in (
            "x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")],
            q=Q, dx=DX, dy=DY, dz=DZ, dt=DT, g=3)
    with pytest.raises(ValueError):
        cp.migrate_cells_fused(td, ta, ((8, True, "x"), (8, True, "y")))


def test_per_stage_3d_simulation_on_card_matches_cpu(cuda):
    """Three float64 steps of tests/test_torch_step3d.py's tiny 3D
    laser-target through Simulation3D.run with cell_migration="exact"
    (B4, B5 on the card), and three split steps (a _push_momentum
    callback: B6, B5), each against the plain path on the CPU."""
    import lambdapic_torch
    from lambdapic_torch.core import species as t_species
    from lambdapic_torch.core.state import state_to_numpy
    from lambdapic_torch.ops import cellpallas as cp
    um, nc = 1e-6, 1.742e27
    l0 = 0.8 * um
    nx, ny, nz = 32, 16, 16
    dx, dy, dz = l0 / 10, l0 / 5, l0 / 5

    def make(dev, **kw):
        t_species._ALL_SPECIES.clear()
        L = lambdapic_torch
        dens = lambda x, y, z: np.where(x > 1.2 * um, 2 * nc, 0.0)
        mom = (lambda x, y, z: 0.8 * np.sin(2 * np.pi * y / (ny * dy)),
               lambda x, y, z: 0.7 * np.cos(2 * np.pi * z / (nz * dz)),
               None)
        sim = L.Simulation3D(nx=nx, ny=ny, nz=nz, dx=dx, dy=dy, dz=dz,
                             tiling="cell", random_seed=1,
                             precision="double", particle_capacity_factor=2.0,
                             device=dev, **kw)
        sim.add_species([L.Electron(density=dens, ppc=2, momentum=mom),
                         L.Proton(density=dens, ppc=2)])
        laser = L.GaussianLaser3D(a0=2, l0=l0, w0=0.8 * um, ctau=0.5 * um,
                                  x0=0.0, focus_position=1.0 * um)
        return sim, laser

    probe = lambdapic_torch.callback(stage="_push_momentum")(lambda s: None)
    for kw, cbs in ((dict(cell_migration="exact"), []), ({}, [probe])):
        states = []
        for dev in ("cpu", cuda):
            sim, laser = make(dev, **kw)
            before = (cp.fused_push_cell_3d.launches, cp.migrate_axis.launches,
                      cp.deposit_cell_3d_k.launches)
            sim.run(3, callbacks=[laser, *cbs])
            states.append(state_to_numpy(sim.state, dimension=3))
        if cbs:
            assert cp.migrate_axis.launches == before[1] + 3 * 2 * 3
        else:
            assert cp.fused_push_cell_3d.launches == before[0] + 3 * 2
        assert cp.deposit_cell_3d_k.launches == before[2] + 3 * 2
        ref, got = states
        for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz"):
            a, b = getattr(got.fields, k), getattr(ref.fields, k)
            np.testing.assert_allclose(a, b, rtol=1e-9,
                                       atol=1e-9 * np.abs(b).max(), err_msg=k)
        for pr, pg in zip(ref.particles, got.particles):
            assert int(pr.overflow.sum()) == int(pg.overflow.sum())
            compare_slots({k: v[0, 0, 0] for k, v in pr.data.items()},
                          pr.alive[0, 0, 0],
                          {k: v[0, 0, 0] for k, v in pg.data.items()},
                          pg.alive[0, 0, 0], rtol=1e-9)


QED3_CASES = [
    # (cap, nx, ny, nz, periodic, n_frac)
    (8, 8, 8, 8, (True, True, True), 0.4),
    (12, 9, 6, 10, (False, False, False), 0.5),
    (8, 8, 8, 8, (True, False, True), 0.9),      # merges
    (20, 6, 5, 7, (False, True, False), 0.5),
]


@pytest.mark.parametrize("cap,nx,ny,nz,periodic,n_frac", QED3_CASES)
def test_b2_3d_want_chi_matches_plain(cuda, cap, nx, ny, nz, periodic,
                                      n_frac):
    """B2 3D's want_chi mode: slots, the QED payloads, chi and ig0 slot
    for slot (float64, rtol 1e-11), panels to 1e-12 of their peak."""
    from lambdapic_torch.ops.cellslab import (cell_step, cell_step_plain,
                                              panel_shape)
    from lambdapic_torch.testing import QED_PAYLOADS, SLOT_FLOATS, to_numpy
    data, alive, eb = random_cell_state(cap, nx, ny, nz, n_frac=n_frac,
                                        seed=cap + nx, umax=50.0, field=5e13)
    td, ta = to_torch(add_qed_payloads(data, seed=cap), alive, torch.float64,
                      cuda)
    eb = torch.as_tensor(eb).to(cuda)
    rims_in = torch.as_tensor(np.random.default_rng(1).normal(
        size=panel_shape(4, nx, ny, nz))).to(cuda)
    kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DY, dz=DZ, g=3, periodic=periodic,
              rims_in=rims_in, want_chi=True)
    ref = cell_step_plain(eb, td, ta, **kw)
    before = cell_step.launches_by_mode["want_chi"]
    got = cell_step(eb, td, ta, **kw)
    torch.cuda.synchronize()
    assert cell_step.launches_by_mode["want_chi"] == before + 1
    for out in (ref, got):
        out[0]["chi"], out[0]["ig0"] = out[4]
    compare_slots(*to_numpy(ref[0], ref[1]), *to_numpy(got[0], got[1]),
                  rtol=1e-11, keys=SLOT_FLOATS + QED_PAYLOADS + ("chi", "ig0"))
    assert int(got[2]) == int(ref[2])
    if n_frac > 0.8:
        assert int(ref[2]) > 0
    torch.testing.assert_close(got[3], ref[3], rtol=0,
                               atol=1e-12 * float(ref[3].abs().max()))


@pytest.mark.parametrize("cap,nx,ny,nz,periodic,n_frac", QED3_CASES)
def test_b2_3d_photon_matches_plain(cuda, cap, nx, ny, nz, periodic, n_frac):
    from lambdapic_torch.ops.cellslab import cell_step, cell_step_plain
    from lambdapic_torch.testing import photon_cell_state, to_numpy
    data, alive = photon_cell_state(cap, nx, ny, nz, n_frac=n_frac,
                                    seed=cap + ny)
    td, ta = to_torch(add_qed_payloads(data, seed=cap), alive, torch.float64,
                      cuda)
    kw = dict(q=0.0, m=0.0, dt=DT, dx=DX, dy=DY, dz=DZ, g=3,
              periodic=periodic, photon=True)
    ref = cell_step_plain(None, td, ta, **kw)
    before = cell_step.launches_by_mode["photon"]
    got = cell_step(None, td, ta, **kw)
    torch.cuda.synchronize()
    assert cell_step.launches_by_mode["photon"] == before + 1
    assert got[3] is None
    compare_slots(*to_numpy(ref[0], ref[1]), *to_numpy(got[0], got[1]),
                  rtol=1e-11)
    assert int(got[2]) == int(ref[2])
    if n_frac > 0.8:
        assert int(ref[2]) > 0
    a = got[1]
    u = torch.sqrt(got[0]["ux"]**2 + got[0]["uy"]**2 + got[0]["uz"]**2)
    torch.testing.assert_close(got[0]["inv_gamma"][a], 1 / u[a], rtol=1e-14,
                               atol=0)
    assert bool((got[0]["inv_gamma"][~a] == 1).all())


# Per-cell capacities above 128 on 3D slots: (cap, nx, ny, nz, periodic,
# n_frac); cells hold more than 128 alive particles
BIGCAP3_CASES = [(130, 5, 4, 6, (True, False, True), 1.0),
                 (256, 4, 5, 3, (False, True, False), 0.9)]


@pytest.mark.parametrize("cap,nx,ny,nz,periodic,n_frac", BIGCAP3_CASES)
def test_b2_3d_bigcap_matches_plain(cuda, cap, nx, ny, nz, periodic, n_frac):
    from lambdapic_torch.ops.cellslab import cell_step, cell_step_plain
    from lambdapic_torch.testing import to_numpy
    data, alive, eb = random_cell_state(cap, nx, ny, nz, n_frac=n_frac,
                                        seed=cap + nx)
    assert int(alive.sum(0).max()) > 128
    td, ta = to_torch(data, alive, torch.float64, cuda)
    eb = torch.as_tensor(eb).to(cuda)
    kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DY, dz=DZ, g=3, periodic=periodic)
    ref = cell_step_plain(eb, td, ta, **kw)
    got = cell_step(eb, td, ta, **kw)
    torch.cuda.synchronize()
    compare_slots(*to_numpy(ref[0], ref[1]), *to_numpy(got[0], got[1]),
                  rtol=1e-11)
    assert int(got[2]) == int(ref[2]) > 0
    torch.testing.assert_close(got[3], ref[3], rtol=0,
                               atol=1e-12 * float(ref[3].abs().max()))


@pytest.mark.parametrize("cap,nx,ny,nz,periodic,n_frac", BIGCAP3_CASES)
def test_b6_b7_3d_bigcap_match_plain(cuda, cap, nx, ny, nz, periodic, n_frac):
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import batcher_sort, migrate_cells
    plan = tuple(zip((nx, ny, nz), periodic, "xyz"))
    data, alive, _ = crowded_cell_state(cap, nx, ny, nz, n_frac=n_frac,
                                        seed=cap + nx)
    td, ta = to_torch(add_qed_payloads(data, seed=cap), alive,
                      torch.float64, cuda)
    ref = migrate_cells(td, ta, plan)
    got = cp.migrate_cells_fused(td, ta, plan)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1])
    assert sorted(got[0]) == sorted(ref[0])
    for k in ref[0]:
        assert torch.equal(got[0][k], ref[0][k]), k
    assert int(got[2]) == int(ref[2]) > 0
    key = torch.as_tensor(np.random.default_rng(cap).integers(
        -3, 6, ta.shape).astype(np.int32)).to(cuda)
    pays = [td["x"], td["id_lo"], ta]
    rk, rp = batcher_sort(key, pays)
    gk, gp = cp.sort_cells(key, pays)
    torch.cuda.synchronize()
    assert torch.equal(gk, rk)
    for a, b in zip(gp, rp):
        assert torch.equal(a, b)


# B2 3D's tile kernel at its edges, float64 against cell_step_plain: slots
# at rtol 1e-11, panels within 1e-12 of their peak (the kernel's atomics
# sum in another order), merge counts equal. (cap, nx, ny, nz, periodic,
# mode) by case:
#  one_full_cell  one line of cells along x alive, crowded so that after
#                 the x pass a cell holds a particle in every slot beside
#                 empty cells;
#  untiled_grid   a grid that no 8^3 tile divides;
#  cap130         above the thread-local sort (130 slots a cell), want_chi;
#  want_chi_xf,
#  photon_xf      the QED modes with three extra payloads, merging.
TAIL3_CASES = {
    "one_full_cell": (8, 12, 9, 10, (True, False, True), "default"),
    "untiled_grid": (6, 13, 10, 11, (False, True, False), "default"),
    "cap130": (130, 5, 4, 6, (True, False, True), "want_chi"),
    "want_chi_xf": (12, 9, 10, 17, (False, False, True), "want_chi"),
    "photon_xf": (12, 9, 10, 17, (True, True, False), "photon"),
}


def _tail3_state(name, cap, nx, ny, nz, mode, seed):
    from lambdapic_torch.testing import photon_cell_state
    if name == "one_full_cell":
        # at rest and well inside the line's y and z: along x the cells 3k
        # take every slot of 3k - 1 and 3k + 1 (merging), along y and z
        # nothing moves
        data, alive, eb = crowded_cell_state(cap, nx, ny, nz, seed=seed)
        line = np.zeros_like(alive)
        line[:, :, ny // 2, nz // 2] = True
        alive = alive & line
        rng = np.random.default_rng(seed)
        data["y"] = ny // 2 + rng.uniform(-0.3, 0.3, alive.shape)
        data["z"] = nz // 2 + rng.uniform(-0.3, 0.3, alive.shape)
        data = {k: np.where(alive, v, 0.0) if k in ("x", "y", "z", "w") else v
                for k, v in data.items()}
        data.update(ux=np.zeros(alive.shape), uy=np.zeros(alive.shape),
                    uz=np.zeros(alive.shape), inv_gamma=np.ones(alive.shape))
    elif mode == "photon":
        data, alive = photon_cell_state(cap, nx, ny, nz, n_frac=0.9,
                                        seed=seed)
        eb = None
    elif name == "cap130":
        data, alive, eb = random_cell_state(cap, nx, ny, nz, n_frac=1.0,
                                            seed=seed, umax=50.0, field=5e13)
    else:
        data, alive, eb = crowded_cell_state(cap, nx, ny, nz, seed=seed,
                                             n_frac=0.9)
    if mode != "default":
        data = add_qed_payloads(data, seed=seed)
    return data, alive, eb


@pytest.mark.parametrize("name", list(TAIL3_CASES))
def test_b2_3d_tail_edges_match_plain(cuda, name):
    from lambdapic_torch.ops.cellslab import (FLOAT_PAYLOADS, cell_step,
                                              cell_step_plain, panel_shape)
    from lambdapic_torch.testing import QED_PAYLOADS, SLOT_FLOATS, to_numpy
    cap, nx, ny, nz, periodic, mode = TAIL3_CASES[name]
    data, alive, eb = _tail3_state(name, cap, nx, ny, nz, mode,
                                   seed=cap + nx)
    td, ta = to_torch(data, alive, torch.float64, cuda)
    kw = dict(dt=DT, dx=DX, dy=DY, dz=DZ, g=3, periodic=periodic)
    if mode == "photon":
        kw.update(q=0.0, m=0.0, photon=True)
        ebt = None
    else:
        kw.update(q=Q, m=M, want_chi=mode == "want_chi",
                  rims_in=torch.as_tensor(np.random.default_rng(2).normal(
                      size=panel_shape(4, nx, ny, nz))).to(cuda))
        ebt = torch.as_tensor(eb).to(cuda)
    ref = cell_step_plain(ebt, td, ta, **kw)
    before = cell_step.launches_by_mode[mode]
    got = cell_step(ebt, td, ta, **kw)
    torch.cuda.synchronize()
    assert cell_step.launches_by_mode[mode] == before + 1
    if name == "one_full_cell":
        assert int(ref[1].sum(0).max()) == cap
        assert int((ref[1].sum(0) == 0).sum()) > 0
    keys = SLOT_FLOATS + (QED_PAYLOADS if mode != "default" else ())
    if mode == "want_chi":
        for out in (ref, got):
            out[0]["chi"], out[0]["ig0"] = out[4]
        keys += ("chi", "ig0")
    compare_slots(*to_numpy(ref[0], ref[1]), *to_numpy(got[0], got[1]),
                  rtol=1e-11, keys=keys)
    assert int(got[2]) == int(ref[2])
    if name != "one_full_cell" and mode != "photon":
        assert int(ref[2]) > 0
    # dead slots hold the stage's dead values (the plain version pushes
    # its dead slots too; B5 3D takes a slot with w != 0 as alive)
    dead = ~got[1]
    for k in FLOAT_PAYLOADS:
        assert bool((got[0][k][dead] == 0).all()), k
    assert bool((got[0]["inv_gamma"][dead] == 1).all())
    if mode == "want_chi":
        assert bool((got[0]["chi"][dead] == 0).all())
        assert bool((got[0]["ig0"][dead] == 1).all())
    if mode == "photon":
        assert got[3] is None
    else:
        torch.testing.assert_close(got[3], ref[3], rtol=0,
                                   atol=1e-12 * float(ref[3].abs().max()))


def test_b2_3d_tail_dispatch_with_z_edges_matches_plain(cuda):
    """A K4 3D tail dispatch (the z pass with the neighbours' z edge
    columns, then the tail) against the plain version. Its input and the
    edges carry a made-up value in every dead slot, as a head dispatch's
    output may: the kernel must not read it."""
    from lambdapic_torch.ops.cellslab import (FLOAT_PAYLOADS, ID_PAYLOADS,
                                              cell_step, cell_step_plain,
                                              panel_shape)
    from lambdapic_torch.testing import to_numpy
    cap, nx, ny, nz = 6, 9, 8, 10

    def state(seed):
        data, alive, eb = crowded_cell_state(cap, nx, ny, nz, seed=seed,
                                             n_frac=0.8)
        data = {k: np.where(alive, v, 3.5) if k in FLOAT_PAYLOADS else v
                for k, v in data.items()}
        data.pop("inv_gamma")
        td, ta = to_torch(data, alive, torch.float64, cuda)
        return td, ta, eb

    td, ta, eb = state(21)
    edges = []
    for seed, at in ((22, nz - 1), (23, 0)):
        nd, na, _ = state(seed)
        e = {k: nd[k][..., at:at + 1].contiguous()
             for k in FLOAT_PAYLOADS + ID_PAYLOADS}
        e["alive"] = na[..., at:at + 1].to(torch.int32).contiguous()
        edges.append(e)
    kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DY, dz=DZ, g=3,
              periodic=(False, True, False), merge_axes=(2,), tail=True,
              yz_edges=(2, *edges),
              rims_in=torch.as_tensor(np.random.default_rng(4).normal(
                  size=panel_shape(4, nx, ny, nz))).to(cuda))
    ebt = torch.as_tensor(eb).to(cuda)
    ref = cell_step_plain(ebt, td, ta, **kw)
    before = cell_step.launches_by_dispatch["tail"]
    got = cell_step(ebt, td, ta, **kw)
    torch.cuda.synchronize()
    assert cell_step.launches_by_dispatch["tail"] == before + 1
    compare_slots(*to_numpy(ref[0], ref[1]), *to_numpy(got[0], got[1]),
                  rtol=1e-11)
    assert int(got[2]) == int(ref[2]) > 0
    torch.testing.assert_close(got[3], ref[3], rtol=0,
                               atol=1e-12 * float(ref[3].abs().max()))


def test_b2_3d_repeats(cuda):
    """The repeatability the tile kernel keeps: two identical calls give
    the same slots bit for bit (alive masks, every alive payload and id)
    and panels that agree within 1e-12 of their peak (the atomics' order
    of the sums changes from run to run)."""
    from lambdapic_torch.ops.cellslab import cell_step, panel_shape
    cap, nx, ny, nz = 8, 16, 8, 16
    data, alive, eb = crowded_cell_state(cap, nx, ny, nz, seed=5,
                                         n_frac=0.9)
    td, ta = to_torch(data, alive, torch.float64, cuda)
    kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DY, dz=DZ, g=3,
              periodic=(True, True, True),
              rims_in=torch.as_tensor(np.random.default_rng(6).normal(
                  size=panel_shape(4, nx, ny, nz))).to(cuda))
    ebt = torch.as_tensor(eb).to(cuda)
    one = cell_step(ebt, td, ta, **kw)
    two = cell_step(ebt, td, ta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(one[1], two[1])
    a = one[1]
    for k in one[0]:
        assert torch.equal(one[0][k][a], two[0][k][a]), k
    assert int(one[2]) == int(two[2])
    torch.testing.assert_close(one[3], two[3], rtol=0,
                               atol=1e-12 * float(one[3].abs().max()))
