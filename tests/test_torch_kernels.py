"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip without a CUDA device. On a machine with
one (and without JAX, which tests/conftest.py imports) run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Each kernel is held in its 2D and in its 3D form. Tolerances (float64):
B1 1e-12 of each array's peak; B2 slot for slot
after canonicalisation (alive and ids equal, other attributes to rtol
1e-11), merge counts equal, panels to 1e-12 of their peak; B3 1e-12 of
the peak. The kernels are compiled without multiply-add contraction, so
they round like the plain versions; only the current sums run in
another order.

The per-stage kernels (2D): B4 (default and want_eb modes, given the
alive mask) bitwise in every output (the plain version's operations, in
its order; the dead values 0 and inv_gamma 1 in every dead slot); B5
(given the mask) to 1e-12 of the current's peak (the sums run in another
order), its J repeating bit for bit and its panels bit for bit B2's;
B6 and B7 move data and merge in the plain version's order, so every
output array is equal to the plain version's, dead slots included. In
float32: B4 bitwise, B5 1e-5 of the peak, B6 and B7 equal.
"""
import numpy as np
import pytest
import torch

from lambdapic_torch.core.grid import Grid
from lambdapic_torch.core.state import FieldsState
from lambdapic_torch.ops import maxwell
from lambdapic_torch.ops.cellslab import (cell_step, cell_step_plain,
                                          fold_reduce, fold_reduce_plain,
                                          panel_shape)
from lambdapic_torch.ops.cpml import CPMLParams, build_cpml
from lambdapic_torch.ops.fieldskernel import (update_bfield_k,
                                              update_efield_k, update_half_k)
from lambdapic_torch.testing import QED_PAYLOADS, SLOT_FLOATS, \
    add_qed_payloads, compare_slots, photon_cell_state, random_cell_state, \
    sparse_cell_state, to_numpy, to_torch

pytestmark = pytest.mark.gpu

Q, M, DT, DX = -1.602e-19, 9.109e-31, 1.1e-16, 5e-8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.parametrize("bc", ["pml", "periodic"])
def test_b1_matches_plain(cuda, bc):
    names = ("xmin", "xmax", "ymin", "ymax")
    grid = Grid(dimension=2, nx=40, ny=36, dx=1e-6, dy=0.8e-6, npatch_x=1,
                npatch_y=1, n_guard=3, cpml_thickness=6,
                boundary_conditions=tuple((n, bc) for n in names))
    dt = 0.95 / np.sqrt(grid.dx**-2 + grid.dy**-2) / 3e8
    cpml = build_cpml(grid, dt, CPMLParams()) if bc == "pml" else None
    rng = np.random.default_rng(0)

    def t(shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale).to(cuda)

    f = FieldsState(**{k: t(grid.shape, 1e-8 if k[0] == "b" else 1.0)
                       for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx",
                                 "jy", "jz", "rho")})
    if cpml is not None:
        for axis, ax in enumerate("xy"):
            shape = list(grid.shape)
            shape[axis] = cpml.psi_width(ax)
            comps = ("ey", "ez", "by", "bz") if ax == "x" else \
                ("ex", "ez", "bx", "bz")
            for c in comps:
                f.psi[f"psi_{c}_{ax}"] = t(shape, 1e-3)
    for k_fn, p_fn in ((update_efield_k, maxwell.update_efield),
                       (update_bfield_k, maxwell.update_bfield)):
        got, ref = k_fn(f, grid, dt / 2, cpml), p_fn(f, grid, dt / 2, cpml)
        for k in ("ex", "ey", "ez", "bx", "by", "bz"):
            a, b = getattr(got, k), getattr(ref, k)
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-12 * float(b.abs().max()))
        for k in ref.psi:
            torch.testing.assert_close(got.psi[k], ref.psi[k], rtol=0,
                                       atol=1e-12 * float(ref.psi[k].abs().max()))


@pytest.mark.parametrize("cap,nx,ny,periodic,n_frac", [
    (4, 16, 16, (True, True), 0.4),
    (6, 24, 40, (False, False), 0.4),
    (4, 20, 36, (True, False), 0.9),
    (20, 33, 18, (False, True), 0.5),
])
def test_b2_b3_match_plain(cuda, cap, nx, ny, periodic, n_frac):
    data, alive, eb = random_cell_state(cap, nx, ny, n_frac=n_frac,
                                        seed=cap + nx)
    td, ta = to_torch(data, alive, torch.float64, cuda)
    eb = torch.as_tensor(eb).to(cuda)
    rims_in = torch.as_tensor(np.random.default_rng(1).normal(
        size=panel_shape(4, nx, ny))).to(cuda)
    kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DX, g=3, periodic=periodic,
              rims_in=rims_in)
    ref = cell_step_plain(eb, td, ta, **kw)
    before = cell_step.launches
    got = cell_step(eb, td, ta, **kw)
    torch.cuda.synchronize()
    assert cell_step.launches == before + 1
    compare_slots(*to_numpy(ref[0], ref[1]), *to_numpy(got[0], got[1]),
                  rtol=1e-11)
    assert int(got[2]) == int(ref[2])
    if n_frac > 0.8:
        assert int(ref[2]) > 0
    torch.testing.assert_close(got[3], ref[3], rtol=0,
                               atol=1e-12 * float(ref[3].abs().max()))
    jr = fold_reduce_plain(ref[3], (nx, ny), periodic)
    jk = fold_reduce(ref[3], (nx, ny), periodic)
    torch.testing.assert_close(jk, jr, rtol=0,
                               atol=1e-12 * float(jr.abs().max()))


def test_wrappers_reject_bad_operands(cuda):
    data, alive, eb = random_cell_state(4, 16, 16)
    td, ta = to_torch(data, alive, torch.float64, cuda)
    td["x"] = td["x"].float()
    with pytest.raises(ValueError):
        cell_step(torch.as_tensor(eb).to(cuda), td, ta, q=Q, m=M, dt=DT,
                  dx=DX, dy=DX, g=3, periodic=(True, True))


QED_CASES = [
    (4, 16, 16, (True, True), 0.4),
    (6, 24, 40, (False, False), 0.5),
    (8, 16, 16, (False, True), 0.85),      # merges
    (20, 33, 18, (True, False), 0.5),
]


@pytest.mark.parametrize("cap,nx,ny,periodic,n_frac", QED_CASES)
def test_b2_want_chi_matches_plain(cuda, cap, nx, ny, periodic, n_frac):
    """want_chi: slots, the QED payloads, chi and ig0 slot for slot."""
    data, alive, eb = random_cell_state(cap, nx, ny, n_frac=n_frac,
                                        seed=cap + nx, umax=50.0, field=5e13)
    data = add_qed_payloads(data, seed=cap)
    td, ta = to_torch(data, alive, torch.float64, cuda)
    eb = torch.as_tensor(eb).to(cuda)
    rims_in = torch.as_tensor(np.random.default_rng(1).normal(
        size=panel_shape(4, nx, ny))).to(cuda)
    kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DX, g=3, periodic=periodic,
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


@pytest.mark.parametrize("cap,nx,ny,periodic,n_frac", QED_CASES)
def test_b2_photon_matches_plain(cuda, cap, nx, ny, periodic, n_frac):
    data, alive = photon_cell_state(cap, nx, ny, n_frac=n_frac, seed=cap + ny)
    td, ta = to_torch(data, alive, torch.float64, cuda)
    kw = dict(q=0.0, m=0.0, dt=DT, dx=DX, dy=DX, g=3, periodic=periodic,
              photon=True)
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


def test_simulation_on_card_matches_cpu(cuda):
    """Ten float64 steps of a small laser-target through Simulation.run:
    the kernel path on the card against the plain path on the CPU."""
    import lambdapic_torch
    from lambdapic_torch.core import species as t_species
    from lambdapic_torch.core.state import state_to_numpy
    um = 1e-6
    l0 = 0.8 * um
    nx, dx = 64, l0 / 16

    def density(x, y):
        return np.where((x > nx * dx / 2) & (x < nx * dx / 2 + 0.5 * um),
                        5 * 1.742e27, 0.0)

    def ux(x, y):
        return 1.5 * np.sin(2 * np.pi * y / (nx * dx))

    states = []
    for dev in ("cpu", cuda):
        t_species._ALL_SPECIES.clear()
        sim = lambdapic_torch.Simulation(
            nx=nx, ny=48, dx=dx, dy=dx, tiling="cell", random_seed=4,
            precision="double", device=dev)
        sim.add_species([
            lambdapic_torch.Electron(density=density, ppc=4,
                                     momentum=(ux, ux, None)),
            lambdapic_torch.Proton(density=density, ppc=2)])
        sim.run(10, callbacks=[lambdapic_torch.GaussianLaser2D(
            a0=2, l0=l0, w0=0.6 * um, ctau=0.5 * um, x0=0.0)])
        states.append(state_to_numpy(sim.state))
    ref, got = states
    for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz"):
        a, b = getattr(got.fields, k), getattr(ref.fields, k)
        np.testing.assert_allclose(a, b, rtol=1e-9,
                                   atol=1e-9 * np.abs(b).max(), err_msg=k)
    for pr, pg in zip(ref.particles, got.particles):
        assert int(pr.overflow.sum()) == int(pg.overflow.sum())
        compare_slots({k: v[0, 0] for k, v in pr.data.items()},
                      pr.alive[0, 0],
                      {k: v[0, 0] for k, v in pg.data.items()},
                      pg.alive[0, 0], rtol=1e-9)


def test_qed_simulation_on_card_matches_cpu(cuda):
    """Six float64 steps of radiating electrons in a strong uniform Bz
    (chi ~ 1) through Simulation.run: the card (B2 want_chi and photon
    kernels, the draws on the card) against the CPU (plain versions,
    draws on the CPU). The draws are bitwise equal, so the same photons
    are born in the same slots."""
    import lambdapic_torch
    from lambdapic_torch.constants import c, e, hbar, m_e
    from lambdapic_torch.core import species as t_species
    from lambdapic_torch.core.state import state_to_numpy
    bc = {k: "periodic" for k in ("xmin", "xmax", "ymin", "ymax")}
    n, gamma = 300, 2000.0
    ux = np.sqrt(gamma**2 - 1)
    rng = np.random.default_rng(0)
    coords = {"x": rng.uniform(0.5e-6, 2.5e-6, n),
              "y": rng.uniform(0.5e-6, 2.5e-6, n)}
    attrs = {"w": np.ones(n), "ux": np.full(n, ux), "uy": np.zeros(n),
             "uz": rng.normal(0, 50, n), "inv_gamma": np.full(n, 1 / gamma)}
    bz = 1.0 / (e * hbar / (m_e**2 * c**3) * c * ux)
    states = []
    for dev in ("cpu", cuda):
        t_species._ALL_SPECIES.clear()
        pho = lambdapic_torch.Photon(capacity=4096)
        ele = lambdapic_torch.Electron(radiation="photons")
        ele.set_photon(pho)
        sim = lambdapic_torch.Simulation(
            nx=32, ny=32, dx=1e-7, dy=1e-7, boundary_conditions=bc,
            tiling="cell", random_seed=3, precision="double", device=dev)
        sim.add_species([ele, pho])
        sim.initialize()
        sim.set_particles_global(0, coords, attrs)
        sim.set_field("bz", np.full((32, 32), bz))
        sim.run(6)
        states.append(state_to_numpy(sim.state))
    ref, got = states
    assert int(ref.particles[1].alive.sum()) > 0
    for pr, pg in zip(ref.particles, got.particles):
        assert int(pr.alive.sum()) == int(pg.alive.sum())
        assert int(pr.overflow.sum()) == int(pg.overflow.sum())
        assert int(pr.next_id.sum()) == int(pg.next_id.sum())
        keys = SLOT_FLOATS + tuple(k for k in QED_PAYLOADS if k in pr.data)
        compare_slots({k: v[0, 0] for k, v in pr.data.items()},
                      pr.alive[0, 0],
                      {k: v[0, 0] for k, v in pg.data.items()},
                      pg.alive[0, 0], rtol=1e-9, keys=keys)


# -- the 3D forms ------------------------------------------------------------

BC3 = {
    "pml": ("pml",) * 6,
    "periodic": ("periodic",) * 6,
    "mixed": ("pml", "pml", "periodic", "periodic", "pml", "pml"),
}


@pytest.mark.parametrize("bc", sorted(BC3))
def test_b1_3d_matches_plain(cuda, bc):
    from lambdapic_torch.core.state import PSI_COMPONENTS
    names = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")
    grid = Grid(dimension=3, nx=20, ny=18, nz=22, dx=1e-6, dy=0.8e-6,
                dz=1.2e-6, npatch_x=1, npatch_y=1, npatch_z=1, n_guard=3,
                cpml_thickness=6,
                boundary_conditions=tuple(zip(names, BC3[bc])))
    dt = 0.95 / np.sqrt(grid.dx**-2 + grid.dy**-2 + grid.dz**-2) / 3e8
    cpml = build_cpml(grid, dt, CPMLParams()) if bc != "periodic" else None
    rng = np.random.default_rng(0)

    def t(shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale).to(cuda)

    f = FieldsState(**{k: t(grid.shape, 1e-8 if k[0] == "b" else 1.0)
                       for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx",
                                 "jy", "jz", "rho")})
    if cpml is not None:
        for axis, ax in enumerate("xyz"):
            if cpml.axis(ax) is None:
                continue
            shape = list(grid.shape)
            shape[axis] = cpml.psi_width(ax)
            for c in PSI_COMPONENTS[ax]:
                f.psi[f"psi_{c}_{ax}"] = t(shape, 1e-3)
    for k_fn, p_fn in ((update_efield_k, maxwell.update_efield),
                       (update_bfield_k, maxwell.update_bfield)):
        before = update_half_k.launches
        got, ref = k_fn(f, grid, dt / 2, cpml), p_fn(f, grid, dt / 2, cpml)
        assert update_half_k.launches == before + 1
        for k in ("ex", "ey", "ez", "bx", "by", "bz"):
            a, b = getattr(got, k), getattr(ref, k)
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-12 * float(b.abs().max()))
        assert set(got.psi) == set(ref.psi)
        for k in ref.psi:
            torch.testing.assert_close(got.psi[k], ref.psi[k], rtol=0,
                                       atol=1e-12 * float(ref.psi[k].abs().max()))


@pytest.mark.parametrize("cap,nx,ny,nz,periodic,n_frac", [
    (4, 8, 8, 8, (True, True, True), 0.4),
    (6, 12, 10, 20, (False, False, False), 0.4),
    (4, 10, 18, 9, (True, False, True), 0.9),
    (20, 9, 8, 11, (False, True, False), 0.5),
])
def test_b2_b3_3d_match_plain(cuda, cap, nx, ny, nz, periodic, n_frac):
    data, alive, eb = random_cell_state(cap, nx, ny, nz, n_frac=n_frac,
                                        seed=cap + nx)
    td, ta = to_torch(data, alive, torch.float64, cuda)
    eb = torch.as_tensor(eb).to(cuda)
    rims_in = torch.as_tensor(np.random.default_rng(1).normal(
        size=panel_shape(4, nx, ny, nz))).to(cuda)
    kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DX, dz=DX, g=3, periodic=periodic,
              rims_in=rims_in)
    ref = cell_step_plain(eb, td, ta, **kw)
    before = cell_step.launches
    got = cell_step(eb, td, ta, **kw)
    torch.cuda.synchronize()
    assert cell_step.launches == before + 1
    compare_slots(*to_numpy(ref[0], ref[1]), *to_numpy(got[0], got[1]),
                  rtol=1e-11)
    assert int(got[2]) == int(ref[2])
    if n_frac > 0.8:
        assert int(ref[2]) > 0
    torch.testing.assert_close(got[3], ref[3], rtol=0,
                               atol=1e-12 * float(ref[3].abs().max()))
    jr = fold_reduce_plain(ref[3], (nx, ny, nz), periodic)
    before = fold_reduce.launches
    jk = fold_reduce(ref[3], (nx, ny, nz), periodic)
    assert fold_reduce.launches == before + 1
    torch.testing.assert_close(jk, jr, rtol=0,
                               atol=1e-12 * float(jr.abs().max()))


def test_simulation3d_on_card_matches_cpu(cuda):
    """Six float64 steps of a small 3D laser-target through
    Simulation3D.run: the kernel path on the card against the plain path
    on the CPU."""
    import lambdapic_torch
    from lambdapic_torch.core import species as t_species
    from lambdapic_torch.core.state import state_to_numpy
    um = 1e-6
    l0 = 0.8 * um
    nx, dx = 32, l0 / 10

    def density(x, y, z):
        return np.where(x > 1.2 * um, 2 * 1.742e27, 0.0)

    def uy(x, y, z):
        return 1.5 * np.sin(2 * np.pi * z / (16 * 2 * dx))

    states = []
    for dev in ("cpu", cuda):
        t_species._ALL_SPECIES.clear()
        sim = lambdapic_torch.Simulation3D(
            nx=nx, ny=16, nz=16, dx=dx, dy=2 * dx, dz=2 * dx, tiling="cell",
            random_seed=4, precision="double", device=dev,
            particle_capacity_factor=4.0)
        sim.add_species([
            lambdapic_torch.Electron(density=density, ppc=2,
                                     momentum=(uy, uy, uy)),
            lambdapic_torch.Proton(density=density, ppc=2)])
        sim.run(6, callbacks=[lambdapic_torch.GaussianLaser3D(
            a0=2, l0=l0, w0=0.6 * um, ctau=0.5 * um, x0=0.0)])
        states.append(state_to_numpy(sim.state, dimension=3))
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


# ---------------------------------------------------------------------------
# the per-stage kernels B4-B7
# ---------------------------------------------------------------------------

STAGE_CASES = [
    # (cap, nx, ny, periodic, n_frac)
    (13, 18, 10, (True, True), 0.5),
    (16, 15, 12, (False, True), 0.9),
    (20, 12, 16, (True, False), 1.0),
    (4, 33, 18, (False, False), 0.9),
    # the edges of B6's 2D tiles (csrc/migrate.cu: 2D slots (nx, ny) as 3D
    # slots (1, nx, ny); along x tiles of 32 y cells by 8 x cells at up to
    # 8 slots a cell, 32 x 4 at 16, 16 x 4 at 32; along y rows of 256 (128
    # where they are whole), 128 and 64 cells): x one cell, y over one
    # row and not a multiple of 4 (element copies); x two cells, y a
    # multiple of 4 (16-byte copies); x over several tiles at 16 and 20
    # slots, y over one row and not a multiple of its width; the tile
    # kernel's limit of 32 slots; one slot above it (one thread a cell)
    (8, 1, 299, (True, False), 0.9),
    (4, 2, 260, (False, True), 0.9),
    (16, 17, 132, (False, True), 0.9),
    (20, 9, 70, (True, True), 1.0),
    (32, 6, 65, (False, False), 1.0),
    (33, 5, 9, (True, False), 1.0),
]


def _b4_check(cp, eb, args, ta, dtype, **kw):
    """B4 2D against its plain version, launch counted by mode: every
    output bitwise in float64 and float32; every dead slot's dead values
    exactly (0, inv_gamma 1)."""
    ref = cp.fused_push_cell_2d_plain(eb, *args, alive=ta, **kw)
    mode = "want_eb" if kw["want_eb"] else "default"
    before = dict(cp.fused_push_cell_2d.launches_by_mode)
    got = cp.fused_push_cell_2d(eb, *args, alive=ta, **kw)
    torch.cuda.synchronize()
    assert cp.fused_push_cell_2d.launches_by_mode[mode] == before[mode] + 1
    assert len(got) == len(ref) == (12 if kw["want_eb"] else 6)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b), (i, dtype)
        assert bool((a[~ta] == (1.0 if i == 5 else 0.0)).all()), i
    assert bool(torch.isfinite(got[5]).all())


@pytest.mark.parametrize("want_eb", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_b4_matches_plain(cuda, want_eb, dtype):
    """The alive slots pushed and the dead ones given the dead values;
    with and without the first half push."""
    from lambdapic_torch.ops import cellpallas as cp
    data, alive, eb = random_cell_state(5, 33, 18, seed=7, field=5e13)
    td, ta = to_torch(data, alive, dtype, cuda)
    args = [td[k] for k in ("x", "y", "ux", "uy", "uz")]
    eb = torch.as_tensor(eb, dtype=dtype).to(cuda)
    for do_pos1 in (False, True):
        _b4_check(cp, eb, args, ta, dtype, q=Q, m=M, dt=DT, dx=DX,
                  dy=0.9 * DX, g=3, want_eb=want_eb, do_pos1=do_pos1)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_b5_matches_plain(cuda, dtype, tol):
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import deposit_cell_2d
    for cap, nx, ny, g in ((6, 24, 40, 3), (20, 33, 18, 2), (4, 16, 16, 4)):
        data, alive, _ = random_cell_state(cap, nx, ny, seed=cap, spread=0.99)
        td, ta = to_torch(data, alive, dtype, cuda)
        w = torch.where(ta, td["w"], 0.0)
        args = [td[k] for k in ("x", "y", "ux", "uy", "uz", "inv_gamma")]
        kw = dict(q=Q, dx=DX, dy=1.1 * DX, dt=DT, g=g)
        ref = deposit_cell_2d(*args, w, **kw)
        before = cp.deposit_cell_2d_k.launches
        got = cp.deposit_cell_2d_k(*args, w, alive=ta, **kw)
        torch.cuda.synchronize()
        assert cp.deposit_cell_2d_k.launches == before + 1
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=tol * float(ref.abs().max()))


# B4 2D and B5 2D at their edges, float64 against their plain versions.
# Random states (cap, nx, ny, g, n_frac):
#  ragged      neither B4's 8 x 32 tiles nor B5's 16 x 16 divide the grid;
#  above_64    70 slots a cell (the exact QED slice's electrons): the
#              alive bytes read a round at a time, B5's count path;
#  above_128   130 slots a cell, all alive;
#  long_x      nx + 2g over 65535 padded rows, more than B5's fold_pad
#              has blocks along y: each block folds every 65535th row.
B45_EDGE_CASES = {"ragged": (6, 13, 70, 2, 0.5),
                  "above_64": (70, 9, 35, 3, 0.9),
                  "above_128": (130, 5, 9, 3, 1.0),
                  "long_x": (2, 65600, 3, 2, 0.5)}
# 40 x 70 cells of 6 slots, one occupied cell (cell, its alive slots) or
# none: ``empty`` every tile writes its dead values (B4) or no panel
# (B5); ``corner`` the cell where four tiles of each kernel meet (B4's
# and B5's tiles both have a corner at (16, 32)); ``corner_below`` the
# cell diagonally below it
B45_CORNER_CASES = {"empty": (None, 0), "corner": ((16, 32), 4),
                    "corner_below": ((15, 31), 5)}


@pytest.mark.parametrize("name", list(B45_EDGE_CASES) +
                         list(B45_CORNER_CASES))
def test_b4_b5_edges_match_plain(cuda, name):
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import deposit_cell_2d
    from lambdapic_torch.testing import occupied_cell_state
    if name in B45_EDGE_CASES:
        cap, nx, ny, g, n_frac = B45_EDGE_CASES[name]
        data, alive, eb = random_cell_state(cap, nx, ny, g=g, seed=cap + nx,
                                            n_frac=n_frac, field=5e13)
    else:
        cell, per_cell = B45_CORNER_CASES[name]
        occ = np.zeros((40, 70), bool)
        if cell is not None:
            occ[cell] = True
        g = 3
        data, alive, eb = occupied_cell_state(6, occ, per_cell, seed=2,
                                              field=5e13)
    if name == "above_128":
        assert int(alive.sum(0).max()) > 128
    td, ta = to_torch(data, alive, torch.float64, cuda)
    args = [td[k] for k in ("x", "y", "ux", "uy", "uz")]
    eb = torch.as_tensor(eb).to(cuda)
    for want_eb in (False, True):
        _b4_check(cp, eb, args, ta, torch.float64, q=Q, m=M, dt=DT, dx=DX,
                  dy=0.9 * DX, g=g, want_eb=want_eb, do_pos1=True)
    w = torch.where(ta, td["w"], 0.0)
    a7 = [td[k] for k in ("x", "y", "ux", "uy", "uz", "inv_gamma")] + [w]
    kw = dict(q=Q, dx=DX, dy=1.1 * DX, dt=DT, g=g)
    ref = deposit_cell_2d(*a7, **kw)
    got = cp.deposit_cell_2d_k(*a7, alive=ta, **kw)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-12 * float(ref.abs().max()))
    if name == "empty":
        assert float(got.abs().max()) == 0
    else:
        assert float(ref.abs().max()) > 0


def test_b5_repeats_and_matches_b2_panels(cuda):
    """B5 2D sums in a fixed order: two identical calls give the same J
    bit for bit, in float64 and float32. Its panels are bit for bit those
    of B2 2D's deposit2 on the same slots (one routine,
    csrc/cell2d.cuh::deposit_panel): B2 runs a step of a sparse state,
    B5 deposits B2's output slots; a tile flagged by B5 holds B2's panel,
    and B2's panel of every other tile is zero."""
    from lambdapic_torch.ops import cellpallas as cp
    for case, cap in (("band", 8), ("corner", 8), ("crowded", 20)):
        data, alive, eb, per = sparse_cell_state(case, cap, seed=1)
        for dtype in (torch.float64, torch.float32):
            td, ta = to_torch(data, alive, dtype, cuda)
            ebt = torch.as_tensor(eb, dtype=dtype).to(cuda)
            out, oa, _, rims = cell_step(ebt, td, ta, q=Q, m=M, dt=DT, dx=DX,
                                         dy=DX, g=3, periodic=per,
                                         with_rho=True)[:4]
            w = torch.where(oa, out["w"], 0.0)
            a7 = [out[k] for k in ("x", "y", "ux", "uy", "uz",
                                   "inv_gamma")] + [w]
            kw = dict(q=Q, dx=DX, dy=DX, dt=DT, g=3, alive=oa)
            jpad, pan, flags = cp._deposit_panels_2d(*a7, **kw)
            again = cp.deposit_cell_2d_k(*a7, **kw)
            torch.cuda.synchronize()
            assert torch.equal(jpad, again), (case, dtype)
            f = flags.view(pan.shape[1], pan.shape[2]).bool()
            assert 0 < int(f.sum()) < f.numel(), case
            assert torch.equal(pan[:, f], rims[:, f]), (case, dtype)
            assert bool((rims[:, ~f] == 0).all()), (case, dtype)


def _stage_state(cap, nx, ny, n_frac, dtype, device, photon=False):
    from lambdapic_torch.testing import add_qed_payloads, crowded_cell_state
    data, alive, _ = crowded_cell_state(cap, nx, ny, n_frac=n_frac,
                                        seed=cap + nx)
    data = add_qed_payloads(data, seed=cap)
    if photon:
        u2 = data["ux"]**2 + data["uy"]**2 + data["uz"]**2
        data["inv_gamma"] = np.where(u2 > 0, 1 / np.sqrt(np.maximum(
            u2, 1e-30)), 1.0)
    return to_torch(data, alive, dtype, device)


def _assert_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cap,nx,ny,periodic,n_frac", STAGE_CASES)
def test_b6_matches_plain(cuda, dtype, cap, nx, ny, periodic, n_frac):
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import migrate_cells
    plan = ((nx, periodic[0], "x"), (ny, periodic[1], "y"))
    for photon in (False, True):
        td, ta = _stage_state(cap, nx, ny, n_frac, dtype, cuda, photon)
        ref = migrate_cells(td, ta, plan, recompute_ig=not photon)
        before = cp.migrate_axis.launches
        got = cp.migrate_cells_fused(td, ta, plan, recompute_ig=not photon)
        torch.cuda.synchronize()
        assert cp.migrate_axis.launches == before + 2
        assert torch.equal(got[1], ref[1])
        _assert_equal(got[0], ref[0])
        assert int(got[2]) == int(ref[2])
        if n_frac > 0.8:
            assert int(ref[2]) > 0


@pytest.mark.parametrize("cap", [13, 16, 20])
def test_b7_matches_plain(cuda, cap):
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import batcher_sort
    rng = np.random.default_rng(cap)
    shape = (cap, 17, 9)
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


def test_per_stage_wrappers_reject_bad_operands(cuda):
    from lambdapic_torch.ops import cellpallas as cp
    data, alive, eb = random_cell_state(4, 16, 16)
    td, ta = to_torch(data, alive, torch.float64, cuda)
    eb = torch.as_tensor(eb).to(cuda)
    with pytest.raises(ValueError):
        cp.fused_push_cell_2d(eb, td["x"].float(), td["y"], td["ux"],
                              td["uy"], td["uz"], q=Q, m=M, dt=DT, dx=DX,
                              dy=DX, g=3, alive=ta)
    with pytest.raises(ValueError):
        cp.fused_push_cell_2d(eb, td["x"], td["y"], td["ux"], td["uy"],
                              td["uz"], q=Q, m=M, dt=DT, dx=DX, dy=DX, g=3,
                              alive=ta.to(torch.uint8))
    with pytest.raises(ValueError):
        cp.sort_cells(torch.zeros((4, 16, 16), dtype=torch.int64,
                                  device=cuda), [])
    with pytest.raises(ValueError):
        cp.deposit_cell_2d_k(*[td[k].transpose(1, 2) for k in ("x", "y", "ux", "uy",
                                                   "uz", "inv_gamma", "w")],
                             q=Q, dx=DX, dy=DX, dt=DT, g=3,
                             alive=ta.transpose(1, 2))


def test_per_stage_simulation_on_card_matches_cpu(cuda):
    """Six float64 steps of the tiny laser-target through Simulation.run
    with cell_migration="exact", and four split steps (an _interpolator
    callback), each through the kernels on the card against the plain
    path on the CPU."""
    import lambdapic_torch
    from lambdapic_torch.core import species as t_species
    from lambdapic_torch.core.state import state_to_numpy
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.testing import tiny_laser_target
    probe = lambdapic_torch.callback(stage="_interpolator")(lambda s: None)
    for kw, cbs in ((dict(cell_migration="exact"), []), ({}, [probe])):
        states = []
        for dev in ("cpu", cuda):
            t_species._ALL_SPECIES.clear()
            sim, laser = tiny_laser_target(lambdapic_torch, device=dev, **kw)
            before = (cp.fused_push_cell_2d.launches,
                      cp.migrate_axis.launches)
            sim.run(6, callbacks=[laser, *cbs])
            states.append(state_to_numpy(sim.state))
        if cbs:
            assert cp.migrate_axis.launches == before[1] + 6 * 2 * 2
        else:
            assert cp.fused_push_cell_2d.launches == before[0] + 6 * 2
        ref, got = states
        for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz"):
            a, b = getattr(got.fields, k), getattr(ref.fields, k)
            np.testing.assert_allclose(a, b, rtol=1e-9,
                                       atol=1e-9 * np.abs(b).max(), err_msg=k)
        for pr, pg in zip(ref.particles, got.particles):
            assert int(pr.overflow.sum()) == int(pg.overflow.sum())
            compare_slots({k: v[0, 0] for k, v in pr.data.items()},
                          pr.alive[0, 0],
                          {k: v[0, 0] for k, v in pg.data.items()},
                          pg.alive[0, 0], rtol=1e-9)


# Per-cell capacities above 128 (the sorting kernels' scratch variant):
# (cap, nx, ny, periodic, n_frac); cells hold more than 128 alive
# particles and the re-binning merges
BIGCAP_CASES = [(130, 12, 10, (True, False), 1.0),
                (256, 9, 7, (False, True), 0.9),
                (300, 5, 6, (True, True), 0.9)]


@pytest.mark.parametrize("cap,nx,ny,periodic,n_frac", BIGCAP_CASES)
def test_b2_bigcap_matches_plain(cuda, cap, nx, ny, periodic, n_frac):
    """B2 (default and want_chi modes) above 128 slots a cell, slot for
    slot, as at small caps."""
    data, alive, eb = random_cell_state(cap, nx, ny, n_frac=n_frac,
                                        seed=cap + nx, umax=50.0, field=5e13)
    assert int(alive.sum(0).max()) > 128
    data = add_qed_payloads(data, seed=cap)
    td, ta = to_torch(data, alive, torch.float64, cuda)
    eb = torch.as_tensor(eb).to(cuda)
    for want_chi in (False, True):
        kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DX, g=3, periodic=periodic,
                  want_chi=want_chi)
        ref = cell_step_plain(eb, td, ta, **kw)
        before = cell_step.launches
        got = cell_step(eb, td, ta, **kw)
        torch.cuda.synchronize()
        assert cell_step.launches == before + 1
        keys = SLOT_FLOATS + QED_PAYLOADS
        if want_chi:
            for out in (ref, got):
                out[0]["chi"], out[0]["ig0"] = out[4]
            keys += ("chi", "ig0")
        compare_slots(*to_numpy(ref[0], ref[1]), *to_numpy(got[0], got[1]),
                      rtol=1e-11, keys=keys)
        assert int(got[2]) == int(ref[2]) > 0
        torch.testing.assert_close(got[3], ref[3], rtol=0,
                                   atol=1e-12 * float(ref[3].abs().max()))


@pytest.mark.parametrize("cap,nx,ny,periodic,n_frac", BIGCAP_CASES)
def test_b6_bigcap_matches_plain(cuda, cap, nx, ny, periodic, n_frac):
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import migrate_cells
    plan = ((nx, periodic[0], "x"), (ny, periodic[1], "y"))
    for photon in (False, True):
        td, ta = _stage_state(cap, nx, ny, n_frac, torch.float64, cuda,
                              photon)
        ref = migrate_cells(td, ta, plan, recompute_ig=not photon)
        got = cp.migrate_cells_fused(td, ta, plan, recompute_ig=not photon)
        torch.cuda.synchronize()
        assert torch.equal(got[1], ref[1])
        _assert_equal(got[0], ref[0])
        assert int(got[2]) == int(ref[2]) > 0


@pytest.mark.parametrize("cap,cells", [(130, (17, 9)), (256, (17, 9)),
                                       (300, (5, 7)),
                                       # more cells than scratch rows
                                       (130, (600, 128))])
def test_b7_bigcap_matches_plain(cuda, cap, cells):
    from lambdapic_torch.ops import cellpallas as cp
    from lambdapic_torch.ops.cell2d import batcher_sort
    rng = np.random.default_rng(cap)
    shape = (cap,) + cells
    key = torch.as_tensor(rng.integers(-3, 6, shape).astype(np.int32)).to(cuda)
    pays = [torch.as_tensor(rng.normal(size=shape)).to(cuda),
            torch.as_tensor(rng.integers(-2**31, 2**31, shape).astype(
                np.int32)).to(cuda),
            torch.as_tensor(rng.uniform(size=shape) < 0.5).to(cuda)]
    rk, rp = batcher_sort(key, pays)
    gk, gp = cp.sort_cells(key, pays)
    torch.cuda.synchronize()
    assert torch.equal(gk, rk)
    for a, b in zip(gp, rp):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# B2 2D on sparse states: empty tiles skipped, arrivals into empty tiles
# ---------------------------------------------------------------------------

# (case, per-cell capacities) of testing.sparse_cell_state
SPARSE_CASES = [(case, cap) for case in ("band", "corner", "wrap", "open",
                                         "empty", "crowded")
                for cap in (8, 20, 82)]
SPARSE_CASES += [(case, cap) for case in ("band", "corner", "crowded")
                 for cap in (130, 256)]


def _check_b2_mode(cuda, data, alive, eb, periodic, mode, dtype):
    """B2 in ``mode`` against its plain version on one state: float64 slot
    for slot (compare_slots at rtol 1e-11; with want_chi also chi and ig0),
    float32 alive masks and the alive slots' ids identical; merges equal;
    panels to 1e-12 (float64) or 1e-5 (float32) of their peak, each chained
    from random rims_in. Returns the merge count."""
    nx, ny = alive.shape[1:]
    kw = dict(q=Q, m=M, dt=DT, dx=DX, dy=DX, g=3, periodic=periodic)
    data = dict(data)
    keys = SLOT_FLOATS
    if mode == "want_chi":
        data = add_qed_payloads(data, seed=3)
        kw["want_chi"] = True
        keys = SLOT_FLOATS + QED_PAYLOADS + ("chi", "ig0")
    elif mode == "photon":
        u2 = data["ux"]**2 + data["uy"]**2 + data["uz"]**2
        data["inv_gamma"] = np.where(u2 > 0, 1 / np.sqrt(np.maximum(u2, 1e-30)),
                                     1.0)
        kw.update(q=0.0, m=0.0, photon=True)
    td, ta = to_torch(data, alive, dtype, cuda)
    eb_t = None if mode == "photon" else torch.as_tensor(eb, dtype=dtype).to(cuda)
    if mode != "photon":
        kw["rims_in"] = torch.as_tensor(np.random.default_rng(1).normal(
            size=panel_shape(4, nx, ny)), dtype=dtype).to(cuda)
    ref = cell_step_plain(eb_t, td, ta, **kw)
    before = cell_step.launches_by_mode[mode]
    got = cell_step(eb_t, td, ta, **kw)
    torch.cuda.synchronize()
    assert cell_step.launches_by_mode[mode] == before + 1
    assert int(got[2]) == int(ref[2])
    if mode == "want_chi":
        for out in (ref, got):
            out[0]["chi"], out[0]["ig0"] = out[4]
    if dtype == torch.float64:
        compare_slots(*to_numpy(ref[0], ref[1]), *to_numpy(got[0], got[1]),
                      rtol=1e-11, keys=keys)
    else:
        assert torch.equal(got[1], ref[1])
        for k in ("id_lo", "id_hi"):
            assert torch.equal(got[0][k][got[1]], ref[0][k][ref[1]])
    if mode == "photon":
        assert got[3] is None
    else:
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        torch.testing.assert_close(got[3], ref[3], rtol=0,
                                   atol=tol * float(ref[3].abs().max()))
    return int(ref[2])


@pytest.mark.parametrize("case,cap", SPARSE_CASES)
def test_b2_sparse_matches_plain(cuda, case, cap):
    """B2's default, want_chi and photon modes on sparse states (empty
    tiles beside occupied ones, arrivals into empty tiles, faces, merges),
    in float64 and float32, against the plain version."""
    data, alive, eb, periodic = sparse_cell_state(case, cap, seed=cap)
    if case == "empty":
        assert not alive.any()
    else:
        assert alive.any() and not alive.any(axis=0).all()
    merged = 0
    for mode in ("default", "want_chi", "photon"):
        for dtype in (torch.float64, torch.float32):
            merged += _check_b2_mode(cuda, data, alive, eb, periodic, mode,
                                     dtype)
    if case == "crowded":
        assert merged > 0
