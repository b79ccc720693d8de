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
    to_numpy, to_torch

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
