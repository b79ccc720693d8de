"""3D set-up of the port against the JAX package: identical particle
fill and cell binning, identical CPML profiles on three axes, the 3D
numpy state carried across and back (``dimension=3``), and the JAX
Simulation's arguments that the port accepts."""
import numpy as np
import pytest
import torch

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_tpu.core.grid import Grid as JGrid
from lambdapic_tpu.ops.cpml import CPMLParams as JParams, build_cpml as j_build
from lambdapic_tpu.simulation import initfill as j_init

from lambdapic_torch.core.grid import Grid
from lambdapic_torch.core.state import state_from_numpy, state_to_numpy
from lambdapic_torch.ops.cpml import CPMLParams, build_cpml
from lambdapic_torch.simulation import initfill as t_init

UM = 1e-6
NC = 1.742e27
FACES = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")
SIZE = dict(nx=20, ny=14, nz=16, dx=0.05 * UM, dy=0.04 * UM, dz=0.06 * UM)


@pytest.fixture(autouse=True)
def clear_registries():
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()
    yield
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()


def _grid_kw(bc=("pml",) * 6):
    return dict(dimension=3, npatch_x=1, npatch_y=1, npatch_z=1, n_guard=3,
                cpml_thickness=6,
                boundary_conditions=tuple(sorted(zip(FACES, bc))), **SIZE)


def _density(x, y, z):
    return np.where((x > 0.3 * UM) & (x < 0.8 * UM), 10 * NC, 0.0)


def _scalar_density(x, y, z):
    return 5 * NC if 0.2 * UM < x < 0.6 * UM and z > 0.3 * UM else 0.0


def _momentum(x, y, z):
    return 0.3 * np.sin(y / UM * 3) + 0.1 * np.cos(z / UM * 5)


def _species(pkg):
    return [pkg.Electron(density=_density, ppc=3, momentum=(_momentum, None,
                                                            _momentum)),
            pkg.Proton(density=_scalar_density, ppc=2),
            pkg.Species(name="C", charge=6, mass=12 * 1800,
                        density=_density, ppc=1)]


def test_fill_and_bin_3d_bitwise_equal():
    jg, tg = JGrid(**_grid_kw()), Grid(**_grid_kw())
    assert tg.shape == jg.shape and tg.mesh_shape == jg.mesh_shape
    assert tg.Lz == jg.Lz
    for ispec, (js, ts) in enumerate(zip(_species(j_species),
                                         _species(t_species))):
        assert ts.is_compatible(3) and not ts.is_compatible(2)
        jc = j_init.count_macro_particles(jg, js)
        tc = t_init.count_macro_particles(tg, ts)
        np.testing.assert_array_equal(tc, jc)
        assert int(jc.sum()) > 0
        cap = j_init.pick_capacity(jc, 2.0)
        ja, jn = j_init.fill_species(jg, js, 7, ispec, cap)
        ta, tn = t_init.fill_species(tg, ts, 7, ispec, cap)
        np.testing.assert_array_equal(tn, jn)
        assert set(ta) == set(ja)
        for k in ja:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
        jb, jal, jcap = j_init.bin_cells(ja, jn, jg, factor=2.0)
        tb, tal, tcap = t_init.bin_cells(ta, tn, tg, factor=2.0)
        assert tcap == jcap
        assert tal.shape == (1, 1, 1, tcap, SIZE["nx"], SIZE["ny"], SIZE["nz"])
        np.testing.assert_array_equal(tal, jal)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("bc", [
    ("pml",) * 6, ("periodic",) * 6,
    ("pml", "pml", "periodic", "periodic", "pml", "pml")])
def test_cpml_profiles_3d_equal(bc):
    jg, tg = JGrid(**_grid_kw(bc)), Grid(**_grid_kw(bc))
    dt = 1e-17
    jc, tc = j_build(jg, dt, JParams()), build_cpml(tg, dt, CPMLParams())
    assert set(tc.profiles) == set(jc.profiles)
    assert ("z" in tc.profiles) == (bc[4] == "pml")
    for ax, prof in jc.profiles.items():
        assert tc.regions(ax) == jc.regions(ax)
        assert tc.psi_width(ax) == jc.psi_width(ax)
        for k, v in prof.items():
            np.testing.assert_array_equal(tc.profiles[ax][k], v, err_msg=k)


def test_initial_state_3d_and_round_trip():
    """The port's Simulation3D builds the JAX package's initial state bit
    for bit, and state_from_numpy / state_to_numpy round-trip it with
    dimension=3."""
    import jax
    from lambdapic_tpu import Simulation3D as JSim
    from lambdapic_torch import Simulation3D
    kw = dict(tiling="cell", random_seed=3, precision="double", **SIZE)
    jsim = JSim(npatch_x=1, npatch_y=1, npatch_z=1, **kw)
    jsim.add_species(_species(j_species))
    jsim.initialize()
    jstate = jax.device_get(jsim.state)

    tsim = Simulation3D(device="cpu", **kw)
    tsim.add_species(_species(t_species))
    tsim.initialize()
    assert tsim.dt == jsim.dt
    assert tsim.Lz == jsim.Lz and tsim.nz_per_patch == SIZE["nz"]

    def assert_same(a, b):
        fa, fb = a.fields, b.fields
        for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho"):
            np.testing.assert_array_equal(np.asarray(getattr(fa, k)),
                                          np.asarray(getattr(fb, k)))
        assert set(fa.psi) == set(fb.psi) and len(fb.psi) == 12
        for k in fb.psi:
            np.testing.assert_array_equal(np.asarray(fa.psi[k]),
                                          np.asarray(fb.psi[k]), err_msg=k)
        for pa, pb in zip(a.particles, b.particles):
            assert set(pa.data) == set(pb.data)
            for k in pb.data:
                va, vb = np.asarray(pa.data[k]), np.asarray(pb.data[k])
                assert va.dtype == vb.dtype, k
                np.testing.assert_array_equal(va, vb, err_msg=k)
            np.testing.assert_array_equal(np.asarray(pa.alive),
                                          np.asarray(pb.alive))
            np.testing.assert_array_equal(np.asarray(pa.next_id),
                                          np.asarray(pb.next_id))
            np.testing.assert_array_equal(np.asarray(pa.overflow),
                                          np.asarray(pb.overflow))

    assert_same(state_to_numpy(tsim.state, dimension=3), jstate)
    back = state_from_numpy(jstate, "cpu", dimension=3)
    assert back.particles[0].alive.ndim == 4
    assert back.particles[0].data["id_lo"].dtype == torch.int32
    assert_same(state_to_numpy(back, dimension=3), jstate)


def test_simulation3d_validation():
    from lambdapic_torch import Simulation3D
    kw = dict(nx=16, ny=16, dx=1e-7, dy=1e-7, device="cpu", tiling="cell")
    with pytest.raises(ValueError, match="nz and dz"):
        Simulation3D(**kw)
    sim = Simulation3D(nz=16, dz=2e-7, **kw)
    assert sorted(sim.boundary_conditions) == sorted(FACES)
    from lambdapic_torch.constants import c
    assert sim.dt == 0.95 * (1e-7**-2 + 1e-7**-2 + 2e-7**-2)**-0.5 / c
    # a 3D device mesh runs since the mesh slice; one larger than its
    # device list raises
    with pytest.raises(ValueError, match="need 2 devices"):
        Simulation3D(nz=16, dz=2e-7, npatch_x=1, npatch_y=1, npatch_z=2,
                     **kw).initialize()
    with pytest.raises(ValueError):
        Simulation3D(nz=16, dz=2e-7, boundary_conditions={
            **{f: "pml" for f in FACES}, "zmax": "periodic"}, **kw
        ).initialize()
    with pytest.raises(ValueError, match="thickness"):
        Simulation3D(nz=6, dz=2e-7, **kw).initialize()


@pytest.mark.parametrize("arg,ok,bad_value,todo", [
    ("migration_buffer", 256, -1, None),
    ("recap_threshold", 0.5, 1.5, None),
    ("tiling_backend", "auto", "cuda", "xla"),
    ("enable_timer", False, "yes", True),
])
def test_jax_simulation_arguments_accepted(arg, ok, bad_value, todo):
    """Arguments of the JAX Simulation that a user script may pass: each
    is accepted and validated; the values the port cannot honour yet are
    refused with their ROADMAP item at initialize."""
    from lambdapic_tpu import Simulation as JSim
    from lambdapic_torch import Simulation
    kw = dict(nx=16, ny=16, dx=1e-7, dy=1e-7, tiling="cell")
    assert getattr(JSim(npatch_x=1, npatch_y=1, **kw), arg) == \
        getattr(Simulation(device="cpu", **kw), arg)
    sim = Simulation(device="cpu", **{arg: ok}, **kw)
    sim.initialize()
    assert getattr(sim, arg) == ok
    with pytest.raises(ValueError, match=arg):
        Simulation(device="cpu", **{arg: bad_value}, **kw)
    if todo is not None:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Simulation(device="cpu", **{arg: todo}, **kw).initialize()
