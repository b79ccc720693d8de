"""Set-up of the port against the JAX package: identical particle fill
and cell binning, identical CPML profiles, the numpy state carried
across and back, the import boundary, and the device rule."""
import ast
import os
import subprocess
import sys
from pathlib import Path

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

REPO = Path(__file__).resolve().parent.parent
UM = 1e-6
NC = 1.742e27


@pytest.fixture(autouse=True)
def clear_registries():
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()
    yield
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()


def _grid_kw(nx=32, ny=24, bc="pml"):
    names = ("xmin", "xmax", "ymin", "ymax")
    return dict(dimension=2, nx=nx, ny=ny, dx=0.05 * UM, dy=0.04 * UM,
                npatch_x=1, npatch_y=1, n_guard=3, cpml_thickness=6,
                boundary_conditions=tuple(sorted((n, bc) for n in names)))


def _density(x, y):
    return np.where((x > 0.6 * UM) & (x < 1.2 * UM), 10 * NC, 0.0)


def _scalar_density(x, y):
    return 5 * NC if 0.4 * UM < x < 1.0 * UM and y > 0.3 * UM else 0.0


def _momentum(x, y):
    return 0.3 * np.sin(y / UM * 3)


def _species(pkg):
    return [pkg.Electron(density=_density, ppc=3, momentum=(_momentum, None,
                                                            _momentum)),
            pkg.Proton(density=_scalar_density, ppc=2),
            pkg.Species(name="C", charge=6, mass=12 * 1800,
                        density=_density, ppc=1)]


def test_fill_and_bin_bitwise_equal():
    jg, tg = JGrid(**_grid_kw()), Grid(**_grid_kw())
    for ispec, (js, ts) in enumerate(zip(_species(j_species),
                                         _species(t_species))):
        jc = j_init.count_macro_particles(jg, js)
        tc = t_init.count_macro_particles(tg, ts)
        np.testing.assert_array_equal(tc, jc)
        cap = j_init.pick_capacity(jc, 2.0)
        assert t_init.pick_capacity(tc, 2.0) == cap
        ja, jn = j_init.fill_species(jg, js, 7, ispec, cap)
        ta, tn = t_init.fill_species(tg, ts, 7, ispec, cap)
        np.testing.assert_array_equal(tn, jn)
        assert set(ta) == set(ja)
        for k in ja:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
        jb, jal, jcap = j_init.bin_cells(ja, jn, jg, factor=2.0)
        tb, tal, tcap = t_init.bin_cells(ta, tn, tg, factor=2.0)
        assert tcap == jcap
        np.testing.assert_array_equal(tal, jal)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("bc", ["pml", "periodic"])
def test_cpml_profiles_equal(bc):
    jg, tg = JGrid(**_grid_kw(bc=bc)), Grid(**_grid_kw(bc=bc))
    dt = 1e-17
    jc, tc = j_build(jg, dt, JParams()), build_cpml(tg, dt, CPMLParams())
    assert set(tc.profiles) == set(jc.profiles)
    for ax, prof in jc.profiles.items():
        assert tc.regions(ax) == jc.regions(ax)
        assert tc.psi_width(ax) == jc.psi_width(ax)
        for k, v in prof.items():
            np.testing.assert_array_equal(tc.profiles[ax][k], v, err_msg=k)


def _jax_sim(**kw):
    from lambdapic_tpu import Simulation as JSim
    sim = JSim(nx=32, ny=24, dx=0.05 * UM, dy=0.04 * UM, npatch_x=1,
               npatch_y=1, tiling="cell", random_seed=3, precision="double",
               **kw)
    sim.add_species(_species(j_species))
    return sim


def test_initial_state_and_round_trip():
    """The port's Simulation builds the JAX package's initial state bit
    for bit, and state_from_numpy / state_to_numpy round-trip it."""
    import jax
    from lambdapic_torch import Simulation
    jsim = _jax_sim()
    jsim.initialize()
    jstate = jax.device_get(jsim.state)

    tsim = Simulation(nx=32, ny=24, dx=0.05 * UM, dy=0.04 * UM, tiling="cell",
                      random_seed=3, precision="double", device="cpu")
    tsim.add_species(_species(t_species))
    tsim.initialize()
    assert tsim.dt == jsim.dt

    def assert_same(a, b):
        fa, fb = a.fields, b.fields
        for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho"):
            np.testing.assert_array_equal(np.asarray(getattr(fa, k)),
                                          np.asarray(getattr(fb, k)))
        assert set(fa.psi) == set(fb.psi)
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

    assert_same(state_to_numpy(tsim.state), jstate)
    assert_same(state_to_numpy(state_from_numpy(jstate, "cpu")), jstate)
    assert state_from_numpy(jstate, "cpu").particles[0].data["id_lo"].dtype \
        == torch.int32


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                getattr(node.func, "id", getattr(node.func, "attr", "")) in (
                    "__import__", "import_module"):
            yield str(node.args[0].value)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "lambdapic_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert {"random.py", "qed.py", "qed_tables.py", "cellpallas.py",
            "mesh.py", "halo.py", "distributed.py"} <= \
        {f.name for f in files}
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "lambdapic_tpu"), (f, mod)
    code = ("import sys, lambdapic_torch, lambdapic_torch.testing\n"
            "import lambdapic_torch.simulation.simulation\n"
            "import lambdapic_torch.models.qed, lambdapic_torch.random\n"
            "import lambdapic_torch.ops.cellpallas\n"
            "import lambdapic_torch.simulation.step\n"
            "import lambdapic_torch.parallel.mesh\n"
            "import lambdapic_torch.parallel.halo\n"
            "import lambdapic_torch.parallel.distributed\n"
            "from lambdapic_torch.simulation.step import MeshStepBuilder\n"
            "from lambdapic_torch.ops.cellslab import cell_step_mesh\n"
            "lambdapic_torch.models.qed._make_tables('photon', "
            "lambdapic_torch.random.torch.float32)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'lambdapic_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(REPO), timeout=120)


def test_simulation_device_rule():
    """Entry points run on CUDA unless asked for the CPU; without a card
    they raise instead of falling back."""
    from lambdapic_torch import Simulation
    kw = dict(nx=16, ny=16, dx=1e-7, dy=1e-7, tiling="cell")
    assert Simulation(device="cpu", **kw).device.type == "cpu"
    if torch.cuda.is_available():
        assert Simulation(**kw).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Simulation(**kw)


def test_config_validation_and_unported_options():
    from lambdapic_torch import Simulation
    kw = dict(nx=16, ny=16, dx=1e-7, dy=1e-7, device="cpu")
    with pytest.raises(ValueError):
        Simulation(nsteps=5, sim_time=1e-15, **kw)
    with pytest.raises(ValueError):
        Simulation(**{**kw, "nx": 0})
    with pytest.raises(ValueError):
        Simulation(dt_cfl=1.5, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulation(tiling=None, **kw).initialize()
    # a device mesh runs since the mesh slice; one larger than its device
    # list raises, and the tiled engine on a mesh names its item
    with pytest.raises(ValueError, match="need 2 devices"):
        Simulation(tiling="cell", npatch_x=2, npatch_y=1, **kw).initialize()
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1, item 15d"):
        Simulation(tiling=(8, 8), npatch_x=2, npatch_y=1,
                   **kw).initialize(devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError):
        t_species.Species(name="x", charge=1.5, mass=1.0)
    with pytest.raises(ValueError):
        t_species.Electron(pusher="leapfrog")


@pytest.mark.parametrize("case", ["pairs", "spin", "tbmt", "qed3d"])
def test_unported_qed_options_name_their_roadmap_item(case):
    """QED photon emission and the photon pusher are accepted, in 2D and
    (since it was ported) in 3D: the "qed3d" case initialises and steps;
    pair production, spin and the "boris+tbmt" pusher raise, naming
    ROADMAP item 9."""
    from lambdapic_torch import Electron, Photon, Simulation, Simulation3D
    kw = dict(nx=16, ny=16, dx=1e-7, dy=1e-7, tiling="cell", device="cpu")
    t_species._ALL_SPECIES.clear()
    ele = Electron(radiation="photons", density=lambda x, y: 1e26 + 0 * x,
                   ppc=1)
    pho = Photon(capacity=256)
    ele.set_photon(pho)
    ok = Simulation(**kw).add_species([ele, pho])
    ok.initialize()
    assert len(ok._qed_processes) == 1
    assert ok._species_static[1].cap == ok._species_static[0].cap
    if case == "pairs":
        pos = Electron(name="positron")
        pho.set_bw_pair(electron=ele, positron=pos)
        sim = Simulation(**kw).add_species([ele, pho, pos])
    elif case == "spin":
        sim = Simulation(**kw).add_species([Electron(polarization=(0, 0, 1))])
    elif case == "tbmt":
        sim = Simulation(**kw).add_species([Electron(pusher="boris+tbmt")])
    else:
        sim = Simulation3D(nz=8, dz=1e-7, **kw).add_species([
            Electron(radiation="photons",
                     density=lambda x, y, z: 1e26 + 0 * x, ppc=1),
            Photon(capacity=256)])
        sim.species[0].set_photon(sim.species[1])
        sim.run(1)
        assert len(sim._qed_processes) == 1 and sim.itime == 1
        assert sim._species_static[1].cap == sim._species_static[0].cap
        assert sim.npart_alive[0] == 16 * 16 * 8
        t_species._ALL_SPECIES.clear()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 9"):
        sim.initialize()
    t_species._ALL_SPECIES.clear()
