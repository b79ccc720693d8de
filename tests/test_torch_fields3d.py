"""The port's 3D fields half-steps (plain version of kernel B1 in 3D,
lambdapic_torch/ops/maxwell.py) against lambdapic_tpu/ops/maxwell.py on
the same random fields, with periodic, PML and mixed faces, the CPML psi
of all three axes included, at rtol 1e-12 (float64); and the port's 3D
laser injection and laser addition against lambdapic_tpu/models/laser.py
at rtol 1e-12."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lambdapic_tpu.core.grid import Grid as JGrid
from lambdapic_tpu.core.state import FieldsState as JFields
from lambdapic_tpu.models import laser as j_laser
from lambdapic_tpu.ops import maxwell as j_maxwell
from lambdapic_tpu.ops.cpml import CPMLParams as JParams, build_cpml as j_build

from lambdapic_torch.core.grid import Grid
from lambdapic_torch.core.state import PSI_COMPONENTS, FieldsState
from lambdapic_torch.models import laser as t_laser
from lambdapic_torch.ops import maxwell
from lambdapic_torch.ops.cpml import CPMLParams, build_cpml
from lambdapic_torch.ops.fieldskernel import (half_coeffs, update_bfield_k,
                                              update_efield_k)

NAMES = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")
FACES = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")
BCS = {
    "periodic": ("periodic",) * 6,
    "pml": ("pml",) * 6,
    "mixed": ("pml", "pml", "periodic", "periodic", "pml", "pml"),
    "mixed_z": ("periodic", "periodic", "pml", "pml", "periodic", "periodic"),
}
UM = 1e-6


def _grids(bc, nx=16, ny=14, nz=18, d=1e-6, dimension=3):
    faces = FACES[:2 * dimension]
    kw = dict(dimension=dimension, nx=nx, ny=ny, dx=d, dy=0.8 * d, npatch_x=1,
              npatch_y=1, n_guard=3, cpml_thickness=6,
              boundary_conditions=tuple(sorted(zip(faces, BCS[bc]))))
    if dimension == 3:
        kw.update(nz=nz, dz=1.2 * d, npatch_z=1)
    return JGrid(**kw), Grid(**kw)


def _random_fields(grid, cpml, seed):
    rng = np.random.default_rng(seed)
    f = {k: rng.normal(size=grid.shape) for k in NAMES}
    for k in ("bx", "by", "bz"):
        f[k] *= 1e-8            # B ~ E / c
    psi = {}
    for axis, ax in enumerate("xyz"[:grid.dimension]):
        if cpml is None or cpml.axis(ax) is None:
            continue
        shape = list(grid.shape)
        shape[axis] = cpml.psi_width(ax)
        for comp in PSI_COMPONENTS[ax]:
            psi[f"psi_{comp}_{ax}"] = rng.normal(size=shape) * 1e-3
    return f, psi


def _setup(bc, seed=0, dimension=3):
    jg, tg = _grids(bc, dimension=dimension)
    dt = 0.95 / np.sqrt(sum(d**-2 for d in tg.deltas)) / 3e8
    any_pml = "pml" in BCS[bc]
    jc = j_build(jg, dt, JParams()) if any_pml else None
    tc = build_cpml(tg, dt, CPMLParams()) if any_pml else None
    f, psi = _random_fields(jg, jc, seed)
    jf = JFields(**{k: jnp.asarray(v) for k, v in f.items()},
                 psi={k: jnp.asarray(v) for k, v in psi.items()})
    tf = FieldsState(**{k: torch.as_tensor(v) for k, v in f.items()},
                     psi={k: torch.as_tensor(v) for k, v in psi.items()})
    return jg, tg, jc, tc, jf, tf, dt


def _assert_fields(tf, jf, rtol):
    for k in NAMES:
        ref = np.asarray(getattr(jf, k))
        np.testing.assert_allclose(getattr(tf, k).numpy(), ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max(), err_msg=k)
    assert set(tf.psi) == set(jf.psi)
    for k, v in jf.psi.items():
        ref = np.asarray(v)
        np.testing.assert_allclose(tf.psi[k].numpy(), ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max(), err_msg=k)


@pytest.mark.parametrize("bc", sorted(BCS))
def test_half_steps_3d_match_jax(bc):
    """Three rounds of E/2, B/2, B/2, E/2 (the step's field order)."""
    jg, tg, jc, tc, jf, tf, dt = _setup(bc)
    if bc == "pml":
        assert len(tf.psi) == 12
    for _ in range(3):
        for which in "ebbe":
            jfn = j_maxwell.update_efield if which == "e" else \
                j_maxwell.update_bfield
            tfn = maxwell.update_efield if which == "e" else \
                maxwell.update_bfield
            jf = jfn(jf, jg, dt / 2, jc)
            tf = tfn(tf, tg, dt / 2, tc)
    _assert_fields(tf, jf, 1e-12)


@pytest.mark.parametrize("bc", ["pml", "periodic"])
def test_kernel_wrapper_3d_uses_plain_on_cpu(bc):
    _, tg, _, tc, _, tf, dt = _setup(bc, seed=1)
    a = update_bfield_k(update_efield_k(tf, tg, dt, tc), tg, dt, tc)
    b = maxwell.update_bfield(maxwell.update_efield(tf, tg, dt, tc), tg, dt, tc)
    for k in NAMES:
        assert torch.equal(getattr(a, k), getattr(b, k))
    for k in b.psi:
        assert torch.equal(a.psi[k], b.psi[k])


def test_half_coeffs_rows_3d():
    """The 3D kernel's coefficient rows: 1/kappa along each axis, and each
    PML slab row mapped to its row of the slab-restricted psi array; an
    axis without PML has identity rows and no psi rows."""
    _, tg, _, tc, _, _, _ = _setup("mixed")
    for which in "eb":
        co = half_coeffs(tg, tc, which, torch.float64, "cpu")
        for ax, ik, r, w, n in (("x", co.ikx, co.rx, co.wx, tg.nx),
                                ("z", co.ikz, co.rz, co.wz, tg.nz)):
            prof = tc.axis(ax)
            np.testing.assert_array_equal(ik.numpy(),
                                          1.0 / prof["kappa_" + which])
            assert w == tc.psi_width(ax)
            rows = np.concatenate([np.arange(s, s + k)
                                   for s, k in tc.regions(ax)])
            np.testing.assert_array_equal(r.numpy()[rows],
                                          np.arange(len(rows)))
            assert (np.delete(r.numpy(), rows) == -1).all()
            assert len(r) == n
        np.testing.assert_array_equal(co.iky.numpy(), np.ones(tg.ny))
        assert co.wy == 0 and (co.ry.numpy() == -1).all()
        np.testing.assert_array_equal(co.bz.numpy(),
                                      tc.axis("z")["b_" + which])
        np.testing.assert_array_equal(co.cz.numpy(),
                                      tc.axis("z")["c_" + which])


# -- lasers --------------------------------------------------------------

class _Sim:
    """What Laser.host_scalars reads of a simulation."""

    def __init__(self, time):
        self.time = time


def _lasers(mod, dimension):
    suffix = f"{dimension}D"
    simple = getattr(mod, "SimpleLaser" + suffix)
    gauss = getattr(mod, "GaussianLaser" + suffix)
    return {
        "simple": lambda: simple(a0=3, w0=5 * UM, ctau=4 * UM, l0=0.8 * UM,
                                 pol_angle=0.3, ellipticity=0.5, cep=0.2,
                                 angle_y=0.1),
        "gauss": lambda: gauss(a0=5, l0=0.8 * UM, w0=4 * UM, ctau=5 * UM,
                               x0=3 * UM, focus_position=20 * UM,
                               ellipticity=1.0),
        "lg": lambda: gauss(a0=5, l0=0.8 * UM, w0=4 * UM, ctau=5 * UM,
                            x0=3 * UM, focus_position=20 * UM, l=1, p=1,
                            pol_angle=0.4),
        "sum": lambda: (simple(a0=3, w0=5 * UM, ctau=4 * UM, l0=0.8 * UM)
                        + gauss(a0=5, l0=0.8 * UM, w0=4 * UM, ctau=5 * UM,
                                x0=3 * UM, y0=9 * UM)),
    }


def _apply_both(kind, dimension, bc, time):
    jg, tg, _, _, jf, tf, dt = _setup(bc, seed=3, dimension=dimension)
    jl = _lasers(j_laser, dimension)[kind]()
    tl = _lasers(t_laser, dimension)[kind]()
    jsc, tsc = jl.host_scalars(_Sim(time)), tl.host_scalars(_Sim(time))
    return (jl.apply(jf, jg, dt, jsc), tl.apply(tf, tg, dt, tsc), jf, jsc,
            tsc, jl, tl)


@pytest.mark.parametrize("kind", ["simple", "gauss", "lg", "sum"])
@pytest.mark.parametrize("bc", ["pml", "mixed_z"])
def test_laser_3d_matches_jax(kind, bc):
    """One injection on random 3D fields, mid-pulse: the same host
    scalars, and bx, by, bz equal to 1e-12 of each field's peak."""
    jout, tout, jf, jsc, tsc, _, _ = _apply_both(kind, 3, bc, time=1.1e-14)
    assert float(tsc["on"]) == float(jsc["on"]) == 1.0
    _assert_fields(tout, jout, 1e-12)
    assert np.abs(np.asarray(jout.bz) - np.asarray(jf.bz)).max() > 0
    assert np.abs(np.asarray(jout.by) - np.asarray(jf.by)).max() > 0


@pytest.mark.parametrize("dimension", [2, 3])
def test_laser_addition_matches_jax(dimension):
    """laser1 + laser2: the combined source equals the JAX package's while
    both run, after the first has stopped, and after both have."""
    bc = "pml"
    ons = []
    for time in (1.1e-14, 3.0e-14, 2.0e-13):
        jout, tout, _, jsc, tsc, jl, tl = _apply_both("sum", dimension, bc,
                                                      time)
        assert float(tsc["on"]) == float(jsc["on"])
        assert [float(tsc[k]["on"]) for k in ("s1", "s2")] == \
            [float(jsc[k]["on"]) for k in ("s1", "s2")]
        assert tl.disabled == jl.disabled
        ons.append([float(tsc[k]["on"]) for k in ("s1", "s2")])
        _assert_fields(tout, jout, 1e-12)
    assert ons == [[1.0, 1.0], [0.0, 1.0], [0.0, 0.0]]
    with pytest.raises(TypeError):
        _lasers(t_laser, dimension)["gauss"]() + 3
