"""The port's fields half-steps (plain version of kernel B1,
lambdapic_torch/ops/maxwell.py) against lambdapic_tpu/ops/maxwell.py on
the same random fields, with periodic and with PML faces, CPML psi
included, at rtol 1e-12 (float64)."""
import numpy as np
import pytest
import torch

from lambdapic_tpu.core.grid import Grid as JGrid
from lambdapic_tpu.core.state import FieldsState as JFields
from lambdapic_tpu.ops import maxwell as j_maxwell
from lambdapic_tpu.ops.cpml import CPMLParams as JParams, build_cpml as j_build

from lambdapic_torch.core.grid import Grid
from lambdapic_torch.core.state import FieldsState
from lambdapic_torch.ops import maxwell
from lambdapic_torch.ops.cpml import CPMLParams, build_cpml
from lambdapic_torch.ops.fieldskernel import (half_coeffs, update_bfield_k,
                                              update_efield_k)

NAMES = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz", "rho")
BCS = {
    "periodic": {"xmin": "periodic", "xmax": "periodic",
                 "ymin": "periodic", "ymax": "periodic"},
    "pml": {"xmin": "pml", "xmax": "pml", "ymin": "pml", "ymax": "pml"},
    "mixed": {"xmin": "pml", "xmax": "pml", "ymin": "periodic",
              "ymax": "periodic"},
}


def _grids(bc, nx=24, ny=20, d=1e-6):
    kw = dict(dimension=2, nx=nx, ny=ny, dx=d, dy=0.8 * d, npatch_x=1,
              npatch_y=1, n_guard=3, cpml_thickness=6,
              boundary_conditions=tuple(sorted(bc.items())))
    return JGrid(**kw), Grid(**kw)


def _random_fields(grid, cpml, seed):
    rng = np.random.default_rng(seed)
    f = {k: rng.normal(size=grid.shape) for k in NAMES}
    for k in ("bx", "by", "bz"):
        f[k] *= 1e-8            # B ~ E / c
    psi = {}
    comps = {"x": ("ey", "ez", "by", "bz"), "y": ("ex", "ez", "bx", "bz")}
    for axis, ax in enumerate("xy"):
        if cpml is None or cpml.axis(ax) is None:
            continue
        shape = list(grid.shape)
        shape[axis] = cpml.psi_width(ax)
        for comp in comps[ax]:
            psi[f"psi_{comp}_{ax}"] = rng.normal(size=shape) * 1e-3
    return f, psi


def _setup(bc, seed=0):
    jg, tg = _grids(BCS[bc])
    dt = 0.95 / np.sqrt(jg.dx**-2 + jg.dy**-2) / 3e8
    any_pml = "pml" in BCS[bc].values()
    jc = j_build(jg, dt, JParams()) if any_pml else None
    tc = build_cpml(tg, dt, CPMLParams()) if any_pml else None
    f, psi = _random_fields(jg, jc, seed)
    import jax.numpy as jnp
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
def test_half_steps_match_jax(bc):
    """Three rounds of E/2, B/2, B/2, E/2 (the step's field order)."""
    jg, tg, jc, tc, jf, tf, dt = _setup(bc)
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
def test_kernel_wrapper_uses_plain_on_cpu(bc):
    _, tg, _, tc, _, tf, dt = _setup(bc, seed=1)
    a = update_bfield_k(update_efield_k(tf, tg, dt, tc), tg, dt, tc)
    b = maxwell.update_bfield(maxwell.update_efield(tf, tg, dt, tc), tg, dt, tc)
    for k in NAMES:
        assert torch.equal(getattr(a, k), getattr(b, k))
    for k in b.psi:
        assert torch.equal(a.psi[k], b.psi[k])


def test_half_coeffs_rows():
    """The kernel's coefficient rows: 1/kappa everywhere, and each PML
    slab row mapped to its row of the slab-restricted psi array."""
    _, tg, _, tc, _, _, _ = _setup("mixed")
    for which in "eb":
        co = half_coeffs(tg, tc, which, torch.float64, "cpu")
        prof = tc.axis("x")
        np.testing.assert_array_equal(co.ikx.numpy(), 1.0 / prof["kappa_" + which])
        np.testing.assert_array_equal(co.iky.numpy(), np.ones(tg.ny))
        assert co.wx == tc.psi_width("x") and co.wy == 0
        rows = np.concatenate([np.arange(s, s + w) for s, w in tc.regions("x")])
        rx = co.rx.numpy()
        np.testing.assert_array_equal(rx[rows], np.arange(len(rows)))
        assert (np.delete(rx, rows) == -1).all()
        assert (co.ry.numpy() == -1).all()
