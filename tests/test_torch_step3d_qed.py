"""The port's QED step in 3D end to end against the JAX package: a tiny
radiating Simulation3D (periodic 16 x 8 x 8 cells, float64): electrons of
Lorentz factor 2000 moving along x in a uniform Bz set for chi ~ 1 (as in
tests/test_torch_step_qed.py), protons with random momenta, and the
electrons' photon species. Both packages run it from the same seed on the
fused path (kernel B2's want_chi, default and photon modes in their plain
versions), on the exact path (``cell_migration="exact"``: the exact
re-binning, then B4's want_eb mode for the electrons) and on the split
path (an ``@callback(stage="_push_momentum")`` due every step).

A draw belongs to a slot, so each cell's slots must be in the same order
on both sides: the JAX side runs its XLA cell path on the CPU
(LAMBDAPIC_FIELDS_PALLAS=0) with its re-binning's sort swapped, for this
test only, for the Batcher compare-exchange list that the port (and the
TPU kernel) use; the exact scheme sorts stably on both sides and takes no
sort function. Slots are compared after canonicalisation (alive and ids
equal, positions, weights, momenta and inv_gamma to rtol 1e-11, chi to
rtol 1e-10, the optical depths and event flags exactly), fields to 1e-12
of their peak. Photons are emitted in every run.
"""
import numpy as np
import pytest

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.testing import SLOT_FLOATS, compare_slots, torch_threads

NSTEPS = 4
N_ELE = 200
N_PROTON = 300
NX, NY, NZ = 16, 8, 8
D = 1e-7
FIELDS = ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz")


@pytest.fixture(autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def clear_registries():
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()
    yield
    j_species._ALL_SPECIES.clear()
    t_species._ALL_SPECIES.clear()


@pytest.fixture
def batcher_jax(monkeypatch):
    """The JAX package's XLA cell path with the Batcher-order sort."""
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    from lambdapic_tpu.ops import cell2d as j_cell2d
    from test_torch_cell3d import batcher_sort_jnp
    xla_migrate = j_cell2d.migrate_cells

    def batcher_migrate(*args, sort_fn=None, **kw):
        return xla_migrate(*args, sort_fn=sort_fn or batcher_sort_jnp, **kw)
    monkeypatch.setattr(j_cell2d, "migrate_cells", batcher_migrate)


def _radiating_sim3d(pkg, **extra):
    """The tiny radiating Simulation3D of ``pkg``, initialised, with its
    electrons, protons and Bz set."""
    from lambdapic_torch.constants import c, e, hbar, m_e
    gamma, chi_target = 2000.0, 1.0
    bc = {k: "periodic" for k in ("xmin", "xmax", "ymin", "ymax", "zmin",
                                  "zmax")}
    pho = pkg.Photon(capacity=16384)
    ele = pkg.Electron(radiation="photons")
    ele.set_photon(pho)
    sim = pkg.Simulation3D(nx=NX, ny=NY, nz=NZ, dx=D, dy=D, dz=D,
                           boundary_conditions=bc, random_seed=3,
                           precision="double", tiling="cell", **extra)
    sim.add_species([ele, pkg.Proton(), pho])
    sim.initialize()
    rng = np.random.default_rng(1)

    def coords(n):
        return {a: rng.uniform(0.05, 0.95, n) * n_ * D
                for a, n_ in zip("xyz", (NX, NY, NZ))}
    ux = np.sqrt(gamma**2 - 1)
    sim.set_particles_global(0, coords(N_ELE), {
        "w": np.ones(N_ELE), "ux": np.full(N_ELE, ux),
        "uy": np.zeros(N_ELE), "uz": np.zeros(N_ELE),
        "inv_gamma": np.full(N_ELE, 1 / gamma)})
    u = rng.uniform(-0.5, 0.5, (3, N_PROTON))
    sim.set_particles_global(1, coords(N_PROTON), {
        "w": np.full(N_PROTON, 2.0), "ux": u[0], "uy": u[1], "uz": u[2],
        "inv_gamma": 1 / np.sqrt(1 + (u**2).sum(0))})
    bz = chi_target / (e * hbar / (m_e**2 * c**3) * c * ux)
    sim.set_field("bz", np.full((NX, NY, NZ), bz))
    return sim


def _run_both(cbs=(), **extra):
    """The JAX and the port Simulation3D after NSTEPS steps: (jax sim,
    its state, port sim, its state)."""
    import jax
    import lambdapic_tpu
    import lambdapic_torch
    jsim = _radiating_sim3d(lambdapic_tpu, npatch_x=1, npatch_y=1,
                            npatch_z=1, **extra)
    jsim.run(NSTEPS, callbacks=[cb for pkg, cb in cbs if pkg == "jax"])
    jstate = jax.device_get(jsim.state)
    tsim = _radiating_sim3d(lambdapic_torch, device="cpu", **extra)
    assert [p.cap for p in tsim.state.particles] == \
        [np.asarray(p.alive).shape[3] for p in jstate.particles]
    tsim.run(NSTEPS, callbacks=[cb for pkg, cb in cbs if pkg == "torch"])
    return jsim, jstate, tsim, state_to_numpy(tsim.state, dimension=3)


def _compare(jsim, jstate, tsim, tstate, extra_keys=()):
    assert [int(np.asarray(p.overflow).sum()) for p in tstate.particles] \
        == [int(np.asarray(p.overflow).sum()) for p in jstate.particles]
    assert tsim.npart_alive == jsim.npart_alive
    assert jsim.npart_alive[2] > 20           # photons were emitted
    assert int(np.asarray(tstate.particles[2].next_id).sum()) == \
        int(np.asarray(jstate.particles[2].next_id).sum())
    for k in FIELDS:
        ref = np.asarray(getattr(jstate.fields, k))
        np.testing.assert_allclose(getattr(tstate.fields, k), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=k)
    for i, (jp, tp) in enumerate(zip(jstate.particles, tstate.particles)):
        ref = {k: np.asarray(v)[0, 0, 0] for k, v in jp.data.items()}
        ref_alive = np.asarray(jp.alive)[0, 0, 0]
        got = {k: v[0, 0, 0] for k, v in tp.data.items()}
        compare_slots(ref, ref_alive, got, tp.alive[0, 0, 0], rtol=1e-11,
                      keys=tuple(k for k in SLOT_FLOATS + extra_keys
                                 if k in got))
        if i == 0:
            compare_slots(ref, ref_alive, got, tp.alive[0, 0, 0], rtol=1e-10,
                          keys=("chi",))
            compare_slots(ref, ref_alive, got, tp.alive[0, 0, 0], rtol=0,
                          keys=("tau", "event"))
    # photons: the parent's weight, inv_gamma = 1/|u|, momentum below the
    # parent's
    ph = tsim.get_particles(2)
    umag = np.sqrt(ph["ux"]**2 + ph["uy"]**2 + ph["uz"]**2)
    np.testing.assert_allclose(ph["w"], 1.0, rtol=1e-12)
    np.testing.assert_allclose(ph["inv_gamma"], 1 / umag, rtol=1e-12)
    assert 0 < umag.min() and umag.max() < np.sqrt(2000.0**2 - 1)


def _spy(monkeypatch, module, name, modes, mode_of):
    """Record mode_of(kwargs) of every call of module.name."""
    fn = getattr(module, name)

    def spy(*args, **kw):
        modes.append(mode_of(kw))
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, spy)


def test_qed_step_3d_matches_jax(batcher_jax, monkeypatch):
    from lambdapic_torch.ops import cellslab
    modes = []
    _spy(monkeypatch, cellslab, "cell_step_plain", modes,
         lambda kw: cellslab._mode(kw["want_chi"], kw["photon"]))
    jsim, jstate, tsim, tstate = _run_both()
    # the fused path: a want_chi (electrons), a default (protons) and a
    # photon stage a step, in B2's plain version
    assert modes == ["want_chi", "default", "photon"] * NSTEPS
    assert tsim._builder.transients_valid == {0: False, 1: False, 2: False}
    _compare(jsim, jstate, tsim, tstate, extra_keys=("delta",))


def test_exact_qed_step_3d_matches_jax(batcher_jax, monkeypatch):
    from lambdapic_torch.ops import cellpallas
    modes = []
    _spy(monkeypatch, cellpallas, "fused_push_cell_3d_plain", modes,
         lambda kw: kw["want_eb"])
    jsim, jstate, tsim, tstate = _run_both(cell_migration="exact")
    # B4 3D: the electrons in its want_eb mode, the protons in its default
    assert modes == [True, False] * NSTEPS
    # both exact re-binnings keep the stable order: compared in place too
    for jp, tp in zip(jstate.particles, tstate.particles):
        ref_alive = np.asarray(jp.alive)[0, 0, 0]
        np.testing.assert_array_equal(tp.alive[0, 0, 0], ref_alive)
        np.testing.assert_array_equal(
            tp.data["id_lo"][0, 0, 0][ref_alive],
            np.asarray(jp.data["id_lo"])[0, 0, 0][ref_alive])
    _compare(jsim, jstate, tsim, tstate, extra_keys=("delta",))
    assert tsim._builder.transients_valid == {0: True, 1: False, 2: False}
    assert "ex_part" in tsim.get_particles(0)


def test_split_qed_step_3d_matches_jax(batcher_jax):
    import lambdapic_torch
    from lambdapic_tpu.simulation.callbacks import callback as j_callback
    j_seen, t_seen = [], []
    cbs = (("jax", j_callback(stage="_push_momentum")(
                lambda s: j_seen.append(s.itime))),
           ("torch", lambdapic_torch.callback(stage="_push_momentum")(
                lambda s: t_seen.append(s.itime))))
    jsim, jstate, tsim, tstate = _run_both(cbs)
    assert j_seen == t_seen == list(range(NSTEPS))
    _compare(jsim, jstate, tsim, tstate,
             extra_keys=("delta", "ex_part", "ey_part", "bz_part"))
    assert tsim._builder.transients_valid == {0: True, 1: True, 2: True}
