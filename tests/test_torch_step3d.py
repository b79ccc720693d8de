"""The port's 3D cell-engine step end to end against the JAX package: a
tiny 3D laser-target (32 x 16 x 16 cells, electrons and protons, y- and
z-dependent momentum profiles so particles cross cells along every axis,
PML on all six faces, GaussianLaser3D) run for four steps in float64 by
both Simulation3Ds from the same seed.

The JAX side runs its XLA cell path on the CPU (LAMBDAPIC_FIELDS_PALLAS=0
keeps its fields update out of Pallas interpret mode; ops/maxwell.py is
what that kernel is tested against). Its re-binning sorts with stable
lax.sort, which pairs merging particles differently from the Batcher
order the port (and the TPU kernel) use, so the test asserts that no
merge happened. Fields agree to rtol 1e-9 (the current sums run in
another order); particles agree slot for slot after canonicalisation.
"""
import numpy as np
import pytest

import lambdapic_tpu.core.species as j_species
import lambdapic_torch.core.species as t_species
from lambdapic_torch.core.state import state_to_numpy
from lambdapic_torch.testing import compare_slots, torch_threads

UM = 1e-6
NSTEPS = 4
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


def _config(pkg):
    l0 = 0.8 * UM
    nx, ny, nz = 32, 16, 16
    dx, dy, dz = l0 / 10, l0 / 5, l0 / 5
    Ly, Lz = ny * dy, nz * dz
    nc = 1.742e27

    def density(x, y, z):
        return np.where(x > 1.2 * UM, 2 * nc, 0.0)

    def ux(x, y, z):
        return 0.8 * np.sin(2 * np.pi * y / Ly)

    def uy(x, y, z):
        return 0.7 * np.cos(2 * np.pi * z / Lz)

    def uz(x, y, z):
        return 0.7 * np.sin(2 * np.pi * (y / Ly + z / Lz))

    species = [pkg.Electron(density=density, ppc=2, momentum=(ux, uy, uz)),
               pkg.Proton(density=density, ppc=2)]
    laser = pkg.GaussianLaser3D(a0=2, l0=l0, w0=0.8 * UM, ctau=0.5 * UM,
                                x0=0.0, focus_position=1.0 * UM)
    # capacity headroom keeps the overwrite-merge re-binning merge-free
    sim_kw = dict(nx=nx, ny=ny, nz=nz, dx=dx, dy=dy, dz=dz, tiling="cell",
                  random_seed=1, precision="double",
                  particle_capacity_factor=6.0)
    return species, laser, sim_kw


def _home_cells(np_state):
    """id_lo -> (ix, iy, iz) of every alive particle, per species."""
    out = []
    for p in np_state.particles:
        alive = np.asarray(p.alive)[0, 0, 0]
        ids = np.asarray(p.data["id_lo"])[0, 0, 0]
        cells = np.stack(np.broadcast_arrays(
            *np.meshgrid(*[np.arange(n) for n in alive.shape[1:]],
                         indexing="ij")), -1)
        cells = np.broadcast_to(cells, alive.shape + (3,))
        out.append(dict(zip(ids[alive].tolist(),
                            map(tuple, cells[alive].tolist()))))
    return out


def _port_sim(**extra):
    import lambdapic_torch
    species, laser, kw = _config(lambdapic_torch)
    sim = lambdapic_torch.Simulation3D(device="cpu", **{**kw, **extra})
    sim.add_species(species)
    return sim, laser


def test_laser_target_3d_matches_jax(monkeypatch):
    monkeypatch.setenv("LAMBDAPIC_FIELDS_PALLAS", "0")
    import jax
    import lambdapic_tpu

    species, laser, kw = _config(lambdapic_tpu)
    jsim = lambdapic_tpu.Simulation3D(npatch_x=1, npatch_y=1, npatch_z=1,
                                      **kw)
    jsim.add_species(species)
    jsim.run(NSTEPS, callbacks=[laser])
    jstate = jax.device_get(jsim.state)

    tsim, laser = _port_sim()
    tsim.initialize()
    start = _home_cells(state_to_numpy(tsim.state, dimension=3))
    tsim.run(NSTEPS, callbacks=[laser])
    tstate = state_to_numpy(tsim.state, dimension=3)

    # guards on the test itself: no merge (lax.sort and the Batcher order
    # pair merges differently), and particles changed cells along every axis
    assert [int(np.asarray(p.overflow).sum()) for p in jstate.particles] \
        == [0, 0]
    assert [int(np.asarray(p.overflow).sum()) for p in tstate.particles] \
        == [0, 0]
    end = _home_cells(tstate)
    for axis in range(3):
        moved = sum(int(s[i][axis] != e[i][axis])
                    for s, e in zip(start, end) for i in s if i in e)
        assert moved > 0, axis
    assert tsim.itime == jsim.itime == NSTEPS

    for k in FIELDS:
        ref = np.asarray(getattr(jstate.fields, k))
        assert ref.shape == (32, 16, 16)
        np.testing.assert_allclose(getattr(tstate.fields, k), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=k)
    assert np.abs(np.asarray(jstate.fields.ey)).max() > 0
    assert len(jstate.fields.psi) == 12
    for k, v in jstate.fields.psi.items():
        ref = np.asarray(v)
        np.testing.assert_allclose(tstate.fields.psi[k], ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=k)
    rho = jsim.get_field("rho")
    np.testing.assert_allclose(tsim.get_field("rho"), rho, rtol=1e-9,
                               atol=1e-9 * np.abs(rho).max())
    assert np.abs(rho).max() > 0

    for jp, tp in zip(jstate.particles, tstate.particles):
        ref = {k: np.asarray(v)[0, 0, 0] for k, v in jp.data.items()}
        got = {k: v[0, 0, 0] for k, v in tp.data.items()}
        compare_slots(ref, np.asarray(jp.alive)[0, 0, 0], got,
                      tp.alive[0, 0, 0], rtol=1e-9)


def test_segmented_step_3d_equals_full_step():
    """A host callback at maxwell_1 splits the 3D step into its three
    segments; the result is bit for bit the fused step's."""
    from lambdapic_torch import callback
    seen = []
    sims = []
    for cbs in ([], [callback(stage="maxwell_1")(lambda s: seen.append(s.itime))]):
        t_species._ALL_SPECIES.clear()
        sim, laser = _port_sim()
        sim.run(2, callbacks=[laser] + cbs)
        sims.append(state_to_numpy(sim.state, dimension=3))
    assert seen == [0, 1]
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(sims[1].fields, k),
                                      getattr(sims[0].fields, k), err_msg=k)
    for a, b in zip(sims[0].particles, sims[1].particles):
        for k in a.data:
            np.testing.assert_array_equal(b.data[k], a.data[k], err_msg=k)


def test_rho_free_run_recomputes_rho_3d():
    """With laser-only callbacks the hot loop skips the rho deposit
    (three-component panels); get_field("rho") recomputes it through the
    3D plain deposit and equals the every-step deposit's rho."""
    rhos = []
    for deposit_rho in ("auto", True):
        t_species._ALL_SPECIES.clear()
        sim, laser = _port_sim(deposit_rho=deposit_rho)
        sim.run(2, callbacks=[laser])
        assert sim._with_rho == (deposit_rho is True)
        rhos.append(sim.get_field("rho"))
    assert np.abs(rhos[1]).max() > 0
    np.testing.assert_allclose(rhos[0], rhos[1], rtol=0,
                               atol=1e-12 * np.abs(rhos[1]).max())


def test_grow_capacity_3d_pads_dead_slots():
    """Re-capacity works on the slot axis of 3D slots as it does in 2D.
    The plasma fills the box up to its open faces, so electrons may leave
    in a step; none merge, and the resting protons all stay."""
    import torch
    sim, laser = _port_sim()
    sim.initialize()
    old = sim.state.particles[0]
    cap = old.cap
    assert sim._grow_capacity(0, cap + 3)
    new = sim.state.particles[0]
    assert new.cap == cap + 4 == sim._species_static[0].cap   # kept even
    assert new.alive.shape[1:] == old.alive.shape[1:] == (32, 16, 16)
    assert torch.equal(new.alive[:cap], old.alive)
    assert not bool(new.alive[cap:].any())
    assert bool((new.data["inv_gamma"][cap:] == 1).all())
    n0 = sim.npart_alive
    sim.run(1, callbacks=[laser])
    sim._maybe_recap()
    assert [int(p.overflow) for p in sim.state.particles] == [0, 0]
    assert sim.npart_alive[1] == n0[1]
    assert 0.9 * n0[0] < sim.npart_alive[0] <= n0[0]
