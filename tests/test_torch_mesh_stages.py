"""The port's per-stage engine and QED on a device mesh against its own
one-device run (no JAX compile).

- 3D, exact and split: tests/test_torch_step3d.py's tiny laser-target
  (32 x 16 x 16 cells, float64) with ``cell_migration="exact"``, or with
  a callback at ``_push_momentum`` due every step, on one device and on a
  2 x 2 x 2 mesh of CPU shards from the same particles (the one-device
  fill handed over through ``set_particles_global``), at the rules of
  tests/test_torch_step_mesh.py::test_mesh_run_equals_one_device_run:
  shard-local positions round differently from global ones, so particles
  are matched through their starting positions, positions to 1e-9 cells,
  momenta and weights to rtol 1e-9, fields to 1e-9 of their peak.
- QED: the mesh draws its own streams (each shard folds its index into
  the key), so a 2 x 2 run differs from a one-device run particle by
  particle; as in tests/test_qed.py::test_qed_multi_device_statistical_
  parity the photon count agrees within 5 sqrt(N), the photons' summed
  |u| within 15% and the electrons' summed ux within 5%.
"""
import numpy as np
import pytest
import torch

import lambdapic_torch.core.species as t_species
from lambdapic_torch.testing import torch_threads

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clear_registry():
    t_species._ALL_SPECIES.clear()
    yield
    t_species._ALL_SPECIES.clear()


def _ids(p):
    return p["id_lo"].astype(np.int64) * 64 + p["id_hi"].astype(np.int64)


def _sim3d(mesh, **extra):
    import lambdapic_torch
    from test_torch_step3d import _config
    t_species._ALL_SPECIES.clear()
    species, laser, kw = _config(lambdapic_torch)
    sim = lambdapic_torch.Simulation3D(
        device="cpu", npatch_x=mesh[0], npatch_y=mesh[1], npatch_z=mesh[2],
        **kw, **extra)
    sim.add_species(species)
    sim.initialize(devices=[CPU] * int(np.prod(mesh)))
    return sim, laser


@pytest.mark.parametrize("case", ["exact", "split"])
def test_mesh_3d_stages_equal_one_device(case):
    import lambdapic_torch
    extra = dict(cell_migration="exact") if case == "exact" else {}
    seen = []
    with torch_threads(1):
        one, laser = _sim3d((1, 1, 1), **extra)
        mesh, laser2 = _sim3d((2, 2, 2), **extra)
        match = []
        for ispec in range(2):
            p = one.get_particles(ispec)
            coords = {k: p[k] for k in ("x", "y", "z")}
            mesh.set_particles_global(
                ispec, coords, {k: v for k, v in p.items() if k not in coords})
            q = mesh.get_particles(ispec)
            o1 = np.lexsort((p["z"], p["y"], p["x"]))
            o2 = np.lexsort((q["z"], q["y"], q["x"]))
            np.testing.assert_allclose(q["x"][o2], p["x"][o1], rtol=1e-15)
            match.append(dict(zip(_ids(q)[o2].tolist(),
                                  _ids(p)[o1].tolist())))
        cbs, cbs2 = [laser], [laser2]
        if case == "split":
            cbs.append(lambdapic_torch.callback(stage="_push_momentum")(
                lambda s: None))
            cbs2.append(lambdapic_torch.callback(stage="_push_momentum")(
                lambda s: seen.append(s.itime)))
        one.run(3, callbacks=cbs)
        mesh.run(3, callbacks=cbs2)
    if case == "split":
        assert seen == [0, 1, 2]
        assert mesh._builder.transients_valid == {0: True, 1: True}
    assert one.npart_alive == mesh.npart_alive
    assert [int(sum(int(sh.particles[i].overflow)
                    for sh in mesh.state.shards)) for i in range(2)] == \
        [int(p.overflow) for p in one.state.particles]
    for k in ("ex", "ey", "ez", "bx", "by", "bz", "jx", "jy", "jz"):
        a, b = one.get_field(k), mesh.get_field(k)
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-9 * max(np.abs(a).max(), 1e-300),
                                   err_msg=k)
    assert np.abs(one.get_field("jx")).max() > 0
    for ispec in range(2):
        a, b = one.get_particles(ispec), mesh.get_particles(ispec)
        where = {i: n for n, i in enumerate(_ids(a).tolist())}
        idx = np.array([where[match[ispec][i]] for i in _ids(b).tolist()])
        for k, d in (("x", one.dx), ("y", one.dy), ("z", one.dz)):
            np.testing.assert_allclose(b[k] / d, a[k][idx] / d, rtol=0,
                                       atol=1e-9, err_msg=k)
        for k in ("ux", "uy", "uz", "w"):
            np.testing.assert_allclose(b[k], a[k][idx], rtol=1e-9,
                                       atol=1e-12, err_msg=k)
    # particles crossed the shards' faces along every axis
    moved = 0
    for i, sh in enumerate(mesh.state.shards):
        p = sh.particles[0]
        moved += int((p.data["id_hi"][p.alive] != i).sum())
    assert moved > 0


@pytest.mark.parametrize("exact", [False, True], ids=["fused", "exact"])
def test_qed_mesh_statistics_equal_one_device(exact):
    """A 2 x 2 radiating run against the one-device run of the same
    electrons (tests/test_qed.py's statistical parity)."""
    import lambdapic_torch as lt
    from lambdapic_torch.constants import c, e, hbar, m_e
    stats = {}
    for mesh in ((1, 1), (2, 2)):
        t_species._ALL_SPECIES.clear()
        pho = lt.Photon(capacity=16384)
        ele = lt.Electron(radiation="photons")
        ele.set_photon(pho)
        bc = {k: "periodic" for k in ("xmin", "xmax", "ymin", "ymax")}
        sim = lt.Simulation(nx=32, ny=32, dx=1e-7, dy=1e-7,
                            npatch_x=mesh[0], npatch_y=mesh[1],
                            boundary_conditions=bc, random_seed=3,
                            precision="double", tiling="cell", device="cpu",
                            cell_migration="exact" if exact else "fast")
        sim.add_species([ele, pho])
        with torch_threads(1):
            sim.initialize(devices=[CPU] * (mesh[0] * mesh[1]))
            n = 4000
            gamma = 2000.0
            ux = np.sqrt(gamma**2 - 1)
            rng = np.random.default_rng(0)
            coords = {"x": rng.uniform(0.3e-6, 2.9e-6, n),
                      "y": rng.uniform(0.3e-6, 2.9e-6, n)}
            attrs = {"w": np.ones(n), "ux": np.full(n, ux),
                     "uy": np.zeros(n), "uz": np.zeros(n),
                     "inv_gamma": np.full(n, 1 / gamma)}
            sim.set_particles_global(0, coords, attrs)
            bz = 1.0 / (e * hbar / (m_e**2 * c**3) * c * ux)
            sim.set_field("bz", np.full((32, 32), bz))
            sim.run(nsteps=6)
        ph = sim.get_particles(1)
        el = sim.get_particles(0)
        umag = np.sqrt(ph["ux"]**2 + ph["uy"]**2 + ph["uz"]**2)
        stats[mesh] = (len(ph["w"]), umag.sum(), el["ux"].sum())
        if mesh == (2, 2):
            # every shard emitted, its newborns carrying its index
            for i, sh in enumerate(sim.state.shards):
                p = sh.particles[1]
                assert int(p.next_id) > 0
                assert (p.data["id_hi"][p.alive] == i).any()
    n1, e1, r1 = stats[(1, 1)]
    n4, e4, r4 = stats[(2, 2)]
    assert n1 > 500 and n4 > 500
    assert abs(n1 - n4) < 5 * np.sqrt(max(n1, n4)), (n1, n4)
    assert abs(e1 - e4) / e1 < 0.15
    assert abs(r1 - r4) / abs(r1) < 0.05
