"""The re-binning across a device mesh and the per-shard QED pieces
against the JAX package under shard_map on the same mesh of virtual CPU
devices, 2D and 3D.

- ``cellpallas.migrate_cells_mesh``: kernel B6's plain version with the
  neighbours' edge columns (K7's plain version, ``cell2d.migrate_cells``
  with ``edges``), and the exact scheme with cross-device donors, against JAX
  ``cell2d.migrate_cells`` (the fast scheme with the Batcher list swapped
  in, or ``exact=True``) with the mesh plan of HaloSpecs, open and
  periodic mesh faces. Slots compared after canonicalisation by (dead,
  id_hi, id_lo): alive and ids equal, attributes to rtol 1e-11 with a
  floor of 1e-14 of their peak; merge counts equal.
- ``cell2d.insert_cells(device_id=...)`` against JAX ``insert_cells``:
  newborn id_hi is the shard's index, whatever the residents carry.
- ``models.qed.species_key`` per shard against jax.random.fold_in of the
  row-major device index.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from lambdapic_torch.ops.cell2d import migrate_cells
from lambdapic_torch.ops.cellpallas import (migrate_cells_fused,
                                            migrate_cells_mesh)
from lambdapic_torch.parallel.halo import HaloSpec as THaloSpec
from lambdapic_torch.parallel.mesh import Mesh
from lambdapic_torch.testing import (QED_PAYLOADS, compare_mesh_slots,
                                     mesh_to_numpy, mesh_to_torch,
                                     random_mesh_cells, to_numpy, to_torch,
                                     torch_threads)
from test_torch_cellstep import batcher_sort_jnp, shard_map

NAMES = ("px", "py", "pz")


def jax_migrate_mesh(data, alive, mesh_shape, periodic, exact,
                     recompute_ig=True):
    from lambdapic_tpu.ops import cell2d
    from lambdapic_tpu.parallel.halo import HaloSpec

    nd = len(mesh_shape)
    names = NAMES[:nd]
    n = int(np.prod(mesh_shape))
    mesh = JMesh(np.array(jax.devices()[:n]).reshape(mesh_shape), names)
    specs = tuple(HaloSpec(names[i], mesh_shape[i], periodic[i])
                  for i in range(nd))
    nloc = alive.shape[nd + 1:]
    plan = tuple((nloc[i], specs[i], "xyz"[i]) for i in range(nd))
    lead = (1,) * nd

    def run(d, al):
        d = {k: v.reshape(v.shape[nd:]) for k, v in d.items()}
        al = al.reshape(al.shape[nd:])
        kw = dict(exact=True) if exact else dict(sort_fn=batcher_sort_jnp)
        d, al, n_lost = cell2d.migrate_cells(d, al, plan,
                                             recompute_ig=recompute_ig, **kw)
        return ({k: v.reshape(lead + v.shape) for k, v in d.items()},
                al.reshape(lead + al.shape), n_lost.reshape(lead))

    spec = P(*names)
    f = jax.jit(shard_map(run, mesh, in_specs=(spec, spec),
                          out_specs=(spec,) * 3))
    d, al, n_lost = f({k: jnp.asarray(v) for k, v in data.items()},
                      jnp.asarray(alive))
    return ({k: np.asarray(v) for k, v in d.items()}, np.asarray(al),
            np.asarray(n_lost))


def displaced(mesh_shape, cap, nloc, crowded, seed):
    """A mesh state with QED payloads whose particles sit up to 0.9 of a
    cell past their home cell's faces along y (and z): donors along every
    axis, across the shards' faces and corners."""
    data, alive, _ = random_mesh_cells(mesh_shape, cap, nloc, seed=seed,
                                       crowded=crowded,
                                       n_frac=0.9 if crowded else 0.4,
                                       qed=True)
    rng = np.random.default_rng(seed + 7)
    for a in "xyz"[:len(mesh_shape)]:
        if a == "x" and crowded:
            continue
        data[a] = np.where(alive, data[a] + rng.uniform(-0.9, 0.9,
                                                        alive.shape), 0.0)
    return data, alive


def port_migrate(data, alive, mesh_shape, periodic, scheme,
                 recompute_ig=True):
    nd = len(mesh_shape)
    n = int(np.prod(mesh_shape))
    mesh = Mesh(tuple(mesh_shape), NAMES[:nd], (torch.device("cpu"),) * n)
    specs = tuple(THaloSpec(NAMES[i], mesh_shape[i], periodic[i])
                  for i in range(nd))
    shards = mesh_to_torch(data, alive, mesh, torch.float64)
    with torch_threads(1):
        return migrate_cells_mesh([d for d, _ in shards],
                                  [a for _, a in shards], mesh, specs,
                                  recompute_ig=recompute_ig, scheme=scheme)


CASES = [
    # (mesh, cap, nloc, periodic, crowded)
    ((2, 2), 4, (8, 8), (True, True), False),
    ((2, 2), 6, (9, 8), (False, False), True),
    ((4, 2), 4, (4, 6), (False, True), False),
    ((1, 2, 2), 4, (4, 4, 4), (False, True, False), True),
    ((2, 2, 2), 4, (4, 4, 4), (True, False, True), False),
]


@pytest.mark.parametrize("scheme", ["fused", "exact"])
@pytest.mark.parametrize("mesh_shape,cap,nloc,periodic,crowded", CASES)
def test_migrate_cells_mesh_plain_matches_jax(mesh_shape, cap, nloc,
                                              periodic, crowded, scheme):
    exact = scheme == "exact"
    nd = len(mesh_shape)
    data, alive = displaced(mesh_shape, cap, nloc, crowded,
                            seed=3 + cap + nd)
    ref, ref_alive, ref_lost = jax_migrate_mesh(data, alive, mesh_shape,
                                                periodic, exact)
    outs = port_migrate(data, alive, mesh_shape, periodic, scheme)
    got, got_alive = mesh_to_numpy([(o[0], o[1]) for o in outs], mesh_shape)
    compare_mesh_slots(ref, ref_alive, got, got_alive, mesh_shape,
                       rtol=1e-11)
    compare_mesh_slots(ref, ref_alive, got, got_alive, mesh_shape, rtol=0,
                       keys=QED_PAYLOADS)
    lost = np.array([int(o[2]) for o in outs]).reshape(mesh_shape)
    np.testing.assert_array_equal(lost, ref_lost)
    if crowded and not exact:
        assert ref_lost.sum() > 0
    # particles crossed the shards' faces; at open faces some left the box
    assert sum(int((got["id_hi"][c][got_alive[c]]
                    != np.ravel_multi_index(c, mesh_shape)).sum())
               for c in np.ndindex(mesh_shape)) > 0


def test_migrate_cells_mesh_photon_and_sort_scheme():
    """A photon species (inv_gamma carried, 1 in dead slots) through the
    cross-device strips against JAX; the B7 scheme and the wrappers give
    the plain version's result on CPU shards."""
    mesh_shape, periodic = (2, 2), (True, False)
    data, alive = displaced(mesh_shape, 6, (6, 8), True, seed=21)
    for k in QED_PAYLOADS:
        data.pop(k)
    ref, ref_alive, ref_lost = jax_migrate_mesh(data, alive, mesh_shape,
                                                periodic, False,
                                                recompute_ig=False)
    outs = port_migrate(data, alive, mesh_shape, periodic, "fused",
                        recompute_ig=False)
    got, got_alive = mesh_to_numpy([(o[0], o[1]) for o in outs], mesh_shape)
    compare_mesh_slots(ref, ref_alive, got, got_alive, mesh_shape,
                       rtol=1e-11)
    assert (got["inv_gamma"][~got_alive] == 1).all()
    np.testing.assert_array_equal(
        np.array([int(o[2]) for o in outs]).reshape(mesh_shape), ref_lost)
    sort = port_migrate(data, alive, mesh_shape, periodic, "sort",
                        recompute_ig=False)
    for a, b in zip(outs, sort):
        assert torch.equal(a[1], b[1]) and int(a[2]) == int(b[2])
        for k in a[0]:
            assert torch.equal(a[0][k], b[0][k]), k
    # one shard's axis through the wrappers: the plain version on the CPU
    d, al = to_torch({k: v[0, 0] for k, v in data.items()}, alive[0, 0],
                     torch.float64, "cpu")
    plan = ((6, True, "x"), (8, False, "y"))
    a = migrate_cells_fused(d, al, plan, recompute_ig=False)
    b = migrate_cells(d, al, plan, recompute_ig=False)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    with pytest.raises(ValueError, match="scheme"):
        port_migrate(data, alive, mesh_shape, periodic, "scatter")


@pytest.mark.parametrize("nd", [2, 3])
def test_insert_cells_device_id_matches_jax(nd):
    """Newborns of the shard of index ``device_id`` carry it as id_hi and
    number from the shard's next_id; residents (immigrants with foreign
    id_hi among them) keep theirs."""
    from lambdapic_torch.ops.cell2d import insert_cells
    from lambdapic_tpu.ops.cell2d import insert_cells as j_insert
    rng = np.random.default_rng(nd)
    cells = (6, 5) if nd == 2 else (4, 3, 5)
    cap, cap_s = 8, 6
    alive = rng.uniform(0, 1, (cap,) + cells) < 0.5
    data = {k: np.where(alive, rng.uniform(-1, 1, alive.shape), 0.0)
            for k in ("x", "y", "z", "w", "ux", "uy", "uz")}
    data["inv_gamma"] = np.ones(alive.shape)
    data["id_lo"] = rng.integers(0, 2**32, alive.shape).astype(np.uint32)
    data["id_hi"] = rng.integers(0, 4, alive.shape).astype(np.uint32)
    valid = rng.uniform(0, 1, (cap_s,) + cells) < 0.4
    new = {k: rng.uniform(-1, 1, valid.shape)
           for k in ("x", "y", "z", "w", "ux", "uy", "uz", "inv_gamma")}
    next_id = 4_000_000_000
    for dev in (None, 3):
        jd, ja, jn, jl = j_insert(
            {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(alive),
            jnp.asarray(next_id, jnp.uint32),
            {k: jnp.asarray(v) for k, v in new.items()}, jnp.asarray(valid),
            device_id=jnp.int32(0 if dev is None else dev))
        td, ta = to_torch(data, alive, torch.float64, "cpu")
        tn = {k: torch.as_tensor(v) for k, v in new.items()}
        gd, ga, gn, gl = insert_cells(td, ta, torch.tensor(next_id), tn,
                                      torch.as_tensor(valid), device_id=dev)
        got, got_alive = to_numpy(gd, ga)
        np.testing.assert_array_equal(got_alive, np.asarray(ja))
        for k, v in jd.items():
            np.testing.assert_array_equal(got[k], np.asarray(v), k)
        assert int(gn) == int(jn) and int(gl) == int(jl)
        born = got_alive & ~alive
        assert born.any()
        assert (got["id_hi"][born] == (dev or 0)).all()
        assert (got["id_hi"][alive] == data["id_hi"][alive]).all()


def test_species_key_per_shard_matches_jax():
    """The key of a species on a shard folds the row-major device index in
    last, as the JAX step does under shard_map."""
    from lambdapic_torch import random as jr
    from lambdapic_torch.models.qed import species_key
    base = jax.random.PRNGKey(1234)
    tbase = jr.PRNGKey(1234)
    for itime, ispec, didx in ((0, 0, 0), (17, 1, 3), (500, 2, 7),
                               (2**20, 0, 5)):
        ref = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(base, itime), ispec), didx)
        got = species_key(tbase, itime, ispec, didx)
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(ref) if jnp.issubdtype(
                ref.dtype, jax.dtypes.prng_key) else ref).astype(np.uint32),
            got.numpy().astype(np.uint32))
    assert torch.equal(species_key(tbase, 9, 1),
                       species_key(tbase, 9, 1, 0))
    assert not torch.equal(species_key(tbase, 9, 1, 0),
                           species_key(tbase, 9, 1, 1))
