"""The port's device mesh and guard-cell exchanges (parallel/mesh.py,
parallel/halo.py, parallel/distributed.py) against the JAX package's
(lambdapic_tpu/parallel/{mesh,halo}.py inside shard_map) on meshes of
virtual CPU devices: exact equality. Also the state carry-over of a JAX
mesh state and the per-device fill on a mesh, bit for bit."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, PartitionSpec as P

import lambdapic_tpu.parallel.halo as j_halo
import lambdapic_tpu.parallel.mesh as j_mesh
from lambdapic_torch.core.grid import Grid
from lambdapic_torch.parallel import distributed, halo as t_halo
from lambdapic_torch.parallel import mesh as t_mesh
from test_torch_cellstep import shard_map

NAMES = ("px", "py", "pz")
CPU = torch.device("cpu")


def _grid(shape, mesh_shape, periodic=True, n_guard=2):
    nd = len(shape)
    bc = tuple((ax + side, "periodic" if periodic else "pml")
               for ax in "xyz"[:nd] for side in ("min", "max"))
    extra = dict(nz=shape[2], dz=1.0, npatch_z=mesh_shape[2]) if nd == 3 \
        else {}
    return Grid(dimension=nd, nx=shape[0], ny=shape[1], dx=1.0, dy=1.0,
                npatch_x=mesh_shape[0], npatch_y=mesh_shape[1],
                n_guard=n_guard, cpml_thickness=2,
                boundary_conditions=tuple(sorted(bc)), **extra)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12])
def test_auto_patches_matches_jax(n):
    assert t_mesh.auto_patches(64, 32, n_devices=n) == \
        j_mesh.auto_patches(64, 32, n_devices=n)
    assert t_mesh.auto_patches(64, 32, 48, n_devices=n) == \
        j_mesh.auto_patches(64, 32, 48, n_devices=n)


def test_make_mesh():
    grid = _grid((16, 16), (2, 2))
    mesh = t_mesh.make_mesh(grid, [CPU] * 4)
    jm = j_mesh.make_mesh(grid, jax.devices()[:4])
    assert mesh.shape == tuple(jm.devices.shape)
    assert mesh.axis_names == tuple(jm.axis_names)
    assert [mesh.coords(i) for i in range(4)] == \
        [tuple(int(v) for v in np.argwhere(jm.devices == d)[0])
         for d in jm.devices.flat]
    with pytest.raises(ValueError, match="need 4 devices"):
        t_mesh.make_mesh(grid, [CPU] * 3)
    with pytest.raises(ValueError, match="need 4 devices"):
        j_mesh.make_mesh(grid, jax.devices()[:3])


def _jax_run(fn, mesh_shape, *arrays):
    nd = len(mesh_shape)
    n = int(np.prod(mesh_shape))
    mesh = JMesh(np.array(jax.devices()[:n]).reshape(mesh_shape),
                 NAMES[:nd])
    spec = P(*NAMES[:nd])

    def body(*blocks):
        outs = fn(*[b.reshape(b.shape[nd:]) for b in blocks])
        return tuple(o.reshape((1,) * nd + o.shape) for o in outs)

    f = jax.jit(shard_map(body, mesh, in_specs=(spec,) * len(arrays),
                          out_specs=spec))
    return [np.asarray(o) for o in f(*[jnp.asarray(a) for a in arrays])]


def _shards(a, mesh):
    nd = len(mesh.shape)
    return [torch.as_tensor(a[mesh.coords(i)]) for i in range(mesh.size)]


def _stack(ts, mesh_shape):
    arrs = [t.numpy() for t in ts]
    return np.stack(arrs).reshape(tuple(mesh_shape) + arrs[0].shape)


MESHES = [((2, 2), (True, False)), ((4, 2), (False, True)),
          ((2, 2, 2), (True, False, True)), ((2, 2, 2), (False,) * 3)]


@pytest.mark.parametrize("mesh_shape,periodic", MESHES)
def test_halo_pad_reduce_and_strips_match_jax(mesh_shape, periodic):
    nd = len(mesh_shape)
    n = int(np.prod(mesh_shape))
    rng = np.random.default_rng(n + nd)
    nloc = (5, 4, 3)[:nd]
    g = 2
    f = rng.normal(size=tuple(mesh_shape) + (2,) + nloc)
    fpad = rng.normal(size=tuple(mesh_shape) + (2,)
                      + tuple(k + 2 * g for k in nloc))
    jspecs = tuple(j_halo.HaloSpec(NAMES[i], mesh_shape[i], periodic[i])
                   for i in range(nd))
    tspecs = tuple(t_halo.HaloSpec(NAMES[i], mesh_shape[i], periodic[i])
                   for i in range(nd))
    axes = tuple(range(1, nd + 1))
    mesh = t_mesh.Mesh(tuple(mesh_shape), NAMES[:nd], (CPU,) * n)

    def ref(a, b):
        pad = j_halo.halo_pad(a, g, axes, jspecs)
        red = j_halo.halo_reduce(b, g, axes, jspecs)
        lo, hi = j_halo.exchange_strips(a[:, :1], a[:, -1:], jspecs[0])
        return pad, red, lo, hi

    r_pad, r_red, r_lo, r_hi = _jax_run(ref, mesh_shape, f, fpad)
    fs, fps = _shards(f, mesh), _shards(fpad, mesh)
    pad = t_halo.halo_pad(fs, g, axes, tspecs, mesh)
    red = t_halo.halo_reduce(fps, g, axes, tspecs, mesh)
    lo, hi = t_halo.exchange_strips([t[:, :1] for t in fs],
                                    [t[:, -1:] for t in fs], tspecs[0], mesh)
    np.testing.assert_array_equal(_stack(pad, mesh_shape), r_pad)
    np.testing.assert_array_equal(_stack(red, mesh_shape), r_red)
    np.testing.assert_array_equal(_stack(lo, mesh_shape), r_lo)
    np.testing.assert_array_equal(_stack(hi, mesh_shape), r_hi)
    # the stack form and the host gather
    stacked = t_halo.halo_pad_stack([[t[0] for t in fs], [t[1] for t in fs]],
                                    g, tspecs, mesh)
    for a, b in zip(stacked, pad):
        assert torch.equal(a, b)
    glob = distributed.to_host([t[0] for t in fs], mesh, 0)
    back = distributed.split_blocks(glob, mesh)
    for a, b in zip(back, fs):
        np.testing.assert_array_equal(a, b[0].numpy())
    np.testing.assert_array_equal(distributed.to_host(fs, mesh), f)


def test_one_by_one_mesh_equals_one_device_functions():
    rng = np.random.default_rng(0)
    f = torch.as_tensor(rng.normal(size=(2, 6, 5)))
    fpad = torch.as_tensor(rng.normal(size=(2, 10, 9)))
    mesh = t_mesh.Mesh((1, 1), ("px", "py"), (CPU,))
    for per in ((True, True), (False, True), (True, False)):
        specs = tuple(t_halo.HaloSpec(NAMES[i], 1, per[i]) for i in range(2))
        assert torch.equal(t_halo.halo_pad([f], 2, (1, 2), specs, mesh)[0],
                           t_halo.halo_pad(f, 2, (1, 2), per))
        assert torch.equal(
            t_halo.halo_reduce([fpad], 2, (1, 2), specs, mesh)[0],
            t_halo.halo_reduce(fpad, 2, (1, 2), per))


def test_ppermute_psum_axis_index():
    mesh = t_mesh.Mesh((2, 3), ("px", "py"), (CPU,) * 6)
    xs = [torch.tensor(float(i)) for i in range(6)]
    up = t_mesh.ppermute(xs, mesh, "py", +1)
    for i in range(6):
        cx, cy = mesh.coords(i)
        assert t_mesh.axis_index(mesh, i, "py") == cy
        assert float(up[i]) == mesh.index((cx, (cy - 1) % 3))
    assert float(t_mesh.psum(xs, mesh)) == 15.0


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 1, 2)])
def test_fill_on_a_mesh_matches_jax(mesh_shape):
    """The per-device fill (default_rng([seed, ispec, device])) and the
    cell binning of every device of a mesh, bit for bit."""
    import lambdapic_tpu.core.grid as j_grid
    import lambdapic_tpu.core.species as j_species
    import lambdapic_tpu.simulation.initfill as j_fill
    import lambdapic_torch.core.species as t_species
    import lambdapic_torch.simulation.initfill as t_fill
    nd = len(mesh_shape)
    shape = (16, 12, 8)[:nd]
    kw = dict(dimension=nd, nx=shape[0], ny=shape[1], dx=1e-7, dy=2e-7,
              npatch_x=mesh_shape[0], npatch_y=mesh_shape[1], n_guard=3,
              cpml_thickness=2,
              boundary_conditions=tuple(sorted(
                  (ax + s, "pml") for ax in "xyz"[:nd]
                  for s in ("min", "max"))))
    if nd == 3:
        kw.update(nz=shape[2], dz=1.5e-7, npatch_z=mesh_shape[2])
    out = []
    for grid_mod, sp_mod, fill in ((j_grid, j_species, j_fill),
                                   (None, t_species, t_fill)):
        grid = (grid_mod.Grid if grid_mod else Grid)(**kw)

        if nd == 2:
            def density(x, y):
                return np.where(x > 5e-7, 1e26 * (1 + 0.5 * np.sin(y * 1e7)),
                                0.0)

            def ux(x, y):
                return np.cos(y * 2e6)
        else:
            def density(x, y, z):
                return np.where(x > 5e-7, 1e26 * (1 + 0.5 * np.sin(
                    y * 1e7 + z * 3e6)), 0.0)

            def ux(x, y, z):
                return np.cos(y * 2e6) * np.sin(z * 1e6)

        sp = sp_mod.Electron(density=density, ppc=3,
                             momentum=(ux, None, None))
        counts = fill.count_macro_particles(grid, sp)
        cap = fill.pick_capacity(counts, 2.0)
        arrays, counts = fill.fill_species(grid, sp, 7, 0, cap)
        out.append(fill.bin_cells(arrays, counts, grid, factor=2.0))
        sp_mod._ALL_SPECIES.clear()
    (ja, jal, jc), (ta, tal, tc) = out
    assert jc == tc
    np.testing.assert_array_equal(tal, jal)
    assert set(ta) == set(ja)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert jal.shape[:nd] == tuple(mesh_shape) and jal.sum() > 0
