"""The port's VDB codec (zpc_tpu_torch.utils.vdb) and SparseGrid bridge
(zpc_tpu_torch.geometry.vdb_bridge) against zpc_tpu's: the cases of
tests/test_vdb.py in the port, the writer's bytes equal to JAX's
(compressed and not), and each package reading the other's files.

Tolerances: none.  The codec moves bits: leaves, masks, bytes and the
dense fields read back are compared for equality; the staggered samples
of a grid read back equal those of the grid written.
"""

import dataclasses
import hashlib
import importlib
import os

import numpy as np
import pytest
import torch

from zpc_tpu_torch.containers.block_table import build_block_table
from zpc_tpu_torch.core.config import prop
from zpc_tpu_torch.geometry import vdb_bridge as TB
from zpc_tpu_torch.utils import vdb as TV

TS = importlib.import_module("zpc_tpu_torch.geometry.sparse_grid")

# every test here needs zpc_tpu
try:
    import jax.numpy as jnp
    from zpc_tpu.geometry import vdb_bridge as JB
    from zpc_tpu.utils import vdb as JV
    JS = importlib.import_module("zpc_tpu.geometry.sparse_grid")
except ImportError:
    pass

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def dense(rng):
    a = np.zeros((24, 16, 40), np.float32)
    a[3:9, 2:11, 5:30] = rng.standard_normal((6, 9, 25)).astype(np.float32)
    return a


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_grids(a, b):
    assert (a.name, a.grid_class, a.voxel_size, a.translation, a.vec) == \
        (b.name, b.grid_class, b.voxel_size, b.translation, b.vec)
    assert a.background == b.background
    assert set(a.leaves) == set(b.leaves)
    for k in a.leaves:
        np.testing.assert_array_equal(a.leaves[k], b.leaves[k])
        np.testing.assert_array_equal(a.masks[k], b.masks[k])


def _grids(leaves_f, leaves_v, leaves_i):
    kw = dict(voxel_size=0.1, translation=(1.0, -2.0, 0.5))
    return ([TV.VdbGrid("density", leaves_f, background=0.0,
                        grid_class="fog volume", **kw),
             TV.VdbGrid("vel", leaves_v, background=(0.0, 0.0, 0.0), vec=3,
                        **kw),
             TV.VdbGrid("id", leaves_i, dtype=np.int32, **kw)],
            [JV.VdbGrid("density", leaves_f, background=0.0,
                        grid_class="fog volume", **kw),
             JV.VdbGrid("vel", leaves_v, background=(0.0, 0.0, 0.0), vec=3,
                        **kw),
             JV.VdbGrid("id", leaves_i, dtype=np.int32, **kw)])


@pytest.mark.parametrize("compress", [False, True])
def test_writer_bytes_equal_jax_and_cross_read(tmp_path, dense, rng,
                                               compress):
    """Float, Vec3s and int32 grids in one file: the port's bytes are
    JAX's, and each package reads the other's file to the same grids."""
    leaves_v = {(0, 0, 0): rng.standard_normal((8, 8, 8, 3)).astype(
        np.float32), (-16, 8, 0): rng.standard_normal((8, 8, 8, 3)).astype(
        np.float32)}
    leaves_i = {(8, 0, 0): np.arange(512, dtype=np.int32).reshape(8, 8, 8)}
    tg, jg = _grids(TV.dense_to_leaves(dense), leaves_v, leaves_i)
    tpath, jpath = str(tmp_path / "t.vdb"), str(tmp_path / "j.vdb")
    TV.write_vdb(tpath, tg, compress=compress)
    JV.write_vdb(jpath, jg, compress=compress)
    assert _bytes(tpath) == _bytes(jpath)
    for a, b in zip(TV.read_vdb(jpath), JV.read_vdb(tpath), strict=True):
        _same_grids(a, b)


@pytest.mark.parametrize("compress", [False, True])
def test_roundtrip(tmp_path, dense, compress):
    leaves = TV.dense_to_leaves(dense)
    g = TV.VdbGrid("density", leaves, voxel_size=0.1,
                   translation=(1.0, -2.0, 0.5), background=0.0,
                   grid_class="fog volume")
    path = os.path.join(tmp_path, "t.vdb")
    TV.write_vdb(path, [g], compress=compress)
    (g2,) = TV.read_vdb(path)
    assert g2.name == "density" and g2.grid_class == "fog volume"
    assert g2.voxel_size == pytest.approx(0.1)
    assert g2.translation == pytest.approx((1.0, -2.0, 0.5))
    assert set(g2.leaves) == set(leaves)
    for k in leaves:
        np.testing.assert_array_equal(g2.leaves[k], leaves[k])
        np.testing.assert_array_equal(g2.masks[k], leaves[k] != 0.0)


def test_negative_and_far_coords(tmp_path, rng):
    leaves = {(-4096, -128, 8): rng.standard_normal((8, 8, 8)).astype(
        np.float32), (5000 // 8 * 8, 0, -8): rng.standard_normal(
        (8, 8, 8)).astype(np.float32)}
    path = os.path.join(tmp_path, "far.vdb")
    TV.write_vdb(path, [TV.VdbGrid("g", leaves)])
    (g2,) = TV.read_vdb(path)
    assert set(g2.leaves) == set(leaves)
    for k in leaves:
        np.testing.assert_array_equal(g2.leaves[k], leaves[k])
    (j2,) = JV.read_vdb(path)
    _same_grids(g2, j2)


@pytest.mark.parametrize("compress", [False, True])
def test_vec3_roundtrip(tmp_path, rng, compress):
    leaves = {(0, 0, 0): rng.standard_normal((8, 8, 8, 3)).astype(
        np.float32), (-16, 8, 0): rng.standard_normal((8, 8, 8, 3)).astype(
        np.float32)}
    g = TV.VdbGrid("vel", leaves, voxel_size=0.25, translation=(0.5, 0.0,
                                                                 -1.0),
                   background=(0.0, 0.0, 0.0), vec=3)
    path = os.path.join(tmp_path, "vec3.vdb")
    TV.write_vdb(path, [g], compress=compress)
    (g2,) = TV.read_vdb(path)
    assert g2.vec == 3 and g2.background == (0.0, 0.0, 0.0)
    for k in leaves:
        np.testing.assert_array_equal(g2.leaves[k], leaves[k])
        np.testing.assert_array_equal(g2.masks[k],
                                      np.any(leaves[k] != 0.0, axis=-1))


def test_int32_and_multiple_grids(tmp_path):
    gf = TV.VdbGrid("f", {(0, 0, 0): np.arange(512, dtype=np.float32)
                          .reshape(8, 8, 8)})
    gi = TV.VdbGrid("i", {(8, 0, 0): np.arange(512, dtype=np.int32)
                          .reshape(8, 8, 8)}, dtype=np.int32)
    path = os.path.join(tmp_path, "multi.vdb")
    TV.write_vdb(path, [gf, gi])
    out = TV.read_vdb(path)
    assert [g.name for g in out] == ["f", "i"]
    assert out[1].leaves[(8, 0, 0)].dtype == np.int32


def test_dense_leaf_helpers(dense, rng):
    back, (ox, oy, oz) = TV.leaves_to_dense(TV.dense_to_leaves(dense))
    np.testing.assert_array_equal(back[3 - ox:9 - ox, 2 - oy:11 - oy,
                                       5 - oz:30 - oz], dense[3:9, 2:11, 5:30])
    a = np.zeros((16, 8, 8, 3), np.float32)
    a[2:10, 1:5, 3:6] = rng.standard_normal((8, 4, 3, 3))
    leaves = TV.dense_to_leaves(a)
    assert all(v.shape == (8, 8, 8, 3) for v in leaves.values())
    jl = JV.dense_to_leaves(a)
    assert set(leaves) == set(jl)
    for k in jl:
        np.testing.assert_array_equal(leaves[k], jl[k])


def test_origin_not_leaf_aligned_raises(dense):
    with pytest.raises(ValueError, match="leaf-aligned"):
        TV.dense_to_leaves(dense, origin_ijk=(4, 0, 0))


def test_rejects_garbage(tmp_path):
    path = os.path.join(tmp_path, "bad.vdb")
    with open(path, "wb") as f:
        f.write(b"not a vdb file at all........")
    with pytest.raises(TV.VdbFormatError):
        TV.read_vdb(path)


def test_reader_parses_handmade_v218_stream(tmp_path):
    """tests/test_vdb.py's hand-assembled version-218 stream (no
    compression byte, no offsets, a ScaleMap without translation)."""
    from test_vdb import TestGoldenStream
    raw, leaf = TestGoldenStream()._handmade_stream()
    p = tmp_path / "handmade.vdb"
    p.write_bytes(raw)
    (g,) = TV.read_vdb(str(p))
    assert g.name == "handmade" and g.voxel_size == 0.25
    assert g.translation == (0.0, 0.0, 0.0)
    assert abs(g.background + 9.0) < 1e-7
    assert set(g.leaves) == {(8, 16, 24)}
    np.testing.assert_array_equal(g.leaves[(8, 16, 24)].reshape(-1), leaf)


def test_writer_digest_pinned(tmp_path):
    """The port's writer gives tests/test_vdb.py's pinned digest."""
    leaf = np.arange(512, dtype=np.float32).reshape(8, 8, 8)
    g = TV.VdbGrid("pin", {(0, 0, 0): leaf, (8, 0, 0): leaf * 2},
                   voxel_size=0.5, translation=(1.0, 2.0, 3.0),
                   background=0.0, grid_class="level set")
    p = tmp_path / "pin.vdb"
    TV.write_vdb(str(p), [g])
    assert hashlib.sha256(p.read_bytes()).hexdigest() == \
        "a3ae9d1c8262c0a78b0493c8eec64cc3a8c8be9ffe8957588052d67a213dc4f5"


# -- the SparseGrid bridge -------------------------------------------------------

def _both_from_dense(dense, **kw):
    jkw = dict(kw)
    if "origin" in kw:
        jkw["origin"] = jnp.asarray(kw["origin"])
    return (TS.sparse_grid_from_dense(torch.from_numpy(dense), **kw),
            JS.sparse_grid_from_dense(jnp.asarray(dense), **jkw))


def test_grid_roundtrip(dense):
    tg, _ = _both_from_dense(dense, dx=0.05, prop_name="sdf", threshold=0.0)
    g2 = TB.vdb_grid_to_sparse_grid(TB.sparse_grid_to_vdb_grid(tg, "sdf"),
                                    "sdf", device=CPU)
    np.testing.assert_array_equal(
        TS.sparse_grid_to_dense(g2, "sdf", (0, 0, 0), dense.shape).numpy(),
        dense)


@pytest.mark.parametrize("compress", [False, True])
def test_save_vdb_equals_jax_and_cross_load(tmp_path, dense, compress):
    """save_vdb of the same grid writes JAX's bytes; load_vdb_grids of
    JAX's file gives the grid back (dx, origin, dense field), and JAX's
    load of the port's file the same field."""
    kw = dict(dx=0.1, prop_name="phi", threshold=0.0,
              origin=[2.0, 0.0, -1.0])
    tg, jg = _both_from_dense(dense, **kw)
    tpath, jpath = str(tmp_path / "t.vdb"), str(tmp_path / "j.vdb")
    TB.save_vdb(tpath, tg, ["phi"], grid_class="level set",
                compress=compress)
    JB.save_vdb(jpath, jg, ["phi"], grid_class="level set",
                compress=compress)
    assert _bytes(tpath) == _bytes(jpath)
    g2 = TB.load_vdb_grids(jpath, device=CPU)["phi"]
    assert float(g2.dx) == pytest.approx(0.1)
    np.testing.assert_allclose(g2.transform.matrix[:3, 3].numpy(),
                               [2.0, 0.0, -1.0])
    np.testing.assert_array_equal(
        TS.sparse_grid_to_dense(g2, "phi", (0, 0, 0), dense.shape).numpy(),
        dense)
    j2 = JB.load_vdb_grids(tpath)["phi"]
    np.testing.assert_array_equal(
        np.asarray(JS.sparse_grid_to_dense(j2, "phi", (0, 0, 0),
                                           dense.shape)), dense)


def _vector_grid(rng, coords, cap, dx):
    table, inv = build_block_table(torch.tensor(coords, dtype=torch.int32),
                                   cap)
    g = TS.sparse_grid([prop("v", 3)], dx=dx, block_capacity=cap,
                       device=CPU)
    v = torch.zeros((cap, 64, 3))
    v[inv.long()] = torch.from_numpy(rng.standard_normal(
        (len(coords), 64, 3)).astype(np.float32))
    return dataclasses.replace(g, table=table, data={"v": v})


def test_vector_prop_export(tmp_path, rng):
    g = _vector_grid(rng, [[0, 0, 0], [1, 2, 3]], 8, 1.0)
    path = os.path.join(tmp_path, "vec.vdb")
    TB.save_vdb(path, g, ["v"])
    assert sorted(o.name for o in TV.read_vdb(path)) == ["v.0", "v.1", "v.2"]


def test_velocity_vec3_staggered_roundtrip(tmp_path, rng):
    """A velocity grid round-trips as one Vec3s grid and samples the same
    (staggered), in the port and through JAX's reader."""
    coords = [[i, j, k] for i in range(2) for j in range(2)
              for k in range(2)]
    g = _vector_grid(rng, coords, 16, 0.125)
    path = os.path.join(tmp_path, "vel.vdb")
    TB.save_vdb(path, g, ["v"], vec3=True)
    out = TV.read_vdb(path)
    assert len(out) == 1 and out[0].vec == 3
    g2 = TB.load_vdb_grids(path, device=CPU)["v"]
    pts = torch.from_numpy(rng.uniform(0.15, 0.7, (64, 3)).astype(
        np.float32))
    s1 = g.sample_staggered("v", pts).numpy()
    np.testing.assert_array_equal(g2.sample_staggered("v", pts).numpy(), s1)
    assert np.any(s1 != 0.0)
    j2 = JB.load_vdb_grids(path)["v"]
    np.testing.assert_allclose(np.asarray(j2.sample_staggered(
        "v", jnp.asarray(pts.numpy()))), s1, atol=1e-6)


def test_bridge_rejects_other_grids():
    g = TS.sparse_grid([prop("m")], dx=0.1, block_capacity=8, device=CPU,
                       dim=2)
    with pytest.raises(ValueError, match="dim=3"):
        TB.sparse_grid_to_vdb_grid(g, "m")
