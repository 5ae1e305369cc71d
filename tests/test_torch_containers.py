"""The port's containers (Field, DenseField, the wide block table,
OrderedMap, RingBuffer, IndexBuckets) and the remainder of its sparse grid
against zpc_tpu's, on the same seeded numpy inputs.

Integers (keys, slots, counts, ids) are held exactly, floats at 1e-6
relative (the sampled fields' gradients within 1e-6 of their largest
entry: they add eight products in another order).  One reference fault is
not copied: ``OrderedMap.erase`` in the JAX package can miss the key in
slot 0 (see zpc_tpu_torch/containers/ordered_map.py); that case is held to
a dict instead.
"""

import importlib

import numpy as np
import pytest
import torch


import zpc_tpu_torch as tz
from zpc_tpu_torch.containers import block_table as tbt
from zpc_tpu_torch.containers import dense_field as tdf
from zpc_tpu_torch.containers import index_buckets as tib
from zpc_tpu_torch.containers import ordered_map as tom
from zpc_tpu_torch.geometry import sparse_grid as tsg

# JAX is imported where it is installed (the machine with the card has
# none, and runs only the cuda test); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    import zpc_tpu as jz
    from zpc_tpu.core.config import prop as jprop
    # zpc_tpu re-exports functions under these modules' names
    jbt, jdf, jib, jom, jsg = (importlib.import_module(f"zpc_tpu.{m}")
                               for m in ("containers.block_table",
                                         "containers.dense_field",
                                         "containers.index_buckets",
                                         "containers.ordered_map",
                                         "geometry.sparse_grid"))
except ImportError:
    jax = jnp = jz = jprop = jbt = jdf = jib = jom = jsg = None

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


# -- Field / DenseField -------------------------------------------------------

def test_field_construct_and_access():
    f = tz.field(np.arange(10, dtype=np.float32), capacity=16, device=CPU)
    j = jz.field(np.arange(10, dtype=np.float32), capacity=16)
    assert (f.size, f.capacity, len(f)) == (j.size, j.capacity, len(j))
    _eq(f.data, j.data)
    _eq(f.mask, j.mask)
    np.testing.assert_array_equal(f.to_host(), j.to_host())
    assert f.active.shape == (10,) and f.item_shape == ()


def test_field_resize_append():
    f = tz.field(capacity=4, dtype=torch.int32, device=CPU)
    j = jz.field(capacity=4, dtype=jnp.int32)
    for vals in ([1, 2, 3], [4, 5, 6], list(range(20))):
        f = f.append(torch.tensor(vals, dtype=torch.int32))
        j = j.append(jnp.asarray(vals, jnp.int32))
        assert (f.size, f.capacity) == (j.size, j.capacity)
        _eq(f.data, j.data)
    g = f.resize(3)
    assert g.size == 3 and g.capacity == f.capacity
    e = tz.field(capacity=0, item_shape=(3,), device=CPU).resize(2)
    assert e.capacity == 8 and e.item_shape == (3,)


def test_field_set_fill_is_functional():
    base = tz.field(np.zeros(8, np.float32), device=CPU)
    f = base.set(3, 7.0)
    assert float(f[3]) == 7.0 and float(base[3]) == 0.0
    assert float(f.fill(2.0)[3]) == 2.0
    jf = jz.field(np.zeros(8, np.float32)).set(3, 7.0)
    _eq(f.data, jf.data)


def test_field_device_roundtrip():
    f = tz.field(np.arange(8, dtype=np.float32), device=CPU)
    g = f.to_device(CPU)
    np.testing.assert_array_equal(g.to_host(), f.to_host())
    assert g.device == CPU


def test_dense_field():
    d = tdf.dense_field((3, 4, 5), device=CPU, fill=1.5)
    j = jdf.dense_field((3, 4, 5), fill=1.5)
    assert d.shape == j.shape and d.dtype == torch.float32
    d2, j2 = d.set((1, 2, 3), 9.0), j.set((1, 2, 3), 9.0)
    _eq(d2.data, j2.data)
    assert float(d2(1, 2, 3)) == 9.0 and float(d(1, 2, 3)) == 1.5
    _eq(d2.flat, j2.flat)
    _eq(d2.reshape(12, 5).data, j2.reshape(12, 5).data)
    _eq(d2[1].clone(), j2[1])
    _eq(d2.fill(0.0).to_device(CPU).data, j2.fill(0.0).data)


# -- wide block table ---------------------------------------------------------

def _far_coords(rng, n, xr=200_000):
    return np.stack([rng.integers(-xr, xr, n),
                     rng.integers(-16_000, 16_000, n),
                     rng.integers(-32_000, 32_000, n)], -1).astype(np.int32)


@pytest.mark.parametrize("n,cap", [(64, 128), (1, 4), (500, 300),
                                   (256, 256)])
def test_wide_block_table_matches_zpc_tpu(n, cap):
    rng = np.random.default_rng(n)
    c = _far_coords(rng, n)
    c = np.concatenate([c, c[: n // 3]])          # duplicates
    kx, kyz = tbt.pack_coords_wide(_t(c))
    jkx, jkyz = jbt.pack_coords_wide(jnp.asarray(c))
    _eq(kx, jkx)
    _eq(kyz, jkyz)
    _eq(tbt.unpack_key_wide(kx, kyz), c)
    valid = rng.random(c.shape[0]) < 0.9
    for v in (None, valid):
        t, inv = tbt.build_wide_block_table(
            _t(c), cap, None if v is None else _t(v))
        j, jinv = jax.jit(jbt.build_wide_block_table, static_argnums=1)(
            jnp.asarray(c), cap, None if v is None else jnp.asarray(v))
        _eq(t.kx, j.kx)
        _eq(t.kyz, j.kyz)
        _eq(t.count, j.count)
        _eq(inv, jinv)
        _eq(t.active_coords, j.active_coords)
        _eq(t.mask, j.mask)
        q = np.concatenate([c, _far_coords(rng, 20)])
        _eq(t.query(_t(q)), jax.jit(jbt.WideBlockTable.query)(
            j, jnp.asarray(q)))


def test_wide_block_table_far_roundtrip():
    rng = np.random.default_rng(7)
    c = _far_coords(rng, 64, 500_000)
    t, inv = tbt.build_wide_block_table(_t(c), 128)
    slots = t.query(_t(c))
    assert (slots >= 0).all() and torch.equal(slots, inv)
    np.testing.assert_array_equal(t.active_coords[slots.long()].numpy(), c)
    n = int(t.count)
    comb = (t.kx[:n].numpy().astype(np.int64) << 32) | \
        t.kyz[:n].numpy().astype(np.uint32)
    assert (np.diff(comb) > 0).all()
    assert int(t.query(torch.tensor([[1, 2, 3]], dtype=torch.int32))) == -1


# -- OrderedMap / RingBuffer --------------------------------------------------

def _map_eq(t, j):
    _eq(t.keys, j.keys)
    _eq(t.values, j.values)
    _eq(t.count, j.count)


def test_ordered_map_matches_zpc_tpu():
    rng = np.random.default_rng(11)
    t = tom.ordered_map(256, device=CPU)
    j = jom.ordered_map(256)
    insert, erase = (jax.jit(getattr(jom.OrderedMap, f))
                     for f in ("insert", "erase"))
    for _ in range(5):
        k = rng.integers(0, 100, 40).astype(np.int32)
        v = rng.standard_normal(40).astype(np.float32)
        t, j = t.insert(_t(k), _t(v)), insert(j, jnp.asarray(k),
                                              jnp.asarray(v))
        _map_eq(t, j)
        # erase only present keys: there the JAX erase is well defined
        present = t.keys[: int(t.count)].numpy()
        dels = rng.choice(present, 10).astype(np.int32)
        t, j = t.erase(_t(dels)), erase(j, jnp.asarray(dels))
        _map_eq(t, j)
    q = rng.integers(-5, 105, 300).astype(np.int32)
    _eq(t.find(_t(q)), j.find(jnp.asarray(q)))
    _eq(t.get(_t(q), default=-1.0), j.get(jnp.asarray(q), default=-1.0))
    _eq(t.lower_bound(_t(q)), j.lower_bound(jnp.asarray(q)))
    _eq(t.mask, j.mask)


def test_ordered_map_vector_values_and_overflow():
    rng = np.random.default_rng(12)
    t = tom.ordered_map(16, (3,), device=CPU, value_dtype=torch.int32)
    j = jom.ordered_map(16, (3,), jnp.int32)
    k = rng.integers(-50, 50, 40).astype(np.int32)     # past the capacity
    v = rng.integers(0, 9, (40, 3)).astype(np.int32)
    t, j = t.insert(_t(k), _t(v)), j.insert(jnp.asarray(k), jnp.asarray(v))
    _map_eq(t, j)
    assert int(t.count) == 16
    _eq(t.get(_t(k)), j.get(jnp.asarray(k)))


def test_ordered_map_random_oracle():
    """Against a dict, misses in the erase batches included."""
    rng = np.random.default_rng(42)
    m = tom.ordered_map(256, device=CPU)
    ref = {}
    for _ in range(8):
        k = rng.integers(0, 100, 40).astype(np.int32)
        v = rng.standard_normal(40).astype(np.float32)
        m = m.insert(_t(k), _t(v))
        for kk, vv in zip(k, v):
            ref[int(kk)] = float(vv)
        dels = rng.integers(0, 100, 10).astype(np.int32)
        m = m.erase(_t(dels))
        for d in dels:
            ref.pop(int(d), None)
    assert int(m.count) == len(ref)
    qs = np.asarray(sorted(ref), np.int32)
    np.testing.assert_array_equal(m.keys[: len(ref)].numpy(), qs)
    np.testing.assert_allclose(m.get(_t(qs)).numpy(),
                               [ref[int(q)] for q in qs], rtol=1e-6)


def test_ordered_map_erase_slot0_then_miss():
    """A hit in slot 0 followed by a miss: the key is erased (the JAX
    package keeps it, see the module docstring)."""
    m = tom.ordered_map(8, device=CPU).insert(
        torch.tensor([1, 2, 3], dtype=torch.int32), torch.ones(3))
    out = m.erase(torch.tensor([1, 7], dtype=torch.int32))
    assert out.keys[:2].tolist() == [2, 3] and int(out.count) == 2


def test_ring_buffer_matches_zpc_tpu():
    t = tom.ring_buffer(4, device=CPU)
    j = jom.ring_buffer(4)
    outs_t, outs_j = [], []
    for step in range(12):
        if step % 3 == 2:
            t, vt = t.pop()
            j, vj = j.pop()
            outs_t.append(float(vt))
            outs_j.append(float(vj))
        else:
            t, j = t.push(float(step)), j.push(float(step))
        _eq(t.data, j.data)
        _eq(t.head, j.head)
        _eq(t.size, j.size)
    assert outs_t == outs_j
    assert float(t.peek(1)) == float(j.peek(1))


# -- IndexBuckets -------------------------------------------------------------

@pytest.mark.parametrize("n,dx,cap", [(1000, 0.1, 4096), (2000, 0.15, 2048),
                                      (1, 0.2, 8)])
def test_index_buckets_match_zpc_tpu(n, dx, cap):
    rng = np.random.default_rng(n)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    valid = rng.random(n) < 0.85
    for v in (None, valid):
        t = tib.build_index_buckets(_t(x), dx, cap,
                                    None if v is None else _t(v))
        j = jax.jit(jib.build_index_buckets, static_argnums=(1, 2))(
            jnp.asarray(x), dx, cap, None if v is None else jnp.asarray(v))
        _eq(t.table.keys, j.table.keys)
        _eq(t.offsets, j.offsets)
        _eq(t.indices, j.indices)
        _eq(t.count, j.count)
        q = rng.uniform(-1.1, 1.1, (50, 3)).astype(np.float32)
        ids, mask = tib.neighbor_candidates(t, _t(q), k_per_cell=16)
        jids, jmask = jax.jit(jib.neighbor_candidates, static_argnums=2)(
            j, jnp.asarray(q), 16)
        _eq(ids, jids)
        _eq(mask, jmask)
        s, e = t.cell_range(t.cell_of(_t(x)))
        js, je = j.cell_range(j.cell_of(jnp.asarray(x)))
        _eq(s, js)
        _eq(e, je)


def test_neighbor_candidates_cover_the_radius():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
    q = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    ib = tib.build_index_buckets(_t(x), 0.15, 2048)
    ids, mask = tib.neighbor_candidates(ib, _t(q), k_per_cell=64, ring=1)
    for i in range(50):
        d = np.linalg.norm(x - q[i], axis=1)
        need = set(np.nonzero(d < 0.15)[0].tolist())
        assert need <= set(ids[i][mask[i]].tolist())
    far = tib.build_index_buckets(_t(x[:50] * 0.1), 0.05, 128)
    s, e = far.cell_range(torch.tensor([[100, 100, 100]], dtype=torch.int32))
    assert int(s[0]) == int(e[0]) == 0


# -- sparse grid remainder ----------------------------------------------------

def _corners(bs=4):
    return np.stack(np.meshgrid(*[np.arange(bs)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)


def _grids(blocks, dx=0.5, cap=256, dilation=0, wide=False, origin=None):
    t = tsg.sparse_grid([tz.prop("rho"), tz.prop("vel", 3)], dx=dx,
                        block_capacity=cap, device=CPU, origin=origin,
                        wide_keys=wide)
    j = jsg.sparse_grid([jprop("rho"), jprop("vel", 3)], dx=dx,
                        block_capacity=cap, origin=origin, wide_keys=wide)
    t, ts = t.activate_with_slots(_t(blocks), dilation=dilation)
    j, js = jax.jit(jsg.SparseGrid.activate_with_slots, static_argnums=3)(
        j, jnp.asarray(blocks), None, dilation)
    _eq(t.table.keys, j.table.keys)
    _eq(t.table.count, j.table.count)
    _eq(ts, js)
    # a smooth field on the active cells: rho(c) and vel(c) from the cell
    cells = np.asarray(j.table.active_coords)[:, None, :] * 4 + _corners()
    w = cells.astype(np.float32) * 0.37
    rho = (np.sin(w[..., 0]) + w[..., 1] * w[..., 2]).astype(np.float32)
    vel = np.stack([np.cos(w[..., 1]), w[..., 0] ** 2, -w[..., 2]],
                   -1).astype(np.float32)
    return (t.with_data(rho=_t(rho), vel=_t(vel)),
            j.with_data(rho=jnp.asarray(rho), vel=jnp.asarray(vel)))


@pytest.mark.parametrize("dilation", [0, 1])
def test_sparse_grid_queries_and_sampling(dilation):
    rng = np.random.default_rng(dilation)
    blocks = rng.integers(-3, 3, (40, 3)).astype(np.int32)
    t, j = _grids(blocks, dilation=dilation, origin=[0.25, -0.5, 1.0])
    cells = rng.integers(-16, 16, (300, 3)).astype(np.int32)
    b, lin = t.decompose_cell(_t(cells))
    jb, jlin = j.decompose_cell(jnp.asarray(cells))
    _eq(b, jb)
    _eq(lin, jlin)
    _eq(t.cell_slot(_t(cells)), j.cell_slot(jnp.asarray(cells)))
    pts = rng.uniform(-6.0, 6.0, (200, 3)).astype(np.float32)

    def queries(g, c, x):
        return [(g.value_or(p, c, -3.0), g.sample(p, x),
                 g.sample_gradient(p, x), g.sample_staggered(p, x))
                for p in ("rho", "vel")]
    # the JAX side in one compiled call: op by op it takes seconds
    ref = jax.jit(queries)(j, jnp.asarray(cells), jnp.asarray(pts))
    for p, (v, smp, grad, stag) in zip(("rho", "vel"), ref):
        _eq(t.value_or(p, _t(cells), -3.0), v)
        np.testing.assert_allclose(t.sample(p, _t(pts)).numpy(),
                                   np.asarray(smp), rtol=1e-6, atol=1e-6)
        g = t.sample_gradient(p, _t(pts)).numpy()
        assert g.shape == grad.shape == pts.shape
        np.testing.assert_allclose(g, np.asarray(grad), rtol=0,
                                   atol=1e-6 * np.abs(grad).max())
        np.testing.assert_allclose(t.sample_staggered(p, _t(pts)).numpy(),
                                   np.asarray(stag), rtol=1e-6, atol=1e-6)
    i = rng.uniform(-9, 9, (30, 3)).astype(np.float32)
    np.testing.assert_allclose(t.index_to_world(_t(i)).numpy(),
                               np.asarray(j.index_to_world(jnp.asarray(i))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        t.node_world_positions().numpy(),
        np.asarray(j.node_world_positions()), rtol=1e-6, atol=1e-6)
    z = t.zeroed()
    assert all(not v.any() for v in z.data.values())
    assert torch.equal(z.table.keys, t.table.keys)


def test_sparse_grid_sample_linear_field():
    """The sampled gradient of a linear ramp is its slope."""
    t, _ = _grids(np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                           -1).reshape(-1, 3).astype(np.int32), dx=1.0)
    cells = t.table.active_coords[:, None, :] * 4 + torch.as_tensor(
        _corners())
    t = t.with_data(rho=(2.0 * cells[..., 0] - cells[..., 2]).float())
    pts = torch.from_numpy(np.random.default_rng(3).uniform(
        2.0, 8.0, (40, 3)).astype(np.float32))
    np.testing.assert_allclose(t.sample("rho", pts).numpy(),
                               (2 * pts[:, 0] - pts[:, 2]).numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(t.sample_gradient("rho", pts).numpy(),
                               np.tile([2.0, 0.0, -1.0], (40, 1)),
                               atol=1e-4)


def test_sparse_grid_wide_keys_far_domain():
    blocks = np.asarray([[100000, 9000, -20000], [100001, 9000, -20000],
                         [-5000, -9000, 30000]], np.int32)
    t, j = _grids(blocks, dx=1.0, cap=64, dilation=1, wide=True)
    assert isinstance(t.table, tbt.WideBlockTable)
    _eq(t.table.kyz, j.table.kyz)
    cells = blocks * 4 + 1
    cs = t.cell_slot(_t(cells))
    _eq(cs, j.cell_slot(jnp.asarray(cells)))
    assert (cs >= 0).all()
    _eq(t.value_or("rho", _t(cells), -1.0),
        j.value_or("rho", jnp.asarray(cells), -1.0))
    with pytest.raises(ValueError):
        tsg.sparse_grid([tz.prop("m")], dx=1.0, block_capacity=4,
                        device=CPU, dim=2, wide_keys=True)


@pytest.mark.parametrize("shape,threshold", [((9, 7, 12), None),
                                             ((16, 16, 16), 0.5),
                                             ((10, 6), 0.2)])
def test_sparse_grid_dense_conversions(shape, threshold):
    rng = np.random.default_rng(len(shape))
    arr = rng.standard_normal(shape).astype(np.float32)
    arr[arr < 0.3] = 0
    t = tsg.sparse_grid_from_dense(_t(arr), dx=0.5, prop_name="a",
                                   threshold=threshold)
    j = jax.jit(jsg.sparse_grid_from_dense, static_argnames=(
        "dx", "prop_name", "threshold"))(jnp.asarray(arr), dx=0.5,
                                          prop_name="a", threshold=threshold)
    _eq(t.table.keys, j.table.keys)
    _eq(t.data["a"], j.data["a"])
    lo, hi = [-2] * len(shape), [s + 3 for s in shape]
    dense = tsg.sparse_grid_to_dense(t, "a", lo, hi, default=-1.0)
    _eq(dense, jax.jit(jsg.sparse_grid_to_dense, static_argnums=(1, 2, 3))(
        j, "a", tuple(lo), tuple(hi), -1.0))
    if threshold is None:
        inner = dense.numpy()[tuple(slice(2, 2 + s) for s in shape)]
        np.testing.assert_array_equal(inner, arr)


@pytest.mark.cuda
def test_containers_on_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel has no CPU mode")
    dev = tz.cuda_device()
    rng = np.random.default_rng(0)
    c = _far_coords(rng, 100_000)
    t, inv = tbt.build_wide_block_table(_t(c), 131_072)
    g, ginv = tbt.build_wide_block_table(_t(c).to(dev), 131_072)
    assert torch.equal(g.kx.cpu(), t.kx) and torch.equal(ginv.cpu(), inv)
    k = rng.integers(0, 1 << 20, 200_000).astype(np.int32)
    v = rng.standard_normal(200_000).astype(np.float32)
    m = tom.ordered_map(262_144, device=CPU).insert(_t(k), _t(v))
    mg = tom.ordered_map(262_144, device=dev).insert(_t(k).to(dev),
                                                     _t(v).to(dev))
    assert torch.equal(mg.keys.cpu(), m.keys)
    assert torch.equal(mg.values.cpu(), m.values)
    x = rng.uniform(0, 1, (100_000, 3)).astype(np.float32)
    ib = tib.build_index_buckets(_t(x), 1 / 64, 131_072)
    ibg = tib.build_index_buckets(_t(x).to(dev), 1 / 64, 131_072)
    assert torch.equal(ibg.offsets.cpu(), ib.offsets)
    assert torch.equal(ibg.indices.cpu(), ib.indices)
