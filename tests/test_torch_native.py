"""The port's native host runtime (zpc_tpu_torch.utils.native over its own
copy of host_ops.cpp, built with g++ into zpc_tpu_torch/_build/) against
zpc_tpu.utils.native, numpy and the port's own bgeo packing.

Tolerances: none; keys, permutations and bytes are compared for
equality.  The library is needed by every test but the fallback one: a
fixture skips them where no compiler can build it.
"""

import ctypes

import numpy as np
import pytest
import torch

from zpc_tpu_torch.math.bits import morton3d
from zpc_tpu_torch.utils import io as TIO
from zpc_tpu_torch.utils import native

# every test here compares with zpc_tpu
try:
    import jax.numpy as jnp
    from zpc_tpu.math.bits import morton3d as jax_morton3d
    from zpc_tpu.utils import native as jax_native
except ImportError:
    pass


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def lib():
    lib = native.load()
    if lib is None:
        pytest.skip("no C++ compiler: the native library cannot be built")
    return lib


def test_built_from_the_checked_in_source(lib):
    assert native.available()
    assert lib.zpc_abi_version() == 1
    assert native._build().parent == native._BUILD
    assert native._BUILD.name == "_build" and \
        native._BUILD.parent.name == "zpc_tpu_torch"


def test_morton_matches_device_impl(lib, rng):
    c = rng.integers(0, 1024, (1000, 3)).astype(np.int32)
    host = native.morton3d_host(c)
    np.testing.assert_array_equal(host, morton3d(torch.from_numpy(c)).numpy())
    np.testing.assert_array_equal(host,
                                  np.asarray(jax_morton3d(jnp.asarray(c))))
    np.testing.assert_array_equal(host, jax_native.morton3d_host(c))


def test_radix_sort_pairs(lib, rng):
    k = rng.integers(0, 1 << 20, 10000).astype(np.int32)
    v = np.arange(10000, dtype=np.int32)
    ks, vs = native.radix_sort_pairs_host(k.copy(), v.copy())
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ks, k[order])
    np.testing.assert_array_equal(vs, v[order])
    jk, jv = jax_native.radix_sort_pairs_host(k.copy(), v.copy())
    np.testing.assert_array_equal(vs, jv)


def test_radix_sort_negative_keys(lib, rng):
    """Keys sort as uint32 bit patterns (negative keys last), stably."""
    k = rng.integers(-1000, 1000, 4096).astype(np.int32)
    v = np.arange(4096, dtype=np.int32)
    _, vs = native.radix_sort_pairs_host(k.copy(), v.copy())
    np.testing.assert_array_equal(
        vs, v[np.argsort(k.astype(np.uint32), kind="stable")])


def test_radix_sort_bit_window(lib, rng):
    k = rng.integers(0, 1 << 16, 5000).astype(np.int32)
    v = np.arange(5000, dtype=np.int32)
    _, vs = native.radix_sort_pairs_host(k.copy(), v.copy(), sbit=4,
                                         ebit=12)
    np.testing.assert_array_equal(vs, v[np.argsort((k >> 4) & 0xFF,
                                                   kind="stable")])
    _, jv = jax_native.radix_sort_pairs_host(k.copy(), v.copy(), sbit=4,
                                             ebit=12)
    np.testing.assert_array_equal(vs, jv)


def test_pack_unpack_roundtrip(lib, rng):
    pos = rng.standard_normal((500, 3)).astype(np.float32)
    vel = rng.standard_normal((500, 3)).astype(np.float32)
    m = rng.standard_normal((500, 1)).astype(np.float32)
    rec = native.pack_be_records([pos, vel, m], [3, 3, 1])
    assert rec is not None and rec.shape == (500, 7)
    np.testing.assert_array_equal(rec[:, :3].view(np.float32),
                                  pos.astype(">f4").view(np.float32))
    np.testing.assert_array_equal(
        rec, jax_native.pack_be_records([pos, vel, m], [3, 3, 1]))
    cols = native.unpack_be_records(rec, [3, 3, 1])
    for got, want in zip(cols, (pos, vel, m)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        native.pack_be_records([pos, vel], [3, 2])


def test_pack_equals_the_bgeo_writers_records(lib, rng, tmp_path):
    """The records the port's write_bgeo packs with numpy (x y z w, then
    the attributes, big-endian) are pack_be_records' bytes."""
    n = 777
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    path = str(tmp_path / "p.bgeo")
    TIO.write_bgeo(path, pos, {"v": vel})
    with open(path, "rb") as f:
        raw = f.read()
    rec = native.pack_be_records([pos, np.ones((n, 1), np.float32), vel],
                                 [3, 1, 3])
    assert raw[-2 - rec.nbytes:-2] == rec.tobytes()


def test_arena(lib):
    a = lib.zpc_arena_create(1024)
    p1 = lib.zpc_arena_alloc(a, 100, 64)
    p2 = lib.zpc_arena_alloc(a, 100, 64)
    assert p1 and p2 and p2 - p1 == 128
    assert not lib.zpc_arena_alloc(a, 2000, 8)       # overflow: NULL
    lib.zpc_arena_reset(a)
    assert lib.zpc_arena_alloc(a, 100, 64) == p1
    lib.zpc_arena_destroy(a)
    assert isinstance(a, int) and ctypes.c_void_p(a).value == a


def test_without_a_compiler(monkeypatch, rng):
    """No library: morton keys and the sort computed in PyTorch and
    numpy, the same results; the record packers give None (JAX's
    contract)."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert not native.available()
    c = rng.integers(0, 1024, (300, 3)).astype(np.int32)
    np.testing.assert_array_equal(native.morton3d_host(c),
                                  np.asarray(jax_morton3d(jnp.asarray(c))))
    k = rng.integers(0, 1 << 16, 2000).astype(np.int32)
    v = np.arange(2000, dtype=np.int32)
    for sbit, ebit in ((0, 32), (4, 12)):
        _, vs = native.radix_sort_pairs_host(k, v, sbit, ebit)
        _, jv = jax_native.radix_sort_pairs_host(k.copy(), v.copy(), sbit,
                                                 ebit)
        np.testing.assert_array_equal(vs, jv)
    assert native.pack_be_records([c.astype(np.float32)], [3]) is None
    assert native.unpack_be_records(np.zeros((2, 3), np.float32),
                                    [3]) is None
