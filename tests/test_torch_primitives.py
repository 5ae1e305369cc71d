"""The port's parallel primitives (zpc_tpu_torch.parallel.primitives)
against zpc_tpu's on the same seeded numpy inputs.

The JAX side runs under ``jit_exec()`` on the CPU, the port under its CPU
oracle policy ``seq_exec()``.  Integers, permutations and sorted keys are
held exactly.  A float reduction or scan is held within 1e-6 of the sum of
|x| over the elements it adds: the two sides add in different orders, so a
tolerance relative to the result itself would fail wherever the sum
cancels.  Where the JAX result is unspecified (the order of ties in an
unstable pair sort) the test holds the (key, value) pairs as a multiset.
"""

import numpy as np
import pytest
import torch

# JAX is imported where it is installed (the machine with the card has
# none, and runs only the cuda test); every other test needs zpc_tpu
try:
    import jax.numpy as jnp
    import zpc_tpu as jz
    from zpc_tpu.parallel import primitives as JP
    JPOL = jz.jit_exec()
except ImportError:
    jnp = jz = JP = JPOL = None

import zpc_tpu_torch as tz
from zpc_tpu_torch.parallel import primitives as TP

TPOL = tz.seq_exec()
SIZES = [1, 2, 7, 1024, 8192]      # a few of conftest's ORACLE_SIZES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(rng, n, lo=-1000, hi=1000):
    return rng.integers(lo, hi, size=n).astype(np.int32)


def _u32(rng, n):
    return rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _eq(got, ref):
    got, ref = _n(got), _n(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


def _close_sum(got, ref, x):
    """Within 1e-6 of sum |x| (see the module docstring)."""
    scale = max(float(np.abs(x.astype(np.float64)).sum()), 1e-30)
    assert abs(float(got) - float(ref)) <= 1e-6 * scale


# -- reduce -------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_reduce_int32(n, op):
    a = _ints(np.random.default_rng(n), n)
    _eq(TP.reduce(TPOL, _t(a), op), JP.reduce(JPOL, jnp.asarray(a), op))


@pytest.mark.parametrize("n", SIZES)
def test_reduce_f32_sum(n):
    a = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = TP.reduce(TPOL, _t(a), "sum")
    assert got.dtype == torch.float32 and got.dim() == 0
    _close_sum(got, JP.reduce(JPOL, jnp.asarray(a), "sum"), a)


def test_reduce_wraps_and_dtypes():
    rng = np.random.default_rng(1)
    big = rng.integers(2 ** 29, 2 ** 31 - 1, 64).astype(np.int32)
    _eq(TP.reduce(TPOL, _t(big)), JP.reduce(JPOL, jnp.asarray(big)))
    _eq(TP.reduce(TPOL, _t(big), "prod"),
        JP.reduce(JPOL, jnp.asarray(big), "prod"))
    u = _u32(rng, 257)
    for op in ("add", "max", "min"):
        _eq(TP.reduce(TPOL, _t(u), op), JP.reduce(JPOL, jnp.asarray(u), op))
    b = rng.random(100) < 0.3
    _eq(TP.reduce(TPOL, _t(b)), JP.reduce(JPOL, jnp.asarray(b)))
    a = _ints(rng, 100)
    for op in ("max", "min"):
        _eq(TP.reduce(TPOL, _t(a), op, init=7),
            JP.reduce(JPOL, jnp.asarray(a), op, init=7))
    # XLA's reduce needs an identity as its init and folds any other one
    # in more than once (here 4 times); the port folds it in once
    assert int(TP.reduce(TPOL, _t(a), "add", init=7)) == int(a.sum()) + 7
    # a custom associative op takes the generic fold with its init
    _eq(TP.reduce(TPOL, _t(a), torch.bitwise_xor, init=0),
        JP.reduce(JPOL, jnp.asarray(a), jnp.bitwise_xor, init=0))
    _eq(TP.reduce(TPOL, _t(a[:0])), JP.reduce(JPOL, jnp.asarray(a[:0])))
    with pytest.raises(RuntimeError):
        TP.reduce(TPOL, _t(a[:0]), "min")     # jnp.min of nothing raises


# -- scans --------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_scans_int32(n, op):
    a = _ints(np.random.default_rng(n + 1), n)
    _eq(TP.inclusive_scan(TPOL, _t(a), op),
        JP.inclusive_scan(JPOL, jnp.asarray(a), op))
    _eq(TP.exclusive_scan(TPOL, _t(a), op),
        JP.exclusive_scan(JPOL, jnp.asarray(a), op))


@pytest.mark.parametrize("n", SIZES)
def test_scans_f32(n):
    """Held to test_scan_pallas.py's tolerance (rtol 2e-4, atol 1e-3):
    the two sides sum prefixes in different orders."""
    a = np.random.default_rng(n + 2).standard_normal(n).astype(np.float32)
    for t_fn, j_fn in ((TP.inclusive_scan, JP.inclusive_scan),
                       (TP.exclusive_scan, JP.exclusive_scan)):
        got = t_fn(TPOL, _t(a)).numpy()
        ref = np.asarray(j_fn(JPOL, jnp.asarray(a)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-3)


def test_scans_other_ops_and_dtypes():
    rng = np.random.default_rng(3)
    u = _u32(rng, 3000)
    for op in ("add", "max", "min"):
        _eq(TP.inclusive_scan(TPOL, _t(u), op),
            JP.inclusive_scan(JPOL, jnp.asarray(u), op))
        _eq(TP.exclusive_scan(TPOL, _t(u), op),
            JP.exclusive_scan(JPOL, jnp.asarray(u), op))
    a = rng.integers(-3, 4, 300).astype(np.int32)
    _eq(TP.inclusive_scan(TPOL, _t(a), "mul"),
        JP.inclusive_scan(JPOL, jnp.asarray(a), "mul"))
    _eq(TP.exclusive_scan(TPOL, _t(a), torch.mul, init=5),
        JP.exclusive_scan(JPOL, jnp.asarray(a), jnp.multiply, init=5))
    _eq(TP.inclusive_scan(TPOL, _t(a), torch.bitwise_xor),
        JP.inclusive_scan(JPOL, jnp.asarray(a), jnp.bitwise_xor))
    m = rng.integers(-9, 9, (50, 3)).astype(np.int32)      # along axis 0
    _eq(TP.inclusive_scan(TPOL, _t(m)),
        JP.inclusive_scan(JPOL, jnp.asarray(m)))
    b = rng.random(40) < 0.2                               # add is or
    _eq(TP.inclusive_scan(TPOL, _t(b)),
        JP.inclusive_scan(JPOL, jnp.asarray(b)))
    _eq(TP.exclusive_scan(TPOL, _t(a), "max", init=2),
        JP.exclusive_scan(JPOL, jnp.asarray(a), "max", init=2))
    e = _t(a[:0])
    assert TP.inclusive_scan(TPOL, e).numel() == 0
    assert TP.exclusive_scan(TPOL, e, "min").numel() == 0


def test_every_prefix_sum_goes_through_the_scan(monkeypatch):
    """The scans, select_if and unique reach ``primitives.scan`` (on the
    card, the scan kernel), which chip_smoke's recorder patches."""
    seen = []
    inner = TP.scan

    def record(x, op="add", exclusive=False):
        seen.append((x.numel(), op, exclusive))
        return inner(x, op, exclusive)
    monkeypatch.setattr(TP, "scan", record)
    x = _t(_ints(np.random.default_rng(4), 100))
    TP.inclusive_scan(TPOL, x)
    TP.exclusive_scan(TPOL, x)
    TP.inclusive_scan(TPOL, x, "max")
    TP.select_if(TPOL, x, x > 0)
    TP.unique(TPOL, torch.sort(x).values)
    assert seen == [(100, "add", False), (100, "add", True),
                    (100, "max", False), (100, "add", False),
                    (100, "add", False)]


# -- sorts --------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_sorts(n):
    rng = np.random.default_rng(n + 5)
    a = _ints(rng, n)
    f = rng.standard_normal(n).astype(np.float32)
    u = _u32(rng, n)
    for x in (a, f, u):
        ref = JP.sort(JPOL, jnp.asarray(x))
        _eq(TP.sort(TPOL, _t(x)), ref)
        _eq(TP.merge_sort(TPOL, _t(x)), ref)
        _eq(TP.radix_sort(TPOL, _t(x)) if x.dtype != np.float32
            else TP.sort(TPOL, _t(x)), ref)


@pytest.mark.parametrize("n", SIZES)
def test_sort_pair_unpacked(n):
    """Ties of an unstable pair sort are unspecified: keys exact, the
    (key, value) pairs equal as a multiset."""
    rng = np.random.default_rng(n + 6)
    k = _ints(rng, n, 0, 50)
    v = rng.standard_normal(n).astype(np.float32)
    ko, vo = TP.sort_pair(TPOL, _t(k), _t(v))
    jk, jv = JP.sort_pair(JPOL, jnp.asarray(k), jnp.asarray(v))
    _eq(ko, jk)
    assert vo.dtype == torch.float32
    assert sorted(zip(ko.tolist(), vo.tolist())) == \
        sorted(zip(np.asarray(jk).tolist(), np.asarray(jv).tolist()))
    mk, mv = TP.merge_sort_pair(TPOL, _t(k), _t(v))
    jmk, jmv = JP.merge_sort_pair(JPOL, jnp.asarray(k), jnp.asarray(v))
    _eq(mk, jmk)
    _eq(mv, jmv)


@pytest.mark.parametrize("kbits,vbits", [(10, 21), (10, 22), (1, 30),
                                         (16, 16)])
def test_sort_pair_packing_threshold(kbits, vbits):
    """Both sides of the packed path's 31-bit limit: the packed path orders
    ties by value, exactly as JAX's; past the limit the pairs hold as a
    multiset."""
    rng = np.random.default_rng(kbits * 100 + vbits)
    n = 3000
    k = rng.integers(0, 2 ** kbits, n).astype(np.int32)
    v = rng.integers(0, 2 ** vbits, n).astype(np.int32)
    kw = dict(key_bound=2 ** kbits, val_bound=2 ** vbits)
    ko, vo = TP.sort_pair(TPOL, _t(k), _t(v), **kw)
    jk, jv = JP.sort_pair(JPOL, jnp.asarray(k), jnp.asarray(v), **kw)
    _eq(ko, jk)
    if kbits + vbits <= 31:
        assert TP._pack_ok(2 ** kbits, 2 ** vbits)
        _eq(vo, jv)
    else:
        assert not TP._pack_ok(2 ** kbits, 2 ** vbits)
        assert sorted(zip(ko.tolist(), vo.tolist())) == \
            sorted(zip(np.asarray(jk).tolist(), np.asarray(jv).tolist()))


@pytest.mark.parametrize("n,sbit,ebit", [
    (2048, 4, 12),            # packed: 8 + 11 bits
    (2048, 0, 20),            # packed: 20 + 11 = 31
    (2048, 0, 21),            # 21 + 11 = 32: the stable general path
    (4096, 0, 30),
    (1, 3, 9), (7, 0, 31), (1024, 16, 32)])
@pytest.mark.parametrize("dtype", ["int32", "uint32"])
def test_radix_sort_windows(n, sbit, ebit, dtype):
    rng = np.random.default_rng(n + sbit * 7 + ebit)
    k = _u32(rng, n)
    if dtype == "int32":
        k = k.view(np.int32)
    _eq(TP.radix_sort(TPOL, _t(k), sbit, ebit),
        JP.radix_sort(JPOL, jnp.asarray(k), sbit, ebit))
    v = np.arange(n, dtype=np.int32)
    for ranks in (False, True):
        ko, vo = TP.radix_sort_pair(TPOL, _t(k), _t(v), sbit, ebit,
                                    vals_are_ranks=ranks)
        jk, jv = JP.radix_sort_pair(JPOL, jnp.asarray(k), jnp.asarray(v),
                                    sbit, ebit, vals_are_ranks=ranks)
        _eq(ko, jk)
        _eq(vo, jv)
    # and the order is the stable order of the window
    window = (k.astype(np.uint64) >> sbit) & ((1 << (ebit - sbit)) - 1)
    np.testing.assert_array_equal(
        TP.radix_sort(TPOL, _t(k), sbit, ebit).numpy(),
        k[np.argsort(window, kind="stable")])


def test_radix_sort_pair_full_window_is_signed():
    """The whole key compares signed, as the JAX package's stable path
    does."""
    k = np.asarray([5, -3, 7, -3, 0], np.int32)
    v = np.arange(5, dtype=np.int32)
    ko, vo = TP.radix_sort_pair(TPOL, _t(k), _t(v))
    jk, jv = JP.radix_sort_pair(JPOL, jnp.asarray(k), jnp.asarray(v))
    _eq(ko, jk)
    _eq(vo, jv)
    assert vo.tolist() == [1, 3, 4, 0, 2]


@pytest.mark.parametrize("n,kb", [(4096, 2 ** 19), (4096, 2 ** 20),
                                  (4096, 5000), (1, 3), (8192, None)])
def test_argsort_stable(n, kb):
    """Packed (bits(kb) + bits(n) <= 31) and general paths."""
    rng = np.random.default_rng(n + (kb or 0))
    k = rng.integers(0, kb or 2 ** 31 - 1, n).astype(np.int32)
    got = TP.argsort_stable(TPOL, _t(k), key_bound=kb)
    _eq(got, JP.argsort_stable(JPOL, jnp.asarray(k), key_bound=kb))
    np.testing.assert_array_equal(got.numpy(), np.argsort(k, kind="stable"))
    u = _u32(rng, n)
    _eq(TP.argsort_stable(TPOL, _t(u)),
        JP.argsort_stable(JPOL, jnp.asarray(u)))


# -- histogram and segment reductions ----------------------------------------

@pytest.mark.parametrize("bins", [37, 1024, 1025, 5000])
def test_histogram(bins):
    rng = np.random.default_rng(bins)
    idx = rng.integers(-5, bins + 5, 20_000).astype(np.int32)  # some out
    _eq(TP.histogram(TPOL, _t(idx), bins),
        JP.histogram(JPOL, jnp.asarray(idx), bins))
    w = rng.standard_normal(20_000).astype(np.float32)
    got = TP.histogram(TPOL, _t(idx), bins, _t(w)).numpy()
    ref = np.asarray(JP.histogram(JPOL, jnp.asarray(idx), bins,
                                  jnp.asarray(w)))
    assert got.dtype == np.float32
    keep = (idx >= 0) & (idx < bins)
    scale = np.bincount(idx[keep], np.abs(w[keep]), minlength=bins)
    assert (np.abs(got - ref) <= 1e-6 * scale + 1e-30).all()


def test_segment_reduce():
    rng = np.random.default_rng(8)
    sid = np.sort(rng.integers(0, 100, 5000)).astype(np.int32)
    d = rng.standard_normal(5000).astype(np.float32)
    got = TP.segment_reduce(TPOL, _t(d), _t(sid), 100,
                            indices_are_sorted=True).numpy()
    ref = np.asarray(JP.segment_reduce(JPOL, jnp.asarray(d),
                                       jnp.asarray(sid), 100,
                                       indices_are_sorted=True))
    scale = np.bincount(sid, np.abs(d), minlength=100)
    assert (np.abs(got - ref) <= 1e-6 * scale).all()
    # ids out of range dropped; empty segments at the identity
    sid = rng.integers(-3, 13, 256).astype(np.int32)
    for data in (_ints(rng, 256), rng.standard_normal(256).astype(
            np.float32), rng.integers(-3, 4, 256).astype(np.int32)):
        for op in ("min", "max", "add", "prod"):
            g = TP.segment_reduce(TPOL, _t(data), _t(sid), 12, op)
            r = JP.segment_reduce(JPOL, jnp.asarray(data), jnp.asarray(sid),
                                  12, op)
            if data.dtype == np.float32 and op in ("add", "prod"):
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           rtol=1e-6)
            else:
                _eq(g, r)
    d2 = rng.standard_normal((300, 3)).astype(np.float32)
    s2 = rng.integers(0, 9, 300).astype(np.int32)
    _eq(TP.segment_reduce(TPOL, _t(d2), _t(s2), 9, torch.maximum),
        JP.segment_reduce(JPOL, jnp.asarray(d2), jnp.asarray(s2), 9,
                          jnp.maximum))
    with pytest.raises(ValueError):
        TP.segment_reduce(TPOL, _t(d), _t(sid[:5000]), 3, torch.bitwise_or)


@pytest.mark.parametrize("op", ["set", "add", "max", "min"])
def test_scatter_drop(op):
    rng = np.random.default_rng(9)
    target = _ints(rng, 50)
    dst = rng.integers(-2, 70, 200).astype(np.int32)
    if op == "set":                     # distinct lanes: the set is defined
        dst = rng.permutation(np.arange(-2, 70))[:60].astype(np.int32)
    vals = _ints(rng, dst.shape[0])
    _eq(TP.scatter_drop(_t(target), _t(dst), _t(vals), op),
        JP.scatter_drop(jnp.asarray(target), jnp.asarray(dst),
                        jnp.asarray(vals), op))


# -- compaction ---------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_count_select_unique(n):
    rng = np.random.default_rng(n + 10)
    d = _ints(rng, n)
    m = d > 0
    _eq(TP.count_if(TPOL, _t(m)), JP.count_if(JPOL, jnp.asarray(m)))
    packed, cnt = TP.select_if(TPOL, _t(d), _t(m), fill=-9)
    jp, jc = JP.select_if(JPOL, jnp.asarray(d), jnp.asarray(m), fill=-9)
    _eq(packed, jp)
    _eq(cnt, jc)
    s = np.sort(_ints(rng, n, 0, 50))
    vm = rng.random(n) < 0.8
    for valid in (None, vm):
        got = TP.unique(TPOL, _t(s), None if valid is None else _t(valid))
        ref = JP.unique(JPOL, jnp.asarray(s),
                        None if valid is None else jnp.asarray(valid))
        for g, r in zip(got, ref):
            _eq(g, r)
    u = np.sort(_u32(rng, n))
    for g, r in zip(TP.unique(TPOL, _t(u)), JP.unique(JPOL, jnp.asarray(u))):
        _eq(g, r)
    rows = rng.integers(-5, 5, (n, 3)).astype(np.int32)
    p2, c2 = TP.select_if(TPOL, _t(rows), _t(m))
    j2, k2 = JP.select_if(JPOL, jnp.asarray(rows), jnp.asarray(m))
    _eq(p2, j2)
    _eq(c2, k2)


def test_empty_compaction():
    """Empty inputs (the JAX package's unique raises on them)."""
    e = torch.zeros(0, dtype=torch.int32)
    packed, cnt = TP.select_if(TPOL, e, e > 0)
    assert packed.numel() == 0 and int(cnt) == 0
    uniq, cnt, inv = TP.unique(TPOL, e)
    assert uniq.numel() == 0 and int(cnt) == 0 and inv.numel() == 0
    assert int(TP.count_if(TPOL, e > 0)) == 0
    for fn in (TP.sort, TP.merge_sort, TP.radix_sort):
        assert fn(TPOL, e).numel() == 0


def test_monoid_identities():
    assert TP.monoid_identity("add", torch.float32) == 0
    assert TP.monoid_identity(torch.mul, torch.int32) == 1
    assert TP.monoid_identity("min", torch.float32) == np.inf
    assert TP.monoid_identity(torch.maximum, torch.int32) == -2 ** 31
    assert TP.monoid_identity("min", torch.uint32) == 2 ** 32 - 1
    assert TP.monoid_identity("max", torch.uint32) == 0
    for op, jop in (("add", jnp.add), ("prod", jnp.multiply),
                    ("min", jnp.minimum), ("max", jnp.maximum)):
        for dt, jdt in ((torch.int32, np.int32), (torch.float32, np.float32),
                        (torch.uint32, np.uint32)):
            assert TP.monoid_identity(op, dt) == \
                JP.monoid_identity(jop, jdt)
    with pytest.raises(ValueError):
        TP.monoid_identity(torch.bitwise_xor, torch.int32)


def test_top_level_names_match_zpc_tpu():
    import zpc_tpu
    missing = [n for n in zpc_tpu.__all__ if not hasattr(tz, n)]
    assert missing == []
    assert set(zpc_tpu.__all__) <= set(tz.__all__)


def test_policy_refuses_a_tensor_on_another_device():
    x = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        TP.reduce(TPOL, x)


@pytest.mark.cuda
def test_primitives_on_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel has no CPU mode")
    card = tz.tpu_exec()
    rng = np.random.default_rng(0)
    n = 1 << 20
    a = _ints(rng, n)
    f = rng.standard_normal(n).astype(np.float32)
    u = _u32(rng, n)

    def same(fn, *args, **kw):
        got = fn(card, *(x.cuda() if isinstance(x, torch.Tensor) else x
                         for x in args), **kw)
        ref = fn(TPOL, *args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref):
            g = g.cpu()
            assert g.dtype == r.dtype
            if r.dtype == torch.float32:
                assert torch.allclose(g, r, rtol=2e-4, atol=1e-3)
            else:
                assert torch.equal(g.to(torch.int64), r.to(torch.int64))

    for x in (_t(a), _t(u)):
        for op in ("add", "min", "max"):
            same(TP.reduce, x, op)
            same(TP.inclusive_scan, x, op)
        same(TP.exclusive_scan, x)
        same(TP.sort, x)
        same(TP.radix_sort, x, 4, 20)
        same(TP.argsort_stable, x)
    same(TP.reduce, _t(f))
    same(TP.inclusive_scan, _t(f))
    k = rng.integers(0, 4096, n).astype(np.int32)
    v = np.arange(n, dtype=np.int32)
    same(TP.sort_pair, _t(k), _t(v), key_bound=4096, val_bound=n)
    same(TP.merge_sort_pair, _t(k), _t(v))
    same(TP.radix_sort_pair, _t(a), _t(v), 0, 30)
    same(TP.radix_sort_pair, _t(a), _t(v), 4, 12, vals_are_ranks=True)
    same(TP.histogram, _t(k), 4096)
    same(TP.segment_reduce, _t(a), _t(k), 4096, "max")
    same(TP.select_if, _t(a), _t(a > 0))
    same(TP.unique, _t(np.sort(k)))
