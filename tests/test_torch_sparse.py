"""The port's CSR algebra (zpc_tpu_torch.math.sparse) and graph algorithms
(zpc_tpu_torch.utils.graph) against zpc_tpu's, on the same seeded numpy
inputs.

Structure (indptr, cols, nnz, row ids) is held exactly; merged values and
products at 1e-6 of the sum of |terms| per entry (both sides add the same
terms in another order).  Two reference faults are not copied and are held
to numpy instead: ``csr_from_coo``'s wide key above 2^31 - 1 entries, which
wraps in the JAX package, and or-and SpMV on an empty row (see
zpc_tpu_torch/math/sparse.py).  ``greedy_color`` draws its priorities from
a ``torch.Generator``, so it is held to being a proper colouring within
its colour budget, not to JAX's colours.
"""

import numpy as np
import pytest
import torch

# JAX is imported where it is installed (the machine with the card has
# none, and runs only the cuda test); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.math import sparse as js
    from zpc_tpu.utils import graph as jg
except ImportError:
    jax = jnp = js = jg = None

from zpc_tpu_torch.math import sparse as ts
from zpc_tpu_torch.utils import graph as tg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


def _coo(seed, nrows, ncols, nnz):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nrows, nnz).astype(np.int32),
            rng.integers(0, ncols, nnz).astype(np.int32),
            rng.standard_normal(nnz).astype(np.float32))


def _pair(r, c, v, nrows, ncols, valid=None, combine="add"):
    t = ts.csr_from_coo(_t(r), _t(c), _t(v), nrows, ncols,
                        None if valid is None else _t(valid), combine)
    j = jax.jit(js.csr_from_coo, static_argnums=(3, 4, 6))(
        jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), nrows, ncols,
        None if valid is None else jnp.asarray(valid), combine)
    return t, j


def _same_csr(t, j, scale):
    _eq(t.indptr, j.indptr)
    _eq(t.cols, j.cols)
    _eq(t.nnz, j.nnz)
    _eq(t.row_ids, j.row_ids)
    assert (np.abs(t.vals.numpy() - np.asarray(j.vals)) <=
            1e-6 * scale + 1e-30).all()


def _merged_scale(r, c, v, ncols, valid=None):
    """Sum of |v| per merged entry, in the CSR's lane order."""
    keep = np.ones(r.shape, bool) if valid is None else valid
    key = r[keep].astype(np.int64) * ncols + c[keep]
    uk, inv = np.unique(key, return_inverse=True)
    s = np.bincount(inv, np.abs(v[keep]), minlength=len(uk))
    return np.concatenate([s, np.zeros(len(r) - len(uk))])


@pytest.mark.parametrize("nrows,ncols,nnz", [(20, 30, 200), (50, 40, 500),
                                             (1, 1, 1), (7, 3, 60),
                                             (1000, 1000, 4000)])
def test_csr_from_coo_matches(nrows, ncols, nnz):
    r, c, v = _coo(nnz, nrows, ncols, nnz)
    valid = np.random.default_rng(1).random(nnz) < 0.8
    for vm in (None, valid):
        t, j = _pair(r, c, v, nrows, ncols, vm)
        _same_csr(t, j, _merged_scale(r, c, v, ncols, vm))
        dense = np.zeros((nrows, ncols), np.float64)
        keep = np.ones(nnz, bool) if vm is None else vm
        np.add.at(dense, (r[keep], c[keep]), v[keep])
        np.testing.assert_allclose(t.todense().numpy(), dense, atol=1e-5)
    t, j = _pair(r, c, v, nrows, ncols, combine="max")
    _same_csr(t, j, np.zeros(nnz))                 # a max is exact
    with pytest.raises(ValueError):
        ts.csr_from_coo(_t(r), _t(c), _t(v), nrows, ncols, combine="min")


def test_csr_wide_key_above_int32():
    """nrows * ncols = 4.9e9 > 2^31 - 1: the key is int64.  The entries
    (0, 5) and (61,356, 47,301) have keys 5 and 2^32 + 5, equal once
    wrapped to 32 bits, so the JAX package merges them; the port keeps
    both."""
    n = 70_000
    r = np.asarray([0, 61_356, 69_999, 12, 12, 69_999], np.int32)
    c = np.asarray([5, 47_301, 69_999, 7, 7, 0], np.int32)
    assert (61_356 * n + 47_301) % 2 ** 32 == 5
    v = np.arange(1, 7, dtype=np.float32)
    A = ts.csr_from_coo(_t(r), _t(c), _t(v), n, n)
    key = r.astype(np.int64) * n + c
    uk, inv = np.unique(key, return_inverse=True)
    assert int(A.nnz) == len(uk) == 5
    np.testing.assert_array_equal(A.cols[:5].numpy(), uk % n)
    np.testing.assert_array_equal(A.row_ids[:5].numpy(), uk // n)
    np.testing.assert_array_equal(A.vals[:5].numpy(),
                                  np.bincount(inv, v).astype(np.float32))
    indptr = np.searchsorted(uk // n, np.arange(n + 1))
    np.testing.assert_array_equal(A.indptr.numpy(), indptr)
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    ref = np.zeros(n, np.float64)
    np.add.at(ref, r, v.astype(np.float64) * x[c])
    np.testing.assert_allclose(ts.spmv(A, _t(x)).numpy(), ref, rtol=1e-6)


def test_transpose_and_spmv_match():
    r, c, v = _coo(3, 15, 25, 100)
    t, j = _pair(r, c, v, 15, 25)
    tt, jt = ts.csr_transpose(t), jax.jit(js.csr_transpose)(j)
    _eq(tt.indptr, jt.indptr)
    _eq(tt.cols, jt.cols)
    np.testing.assert_allclose(tt.todense().numpy(), t.todense().numpy().T,
                               atol=1e-6)
    x = np.random.default_rng(4).standard_normal(25).astype(np.float32)
    got = ts.spmv(t, _t(x)).numpy()
    ref = np.asarray(jax.jit(js.spmv)(j, jnp.asarray(x)))
    scale = np.abs(t.todense().numpy()) @ np.abs(x)
    assert (np.abs(got - ref) <= 1e-6 * scale + 1e-30).all()


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "max_plus",
                                      "min_times", "max_times"])
def test_spmv_semiring_and_mask_match(semiring):
    n = 40
    r, c, _ = _coo(5, n, n, 120)          # some rows stay empty
    w = np.random.default_rng(6).uniform(0.1, 2.0, 120).astype(np.float32)
    t, j = _pair(r, c, w, n, n, combine="max")
    x = np.random.default_rng(7).uniform(0, 5, n).astype(np.float32)
    mask = np.random.default_rng(8).random(n) < 0.6
    got = ts.spmv_semiring(t, _t(x), semiring).numpy()
    ref = np.asarray(js.spmv_semiring(j, jnp.asarray(x), semiring))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    got = ts.spmv_mask(t, _t(x), _t(mask), semiring).numpy()
    ref = np.asarray(js.spmv_mask(j, jnp.asarray(x), jnp.asarray(mask),
                                  semiring))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # the semiring given as its (reduce, map, identity) triple
    red, mul, ident = ts.SEMIRINGS[semiring]
    red = {"add": torch.add, "min": torch.minimum,
           "max": torch.maximum}[red]
    _eq(ts.spmv_semiring(t, _t(x), (red, mul, ident)),
        ts.spmv_semiring(t, _t(x), semiring).numpy())


def test_or_and_semiring():
    """Rows with entries match JAX; an empty row is False (JAX: True)."""
    n = 30
    r, c, _ = _coo(9, n, n, 40)
    vals = (np.random.default_rng(10).random(40) < 0.7).astype(np.float32)
    t, j = _pair(r, c, vals, n, n)
    x = np.random.default_rng(11).random(n) < 0.5
    got = ts.spmv_semiring(t, _t(x.astype(np.float32)), "or_and").numpy()
    ref = np.asarray(js.spmv_semiring(j, jnp.asarray(x, jnp.float32),
                                      "or_and"))
    has = np.bincount(r, minlength=n) > 0
    assert got.dtype == np.bool_ and (~has).any()
    np.testing.assert_array_equal(got[has], ref[has])
    np.testing.assert_array_equal(got[~has], False)
    dense = t.todense().numpy() != 0
    np.testing.assert_array_equal(got, (dense & x[None, :]).any(1))
    m = np.random.default_rng(12).random(n) < 0.5
    got = ts.spmv_mask(t, _t(x.astype(np.float32)), _t(m), "or_and")
    ref = js.spmv_mask(j, jnp.asarray(x, jnp.float32), jnp.asarray(m),
                       "or_and")
    _eq(got, ref)


@pytest.mark.parametrize("semiring", ["plus_times", "max_times"])
def test_spgemm_matches(semiring):
    n = 24
    rng = np.random.default_rng(13)

    def coo(density):
        D = (rng.random((n, n)) < density) * rng.standard_normal((n, n))
        r, c = np.nonzero(D)
        pad = 160 - r.size
        return (np.concatenate([r, np.zeros(pad, int)]).astype(np.int32),
                np.concatenate([c, np.zeros(pad, int)]).astype(np.int32),
                np.concatenate([D[r, c], np.zeros(pad)]).astype(np.float32),
                np.arange(160) < r.size)
    (ra, ca, va, ma), (rb, cb, vb, mb) = coo(0.15), coo(0.15)
    tA, jA = _pair(ra, ca, va, n, n, ma)
    tB, jB = _pair(rb, cb, vb, n, n, mb)
    for bound in (16, 2):
        C, ovf = ts.spgemm(tA, tB, bound, semiring)
        jC, jovf = jax.jit(js.spgemm, static_argnums=(2, 3))(
            jA, jB, bound, semiring)
        _eq(ovf, jovf)
        _eq(C.indptr, jC.indptr)
        _eq(C.cols, jC.cols)
        np.testing.assert_allclose(C.vals.numpy(), np.asarray(jC.vals),
                                   rtol=1e-6, atol=1e-6)
    C, ovf = ts.spgemm(tA, tB, 16)
    assert not bool(ovf)
    np.testing.assert_allclose(C.todense().numpy(),
                               tA.todense().numpy() @ tB.todense().numpy(),
                               atol=1e-5)


def _sym(edges, n):
    e = np.asarray(edges + [(b, a) for a, b in edges], np.int32)
    v = np.ones(len(e), np.float32)
    return _pair(e[:, 0], e[:, 1], v, n, n)


def _union_find(edges, n):
    parent = list(range(n))

    def root(a):
        while parent[a] != a:
            a = parent[a]
        return a
    for a, b in edges:
        ra, rb = root(a), root(b)
        parent[max(ra, rb)] = min(ra, rb)
    return np.asarray([root(i) for i in range(n)], np.int32)


@pytest.mark.parametrize("case", ["small", "chain", "random"])
def test_connected_components_match(case):
    if case == "small":
        n, edges = 7, [(0, 1), (1, 2), (2, 3), (4, 5)]   # 6 is isolated
    elif case == "chain":
        n, edges = 64, [(i, i + 1) for i in range(63)]
    else:
        n = 300
        rng = np.random.default_rng(14)
        edges = [(int(a), int(b)) for a, b in rng.integers(0, n, (250, 2))
                 if a != b]
    t, j = _sym(edges, n)
    L = tg.connected_components(t)
    _eq(L, jax.jit(jg.connected_components)(j))
    np.testing.assert_array_equal(L.numpy(), _union_find(edges, n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_color_is_proper(seed):
    n = 50
    rng = np.random.default_rng(15 + seed)
    edges = [(int(a), int(b)) for a, b in rng.integers(0, n, (150, 2))
             if a != b]
    t, j = _sym(edges, n)
    colors = tg.greedy_color(t, torch.Generator().manual_seed(seed))
    assert colors.dtype == torch.int32
    jc = np.asarray(jg.greedy_color(j, seed=seed))
    colors = colors.numpy()
    assert (colors >= 0).all() and (colors < 32).all()
    for a, b in edges:
        assert colors[a] != colors[b]
    # as many colours as JAX's within the degree bound of greedy schemes
    deg = np.bincount(np.asarray(edges).ravel(), minlength=n).max()
    assert colors.max() <= deg and jc.max() <= deg


def test_max_flow_matches():
    cases = [([0, 0, 1, 2], [1, 2, 3, 3], [3.0, 2.0, 2.0, 3.0], 4, 0, 3),
             ([0, 1], [1, 2], [5.0, 1.0], 3, 0, 2)]
    rng = np.random.default_rng(16)
    n = 16
    r = rng.integers(0, n, 60)
    c = rng.integers(0, n, 60)
    keep = r != c
    cases.append((r[keep], c[keep], rng.uniform(0.5, 4.0, keep.sum()), n,
                  0, n - 1))
    for r, c, cap, n, s, k in cases:
        t, j = _pair(np.asarray(r, np.int32), np.asarray(c, np.int32),
                     np.asarray(cap, np.float32), n, n)
        got = float(tg.max_flow(t, s, k))
        ref = float(jax.jit(jg.max_flow, static_argnums=(1, 2))(j, s, k))
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert abs(float(tg.max_flow(_pair(
        np.asarray([0, 0, 1, 2], np.int32), np.asarray([1, 2, 3, 3],
                                                      np.int32),
        np.asarray([3, 2, 2, 3], np.float32), 4, 4)[0], 0, 3)) - 4.0) < 1e-6


@pytest.mark.cuda
def test_sparse_and_graph_on_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel has no CPU mode")
    dev = torch.device("cuda")
    r, c, v = _coo(0, 5000, 5000, 60_000)
    A = ts.csr_from_coo(_t(r), _t(c), _t(v), 5000, 5000)
    G = ts.csr_from_coo(_t(r).to(dev), _t(c).to(dev), _t(v).to(dev), 5000,
                        5000)
    for f in ("indptr", "cols", "nnz"):
        assert torch.equal(getattr(G, f).cpu(), getattr(A, f))
    assert torch.allclose(G.vals.cpu(), A.vals, rtol=1e-6, atol=1e-6)
    x = torch.randn(5000)
    assert torch.allclose(ts.spmv(G, x.to(dev)).cpu(), ts.spmv(A, x),
                          rtol=1e-5, atol=1e-5)
    assert torch.equal(tg.connected_components(G).cpu(),
                       tg.connected_components(A))
    gc = tg.greedy_color(G, torch.Generator().manual_seed(0))
    assert torch.equal(gc.cpu(), tg.greedy_color(
        A, torch.Generator().manual_seed(0)))
