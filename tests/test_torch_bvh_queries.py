"""The port's LBVH query family (zpc_tpu_torch.containers.bvh: the nearest
and ray walks, the banded nearest query, every extraction and the compacted
decomposed join, BvttFront; containers.bvs) against zpc_tpu on the same
seeded numpy inputs, trees built by JAX and carried across by
``interop.lbvh_from_jax``, and against numpy brute force.

Tolerances: ids, counts, in-band flags, fronts and sweep candidates equal;
distances and ray parameters within rtol 1e-5 (tests/test_bvh.py:519);
where two primitives tie, either is accepted.  The plain banded join sorts
its queries stably in both packages, so its rows are compared row for row;
the decomposed join orders equal interval starts differently (JAX's sort
is unstable), so its rows are compared as sets per query.
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch import interop
from zpc_tpu_torch.containers import bvh as TB
from zpc_tpu_torch.containers import bvs as TS
from zpc_tpu_torch.math.rounding import sqrt_rn
from zpc_tpu_torch.parallel import primitives as TP

from _jax_jit import jit

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.containers import bvh as JB
    from zpc_tpu.containers import bvs as JS
except ImportError:
    pass

CPU = torch.device("cpu")
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@jit(static_argnames=("max_hits", "tile", "extract", "decompose", "cells",
                     "compact"))
def _jax_sorted(tree, qlo, qhi, max_hits, **kw):
    """JAX's banded join as one program (op by op it compiles each of its
    ops again for every shape)."""
    return JB.query_overlaps_sorted(tree, qlo, qhi, max_hits, **kw)


@jit(static_argnames=("complete",))
def _jax_build(lo, hi, valid=None, complete=False):
    kw = {} if valid is None else {"valid": valid}
    return (JB.build_lbvh_complete if complete else JB.build_lbvh)(lo, hi,
                                                                   **kw)


@jit(static_argnames=("tile",))
def _jax_nearest_sorted(tree, q, pts, tile):
    return JB.query_nearest_sorted(tree, q, pts, tile=tile)


def _random_boxes(rng, n, size=0.05):
    """tests/test_bvh.py's boxes."""
    c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32) * size
    return c - h, c + h


def _dist(p, q):
    """Euclidean distance with one fixed summation order and a square
    root rounded once: the card's equals the CPU's."""
    d = p - q
    return sqrt_rn((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                   + d[..., 2] * d[..., 2])


def _brute_sets(lo, hi, qlo, qhi, valid=None):
    ov = ((lo[None] <= qhi[:, None]).all(-1)
          & (qlo[:, None] <= hi[None]).all(-1))
    if valid is not None:
        ov &= valid[None]
    return [set(np.nonzero(r)[0].tolist()) for r in ov]


def _trees(lo, hi, complete=False, valid=None):
    """The JAX tree and the same tree carried to the port."""
    jt = _jax_build(jnp.asarray(lo), jnp.asarray(hi), None if valid is None
                    else jnp.asarray(valid), complete=complete)
    return jt, interop.lbvh_from_jax(jt, CPU)


# ------------------------------------------------------------ walks

def test_rank_any_matches_zpc_tpu():
    rng = np.random.default_rng(0)
    codes = np.sort(rng.integers(0, 1 << 30, 500)).astype(np.int32)
    codes[-20:] = 2 ** 31 - 1                       # invalid-leaf sentinel
    vals = np.concatenate([rng.integers(0, 1 << 30, 300), codes[:50],
                           [0, 2 ** 31 - 1]]).astype(np.int32)
    for side in ("left", "right"):
        want = np.asarray(JB._rank_any(jnp.asarray(codes), jnp.asarray(vals),
                                       side))
        got = TB._rank_any(_t(codes), _t(vals), side).numpy()
        np.testing.assert_array_equal(got, want)


def test_nearest_point_boxes():
    """tests/test_bvh.py's nearest query (box centres as primitives): ids
    equal to JAX's and to brute force, distances within rtol 1e-5."""
    rng = np.random.default_rng(42)
    lo, hi = _random_boxes(rng, 200)
    centers = 0.5 * (lo + hi)
    pts = rng.uniform(0, 1, (32, 3)).astype(np.float32)
    jt, tt = _trees(lo, hi)
    cj, ct = jnp.asarray(centers), _t(centers)
    jid, jd = jax.jit(lambda p: JB.query_nearest(
        jt, p, lambda i, q: jnp.linalg.norm(cj[i] - q)))(jnp.asarray(pts))
    tid, td = TB.query_nearest(tt, _t(pts),
                               lambda i, q: _dist(ct[i.long()], q))
    ref = np.linalg.norm(centers[None] - pts[:, None], axis=-1)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tid.numpy(), ref.argmin(1))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL)
    np.testing.assert_allclose(td.numpy(), ref.min(1), rtol=RTOL)


def test_nearest_max_iters_cap():
    """A cap below the tree's node count stops every walk at the same node
    in both packages (clustered points, where a cap mis-answers)."""
    rng = np.random.default_rng(3)
    n = 512
    cen = rng.uniform(0.2, 0.8, (6, 3))
    pts = (cen[rng.integers(0, 6, n)]
           + 0.03 * rng.standard_normal((n, 3))).astype(np.float32)
    h = np.full((n, 3), 1e-4, np.float32)
    jt, tt = _trees(pts - h, pts + h, complete=True)
    q = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    pj, pt = jnp.asarray(pts), _t(pts)
    for cap in (24, 96):
        jid, jd = JB.query_nearest(
            jt, jnp.asarray(q), lambda i, p: jnp.linalg.norm(p - pj[i]),
            max_iters=cap)
        tid, td = TB.query_nearest(
            tt, _t(q), lambda i, p: _dist(p, pt[i.long()]), max_iters=cap)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL)
        assert TB.LAST_WALK_STEPS <= cap


def _sphere_hit_np(o, d, c, r):
    oc = o - c
    b = (oc * d).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - r ** 2)
    t = -b - np.sqrt(np.maximum(disc, 0))
    return np.where((disc >= 0) & (t > 0), t, np.inf)


@pytest.mark.parametrize("t_max", [np.inf, 0.9])
def test_ray_vs_bruteforce_spheres(t_max):
    """tests/test_bvh.py's ray case (16 rays into 100 spheres), and the same
    rays cut at t_max = 0.9: ids equal to JAX's, t within rtol 1e-5 of
    JAX's and of brute force."""
    rng = np.random.default_rng(42)
    n = 100
    c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    r = np.full(n, 0.03, np.float32)
    jt, tt = _trees(c - r[:, None], c + r[:, None])
    cj, rj = jnp.asarray(c), jnp.asarray(r)
    ct, rt = _t(c), _t(r)

    def jhit(pid, o, d):
        oc = o - cj[pid]
        b = jnp.dot(oc, d)
        disc = b * b - (jnp.dot(oc, oc) - rj[pid] ** 2)
        t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
        return jnp.where((disc >= 0) & (t > 0), t, jnp.inf)

    def thit(pid, o, d):
        oc = o - ct[pid.long()]
        b = (oc * d).sum(-1)
        disc = b * b - ((oc * oc).sum(-1) - rt[pid.long()] ** 2)
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        return torch.where((disc >= 0) & (t > 0), t, float("inf"))

    o = np.tile(np.array([[0.5, 0.5, -1.0]], np.float32), (16, 1))
    d = rng.standard_normal((16, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jid, jts = jax.jit(lambda o, d: JB.query_ray(jt, o, d, jhit, t_max=t_max)
                       )(jnp.asarray(o), jnp.asarray(d))
    tid, tts = TB.query_ray(tt, _t(o), _t(d), thit, t_max=t_max)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tts.numpy(), np.asarray(jts), rtol=RTOL)
    for qi in range(16):
        t = _sphere_hit_np(o[qi], d[qi], c, r)
        if t.min() >= t_max:
            assert tid[qi] == -1 and tts[qi] == np.float32(t_max)
        else:
            assert abs(float(tts[qi]) - t.min()) < 1e-5
            assert int(tid[qi]) == int(t.argmin())


# ------------------------------------------------------------ BvttFront

def test_front_rebuild_and_refresh(monkeypatch):
    """tests/test_bvh.py's front: the pairs equal JAX's front slot for slot
    and the brute-force pair set; refresh keeps every pair under unchanged
    boxes and none after the queries move away.  The compaction's prefix
    sum goes through the scan (on the card, the scan kernel)."""
    rng = np.random.default_rng(42)
    n, nq = 200, 40
    lo, hi = _random_boxes(rng, n)
    qlo, qhi = _random_boxes(rng, nq, size=0.08)
    jt, tt = _trees(lo, hi)
    jf = JB.BvttFront.rebuild(jt, jnp.asarray(qlo), jnp.asarray(qhi),
                              max_hits_per_query=64, capacity=4096)
    seen = []
    inner = TP.scan

    def record(x, op="add", exclusive=False):
        seen.append(x.numel())
        return inner(x, op, exclusive)
    monkeypatch.setattr(TP, "scan", record)
    tf = TB.BvttFront.rebuild(tt, _t(qlo), _t(qhi), max_hits_per_query=64,
                              capacity=4096)
    assert seen == [nq * 64]
    np.testing.assert_array_equal(tf.qid.numpy(), np.asarray(jf.qid))
    np.testing.assert_array_equal(tf.pid.numpy(), np.asarray(jf.pid))
    assert int(tf.count) == int(jf.count)
    cnt = int(tf.count)
    ref = {(q, p) for q, s in enumerate(_brute_sets(lo, hi, qlo, qhi))
           for p in s}
    assert set(zip(tf.qid[:cnt].tolist(), tf.pid[:cnt].tolist())) == ref
    live = tf.refresh(_t(lo), _t(hi), _t(qlo), _t(qhi))
    assert int(live.sum()) == cnt
    np.testing.assert_array_equal(live.numpy(), np.asarray(jf.refresh(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(qlo),
        jnp.asarray(qhi))))
    assert int(tf.refresh(_t(lo), _t(hi), _t(qlo + 10),
                          _t(qhi + 10)).sum()) == 0
    # past its capacity the front keeps the first pairs in order
    small = TB.BvttFront.rebuild(tt, _t(qlo), _t(qhi), 64, capacity=32)
    assert int(small.count) == 32
    np.testing.assert_array_equal(small.qid.numpy(), tf.qid[:32].numpy())
    np.testing.assert_array_equal(small.pid.numpy(), tf.pid[:32].numpy())
    back = interop.bvtt_front_from_jax(jf, CPU)
    assert all(torch.equal(getattr(back, k), getattr(tf, k))
               for k in ("qid", "pid", "count"))


# ------------------------------------------------------------ Bvs

@pytest.mark.parametrize("masked", [False, True])
def test_bvs_matches_zpc_tpu_and_bruteforce(masked):
    """tests/test_bvh.py's TestBvs (300 boxes, 50 queries; and with the
    last 30 of 100 boxes invalid, one query over everything): the sweep
    structure field for field and the candidates equal JAX's, the hit sets
    equal brute force."""
    rng = np.random.default_rng(42)
    if masked:
        lo, hi = _random_boxes(rng, 100)
        valid = np.arange(100) < 70
        qlo = np.full((1, 3), -1.0, np.float32)
        qhi = np.full((1, 3), 2.0, np.float32)
        mc = 128
    else:
        lo, hi = _random_boxes(rng, 300)
        valid = None
        qlo, qhi = _random_boxes(rng, 50, size=0.1)
        mc = 300
    kw_j = {} if valid is None else {"valid": jnp.asarray(valid)}
    kw_t = {} if valid is None else {"valid": _t(valid)}
    jb = JS.build_bvs(jnp.asarray(lo), jnp.asarray(hi), **kw_j)
    tb = TS.build_bvs(_t(lo), _t(hi), **kw_t)
    for k in ("lo", "hi", "prim", "max_extent"):
        np.testing.assert_array_equal(_np(getattr(tb, k)),
                                      np.asarray(getattr(jb, k)))
    carried = interop.bvs_from_jax(jb, CPU)
    assert torch.equal(carried.prim, tb.prim) and carried.axis == tb.axis
    jid, jm = JS.bvs_query(jb, jnp.asarray(qlo), jnp.asarray(qhi), mc)
    tid, tm = TS.bvs_query(tb, _t(qlo), _t(qhi), mc)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    ref = _brute_sets(lo, hi, qlo, qhi, valid)
    assert [set(r[m].tolist()) for r, m in zip(tid.numpy(), tm.numpy())] \
        == ref
    assert (TS.bvs_candidates(tb, _t(qlo), _t(qhi)) <= mc).all()


def test_bvs_candidates():
    """The sweep-range counts equal numpy's searchsorted; with the window
    at their median, the queries past it lose hits and the others none."""
    rng = np.random.default_rng(5)
    lo, hi = _random_boxes(rng, 300)
    qlo, qhi = _random_boxes(rng, 50, size=0.1)
    tb = TS.build_bvs(_t(lo), _t(hi))
    keys = tb.lo[:, 0].numpy()
    span = (np.searchsorted(keys, qhi[:, 0], "right")
            - np.searchsorted(keys, qlo[:, 0] - tb.max_extent.numpy()))
    got = TS.bvs_candidates(tb, _t(qlo), _t(qhi)).numpy()
    np.testing.assert_array_equal(got, span)
    mc = int(np.median(span))
    _, fm = TS.bvs_query(tb, _t(qlo), _t(qhi), 300)
    _, cm = TS.bvs_query(tb, _t(qlo), _t(qhi), mc)
    lost = fm.sum(1).numpy() != cm.sum(1).numpy()
    assert lost.any() and not (lost & (got <= mc)).any()


# ------------------------------------------------------------ extractions

@pytest.fixture(scope="module")
def join_scene():
    """tests/test_bvh.py's TestExtractVariants scene: 1,024 boxes of
    half-width 0.01, the first 512 grown by 0.02 as queries."""
    rng = np.random.default_rng(42)
    n = 1024
    c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = np.full((n, 3), 0.01, np.float32)
    lo, hi = c - h, c + h
    jt, tt = _trees(lo, hi)
    return dict(lo=lo, hi=hi, qlo=lo[:512] - 0.02, qhi=hi[:512] + 0.02,
                jt=jt, tt=tt)


def _per_query(out, nq):
    """Counts, in-band flags and hit sets per query of entry rows; a query
    with no row (its cells cut by an overflowing ``compact`` budget) is
    out of band."""
    qid, hits, cnt, band = (_np(o) for o in out)
    cnt_q = np.zeros(nq, np.int64)
    band_q = np.ones(nq, bool)
    rows = np.zeros(nq, bool)
    sets = [set() for _ in range(nq)]
    for row in range(len(qid)):
        q = int(qid[row])
        cnt_q[q] += cnt[row]
        band_q[q] &= bool(band[row])
        rows[q] = True
        sets[q].update(int(p) for p in hits[row] if p >= 0)
    return cnt_q, band_q & rows, sets


def _same_where_certified(got, want, nq, sets_too=True):
    """Decomposed joins per query: where both packages certify a query in
    band its count and hit set agree; the port's in-band fraction is at
    most 0.005 below JAX's (tests/test_torch_bvh.py's rule: the two order
    equal interval starts differently, so out-of-band counts may differ).
    Returns the port's per-query (counts, in_band, sets)."""
    ct, bt, st = _per_query(got, nq)
    cj, bj, sj = _per_query(want, nq)
    both = bt & bj
    np.testing.assert_array_equal(ct[both], cj[both])
    if sets_too:
        assert [a for a, k in zip(st, both) if k] == \
            [a for a, k in zip(sj, both) if k]
    assert bt.mean() >= bj.mean() - 0.005
    return ct, bt, st


@pytest.mark.parametrize("mode", ["plain", "c8"])
@pytest.mark.parametrize("extract", list(TB.EXTRACTS))
def test_extract_matches_zpc_tpu_variant(join_scene, extract, mode):
    """Each extraction against JAX's own variant of it: the plain join row
    for row (qid, hits, counts, in_band); the decomposed join per query
    where both certify it, and against brute force wherever the port
    does (``none`` has no hits)."""
    s = join_scene
    kw = dict(tile=64, extract=extract)
    if mode != "plain":
        kw.update(decompose=True, cells=int(mode[1]))
    j = _jax_sorted(s["jt"], jnp.asarray(s["qlo"]), jnp.asarray(s["qhi"]),
                    32, **kw)
    t = TB.query_overlaps_sorted(s["tt"], _t(s["qlo"]), _t(s["qhi"]), 32,
                                 **kw)
    if mode == "plain":
        for a, b in zip(t, j):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    else:
        ct, bt, st = _same_where_certified(t, j, 512)
        ref = _brute_sets(s["lo"], s["hi"], s["qlo"], s["qhi"])
        np.testing.assert_array_equal(ct[bt], [len(r) for r, k in
                                               zip(ref, bt) if k])
        if extract != "none":
            assert [a for a, k in zip(st, bt) if k] == \
                [r for r, k in zip(ref, bt) if k]
    if extract == "none":
        assert (t[1] == -1).all()


@pytest.mark.parametrize("case", ["bitpeel_unaligned", "peel_wide_tile"])
def test_extract_window_edges(case):
    """tests/test_bvh.py's two window-edge cases: bit-packed peel over a
    window that is no multiple of 32 lanes (complete tree of 1,000, tile
    32: 189 lanes) and peel over a 3,072-lane window (2,048 boxes, tile
    256), each equal to JAX's top-k and to the port's top-k."""
    rng = np.random.default_rng(42)
    n, half, tile, ex = ((1000, 0.015, 32, "bitpeel")
                         if case == "bitpeel_unaligned"
                         else (2048, 0.01, 256, "peel"))
    c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = np.full((n, 3), half, np.float32)
    jt, tt = _trees(c - h, c + h, complete=case == "bitpeel_unaligned")
    qlo, qhi = c[:512] - h[:512] - 0.02, c[:512] + h[:512] + 0.02
    j = _jax_sorted(jt, jnp.asarray(qlo), jnp.asarray(qhi), 32, tile=tile,
                    extract=ex)
    for e in (ex, "topk"):
        t = TB.query_overlaps_sorted(tt, _t(qlo), _t(qhi), 32, tile=tile,
                                     extract=e)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compact_matches_zpc_tpu(join_scene):
    """The decomposed c8 join with a live-entry budget (the live cells
    rounded up to the tile): per query equal to JAX's compacted join where
    both certify it, and to the port's uncompacted join wherever it is not
    flagged.  A budget below the live cells flags every row in both
    packages, and the queries whose cells it cut have no row at all."""
    s = join_scene
    args_j = (s["jt"], jnp.asarray(s["qlo"]), jnp.asarray(s["qhi"]), 32)
    args_t = (s["tt"], _t(s["qlo"]), _t(s["qhi"]), 32)
    kw = dict(tile=64, decompose=True, cells=8)
    live = int(TB._decompose(s["tt"], _t(s["qlo"]), _t(s["qhi"]), 8)[2]
               .sum())
    budget = -(-live // 64) * 64
    assert budget < 512 * 8
    j = _jax_sorted(*args_j, compact=budget, **kw)
    t = TB.query_overlaps_sorted(*args_t, compact=budget, **kw)
    assert t[0].shape[0] == budget
    ct, bt, st = _same_where_certified(t, j, 512)
    cu, bu, su = _per_query(TB.query_overlaps_sorted(*args_t, **kw), 512)
    ok = bt & bu
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(ct[ok], cu[ok])
    assert [a for a, k in zip(st, ok) if k] == \
        [a for a, k in zip(su, ok) if k]
    jo = _jax_sorted(*args_j, compact=budget - 64, **kw)
    to = TB.query_overlaps_sorted(*args_t, compact=budget - 64, **kw)
    assert not np.asarray(jo[3]).any() and not to[3].any()
    assert torch.unique(to[0]).numel() < 512


# ------------------------------------------------------------ banded nearest

def test_nearest_sorted_certified_exact():
    """tests/test_bvh.py's banded nearest case (4,096 points, 1,024 queries,
    tile 64): qid, in-band flags and primitives equal JAX's, d2 within rtol
    1e-5; every in-band answer equals brute force; no answer beats the
    truth."""
    rng = np.random.default_rng(42)
    n = 4096
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = np.full((n, 3), 1e-4, np.float32)
    jt, tt = _trees(pts - h, pts + h, complete=True)
    q = rng.uniform(0.1, 0.9, (1024, 3)).astype(np.float32)
    jout = _jax_nearest_sorted(jt, jnp.asarray(q), jnp.asarray(pts), 64)
    qid, prim, d2, ok = TB.query_nearest_sorted(tt, _t(q), _t(pts), tile=64)
    np.testing.assert_array_equal(qid.numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jout[3]))
    np.testing.assert_array_equal(prim.numpy(), np.asarray(jout[1]))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jout[2]), rtol=RTOL)
    qn = q[qid.numpy()]
    dd = ((qn[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    okn, pn, dn = ok.numpy(), prim.numpy(), d2.numpy()
    assert okn.mean() > 0.5
    assert (pn[okn] == dd.argmin(1)[okn]).all()
    np.testing.assert_allclose(dn[okn], dd.min(1)[okn], rtol=RTOL, atol=1e-9)
    assert (dn >= dd.min(1) - 1e-6).all()


def test_nearest_sorted_fallback_completes():
    """tests/test_bvh.py's usage pattern on clustered points: the banded
    answer where certified, the walk (query_nearest) on the rest, equals
    the brute-force nearest everywhere."""
    rng = np.random.default_rng(42)
    n = 2048
    cen = rng.uniform(0.2, 0.8, (8, 3))
    pts = (cen[rng.integers(0, 8, n)]
           + 0.02 * rng.standard_normal((n, 3))).astype(np.float32)
    h = np.full((n, 3), 1e-4, np.float32)
    _, tt = _trees(pts - h, pts + h, complete=True)
    q = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    pt = _t(pts)
    qid, prim, _, ok = TB.query_nearest_sorted(tt, _t(q), pt, tile=32)
    assert 0 < int(ok.sum()) < 512
    qs = _t(q)[qid.long()]
    rest = torch.nonzero(~ok).flatten()
    ids, _ = TB.query_nearest(tt, qs[rest],
                              lambda i, p: _dist(p, pt[i.long()]))
    prim = prim.clone()
    prim[rest] = ids
    dd = ((qs.numpy()[:, None, :] - pts[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(prim.numpy(), dd.argmin(1))


# ------------------------------------------------------------ the card

@pytest.mark.cuda
def test_card_against_cpu():
    """chip_smoke phase 32 at a small size: every extraction plain and c8,
    the compacted join, the banded nearest query, the walks and the front
    on the card equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from zpc_tpu_torch import scenes
    out = []
    for dev in (CPU, torch.device("cuda")):
        lo, hi, c = scenes.lbvh_boxes(8192, dev)
        b = TB.build_lbvh(lo, hi)
        r = [TB.query_overlaps_sorted(b, c, c, 16, tile=256, group=32,
                                      extract=e, decompose=d, cells=8,
                                      uniform_extent=0.006)
             for e in TB.EXTRACTS for d in (False, True)]
        r.append(TB.query_overlaps_sorted(
            b, c, c, 16, tile=256, group=32, decompose=True, cells=8,
            compact=int(0.4 * 8192 * 8) // 256 * 256, uniform_extent=0.006))
        r.append(TB.query_nearest_sorted(b, c + 0.001, c, tile=256,
                                         group=32))
        r.append(TB.query_nearest(b, c[:512] + 0.001,
                                  lambda i, p: _dist(p, c[i.long()])))
        f = TB.BvttFront.rebuild(b, lo[:1024], hi[:1024], 16, 1 << 14)
        r.append((f.qid, f.pid, f.count))
        out.append([[x.cpu() for x in t] for t in r])
    for a, b in zip(*out):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
