"""The port's LBVH broad phase (zpc_tpu_torch.math.bits, ops.nse,
containers.bvh) against zpc_tpu's on the same seeded numpy inputs.

Bits, NSE sweeps and trees must be exact: integers integer for integer,
and node boxes bit for bit (they are mins and maxes of the same floats).
The JAX NSE kernel runs in interpret mode on the CPU, as tests/test_bvh.py
runs it.  Queries are held to JAX and to a numpy brute force: counts and
in-band flags exactly, hit lists as sets.  The decomposed join sorts its
entries unstably in JAX, so ties may land in other tiles there; the port
puts empty entries first among ties, which keeps more queries in band.
Queries that both packages certify in band must agree exactly, and the
port's in-band fraction may fall at most 0.005 below JAX's.
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch import _kernels, interop, scenes
from zpc_tpu_torch.containers import bvh as tbvh
from zpc_tpu_torch.math import bits as tbits
from zpc_tpu_torch.ops import nse as tnse

# zpc_tpu (and so JAX) is imported inside the tests that compare against
# it, so the GPU test below also runs where JAX is not installed
NONE = -(1 << 30)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_boxes(rng, n, size=0.05):
    """tests/test_bvh.py's boxes."""
    c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32) * size
    return c - h, c + h


# ---------------------------------------------------------------- bits

def _bit_inputs(seed):
    rng = np.random.default_rng(seed)
    edge = np.asarray([0, 1, 2, 3, 1023, 1024, 65535, 2 ** 30, 2 ** 31 - 1,
                       -1, -2 ** 31, -2 ** 31 + 1], np.int64)
    rand = rng.integers(-2 ** 31, 2 ** 31, 500)
    return np.concatenate([edge, rand]).astype(np.int32)


@pytest.mark.parametrize("name", ["clz32", "next_pow2", "expand_bits_3d"])
def test_bits_unary_match_zpc_tpu(name):
    import jax.numpy as jnp
    from zpc_tpu.math import bits as jbits

    x = _bit_inputs(1)
    want = np.asarray(getattr(jbits, name)(jnp.asarray(x))).astype(np.int64)
    got = getattr(tbits, name)(_t(x)).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_clz32_edges():
    x = np.asarray([0, 1, 2 ** 31 - 1, -2 ** 31, -1], np.int32)
    np.testing.assert_array_equal(tbits.clz32(_t(x)).numpy(),
                                  [32, 31, 1, 0, 0])


def test_morton_and_prefix_match_zpc_tpu():
    import jax.numpy as jnp
    from zpc_tpu.math import bits as jbits

    rng = np.random.default_rng(2)
    q3 = rng.integers(0, 1024, (400, 3)).astype(np.int32)
    q3[:3] = [[0, 0, 0], [1023, 1023, 1023], [1023, 0, 512]]
    q2 = rng.integers(0, 65536, (400, 2)).astype(np.int32)
    q2[:2] = [[65535, 65535], [0, 65535]]
    for fn, q in (("morton3d", q3), ("morton2d", q2)):
        want = np.asarray(getattr(jbits, fn)(jnp.asarray(q)))
        got = getattr(tbits, fn)(_t(q)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    a, b = _bit_inputs(3), _bit_inputs(4)
    b[:6] = a[:6]                                  # equal keys: cpl 32
    np.testing.assert_array_equal(
        tbits.common_prefix_length(_t(a), _t(b)).numpy(),
        np.asarray(jbits.common_prefix_length(jnp.asarray(a),
                                              jnp.asarray(b))))


# ---------------------------------------------------------------- NSE

def _brute_nse(d, strict):
    """Nearest j < i with d[j] <= d[i] (strict: <), packed, by a stack."""
    out = np.full(len(d), NONE, np.int64)
    stack = []
    for i, v in enumerate(d):
        # pop what can never answer i or anything after it
        while stack and not ((d[stack[-1]] < v) if strict
                             else (d[stack[-1]] <= v)):
            stack.pop()
        if stack:
            out[i] = (stack[-1] << 6) | d[stack[-1]]
        stack.append(i)
    return out


def _pattern(name, g, seed=0):
    i = np.arange(g)
    if name == "random":
        return np.random.default_rng(seed + g).integers(1, 64, g)
    if name == "equal":
        return np.full(g, 17)
    if name == "increasing":
        return i % 63 + 1
    if name == "decreasing":
        return 63 - i % 63
    if name == "ones":
        return np.ones(g)
    return np.where(i % 2 == 0, 1, 63)               # alternating 1s, 63s


PATTERNS = ["random", "equal", "increasing", "decreasing", "ones",
            "alternating"]


@pytest.mark.parametrize("strict", [False, True])
def test_nse_plain_matches_chunked_sweep(strict):
    import jax.numpy as jnp
    from zpc_tpu.containers.bvh import _nse_dir_chunked

    d = np.random.default_rng(3).integers(1, 64, 3000).astype(np.int32)
    want = np.asarray(_nse_dir_chunked(jnp.asarray(d), strict, chunk=512))
    np.testing.assert_array_equal(tnse.nse(_t(d), strict).numpy(), want)


@pytest.mark.parametrize("strict", [False, True])
def test_nse_plain_matches_nse_pallas(strict):
    import jax.numpy as jnp
    from zpc_tpu.ops.nse_pallas import CHUNK, nse_pallas

    d = np.random.default_rng(5).integers(1, 64, 2 * CHUNK + 1234).astype(
        np.int32)
    want = np.asarray(nse_pallas(jnp.asarray(d), strict=strict,
                                 interpret=True))
    np.testing.assert_array_equal(tnse.nse(_t(d), strict).numpy(), want)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("g", [1, 2, 63, 1000])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_nse_plain_matches_bruteforce(pattern, g, strict):
    d = _pattern(pattern, g).astype(np.int32)
    got = tnse.nse(_t(d), strict).numpy()
    np.testing.assert_array_equal(got, _brute_nse(d, strict))
    if strict and pattern == "ones":
        assert (got == NONE).all()                   # w = 0: nothing below


@pytest.mark.parametrize("strict", [False, True])
def test_nse_plain_values_outside_never_answer(strict):
    """Values outside [0, 63] are never an answer and get NONE (64 too,
    whose strict w = 63 would otherwise find one)."""
    d = _pattern("random", 3000).astype(np.int32)
    d[::7] = 64
    d[3::11] = -5
    d[5::13] = 0
    d[6::17] = 100
    inside = (d >= 0) & (d <= 63)
    want = _brute_nse(np.where(inside, d, 1 << 20), strict)
    want[~inside] = NONE
    np.testing.assert_array_equal(tnse.nse(_t(d), strict).numpy(), want)


def test_nse_rejects_bad_input():
    with pytest.raises(TypeError):
        tnse.nse(torch.ones(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        tnse.nse(torch.ones((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        tnse.nse(torch.ones(0, dtype=torch.int32))
    with pytest.raises(ValueError):
        tnse.nse(torch.ones(1 << 24, dtype=torch.int32))


def test_nse_plain_version_does_not_count_launches():
    before = tnse.LAUNCHES
    tnse.nse(torch.ones(10, dtype=torch.int32))
    assert tnse.LAUNCHES == before


def test_nse_cpu_needs_no_kernel_library(monkeypatch):
    """A CPU tensor takes the plain version and never loads the library."""
    def no_library():
        raise AssertionError("the CPU path loaded the kernel library")
    monkeypatch.setattr(tnse, "_library", no_library)
    d = _pattern("random", 9000)
    for strict in (False, True):
        np.testing.assert_array_equal(
            tnse.nse(_t(d.astype(np.int32)), strict).numpy(),
            _brute_nse(d, strict))


def _nse_cuda_check(got, x, strict):
    np.testing.assert_array_equal(
        got.cpu().numpy(), tnse.nse_reference(x.cpu(), strict).numpy())


@pytest.mark.cuda
def test_nse_kernel_matches_plain_on_cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the NSE kernel has no CPU mode")
    kern = tnse.build()
    tile = kern.tile
    cases = [_pattern(p, g) for p in PATTERNS for g in (1, 2, 63, 1000)]
    # one tile, one tile plus one, an exact multiple, many tiles
    cases += [_pattern("random", g) for g in (511, 512, 513, tile, tile + 1,
                                              3 * tile, 4096 + 1234, 65_535,
                                              1_048_575, (1 << 24) - 1)]
    cases += [_pattern(p, 5 * tile + 17) for p in PATTERNS]
    for d in cases:
        x = _t(d.astype(np.int32))
        for strict in (False, True):
            before = tnse.LAUNCHES
            got = tnse.nse(x.cuda(), strict)
            torch.cuda.synchronize()
            assert tnse.LAUNCHES == before + 1
            _nse_cuda_check(got, x, strict)
    # values outside [0, 63] never answer and get NONE
    d = _pattern("random", 3 * tile + 5).astype(np.int32)
    d[::7] = 64
    d[3::11] = -5
    d[5::13] = 0
    d[6::17] = 100
    for strict in (False, True):
        _nse_cuda_check(tnse.nse(_t(d).cuda(), strict), _t(d), strict)
    # back to back with no sync, same and growing sizes
    xs = [_t(_pattern("random", g, seed=k).astype(np.int32)).cuda()
          for k, g in enumerate((50_000, 50_000, 200_000, 1_048_575, 9_000))]
    outs = [tnse.nse(x, k % 2 == 1) for k, x in enumerate(xs)]
    for k, (x, got) in enumerate(zip(xs, outs)):
        _nse_cuda_check(got, x, k % 2 == 1)
    # views at 1, 2 and 3 elements: not 16-byte aligned
    base = _t(_pattern("random", 100_008, seed=3).astype(np.int32)).cuda()
    for off in (1, 2, 3):
        x = base[off:off + 100_005]
        assert x.data_ptr() % 16 != 0
        _nse_cuda_check(tnse.nse(x, off == 2), x, off == 2)
    # two streams at once
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    x1 = _t(_pattern("random", 600_001, seed=7).astype(np.int32)).cuda()
    x2 = _t(_pattern("random", 700_003, seed=8).astype(np.int32)).cuda()
    s1.wait_stream(torch.cuda.current_stream())
    s2.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        g1 = tnse.nse(x1)
    with torch.cuda.stream(s2):
        g2 = tnse.nse(x2, True)
    torch.cuda.synchronize()
    _nse_cuda_check(g1, x1, False)
    _nse_cuda_check(g2, x2, True)
    # across the epoch's wrap: a workspace that starts 2 below it, full of
    # stale statuses of epochs 0-2; two small calls, the second of which
    # wraps the epoch and must zero them, then three large ones that would
    # read any it left as predecessors
    monkeypatch.setattr(tnse, "WORKSPACE", _kernels.Workspace(
        epoch=_kernels.EPOCH_LIMIT - 2, stale=True))
    sizes = (3 * tile, 2 * tile + 1, 300_000, 300_000 - 999, 250_000)
    xs = [_t(_pattern("random", g, seed=k).astype(np.int32)).cuda()
          for k, g in enumerate(sizes)]
    stream = torch.cuda.current_stream().cuda_stream
    ws = tnse.WORKSPACE.get(xs[0].device, stream,
                            kern.status_words(max(sizes)))
    assert ws[_kernels.HEADER_WORDS:].any()
    for k, x in enumerate(xs):
        _nse_cuda_check(tnse.nse(x, k % 2 == 0), x, k % 2 == 0)
        if k == 1:
            assert _kernels.Workspace.header(ws) == (0, 0, 0)
            assert not ws[_kernels.HEADER_WORDS:].any()
    assert tnse.WORKSPACE.get(xs[0].device, stream, 1) is ws
    assert _kernels.Workspace.header(ws) == (0, 0, 3)


# ---------------------------------------------------------------- build

def _assert_tree_equal(got, want):
    g, w = interop.lbvh_to_numpy(got), interop.lbvh_to_numpy(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _both_builds(fn_name, lo, hi, valid=None):
    import jax
    import jax.numpy as jnp
    from zpc_tpu.containers import bvh as jbvh

    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else _t(valid)
    want = jax.jit(getattr(jbvh, fn_name))(jnp.asarray(lo), jnp.asarray(hi),
                                           jv)
    got = getattr(tbvh, fn_name)(_t(lo), _t(hi), tv)
    return got, want


# n < 1025 puts the JAX side on its 126-scan loop, the port on its NSE
@pytest.mark.parametrize("n", [1, 2, 7, 64, 500, 1023, 1025, 5000])
def test_build_lbvh_matches_zpc_tpu(n):
    lo, hi = _random_boxes(np.random.default_rng(n), n)
    got, want = _both_builds("build_lbvh", lo, hi)
    _assert_tree_equal(got, want)
    prim = got.leaf_prim.numpy()
    assert sorted(prim[prim >= 0].tolist()) == list(range(n))


def test_build_lbvh_duplicate_positions():
    lo = np.zeros((32, 3), np.float32)
    hi = np.ones((32, 3), np.float32) * 0.1
    got, want = _both_builds("build_lbvh", lo, hi)
    _assert_tree_equal(got, want)


@pytest.mark.parametrize("fn_name", ["build_lbvh", "build_lbvh_complete"])
def test_build_with_valid_mask(fn_name):
    rng = np.random.default_rng(9)
    lo, hi = _random_boxes(rng, 1500)
    valid = rng.uniform(size=1500) > 1 / 3
    got, want = _both_builds(fn_name, lo, hi, valid)
    _assert_tree_equal(got, want)
    assert int(got.count) == int(valid.sum())


@pytest.mark.parametrize("n", [1, 2, 500, 1024, 1025])
def test_build_lbvh_complete_matches_zpc_tpu(n):
    lo, hi = _random_boxes(np.random.default_rng(n + 1), n)
    got, want = _both_builds("build_lbvh_complete", lo, hi)
    _assert_tree_equal(got, want)


def test_interop_round_trip():
    import jax
    import jax.numpy as jnp
    from zpc_tpu.containers import bvh as jbvh

    lo, hi = _random_boxes(np.random.default_rng(4), 1500)
    jt = jax.jit(jbvh.build_lbvh)(jnp.asarray(lo), jnp.asarray(hi))
    tt = interop.lbvh_from_jax(jt, CPU)
    assert isinstance(tt, tbvh.LBvh) and tt.num_leaves == 1500
    _assert_tree_equal(tt, jt)


@pytest.mark.cuda
def test_build_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the NSE kernel has no CPU mode")
    lo, hi, _ = scenes.lbvh_boxes(70_000, CPU)
    want = tbvh.build_lbvh(lo, hi)
    before = tnse.LAUNCHES
    got = tbvh.build_lbvh(lo.cuda(), hi.cuda())
    torch.cuda.synchronize()
    assert tnse.LAUNCHES == before + 2
    _assert_tree_equal(got, want)


def test_lbvh_boxes_is_bench_scene():
    lo, hi, c = scenes.lbvh_boxes(1000, CPU)
    rc = np.random.default_rng(0).uniform(0, 1, (1000, 3)).astype(np.float32)
    np.testing.assert_array_equal(c.numpy(), rc)
    np.testing.assert_array_equal(lo.numpy(), rc - np.float32(0.002))
    np.testing.assert_array_equal(hi.numpy(), rc + np.float32(0.002))


# ---------------------------------------------------------------- queries

@pytest.fixture(scope="module")
def scene():
    """A 2,000-box tree built by JAX, carried to the port, and 512 query
    boxes: centres of the first 512 boxes +- 0.02."""
    import jax
    import jax.numpy as jnp
    from zpc_tpu.containers import bvh as jbvh

    rng = np.random.default_rng(1)
    c = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
    h = np.full((2000, 3), 0.01, np.float32)
    lo, hi = c - h, c + h
    jt = jax.jit(jbvh.build_lbvh)(jnp.asarray(lo), jnp.asarray(hi))
    return dict(jt=jt, tt=interop.lbvh_from_jax(jt, CPU), lo=lo, hi=hi,
                c=c[:512], qlo=c[:512] - 0.02, qhi=c[:512] + 0.02)


def _brute(lo, hi, qlo, qhi):
    return [set(np.nonzero((lo <= qhi[i]).all(1)
                           & (qlo[i] <= hi).all(1))[0].tolist())
            for i in range(len(qlo))]


def test_query_overlaps_matches_zpc_tpu(scene):
    import jax.numpy as jnp
    from zpc_tpu.containers import bvh as jbvh

    qlo, qhi = scene["qlo"], scene["qhi"]
    jh, jc = jbvh.query_overlaps(scene["jt"], jnp.asarray(qlo),
                                 jnp.asarray(qhi), 16)
    valid = np.arange(len(qlo)) % 5 != 0
    th, tc = tbvh.query_overlaps(scene["tt"], _t(qlo), _t(qhi), 16)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    steps = tbvh.LAST_WALK_STEPS
    assert steps % tbvh.CHECK_EVERY == 0 and steps > 0
    ref = _brute(scene["lo"], scene["hi"], qlo, qhi)
    assert [len(r) for r in ref] == tc.tolist()
    # masked queries find nothing; the others are unchanged
    vh, vc = tbvh.query_overlaps(scene["tt"], _t(qlo), _t(qhi), 16,
                                 valid=_t(valid))
    np.testing.assert_array_equal(vc.numpy(), np.where(valid, tc, 0))
    np.testing.assert_array_equal(vh.numpy()[valid], th.numpy()[valid])
    assert (vh.numpy()[~valid] == -1).all()


def _hit_sets(qid, hits, nq):
    sets = [set() for _ in range(nq)]
    for q, row in zip(np.asarray(qid), np.asarray(hits)):
        if q < nq:
            sets[q] |= set(row[row >= 0].tolist())
    return sets


def test_query_sorted_plain_band_matches_zpc_tpu(scene):
    import jax
    import jax.numpy as jnp
    from zpc_tpu.containers import bvh as jbvh

    qlo, qhi = scene["qlo"], scene["qhi"]
    want = jax.jit(lambda b, x, y: jbvh.query_overlaps_sorted(
        b, x, y, 16, tile=64))(scene["jt"], jnp.asarray(qlo),
                               jnp.asarray(qhi))
    got = tbvh.query_overlaps_sorted(scene["tt"], _t(qlo), _t(qhi), 16,
                                     tile=64)
    for name, i in (("qid", 0), ("counts", 2), ("in_band", 3)):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=name)
    gs = [set(r[r >= 0].tolist()) for r in got[1].numpy()]
    ws = [set(r[r >= 0].tolist()) for r in np.asarray(want[1])]
    assert gs == ws
    # certified rows are the brute-force answer
    ref = _brute(scene["lo"], scene["hi"], qlo, qhi)
    for q, band, cnt, s in zip(got[0].tolist(), got[3].tolist(),
                               got[2].tolist(), gs):
        if band:
            assert cnt == len(ref[q]) and (cnt > 16 or s == ref[q])


def _combine(qid, hits, cnt, band, nq):
    qid, cnt, band = (np.asarray(a) for a in (qid, cnt, band))
    counts = np.zeros(nq, np.int64)
    np.add.at(counts, qid, cnt)
    in_band = np.ones(nq, bool)
    np.logical_and.at(in_band, qid, band)
    return counts, in_band, _hit_sets(qid, hits, nq)


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("cells", [8, 4, 2])
def test_query_sorted_decomposed_matches_zpc_tpu(scene, cells, uniform):
    import jax
    import jax.numpy as jnp
    from zpc_tpu.containers import bvh as jbvh

    nq = 512
    if uniform:
        ja = (jnp.asarray(scene["c"]),) * 2
        ta = (_t(scene["c"]),) * 2
        ext = 0.02
    else:
        ja = (jnp.asarray(scene["qlo"]), jnp.asarray(scene["qhi"]))
        ta = (_t(scene["qlo"]), _t(scene["qhi"]))
        ext = None
    kw = dict(tile=64, decompose=True, cells=cells, uniform_extent=ext)
    want = jax.jit(lambda b, x, y: jbvh.query_overlaps_sorted(
        b, x, y, 16, **kw))(scene["jt"], *ja)
    got = tbvh.query_overlaps_sorted(scene["tt"], *ta, 16, **kw)
    wc, wb, ws = _combine(*want, nq)
    gc, gb, gs = _combine(*(a.numpy() for a in got), nq)
    both = wb & gb
    assert gb.mean() >= wb.mean() - 0.005
    np.testing.assert_array_equal(gc[both], wc[both])
    ref = _brute(scene["lo"], scene["hi"], scene["qlo"], scene["qhi"])
    for q in np.nonzero(both)[0]:
        assert gs[q] == ws[q], q
        assert gc[q] == len(ref[q]) and (gc[q] > 16 or gs[q] == ref[q]), q
    # extract="none" gives the same counts and flags, and no hits
    none = tbvh.query_overlaps_sorted(scene["tt"], *ta, 16, extract="none",
                                      **kw)
    for a, b in ((none[0], got[0]), (none[2], got[2]), (none[3], got[3])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (none[1].numpy() == -1).all()


def test_query_sorted_rejects_bad_options(scene):
    c = _t(scene["c"])
    with pytest.raises(ValueError):
        tbvh.query_overlaps_sorted(scene["tt"], c, c, 16, tile=64,
                                   decompose=True, cells=3)
    with pytest.raises(ValueError):
        tbvh.query_overlaps_sorted(scene["tt"], c, c, 16, tile=100)
    with pytest.raises(ValueError):
        tbvh.query_overlaps_sorted(scene["tt"], c, c, 16, tile=64,
                                   extract="sort")
    with pytest.raises(ValueError):
        tbvh.query_overlaps_sorted(scene["tt"], c, c, 16, tile=64,
                                   compact=64)
    with pytest.raises(ValueError):
        tbvh.query_overlaps_sorted(scene["tt"], c, c, 16, tile=64,
                                   decompose=True, compact=96)


def test_query_exact_every_query_including_residue():
    """tests/test_bvh.py's exact-query case, on the port, against brute
    force and against JAX."""
    import jax
    import jax.numpy as jnp
    from zpc_tpu.containers import bvh as jbvh

    rng = np.random.default_rng(42)
    n = 4096
    c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = np.full((n, 3), 0.002, np.float32)
    lo, hi = c - h, c + h
    nq = 700                               # deliberate non-tile-multiple
    qlo = (c[:nq] - 0.004).copy()
    qhi = (c[:nq] + 0.004).copy()
    for i in (0, 13, 250):                 # pathological: whole scene
        qlo[i] = -0.1
        qhi[i] = 1.1
    max_hits = 64
    kw = dict(tile=64, residue_budget=64)
    jt = jax.jit(jbvh.build_lbvh)(jnp.asarray(lo), jnp.asarray(hi))
    tt = tbvh.build_lbvh(_t(lo), _t(hi))
    _assert_tree_equal(tt, jt)
    qid_r, hits_r, cnt, ovf = tbvh.query_overlaps_exact(
        tt, _t(qlo), _t(qhi), max_hits, **kw)
    assert not bool(ovf)
    sets = [set() for _ in range(nq)]
    for q, row in zip(qid_r.tolist(), hits_r.numpy()):
        if q < nq:
            for p in row[row >= 0].tolist():
                assert p not in sets[q], "duplicate hit"
                sets[q].add(p)
    ref = _brute(lo, hi, qlo, qhi)
    assert cnt.tolist() == [len(r) for r in ref]
    for q in range(nq):
        if len(ref[q]) <= max_hits:
            assert sets[q] == ref[q], q
    jcnt = jax.jit(lambda b, x, y: jbvh.query_overlaps_exact(
        b, x, y, max_hits, **kw))(jt, jnp.asarray(qlo), jnp.asarray(qhi))[2]
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_query_exact_residue_overflow_flagged():
    rng = np.random.default_rng(42)
    c = rng.uniform(0, 1, (2048, 3)).astype(np.float32)
    tt = tbvh.build_lbvh(_t(c - 0.002), _t(c + 0.002))
    qlo = torch.full((256, 3), -0.1)               # all pathological
    qhi = torch.full((256, 3), 1.1)
    *_, ovf = tbvh.query_overlaps_exact(tt, qlo, qhi, 16, tile=64,
                                        residue_budget=64)
    assert bool(ovf)


def test_slice_matches_zpc_tpu():
    """The slice as chip_smoke drives it, at 16,384 boxes: the bench scene,
    build_lbvh, and the exact query at c8 with a uniform extent; the tree
    and every count equal JAX's."""
    import jax
    import jax.numpy as jnp
    from zpc_tpu.containers import bvh as jbvh

    n = 16_384
    lo, hi, c = scenes.lbvh_boxes(n, CPU)
    tt = tbvh.build_lbvh(lo, hi)
    jt = jax.jit(jbvh.build_lbvh)(jnp.asarray(lo.numpy()),
                                  jnp.asarray(hi.numpy()))
    _assert_tree_equal(tt, jt)
    kw = dict(cells=8, uniform_extent=0.006, residue_budget=2048)
    _, _, cnt, ovf = tbvh.query_overlaps_exact(tt, c, c, 16, **kw)
    jc = jnp.asarray(c.numpy())
    _, _, jcnt, jovf = jax.jit(lambda b, x: jbvh.query_overlaps_exact(
        b, x, x, 16, **kw))(jt, jc)
    assert not bool(ovf) and not bool(jovf)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert cnt.min() >= 1                  # every box overlaps itself
