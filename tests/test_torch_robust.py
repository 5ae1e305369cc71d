"""The port's robust geometry (zpc_tpu_torch.geometry.predicates and cells,
math.rational and bigint) against zpc_tpu on the same seeded numpy inputs,
and against exact Python oracles (``fractions``, unbounded ints).

Tolerances: predicate values within 2^-40 of the permanent (the sum of
the absolute terms of the determinant's expansion: the double-float error
bound) plus 2^-24 of the value (the float32 result's rounding) of the
exact value, and within twice that of JAX's (XLA may contract a multiply
and an add where PyTorch rounds each), so their signs equal the exact
oracle's wherever it exceeds 2^-40 of the permanent; signs equal JAX's.  Below the bound the
double-float predicates may give 0 or the opposite sign: a 1-ulp move
along the circle or sphere changes incircle and insphere only to second
order (about 1e-16 of the permanent), past the ~48 bits that both
packages carry.  The error-free
transforms exact (hi + lo equals the exact sum or product); cell codes,
BigInt limbs and fractions equal.  Near-degenerate inputs are lattice
points moved by one ulp, with no coordinate at 0 (a 1-ulp move of 0 is a
denormal whose determinant underflows float32).
"""

import importlib
import math
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from zpc_tpu_torch import interop
from zpc_tpu_torch.geometry import cells as TC
from zpc_tpu_torch.geometry import predicates as TPR
TBI = importlib.import_module("zpc_tpu_torch.math.bigint")
TR = importlib.import_module("zpc_tpu_torch.math.rational")

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.geometry import cells as JC
    from zpc_tpu.geometry import predicates as JPR
    # zpc_tpu.math exports a function named bigint over its submodule
    JBI = importlib.import_module("zpc_tpu.math.bigint")
    JR = importlib.import_module("zpc_tpu.math.rational")
except ImportError:
    pass

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or
    zpc_tpu: the card's machine has neither."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|zpc_tpu)(\.|\s|$)", re.M)
    files = sorted((ROOT / "zpc_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 50
    bad = [str(f.relative_to(ROOT)) for f in files
           if pat.search(f.read_text())]
    assert bad == []


# ------------------------------------------------------------ predicates

def _fr(x):
    return Fraction(float(x))


def _det3(m):
    return (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
            - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
            + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))


def _perm3(m):
    """The permanent of |m| (float64): the determinant's error scale."""
    a = np.abs(np.asarray(m, np.float64))
    return (a[0, 0] * (a[1, 1] * a[2, 2] + a[1, 2] * a[2, 1])
            + a[0, 1] * (a[1, 0] * a[2, 2] + a[1, 2] * a[2, 0])
            + a[0, 2] * (a[1, 0] * a[2, 1] + a[1, 1] * a[2, 0]))


def _exact(name, pts):
    """The exact value and the permanent of ``name`` at one set of float32
    points (fractions)."""
    *ps, q = pts
    if name == "orient2d":
        a, b, c = pts
        m = [[_fr(a[0]) - _fr(c[0]), _fr(a[1]) - _fr(c[1])],
             [_fr(b[0]) - _fr(c[0]), _fr(b[1]) - _fr(c[1])]]
        return (m[0][0] * m[1][1] - m[0][1] * m[1][0],
                abs(float(m[0][0] * m[1][1])) + abs(float(m[0][1] * m[1][0])))
    rows = [[_fr(p[j]) - _fr(q[j]) for j in range(len(q))] for p in ps]
    if name == "orient3d":
        return _det3(rows), _perm3([[float(v) for v in r] for r in rows])
    for r in rows:
        r.append(sum(v * v for v in r))
    if name == "incircle":
        return _det3(rows), _perm3([[float(v) for v in r] for r in rows])
    det, perm = Fraction(0), 0.0
    for i in range(4):
        minor = [rows[k][:3] for k in range(4) if k != i]
        s = 1 if (i + 3) % 2 == 0 else -1
        det += s * rows[i][3] * _det3(minor)
        perm += float(abs(rows[i][3])) * _perm3(
            [[float(v) for v in r] for r in minor])
    return det, perm


_ARITY = {"orient2d": (3, 2), "orient3d": (4, 3), "incircle": (4, 2),
          "insphere": (5, 3)}


def _near_degenerate(name, n, rng):
    """Degenerate configurations on a lattice away from 0 (colinear,
    coplanar, cocircular, cospherical), one coordinate of one point moved
    by one ulp up or down in half of them."""
    k, dim = _ARITY[name]
    if name in ("orient2d", "orient3d"):
        base = rng.integers(8, 24, (n, k - 1, dim)).astype(np.float32) / 8
        w = rng.integers(1, 4, (n, k - 1, 1)).astype(np.float32) / 4
        last = base[:, 0] + ((base[:, 1:] - base[:, :1]) * w[:, 1:]).sum(1)
        pts = np.concatenate([base, last[:, None]], 1)
    else:
        # integer points at distance 5 from (8, 8[, 8]): the sign and
        # axis variants of (3, 4[, 0]) and (5, 0[, 0])
        on = (np.asarray([[3, 4, 0], [4, 3, 0], [0, 3, 4], [5, 0, 0],
                          [0, 0, 5], [0, 5, 0], [4, 0, 3]], np.float32)
              if dim == 3 else
              np.asarray([[3, 4], [4, 3], [5, 0], [0, 5]], np.float32))
        sgn = rng.choice([-1.0, 1.0], (n, k, dim)).astype(np.float32)
        pts = on[rng.integers(0, len(on), (n, k))] * sgn + 8.0
    move = rng.uniform(size=n) < 0.5
    i = np.arange(n)
    p = rng.integers(0, k, n)
    d = rng.integers(0, dim, n)
    up = rng.uniform(size=n) < 0.5
    v = pts[i, p, d]
    pts[i, p, d] = np.where(move, np.nextafter(
        v, np.where(up, np.float32(np.inf), np.float32(-np.inf))), v)
    return pts


@pytest.mark.parametrize("name", list(_ARITY))
@pytest.mark.parametrize("kind", ["random", "near_degenerate"])
def test_predicate_matches_exact_and_zpc_tpu(name, kind):
    rng = np.random.default_rng(7)
    k, dim = _ARITY[name]
    n = 256
    if kind == "random":
        pts = rng.uniform(-1, 1, (n, k, dim)).astype(np.float32)
    else:
        pts = _near_degenerate(name, n, rng)
    got = getattr(TPR, name)(*[_t(pts[:, i]) for i in range(k)]).numpy()
    want = np.asarray(getattr(JPR, name)(
        *[jnp.asarray(pts[:, i]) for i in range(k)]))
    ex = [_exact(name, pts[r]) for r in range(n)]
    exact = np.asarray([float(e) for e, _ in ex])
    perm = np.asarray([p for _, p in ex])
    bound = 2.0 ** -40 * perm
    sure = np.abs(exact) > bound
    out = 2.0 ** -24 * np.abs(exact)           # the float32 result's rounding
    assert (np.abs(got.astype(np.float64) - exact) <= bound + out).all()
    np.testing.assert_array_equal(np.sign(got)[sure], np.sign(exact)[sure])
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    assert (np.abs(got.astype(np.float64) - want) <= 2 * (bound + out)).all()
    if kind == "near_degenerate":
        assert (exact == 0).sum() > 20 and sure.sum() > 20   # both occur


def test_error_free_transforms():
    """two_sum and two_prod are exact (hi + lo is the exact sum and
    product) and equal JAX's; df_add and df_mul equal JAX's within one
    rounding of the low part."""
    rng = np.random.default_rng(1)
    a = (rng.uniform(-1, 1, 500) * 2.0 ** rng.integers(-20, 20, 500)
         ).astype(np.float32)
    b = (rng.uniform(-1, 1, 500) * 2.0 ** rng.integers(-20, 20, 500)
         ).astype(np.float32)
    for name, op in (("two_sum", lambda x, y: x + y),
                     ("two_prod", lambda x, y: x * y)):
        hi, lo = getattr(TPR, name)(_t(a), _t(b))
        jhi, jlo = getattr(JPR, name)(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        assert all(_fr(h) + _fr(l) == op(_fr(x), _fr(y)) for h, l, x, y in
                   zip(hi.numpy(), lo.numpy(), a, b))
    x = (_t(a), _t(b * 2.0 ** -24))
    y = (_t(b), _t(a * 2.0 ** -24))
    for name in ("df_add", "df_mul"):
        hi, lo = getattr(TPR, name)(x, y)
        jhi, jlo = getattr(JPR, name)(
            tuple(jnp.asarray(v.numpy()) for v in x),
            tuple(jnp.asarray(v.numpy()) for v in y))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), rtol=0,
                                   atol=2.0 ** -46 * np.abs(hi.numpy())
                                   .max())


def test_insphere_conventions():
    """tests/test_geometry_robust.py's insphere cases: inside and outside
    the unit sphere take orient3d's sign and its opposite, cospherical
    points give 0."""
    a, b, c, d = (torch.tensor(v, dtype=torch.float32) for v in
                  ([1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [-1.0, 0, 0]))
    ori = float(TPR.orient3d(a, b, c, d))
    assert np.sign(float(TPR.insphere(a, b, c, d, torch.zeros(3)))) == \
        np.sign(ori)
    assert np.sign(float(TPR.insphere(a, b, c, d, torch.tensor(
        [2.0, 0, 0])))) == -np.sign(ori)
    assert float(TPR.insphere(a, b, c, d, torch.tensor([0, -1.0, 0]))) == 0


# ------------------------------------------------------------ cells

def _both(name, *args):
    """A cells function of both packages on the same float32 inputs."""
    got = getattr(TC, name)(*[_t(np.asarray(a, np.float32)) for a in args])
    want = getattr(JC, name)(*[jnp.asarray(np.asarray(a, np.float32))
                               for a in args])
    return got, want


def test_cells_predicates_match_zpc_tpu():
    """tests/test_geometry_robust.py's TestCells cases on the port, each
    output equal to JAX's and to the expected code."""
    rng = np.random.default_rng(42)
    a = rng.integers(-8, 8, (16, 3)) / 8.0
    d = rng.integers(1, 8, (16, 3)) / 8.0
    g, w = _both("is_triangle_degenerated", a, a + d, a + 2 * d)
    assert g.all() and torch.equal(g, _t(np.array(w)))
    g, w = _both("is_triangle_degenerated", a, a + d, a + 2 * d + [0, 4, 0])
    assert not g.any() and not np.asarray(w).any()
    s0, e0 = [0.0, 0, 0], [1.0, 0, 0]
    for pt, code in (([0.0, 0, 0], 2), ([3.0, 0, 0], 1), ([-1.0, 0, 0], 0),
                     ([1.0, 1, 0], 0)):
        g, w = _both("point_on_ray", s0, e0, e0, pt)
        assert int(g) == int(w) == code
    for pt, on in (([1.0, 1, 1], True), ([3.0, 3, 3], False),
                   ([1.0, 1, 0], False)):
        g, w = _both("point_on_segment", pt, [0.0, 0, 0], [2.0, 2, 2])
        assert bool(g) == bool(w) == on
    for s1, e1, code in (([2.0, -1, 0], [2.0, 1, 0], 1),
                         ([-2.0, -1, 0], [-2.0, 1, 0], 0),
                         ([0.0, -1, 0], [0.0, 1, 0], 2),
                         ([2.0, -1, 1], [2.0, 1, 2], 0),
                         ([-2.0, -1, 0], [1.0, 1, 0], 0),
                         ([-1.0, -1, 0], [2.0, 1, 0], 1)):
        g, w = _both("ray_segment_intersection", s0, e0, e0, s1, e1)
        assert int(g) == int(w) == code


def test_cells_batched_match_zpc_tpu():
    """Batches of random and lattice (often degenerate) configurations:
    segment-segment, ray-segment and ray-triangle tests and the bilinear,
    prism and hex cells equal JAX's."""
    rng = np.random.default_rng(3)
    n = 256
    lat = (rng.integers(-2, 3, (n, 5, 3)) / 2.0).astype(np.float32)
    lat[:, :, 2] = 0.0                       # coplanar: the 2-D cases
    rnd = rng.uniform(-1, 1, (n, 5, 3)).astype(np.float32)
    for p in (lat, rnd):
        g, w = _both("segment_segment_intersection", p[:, 0], p[:, 1],
                     p[:, 2], p[:, 3])
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        g, w = _both("ray_segment_intersection", p[:, 0], p[:, 1],
                     p[:, 1] - p[:, 0], p[:, 2], p[:, 3])
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    tri = rng.uniform(-1, 1, (n, 3, 3)).astype(np.float32)
    d = (tri.mean(1) - o) * rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)
    g, w = _both("ray_triangle_intersection", o, d, tri[:, 0], tri[:, 1],
                 tri[:, 2])
    np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
    np.testing.assert_allclose(g[1].numpy(), np.asarray(w[1]), rtol=1e-5,
                               atol=1e-6)
    assert g[0].float().mean() > 0.3
    v = rng.uniform(-1, 1, (8, 8, 3)).astype(np.float32)
    bi = TC.make_bilinear(*[_t(v[:, i]) for i in range(4)])
    jbi = JC.make_bilinear(*[jnp.asarray(v[:, i]) for i in range(4)])
    np.testing.assert_array_equal(bi.facets.numpy(), np.asarray(jbi.facets))
    np.testing.assert_array_equal(bi.is_degenerated.numpy(),
                                  np.asarray(jbi.is_degenerated))
    pr = TC.make_prism(*[_t(v[:, i]) for i in range(8)])
    jpr = JC.make_prism(*[jnp.asarray(v[:, i]) for i in range(8)])
    np.testing.assert_array_equal(pr.v.numpy(), np.asarray(jpr.v))
    np.testing.assert_array_equal(pr.triangle_degenerated(1).numpy(),
                                  np.asarray(jpr.triangle_degenerated(1)))
    hx = TC.make_hex(*[_t(v[:, i]) for i in range(8)])
    lo, hi = hx.bbox()
    assert hx.bbox_cut_bbox(lo, hi).all()
    assert not hx.bbox_cut_bbox(hi + 1.0, hi + 2.0).any()
    jlo, _ = JC.make_hex(*[jnp.asarray(v[:, i]) for i in range(8)]).bbox()
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    assert TC.PRISM_EDGES.shape == (9, 2) and TC.HEX_EDGES.shape == (12, 2)


# ------------------------------------------------------------ BigInt

RNG = np.random.default_rng(7)


def _rand_ints(n, bits):
    """tests/test_bigint.py's signed random ints."""
    out = []
    for _ in range(n):
        v = int.from_bytes(RNG.bytes((bits + 7) // 8)) & ((1 << bits) - 1)
        out.append(v if RNG.integers(0, 2) else -v)
    return out


def _big(vals, limbs=16):
    return TBI.bigint(list(vals), limbs=limbs, device=CPU)


def _same_limbs(got, want):
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_array_equal(got.mag.numpy(), np.asarray(want.mag))


@pytest.mark.parametrize("bits", [8, 31, 62])
def test_bigint_roundtrip(bits):
    vals = _rand_ints(64, bits) + [0, 1, -1]
    b = _big(vals)
    assert b.to_pyints() == vals
    _same_limbs(b, JBI.bigint(vals))
    x = np.asarray([v for v in vals if abs(v) < 2 ** 31], np.int32)
    _same_limbs(TBI.bigint(_t(x)), JBI.bigint(jnp.asarray(x)))
    assert torch.equal(interop.bigint_from_jax(JBI.bigint(vals), CPU).mag,
                       b.mag)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("bits", [16, 62, 90])
def test_bigint_arith(op, bits):
    a = _rand_ints(128, bits) + [0, 0, 1, -1]
    b = _rand_ints(128, bits) + [0, 5, -1, 0]
    f = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
         "mul": lambda x, y: x * y}[op]
    got = f(_big(a), _big(b))
    assert got.to_pyints() == [f(x, y) for x, y in zip(a, b)]
    _same_limbs(got, f(JBI.bigint(a), JBI.bigint(b)))


def test_bigint_compare_and_shifts():
    a = _rand_ints(200, 62) + [0, 3, -3]
    b = _rand_ints(200, 62) + [0, 3, 3]
    c = _big(a).compare(_big(b)).numpy()
    assert c.tolist() == [(x > y) - (x < y) for x, y in zip(a, b)]
    np.testing.assert_array_equal(c, np.asarray(
        JBI.bigint(a).compare(JBI.bigint(b))))
    vals = _rand_ints(64, 80) + [0, 1, -1, 2]
    _same_limbs(_big(vals).shift_right1(), JBI.bigint(vals).shift_right1())
    assert _big(vals).shift_right1().to_pyints() == [
        (1 if v > 0 else -1) * (abs(v) >> 1) if abs(v) > 1 else 0
        for v in vals]
    assert _big(vals).shift_left1().to_pyints() == [2 * v for v in vals]
    p = _rand_ints(64, 62)
    q = _rand_ints(64, 62)
    assert (_big(p) * _big(q)).to_pyints() == [x * y for x, y in zip(p, q)]


def test_bigint_gcd_and_division():
    base = _rand_ints(40, 40)
    mult = _rand_ints(40, 20)
    a = [abs(x) for x in base] + [0, 8, 0, 12]
    b = [abs(x * m) % (1 << 60) for x, m in zip(base, mult)] + [8, 0, 0, 18]
    g = TBI.bigint_gcd(_big(a), _big(b))
    assert g.to_pyints() == [math.gcd(x, y) if (x or y) else 1
                             for x, y in zip(a, b)]
    _same_limbs(g, JBI.bigint_gcd(JBI.bigint(a), JBI.bigint(b)))
    q = _rand_ints(48, 50)
    d = [abs(v) + 1 for v in _rand_ints(48, 30)]
    prod = [x * y for x, y in zip(q, d)]
    got = TBI._bigint_div_exact(_big(prod), _big(d))
    assert got.to_pyints() == q
    _same_limbs(got, JBI._bigint_div_exact(JBI.bigint(prod), JBI.bigint(d)))


def test_rational_w():
    n1, d1 = _rand_ints(64, 40), [abs(v) + 1 for v in _rand_ints(64, 30)]
    n2, d2 = _rand_ints(64, 40), [abs(v) + 1 for v in _rand_ints(64, 30)]
    r1 = TBI.rational_w(_big(n1), _big(d1))
    r2 = TBI.rational_w(_big(n2), _big(d2))
    j1 = JBI.rational_w(JBI.bigint(n1), JBI.bigint(d1))
    j2 = JBI.rational_w(JBI.bigint(n2), JBI.bigint(d2))
    f1 = [Fraction(a, b) for a, b in zip(n1, d1)]
    f2 = [Fraction(a, b) for a, b in zip(n2, d2)]
    for op in ("__add__", "__sub__", "__mul__", "__truediv__"):
        got = getattr(r1, op)(r2)
        want = getattr(j1, op)(j2)
        assert got.to_fractions() == [getattr(a, op)(b)
                                      for a, b in zip(f1, f2)]
        _same_limbs(got.num, want.num)
        _same_limbs(got.den, want.den)
    assert r1.compare(r2).tolist() == [(a > b) - (a < b)
                                       for a, b in zip(f1, f2)]
    n = [6, -6, 0, 35]
    d = [4, 9, 5, 7]
    r = TBI.rational_w(_big(n), _big(d)).normalized()
    assert r.to_fractions() == [Fraction(a, b) for a, b in zip(n, d)]
    assert r.den.to_pyints() == [2, 3, 1, 1]
    _same_limbs(r.num, JBI.rational_w(JBI.bigint(n), JBI.bigint(d))
                .normalized().num)
    q = TBI.rational_w(_big([3, -3, 0, 7])) / TBI.rational_w(
        _big([2, -5, 4, -7]))
    assert q.sign().tolist() == [1, 1, 0, -1]


def test_bigint_to_float():
    """Magnitudes past float32's range stay finite in the scaled form,
    and ratios of them are representable (tests/test_bigint.py)."""
    vals = [1 << 140, -(3 << 150), 7, 12345678901234]
    got = _big(vals).to_float().numpy()
    want = np.asarray(JBI.bigint(vals).to_float())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with np.errstate(over="ignore"):
        np.testing.assert_allclose(got, np.asarray(vals, np.float64)
                                   .astype(np.float32), rtol=1e-6)
    n = [5 << 140, -(1 << 150), 1]
    d = [1 << 139, 1 << 150, 1 << 100]
    r = TBI.rational_w(_big(n), _big(d)).to_float().numpy()
    np.testing.assert_allclose(r, [float(Fraction(a, b)) for a, b in
                                   zip(n, d)], rtol=1e-6)


# ------------------------------------------------------------ Rational

def test_rational_int32():
    """tests/test_containers2.py's TestRational, against JAX's fractions."""
    a = TR.rational(1, 3, device=CPU)
    b = TR.rational(1, 6, device=CPU)
    for op, (num, den) in (("__add__", (1, 2)), ("__sub__", (1, 6)),
                           ("__mul__", (1, 18)), ("__truediv__", (2, 1))):
        r = getattr(a, op)(b)
        assert (int(r.num), int(r.den)) == (num, den)
    c = TR.rational(3333, 10000, device=CPU)
    assert int(a.compare(c)) == 1 and int(c.compare(a)) == -1
    assert int(a.compare(TR.rational(2, 6, device=CPU))) == 0
    rng = np.random.default_rng(42)
    n = rng.integers(-50, 50, 32).astype(np.int32)
    d = rng.integers(-50, 50, 32).astype(np.int32)
    d[d == 0] = 7
    r = TR.rational(_t(n), _t(d))
    jr = JR.rational(jnp.asarray(n), jnp.asarray(d))
    np.testing.assert_array_equal(r.num.numpy(), np.asarray(jr.num))
    np.testing.assert_array_equal(r.den.numpy(), np.asarray(jr.den))
    assert r.to_fractions() == [Fraction(int(x), int(y))
                                for x, y in zip(n, d)]
    s = r + TR.rational(_t(d), _t(np.abs(n) + 1))
    js = jr + JR.rational(jnp.asarray(d), jnp.asarray(np.abs(n) + 1))
    np.testing.assert_array_equal(s.num.numpy(), np.asarray(js.num))
    g = TR.gcd(_t(np.asarray([12, 18, 7, 0])), _t(np.asarray([8, 24, 13,
                                                              5])))
    assert g.tolist() == [4, 6, 1, 5]


# ------------------------------------------------------------ the card

@pytest.mark.cuda
def test_card_against_cpu():
    """chip_smoke phase 35 at a small size: predicate values, cells and
    BigInt limbs on the card equal the CPU's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    pts = {name: _near_degenerate(name, 512, rng) for name in _ARITY}
    a = _rand_ints(64, 62)
    b = _rand_ints(64, 62)
    out = []
    for dev in (CPU, torch.device("cuda")):
        r = [getattr(TPR, name)(*[_t(p[:, i]).to(dev) for i in
                                  range(_ARITY[name][0])])
             for name, p in pts.items()]
        x = TBI.bigint(a, device=dev)
        y = TBI.bigint(b, device=dev)
        r += [(x * y).mag, (x + y).mag, TBI.bigint_gcd(x, y).mag]
        out.append([t.cpu() for t in r])
    for g, c in zip(*out):
        assert torch.equal(g, c)
