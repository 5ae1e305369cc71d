"""The port's distance queries and CCD (zpc_tpu_torch.geometry.distance)
against zpc_tpu.geometry.distance on the same seeded numpy inputs.

Inputs: random points, triangles and segments, and points placed exactly on
the point-triangle region boundaries (vertex, edge and face regions and
the planes between them), parallel and crossing segments.  Tolerances,
absolute: closest points, barycentric and segment parameters and squared
distances within 1e-6 of the largest magnitude of the reference output;
times of impact within 1e-5; hit flags equal.  The invariants of
tests/test_distance.py (the interior projection, the vertex and edge
regions, ray hit and miss, a time of impact inside (0.4, 0.5], a full
step without collision) are held on the port alone.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from zpc_tpu.geometry import distance as JD
from zpc_tpu_torch.geometry import distance as TD

REL = 1e-6
TOI_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(fn_name, *arrs):
    """Outputs of ``fn_name`` in both packages as lists of numpy arrays."""
    arrs = [np.array(a, np.float32) for a in arrs]
    j = getattr(JD, fn_name)(*[jnp.asarray(a) for a in arrs])
    t = getattr(TD, fn_name)(*[torch.from_numpy(a) for a in arrs])
    if not isinstance(j, tuple):
        j, t = (j,), (t,)
    return [np.asarray(a) for a in j], [b.numpy() for b in t]


def _assert_matches(want, got, tol_rel=REL, what=""):
    for k, (a, b) in enumerate(zip(want, got)):
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=f"{what}[{k}]")
            continue
        fin = np.isfinite(a)
        np.testing.assert_array_equal(np.isfinite(b), fin,
                                      err_msg=f"{what}[{k}] finite")
        scale = np.abs(a[fin]).max(initial=0.0)
        np.testing.assert_allclose(b[fin], a[fin], rtol=0,
                                   atol=tol_rel * scale,
                                   err_msg=f"{what}[{k}]")


def _random(n=256, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((4, n, 3)).astype(np.float32)


UNIT_TRI = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
# points on the region boundaries of UNIT_TRI: vertex a / edge ab (d1 = 0),
# vertex b / edge ab (d3 = 0), vertex a with the face (d1 = d2 = 0), the
# face / edge bc plane, the face / edge ab plane, inside each vertex, edge
# and face region, on the triangle itself, and on its vertices and edges
BOUNDARY_POINTS = np.asarray([
    [0, -1, 0.3], [1, -1, 0.2], [0, 0, 1], [0.5, 0.5, 1], [0.5, 0, 0.7],
    [-1, -1, 0], [2, -0.5, 0], [-0.5, 2, 0], [0.5, -1, 0], [-1, 0.5, 0],
    [1, 1, 0], [0.2, 0.3, 0.5], [0.2, 0.3, 0], [0, 0, 0], [1, 0, 0],
    [0, 1, 0], [0.5, 0, 0], [0, 0.5, 0], [0.5, 0.5, 0], [0, -1, 0],
    [1, 0, -1], [0, 1, 2]], np.float32)


def _boundary_tris():
    n = len(BOUNDARY_POINTS)
    return (BOUNDARY_POINTS,) + tuple(np.broadcast_to(v, (n, 3))
                                      for v in UNIT_TRI)


@pytest.mark.parametrize("inputs", ["random", "boundary"])
@pytest.mark.parametrize("fn", ["point_triangle_closest",
                                "point_triangle_dist2"])
def test_point_triangle_matches_jax(fn, inputs):
    args = _random()[:4] if inputs == "random" else _boundary_tris()
    _assert_matches(*_both(fn, *args), what=fn)


@pytest.mark.parametrize("fn", ["point_point_dist2", "point_edge_closest",
                                "point_edge_dist2"])
def test_point_queries_match_jax(fn):
    p, a, b, _ = _random(seed=1)
    args = (p, a) if fn == "point_point_dist2" else (p, a, b)
    _assert_matches(*_both(fn, *args), what=fn)
    # the segment's ends and its interior, exactly on the clamps
    e0 = np.zeros((4, 3), np.float32)
    e1 = np.tile(np.asarray([1, 0, 0], np.float32), (4, 1))
    q = np.asarray([[0, 1, 0], [1, 1, 0], [0.5, 0, 0], [-1, 0, 0]],
                   np.float32)
    args = (q, e0) if fn == "point_point_dist2" else (q, e0, e1)
    _assert_matches(*_both(fn, *args), what=fn + " on the clamps")


def _segment_cases():
    p0, p1, q0, q1 = _random(seed=2)
    cases = {"random": (p0, p1, q0, q1)}
    # tests/test_distance.py's crossing and parallel pairs, collinear
    # overlapping and touching ones, and a degenerate (point) segment
    pairs = [([[-1, 0, 1], [1, 0, 1]], [[0, -1, 0], [0, 1, 0]]),
             ([[0, 0, 0], [1, 0, 0]], [[0, 1, 0], [1, 1, 0]]),
             ([[0, 0, 0], [2, 0, 0]], [[1, 0, 0], [3, 0, 0]]),
             ([[0, 0, 0], [1, 0, 0]], [[1, 0, 0], [1, 1, 0]]),
             ([[0, 0, 0], [0, 0, 0]], [[0, 1, 0], [1, 1, 0]])]
    seg = np.asarray(pairs, np.float32)          # [n, 2, 2, 3]
    cases["special"] = (seg[:, 0, 0], seg[:, 0, 1], seg[:, 1, 0],
                        seg[:, 1, 1])
    return cases


@pytest.mark.parametrize("case", ["random", "special"])
@pytest.mark.parametrize("fn", ["edge_edge_closest", "edge_edge_dist2"])
def test_edge_edge_matches_jax(fn, case):
    _assert_matches(*_both(fn, *_segment_cases()[case]), what=fn)


def test_ray_and_segment_match_jax():
    rng = np.random.default_rng(3)
    n = 256
    a, b, c = rng.standard_normal((3, n, 3)).astype(np.float32)
    o = rng.standard_normal((n, 3)).astype(np.float32)
    # rays toward a point of each triangle (hits) and random ones
    aim = (0.2 * a + 0.3 * b + 0.5 * c) - o
    d = np.where(np.arange(n)[:, None] % 2 == 0, aim,
                 rng.standard_normal((n, 3))).astype(np.float32)
    want, got = _both("ray_triangle", o, d, a, b, c)
    np.testing.assert_array_equal(got[0], want[0])
    assert want[0].sum() > n // 4, "too few hits to compare"
    _assert_matches(want[1:], got[1:], what="ray_triangle")
    _assert_matches(*_both("segment_triangle_intersect", o, o + d, a, b, c),
                    what="segment_triangle_intersect")
    _assert_matches(*_both("segment_triangle_intersect", o, o + 0.4 * d,
                           a, b, c), what="segment_triangle_intersect short")


def test_point_triangle_ccd_matches_jax():
    rng = np.random.default_rng(4)
    n = 256
    p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    a, b, c = rng.uniform(-1, 1, (3, n, 3)).astype(np.float32)
    dp, da, db, dc = (0.5 * rng.standard_normal((4, n, 3))).astype(
        np.float32)
    cen = (a + b + c) / 3
    dp = np.where(np.arange(n)[:, None] % 2 == 0, 2.0 * (cen - p),
                  dp).astype(np.float32)
    want, got = _both("point_triangle_ccd", p, a, b, c, dp, da, db, dc)
    assert (want[0] < 1).sum() > n // 4, "too few impacts to compare"
    _assert_matches(want, got, tol_rel=TOI_TOL, what="toi")
    # the implicit step's form: a static triangle
    z = np.zeros_like(dp)
    _assert_matches(*_both("point_triangle_ccd", p, a, b, c, dp, z, z, z),
                    tol_rel=TOI_TOL, what="toi, static triangle")


def test_edge_edge_ccd_matches_jax():
    rng = np.random.default_rng(5)
    n = 256
    p0, p1, q0, q1 = rng.uniform(-1, 1, (4, n, 3)).astype(np.float32)
    v0, v1, w0, w1 = (0.5 * rng.standard_normal((4, n, 3))).astype(
        np.float32)
    # every other first segment heads for the second one's midpoint
    aim = (q0 + q1 - p0 - p1).astype(np.float32)
    v0 = np.where(np.arange(n)[:, None] % 2 == 0, aim, v0)
    v1 = np.where(np.arange(n)[:, None] % 2 == 0, aim, v1)
    want, got = _both("edge_edge_ccd", p0, p1, q0, q1, v0, v1, w0, w1)
    assert (want[0] < 1).sum() > n // 4, "too few impacts to compare"
    _assert_matches(want, got, tol_rel=TOI_TOL, what="edge toi")


# -- the invariants of tests/test_distance.py on the port alone ---------------

def _t(*arrs):
    return [torch.tensor(a, dtype=torch.float32) for a in arrs]


def test_port_point_triangle_invariants():
    a, b, c = _t(*UNIT_TRI)
    p = torch.tensor([0.2, 0.2, 0.5])
    assert abs(float(TD.point_triangle_dist2(p, a, b, c)) - 0.25) < 1e-6
    _, cl = TD.point_triangle_closest(p, a, b, c)
    np.testing.assert_allclose(cl.numpy(), [0.2, 0.2, 0.0], atol=1e-6)
    assert abs(float(TD.point_triangle_dist2(
        torch.tensor([-1.0, -1.0, 0.0]), a, b, c)) - 2.0) < 1e-6
    assert abs(float(TD.point_triangle_dist2(
        torch.tensor([0.5, -1.0, 0.0]), a, b, c)) - 1.0) < 1e-6


def test_port_point_triangle_vs_dense_sampling():
    rng = np.random.default_rng(42)
    a, b, c = rng.standard_normal((3, 3)).astype(np.float32)
    u = np.linspace(0, 1, 60)
    uu, vv = np.meshgrid(u, u)
    keep = uu + vv <= 1
    uu, vv = uu[keep], vv[keep]
    samples = (1 - uu - vv)[:, None] * a + uu[:, None] * b + \
        vv[:, None] * c
    pts = rng.standard_normal((32, 3)).astype(np.float32)
    d2 = TD.point_triangle_dist2(*_t(pts, *(np.tile(v, (32, 1))
                                            for v in (a, b, c)))).numpy()
    ref = ((samples[None] - pts[:, None]) ** 2).sum(-1).min(1)
    assert (d2 <= ref + 1e-5).all() and (d2 >= ref - 1e-2).all()


def test_port_edge_edge_invariants():
    d2 = TD.edge_edge_dist2(*_t([-1, 0, 1], [1, 0, 1], [0, -1, 0],
                                [0, 1, 0]))
    assert abs(float(d2) - 1.0) < 1e-6
    d2 = TD.edge_edge_dist2(*_t([0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]))
    assert abs(float(d2) - 1.0) < 1e-6


def test_port_ray_hit_miss():
    a, b, c = _t([0, 0, 1], [1, 0, 1], [0, 1, 1])
    d = torch.tensor([0.0, 0.0, 1.0])
    hit, t, _, _ = TD.ray_triangle(torch.tensor([0.2, 0.2, 0.0]), d, a, b, c)
    assert bool(hit) and abs(float(t) - 1.0) < 1e-6
    hit, t, _, _ = TD.ray_triangle(torch.tensor([2.0, 2.0, 0.0]), d, a, b, c)
    assert not bool(hit) and np.isinf(float(t))


def test_port_ccd_invariants():
    a, b, c = _t(*UNIT_TRI)
    p = torch.tensor([0.2, 0.2, 1.0])
    z = torch.zeros(3)
    toi = float(TD.point_triangle_ccd(p, a, b, c, torch.tensor(
        [0.0, 0.0, -2.0]), z, z, z))
    assert 0.4 < toi <= 0.5
    toi = float(TD.point_triangle_ccd(p, a, b, c, torch.tensor(
        [0.0, 0.0, 0.5]), z, z, z))
    assert toi == 1.0
    v = torch.tensor([0.0, 0.0, -2.0])
    toi = float(TD.edge_edge_ccd(*_t([-1, 0, 1], [1, 0, 1], [0, -1, 0],
                                     [0, 1, 0]), v, v, z, z))
    assert 0.4 < toi <= 0.5
