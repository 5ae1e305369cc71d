"""Distance queries and CCD (counterpart of ``zpc_tpu/geometry/distance.py``).

Every query is batched and branch-free: the point-triangle region dispatch
is Ericson's clamped barycentric projection for every lane with ``where``
selects, in the JAX package's order (edge regions, then vertex regions
last).  Derivatives come from autograd through these projections
(:mod:`zpc_tpu_torch.geometry.contact`), so the clamps are written as the
JAX package writes them: ``jnp.clip`` is ``minimum(maximum(x, lo), hi)``,
whose derivative at a bound is one half on each side, and
``torch.clamp``'s (one at the bound) is not.  The ``1e-30`` guards keep
their places.

CCD is conservative advancement over a fixed 32 iterations (a plain loop,
no early exit), vectorised over whatever leading shape the inputs share.
"""

from __future__ import annotations

import torch

__all__ = [
    "point_point_dist2", "point_edge_closest", "point_edge_dist2",
    "point_triangle_closest", "point_triangle_dist2",
    "edge_edge_closest", "edge_edge_dist2",
    "ray_triangle", "segment_triangle_intersect",
    "point_triangle_ccd", "edge_edge_ccd",
]


def _dot(a, b):
    return torch.sum(a * b, -1)


def _clip01(x, z, o):
    """``jnp.clip(x, 0, 1)``: ``minimum(maximum(x, 0), 1)`` with the
    bounds ``z`` (zeros) and ``o`` (ones) broadcastable to ``x``."""
    return torch.minimum(torch.maximum(x, z), o)


def _bounds(x):
    return torch.zeros_like(x), torch.ones_like(x)


def point_point_dist2(p, q):
    d = p - q
    return _dot(d, d)


def point_edge_closest(p, e0, e1):
    """Closest point on segment [e0, e1]; returns (t, closest)."""
    d = e1 - e0
    t = _dot(p - e0, d) / torch.clamp_min(_dot(d, d), 1e-30)
    t = _clip01(t, *_bounds(t))
    return t, e0 + t[..., None] * d


def point_edge_dist2(p, e0, e1):
    _, c = point_edge_closest(p, e0, e1)
    return point_point_dist2(p, c)


def point_triangle_closest(p, a, b, c):
    """Closest point on triangle abc (Ericson's barycentric clamping,
    branch-free).  Returns (bary [..., 3], closest [..., 3])."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp_min(va + vb + vc, 1e-30)
    v = vb / denom
    w = vc / denom
    bary_face = torch.stack([1.0 - v - w, v, w], -1)

    # vertex regions
    reg_a = (d1 <= 0) & (d2 <= 0)
    reg_b = (d3 >= 0) & (d4 <= d3)
    reg_c = (d6 >= 0) & (d5 <= d6)
    # edge regions
    vab = d1 * d4 - d3 * d2
    reg_ab = (~reg_a) & (~reg_b) & (vab <= 0) & (d1 >= 0) & (d3 <= 0)
    vac = d5 * d2 - d1 * d6
    reg_ac = (~reg_a) & (~reg_c) & (vac <= 0) & (d2 >= 0) & (d6 <= 0)
    vbc = d3 * d6 - d5 * d4
    reg_bc = (~reg_b) & (~reg_c) & (vbc <= 0) & ((d4 - d3) >= 0) & \
        ((d5 - d6) >= 0)

    z, o = _bounds(v)
    t_ab = _clip01(d1 / torch.clamp_min(d1 - d3, 1e-30), z, o)
    t_ac = _clip01(d2 / torch.clamp_min(d2 - d6, 1e-30), z, o)
    t_bc = _clip01((d4 - d3) / torch.clamp_min((d4 - d3) + (d5 - d6), 1e-30),
                   z, o)

    bary = bary_face

    def pick(cond, bb):
        return torch.where(cond[..., None], bb, bary)

    bary = pick(reg_bc, torch.stack([z, 1 - t_bc, t_bc], -1))
    bary = pick(reg_ac, torch.stack([1 - t_ac, z, t_ac], -1))
    bary = pick(reg_ab, torch.stack([1 - t_ab, t_ab, z], -1))
    bary = pick(reg_c, torch.stack([z, z, o], -1))
    bary = pick(reg_b, torch.stack([z, o, z], -1))
    bary = pick(reg_a, torch.stack([o, z, z], -1))
    closest = (bary[..., 0:1] * a + bary[..., 1:2] * b + bary[..., 2:3] * c)
    return bary, closest


def point_triangle_dist2(p, a, b, c):
    _, cl = point_triangle_closest(p, a, b, c)
    return point_point_dist2(p, cl)


def edge_edge_closest(p0, p1, q0, q1):
    """Closest points between segments; returns (s, t, cp, cq)
    (Ericson 5.1.9, branch-free clamp iteration)."""
    d1 = p1 - p0
    d2 = q1 - q0
    r = p0 - q0
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = torch.clamp_min(a * e - b * b, 1e-30)
    z, o = _bounds(denom)
    s = _clip01((b * f - c * e) / denom, z, o)
    # recompute t for clamped s, then re-clamp s
    t = (b * s + f) / torch.clamp_min(e, 1e-30)
    t_cl = _clip01(t, z, o)
    s = _clip01((b * t_cl - c) / torch.clamp_min(a, 1e-30), z, o)
    cp = p0 + s[..., None] * d1
    cq = q0 + t_cl[..., None] * d2
    return s, t_cl, cp, cq


def edge_edge_dist2(p0, p1, q0, q1):
    _, _, cp, cq = edge_edge_closest(p0, p1, q0, q1)
    return point_point_dist2(cp, cq)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def ray_triangle(o, d, a, b, c, eps: float = 1e-9):
    """Moller-Trumbore; returns (hit, t, u, v), t = inf on a miss."""
    e1 = b - a
    e2 = c - a
    pv = _cross(d, e2)
    det = _dot(e1, pv)
    inv = 1.0 / torch.where(det.abs() < eps, torch.inf, det)
    tv = o - a
    u = _dot(tv, pv) * inv
    qv = _cross(tv, e1)
    v = _dot(d, qv) * inv
    t = _dot(e2, qv) * inv
    hit = (det.abs() >= eps) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0)
    return hit, torch.where(hit, t, torch.inf), u, v


def segment_triangle_intersect(p0, p1, a, b, c):
    """Segment [p0, p1] against triangle abc (Geometry.hpp's test)."""
    d = p1 - p0
    hit, t, _, _ = ray_triangle(p0, d, a, b, c)
    return hit & (t <= 1.0)


def _ccd(dist_fn, x0_list, v_list, min_sep, max_iters):
    """Conservative-advancement core: advance time while the closest
    distance stays above ``min_sep``; returns the earliest safe time of
    impact in [0, 1].  ``max_iters`` iterations, none skipped."""
    speeds = sum(torch.linalg.vector_norm(v, dim=-1) for v in v_list)
    speeds = torch.clamp_min(speeds, 1e-30)
    t = torch.zeros_like(speeds)
    for _ in range(max_iters):
        xs = [x + t[..., None] * v for x, v in zip(x0_list, v_list)]
        d = torch.sqrt(torch.clamp_min(dist_fn(*xs), 0.0))
        step = 0.9 * torch.clamp_min(d - min_sep, 0.0) / speeds
        t = torch.clamp_max(t + step, 1.0)
    return t


def point_triangle_ccd(p, a, b, c, dp, da, db, dc,
                       min_sep: float = 1e-4, max_iters: int = 32):
    """Time of impact in [0, 1] of a moving point against a moving
    triangle (additive conservative advancement)."""
    return _ccd(point_triangle_dist2, [p, a, b, c], [dp, da, db, dc],
                min_sep, max_iters)


def edge_edge_ccd(p0, p1, q0, q1, dp0, dp1, dq0, dq1,
                  min_sep: float = 1e-4, max_iters: int = 32):
    """Time of impact in [0, 1] of two moving segments."""
    return _ccd(edge_edge_dist2, [p0, p1, q0, q1], [dp0, dp1, dq0, dq1],
                min_sep, max_iters)
