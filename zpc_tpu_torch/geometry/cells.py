"""Cell structures of exact-root CCD and the point, segment, ray and
triangle tests they rest on (counterpart of ``zpc_tpu/geometry/cells.py``).

Batched over ``[..., 3]`` inputs with masks in place of early returns, on
the double-float predicates of :mod:`zpc_tpu_torch.geometry.predicates`.
Cross and dot products are written out term by term and divisions and
square roots rounded once (:mod:`~zpc_tpu_torch.math.rounding`), so the
card's results equal the CPU's bit for bit.
The return codes are the JAX package's (0 = miss, 1 = hit, 2 = endpoint
on).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..math.rounding import cross, div_rn, dot, sqrt_rn
from .predicates import orient2d, orient3d

__all__ = ["Bilinear", "Prism", "Hex", "make_bilinear", "make_prism",
           "make_hex", "is_triangle_degenerated", "same_point",
           "point_on_ray", "colinear_point_on_segment", "point_on_segment",
           "ray_segment_intersection", "segment_segment_intersection",
           "ray_triangle_intersection", "PRISM_EDGES", "HEX_EDGES"]

# facet tables of the two bilinear orientations
_BILINEAR_FACETS_POS = np.asarray(
    [[1, 2, 0], [3, 0, 2], [0, 3, 1], [2, 1, 3]], np.int32)
_BILINEAR_FACETS_NEG = np.asarray(
    [[1, 0, 2], [3, 2, 0], [0, 1, 3], [2, 3, 1]], np.int32)

PRISM_EDGES = np.asarray(
    [[0, 1], [1, 2], [2, 0], [3, 4], [4, 5], [5, 3], [0, 3], [1, 4],
     [2, 5]], np.int32)
HEX_EDGES = np.asarray(
    [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7], [7, 4],
     [0, 4], [1, 5], [2, 6], [3, 7]], np.int32)


@dataclasses.dataclass(frozen=True)
class Bilinear:
    """Bilinear patch of two segment pairs: ``v`` [..., 4, 3], ``facets``
    [..., 4, 3] tetrahedron facets oriented by the sign of
    orient3d(v0..v3), ``is_degenerated`` [...] (coplanar)."""

    v: torch.Tensor
    facets: torch.Tensor
    is_degenerated: torch.Tensor


def make_bilinear(v0, v1, v2, v3) -> Bilinear:
    v = torch.stack([v0, v1, v2, v3], dim=-2)
    ori = orient3d(v0, v1, v2, v3)
    pos = torch.as_tensor(_BILINEAR_FACETS_POS, device=v.device)
    neg = torch.as_tensor(_BILINEAR_FACETS_NEG, device=v.device)
    facets = torch.where((ori >= 0)[..., None, None], pos, neg)
    return Bilinear(v, facets, ori == 0)


@dataclasses.dataclass(frozen=True)
class Prism:
    """CCD prism: 6 difference vertices, 9 edges (:data:`PRISM_EDGES`)."""

    v: torch.Tensor                   # [..., 6, 3]

    def bbox(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.v.amin(-2), self.v.amax(-2)

    def bbox_cut_bbox(self, lo, hi) -> torch.Tensor:
        mn, mx = self.bbox()
        return torch.all((mn <= hi) & (lo <= mx), dim=-1)

    def triangle_degenerated(self, up_or_bottom: int) -> torch.Tensor:
        pid = 0 if up_or_bottom == 0 else 3
        return is_triangle_degenerated(self.v[..., pid, :],
                                       self.v[..., pid + 1, :],
                                       self.v[..., pid + 2, :])


def make_prism(vs, fs0, fs1, fs2, ve, fe0, fe1, fe2) -> Prism:
    """Vertex order of the reference: (s - f0, s - f2, s - f1, ...)."""
    return Prism(torch.stack([vs - fs0, vs - fs2, vs - fs1,
                              ve - fe0, ve - fe2, ve - fe1], dim=-2))


@dataclasses.dataclass(frozen=True)
class Hex:
    """CCD hexahedron: 8 difference vertices, 12 edges
    (:data:`HEX_EDGES`)."""

    v: torch.Tensor                   # [..., 8, 3]

    def bbox(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.v.amin(-2), self.v.amax(-2)

    def bbox_cut_bbox(self, lo, hi) -> torch.Tensor:
        mn, mx = self.bbox()
        return torch.all((mn <= hi) & (lo <= mx), dim=-1)


def make_hex(a0, a1, b0, b1, a0b, a1b, b0b, b1b) -> Hex:
    return Hex(torch.stack([a0 - b0, a1 - b0, a1 - b1, a0 - b1,
                            a0b - b0b, a1b - b0b, a1b - b1b, a0b - b1b],
                           dim=-2))


def _drop_axis(p, t):
    """Project to 2-D on the axes (t + 1) % 3 and (t + 2) % 3."""
    return torch.stack([p[..., (t + 1) % 3], p[..., (t + 2) % 3]], dim=-1)


def is_triangle_degenerated(t1, t2, t3) -> torch.Tensor:
    """True iff t1, t2, t3 are colinear: the cross product's norm at most
    1e-8 and all three 2-D projections exactly colinear."""
    c = cross(t1 - t2, t1 - t3)
    r = sqrt_rn(dot(c, c))
    exact = torch.ones(r.shape, dtype=torch.bool, device=r.device)
    for j in range(3):
        exact = exact & (orient2d(_drop_axis(t1, j), _drop_axis(t2, j),
                                  _drop_axis(t3, j)) == 0)
    return (r.abs() <= 1e-8) & exact


def same_point(p1, p2) -> torch.Tensor:
    return torch.all(p1 == p2, dim=-1)


def _axis_ray_ok(dirv, s0, pt, d) -> torch.Tensor:
    dd, ss, pp = dirv[..., d], s0[..., d], pt[..., d]
    return torch.where(dd > 0, pp > ss, torch.where(dd < 0, pp < ss,
                                                    pp == ss))


def point_on_ray(s0, e0, dir0, pt) -> torch.Tensor:
    """0 = off the ray, 1 = on the open ray, 2 = pt == s0."""
    on_line = is_triangle_degenerated(s0, e0, pt)
    ok = (_axis_ray_ok(dir0, s0, pt, 0) & _axis_ray_ok(dir0, s0, pt, 1)
          & _axis_ray_ok(dir0, s0, pt, 2))
    hit = (on_line & ok).to(torch.int32)
    return torch.where(same_point(s0, pt), 2, hit).to(torch.int32)


def colinear_point_on_segment(pt, s0, s1) -> torch.Tensor:
    lo = torch.minimum(s0, s1)
    hi = torch.maximum(s0, s1)
    return torch.all((lo <= pt) & (pt <= hi), dim=-1)


def point_on_segment(pt, s0, s1) -> torch.Tensor:
    return is_triangle_degenerated(pt, s0, s1) & \
        colinear_point_on_segment(pt, s0, s1)


def _sign(x):
    return torch.sign(x).to(torch.int32)


def orient3d_proxy(a, b, c):
    """2-D orientation of coplanar 3-D points in the projection that drops
    the plane normal's largest component (the first such axis)."""
    n = cross(b - a, c - a).abs()
    outs = torch.stack([orient2d(_drop_axis(a, j), _drop_axis(b, j),
                                 _drop_axis(c, j)) for j in range(3)], -1)
    return torch.gather(outs, -1, torch.argmax(n, -1, keepdim=True))[..., 0]


def segment_segment_intersection(s0, e0, s1, e1) -> torch.Tensor:
    """True iff coplanar segments (s0, e0) and (s1, e1) cross or touch."""
    o1 = _sign(orient3d_proxy(s0, e0, s1))
    o2 = _sign(orient3d_proxy(s0, e0, e1))
    o3 = _sign(orient3d_proxy(s1, e1, s0))
    o4 = _sign(orient3d_proxy(s1, e1, e0))
    proper = (o1 * o2 < 0) & (o3 * o4 < 0)
    touch = (point_on_segment(s1, s0, e0) | point_on_segment(e1, s0, e0)
             | point_on_segment(s0, s1, e1) | point_on_segment(e0, s1, e1))
    return proper | touch


def ray_segment_intersection(s0, e0, dir0, s1, e1) -> torch.Tensor:
    """0 = miss, 1 = hit, 2 = the ray's origin on the segment.  The ray
    hits iff the two are coplanar, the segment's ends straddle the ray's
    line and the crossing lies ahead (tested without a division), or the
    segment lies on the ray's line with an end on the ray."""
    degen_seg = same_point(s1, e1)
    on_ray_d = point_on_ray(s0, e0, dir0, s1)
    coplanar = orient3d(s0, e0, s1, e1) == 0
    origin_on = point_on_segment(s0, s1, e1)
    r_s1 = orient3d_proxy(s0, e0, s1)
    r_e1 = orient3d_proxy(s0, e0, e1)
    straddles = _sign(r_s1) * _sign(r_e1) <= 0
    # crossing p = s1 + u (e1 - s1), u = r_s1 / (r_s1 - r_e1); ahead means
    # dot(p - s0, dir0) >= 0, multiplied through by |r_s1 - r_e1|
    a = dot(s1 - s0, dir0)
    b = dot(e1 - s1, dir0)
    den = r_s1 - r_e1
    forward = (a * den + r_s1 * b) * torch.sign(den) >= 0
    col_s1 = point_on_ray(s0, e0, dir0, s1) > 0
    col_e1 = point_on_ray(s0, e0, dir0, e1) > 0
    seg_on_line = (is_triangle_degenerated(s1, s0, e0)
                   & is_triangle_degenerated(e1, s0, e0))
    colinear_hit = seg_on_line & (col_s1 | col_e1)
    proper = coplanar & straddles & forward & ~seg_on_line
    hit = (proper | colinear_hit).to(torch.int32)
    hit = torch.where(origin_on, 2, hit)
    return torch.where(degen_seg, on_ray_d, hit).to(torch.int32)


def ray_triangle_intersection(o, d, t0, t1, t2, eps: float = 0.0):
    """Möller-Trumbore: ``(hit, t)``; ``eps`` widens the barycentric
    test."""
    e1 = t1 - t0
    e2 = t2 - t0
    p = cross(d, e2)
    det = dot(e1, p)
    ok = det.abs() > 1e-12
    inv = torch.where(ok, div_rn(1.0, det), 0.0)
    s = o - t0
    u = dot(s, p) * inv
    q = cross(s, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    hit = ok & (u >= -eps) & (v >= -eps) & (u + v <= 1 + eps) & (t >= 0)
    return hit, t
