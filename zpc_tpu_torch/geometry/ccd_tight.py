"""Tight-inclusion continuous collision detection, batched (counterpart of
``zpc_tpu/geometry/ccd_tight.py``).

The (t, u, v) parameter cube is bisected in dyadic int32 boxes
``(k, n)`` per dimension with n <= 23, so every corner ``k * 2^-n`` is
exact in fp32: ``2^-n`` comes from a 24-entry table (:data:`_POW2`), not
from ``exp2``, whose fp32 value is not exact on every device.  Each query
runs a depth-first search over a ``[Q, S + 1, 6]`` int32 stack; all
queries pop, evaluate the 8 corners of the multilinear gap function, and
push in lockstep.  Slot ``S`` is the sink of pushes that do not happen
(the JAX package's ``mode="drop"``); it is never read.  Stack overflow
and the iteration cap degrade conservatively: the unrefined box's early
time is folded into the answer, so a hit is never missed.

The JAX package's ``lax.while_loop`` is a host loop here: every
:data:`CHECK_EVERY` iterations it reads which stacks are empty and drops
those queries (an iteration after a query's stack emptied changes
nothing for it), and it stops when none is left or at ``max_iter``, so
the result is that of the JAX loop's stopping rule.  ``CCDResult.iters``
is the number of iterations run.

Returned ``toi`` is a conservative lower bound on the true time of impact
in [0, 1], within ``tol`` of it when the refinement converged
(``overflowed`` False).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["CCDResult", "vertex_face_ccd", "edge_edge_ccd_tight"]

_N_MAX = 23          # deepest dyadic level: corners stay exact in fp32
_EPS32 = 2.0 ** -23
CHECK_EVERY = 16     # iterations between reads of the loop's exit flag
# 2^-n for n = 0 .. 23, each exact in fp32
_POW2 = tuple(2.0 ** -n for n in range(_N_MAX + 1))


class CCDResult(NamedTuple):
    toi: torch.Tensor         # [Q] fp32, earliest impact; inf = miss
    hit: torch.Tensor         # [Q] bool
    overflowed: torch.Tensor  # [Q] bool: stack overflow / iteration cap hit
    iters: int = 0            # lockstep iterations run


def _corners(box, pow2):
    """box [Q, 6] int32 -> (lo, hi) pairs per dim, each [Q] fp32."""
    out = []
    for d in range(3):
        k, n = box[:, 2 * d], box[:, 2 * d + 1]
        s = pow2[n.long()]
        out.append((k.float() * s, (k + 1).float() * s))
    return tuple(out)


def _lerp(x0, x1, w):
    return x0[:, None, None, None, :] + w * (x1 - x0)[:, None, None, None, :]


def _params(tb, ub, vb):
    t = torch.stack(tb, -1)[:, :, None, None, None]        # [Q,2,1,1,1]
    u = torch.stack(ub, -1)[:, None, :, None, None]
    v = torch.stack(vb, -1)[:, None, None, :, None]
    return t, u, v


def _gap_corners_vf(tb, ub, vb, p0, p1, a0, a1, b0, b1, c0, c1):
    """Vertex-face gap F = p(t) - ((1-u-v) a(t) + u b(t) + v c(t)) at the 8
    box corners: [Q, 2, 2, 2, 3]."""
    t, u, v = _params(tb, ub, vb)
    pt, at = _lerp(p0, p1, t), _lerp(a0, a1, t)
    bt, ct = _lerp(b0, b1, t), _lerp(c0, c1, t)
    return pt - (at + u * (bt - at) + v * (ct - at))


def _gap_corners_ee(tb, ub, vb, a00, a01, a10, a11, b00, b01, b10, b11):
    """Edge-edge gap F = ((1-u) a0(t) + u a1(t)) - ((1-v) b0(t) + v b1(t))."""
    t, u, v = _params(tb, ub, vb)
    ea0, ea1 = _lerp(a00, a01, t), _lerp(a10, a11, t)
    eb0, eb1 = _lerp(b00, b01, t), _lerp(b10, b11, t)
    return (ea0 + u * (ea1 - ea0)) - (eb0 + v * (eb1 - eb0))


def _amin3(g):
    return g.amin((1, 2, 3))


def _amax3(g):
    return g.amax((1, 2, 3))


def _t_early(g, tb, band):
    """Conservative earliest impact time inside a box from its 8 corner gap
    values: while the lerp of the per-face minima stays above +band (or of
    the maxima below -band) no root exists; the latest such crossing over
    the coordinates."""
    a_min, b_min = g[:, 0].amin((1, 2)), g[:, 1].amin((1, 2))   # [Q, 3]
    a_max, b_max = g[:, 0].amax((1, 2)), g[:, 1].amax((1, 2))
    bnd = band[:, None]
    s_lo = torch.where(a_min > bnd, (a_min - bnd) / torch.clamp_min(
        a_min - b_min, 1e-30), 0.0)
    s_hi = torch.where(a_max < -bnd, (-bnd - a_max) / torch.clamp_min(
        b_max - a_max, 1e-30), 0.0)
    s = torch.maximum(s_lo, s_hi).amax(-1)
    s = torch.minimum(torch.maximum(s, torch.zeros_like(s)),
                      torch.ones_like(s))
    t_lo, t_hi = tb
    return t_lo + s * (t_hi - t_lo)


def _simplex_excluded(box):
    """Exact dyadic test that the whole box lies outside u + v <= 1
    (u_lo + v_lo > 1), in shifted int32."""
    uk, un, vk, vn = box[:, 2], box[:, 3], box[:, 4], box[:, 5]
    m = torch.maximum(un, vn)
    lhs = (uk << (m - un)) + (vk << (m - vn))   # < 2^24: no overflow
    return lhs > (1 << m)


def _inclusion(g, band):
    b = band[:, None]
    return ((_amin3(g) <= b) & (_amax3(g) >= -b)).all(-1)


def _ccd_loop(gap_fn, pts, min_sep, tol, max_iter, stack_size, simplex):
    """Lockstep bisection shared by both queries; ``pts`` are the point
    arrays handed to ``gap_fn``; ``simplex`` restricts (u, v) to
    u + v <= 1."""
    Q = pts[0].shape[0]
    dev = pts[0].device
    S = stack_size
    n_tol = min(_N_MAX, max(1, int(math.ceil(-math.log2(float(tol))))))
    pow2 = torch.tensor(_POW2, dtype=torch.float32, device=dev)
    sep = torch.tensor(min_sep, dtype=torch.float32, device=dev)

    # conservative rounding filter per query: the gap is a short chain of
    # fp32 lerps of the inputs, |err| <= 64 ulp of the largest input
    mags = torch.stack([p.abs().amax(-1) for p in pts], 0)
    err = 64.0 * _EPS32 * torch.clamp_min(mags.amax(0), 1.0)        # [Q]

    def body(stack, sp, toi, ovf, pts, err):
        q = torch.arange(sp.shape[0], device=dev)
        band = err + sep
        active = sp > 0
        box = stack[q, torch.clamp_min(sp - 1, 0).long()]
        sp2 = sp - active.to(torch.int32)

        tb, ub, vb = _corners(box, pow2)
        g = gap_fn(tb, ub, vb, *pts)                        # [Q,2,2,2,3]
        t_lo = _t_early(g, tb, band)
        live = active & (t_lo < toi)
        if simplex:
            live = live & ~_simplex_excluded(box)
        live = live & _inclusion(g, band)

        # existence certificate: the gap at the box centre strictly inside
        # +-(min_sep - err) proves a root in this box, so only t needs
        # resolving
        ctr = tuple((0.5 * (lo + hi), 0.5 * (lo + hi))
                    for lo, hi in (tb, ub, vb))
        gc = gap_fn(*ctr, *pts)[:, 0, 0, 0, :]
        certified = (gc.abs() <= sep - err[:, None]).all(-1)

        ns = box[:, 1::2]                                   # (tn, un, vn)
        terminal = live & ((ns.amin(-1) >= n_tol)
                           | (certified & (ns[:, 0] >= n_tol)))
        toi = torch.where(terminal, torch.minimum(toi, t_lo), toi)

        split = live & ~terminal
        # split the dimension of the widest image across the 8 corners
        # (ties to t); certified boxes split t; a dimension at _N_MAX
        # reports width 0
        spans = torch.stack(
            [(g[:, 1] - g[:, 0]).abs().amax((1, 2, 3)),
             (g[:, :, 1] - g[:, :, 0]).abs().amax((1, 2, 3)),
             (g[:, :, :, 1] - g[:, :, :, 0]).abs().amax((1, 2, 3))], -1)
        spans = torch.where(ns >= _N_MAX, 0.0, spans)
        d = torch.where(certified & (ns[:, 0] < _N_MAX), 0,
                        spans.argmax(-1)).long()
        kd = box.gather(1, (2 * d)[:, None])[:, 0]
        nd = box.gather(1, (2 * d + 1)[:, None])[:, 0]
        child_lo = box.clone()
        child_lo[q, 2 * d] = 2 * kd
        child_lo[q, 2 * d + 1] = nd + 1
        child_hi = child_lo.clone()
        child_hi[q, 2 * d] = 2 * kd + 1

        room = sp2 + 2 <= S
        do_push = split & room
        blown = split & ~room
        toi = torch.where(blown, torch.minimum(toi, t_lo), toi)
        ovf = ovf | blown

        pos_hi = torch.where(do_push, sp2, S).long()        # S: the sink
        pos_lo = torch.where(do_push, sp2 + 1, S).long()
        stack[q, pos_hi] = child_hi
        stack[q, pos_lo] = child_lo
        return sp2 + 2 * do_push.to(torch.int32), toi, ovf

    toi = torch.full((Q,), math.inf, dtype=torch.float32, device=dev)
    ovf = torch.zeros(Q, dtype=torch.bool, device=dev)
    # the queries still searching: their ids, stacks and inputs
    ids = torch.arange(Q, device=dev)
    stack = torch.zeros((Q, S + 1, 6), dtype=torch.int32, device=dev)
    sp = torch.ones(Q, dtype=torch.int32, device=dev)
    toi_a, ovf_a, pts_a, err_a = toi.clone(), ovf.clone(), pts, err
    it = 0
    while it < max_iter and ids.numel():
        for _ in range(min(CHECK_EVERY, max_iter - it)):
            sp, toi_a, ovf_a = body(stack, sp, toi_a, ovf_a, pts_a, err_a)
            it += 1
        toi[ids], ovf[ids] = toi_a, ovf_a
        keep = sp > 0
        if not bool(keep.all()):
            # a finished query's later iterations change nothing: drop it
            ids, stack, sp, toi_a, ovf_a, err_a = (
                a[keep] for a in (ids, stack, sp, toi_a, ovf_a, err_a))
            pts_a = tuple(p[keep] for p in pts_a)

    # iteration cap with work left: fold in the remaining boxes that would
    # survive the prune, domain and inclusion tests
    if ids.numel():
        band = err_a + sep
        live_any = torch.zeros_like(ovf_a)
        tmin = torch.full_like(toi_a, math.inf)
        for k in range(S):
            box = stack[:, k]
            tb, ub, vb = _corners(box, pow2)
            g = gap_fn(tb, ub, vb, *pts_a)
            te = _t_early(g, tb, band)
            ok = (k < sp) & (te < toi_a)
            if simplex:
                ok = ok & ~_simplex_excluded(box)
            ok = ok & _inclusion(g, band)
            live_any = live_any | ok
            tmin = torch.where(ok, torch.minimum(tmin, te), tmin)
        toi[ids] = torch.where(live_any, torch.minimum(toi_a, tmin), toi_a)
        ovf[ids] = ovf_a | live_any
    return CCDResult(toi, torch.isfinite(toi), ovf, it)


def vertex_face_ccd(p, t0, t1, t2, dp, dt0, dt1, dt2, *, min_sep=0.0,
                    tol=1e-6, max_iter=1024, stack_size=96) -> CCDResult:
    """Batched conservative vertex-triangle CCD over t in [0, 1].  All
    points are [Q, 3]; ``d*`` are displacements over the step."""
    pts = (p, p + dp, t0, t0 + dt0, t1, t1 + dt1, t2, t2 + dt2)
    return _ccd_loop(_gap_corners_vf, pts, min_sep, tol, max_iter,
                     stack_size, simplex=True)


def edge_edge_ccd_tight(a0, a1, b0, b1, da0, da1, db0, db1, *, min_sep=0.0,
                        tol=1e-6, max_iter=1024, stack_size=96) -> CCDResult:
    """Batched conservative edge-edge CCD over t in [0, 1]."""
    pts = (a0, a0 + da0, a1, a1 + da1, b0, b0 + db0, b1, b1 + db1)
    return _ccd_loop(_gap_corners_ee, pts, min_sep, tol, max_iter,
                     stack_size, simplex=False)
