"""Orientation predicates in double-float arithmetic (counterpart of
``zpc_tpu/geometry/predicates.py``): ``orient2d``, ``orient3d``,
``incircle`` and ``insphere`` on float32 inputs ``[..., 2|3]``, with the
error-free transforms ``two_sum`` and ``two_prod`` (Dekker's split) and the
double-float ``df_add`` and ``df_mul``.  Positive means counter-clockwise
(``orient2d``), below the plane (``orient3d``), inside (``incircle``,
``insphere``).

Dekker's split is exact only when every product and sum rounds on its own.
PyTorch's eager operations do, on the CPU and on the card: each is its own
kernel.  A fused kernel that computes these must not contract a multiply
and an add into one FMA: compile it with ``--fmad=false``, or write the
products with ``__fmul_rn`` and the sums with ``__fadd_rn``.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["orient2d", "orient3d", "incircle", "insphere", "two_sum",
           "two_prod", "df_add", "df_mul"]

_SPLIT = 4097.0                 # 2^12 + 1: Dekker's split for float32


def two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fma_err(a, b, p):
    """The rounding error of ``p = a * b`` by Dekker's split."""
    ca = _SPLIT * a
    ah = ca - (ca - a)
    al = a - ah
    cb = _SPLIT * b
    bh = cb - (cb - b)
    bl = b - bh
    return ((ah * bh - p) + ah * bl + al * bh) + al * bl


def two_prod(a, b):
    p = a * b
    return p, _fma_err(a, b, p)


def df_add(x: Tuple, y: Tuple):
    """Double-float (hi, lo) + (hi, lo)."""
    s, e = two_sum(x[0], y[0])
    return two_sum(s, e + x[1] + y[1])


def df_mul(x: Tuple, y: Tuple):
    p, e = two_prod(x[0], y[0])
    return two_sum(p, e + x[0] * y[1] + x[1] * y[0])


def _df(v):
    return v, torch.zeros_like(v)


def _df_sub(x, y):
    return df_add(x, (-y[0], -y[1]))


def _diff(p, q, j):
    return _df_sub(_df(p[..., j]), _df(q[..., j]))


def orient2d(a, b, c):
    """Sign of the area of triangle abc (> 0 counter-clockwise)."""
    acx, acy = _diff(a, c, 0), _diff(a, c, 1)
    bcx, bcy = _diff(b, c, 0), _diff(b, c, 1)
    det = _df_sub(df_mul(acx, bcy), df_mul(acy, bcx))
    return det[0] + det[1]


def _df_det3(m):
    """Double-float 3x3 determinant of double-float entries m[i][j]."""
    t0 = df_mul(m[0][0], _df_sub(df_mul(m[1][1], m[2][2]),
                                 df_mul(m[1][2], m[2][1])))
    t1 = df_mul(m[0][1], _df_sub(df_mul(m[1][0], m[2][2]),
                                 df_mul(m[1][2], m[2][0])))
    t2 = df_mul(m[0][2], _df_sub(df_mul(m[1][0], m[2][1]),
                                 df_mul(m[1][1], m[2][0])))
    return df_add(_df_sub(t0, t1), t2)


def orient3d(a, b, c, d):
    """> 0 iff d lies below the plane of counter-clockwise (a, b, c)."""
    det = _df_det3([[_diff(p, d, j) for j in range(3)] for p in (a, b, c)])
    return det[0] + det[1]


def incircle(a, b, c, d):
    """> 0 iff d lies strictly inside the circumcircle of counter-clockwise
    triangle abc."""
    def row(p):
        x, y = _diff(p, d, 0), _diff(p, d, 1)
        return [x, y, df_add(df_mul(x, x), df_mul(y, y))]

    det = _df_det3([row(a), row(b), row(c)])
    return det[0] + det[1]


def insphere(a, b, c, d, e):
    """> 0 iff e lies strictly inside the circumsphere of tetrahedron abcd
    (positively oriented as :func:`orient3d` orients), < 0 outside, 0 on
    it: the 4x4 determinant with rows ``(p - e, |p - e|^2)``, expanded
    along the norm column into four 3x3 determinants."""
    rows = []
    for p in (a, b, c, d):
        xyz = [_diff(p, e, j) for j in range(3)]
        w = df_add(df_add(df_mul(xyz[0], xyz[0]), df_mul(xyz[1], xyz[1])),
                   df_mul(xyz[2], xyz[2]))
        rows.append(xyz + [w])
    det = _df(torch.zeros_like(rows[0][0][0]))
    for i in range(4):
        minor = _df_det3([rows[k][:3] for k in range(4) if k != i])
        term = df_mul(rows[i][3], minor)
        # expansion along the w column: sign (-1)^(i + 3)
        det = df_add(det, term if (i + 3) % 2 == 0 else (-term[0], -term[1]))
    return det[0] + det[1]
