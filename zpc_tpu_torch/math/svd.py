"""Small-matrix decompositions (counterpart of ``zpc_tpu/math/svd.py``):
the closed-form 2x2 SVD, the symmetric 3x3 eigensolver, the 3x3 SVD and
polar decomposition in the rotation convention, the Newton polar factor of
the corotated stress and the Gram-Schmidt 3x3 QR.

Every routine is branch-free over batches, as in the JAX package: a fixed
number of cyclic Jacobi sweeps, compare-swap sorting and ``where`` selects,
in scalar form (one tensor per matrix entry).  ``svd3x3`` carries the JAX
package's closed-form derivative (a ``torch.autograd.Function`` with a
``jvp`` rule and its transpose as the ``backward``), so ``torch.func.jvp``
of a model's stress, which the implicit solver takes, and the gradients of
an energy, which a return map takes, never differentiate through the
Jacobi sweeps.  ``torch.linalg.svd`` is not a substitute:
it returns non-negative singular values with a reflection in U or V, where
this convention keeps ``det U = det V = +1`` and a signed smallest
singular value.
"""

from __future__ import annotations

import torch

from .vecmat import cof3, det3, mm33

__all__ = ["svd2x2", "eigh3x3", "svd3x3", "polar_decomposition",
           "polar_newton3x3", "qr3x3"]


def _jacobi_rotation(app, aqq, apq):
    """Givens (c, s) zeroing the off-diagonal ``apq`` (branch-free)."""
    tau = (aqq - app) / (2.0 * torch.where(apq == 0.0, 1.0, apq))
    sgn = torch.where(tau >= 0.0, 1.0, -1.0)     # sign(0) must be 1, not 0
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(apq == 0.0, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _rotate(s, p, q, r):
    """One Jacobi rotation in the (p, q) plane of the state ``s``: the six
    unique entries of the symmetric matrix (keys ``pq``) and the nine
    components of V (keys ``v<col><axis>``); ``r`` is the third index."""
    def a(i, j):
        return s[f"{min(i, j)}{max(i, j)}"]
    app, aqq, apq = a(p, p), a(q, q), a(p, q)
    apr, aqr = a(p, r), a(q, r)
    c, sn = _jacobi_rotation(app, aqq, apq)
    out = dict(s)
    out[f"{p}{p}"] = c * c * app - 2 * sn * c * apq + sn * sn * aqq
    out[f"{q}{q}"] = sn * sn * app + 2 * sn * c * apq + c * c * aqq
    out[f"{min(p, q)}{max(p, q)}"] = torch.zeros_like(apq)
    out[f"{min(p, r)}{max(p, r)}"] = c * apr - sn * aqr
    out[f"{min(q, r)}{max(q, r)}"] = sn * apr + c * aqr
    for ax in "xyz":
        vp, vq = s[f"v{p}{ax}"], s[f"v{q}{ax}"]
        out[f"v{p}{ax}"] = c * vp - sn * vq
        out[f"v{q}{ax}"] = sn * vp + c * vq
    return out


def eigh3x3(A: torch.Tensor, sweeps: int = 6):
    """Symmetric 3x3 eigendecomposition of ``[..., 3, 3]`` by cyclic Jacobi
    (sweep order (0,1), (0,2), (1,2)), batched.  Returns (eigenvalues
    sorted descending ``[..., 3]``, eigenvectors ``[..., 3, 3]`` as
    columns)."""
    Ah = 0.5 * (A + A.transpose(-1, -2))
    one = torch.ones_like(Ah[..., 0, 0])
    zero = torch.zeros_like(one)
    s = {f"{i}{j}": Ah[..., i, j] for i in range(3) for j in range(i, 3)}
    for col in range(3):
        for k, ax in enumerate("xyz"):
            s[f"v{col}{ax}"] = one if k == col else zero
    for _ in range(sweeps):
        s = _rotate(s, 0, 1, 2)
        s = _rotate(s, 0, 2, 1)
        s = _rotate(s, 1, 2, 0)

    # descending sort by a 3-element compare-swap network
    def cswap(wa, va, wb, vb):
        swap = wb > wa
        return (torch.where(swap, wb, wa),
                tuple(torch.where(swap, b, a) for a, b in zip(va, vb)),
                torch.where(swap, wa, wb),
                tuple(torch.where(swap, a, b) for a, b in zip(va, vb)))

    w = [s["00"], s["11"], s["22"]]
    v = [tuple(s[f"v{c}{ax}"] for ax in "xyz") for c in range(3)]
    w[0], v[0], w[1], v[1] = cswap(w[0], v[0], w[1], v[1])
    w[1], v[1], w[2], v[2] = cswap(w[1], v[1], w[2], v[2])
    w[0], v[0], w[1], v[1] = cswap(w[0], v[0], w[1], v[1])
    V = torch.stack([torch.stack([v[0][i], v[1][i], v[2][i]], -1)
                     for i in range(3)], -2)
    return torch.stack(w, -1), V


def _safe_norm(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``sqrt(p^2 + q^2)``, whose derivative at p = q = 0 is taken as 0
    (the double ``where``: the square root never sees 0, so its tangent
    stays finite)."""
    r2 = p * p + q * q
    pos = r2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, r2, 1.0)), 0.0)


def _safe_atan2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``atan2(q, p)``, 0 with a zero derivative at p = q = 0."""
    pos = (p * p + q * q) > 0.0
    return torch.where(pos, torch.atan2(torch.where(pos, q, 0.0),
                                        torch.where(pos, p, 1.0)), 0.0)


def svd2x2(A: torch.Tensor):
    """Closed-form 2x2 SVD ``A = U diag(sigma) V^T`` with rotations U, V
    (det +1) and signed sigma, the JAX package's formula: with E, F, G, H
    the half sums and differences of the entries, ``sigma = (Q + R, Q -
    R)`` for ``Q = |(E, H)|``, ``R = |(F, G)|``, and the angles of U and V
    from ``atan2(G, F)`` and ``atan2(H, E)``.

    The values are the JAX function's.  Its derivative is not where ``(F,
    G)`` or ``(E, H)`` is 0 (F = I is one such point): JAX differentiates
    ``sqrt`` and ``atan2`` at 0 and returns NaN there, while here both
    take a zero derivative.  The rotation U V^T, which turns by ``atan2(H,
    E)`` alone, keeps its exact derivative, and so does ``det A = Q^2 -
    R^2``; what is lost is the split of a shear between the two singular
    values, which has no derivative at equal singular values."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    E = 0.5 * (a + d)
    F = 0.5 * (a - d)
    G = 0.5 * (c + b)
    H = 0.5 * (c - b)
    Q = _safe_norm(E, H)
    R = _safe_norm(F, G)
    a1 = _safe_atan2(G, F)
    a2 = _safe_atan2(H, E)
    theta = 0.5 * (a2 - a1)   # V angle
    phi = 0.5 * (a2 + a1)     # U angle
    cU, sU = torch.cos(phi), torch.sin(phi)
    cV, sV = torch.cos(theta), torch.sin(theta)
    U = torch.stack([torch.stack([cU, -sU], -1),
                     torch.stack([sU, cU], -1)], -2)
    V = torch.stack([torch.stack([cV, sV], -1),
                     torch.stack([-sV, cV], -1)], -2)
    return U, torch.stack([Q + R, Q - R], -1), V


def _svd3x3_impl(A: torch.Tensor, sweeps: int):
    _, V = eigh3x3(mm33(A.transpose(-1, -2), A), sweeps)
    sgn = torch.where(det3(V) < 0, -1.0, 1.0)
    V = torch.cat([V[..., :, :2], (sgn[..., None] * V[..., :, 2])[..., None]],
                  -1)
    B = mm33(A, V)                                   # = U diag(s)
    eps = 1e-12
    b0x, b0y, b0z = B[..., 0, 0], B[..., 1, 0], B[..., 2, 0]
    b1x, b1y, b1z = B[..., 0, 1], B[..., 1, 1], B[..., 2, 1]
    b2x, b2y, b2z = B[..., 0, 2], B[..., 1, 2], B[..., 2, 2]
    s0 = torch.sqrt(torch.clamp_min(b0x * b0x + b0y * b0y + b0z * b0z, 0.0))
    s1 = torch.sqrt(torch.clamp_min(b1x * b1x + b1y * b1y + b1z * b1z, 0.0))
    inv0 = 1.0 / torch.clamp_min(s0, eps)
    u0x, u0y, u0z = b0x * inv0, b0y * inv0, b0z * inv0
    d = b1x * u0x + b1y * u0y + b1z * u0z
    w1x, w1y, w1z = b1x - d * u0x, b1y - d * u0y, b1z - d * u0z
    n1 = torch.sqrt(torch.clamp_min(w1x * w1x + w1y * w1y + w1z * w1z, 0.0))
    # fallback direction for a degenerate second column: any vector
    # orthogonal to u0, cross(u0, e_x) = (0, u0z, -u0y) or
    # cross(u0, e_y) = (-u0z, 0, u0x)
    na = torch.sqrt(u0y * u0y + u0z * u0z)
    use_ex = na > 1e-6
    ax = torch.where(use_ex, 0.0, -u0z)
    ay = torch.where(use_ex, u0z, 0.0)
    az = torch.where(use_ex, -u0y, u0x)
    inva = 1.0 / torch.clamp_min(torch.sqrt(ax * ax + ay * ay + az * az), eps)
    ok1 = n1 > 1e-8
    inv1 = 1.0 / torch.clamp_min(n1, eps)
    u1x = torch.where(ok1, w1x * inv1, ax * inva)
    u1y = torch.where(ok1, w1y * inv1, ay * inva)
    u1z = torch.where(ok1, w1z * inv1, az * inva)
    # right-handed completion: det U = +1
    u2x = u0y * u1z - u0z * u1y
    u2y = u0z * u1x - u0x * u1z
    u2z = u0x * u1y - u0y * u1x
    # degenerate first column (A ~ 0): the identity frame
    tiny = s0 < 1e-12
    u = [[u0x, u1x, u2x], [u0y, u1y, u2y], [u0z, u1z, u2z]]
    U = torch.stack([torch.stack([torch.where(tiny, float(i == j), u[i][j])
                                  for j in range(3)], -1)
                     for i in range(3)], -2)
    s2 = U[..., 0, 2] * b2x + U[..., 1, 2] * b2y + U[..., 2, 2] * b2z
    return U, torch.stack([s0, s1, s2], -1), V


def _skew(w01, w02, w12):
    zero = torch.zeros_like(w01)
    return torch.stack([torch.stack([zero, w01, w02], -1),
                        torch.stack([-w01, zero, w12], -1),
                        torch.stack([-w02, -w12, zero], -1)], -2)


_PAIRS = ((0, 1), (0, 2), (1, 2))


def _pair_inverses(s):
    """Per pair i < j of singular values, the clamped inverses of
    ``s_j - s_i`` and ``s_j + s_i`` that the differential divides by."""
    out = []
    for i, j in _PAIRS:
        si, sj = s[..., i], s[..., j]
        d, t = sj - si, sj + si
        m2 = si * si + sj * sj + 1e-12
        out.append((d / (d * d + 1e-8 * m2), t / (t * t + 1e-8 * m2)))
    return out


class _Svd3x3(torch.autograd.Function):
    """The SVD with the JAX package's analytic differential as its forward
    rule and that rule's transpose as its reverse rule.  With ``U^T dU =
    Om_U`` and ``V^T dV = Om_V`` (both skew) and ``P = U^T dA V``: ``ds_i =
    P_ii``, and per pair i < j the 2x2 system for ``x = Om_U[i, j]``, ``y
    = Om_V[i, j]`` is solved through ``x + y = (P_ij + P_ji) / (s_j -
    s_i)`` (singular at repeated singular values, where U and V are not
    differentiable) and ``x - y = (P_ij - P_ji) / (s_j + s_i)`` (the part
    R = U V^T consumes), each inverse clamped scale-invariantly so
    repeated or opposite singular values give 0 in place of inf.  Both
    rules are written in differentiable ops of (U, s, V), so derivatives
    of derivatives (``jvp`` of ``grad``, as a return map through an
    energy takes) compose as JAX's ``custom_jvp`` does.  ``factors``, when
    given, are the SVD of A already computed: they are returned (as
    views) in place of the sweeps."""

    @staticmethod
    def forward(A, sweeps, factors):
        if factors is None:
            return _svd3x3_impl(A, sweeps)
        return tuple(f.view_as(f) for f in factors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*output)
        ctx.save_for_backward(*output)

    @staticmethod
    def jvp(ctx, dA, _sweeps, _factors):
        U, s, V = ctx.saved_tensors
        P = mm33(mm33(U.transpose(-1, -2), dA), V)
        ds = torch.stack([P[..., 0, 0], P[..., 1, 1], P[..., 2, 2]], -1)
        om_u, om_v = [], []
        for (i, j), (a, b) in zip(_PAIRS, _pair_inverses(s)):
            pij, pji = P[..., i, j], P[..., j, i]
            xpy, xmy = (pij + pji) * a, (pij - pji) * b
            om_u.append(0.5 * (xpy + xmy))
            om_v.append(0.5 * (xpy - xmy))
        return mm33(U, _skew(*om_u)), ds, mm33(V, _skew(*om_v))

    @staticmethod
    def backward(ctx, gU, gs, gV):
        U, s, V = ctx.saved_tensors
        GU = mm33(U.transpose(-1, -2), gU)
        GV = mm33(V.transpose(-1, -2), gV)
        gP = [[gs[..., 0], None, None], [None, gs[..., 1], None],
              [None, None, gs[..., 2]]]
        for (i, j), (a, b) in zip(_PAIRS, _pair_inverses(s)):
            gu = GU[..., i, j] - GU[..., j, i]       # <G, skew>'s weight
            gv = GV[..., i, j] - GV[..., j, i]
            gxpy, gxmy = 0.5 * (gu + gv) * a, 0.5 * (gu - gv) * b
            gP[i][j], gP[j][i] = gxpy + gxmy, gxpy - gxmy
        gP = torch.stack([torch.stack(row, -1) for row in gP], -2)
        return mm33(mm33(U, gP), V.transpose(-1, -2)), None, None


def svd3x3(A: torch.Tensor, sweeps: int = 6):
    """Batched 3x3 SVD in the rotation convention: ``A = U diag(s) V^T``
    with ``det U = det V = +1`` and ``s0 >= s1 >= |s2|``, ``s2`` negative
    for reflective A.  V from the eigenvectors of A^T A; U by normalising
    the columns of A V, Gram-Schmidt completing a degenerate second column
    and crossing the first two for the third; the signed ``s2`` is the
    third column of A V projected on ``u2``.  Derivatives, forward and
    reverse, follow the closed form of :class:`_Svd3x3`."""
    return _Svd3x3.apply(A, sweeps, None)


def _svd3x3_at(A: torch.Tensor, factors):
    """:func:`svd3x3` of A with its factors known: ``factors`` must be
    ``svd3x3(A)`` of this very A (nothing checks it).  A derivative taken
    again and again at one A (the implicit solver's operator) then does
    not repeat the sweeps."""
    return _Svd3x3.apply(A, 6, factors)


def polar_decomposition(A: torch.Tensor, sweeps: int = 6):
    """``A = R S`` with R = U V^T a rotation and S = V diag(s) V^T."""
    U, s, V = svd3x3(A, sweeps)
    Vt = V.transpose(-1, -2)
    return mm33(U, Vt), mm33(V, s[..., :, None] * Vt)


def polar_newton3x3(F: torch.Tensor, iters: int = 4,
                    eps: float = 1e-6) -> torch.Tensor:
    """Orthogonal polar factor of ``[..., 3, 3]`` by determinant-scaled
    Newton iteration ``X <- (g X + X^-T / g) / 2``, ``g = |det X|^(-1/3)``,
    branch-free.  ``det`` is clamped away from 0 so degenerate F stays
    finite; for ``det F < 0`` it converges to the improper factor, as the
    JAX version does."""
    X = F
    for _ in range(iters):
        cof = cof3(X)
        det = torch.sum(X[..., :, 0] * cof[..., :, 0], -1)
        det = torch.where(det.abs() < eps,
                          torch.where(det < 0, -eps, eps), det)
        inv_t = cof / det[..., None, None]
        g = det.abs() ** (-1.0 / 3.0)
        X = 0.5 * (g[..., None, None] * X + inv_t / g[..., None, None])
    return X


def qr3x3(A: torch.Tensor):
    """3x3 QR by Gram-Schmidt: Q's first two columns from A's, the third
    their cross product, ``R = Q^T A``."""
    eps = 1e-12
    a0 = A[..., :, 0]
    q0 = a0 / torch.linalg.vector_norm(a0, dim=-1,
                                       keepdim=True).clamp_min(eps)
    a1 = A[..., :, 1]
    a1p = a1 - torch.sum(a1 * q0, -1, keepdim=True) * q0
    q1 = a1p / torch.linalg.vector_norm(a1p, dim=-1,
                                        keepdim=True).clamp_min(eps)
    q2 = torch.linalg.cross(q0, q1, dim=-1)
    Q = torch.stack([q0, q1, q2], dim=-1)
    return Q, mm33(Q.transpose(-1, -2), A)
