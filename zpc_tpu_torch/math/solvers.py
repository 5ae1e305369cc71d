"""Matrix-free iterative solvers (counterpart of ``zpc_tpu/math/solvers.py``):
preconditioned conjugate gradient, conjugate residual and MinRes.

The operator contract is plain callables over a *dof view*: a tensor, or a
tuple, list or dict of dof views, so the same solver runs the 128^3 Poisson
problem and the implicit-MPM grid unknowns ``[nb, 64, 3]``.  Every inner
product is an fp32 sum over all leaves.

The JAX package's ``lax.while_loop`` is a host loop here, with the same
stopping rule and the same guards against a zero denominator.  Deciding
whether to go on reads one scalar from the device on every iteration (one
device-to-host synchronisation per iteration, as ``adaptive_chain`` has one
per step); the iteration count is a host integer.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["SolveResult", "cg", "conjugate_residual", "minres", "dot",
           "axpy"]


def _map(fn, *views):
    """``fn`` over the leaves of dof views of one structure."""
    v = views[0]
    if isinstance(v, torch.Tensor):
        return fn(*views)
    if isinstance(v, dict):
        return {k: _map(fn, *(w[k] for w in views)) for k in v}
    if isinstance(v, (tuple, list)):
        return type(v)(_map(fn, *(w[i] for w in views))
                       for i in range(len(v)))
    raise TypeError(f"a dof view is a tensor, tuple, list or dict, not "
                    f"{type(v).__name__}")


def _leaves(v):
    if isinstance(v, torch.Tensor):
        return [v]
    # dict leaves in sorted-key order, as JAX flattens a dict
    items = [v[k] for k in sorted(v)] if isinstance(v, dict) else v
    return [leaf for w in items for leaf in _leaves(w)]


def dot(a, b) -> torch.Tensor:
    """Inner product over every leaf of two dof views, in fp32."""
    sums = _leaves(_map(lambda x, y: torch.sum(x.float() * y.float()), a, b))
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    return out


def axpy(alpha, x, y):
    """``y + alpha x`` over dof views."""
    return _map(lambda xi, yi: yi + alpha * xi, x, y)


class SolveResult(NamedTuple):
    x: object                 # the solution (a dof view)
    iters: int                # iterations taken
    residual: torch.Tensor    # final |r|^2 (preconditioned r.z for cg)
    converged: torch.Tensor   # 0-d bool


def _identity(v):
    return v


def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d == 0, 1.0, d)


def cg(A: Callable, b, x0=None, *, project: Optional[Callable] = None,
       precondition: Optional[Callable] = None, max_iters: int = 100,
       rel_tol: float = 1e-4, abs_tol: float = 0.0) -> SolveResult:
    """Preconditioned conjugate gradient.  ``A``: x -> A x; ``project``
    zeroes Dirichlet dofs; ``precondition``: r -> M^-1 r.  Iterates while
    ``r.z > max(rel_tol^2 r0.z0, abs_tol)`` and fewer than ``max_iters``
    iterations have run."""
    project = project or _identity
    precondition = precondition or _identity
    x = _map(torch.zeros_like, b) if x0 is None else x0
    r = project(axpy(-1.0, A(x), b))
    z = project(precondition(r))
    p = z
    zTr = dot(z, r)
    threshold = torch.clamp_min(rel_tol * rel_tol * zTr, abs_tol)
    thr = threshold.item()
    it = 0
    while it < max_iters and zTr.item() > thr:
        Ap = project(A(p))
        alpha = zTr / _safe(dot(p, Ap))
        x = axpy(alpha, p, x)
        r = axpy(-alpha, Ap, r)
        z = project(precondition(r))
        zTr_new = dot(z, r)
        beta = zTr_new / _safe(zTr)
        p = axpy(beta, p, z)
        zTr = zTr_new
        it += 1
    return SolveResult(x, it, zTr, zTr <= threshold)


def conjugate_residual(A: Callable, b, x0=None, *,
                       project: Optional[Callable] = None,
                       max_iters: int = 100, rel_tol: float = 1e-4
                       ) -> SolveResult:
    """Conjugate residual, for symmetric (possibly indefinite) systems:
    minimises |r|; iterates while ``|r|^2 > rel_tol^2 |r0|^2``."""
    project = project or _identity
    x = _map(torch.zeros_like, b) if x0 is None else x0
    r = project(axpy(-1.0, A(x), b))
    p = r
    Ap = project(A(r))
    rAr = dot(r, Ap)
    threshold = rel_tol * rel_tol * dot(r, r)
    thr = threshold.item()
    it = 0
    while it < max_iters and dot(r, r).item() > thr:
        alpha = rAr / _safe(dot(Ap, Ap))
        x = axpy(alpha, p, x)
        r = axpy(-alpha, Ap, r)
        Ar = project(A(r))
        rAr_new = dot(r, Ar)
        beta = rAr_new / _safe(rAr)
        p = axpy(beta, p, r)
        Ap = axpy(beta, Ap, Ar)
        rAr = rAr_new
        it += 1
    rr = dot(r, r)
    return SolveResult(x, it, rr, rr <= threshold)


def minres(A: Callable, b, x0=None, *, project: Optional[Callable] = None,
           max_iters: int = 100, rel_tol: float = 1e-4) -> SolveResult:
    """MinRes for symmetric indefinite systems: the Lanczos recurrence with
    Givens rotations; iterates while ``|eta| > rel_tol |r0|``."""
    project = project or _identity
    x = _map(torch.zeros_like, b) if x0 is None else x0
    r = project(axpy(-1.0, A(x), b))
    beta = torch.sqrt(torch.clamp_min(dot(r, r), 0.0))
    threshold = rel_tol * beta
    thr = threshold.item()
    one = torch.ones_like(beta)
    zero = torch.zeros_like(beta)
    v_prev = d_prev = d_pprev = _map(torch.zeros_like, b)
    beta0 = _safe(beta)
    v = _map(lambda t: t / beta0, r)
    c, s, c2, s2 = one, zero, one, zero       # the last two rotations
    eta = beta
    it = 0
    while it < max_iters and eta.abs().item() > thr:
        Av = project(A(v))
        alpha = dot(v, Av)
        w = axpy(-alpha, v, axpy(-beta, v_prev, Av))
        beta_new = torch.sqrt(torch.clamp_min(dot(w, w), 0.0))
        bn = _safe(beta_new)
        v_new = _map(lambda t: t / bn, w)
        # the previous two rotations applied to the new column
        delta = c * alpha - c2 * s * beta
        rho2 = s * alpha + c2 * c * beta
        rho3 = s2 * beta
        rho1 = torch.sqrt(delta * delta + beta_new * beta_new)
        r1 = _safe(rho1)
        c_new = delta / r1
        s_new = beta_new / r1
        dvec = _map(lambda vv, dp, dpp: (vv - rho2 * dp - rho3 * dpp) / r1,
                    v, d_prev, d_pprev)
        x = axpy(c_new * eta, dvec, x)
        eta = -s_new * eta
        v_prev, v, d_pprev, d_prev = v, v_new, d_prev, dvec
        beta, c2, s2, c, s = beta_new, c, s, c_new, s_new
        it += 1
    return SolveResult(x, it, eta * eta, eta.abs() <= threshold)
