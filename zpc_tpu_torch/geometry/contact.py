"""IPC contact kernels: distance gradients and Hessians, the barrier, the
edge-edge mollifier and friction (counterpart of
``zpc_tpu/geometry/contact.py``).

The per-region closed forms of the reference come from autograd through
the branch-free clamped projections of :mod:`zpc_tpu_torch.geometry.
distance`: gradients by ``torch.autograd.grad`` of the summed per-lane
scalar, 12x12 Hessians by ``torch.func.vmap(torch.func.hessian(...))``
over the flattened lanes (forward over reverse, as the JAX package's
``jax.hessian``).  :func:`spd_project` clamps eigenvalues through
``torch.linalg.eigh``, as the JAX package does through XLA's eigh.

The barrier and its derivatives evaluate on a safe value
(``where(inside, d2, dhat2)``) and select afterwards, so the branch that
is not taken never sees a log of zero.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .distance import _cross, edge_edge_dist2, point_triangle_dist2

__all__ = [
    "pt_dist2_grad", "pt_dist2_hess", "ee_dist2_grad", "ee_dist2_hess",
    "spd_project", "barrier", "barrier_grad", "barrier_hess",
    "edge_edge_mollifier", "edge_edge_mollifier_grad",
    "pt_tangent_basis", "ee_tangent_basis",
    "friction_f0", "friction_f1_over_x", "relative_displacement_pt",
    "relative_displacement_ee",
]


def _split4(x12):
    return x12[..., 0:3], x12[..., 3:6], x12[..., 6:9], x12[..., 9:12]


def _pt_d2_stacked(x12):
    return point_triangle_dist2(*_split4(x12))


def _ee_d2_stacked(x12):
    return edge_edge_dist2(*_split4(x12))


def _batched_grad(f: Callable, x12: torch.Tensor) -> torch.Tensor:
    """Per-lane gradient of an elementwise scalar f over [..., 12]."""
    with torch.enable_grad():
        z = x12.detach().requires_grad_(True)
        return torch.autograd.grad(f(z).sum(), z)[0]


def _batched_hess(f: Callable, x12: torch.Tensor) -> torch.Tensor:
    """Per-lane 12x12 Hessians over [..., 12] (forward over reverse)."""
    flat = x12.reshape(-1, 12)
    h = torch.func.vmap(torch.func.hessian(lambda z: f(z[None])[0]))(flat)
    return h.reshape(x12.shape[:-1] + (12, 12))


def pt_dist2_grad(p, t0, t1, t2) -> torch.Tensor:
    """d(dist^2)/d[p, t0, t1, t2] -> [..., 12], every region."""
    return _batched_grad(_pt_d2_stacked, torch.cat([p, t0, t1, t2], -1))


def pt_dist2_hess(p, t0, t1, t2) -> torch.Tensor:
    """d^2(dist^2)/dx^2 -> [..., 12, 12]."""
    return _batched_hess(_pt_d2_stacked, torch.cat([p, t0, t1, t2], -1))


def ee_dist2_grad(p0, p1, q0, q1) -> torch.Tensor:
    return _batched_grad(_ee_d2_stacked, torch.cat([p0, p1, q0, q1], -1))


def ee_dist2_hess(p0, p1, q0, q1) -> torch.Tensor:
    return _batched_hess(_ee_d2_stacked, torch.cat([p0, p1, q0, q1], -1))


def spd_project(H: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Project symmetric [..., n, n] onto the PSD cone (eigenvalue
    clamping), the reference's make_pd before a Newton system."""
    Hs = 0.5 * (H + H.transpose(-1, -2))
    w, V = torch.linalg.eigh(Hs)
    w = torch.clamp_min(w, eps)
    return torch.einsum("...ij,...j,...kj->...ik", V, w, V)


# -- IPC barrier -------------------------------------------------------------

def barrier(d2, dhat2, kappa=1.0):
    """IPC barrier b(d^2) = -kappa (d2 - dhat2)^2 log(d2 / dhat2), 0 beyond
    dhat (the squared-distance form)."""
    d2 = torch.as_tensor(d2)
    inside = (d2 < dhat2) & (d2 > 0)
    safe = torch.where(inside, d2, dhat2)
    val = -kappa * (safe - dhat2) ** 2 * torch.log(safe / dhat2)
    return torch.where(inside, val, 0.0)


def barrier_grad(d2, dhat2, kappa=1.0):
    """db / d(d^2)."""
    d2 = torch.as_tensor(d2)
    inside = (d2 < dhat2) & (d2 > 0)
    safe = torch.where(inside, d2, dhat2)
    g = -kappa * (2.0 * (safe - dhat2) * torch.log(safe / dhat2)
                  + (safe - dhat2) ** 2 / safe)
    return torch.where(inside, g, 0.0)


def barrier_hess(d2, dhat2, kappa=1.0):
    """d^2 b / d(d^2)^2 (analytic; grows without bound as d2 -> 0, 0 at
    dhat)."""
    d2 = torch.as_tensor(d2)
    inside = (d2 < dhat2) & (d2 > 0)
    s = torch.where(inside, d2, dhat2)
    h = -kappa * (2.0 * torch.log(s / dhat2) + 2.0 * (s - dhat2) / s
                  + (s - dhat2) * (s + dhat2) / (s * s))
    return torch.where(inside, h, 0.0)


# -- edge-edge mollifier (parallel-edge degeneracy) ---------------------------

def edge_edge_mollifier(p0, p1, q0, q1, rest_e0, rest_e1, thresh=1e-3):
    """IPC mollifier e(x): zeroes the edge-edge barrier smoothly as the
    edges turn parallel.  c = |e0 x e1|^2 against eps = thresh |rest_e0|^2
    |rest_e1|^2: e = (2 - c/eps) c/eps for c < eps, else 1."""
    e0 = p1 - p0
    e1 = q1 - q0
    c = torch.sum(_cross(e0, e1) ** 2, -1)
    eps = thresh * torch.sum(rest_e0 * rest_e0, -1) * \
        torch.sum(rest_e1 * rest_e1, -1)
    r = c / torch.clamp_min(eps, 1e-30)
    return torch.where(c < eps, (2.0 - r) * r, 1.0)


def edge_edge_mollifier_grad(p0, p1, q0, q1, rest_e0, rest_e1,
                             thresh=1e-3) -> torch.Tensor:
    def f(z):
        a0, a1, b0, b1 = _split4(z)
        return edge_edge_mollifier(a0, a1, b0, b1, rest_e0, rest_e1, thresh)

    return _batched_grad(f, torch.cat([p0, p1, q0, q1], -1))


# -- friction (Friction.hpp) --------------------------------------------------

def _orthonormal_basis(n):
    """Two unit tangents orthogonal to the unit normal n (branch-free)."""
    # the axis least aligned with n
    ex = n.new_tensor([1.0, 0.0, 0.0]).expand(n.shape)
    ey = n.new_tensor([0.0, 1.0, 0.0]).expand(n.shape)
    ax = torch.where(n[..., 0:1].abs() < 0.5, ex, ey)
    t0 = _cross(n, ax)
    t0 = t0 / torch.clamp_min(
        torch.linalg.vector_norm(t0, dim=-1, keepdim=True), 1e-30)
    t1 = _cross(n, t0)
    return t0, t1


def _unit_normal(n):
    return n / torch.clamp_min(
        torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-30)


def pt_tangent_basis(p, t0, t1, t2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tangent basis of the point-triangle contact plane [..., 3] x2
    (Friction.hpp point_triangle_tangent_basis)."""
    return _orthonormal_basis(_unit_normal(_cross(t1 - t0, t2 - t0)))


def ee_tangent_basis(p0, p1, q0, q1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tangent basis of the edge-edge contact (normal = cross of the
    edges)."""
    return _orthonormal_basis(_unit_normal(_cross(p1 - p0, q1 - q0)))


def relative_displacement_pt(dp, dt0, dt1, dt2, bary) -> torch.Tensor:
    """Point-against-triangle relative displacement at the closest point
    (Friction.hpp relDX): dp - sum_i bary_i dt_i."""
    return dp - (bary[..., 0:1] * dt0 + bary[..., 1:2] * dt1 +
                 bary[..., 2:3] * dt2)


def relative_displacement_ee(dp0, dp1, dq0, dq1, s, t) -> torch.Tensor:
    a = dp0 + s[..., None] * (dp1 - dp0)
    b = dq0 + t[..., None] * (dq1 - dq0)
    return a - b


def friction_f0(y, epsvh):
    """IPC C1 smooth friction mollifier f0 (Friction.hpp f0_SF):
    y^2 (1 - y / (3 epsvh)) / epsvh + epsvh / 3 for y < epsvh, y beyond."""
    y = torch.as_tensor(y)
    inside = y < epsvh
    return torch.where(inside,
                       y * y * (1.0 - y / (3.0 * epsvh)) / epsvh
                       + epsvh / 3.0, y)


def friction_f1_over_x(y, epsvh):
    """f0'(y) / y, the force scale (Friction.hpp f1_SF_div_relDXNorm):
    (2 - y / epsvh) / epsvh for y < epsvh, else 1 / y."""
    y = torch.as_tensor(y)
    inside = y < epsvh
    return torch.where(inside, (2.0 - y / epsvh) / epsvh,
                       1.0 / torch.clamp_min(y, 1e-30))
