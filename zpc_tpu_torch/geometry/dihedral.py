"""Dihedral-angle kernels for hinge bending (counterpart of
``zpc_tpu/geometry/dihedral.py``).

The signed angle of the hinge ``(v2, v0, v1, v3)`` (triangles (v2, v0, v1)
and (v0, v1, v3) sharing the edge v0-v1) in the ``atan2`` form, its
12-gradient and 12x12 Hessian, and the discrete hinge bending energy on
them.  Derivatives come from autograd through the angle, batched over
hinges as :mod:`zpc_tpu_torch.geometry.contact` takes them: the gradient
by ``torch.autograd.grad`` of the summed per-hinge angle over a detached
leaf, the Hessians by ``torch.func.vmap(torch.func.hessian(...))`` over
the flattened hinges.  Vertex order in the 12-vectors is
``(v2, v0, v1, v3)``.

A degenerate hinge (a zero shared edge, or a triangle of zero area) has
both ``atan2`` arguments zero.  There JAX's derivative of ``atan2`` is
NaN and torch's is zero, so the port's gradient is zero where the JAX
package's is NaN (tests/test_torch_dihedral.py holds both).
"""

from __future__ import annotations

import math

import torch

from .contact import _batched_grad, _batched_hess
from .distance import _cross

__all__ = [
    "dihedral_angle", "dihedral_angle_gradient", "dihedral_angle_hessian",
    "hinge_bending_energy", "hinge_bending_gradient",
    "hinge_bending_hessian",
]


def _angle_x12(x12):
    v2, v0, v1, v3 = (x12[..., 0:3], x12[..., 3:6],
                      x12[..., 6:9], x12[..., 9:12])
    n1 = _cross(v0 - v2, v1 - v2)
    n2 = _cross(v1 - v3, v0 - v3)
    e = v0 - v1
    # (n2 x n1) is parallel to the shared edge: its projection on the unit
    # edge is |n1||n2| sin(theta) with the reference's sign
    sin_s = torch.sum(_cross(n2, n1) * e, -1) / torch.clamp_min(
        torch.linalg.vector_norm(e, dim=-1), 1e-30)
    cos_s = torch.sum(n1 * n2, -1)
    return torch.atan2(sin_s, cos_s)


def _stack(v2, v0, v1, v3):
    return torch.cat(torch.broadcast_tensors(v2, v0, v1, v3), -1)


def dihedral_angle(v2, v0, v1, v3, branch: int = 0):
    """Signed hinge angle in (-pi, pi); ``branch`` +1/-1 shifts it to
    (0, 2pi) / (-2pi, 0)."""
    theta = _angle_x12(_stack(v2, v0, v1, v3))
    if branch > 0:
        theta = torch.where(theta < 0, theta + 2 * math.pi, theta)
    elif branch < 0:
        theta = torch.where(theta > 0, theta - 2 * math.pi, theta)
    return theta


def dihedral_angle_gradient(v2, v0, v1, v3) -> torch.Tensor:
    """d theta / d(v2, v0, v1, v3) as ``[..., 12]``."""
    return _batched_grad(_angle_x12, _stack(v2, v0, v1, v3))


def dihedral_angle_hessian(v2, v0, v1, v3) -> torch.Tensor:
    """``[..., 12, 12]`` hinge Hessian."""
    return _batched_hess(_angle_x12, _stack(v2, v0, v1, v3))


def hinge_bending_energy(v2, v0, v1, v3, rest_angle, stiffness):
    """Discrete hinge bending ``k (theta - theta_rest)^2``."""
    d = dihedral_angle(v2, v0, v1, v3) - rest_angle
    return stiffness * d * d


def hinge_bending_gradient(v2, v0, v1, v3, rest_angle, stiffness):
    """``[..., 12]`` energy gradient ``2k (theta - rest) dtheta``."""
    theta = dihedral_angle(v2, v0, v1, v3)
    g = dihedral_angle_gradient(v2, v0, v1, v3)
    return (2.0 * stiffness * (theta - rest_angle))[..., None] * g


def hinge_bending_hessian(v2, v0, v1, v3, rest_angle, stiffness):
    """``[..., 12, 12]`` energy Hessian ``2k (g g^T + (theta - rest) H)``."""
    theta = dihedral_angle(v2, v0, v1, v3)
    g = dihedral_angle_gradient(v2, v0, v1, v3)
    H = dihedral_angle_hessian(v2, v0, v1, v3)
    outer = g[..., :, None] * g[..., None, :]
    k = torch.as_tensor(stiffness)
    k = k[..., None, None] if k.dim() else k
    return 2.0 * k * (outer + (theta - rest_angle)[..., None, None] * H)
