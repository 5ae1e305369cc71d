"""Rotations, quaternions and affine transforms (counterpart of
``zpc_tpu/math/transform.py``).

Batched and branch-free in fp32, with the JAX package's conventions:
quaternions are ``[x, y, z, w]``, matrices act on column vectors, and a
:class:`Transform` is one 4x4 matrix applied as ``p' = (M @ [p, 1])[:d]``
(the sparse grid's index-to-world map, whose translation column is the
grid origin that recentering moves).
"""

from __future__ import annotations

import dataclasses

import torch

from .vecmat import mm

__all__ = [
    "quat_identity", "quat_from_axis_angle", "quat_mul", "quat_rotate",
    "quat_to_matrix", "quat_from_matrix", "quat_normalize", "quat_slerp",
    "rotation_x", "rotation_y", "rotation_z", "euler_to_matrix",
    "Transform", "translation", "scaling", "rotation_transform",
]


def quat_identity(*, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def quat_from_axis_angle(axis: torch.Tensor,
                         angle: torch.Tensor) -> torch.Tensor:
    axis = axis / torch.linalg.vector_norm(axis, dim=-1,
                                           keepdim=True).clamp_min(1e-12)
    half = 0.5 * angle
    return torch.cat([axis * torch.sin(half)[..., None],
                      torch.cos(half)[..., None]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az, aw = (a[..., i] for i in range(4))
    bx, by, bz, bw = (b[..., i] for i in range(4))
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors by quaternions: ``v + 2 (w (u x v) + u x (u x v))``."""
    u = q[..., :3].expand(v.shape)
    w = q[..., 3:4]
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Shepperd's method without branches: the four candidate forms, the
    one of largest pivot selected by arithmetic."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1 + tr, 1 + m00 - m11 - m22,
                      1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    qw = torch.sqrt(qw.clamp_min(1e-12)) * 0.5
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    cands = torch.stack([
        torch.stack([(m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0),
                     (m10 - m01) / (4 * w0), w0], -1),
        torch.stack([x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1),
                     (m21 - m12) / (4 * x1)], -1),
        torch.stack([(m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2),
                     (m02 - m20) / (4 * y2)], -1),
        torch.stack([(m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3,
                     (m10 - m01) / (4 * z3)], -1),
    ], dim=-2)
    which = torch.argmax(qw, dim=-1)
    q = torch.take_along_dim(cands, which[..., None, None].expand(
        which.shape + (1, 4)), dim=-2)[..., 0, :]
    return quat_normalize(q)


def quat_slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    d = torch.sum(a * b, -1, keepdim=True)
    b = torch.where(d < 0, -b, b)
    d = d.abs()
    theta = torch.arccos(d.clamp(-1.0, 1.0))
    s = torch.sin(theta)
    near = s < 1e-5
    safe = torch.where(near, 1.0, s)
    wa = torch.where(near, 1.0 - t, torch.sin((1 - t) * theta) / safe)
    wb = torch.where(near, t, torch.sin(t * theta) / safe)
    return quat_normalize(wa * a + wb * b)


def _rotation(a: torch.Tensor, entries) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    vals = dict(c=c, s=s, n=-s, z=z, o=o)
    return torch.stack([vals[e] for e in entries], -1).reshape(
        a.shape + (3, 3))


def rotation_x(a: torch.Tensor) -> torch.Tensor:
    return _rotation(a, "ozzzcnzsc")


def rotation_y(a: torch.Tensor) -> torch.Tensor:
    return _rotation(a, "czszoznzc")


def rotation_z(a: torch.Tensor) -> torch.Tensor:
    return _rotation(a, "cnzsczzzo")


def euler_to_matrix(rx: torch.Tensor, ry: torch.Tensor,
                    rz: torch.Tensor) -> torch.Tensor:
    return mm(mm(rotation_z(rz), rotation_y(ry)), rotation_x(rx))


@dataclasses.dataclass(frozen=True)
class Transform:
    """4x4 affine matrix applied to points as ``p' = (M @ [p, 1])[:d]``;
    the dimension follows the points, so the same carrier serves 2-D
    grids."""

    matrix: torch.Tensor  # [4, 4]

    @staticmethod
    def identity(*, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> "Transform":
        return Transform(torch.eye(4, dtype=dtype, device=device))

    def apply(self, p: torch.Tensor) -> torch.Tensor:
        d = p.shape[-1]
        return p @ self.matrix[:d, :d].T + self.matrix[:d, 3]

    def apply_vector(self, v: torch.Tensor) -> torch.Tensor:
        """Vectors: no translation."""
        d = v.shape[-1]
        return v @ self.matrix[:d, :d].T

    def inverse(self) -> "Transform":
        R = self.matrix[:3, :3]
        t = self.matrix[:3, 3]
        Rinv = torch.linalg.inv(R)
        M = torch.eye(4, dtype=self.matrix.dtype, device=self.matrix.device)
        M[:3, :3] = Rinv
        M[:3, 3] = -(Rinv @ t)
        return Transform(M)

    def compose(self, other: "Transform") -> "Transform":
        return Transform(self.matrix @ other.matrix)


def translation(t, *, device: torch.device) -> Transform:
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    M = torch.eye(4, dtype=torch.float32, device=device)
    M[:t.shape[0], 3] = t
    return Transform(M)


def scaling(s, *, device: torch.device) -> Transform:
    s = torch.as_tensor(s, dtype=torch.float32, device=device).expand(3)
    M = torch.diag(torch.cat([s, torch.ones(1, device=device)]))
    return Transform(M)


def rotation_transform(R, *, device: torch.device) -> Transform:
    M = torch.eye(4, dtype=torch.float32, device=device)
    M[:3, :3] = torch.as_tensor(R, dtype=torch.float32, device=device)
    return Transform(M)
