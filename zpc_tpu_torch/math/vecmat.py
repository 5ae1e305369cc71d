"""Small-matrix helpers (counterpart of ``zpc_tpu/math/vecmat.py``).

2x2 and 3x3 products are unrolled into elementwise fp32 multiply-adds, as
in the JAX package: no batched tiny matmul, and no TF32 path that could
drop mantissa bits.
"""

from __future__ import annotations

import torch

__all__ = ["mm", "mm33", "det3", "cof3", "mv", "outer", "trace",
           "frobenius", "identity_like", "cross_matrix"]


def mm33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 @ 3x3, unrolled."""
    rows = []
    for i in range(3):
        rows.append(torch.stack(
            [a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j] +
             a[..., i, 2] * b[..., 2, j] for j in range(3)], -1))
    return torch.stack(rows, -2)


def mm22(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 2x2 @ 2x2, unrolled."""
    rows = []
    for i in range(2):
        rows.append(torch.stack(
            [a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
             for j in range(2)], -1))
    return torch.stack(rows, -2)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched small-matrix product at full fp32 precision."""
    if a.shape[-2:] == (3, 3) and b.shape[-2:] == (3, 3):
        return mm33(a, b)
    if a.shape[-2:] == (2, 2) and b.shape[-2:] == (2, 2):
        return mm22(a, b)
    return torch.matmul(a, b)


def det3(A: torch.Tensor) -> torch.Tensor:
    """Cofactor-expansion determinant of ``[..., 3, 3]`` (or the 2x2
    determinant of ``[..., 2, 2]``)."""
    if A.shape[-1] == 2:
        return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] -
                            A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] -
                              A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] -
                              A[..., 1, 1] * A[..., 2, 0]))


def cof3(F: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix ``J F^-T`` of ``[..., 3, 3]`` from column cross
    products, or of ``[..., 2, 2]`` in closed form (valid for singular
    F)."""
    if F.shape[-1] == 2:
        a, b = F[..., 0, 0], F[..., 0, 1]
        c, d = F[..., 1, 0], F[..., 1, 1]
        return torch.stack([torch.stack([d, -c], -1),
                            torch.stack([-b, a], -1)], -2)
    c0 = torch.linalg.cross(F[..., :, 1], F[..., :, 2], dim=-1)
    c1 = torch.linalg.cross(F[..., :, 2], F[..., :, 0], dim=-1)
    c2 = torch.linalg.cross(F[..., :, 0], F[..., :, 1], dim=-1)
    return torch.stack([c0, c1, c2], dim=-1)


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched small-matrix @ vector, as elementwise products."""
    return torch.sum(a * v[..., None, :], -1)


def outer(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u[..., :, None] * v[..., None, :]


def trace(A: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)


def frobenius(A: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(A * A, (-2, -1)))


def identity_like(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(A.shape[-1], dtype=A.dtype,
                     device=A.device).expand(A.shape)


def cross_matrix(w: torch.Tensor) -> torch.Tensor:
    """Skew matrix ``[w]_x`` with ``[w]_x v = w x v``."""
    zero = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zero, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zero, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zero], -1),
    ], -2)
