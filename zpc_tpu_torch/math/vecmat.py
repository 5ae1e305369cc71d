"""Small-matrix helpers (counterpart of ``zpc_tpu/math/vecmat.py``).

3x3 products are unrolled into elementwise fp32 multiply-adds, as in the
JAX package: no batched tiny matmul, and no TF32 path that could drop
mantissa bits.
"""

from __future__ import annotations

import torch

__all__ = ["mm", "mm33", "det3", "cof3"]


def mm33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 @ 3x3, unrolled."""
    rows = []
    for i in range(3):
        rows.append(torch.stack(
            [a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j] +
             a[..., i, 2] * b[..., 2, j] for j in range(3)], -1))
    return torch.stack(rows, -2)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched small-matrix product at full fp32 precision."""
    if a.shape[-2:] == (3, 3) and b.shape[-2:] == (3, 3):
        return mm33(a, b)
    return torch.matmul(a, b)


def det3(A: torch.Tensor) -> torch.Tensor:
    """Cofactor-expansion determinant of ``[..., 3, 3]``."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] -
                            A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] -
                              A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] -
                              A[..., 1, 1] * A[..., 2, 0]))


def cof3(F: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix ``J F^-T`` of ``[..., 3, 3]`` from column cross
    products (valid for singular F)."""
    c0 = torch.linalg.cross(F[..., :, 1], F[..., :, 2], dim=-1)
    c1 = torch.linalg.cross(F[..., :, 2], F[..., :, 0], dim=-1)
    c2 = torch.linalg.cross(F[..., :, 0], F[..., :, 1], dim=-1)
    return torch.stack([c0, c1, c2], dim=-1)
