"""Polar decomposition for the corotated stress (counterpart of
``polar_newton3x3`` in ``zpc_tpu/math/svd.py``)."""

from __future__ import annotations

import torch

from .vecmat import cof3

__all__ = ["polar_newton3x3"]


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
