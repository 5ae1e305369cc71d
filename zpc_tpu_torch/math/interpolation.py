"""B-spline interpolation weights (counterpart of
``zpc_tpu/math/interpolation.py``); the port carries the quadratic kernel,
which is the one the MPM path uses."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["stencil_size", "base_node", "quadratic_bspline_weights",
           "bspline_weights"]

_STENCIL = {1: 2, 2: 3, 3: 4}


def stencil_size(order: int) -> int:
    return _STENCIL[order]


def _require_quadratic(order: int) -> None:
    if order != 2:
        raise NotImplementedError(
            f"only quadratic (order 2) B-splines are ported, got {order}")


def base_node(x_over_dx: torch.Tensor, order: int) -> torch.Tensor:
    """Leftmost stencil node ``floor(x/dx - 0.5)`` for the quadratic
    kernel, as int32."""
    _require_quadratic(order)
    return torch.floor(x_over_dx - 0.5).to(torch.int32)


def quadratic_bspline_weights(fx: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fx = x/dx - base`` in [0.5, 1.5): weights over 3 nodes and their
    derivatives d(weight)/d(fx)."""
    w0 = 0.5 * (1.5 - fx) ** 2
    w1 = 0.75 - (fx - 1.0) ** 2
    w2 = 0.5 * (fx - 0.5) ** 2
    dw0 = fx - 1.5
    dw1 = -2.0 * (fx - 1.0)
    dw2 = fx - 0.5
    return (torch.stack([w0, w1, w2], -1), torch.stack([dw0, dw1, dw2], -1))


def bspline_weights(x_over_dx: torch.Tensor, order: int = 2):
    """Per-axis weights for a normalized position: ``(base [..., dim]
    int32, w [..., dim, 3], dw [..., dim, 3])``, dw in grid units."""
    base = base_node(x_over_dx, order)
    w, dw = quadratic_bspline_weights(x_over_dx - base)
    return base, w, dw
