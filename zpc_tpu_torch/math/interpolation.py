"""B-spline interpolation weights (counterpart of
``zpc_tpu/math/interpolation.py``): linear, quadratic and cubic kernels,
per axis, as small dense vectors over the stencil's nodes."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["stencil_size", "base_node", "linear_bspline_weights",
           "quadratic_bspline_weights", "cubic_bspline_weights",
           "bspline_weights"]

_STENCIL = {1: 2, 2: 3, 3: 4}


def stencil_size(order: int) -> int:
    return _STENCIL[order]


def base_node(x_over_dx: torch.Tensor, order: int) -> torch.Tensor:
    """Leftmost stencil node as int32: ``floor(x)`` (linear), ``floor(x -
    0.5)`` (quadratic), ``floor(x) - 1`` (cubic)."""
    if order == 1:
        return torch.floor(x_over_dx).to(torch.int32)
    if order == 2:
        return torch.floor(x_over_dx - 0.5).to(torch.int32)
    if order == 3:
        return torch.floor(x_over_dx).to(torch.int32) - 1
    raise ValueError(order)


def linear_bspline_weights(fx: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fx = x/dx - base``: weights over 2 nodes and d(weight)/d(fx)."""
    one = torch.ones_like(fx)
    return torch.stack([1.0 - fx, fx], -1), torch.stack([-one, one], -1)


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


def cubic_bspline_weights(fx: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fx = x/dx - (base + 1)`` in [0, 1): weights over the 4 nodes at
    distances ``1 + fx, fx, 1 - fx, 2 - fx`` and d(weight)/d(fx)."""
    def far(d):    # 1 <= |d| < 2
        return (2.0 - d) ** 3 / 6.0

    def near(d):   # |d| < 1
        return 0.5 * d ** 3 - d * d + 2.0 / 3.0

    def dfar(d):
        return -0.5 * (2.0 - d) ** 2

    def dnear(d):
        return 1.5 * d * d - 2.0 * d

    d0, d1, d2, d3 = 1.0 + fx, fx, 1.0 - fx, 2.0 - fx
    w = torch.stack([far(d0), near(d1), near(d2), far(d3)], -1)
    dw = torch.stack([dfar(d0), dnear(d1), -dnear(d2), -dfar(d3)], -1)
    return w, dw


def bspline_weights(x_over_dx: torch.Tensor, order: int = 2):
    """Per-axis weights for a normalized position: ``(base [..., dim]
    int32, w [..., dim, S], dw [..., dim, S])``, dw in grid units."""
    base = base_node(x_over_dx, order)
    if order == 1:
        w, dw = linear_bspline_weights(x_over_dx - base)
    elif order == 2:
        w, dw = quadratic_bspline_weights(x_over_dx - base)
    else:
        w, dw = cubic_bspline_weights(x_over_dx - (base + 1))
    return base, w, dw
