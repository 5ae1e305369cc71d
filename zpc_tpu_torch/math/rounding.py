"""Float32 arithmetic that rounds the same on every device: division and
square root rounded once, cross and dot products summed in one order.

PyTorch's CUDA float32 ``sqrt`` is not correctly rounded: on an H100, 784
of 4,096 square roots of sums of squares differ from the CPU's by an ulp.
A float32 division or square root taken in float64 and rounded to float32
is correctly rounded (float64 carries more than 2 x 24 + 2 bits, so the
second rounding is innocuous), on the CPU and on the card alike.  A cross
or dot product written as separate multiplies and adds is not contracted
into FMAs and sums in one order, where a reduction over the last axis
sums in the device's order.  Paths whose card results must equal the
CPU's bit for bit use these.
"""

from __future__ import annotations

import torch

__all__ = ["div_rn", "sqrt_rn", "cross", "dot"]


def div_rn(a, b) -> torch.Tensor:
    """``a / b`` for float32 tensors (or a Python number and a tensor),
    rounded once, on the tensor's device."""
    dev = (a if isinstance(a, torch.Tensor) else b).device
    a = torch.as_tensor(a, device=dev)
    b = torch.as_tensor(b, device=dev)
    return (a.double() / b.double()).to(torch.promote_types(a.dtype,
                                                            b.dtype))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(x)`` for a float32 tensor, rounded once."""
    return torch.sqrt(x.double()).to(x.dtype)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x b`` over the last axis (3)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` over the last axis (3), summed x, y, then z."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])
