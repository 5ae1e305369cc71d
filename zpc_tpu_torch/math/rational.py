"""Exact int32 fractions (counterpart of ``zpc_tpu/math/rational.py``):
batched ``num / den`` pairs, normalised by a binary gcd with a fixed trip
count.  Products wrap mod 2^32 as int32 does; ``compare`` is exact while
the cross products fit.  For wider values use
:class:`~zpc_tpu_torch.math.bigint.RationalW`; ``to_fractions`` is host
code.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import torch

__all__ = ["Rational", "rational", "gcd"]


def gcd(a: torch.Tensor, b: torch.Tensor, iters: int = 32) -> torch.Tensor:
    """Batched gcd of |a| and |b| by ``iters`` Euclid steps (at least 1)."""
    a, b = a.abs(), b.abs()
    for _ in range(iters):
        bz = b == 0
        bs = torch.where(bz, 1, b)
        a, b = torch.where(bz, a, bs), torch.where(bz, 0, a % bs)
    return torch.clamp(a, min=1)


@dataclasses.dataclass(frozen=True)
class Rational:
    """Batched fraction ``num / den`` (int32), ``den > 0`` once
    normalised."""

    num: torch.Tensor
    den: torch.Tensor

    def normalized(self) -> "Rational":
        g = gcd(self.num, self.den)
        sgn = torch.where(self.den < 0, -1, 1).to(self.num.dtype)
        return Rational(torch.div(self.num, g, rounding_mode="floor") * sgn,
                        torch.div(self.den.abs(), g, rounding_mode="floor"))

    def __add__(self, o: "Rational") -> "Rational":
        return Rational(self.num * o.den + o.num * self.den,
                        self.den * o.den).normalized()

    def __sub__(self, o: "Rational") -> "Rational":
        return Rational(self.num * o.den - o.num * self.den,
                        self.den * o.den).normalized()

    def __mul__(self, o: "Rational") -> "Rational":
        return Rational(self.num * o.num, self.den * o.den).normalized()

    def __truediv__(self, o: "Rational") -> "Rational":
        return Rational(self.num * o.den, self.den * o.num).normalized()

    def __neg__(self) -> "Rational":
        return Rational(-self.num, self.den)

    def sign(self) -> torch.Tensor:
        return torch.sign(self.num)

    def compare(self, o: "Rational") -> torch.Tensor:
        """sign(self - o) without normalising."""
        return torch.sign(self.num * o.den - o.num * self.den)

    def to_float(self) -> torch.Tensor:
        return self.num.to(torch.float32) / self.den.to(torch.float32)

    def to_fractions(self):
        n = self.num.detach().cpu().reshape(-1).tolist()
        d = self.den.detach().cpu().reshape(-1).tolist()
        return [Fraction(a, b) for a, b in zip(n, d)]


def rational(num, den=1, device=None) -> Rational:
    """Normalised fractions from ints or int tensors (int32); ``device``
    for Python ints, default the card."""
    if not isinstance(num, torch.Tensor) and device is None:
        from ..core.executor import cuda_device
        device = cuda_device()
    num = torch.as_tensor(num, dtype=torch.int32, device=device)
    den = torch.as_tensor(den, dtype=torch.int32, device=num.device)
    return Rational(num, den).normalized()
