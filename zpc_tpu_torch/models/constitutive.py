"""Constitutive models (counterpart of ``zpc_tpu/models/constitutive.py``):
Lame parameters and the 3-D fixed-corotated Kirchhoff stress that the
explicit MPM step scatters."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..math.svd import polar_newton3x3
from ..math.vecmat import cof3, mm33

__all__ = ["lame_parameters", "FixedCorotated"]


def lame_parameters(E: float, nu: float) -> Tuple[float, float]:
    """(mu, lam) from Young's modulus and Poisson ratio."""
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


@dataclasses.dataclass(frozen=True)
class FixedCorotated:
    """psi = mu |F - R|^2 + lam/2 (J - 1)^2; P = 2 mu (F - R) + lam (J - 1)
    cof(F).  ``mu``/``lam`` are fp32 scalar tensors."""

    mu: torch.Tensor
    lam: torch.Tensor

    @classmethod
    def from_young_poisson(cls, E: float, nu: float, *,
                           device: torch.device) -> "FixedCorotated":
        mu, lam = lame_parameters(E, nu)
        return cls(torch.tensor(mu, dtype=torch.float32, device=device),
                   torch.tensor(lam, dtype=torch.float32, device=device))

    def kirchhoff(self, F: torch.Tensor) -> torch.Tensor:
        """tau = P F^T over ``[..., 3, 3]``, with R from the Newton polar
        iteration (no SVD: the corotated stress needs only R, J, cof F)."""
        if F.shape[-2:] != (3, 3):
            raise NotImplementedError("only the 3-D stress is ported")
        R = polar_newton3x3(F)
        cof = cof3(F)
        J = torch.sum(F[..., :, 0] * cof[..., :, 0], -1)
        P = (2.0 * self.mu) * (F - R) + \
            (self.lam * (J - 1.0))[..., None, None] * cof
        return mm33(P, F.transpose(-1, -2))
