"""Timestep estimation (counterpart of ``zpc_tpu/models/cfl.py:19-28``):
``dt = cfl * dx / c`` with the elastic wave speed
``c = sqrt((lam + 2 mu) / rho)`` in fp32."""

from __future__ import annotations

import torch

from .constitutive import lame_parameters

__all__ = ["sound_speed", "timestep_linear_elasticity"]


def sound_speed(E: float, nu: float, rho: float) -> torch.Tensor:
    mu, lam = lame_parameters(E, nu)
    return torch.sqrt(torch.tensor((lam + 2.0 * mu) / rho,
                                   dtype=torch.float32))


def timestep_linear_elasticity(E: float, nu: float, rho: float, dx: float,
                               cfl: float = 0.5) -> torch.Tensor:
    return cfl * dx / sound_speed(E, nu, rho)
