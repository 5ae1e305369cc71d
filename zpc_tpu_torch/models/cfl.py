"""Timestep estimation (counterpart of ``zpc_tpu/models/cfl.py``):
``dt = cfl * dx / c`` with the elastic wave speed
``c = sqrt((lam + 2 mu) / rho)`` in fp32, and the velocity CFL bound of
the grid's maximum speed."""

from __future__ import annotations

import torch

from .constitutive import lame_parameters

__all__ = ["sound_speed", "timestep_linear_elasticity", "timestep_velocity"]


def sound_speed(E: float, nu: float, rho: float) -> torch.Tensor:
    mu, lam = lame_parameters(E, nu)
    return torch.sqrt(torch.tensor((lam + 2.0 * mu) / rho,
                                   dtype=torch.float32))


def timestep_linear_elasticity(E: float, nu: float, rho: float, dx: float,
                               cfl: float = 0.5) -> torch.Tensor:
    return cfl * dx / sound_speed(E, nu, rho)


def timestep_velocity(max_vel: torch.Tensor, dx: float, cfl: float = 0.5,
                      dt_max: float = 1e-3) -> torch.Tensor:
    """``min(cfl * dx / max_vel, dt_max)`` (``max_vel`` clamped to >=
    1e-6), on ``max_vel``'s device: no host read."""
    return torch.clamp_max(cfl * dx / torch.clamp_min(max_vel, 1e-6), dt_max)
