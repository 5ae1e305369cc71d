"""Failure detection and recovery (counterpart of
``zpc_tpu/utils/diagnostics.py``).

* :func:`validate_state`: non-finite lane count, the largest particle
  speed and the count of particles outside given bounds, over an MPM
  state's live particles;
* :class:`Watchdog`: a host loop around a step function that rolls back
  to the last healthy state and halves dt on a blow-up, and lets dt
  recover after a run of healthy steps;
* :func:`momentum_report`: total mass, linear and angular momentum (APIC
  affine part included).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..sim.mpm import MPMState

__all__ = ["StateReport", "validate_state", "Watchdog", "momentum_report"]


class StateReport(NamedTuple):
    nan_count: torch.Tensor    # non-finite lanes across particle channels
    max_speed: torch.Tensor
    escaped: torch.Tensor      # particles outside the [lo, hi] bounds
    healthy: torch.Tensor


def validate_state(state: MPMState, *, max_speed: float = 1e3,
                   bounds: Optional[Tuple] = None) -> StateReport:
    """Health of the live particles: healthy when every channel of x, v,
    F and C is finite and no speed exceeds ``max_speed``."""
    p = state.particles
    mask = p.mask

    def count_bad(a):
        bad = ~torch.isfinite(a.reshape(a.shape[0], -1))
        return (bad & mask[:, None]).sum()

    nan_count = (count_bad(p["x"]) + count_bad(p["v"]) +
                 count_bad(p["F"]) + count_bad(p["C"]))
    speed = torch.where(mask, torch.linalg.vector_norm(p["v"], dim=-1), 0.0)
    ms = speed.max()
    if bounds is not None:
        lo, hi = (torch.as_tensor(b, dtype=p["x"].dtype, device=mask.device)
                  for b in bounds)
        out = ((p["x"] < lo) | (p["x"] > hi)).any(-1)
        escaped = (out & mask).sum()
    else:
        escaped = torch.zeros((), dtype=torch.int64, device=mask.device)
    healthy = (nan_count == 0) & (ms <= max_speed)
    return StateReport(nan_count, ms, escaped, healthy)


@dataclasses.dataclass
class Watchdog:
    """Rollback-and-retry guard around ``step(state, dt) -> state``.  On
    an unhealthy result: restore the last good state, halve dt and retry
    (at most ``max_retries`` rollbacks in all, then raise); after
    ``recover_after`` healthy steps dt doubles back towards its start."""

    step: Callable
    dt: float
    max_speed: float = 1e3
    max_retries: int = 8
    recover_after: int = 20
    bounds: Optional[Tuple] = None

    def __post_init__(self):
        self._good = None
        self._dt0 = self.dt
        self._healthy_streak = 0
        self.rollbacks = 0

    def run(self, state: MPMState, steps: int) -> MPMState:
        self._good = state
        i = 0
        while i < steps:
            out = self.step(state, self.dt)
            rep = validate_state(out, max_speed=self.max_speed,
                                 bounds=self.bounds)
            if bool(rep.healthy):
                state = out
                self._good = out
                self._healthy_streak += 1
                i += 1
                if (self._healthy_streak >= self.recover_after and
                        self.dt < self._dt0):
                    self.dt = min(self.dt * 2.0, self._dt0)
                    self._healthy_streak = 0
            else:
                self.rollbacks += 1
                if self.rollbacks > self.max_retries:
                    raise RuntimeError(
                        f"simulation diverged: {int(rep.nan_count)} bad "
                        f"lanes, max speed {float(rep.max_speed):.3g}")
                state = self._good
                self.dt *= 0.5
                self._healthy_streak = 0
        return state


def momentum_report(state: MPMState):
    """(total mass, linear momentum [3], angular momentum [3]) of the live
    particles; the APIC affine field adds ``m dx^2 / 4 vec(C - C^T)`` to
    the angular momentum."""
    p = state.particles
    m = torch.where(p.mask, p["m"], 0.0)
    x, v, C = p["x"], p["v"], p["C"]
    lin = (m[:, None] * v).sum(0)
    ang = (m[:, None] * torch.linalg.cross(x, v, dim=-1)).sum(0)
    cvec = torch.stack([C[..., 2, 1] - C[..., 1, 2],
                        C[..., 0, 2] - C[..., 2, 0],
                        C[..., 1, 0] - C[..., 0, 1]], -1)
    dx = state.grid.dx
    ang = ang + (m[:, None] * cvec).sum(0) * (dx * dx / 4.0)
    return m.sum(), lin, ang
