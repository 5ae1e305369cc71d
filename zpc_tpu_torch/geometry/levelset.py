"""Analytic level sets (counterpart of ``zpc_tpu/geometry/levelset.py``):
the half space, the box and the complement that the MPM colliders use, with
``sdf``, analytic ``normal`` and ``velocity`` over ``[..., dim]`` points.

The JAX package's default normal is autodiff of the sdf; these three shapes
have closed forms, so the port needs no autograd here.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["LevelSet", "HalfSpace", "Cuboid", "ComplementLevelSet"]


class LevelSet:
    """Interface: ``sdf`` < 0 inside the obstacle; ``velocity`` is the
    material velocity of the boundary (static by default)."""

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def normal(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def velocity(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x)


@dataclasses.dataclass(frozen=True)
class HalfSpace(LevelSet):
    """Plane through ``origin`` with outward unit normal ``direction``;
    sdf > 0 on the side the normal points to."""

    origin: torch.Tensor
    direction: torch.Tensor

    def sdf(self, x):
        return torch.sum((x - self.origin) * self.direction, -1)

    def normal(self, x):
        return self.direction.expand(x.shape)


@dataclasses.dataclass(frozen=True)
class Cuboid(LevelSet):
    """Axis-aligned box between ``minimum`` and ``maximum``: exact exterior
    distance, minus the nearest face distance inside."""

    minimum: torch.Tensor
    maximum: torch.Tensor

    def _q(self, x):
        center = 0.5 * (self.minimum + self.maximum)
        half = 0.5 * (self.maximum - self.minimum)
        rel = x - center
        return rel, rel.abs() - half

    def sdf(self, x):
        _, q = self._q(x)
        outside = torch.linalg.vector_norm(q.clamp_min(0.0), dim=-1)
        inside = torch.clamp_max(q.amax(-1), 0.0)
        return outside + inside

    def normal(self, x):
        """Outside: the direction of the clamped offset; inside: the axis of
        the nearest face (split evenly over tied faces)."""
        rel, q = self._q(x)
        sgn = torch.where(rel >= 0, 1.0, -1.0)
        out_dir = q.clamp_min(0.0) * sgn
        out_n = out_dir / torch.linalg.vector_norm(
            out_dir, dim=-1, keepdim=True).clamp_min(1e-12)
        amax = q.amax(-1, keepdim=True)
        onehot = (q == amax).to(x.dtype)
        onehot = onehot / onehot.sum(-1, keepdim=True).clamp_min(1.0)
        in_n = onehot * sgn
        inside = (q.amax(-1) <= 0.0)[..., None]
        return torch.where(inside, in_n, out_n)


@dataclasses.dataclass(frozen=True)
class ComplementLevelSet(LevelSet):
    """Inside and outside of ``base`` swapped (a box becomes walls)."""

    base: LevelSet

    def sdf(self, x):
        return -self.base.sdf(x)

    def normal(self, x):
        return -self.base.normal(x)

    def velocity(self, x):
        return self.base.velocity(x)
