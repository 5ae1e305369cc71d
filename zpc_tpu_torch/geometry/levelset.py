"""Analytic level sets (counterpart of ``zpc_tpu/geometry/levelset.py``):
half space, sphere, box, capped cylinder and torus, and the rigid-motion,
union, intersection and complement wrappers, with ``sdf``, ``normal`` and
``velocity`` over ``[..., dim]`` points.

A shape with a closed-form normal defines it; the others take the base
class's, the normalised gradient of the sdf by autograd, as the JAX
package takes ``jax.grad`` of it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["LevelSet", "HalfSpace", "Sphere", "Cuboid", "Cylinder", "Torus",
           "TransformedLevelSet", "UnionLevelSet", "IntersectionLevelSet",
           "ComplementLevelSet"]


class LevelSet:
    """Interface: ``sdf`` < 0 inside the obstacle; ``normal`` is the unit
    gradient of the sdf and ``velocity`` the material velocity of the
    boundary (static by default)."""

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def normal(self, x: torch.Tensor) -> torch.Tensor:
        """The gradient of the sdf by autograd, normalised (each point's
        sdf depends on that point alone, so the gradient of their sum is
        every point's own)."""
        with torch.enable_grad():
            p = x.detach().requires_grad_(True)
            g, = torch.autograd.grad(self.sdf(p).sum(), p)
        return g / torch.linalg.vector_norm(g, dim=-1,
                                            keepdim=True).clamp_min(1e-12)

    def velocity(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x)

    def inside(self, x: torch.Tensor) -> torch.Tensor:
        return self.sdf(x) < 0.0


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
class Sphere(LevelSet):
    center: torch.Tensor
    radius: torch.Tensor

    def sdf(self, x):
        return torch.linalg.vector_norm(x - self.center, dim=-1) - self.radius

    def normal(self, x):
        d = x - self.center
        return d / torch.linalg.vector_norm(d, dim=-1,
                                            keepdim=True).clamp_min(1e-12)


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


def _axial_radial(d: torch.Tensor, orient: int):
    """Axial coordinate along axis ``orient`` and the distance from that
    axis."""
    axial = d[..., orient]
    radial_sq = torch.sum(d * d, -1) - axial * axial
    return axial, torch.sqrt(radial_sq.clamp_min(0.0))


@dataclasses.dataclass(frozen=True)
class Cylinder(LevelSet):
    """Capped cylinder along axis ``orient`` from ``bottom`` (the centre of
    its bottom cap), of ``radius`` and ``length``."""

    bottom: torch.Tensor
    radius: torch.Tensor
    length: torch.Tensor
    orient: int = 1

    def sdf(self, x):
        axial, radial = _axial_radial(x - self.bottom, self.orient)
        qr = radial - self.radius
        qa = torch.maximum(-axial, axial - self.length)
        outside = torch.sqrt(qr.clamp_min(0.0) ** 2 + qa.clamp_min(0.0) ** 2)
        inside = torch.maximum(qr, qa).clamp_max(0.0)
        return outside + inside


@dataclasses.dataclass(frozen=True)
class Torus(LevelSet):
    """Torus in the plane normal to axis ``orient``."""

    center: torch.Tensor
    major_radius: torch.Tensor
    minor_radius: torch.Tensor
    orient: int = 1

    def sdf(self, x):
        axial, radial = _axial_radial(x - self.center, self.orient)
        q = torch.sqrt((radial - self.major_radius) ** 2 + axial * axial)
        return q - self.minor_radius


@dataclasses.dataclass(frozen=True)
class TransformedLevelSet(LevelSet):
    """``base`` under a rigid motion: evaluated in its local frame
    (``rotation`` maps local to world, then ``translation_v``), with the
    rigid-body velocity ``linear_velocity + angular_velocity x r``."""

    base: LevelSet
    rotation: torch.Tensor          # [3, 3] local -> world
    translation_v: torch.Tensor     # [3]
    linear_velocity: torch.Tensor   # [3]
    angular_velocity: torch.Tensor  # [3]

    def _to_local(self, x):
        return (x - self.translation_v) @ self.rotation      # R^T applied

    def sdf(self, x):
        return self.base.sdf(self._to_local(x))

    def normal(self, x):
        return self.base.normal(self._to_local(x)) @ self.rotation.T

    def velocity(self, x):
        r = x - self.translation_v
        return self.linear_velocity + torch.linalg.cross(
            self.angular_velocity.expand(r.shape), r, dim=-1)


@dataclasses.dataclass(frozen=True)
class UnionLevelSet(LevelSet):
    """The least sdf of ``sets``; the velocity of the first set that
    attains it."""

    sets: Tuple[LevelSet, ...]

    def sdf(self, x):
        return torch.stack([s.sdf(x) for s in self.sets], 0).amin(0)

    def velocity(self, x):
        ds = torch.stack([s.sdf(x) for s in self.sets], 0)
        vs = torch.stack([s.velocity(x) for s in self.sets], 0)
        # argmin takes the first minimum (jnp.argmin does too)
        which = torch.argmin(ds, 0)
        return torch.take_along_dim(
            vs, which[None, ..., None].expand((1,) + vs.shape[1:]), 0)[0]


@dataclasses.dataclass(frozen=True)
class IntersectionLevelSet(LevelSet):
    sets: Tuple[LevelSet, ...]

    def sdf(self, x):
        return torch.stack([s.sdf(x) for s in self.sets], 0).amax(0)


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
