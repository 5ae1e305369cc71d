"""Boundary colliders (counterpart of ``zpc_tpu/geometry/collider.py``):
project grid velocities against level-set obstacles, over whole node
batches at once."""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import torch

from .levelset import LevelSet

__all__ = ["ColliderType", "Collider", "resolve_boundaries"]


class ColliderType(enum.Enum):
    sticky = "sticky"      # zero all relative velocity inside
    slip = "slip"          # remove the normal component
    separate = "separate"  # remove only an approaching normal component


@dataclasses.dataclass(frozen=True)
class Collider:
    levelset: LevelSet
    kind: ColliderType = ColliderType.sticky
    friction: float = 0.0

    def resolve(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Project ``v`` at points ``x`` where sdf(x) < 0, in the
        boundary's material frame; elsewhere ``v`` is unchanged."""
        phi = self.levelset.sdf(x)
        inside = (phi < 0.0)[..., None]
        vb = self.levelset.velocity(x)
        rel = v - vb
        if self.kind is ColliderType.sticky:
            resolved = torch.zeros_like(rel)
        else:
            n = self.levelset.normal(x)
            vn = torch.sum(rel * n, -1, keepdim=True)
            if self.kind is ColliderType.slip:
                remove = vn
            else:
                remove = torch.clamp_max(vn, 0.0)
            resolved = rel - remove * n
            if self.friction > 0.0:
                # Coulomb: shrink the tangential speed by mu |removed vn|
                vt_norm = torch.linalg.vector_norm(resolved, dim=-1,
                                                   keepdim=True)
                drop = self.friction * remove.abs()
                scale = (vt_norm - drop).clamp_min(0.0) / \
                    vt_norm.clamp_min(1e-12)
                resolved = resolved * scale
        return torch.where(inside, resolved + vb, v)


def resolve_boundaries(colliders: Sequence[Collider], x: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Apply the colliders in order (the grid update's boundary pass)."""
    for c in colliders:
        v = c.resolve(x, v)
    return v
