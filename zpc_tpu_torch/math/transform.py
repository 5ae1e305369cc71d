"""Affine world transforms (counterpart of ``Transform`` in
``zpc_tpu/math/transform.py``): the sparse grid's index-to-world map, whose
translation column is the grid origin that recentering moves."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Transform", "translation", "scaling"]


@dataclasses.dataclass(frozen=True)
class Transform:
    """4x4 affine matrix applied to points as ``p' = (M @ [p, 1])[:d]``."""

    matrix: torch.Tensor  # [4, 4]

    def apply(self, p: torch.Tensor) -> torch.Tensor:
        d = p.shape[-1]
        return p @ self.matrix[:d, :d].T + self.matrix[:d, 3]

    def inverse(self) -> "Transform":
        R = self.matrix[:3, :3]
        t = self.matrix[:3, 3]
        Rinv = torch.linalg.inv(R)
        M = torch.eye(4, dtype=self.matrix.dtype, device=self.matrix.device)
        M[:3, :3] = Rinv
        M[:3, 3] = -(Rinv @ t)
        return Transform(M)

    def compose(self, other: "Transform") -> "Transform":
        return Transform(self.matrix @ other.matrix)


def translation(t, *, device: torch.device) -> Transform:
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    M = torch.eye(4, dtype=torch.float32, device=device)
    M[:t.shape[0], 3] = t
    return Transform(M)


def scaling(s, *, device: torch.device) -> Transform:
    s = torch.as_tensor(s, dtype=torch.float32, device=device).expand(3)
    M = torch.diag(torch.cat([s, torch.ones(1, device=device)]))
    return Transform(M)
