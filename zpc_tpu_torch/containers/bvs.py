"""``Bvs``: a flat sweep-and-prune broad phase (counterpart of
``zpc_tpu/containers/bvs.py``).

Primitives sort by their lower bound on one axis; a query finds its first
candidate by a binary search on that axis and tests a fixed window of
``max_candidates`` primitives after it.  Building is one sort, with no tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .bvh import BIG, aabb_overlap

__all__ = ["Bvs", "build_bvs", "bvs_query", "bvs_candidates"]


@dataclasses.dataclass(frozen=True)
class Bvs:
    lo: torch.Tensor          # [n, dim] sorted by lo[:, axis]
    hi: torch.Tensor
    prim: torch.Tensor        # [n] int32 primitive id (-1 for invalid)
    max_extent: torch.Tensor  # 0-d: widest box along the sweep axis
    axis: int = 0


def build_bvs(prim_lo: torch.Tensor, prim_hi: torch.Tensor, axis: int = 0,
              valid: Optional[torch.Tensor] = None) -> Bvs:
    """Sort the boxes by their lower bound on ``axis`` (a stable sort);
    invalid boxes sort last, inverted."""
    n = prim_lo.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=prim_lo.device)
    keys = torch.where(valid, prim_lo[:, axis], BIG)
    order = torch.argsort(keys, stable=True)
    vs = valid[order]
    lo = torch.where(vs[:, None], prim_lo[order], BIG)
    hi = torch.where(vs[:, None], prim_hi[order], -BIG)
    ext = torch.where(valid, prim_hi[:, axis] - prim_lo[:, axis], 0.0).amax()
    return Bvs(lo, hi, torch.where(vs, order, -1).to(torch.int32), ext, axis)


def bvs_query(bvs: Bvs, q_lo: torch.Tensor, q_hi: torch.Tensor,
              max_candidates: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Overlap query: ``(prim ids [nq, max_candidates], mask)``.

    The candidates are the primitives whose sweep-axis lower bound lies in
    ``[q_lo - max_extent, q_hi]``, a superset of the overlaps on that
    axis; every axis is then tested exactly.  Candidates past
    ``max_candidates`` are dropped (:func:`bvs_candidates` counts them)."""
    a = bvs.axis
    n = bvs.lo.shape[0]
    starts = torch.searchsorted(bvs.lo[:, a].contiguous(),
                                (q_lo[:, a] - bvs.max_extent).contiguous())
    pos = starts[:, None] + torch.arange(max_candidates,
                                         device=q_lo.device)[None, :]
    safe = pos.clamp_max(n - 1)
    in_range = (pos < n) & (bvs.lo[safe, a] <= q_hi[:, a:a + 1])
    ok = in_range & aabb_overlap(bvs.lo[safe], bvs.hi[safe],
                                 q_lo[:, None, :], q_hi[:, None, :])
    ids = torch.where(ok, bvs.prim[safe], -1)
    return ids, ok & (ids >= 0)


def bvs_candidates(bvs: Bvs, q_lo: torch.Tensor,
                   q_hi: torch.Tensor) -> torch.Tensor:
    """Per query, how many sweep-axis lower bounds lie in its range
    ``[q_lo - max_extent, q_hi]``: :func:`bvs_query` truncates the queries
    whose count exceeds its ``max_candidates``."""
    a = bvs.axis
    keys = bvs.lo[:, a].contiguous()
    starts = torch.searchsorted(keys, (q_lo[:, a] - bvs.max_extent)
                                .contiguous())
    return torch.searchsorted(keys, q_hi[:, a].contiguous(),
                              right=True) - starts
