"""``IndexBuckets``: cell-binned neighbour lists (counterpart of
``zpc_tpu/containers/index_buckets.py``; the reference's
``IndexBuckets``/``SpatialHash``).

The build stable-sorts particle ids by packed cell key; the cells' sorted,
unique key table is a :class:`~zpc_tpu_torch.containers.block_table.
BlockTable`, and each table slot's range in the sorted ids comes from a
binary search over the sorted keys.  A neighbourhood query has a fixed
fanout, (2 ring + 1)^d cells times ``k_per_cell`` slots, returned as a
padded id matrix and its mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..containers.block_table import (KEY_SENTINEL, BlockTable,
                                      build_block_table, pack_coords)
from ..geometry.sparse_grid import neighbor_offsets

__all__ = ["IndexBuckets", "build_index_buckets", "neighbor_candidates"]


@dataclasses.dataclass(frozen=True)
class IndexBuckets:
    table: BlockTable          # the active cells (sorted keys)
    offsets: torch.Tensor      # [cell_capacity + 1] int32 start per slot
    indices: torch.Tensor      # [n] int32 particle ids sorted by cell
    dx: torch.Tensor           # 0-d cell size
    count: torch.Tensor        # 0-d int32 valid particles

    @property
    def cell_capacity(self) -> int:
        return self.table.capacity

    def cell_of(self, x: torch.Tensor) -> torch.Tensor:
        return torch.floor(x / self.dx).to(torch.int32)

    def cell_range(self, coords: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(start, end) range in ``indices`` per query cell coord; empty
        (0, 0) for inactive cells."""
        slot = self.table.query(coords)
        safe = slot.clamp_min(0).long()
        empty = slot < 0
        return (torch.where(empty, 0, self.offsets[safe]),
                torch.where(empty, 0, self.offsets[safe + 1]))


def build_index_buckets(x: torch.Tensor, dx: float, cell_capacity: int,
                        valid: Optional[torch.Tensor] = None
                        ) -> IndexBuckets:
    """Sort-based build (the reference builds with atomic counters)."""
    n = x.shape[0]
    dev = x.device
    dxt = torch.tensor(dx, dtype=x.dtype, device=dev)
    cells = torch.floor(x / dxt).to(torch.int32)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    keys = torch.where(valid, pack_coords(cells), KEY_SENTINEL)
    skeys, sids = torch.sort(keys, stable=True)
    table, _ = build_block_table(cells, cell_capacity, valid=valid,
                                 dim=cells.shape[-1])
    # each slot's first sorted position; the sentinel slots past the count
    # find the first invalid lane, so their ranges are empty
    count = torch.count_nonzero(valid).to(torch.int32)
    offsets = torch.searchsorted(skeys, table.keys).to(torch.int32)
    offsets = torch.cat([offsets, count.reshape(1)]).clamp_max(count)
    return IndexBuckets(table, offsets, sids.to(torch.int32), dxt, count)


def neighbor_candidates(ib: IndexBuckets, q: torch.Tensor, k_per_cell: int,
                        ring: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-fanout candidates for query points ``[nq, d]``: (ids
    ``[nq, (2 ring + 1)^d * k_per_cell]`` int32, -1 where masked; mask).
    A cell holding more than ``k_per_cell`` particles gives its first
    ``k_per_cell``; the caller applies the distance test."""
    d = q.shape[-1]
    offs = torch.as_tensor(neighbor_offsets(d, -ring, ring), device=q.device)
    cand = ib.cell_of(q)[:, None, :] + offs[None]          # [nq, m, d]
    start, end = ib.cell_range(cand)                       # [nq, m]
    lane = torch.arange(k_per_cell, dtype=torch.int32, device=q.device)
    pos = start[..., None] + lane                          # [nq, m, k]
    ok = pos < end[..., None]
    safe = pos.clamp(0, ib.indices.shape[0] - 1).long()
    ids = torch.where(ok, ib.indices[safe], -1)
    nq = q.shape[0]
    return ids.reshape(nq, -1), ok.reshape(nq, -1)
