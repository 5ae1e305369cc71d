"""``SparseGrid``: a one-level block-sparse grid (counterpart of
``zpc_tpu/geometry/sparse_grid.py``).

A :class:`~zpc_tpu_torch.containers.block_table.BlockTable` of active blocks,
a dict of payload tensors ``[block_capacity, bs^dim, *prop_shape]`` and an
index-to-world :class:`~zpc_tpu_torch.math.transform.Transform`.  Cell
``c`` lives in block ``floor(c / bs)`` at in-block offset
``((c0 % bs) * bs + c1 % bs) * bs + c2 % bs``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..containers.block_table import (KEY_SENTINEL, BlockTable,
                                      build_block_table)
from ..core.config import PropertyTag
from ..math.transform import Transform, scaling, translation

__all__ = ["neighbor_offsets", "SparseGrid", "sparse_grid"]


def neighbor_offsets(dim: int, lo: int = -1, hi: int = 1) -> np.ndarray:
    """All integer offsets in ``[lo, hi]^dim``, last axis fastest."""
    rng = np.arange(lo, hi + 1)
    grids = np.meshgrid(*([rng] * dim), indexing="ij")
    return np.stack([g.ravel() for g in grids], -1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SparseGrid:
    table: BlockTable
    data: Dict[str, torch.Tensor]
    transform: Optional[Transform]
    block_size: int = 4
    dim: int = 3

    @property
    def block_capacity(self) -> int:
        return self.table.capacity

    @property
    def cells_per_block(self) -> int:
        return self.block_size ** self.dim

    @property
    def dx(self) -> torch.Tensor:
        """Cell size: the isotropic scale of the transform."""
        return torch.linalg.vector_norm(self.transform.matrix[:self.dim, 0])

    @property
    def origin(self) -> torch.Tensor:
        """World position of cell index 0."""
        return self.transform.matrix[:self.dim, 3]

    def world_to_index(self, x: torch.Tensor) -> torch.Tensor:
        return self.transform.inverse().apply(x)

    def cell_slot(self, cell: torch.Tensor) -> torch.Tensor:
        """Flat payload index of each cell ``[..., dim]``, -1 if its block
        is inactive."""
        bs = self.block_size
        block = torch.div(cell, bs, rounding_mode="floor")
        local = cell - block * bs
        lin = torch.zeros(cell.shape[:-1], dtype=torch.int32,
                          device=cell.device)
        for d in range(self.dim):
            lin = lin * bs + local[..., d]
        slot = self.table.query(block)
        return torch.where(slot >= 0, slot * self.cells_per_block + lin, -1)

    def node_world_positions(self) -> torch.Tensor:
        """World position of every payload cell ``[cap, bs^dim, dim]``."""
        bs = self.block_size
        corners = torch.as_tensor(neighbor_offsets(self.dim, 0, bs - 1),
                                  device=self.table.keys.device)
        cells = self.table.active_coords[:, None, :] * bs + corners[None]
        return self.transform.apply(cells.to(self.transform.matrix.dtype))

    def with_data(self, **named: torch.Tensor) -> "SparseGrid":
        d = dict(self.data)
        d.update(named)
        return dataclasses.replace(self, data=d)

    def activate(self, block_coords: torch.Tensor,
                 valid: Optional[torch.Tensor] = None,
                 dilation: int = 0) -> "SparseGrid":
        """Rebuild the table from candidate block coords, dilated by the
        ``[0, dilation]^dim`` positive neighbourhood (the stencil apron),
        with zeroed payloads."""
        cap = self.block_capacity
        table, _ = build_block_table(block_coords, cap, valid=valid,
                                     dim=self.dim)
        if dilation:
            offs = torch.as_tensor(neighbor_offsets(self.dim, 0, dilation),
                                   device=block_coords.device)
            cand = (table.active_coords[:, None, :] +
                    offs[None]).reshape(-1, self.dim)
            vmask = table.mask.repeat_interleave(offs.shape[0])
            table, _ = build_block_table(cand, cap, valid=vmask,
                                         dim=self.dim)
        data = {k: torch.zeros_like(v) for k, v in self.data.items()}
        return dataclasses.replace(self, table=table, data=data)


def sparse_grid(props: Sequence[PropertyTag], *, dx: float,
                block_capacity: int, device: torch.device,
                block_size: int = 4, dim: int = 3,
                origin=None) -> SparseGrid:
    """Empty fp32 grid with named cell properties and no active block."""
    data = {t.name: torch.zeros((block_capacity, block_size ** dim) + t.shape,
                                dtype=torch.float32, device=device)
            for t in props}
    keys = torch.full((block_capacity,), KEY_SENTINEL, dtype=torch.int32,
                      device=device)
    table = BlockTable(keys, torch.zeros((), dtype=torch.int32,
                                         device=device), dim)
    tr = scaling(dx, device=device)
    if origin is not None:
        tr = translation(origin, device=device).compose(tr)
    return SparseGrid(table, data, tr, block_size, dim)
