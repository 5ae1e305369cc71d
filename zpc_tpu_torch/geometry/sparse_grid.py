"""``SparseGrid``: a one-level block-sparse grid (counterpart of
``zpc_tpu/geometry/sparse_grid.py``).

A :class:`~zpc_tpu_torch.containers.block_table.BlockTable` of active blocks
(a :class:`~zpc_tpu_torch.containers.block_table.WideBlockTable` with
``wide_keys=True``), a dict of payload tensors
``[block_capacity, bs^dim, *prop_shape]`` and an index-to-world
:class:`~zpc_tpu_torch.math.transform.Transform`.  Cell ``c`` lives in
block ``floor(c / bs)`` at in-block offset
``((c0 % bs) * bs + c1 % bs) * bs + c2 % bs``.  Queries (``value_or``),
trilinear and staggered sampling, the sampled field's gradient, activation
and the dense conversions follow the JAX module.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..containers.block_table import (KEY_SENTINEL, BlockTable,
                                      WideBlockTable, build_block_table,
                                      build_wide_block_table)
from ..core.config import PropertyTag
from ..math.transform import Transform, scaling, translation

__all__ = ["neighbor_offsets", "SparseGrid", "sparse_grid",
           "sparse_grid_from_dense", "sparse_grid_to_dense"]


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

    def index_to_world(self, i: torch.Tensor) -> torch.Tensor:
        return self.transform.apply(i.to(self.transform.matrix.dtype))

    def decompose_cell(self, cell: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cell coords ``[..., dim]`` -> (block coords, linear in-block
        offset)."""
        bs = self.block_size
        block = torch.div(cell, bs, rounding_mode="floor")
        local = cell - block * bs
        lin = torch.zeros(cell.shape[:-1], dtype=torch.int32,
                          device=cell.device)
        for d in range(self.dim):
            lin = lin * bs + local[..., d]
        return block, lin

    def cell_slot(self, cell: torch.Tensor) -> torch.Tensor:
        """Flat payload index of each cell ``[..., dim]``, -1 if its block
        is inactive."""
        block, lin = self.decompose_cell(cell)
        slot = self.table.query(block)
        return torch.where(slot >= 0, slot * self.cells_per_block + lin, -1)

    def node_world_positions(self) -> torch.Tensor:
        """World position of every payload cell ``[cap, bs^dim, dim]``."""
        bs = self.block_size
        corners = torch.as_tensor(neighbor_offsets(self.dim, 0, bs - 1),
                                  device=self.table.keys.device)
        cells = self.table.active_coords[:, None, :] * bs + corners[None]
        return self.index_to_world(cells)

    def value_or(self, prop: str, cell: torch.Tensor,
                 default=0.0) -> torch.Tensor:
        """The value of ``prop`` at each cell, ``default`` where the cell's
        block is inactive (``valueOr``)."""
        arr = self.data[prop]
        flat = arr.reshape((-1,) + tuple(arr.shape[2:]))
        idx = self.cell_slot(cell)
        val = flat[idx.clamp_min(0).long()]
        miss = (idx < 0).reshape(idx.shape + (1,) * (val.dim() - idx.dim()))
        return torch.where(miss, torch.as_tensor(default, dtype=val.dtype,
                                                 device=val.device), val)

    def sample(self, prop: str, x_world: torch.Tensor,
               default=0.0) -> torch.Tensor:
        """Trilinear sampling at world positions ``[..., dim]``
        (``wSample``); inactive cells read ``default``."""
        xi = self.world_to_index(x_world)
        base = torch.floor(xi).to(torch.int32)
        frac = xi - base
        out = None
        for c in neighbor_offsets(self.dim, 0, 1):
            cell = base + torch.as_tensor(c, device=base.device)
            w = torch.ones(xi.shape[:-1], dtype=xi.dtype, device=xi.device)
            for d in range(self.dim):
                w = w * (frac[..., d] if c[d] else 1.0 - frac[..., d])
            v = self.value_or(prop, cell, default)
            wexp = w.reshape(w.shape + (1,) * (v.dim() - w.dim()))
            out = wexp * v if out is None else out + wexp * v
        return out

    def sample_staggered(self, prop: str, x_world: torch.Tensor,
                         default=0.0) -> torch.Tensor:
        """MAC-grid sampling: component d of ``prop`` lives on faces offset
        by -dx/2 along d, and is sampled with its own shifted stencil."""
        comps = []
        for d in range(self.dim):
            shift = torch.zeros((self.dim,), dtype=x_world.dtype,
                                device=x_world.device)
            shift[d] = 0.5 * self.dx
            comp = self.sample(prop, x_world + shift, default)
            comps.append(comp[..., d] if comp.dim() > x_world.dim() - 1
                         else comp)
        return torch.stack(comps, dim=-1)

    def sample_gradient(self, prop: str,
                        x_world: torch.Tensor) -> torch.Tensor:
        """Gradient of the trilinear field (summed over its channels) at
        each position, by ``torch.func.grad``.  The JAX module maps the
        gradient of one point's sample over the points; the points are
        independent, so the gradient of the sum over all of them is the
        same, in one pass."""
        def f(p):
            return torch.sum(self.sample(prop, p))

        pts = x_world.reshape(-1, self.dim)
        return torch.func.grad(f)(pts).reshape(x_world.shape)

    def with_data(self, **named: torch.Tensor) -> "SparseGrid":
        d = dict(self.data)
        d.update(named)
        return dataclasses.replace(self, data=d)

    def zeroed(self) -> "SparseGrid":
        """Clear every payload (``CleanGridBlocks``)."""
        return dataclasses.replace(
            self, data={k: torch.zeros_like(v) for k, v in self.data.items()})

    def activate(self, block_coords: torch.Tensor,
                 valid: Optional[torch.Tensor] = None,
                 dilation: int = 0) -> "SparseGrid":
        """Rebuild the table from candidate block coords, dilated by the
        ``[0, dilation]^dim`` positive neighbourhood (the stencil apron),
        with zeroed payloads."""
        return self.activate_with_slots(block_coords, valid, dilation)[0]

    def activate_with_slots(self, block_coords: torch.Tensor,
                            valid: Optional[torch.Tensor] = None,
                            dilation: int = 0
                            ) -> Tuple["SparseGrid", torch.Tensor]:
        """:meth:`activate`, and each candidate's slot in the final
        (dilated) table (-1 for invalid lanes and past the capacity), read
        off the builds' own inverses."""
        cap = self.block_capacity
        if isinstance(self.table, WideBlockTable):
            def build(c, v):
                return build_wide_block_table(c, cap, valid=v)
        else:
            def build(c, v):
                return build_block_table(c, cap, valid=v, dim=self.dim)
        table, inverse = build(block_coords, valid)
        if dilation:
            offs = torch.as_tensor(neighbor_offsets(self.dim, 0, dilation),
                                   device=block_coords.device)
            cand = (table.active_coords[:, None, :] +
                    offs[None]).reshape(-1, self.dim)
            vmask = table.mask.repeat_interleave(offs.shape[0])
            table, inv_cand = build(cand, vmask)
            # offset (0, .., 0) is each block's first candidate: candidate
            # i * noffs maps slot i to its slot in the dilated table
            remap = inv_cand[::offs.shape[0]]
            inverse = torch.where(inverse >= 0,
                                  remap[inverse.clamp_min(0).long()], -1)
        return dataclasses.replace(self, table=table).zeroed(), inverse


def sparse_grid(props: Sequence[PropertyTag], *, dx: float,
                block_capacity: int, device: torch.device,
                block_size: int = 4, dim: int = 3, origin=None,
                dtype: torch.dtype = torch.float32,
                wide_keys: bool = False) -> SparseGrid:
    """Empty grid with named cell properties and no active block;
    ``wide_keys=True`` keys blocks by (kx, kyz) pairs
    (:class:`WideBlockTable`, 3-D), past the packed key's 1024^3 blocks."""
    data = {t.name: torch.zeros((block_capacity, block_size ** dim) + t.shape,
                                dtype=dtype, device=device)
            for t in props}
    keys = torch.full((block_capacity,), KEY_SENTINEL, dtype=torch.int32,
                      device=device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    if wide_keys:
        if dim != 3:
            raise ValueError("wide keys are 3-D")
        table = WideBlockTable(keys, keys.clone(), count, dim)
    else:
        table = BlockTable(keys, count, dim)
    tr = scaling(dx, device=device)
    if origin is not None:
        tr = translation(origin, device=device).compose(tr)
    return SparseGrid(table, data, tr, block_size, dim)


def sparse_grid_from_dense(arr: torch.Tensor, *, dx: float, prop_name: str,
                           block_size: int = 4, origin=None,
                           threshold: Optional[float] = None,
                           block_capacity: Optional[int] = None
                           ) -> SparseGrid:
    """Dense array -> SparseGrid on the array's device: the blocks where
    some cell has ``|value| > threshold`` (every block when None)."""
    dim = arr.dim()
    bs = block_size
    dev = arr.device
    nb_axes = [int(np.ceil(s / bs)) for s in arr.shape]
    pad = []
    for a, s in reversed(list(zip(nb_axes, arr.shape))):
        pad += [0, a * bs - s]
    padded = torch.nn.functional.pad(arr, pad)
    # [nbx, bs, nby, bs, (nbz, bs)] -> [nblocks, bs^dim]
    resh = padded.reshape(sum(([a, bs] for a in nb_axes), []))
    perm = list(range(0, 2 * dim, 2)) + list(range(1, 2 * dim, 2))
    blocks = resh.permute(perm).reshape(-1, bs ** dim)
    coords = torch.as_tensor(np.stack(np.meshgrid(
        *[np.arange(a) for a in nb_axes], indexing="ij"),
        -1).reshape(-1, dim), dtype=torch.int32, device=dev)
    if threshold is not None:
        keep = torch.any(blocks.abs() > threshold, dim=1)
    else:
        keep = torch.ones((blocks.shape[0],), dtype=torch.bool, device=dev)
    cap = block_capacity or blocks.shape[0]
    g = sparse_grid([PropertyTag(prop_name)], dx=dx, block_capacity=cap,
                    device=dev, block_size=bs, dim=dim, origin=origin,
                    dtype=arr.dtype)
    table, inv = build_block_table(coords, cap, valid=keep, dim=dim)
    data = torch.zeros((cap + 1, bs ** dim), dtype=arr.dtype, device=dev)
    data[torch.where(inv >= 0, inv, cap).long()] = blocks
    return dataclasses.replace(g, table=table, data={prop_name: data[:cap]})


def sparse_grid_to_dense(grid: SparseGrid, prop_name: str, lo, hi,
                         default=0.0) -> torch.Tensor:
    """SparseGrid -> dense array over the cell range [lo, hi)."""
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    shape = tuple((hi - lo).tolist())
    grids = np.meshgrid(*[np.arange(a, b) for a, b in zip(lo, hi)],
                        indexing="ij")
    cells = torch.as_tensor(np.stack([g.ravel() for g in grids], -1),
                            dtype=torch.int32,
                            device=grid.table.keys.device)
    return grid.value_or(prop_name, cells, default).reshape(shape)
