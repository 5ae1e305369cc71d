"""``AdaptiveGrid``: a multi-level VDB-like sparse tree (counterpart of
``zpc_tpu/geometry/adaptive_grid.py``; reference ``geometry/
AdaptiveGrid.hpp``).

A static number of levels, level 0 the finest (leaf) and the last the
coarsest.  Each level is a sorted-key
:class:`~zpc_tpu_torch.containers.block_table.BlockTable` of its blocks, a
payload ``value [capacity, bs^dim]`` and a child mask of the same shape
(the cell is refined at the next finer level).  A cell of level l spans
``prod(block_sizes[:l])`` leaf cells; a coarse cell without a child is a
constant tile (VDB semantics).  ``probe`` looks every query up at every
level, coarse to fine, and a finer level's value overwrites where its
node exists, so a batch of queries is a handful of gathers and binary
searches with no branch on the data.  Every level build and every
``activate_leaves`` runs ``build_block_table``, whose rank is the port's
scan (the CUDA scan kernel for a CUDA tensor).

Cell coordinates may be negative: every integer division is a floor
division (``torch.div(..., rounding_mode="floor")``), as JAX's
``floor_divide``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..containers.block_table import BlockTable, build_block_table
from ..core.executor import cuda_device
from ..math.transform import Transform, scaling, translation
from .levelset import LevelSet
from .sparse_grid import neighbor_offsets

__all__ = ["AdaptiveGrid", "adaptive_grid_from_leaves",
           "AdaptiveGridLevelSet", "adaptive_from_sdf"]


def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _linear(local: torch.Tensor, bs: int, dim: int) -> torch.Tensor:
    """Row-major offset of in-block coords ``[..., dim]`` (last axis
    fastest)."""
    lin = torch.zeros(local.shape[:-1], dtype=torch.int32,
                      device=local.device)
    for d in range(dim):
        lin = lin * bs + local[..., d].to(torch.int32)
    return lin


@dataclasses.dataclass(frozen=True)
class AdaptiveLevel:
    table: BlockTable
    value: torch.Tensor      # [cap, bs^d] payload
    child: torch.Tensor      # [cap, bs^d] bool: refined at the finer level

    @property
    def capacity(self) -> int:
        return self.value.shape[0]


@dataclasses.dataclass(frozen=True)
class AdaptiveGrid:
    levels: Tuple[AdaptiveLevel, ...]       # finest .. coarsest
    transform: Transform                    # leaf-cell index -> world
    block_sizes: Tuple[int, ...] = (8, 4, 4)
    dim: int = 3
    background: float = 0.0

    def cell_span(self, l: int) -> int:
        """The span of one cell of level ``l``, in leaf cells."""
        s = 1
        for b in self.block_sizes[:l]:
            s *= b
        return s

    def _level_lookup(self, l: int, leaf_cell: torch.Tensor):
        """(found, value, has_child) of the level-``l`` cell over each leaf
        cell ``[..., dim]``."""
        lev = self.levels[l]
        bs = self.block_sizes[l]
        cell_l = _floordiv(leaf_cell, self.cell_span(l))
        block_l = _floordiv(cell_l, bs)
        lin = _linear(cell_l - block_l * bs, bs, self.dim)
        slot = lev.table.query(block_l)
        ok = slot >= 0
        idx = (slot.clamp_min(0) * (bs ** self.dim) + lin).long()
        val = lev.value.reshape(-1)[idx]
        has_child = lev.child.reshape(-1)[idx] & ok
        return ok, val, has_child

    def probe(self, x_world: torch.Tensor) -> torch.Tensor:
        """The value of the finest node covering each point (``probeValue``,
        AdaptiveGrid.hpp:1035-1090); ``background`` where none does."""
        xi = self.transform.inverse().apply(x_world)
        return self._probe_cells(torch.floor(xi).to(torch.int32))

    def _probe_cells(self, leaf_cell: torch.Tensor) -> torch.Tensor:
        """:meth:`probe` of the leaf cells ``[..., dim]``."""
        out = torch.full(leaf_cell.shape[:-1], self.background,
                         dtype=self.levels[0].value.dtype,
                         device=leaf_cell.device)
        for l in reversed(range(len(self.levels))):
            ok, val, has_child = self._level_lookup(l, leaf_cell)
            # a level's value applies where its node exists and is not
            # refined further (or it is the finest level)
            applies = ok & ~has_child if l > 0 else ok
            out = torch.where(applies, val, out)
        return out

    def sample(self, x_world: torch.Tensor) -> torch.Tensor:
        """Trilinear sampling of the hierarchical field by 2^dim probes at
        the surrounding leaf-cell centres.  The JAX module probes each
        centre's world position, which maps back to the same leaf cell;
        the port probes the cell, with one inverse transform a call."""
        xi = self.transform.inverse().apply(x_world) - 0.5
        base = torch.floor(xi)
        frac = xi - base
        cell0 = base.to(torch.int32)
        out = None
        for c in neighbor_offsets(self.dim, 0, 1):
            w = torch.ones(xi.shape[:-1], dtype=xi.dtype, device=xi.device)
            for d in range(self.dim):
                w = w * (frac[..., d] if c[d] else 1.0 - frac[..., d])
            v = self._probe_cells(cell0 + torch.as_tensor(
                c, dtype=torch.int32, device=xi.device))
            out = w * v if out is None else out + w * v
        return out

    def sample_gradient(self, x_world: torch.Tensor) -> torch.Tensor:
        """Gradient of the trilinear field at each point, by
        ``torch.func.grad`` through the weights (the probes are piecewise
        constant): 0 where the field is constant, as JAX's autodiff gives.
        Each point's sample depends on that point alone, so the gradient of
        the sum is every point's own."""
        pts = x_world.reshape(-1, self.dim)
        g = torch.func.grad(lambda p: torch.sum(self.sample(p)))(pts)
        return g.reshape(x_world.shape)

    def sample_staggered(self, x_world: torch.Tensor) -> torch.Tensor:
        """MAC sampling (SparseGrid.hpp:418-498): component d samples the
        scalar field on faces offset by dx/2 along d."""
        dxw = self.transform.matrix[0, 0]
        comps = []
        for d in range(self.dim):
            shift = torch.zeros((self.dim,), dtype=x_world.dtype,
                                device=x_world.device)
            shift[d] = 0.5 * dxw
            comps.append(self.sample(x_world + shift))
        return torch.stack(comps, dim=-1)

    def update_leaf_values(self, leaf_cells: torch.Tensor,
                           leaf_values: torch.Tensor):
        """Write values into existing leaf cells, keeping the topology.
        Returns ``(grid, overflow)``; ``overflow`` (a 0-d bool tensor) is
        set when a written cell's leaf block is inactive (activate it
        first with :meth:`activate_leaves`), and that write is dropped."""
        lev = self.levels[0]
        bs = self.block_sizes[0]
        block = _floordiv(leaf_cells, bs)
        lin = _linear(leaf_cells - block * bs, bs, self.dim)
        slot = lev.table.query(block)
        overflow = torch.any(slot < 0)
        ncell = bs ** self.dim
        flat_idx = torch.where(slot >= 0, slot * ncell + lin,
                               lev.capacity * ncell).long()
        buf = torch.cat([lev.value.reshape(-1),
                         lev.value.new_zeros((1,))])
        buf[flat_idx.reshape(-1)] = leaf_values.reshape(-1).to(buf.dtype)
        value = buf[:-1].reshape(lev.capacity, ncell)
        levels = (dataclasses.replace(lev, value=value),) + self.levels[1:]
        return dataclasses.replace(self, levels=levels), overflow

    def activate_leaves(self, leaf_cells: torch.Tensor):
        """Extend the leaf topology (by whole leaf blocks) with the blocks
        covering ``leaf_cells``, keeping every stored value, and rebuild
        the coarser levels' child masks.  Returns ``(grid, overflow)``:
        ``overflow`` when a level's capacity is exceeded."""
        lev0 = self.levels[0]
        bs0 = self.block_sizes[0]
        dim = self.dim
        cap0 = lev0.capacity
        dev = leaf_cells.device
        old_coords = lev0.table.active_coords
        old_valid = lev0.table.mask
        cat = torch.cat([old_coords, _floordiv(leaf_cells, bs0)])
        catmask = torch.cat([old_valid,
                             torch.ones(leaf_cells.shape[:-1],
                                        dtype=torch.bool, device=dev)])
        table, _ = build_block_table(cat, cap0, valid=catmask, dim=dim)
        overflow = table.count > cap0
        # move the old payload rows to their new slots
        ncell = bs0 ** dim
        dst = table.query(old_coords)
        dst = torch.where(old_valid & (dst >= 0), dst, cap0).long()
        value = torch.full((cap0 + 1, ncell), self.background,
                           dtype=lev0.value.dtype, device=dev)
        value[dst] = lev0.value
        child = torch.zeros((cap0 + 1, ncell), dtype=torch.bool, device=dev)
        child[dst] = lev0.child
        levels = [AdaptiveLevel(table, value[:cap0], child[:cap0])]
        # the coarser child masks, from the new finer block keys
        span = bs0
        fine_cells = table.active_coords * bs0          # block origin cells
        fine_valid = table.mask
        for l in range(1, len(self.levels)):
            lev = self.levels[l]
            bs = self.block_sizes[l]
            cap = lev.capacity
            cell_l = _floordiv(fine_cells, span)
            block_l = _floordiv(cell_l, bs)
            tbl, inv = build_block_table(block_l, cap, valid=fine_valid,
                                         dim=dim)
            overflow = overflow | (tbl.count > cap)
            lin = _linear(cell_l - block_l * bs, bs, dim)
            nc = bs ** dim
            flat = torch.where((inv >= 0) & fine_valid, inv * nc + lin,
                               cap * nc).long()
            cmask = torch.zeros((cap * nc + 1,), dtype=torch.bool,
                                device=dev)
            cmask[flat] = True
            # carry the coarse values over by key (constant tiles)
            vdst = tbl.query(lev.table.active_coords)
            vdst = torch.where(lev.table.mask & (vdst >= 0), vdst,
                               cap).long()
            cval = torch.full((cap + 1, nc), self.background,
                              dtype=lev.value.dtype, device=dev)
            cval[vdst] = lev.value
            levels.append(AdaptiveLevel(tbl, cval[:cap],
                                        cmask[:-1].reshape(cap, nc)))
            span *= bs
            # the next level's fine keys are this level's blocks, as
            # their leaf-cell origins
            fine_cells = tbl.active_coords * span
            fine_valid = tbl.mask
        return dataclasses.replace(self, levels=tuple(levels)), overflow


def adaptive_grid_from_leaves(leaf_cells: torch.Tensor,
                              leaf_values: torch.Tensor, *, dx: float,
                              block_sizes: Sequence[int] = (8, 4, 4),
                              capacities: Optional[Sequence[int]] = None,
                              background: float = 0.0,
                              coarse_values: Optional[Sequence] = None,
                              origin=None) -> AdaptiveGrid:
    """Build from active leaf cells (int coords ``[n, dim]``, values
    ``[n]``) on their device.  The coarser levels get child masks where
    finer blocks exist; their values are ``background`` (or the per-level
    constants of ``coarse_values``), VDB's interior tiles."""
    dim = leaf_cells.shape[-1]
    dev = leaf_cells.device
    leaf_cells = leaf_cells.to(torch.int32)
    capacities = capacities or [max(64, leaf_cells.shape[0]), 512, 64]
    levels = []
    span = 1
    for l, bs in enumerate(block_sizes):
        cap = capacities[l]
        nc = bs ** dim
        cell_l = _floordiv(leaf_cells, span)
        block_l = _floordiv(cell_l, bs)
        table, inv = build_block_table(block_l, cap, dim=dim)
        lin = _linear(cell_l - block_l * bs, bs, dim)
        flat_idx = torch.where(inv >= 0, inv * nc + lin, cap * nc).long()
        value = torch.full((cap, nc), background, dtype=leaf_values.dtype,
                           device=dev)
        child = torch.zeros((cap, nc), dtype=torch.bool, device=dev)
        if l == 0:
            buf = torch.full((cap * nc + 1,), background,
                             dtype=leaf_values.dtype, device=dev)
            buf[flat_idx] = leaf_values
            value = buf[:-1].reshape(cap, nc)
        else:
            cbuf = torch.zeros((cap * nc + 1,), dtype=torch.bool, device=dev)
            cbuf[flat_idx] = True
            child = cbuf[:-1].reshape(cap, nc)
            if coarse_values is not None and coarse_values[l] is not None:
                value = torch.full_like(value, coarse_values[l])
        levels.append(AdaptiveLevel(table, value, child))
        span *= bs
    tr = scaling(dx, device=dev)
    if origin is not None:
        tr = translation(origin, device=dev).compose(tr)
    return AdaptiveGrid(tuple(levels), tr, tuple(block_sizes), dim,
                        background)


def adaptive_from_sdf(levelset, *, dx: float, lo, hi, band: float,
                      device: Optional[torch.device] = None,
                      block_sizes: Sequence[int] = (8, 4, 4),
                      capacities: Optional[Sequence[int]] = None,
                      origin=None) -> AdaptiveGrid:
    """A level set's SDF sampled into a narrow-band adaptive grid on
    ``device`` (the card when None): leaf cells only where ``|sdf| < band`` at the cell centre,
    the background ``+band`` everywhere else (off the band a point reads
    "outside", so size the band to cover every node that must read
    inside).  The SDF is evaluated at every cell centre of the box
    ``[lo, hi)`` on the device, the centres computed in float64 and
    rounded to float32 as the JAX module's numpy does."""
    device = cuda_device() if device is None else device
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    org = lo if origin is None else np.asarray(origin, np.float32)
    res = np.maximum(((hi - lo) / dx).astype(np.int64), 1)
    dim = lo.shape[0]
    axes = [torch.arange(int(r), device=device) for r in res]
    cells = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                        -1).reshape(-1, dim)
    centers = ((cells.double() + 0.5) * dx +
               torch.as_tensor(org, dtype=torch.float64, device=device))
    vals = levelset.sdf(centers.float())
    keep = vals.abs() < band
    leaf_cells = cells[keep].to(torch.int32)
    leaf_vals = vals[keep].to(torch.float32)
    if capacities is None:
        blocks = torch.unique(_floordiv(leaf_cells, block_sizes[0]), dim=0)
        nblk = max(64, int(blocks.shape[0]) * 2)
        capacities = [nblk, max(64, nblk // 8), 64]
    return adaptive_grid_from_leaves(
        leaf_cells, leaf_vals, dx=dx, block_sizes=block_sizes,
        capacities=capacities, background=float(band), origin=org)


class AdaptiveGridLevelSet(LevelSet):
    """A level set over a scalar AdaptiveGrid SDF, to put into a
    :class:`~zpc_tpu_torch.geometry.collider.Collider` as an MPM boundary
    (the grid-backed collision SDF); static, ``inside`` where the SDF is
    negative."""

    def __init__(self, grid: AdaptiveGrid):
        self.grid = grid

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        return self.grid.sample(x)

    def normal(self, x: torch.Tensor) -> torch.Tensor:
        g = self.grid.sample_gradient(x)
        return g / torch.linalg.vector_norm(g, dim=-1,
                                            keepdim=True).clamp_min(1e-12)
