"""Narrow-band signed distance fields on a block-sparse grid (counterpart
of ``zpc_tpu/geometry/sparse_levelset.py``).

A :class:`SparseLevelSet` is a :class:`~.sparse_grid.SparseGrid` with an
``sdf`` property (and an optional ``vel``) and a background distance read
outside its blocks; it is a :class:`~.levelset.LevelSet`, so a
:class:`~.collider.Collider` takes it.  It is built from an analytic level
set or from a point cloud (the union of spheres, how a particle fluid is
surfaced), and :func:`flood_fill` sweeps ``|phi| <- min(|phi|, min over the
six face neighbours of |phi| + dx)`` over the band.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.config import prop
from ..math.rounding import div_rn, sqrt_rn
from .levelset import LevelSet
from .sparse_grid import SparseGrid, neighbor_offsets, sparse_grid

__all__ = ["SparseLevelSet", "levelset_from_analytic",
           "levelset_from_points", "flood_fill", "redistance"]

_NODES, _POINTS = 8192, 8192   # the distance search's chunks


@dataclasses.dataclass(frozen=True)
class SparseLevelSet(LevelSet):
    """Narrow-band SDF on a block-sparse grid; outside its blocks the field
    is ``background``."""

    grid: SparseGrid
    background: torch.Tensor    # 0-d: the far field's distance

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        return self.grid.sample("sdf", x, default=self.background)

    def velocity(self, x: torch.Tensor) -> torch.Tensor:
        if "vel" in self.grid.data:
            return self.grid.sample("vel", x, default=0.0)
        return torch.zeros_like(x)


def _device_of(obj) -> torch.device:
    """The device of the first tensor among a level set's fields (the
    card if it holds none)."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            for item in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(item, torch.Tensor) or \
                        dataclasses.is_dataclass(item):
                    return _device_of(item)
    from ..core.executor import cuda_device
    return cuda_device()


def levelset_from_analytic(ls: LevelSet, lo, hi, dx: float,
                           block_capacity: int = 4096,
                           band: float = 3.0) -> SparseLevelSet:
    """Rasterise an analytic level set over the box ``[lo, hi]``: the
    blocks whose centre lies within ``band * dx`` plus a block's half
    diagonal outside the surface (the whole interior stays, so the field
    is negative deep inside), on the level set's device; values clipped to
    ``+-4 band dx``."""
    dev = _device_of(ls)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    bs = 4
    bdx = dx * bs
    axes = [np.arange(int(np.floor(lo[d] / bdx)) - 1,
                      int(np.ceil(hi[d] / bdx)) + 1) for d in range(3)]
    blocks = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    centers = torch.as_tensor((blocks + 0.5) * bdx, dtype=torch.float32,
                              device=dev)
    d = ls.sdf(centers).cpu().numpy()
    keep = d <= band * dx + bdx * np.sqrt(3) / 2
    g = sparse_grid([prop("sdf")], dx=dx, block_capacity=block_capacity,
                    device=dev)
    g = g.activate(torch.as_tensor(blocks[keep], dtype=torch.int32,
                                   device=dev))
    node_x = g.node_world_positions()
    vals = ls.sdf(node_x.reshape(-1, 3)).reshape(node_x.shape[:-1])
    vals = torch.clamp(vals, -band * dx * 4, band * dx * 4)
    return SparseLevelSet(g.with_data(sdf=vals), torch.tensor(
        band * dx * 4, dtype=torch.float32, device=dev))


def _nearest_distance(nodes: torch.Tensor, pts: torch.Tensor
                      ) -> torch.Tensor:
    """Distance from every node to its nearest point, by brute force in
    chunks (elementwise operations and a square root rounded once, so the
    card's values equal the CPU's bit for bit)."""
    out = torch.empty(nodes.shape[0], dtype=nodes.dtype, device=nodes.device)
    for i in range(0, nodes.shape[0], _NODES):
        nd = nodes[i:i + _NODES]
        best = torch.full((nd.shape[0],), float("inf"), dtype=nodes.dtype,
                          device=nodes.device)
        for j in range(0, pts.shape[0], _POINTS):
            p = pts[j:j + _POINTS]
            d2 = None
            for k in range(3):
                t = nd[:, None, k] - p[None, :, k]
                d2 = t * t if d2 is None else d2 + t * t
            best = torch.minimum(best, d2.amin(1))
        out[i:i + _NODES] = sqrt_rn(best)
    return out


def levelset_from_points(x: torch.Tensor, dx: float, radius: float,
                         block_capacity: int = 4096,
                         band: int = 2) -> SparseLevelSet:
    """The union of spheres of ``radius`` around the points ``x [n, 3]``
    (surfacing a particle fluid): the blocks within ``band`` cells of a
    point, dilated by one block, hold the distance to the nearest of *all*
    points minus ``radius``.  The background is ``4 band dx``.  Blocks past
    ``block_capacity`` are dropped: size it so that
    ``build_overflowed(ls.grid.table)`` stays False."""
    dev = x.device
    cells = torch.floor(div_rn(x, dx)).to(torch.int32)
    # the blocks of the cells within `band` of each point's cell: the
    # distinct block offsets of the (2 band + 1)^3 cell offsets
    offs = np.unique(np.floor_divide(neighbor_offsets(3, -band, band), 4),
                     axis=0)
    cand = (torch.div(cells, 4, rounding_mode="floor")[:, None, :]
            + torch.as_tensor(offs, device=dev)[None]).reshape(-1, 3)
    g = sparse_grid([prop("sdf")], dx=dx, block_capacity=block_capacity,
                    device=dev)
    g = g.activate(cand, dilation=1)
    # the active blocks fill the table's first slots; the rest are never
    # read and keep the background
    nb = min(int(g.table.count), g.block_capacity)
    background = 4 * band * dx
    node_x = g.node_world_positions()[:nb].reshape(-1, 3)
    sdf = torch.full((g.block_capacity, g.cells_per_block), background,
                     dtype=x.dtype, device=dev)
    sdf[:nb] = (_nearest_distance(node_x, x) - radius).view(nb, -1)
    return SparseLevelSet(g.with_data(sdf=sdf), torch.tensor(
        background, dtype=torch.float32, device=dev))


def _face_neighbor_slots(grid: SparseGrid):
    """Payload index of the six face neighbours of every cell ``[nb, bs^3]``
    (-1 where the neighbour's block is inactive)."""
    bs = grid.block_size
    corners = torch.as_tensor(neighbor_offsets(3, 0, bs - 1),
                              device=grid.table.keys.device)
    cells = grid.table.active_coords[:, None, :] * bs + corners[None]
    out = []
    for d in range(3):
        for s in (-1, 1):
            off = torch.zeros(3, dtype=cells.dtype, device=cells.device)
            off[d] = s
            out.append(grid.cell_slot(cells + off))
    return out


def flood_fill(ls: SparseLevelSet, iters: int = 16) -> SparseLevelSet:
    """``iters`` sweeps of ``|phi| <- min(|phi|, min over the six face
    neighbours of |phi| + dx)`` over the band, signs kept (0 counts as
    positive); a neighbour in an inactive block counts as 1e9."""
    g = ls.grid
    dx = g.dx
    phi = g.data["sdf"]
    slots = _face_neighbor_slots(g)
    for _ in range(iters):
        mag = phi.abs()
        flat = mag.reshape(-1)
        nmin = torch.full_like(mag, 1e9)
        for slot in slots:
            nmin = torch.minimum(nmin, torch.where(
                slot >= 0, flat[slot.clamp_min(0).long()], 1e9))
        phi = torch.sign(torch.where(phi == 0, 1.0, phi)) * torch.minimum(
            mag, nmin + dx)
    return SparseLevelSet(g.with_data(sdf=phi), ls.background)


def redistance(ls: SparseLevelSet, iters: int = 8) -> SparseLevelSet:
    """Approximate re-distancing: the flood fill's sweeps."""
    return flood_fill(ls, iters)
