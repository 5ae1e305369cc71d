"""SparseGrid and AdaptiveGrid <-> ``.vdb`` conversion (counterpart of
``zpc_tpu/geometry/vdb_bridge.py``; reference ``geometry/VdbLevelSet.h:
26-99``, ``VdbLevelSet_Conversion.cpp``, ``SparseGrid_Conversion.cpp``,
``AdaptiveGrid_Conversion.cpp``), over the port's codec
:mod:`zpc_tpu_torch.utils.vdb`.

A VDB leaf (8^3 voxels) covers exactly 2^3 SparseGrid blocks of 4^3 cells,
so the conversion is reshapes and one scatter of whole blocks on the host,
no loop over voxels.  3-D grids of block size 4 only.  Scalar properties
map to FloatGrid/Int32Grid; a 3-vector property (a velocity field, the
``readVelVdb`` surface) to one Vec3SGrid (``save_vdb(vec3=True)``) or to
one scalar grid per component.  Grids read from a file are built on
``device``, the card when None.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..containers.block_table import build_block_table
from ..core.config import prop as _prop
from ..core.executor import cuda_device
from ..utils.vdb import LEAF_DIM, VdbGrid, read_vdb, write_vdb
from .adaptive_grid import AdaptiveGrid, adaptive_grid_from_leaves
from .sparse_grid import SparseGrid, sparse_grid

__all__ = ["sparse_grid_to_vdb_grid", "vdb_grid_to_sparse_grid",
           "save_vdb", "load_vdb_grids", "adaptive_to_vdb_grid",
           "vdb_grid_to_adaptive"]

_BS = 4                      # SparseGrid block side; leaf = 2x2x2 blocks


def _require_3d_bs4(grid: SparseGrid):
    if grid.dim != 3 or grid.block_size != _BS:
        raise ValueError("vdb bridge supports dim=3, block_size=4 grids")


def _transform_fields(matrix: torch.Tensor):
    """(voxel size, translation) of an isotropic index-to-world matrix."""
    tr = matrix.detach().cpu().numpy()
    return (float(np.linalg.norm(tr[:3, 0])),
            tuple(float(t) for t in tr[:3, 3]))


def sparse_grid_to_vdb_grid(grid: SparseGrid, prop_name: str, *,
                            name: Optional[str] = None,
                            background=0.0,
                            grid_class: str = "unknown",
                            component: Optional[int] = None) -> VdbGrid:
    """One property as a :class:`VdbGrid` (on the host).  A scalar property
    becomes FloatGrid/Int32Grid leaves; a 3-vector property a
    ``Tree_vec3s_5_4_3`` grid unless ``component`` picks one channel."""
    _require_3d_bs4(grid)
    count = int(grid.table.count)
    coords = grid.table.active_coords[:count].cpu().numpy().astype(np.int64)
    data = grid.data[prop_name][:count].cpu().numpy()
    if component is not None:
        data = data[..., component]
    if data.ndim == 2:
        vec = 1
        ch = ()
    elif data.ndim == 3 and data.shape[-1] == 3:
        vec = 3
        ch = (3,)
        if np.asarray(background).ndim == 0:
            background = (float(background),) * 3
    else:
        raise ValueError(f"{prop_name!r} is neither scalar nor 3-vector; "
                         "pass component=")
    blocks = data.reshape((count, _BS, _BS, _BS) + ch)          # x-major
    leaf_of = coords // 2
    sub = coords - leaf_of * 2                                  # [nb,3] 0/1
    uniq, inv = np.unique(leaf_of, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    # leaf [nl, 2, 4, 2, 4, 2, 4(, 3)]: block b at (sub_x, :, sub_y, :,
    # sub_z, :) of leaf inv[b]
    leaves = np.empty((len(uniq), 2, _BS, 2, _BS, 2, _BS) + ch, data.dtype)
    leaves[...] = np.asarray(background, data.dtype)
    leaves[inv, sub[:, 0], :, sub[:, 1], :, sub[:, 2], :] = blocks
    leaves = leaves.reshape((len(uniq),) + (LEAF_DIM,) * 3 + ch)
    voxel, trans = _transform_fields(grid.transform.matrix)
    return VdbGrid(name or prop_name,
                   {tuple(int(c) * LEAF_DIM for c in lc): leaves[i]
                    for i, lc in enumerate(uniq)},
                   voxel_size=voxel, translation=trans,
                   background=background, grid_class=grid_class, vec=vec)


def vdb_grid_to_sparse_grid(vg: VdbGrid, prop_name: str = "v", *,
                            block_capacity: Optional[int] = None,
                            extra_props: Sequence = (),
                            device: Optional[torch.device] = None
                            ) -> SparseGrid:
    """A SparseGrid on ``device`` holding ``prop_name`` from a VdbGrid
    (a scalar grid gives a scalar property, a Vec3s grid a 3-channel
    one).  Raises when ``block_capacity`` is below the leaves' blocks."""
    dev = cuda_device() if device is None else device
    origins = np.asarray(sorted(vg.leaves), np.int64)           # [nl, 3]
    nl = len(origins)
    sub = np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"),
                   -1).reshape(8, 3)
    bcoords = (origins[:, None, :] // _BS + sub[None, :, :]).reshape(-1, 3)
    vals = np.stack([vg.leaves[tuple(o)] for o in origins])  # [nl,8,8,8(,c)]
    ch = vals.shape[4:]
    # each leaf -> 8 blocks of 4^3: split each axis into (2, 4)
    blocks = vals.reshape((nl, 2, _BS, 2, _BS, 2, _BS) + ch) \
        .transpose((0, 1, 3, 5, 2, 4, 6) + tuple(range(7, 7 + len(ch)))) \
        .reshape((nl * 8, _BS ** 3) + ch)
    cap = block_capacity or max(64, 1 << int(np.ceil(np.log2(nl * 8))))
    table, inverse = build_block_table(
        torch.as_tensor(bcoords, dtype=torch.int32, device=dev), cap)
    if int(table.count) > table.capacity:
        raise ValueError(f"block_capacity {cap} < {int(table.count)} blocks")
    p0 = _prop(prop_name, ch[0]) if ch else _prop(prop_name)
    g = sparse_grid([p0] + list(extra_props), dx=vg.voxel_size,
                    block_capacity=cap, device=dev, dim=3,
                    origin=np.asarray(vg.translation, np.float32),
                    dtype=torch.from_numpy(blocks[:0]).dtype)
    arr = torch.zeros_like(g.data[prop_name])
    arr[inverse.long()] = torch.from_numpy(np.ascontiguousarray(blocks)).to(
        dev)
    return dataclasses.replace(g, table=table,
                               data={**g.data, prop_name: arr})


def save_vdb(path: str, grid: SparseGrid, props: Sequence[str], *,
             background: float = 0.0, grid_class: str = "unknown",
             compress: bool = False, vec3: bool = False):
    """Write named scalar or vector properties of a SparseGrid to ``path``:
    a 3-vector property as one Vec3SGrid with ``vec3=True``, else as one
    scalar grid per component (``"v.0"``, ...)."""
    out: List[VdbGrid] = []
    for p in props:
        a = grid.data[p]
        if a.dim() == 2 or (vec3 and a.shape[-1] == 3):
            out.append(sparse_grid_to_vdb_grid(
                grid, p, background=background, grid_class=grid_class))
        else:
            for c in range(a.shape[-1]):
                out.append(sparse_grid_to_vdb_grid(
                    grid, p, name=f"{p}.{c}", background=background,
                    grid_class=grid_class, component=c))
    write_vdb(path, out, compress=compress)


def load_vdb_grids(path: str, *, block_capacity: Optional[int] = None,
                   device: Optional[torch.device] = None):
    """Every grid in ``path`` as ``{name: SparseGrid}`` on ``device``."""
    return {vg.name: vdb_grid_to_sparse_grid(
        vg, vg.name.split(".")[0] or "v", block_capacity=block_capacity,
        device=device)
        for vg in read_vdb(path)}


def adaptive_to_vdb_grid(ag: AdaptiveGrid, *, name: str = "adaptive",
                         grid_class: str = "unknown") -> VdbGrid:
    """AdaptiveGrid -> VdbGrid: the leaf level (a leaf block size of 8, the
    VDB leaf).  Coarse constant tiles are not written (the codec writes no
    tile stream), so a round trip keeps the leaf topology and values and
    rebuilds the coarse child masks on reading, where
    AdaptiveGrid_Conversion.cpp writes interior tiles."""
    if ag.block_sizes[0] != 8 or ag.dim != 3:
        raise ValueError("adaptive_to_vdb_grid needs dim=3, leaf bs=8")
    lev = ag.levels[0]
    count = int(lev.table.count)
    coords = lev.table.active_coords[:count].cpu().numpy()
    vals = lev.value[:count].cpu().numpy().reshape(count, 8, 8, 8)
    voxel, trans = _transform_fields(ag.transform.matrix)
    return VdbGrid(name, {tuple(int(c) * 8 for c in coords[i]): vals[i]
                          for i in range(count)},
                   voxel_size=voxel, translation=trans,
                   background=ag.background, grid_class=grid_class)


def vdb_grid_to_adaptive(vg: VdbGrid, *, block_sizes=(8, 4, 4),
                         capacities=None,
                         device: Optional[torch.device] = None
                         ) -> AdaptiveGrid:
    """VdbGrid -> AdaptiveGrid on ``device``: the leaves become level-0
    blocks; the coarser levels get child masks (their values the
    background, constant tiles)."""
    dev = cuda_device() if device is None else device
    origins = np.asarray(sorted(vg.leaves), np.int64)
    nl = len(origins)
    off = np.stack(np.meshgrid(*([np.arange(8)] * 3), indexing="ij"),
                   -1).reshape(-1, 3)
    cells = (origins[:, None, :] + off[None]).reshape(-1, 3)
    vals = np.stack([vg.leaves[tuple(o)] for o in origins]).reshape(-1)
    if capacities is None:
        cap0 = max(64, 1 << int(np.ceil(np.log2(max(nl, 1)))))
        capacities = [cap0, max(64, cap0 // 4), 64]
    return adaptive_grid_from_leaves(
        torch.as_tensor(cells, dtype=torch.int32, device=dev),
        torch.as_tensor(vals, dtype=torch.float32, device=dev),
        dx=vg.voxel_size, block_sizes=block_sizes, capacities=capacities,
        background=vg.background,
        origin=np.asarray(vg.translation, np.float32))
