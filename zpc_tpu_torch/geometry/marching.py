"""Iso-surfaces by marching tetrahedra (counterpart of
``zpc_tpu/geometry/marching.py``).

Each cube of a dense grid splits into 6 tetrahedra around its 0-7
diagonal; the 16-case table is derived at import.  Every triangle is turned
so that its normal points from the tetrahedron's inside corners
(``sdf < iso``) to its outside ones.  The output is a fixed-capacity
triangle soup in cube-then-tetrahedron order, with its count and an
overflow flag; :func:`weld` merges its corners into a mesh.

Three tetrahedra of the table ([0, 3, 2, 7], [0, 6, 4, 7], [0, 5, 1, 7])
list an upper corner before a lower one, so each cube interpolates three
of its axis edges from the far end, where the neighbouring cube's
tetrahedra interpolate the same grid edge from the near end: the two
crossing points may differ by a rounding, and the soup's shared corners
are equal only to within that.  The table is the JAX package's, so that
the soups agree.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..math.rounding import cross, div_rn, dot

__all__ = ["TriSoup", "marching_tets", "surface_from_levelset", "weld"]

# cube corners, bit order x + 2y + 4z
_CORNERS = np.array([[b & 1, (b >> 1) & 1, (b >> 2) & 1] for b in range(8)])

# 6 tetrahedra around the 0-7 diagonal
_TETS = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
                  [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]])

# tetrahedron edges (pairs of local corners 0..3)
_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])


def _build_case_table():
    """[16, 2, 3] edge ids per case (-1 = unused): the edges that carry the
    (up to two) triangles' vertices."""
    def edge_id(a, b):
        return next(e for e, (u, v) in enumerate(_EDGES) if {a, b} == {u, v})

    table = -np.ones((16, 2, 3), np.int64)
    for case in range(1, 15):
        inside = [i for i in range(4) if case >> i & 1]
        outside = [i for i in range(4) if not case >> i & 1]
        if len(inside) == 1:
            table[case, 0] = [edge_id(inside[0], b) for b in outside]
        elif len(inside) == 3:
            table[case, 0] = [edge_id(outside[0], b) for b in inside]
        else:
            a, b = inside
            c, d = outside
            q = [edge_id(a, c), edge_id(a, d), edge_id(b, d), edge_id(b, c)]
            table[case, 0] = [q[0], q[1], q[2]]
            table[case, 1] = [q[0], q[2], q[3]]
    return table


_CASE_TABLE = _build_case_table()


class TriSoup(NamedTuple):
    verts: torch.Tensor     # [capacity, 3, 3] triangle corners (world)
    count: torch.Tensor     # 0-d int32: triangles found
    overflow: torch.Tensor  # 0-d bool: more than capacity


def marching_tets(sdf: torch.Tensor, dx, *, iso=0.0, origin=None,
                  capacity: int = 65536) -> TriSoup:
    """The ``iso`` surface of a dense ``[X, Y, Z]`` field with node spacing
    ``dx`` and node 0 at ``origin``.  Triangles past ``capacity`` are
    dropped and ``overflow`` set."""
    X, Y, Z = sdf.shape
    dev, dt = sdf.device, sdf.dtype
    origin = (torch.zeros(3, dtype=dt, device=dev) if origin is None
              else torch.as_tensor(origin, dtype=dt, device=dev))
    dx = torch.as_tensor(dx, dtype=dt, device=dev)
    # per-cube corner values, bit order x + 2y + 4z -> [nC, 8]
    vals = torch.stack([sdf[cx:cx + X - 1, cy:cy + Y - 1, cz:cz + Z - 1]
                        for cx, cy, cz in _CORNERS], -1).reshape(-1, 8)
    nC = vals.shape[0]
    cube_idx = torch.stack(torch.meshgrid(
        torch.arange(X - 1, device=dev), torch.arange(Y - 1, device=dev),
        torch.arange(Z - 1, device=dev), indexing="ij"),
        -1).reshape(-1, 3).to(dt)
    corners = torch.as_tensor(_CORNERS, dtype=dt, device=dev)
    table = torch.as_tensor(_CASE_TABLE, device=dev)
    ea = torch.as_tensor(_EDGES[:, 0], device=dev)
    eb = torch.as_tensor(_EDGES[:, 1], device=dev)
    bit = torch.tensor([1, 2, 4, 8], device=dev)

    def one_tet(tet):
        tv = vals[:, tet]                                  # [nC, 4]
        tpos = (cube_idx[:, None, :] + corners[tet]) * dx + origin
        inside = tv < iso
        case = (inside.long() * bit).sum(-1)
        # the 6 edge crossings, interpolated linearly (clamped)
        va, vb = tv[:, ea], tv[:, eb]                      # [nC, 6]
        dv = vb - va
        t = torch.clamp(div_rn(iso - va, torch.where(dv.abs() > 1e-30, dv,
                                                     1.0)), 0.0, 1.0)
        pa, pb = tpos[:, ea], tpos[:, eb]
        ep = pa + t[..., None] * (pb - pa)                 # [nC, 6, 3]
        tri_e = table[case]                                # [nC, 2, 3]
        valid = tri_e[:, :, 0] >= 0
        tri_p = torch.gather(ep, 1, tri_e.clamp_min(0).reshape(nC, 6, 1)
                             .expand(-1, -1, 3)).reshape(nC, 2, 3, 3)
        # turn each triangle so its normal points inside -> outside
        # (sums and products written out in one order, divisions rounded
        # once: the card rounds as the CPU does)
        w = inside.to(dt)
        n_in = w.sum(-1, keepdim=True).clamp_min(1.0)
        n_out = (1.0 - w).sum(-1, keepdim=True).clamp_min(1.0)
        wi, wo = div_rn(w, n_in), div_rn(1.0 - w, n_out)
        c_in = sum(wi[:, k, None] * tpos[:, k] for k in range(4))
        c_out = sum(wo[:, k, None] * tpos[:, k] for k in range(4))
        nrm = cross(tri_p[:, :, 1] - tri_p[:, :, 0],
                    tri_p[:, :, 2] - tri_p[:, :, 0])
        flip = (dot(nrm, (c_out - c_in)[:, None, :]) < 0)[..., None]
        p1 = torch.where(flip, tri_p[:, :, 2], tri_p[:, :, 1])
        p2 = torch.where(flip, tri_p[:, :, 1], tri_p[:, :, 2])
        return torch.stack([tri_p[:, :, 0], p1, p2], 2), valid

    tris, valids = zip(*(one_tet(torch.as_tensor(tet, device=dev))
                         for tet in _TETS))
    tri_all = torch.cat(tris, 1).reshape(-1, 3, 3)
    val_all = torch.cat(valids, 1).reshape(-1)
    sel = torch.nonzero(val_all).flatten()
    count = torch.tensor(sel.numel(), dtype=torch.int32, device=dev)
    verts = torch.zeros((capacity, 3, 3), dtype=dt, device=dev)
    keep = sel[:capacity]
    verts[:keep.numel()] = tri_all[keep]
    return TriSoup(verts, count, count > capacity)


def surface_from_levelset(ls, *, iso=0.0, capacity: int = 65536) -> TriSoup:
    """Surface a :class:`~.sparse_levelset.SparseLevelSet`: its active
    blocks' bounding box, one node wider on every side, made dense (the
    background outside the blocks), then marched."""
    from .sparse_grid import sparse_grid_to_dense
    g = ls.grid
    bs = g.block_size
    coords = g.table.active_coords[g.table.mask].cpu().numpy()
    lo = coords.min(0) * bs - 1
    hi = (coords.max(0) + 1) * bs + 1
    dense = sparse_grid_to_dense(g, "sdf", lo, hi,
                                 default=float(ls.background))
    origin = g.index_to_world(torch.as_tensor(lo, dtype=torch.float32,
                                              device=dense.device))
    return marching_tets(dense, g.dx, iso=iso, origin=origin,
                         capacity=capacity)


def weld(tris: torch.Tensor, tol: float):
    """Merge the corners of a triangle soup ``[m, 3, 3]`` into vertices and
    drop the triangles that collapse.  Corners that share a cell of any of
    8 lattices of spacing ``4 tol`` (shifted by half a cell on each axis)
    merge, transitively: so corners within ``tol`` of each other on every
    axis always merge, and corners more than ``4 tol`` apart on some axis
    never do directly.  Returns ``(vertices [k, 3], faces [m', 3])``, faces
    int64 in the soup's order."""
    v = tris.reshape(-1, 3)
    u = (v - v.amin(0)) / (4.0 * tol)
    keys = []
    for off in range(8):
        shift = torch.tensor([0.5 * ((off >> d) & 1) for d in range(3)],
                             dtype=u.dtype, device=v.device)
        q = torch.floor(u + shift).to(torch.int64)
        keys.append(torch.unique(q, dim=0, return_inverse=True)[1])
    label = torch.arange(v.shape[0], device=v.device)
    while True:
        prev = label
        for inv in keys:
            low = torch.full((int(inv.max()) + 1,), v.shape[0],
                             dtype=torch.int64, device=v.device)
            low = low.scatter_reduce(0, inv, label, "amin")
            label = low[inv]
        label = label[label]
        if torch.equal(label, prev):
            break
    ids, faces = torch.unique(label, return_inverse=True)
    faces = faces.view(-1, 3)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return v[ids], faces[ok]
