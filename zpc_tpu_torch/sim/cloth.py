"""Codimensional cloth: stretch, hinge bending and the IPC ground barrier
with lagged friction and vertex-triangle self-contact, implicit Euler by
Newton-CG (counterpart of ``zpc_tpu/sim/cloth.py``).

The incremental potential ``Phi(y) = 1/(2 dt^2) |y - xhat|^2_M + E(y)`` is
differentiated by autograd; Newton directions come from matrix-free CG,
either on the assembled Gauss-Newton operator (:func:`assemble_operator`,
cached once per Newton round and applied by :func:`apply_operator`) or on
exact Hessian-vector products (``operator="autodiff"``: a double-backward
product through the gradient's graph, which is built once per Newton round
and replayed by every CG iteration).  The ground-plane step limiter is the
analytic half-space form of IPC's CCD line search; self-contact adds a
conservative-advancement CCD limiter over the lagged candidate set.

Topology (triangles, edges, hinges, the incidence tables and the grid
stencil) is built on the host with numpy, once.  Every layout of the JAX
package is kept: the slice-form stencil of regular grids
(:class:`ClothStencil`), the window-stencil self-contact
(:class:`ContactWindow`) with its indexed residue, and the active-set
compaction of the dense contact rows (``contact_budget``).  Capacity
overflows (candidates per vertex, out-of-band broad-phase queries, residue
and active-set budgets) set the returned flag; nothing raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.executor import cuda_device
from ..geometry.contact import (barrier, barrier_grad, barrier_hess,
                                friction_f0, friction_f1_over_x)
from ..geometry.dihedral import (dihedral_angle, dihedral_angle_gradient,
                                 hinge_bending_energy)
from ..geometry.distance import point_triangle_ccd, point_triangle_closest
from ..math.solvers import cg

__all__ = ["ClothSim", "ClothStencil", "ContactWindow", "make_cloth_grid",
           "cloth_energy", "implicit_step", "self_contact_candidates",
           "self_contact_energy", "assemble_operator", "apply_operator",
           "build_incidence", "build_grid_stencil",
           "window_contact_energy", "classify_window_residue"]


@dataclasses.dataclass(frozen=True)
class ClothStencil:
    """Slice-form topology for unions of regular grids.

    On a regular ``nx x ny`` grid every edge and hinge family lies at a
    static (i, j) offset, so stretch and bending, the assembled operator,
    its application and its diagonal are slice arithmetic with no indexed
    rows.  Families per grid, with ``vid(i, j) = start + i * ny + j``:
    stretch horizontal ``(i,j)-(i+1,j)``, vertical ``(i,j)-(i,j+1)`` and
    diagonal ``(i,j)-(i+1,j+1)``; bending over the interior horizontal,
    vertical and diagonal edges (hinge rows ``(v2, v0, v1, v3)``).
    ``rest_len`` / ``rest_angle`` hold each family's rest quantities as its
    ``[sx, sy]`` patch; :func:`build_grid_stencil` checks that the
    families cover the topology exactly.  ``tri_starts`` is the triangle-id
    base per grid when ``sim.tris`` follows :func:`make_cloth_grid`'s cell
    order (the window contact needs it), else None.
    """

    rest_len: Tuple[torch.Tensor, ...]     # 3 per grid (h, v, d), [sx, sy]
    rest_angle: Tuple[torch.Tensor, ...]   # 3 per grid (bh, bv, bd)
    grids: Tuple[Tuple[int, int, int], ...] = ()   # (start, nx, ny)
    tri_starts: Optional[Tuple[int, ...]] = None


def _stretch_slices(nx, ny):
    """(s0, s1) index tuples per stretch family (h, v, d) on a [nx, ny, ...]
    grid view."""
    a = slice(None)
    return (((slice(0, nx - 1), a), (slice(1, nx), a)),
            ((a, slice(0, ny - 1)), (a, slice(1, ny))),
            ((slice(0, nx - 1), slice(0, ny - 1)),
             (slice(1, nx), slice(1, ny))))


def _bend_slices(nx, ny):
    """(s_v2, s_v0, s_v1, s_v3) per bend family (bh, bv, bd), in
    make_cloth_grid's hinge vertex order."""
    return (
        # over horizontal interior edges (i,j)-(i+1,j):
        # (opp0=(i,j-1), a=(i,j), b=(i+1,j), opp1=(i+1,j+1))
        ((slice(0, nx - 1), slice(0, ny - 2)),
         (slice(0, nx - 1), slice(1, ny - 1)),
         (slice(1, nx), slice(1, ny - 1)),
         (slice(1, nx), slice(2, ny))),
        # over vertical interior edges (i,j)-(i,j+1):
        # (opp0=(i-1,j), a=(i,j), b=(i,j+1), opp1=(i+1,j+1))
        ((slice(0, nx - 2), slice(0, ny - 1)),
         (slice(1, nx - 1), slice(0, ny - 1)),
         (slice(1, nx - 1), slice(1, ny)),
         (slice(2, nx), slice(1, ny))),
        # over diagonal edges (i,j)-(i+1,j+1):
        # (opp0=(i+1,j), a=(i,j), b=(i+1,j+1), opp1=(i,j+1))
        ((slice(1, nx), slice(0, ny - 1)),
         (slice(0, nx - 1), slice(0, ny - 1)),
         (slice(1, nx), slice(1, ny)),
         (slice(0, nx - 1), slice(1, ny))))


def _lookup(keys, queries, what):
    """Row of ``keys`` holding each query (the last one where keys repeat,
    as a dict built in row order keeps it); raises when one is absent."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    pos = np.searchsorted(sk, queries, side="right") - 1
    ok = (pos >= 0) & (sk[np.maximum(pos, 0)] == queries)
    if not ok.all():
        raise ValueError(f"a grid {what} is not in the mesh")
    return order[pos]


def _vid(start, nx, ny):
    return start + (np.arange(nx)[:, None] * ny
                    + np.arange(ny)[None, :]).astype(np.int64)


def build_grid_stencil(sim: "ClothSim", grids) -> "ClothSim":
    """Attach a :class:`ClothStencil` for a union of regular grids.

    ``grids``: ``(start, nx, ny)`` vertex-id ranges that partition ``[0,
    N)`` contiguously in increasing start order.  Host-side: maps every
    family position to its edge/hinge index in ``sim`` and checks exact
    coverage; raises if the mesh is not the union of make_cloth_grid
    topologies."""
    grids = tuple((int(s), int(a), int(b)) for s, a, b in grids)
    N = int(sim.mass.shape[0])
    off = 0
    for s, gx, gy in grids:
        if s != off:
            raise ValueError("grids must partition [0, N) contiguously"
                             " in increasing-start order")
        off += gx * gy
    if off != N:
        raise ValueError("grids must partition [0, N)")
    edges = sim.edges.cpu().numpy().astype(np.int64)
    hinges = sim.hinges.cpu().numpy().astype(np.int64)
    e_key = edges[:, 0] * N + edges[:, 1]
    h_key = hinges[:, 1] * N + hinges[:, 2]
    rl = sim.rest_len.detach().cpu().numpy()
    ra = sim.rest_angle.detach().cpu().numpy()
    dev = sim.mass.device
    rest_len, rest_angle = [], []
    e_used = np.zeros(len(edges), bool)
    h_used = np.zeros(len(hinges), bool)
    for start, nx, ny in grids:
        vid = _vid(start, nx, ny)
        for s0, s1 in _stretch_slices(nx, ny):
            ks = _lookup(e_key, vid[s0] * N + vid[s1], "edge")
            if e_used[ks.ravel()].any():
                raise ValueError("edge claimed twice")
            e_used[ks.ravel()] = True
            rest_len.append(torch.as_tensor(rl[ks], device=dev))
        for s2, s0, s1, s3 in _bend_slices(nx, ny):
            rows = np.stack([vid[s2], vid[s0], vid[s1], vid[s3]], -1)
            ks = _lookup(h_key, rows[..., 1] * N + rows[..., 2], "hinge")
            if not np.array_equal(hinges[ks.reshape(-1)],
                                  rows.reshape(-1, 4)):
                raise ValueError("hinge vertex order mismatch")
            if h_used[ks.ravel()].any():
                raise ValueError("hinge claimed twice")
            h_used[ks.ravel()] = True
            rest_angle.append(torch.as_tensor(ra[ks], device=dev))
    if not (e_used.all() and h_used.all()):
        raise ValueError("mesh has edges/hinges outside the grid union")
    # triangle-id <-> (cell, parity) bijection (window contact)
    tris = sim.tris.cpu().numpy()
    tri_starts, t0, ok = [], 0, True
    for start, nx, ny in grids:
        vid = _vid(start, nx, ny)
        exp = _grid_tris(vid)
        nt = exp.shape[0]
        if t0 + nt > len(tris) or not np.array_equal(tris[t0:t0 + nt], exp):
            ok = False
            break
        tri_starts.append(t0)
        t0 += nt
    tri_starts = tuple(tri_starts) if ok and t0 == len(tris) else None
    sten = ClothStencil(rest_len=tuple(rest_len),
                        rest_angle=tuple(rest_angle), grids=grids,
                        tri_starts=tri_starts)
    return dataclasses.replace(sim, stencil=sten)


def _grid_tris(vid):
    """make_cloth_grid's triangles of a vertex-id grid, cell by cell (i
    major): (a, b, d) then (a, d, c)."""
    a = vid[:-1, :-1].reshape(-1)
    b = vid[1:, :-1].reshape(-1)
    d = vid[1:, 1:].reshape(-1)
    c = vid[:-1, 1:].reshape(-1)
    return np.stack([np.stack([a, b, d], -1),
                     np.stack([a, d, c], -1)], 1).reshape(-1, 3)


@dataclasses.dataclass(frozen=True)
class ClothSim:
    """Static topology and material of a triangle-mesh cloth."""

    tris: torch.Tensor        # [M, 3] int32
    edges: torch.Tensor       # [E, 2] int32
    hinges: torch.Tensor      # [H, 4] int32 rows (v2, v0, v1, v3)
    rest_len: torch.Tensor    # [E]
    rest_angle: torch.Tensor  # [H]
    mass: torch.Tensor        # [N]
    free: torch.Tensor        # [N] bool, False = pinned (Dirichlet)
    k_stretch: torch.Tensor
    k_bend: torch.Tensor
    gravity: torch.Tensor     # [3]
    ground_n: torch.Tensor    # [3] unit normal
    ground_off: torch.Tensor  # plane: n.x = off
    dhat: torch.Tensor        # barrier activation distance
    kappa: torch.Tensor       # barrier stiffness
    mu: torch.Tensor          # ground friction coefficient (0 = off)
    epsv: torch.Tensor        # friction velocity mollifier (m/s)
    # static transpose tables (build_incidence): every scatter of the
    # edge-list operator becomes a bounded gather.  None -> scatter path
    edge_inc: Optional[torch.Tensor] = None   # [N, De] side*E+e, -1 pad
    hinge_inc: Optional[torch.Tensor] = None  # [N, Dh] h*4+slot, -1 pad
    # slice-form topology for unions of regular grids (build_grid_stencil)
    stencil: Optional[ClothStencil] = None


def make_cloth_grid(nx: int, ny: int, spacing: float, *,
                    height: float = 0.5, k_stretch: float = 1e3,
                    k_bend: float = 1e-3, mass: float = 1.0,
                    pinned=(), ground_n=(0.0, 1.0, 0.0),
                    ground_off: float = 0.0, dhat: float = 0.01,
                    kappa: float = 1e2, mu: float = 0.0,
                    epsv: float = 1e-3, gravity=(0.0, -9.8, 0.0),
                    device: Optional[torch.device] = None
                    ) -> Tuple[ClothSim, torch.Tensor]:
    """Regular nx x ny cloth in the XZ plane at ``height`` on ``device``
    (None: the card).  Host-side topology: edges from the triangles, hinges
    the interior edges with their two opposite vertices (the first
    triangle's first), edges and hinges in sorted (min, max) edge order."""
    dev = cuda_device() if device is None else device
    xs, zs = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    pos = np.stack([xs * spacing, np.full(xs.shape, height),
                    zs * spacing], axis=-1).reshape(-1, 3)
    N = nx * ny
    tris = _grid_tris(np.arange(N).reshape(nx, ny)).astype(np.int32)
    # every (triangle, corner) edge with its opposite vertex, in the order
    # a loop over triangles and corners meets them
    ka = tris.astype(np.int64)
    kb = np.roll(ka, -1, axis=1)
    lo = np.minimum(ka, kb).reshape(-1)
    hi = np.maximum(ka, kb).reshape(-1)
    opp = np.roll(ka, -2, axis=1).reshape(-1)
    order = np.argsort(lo * N + hi, kind="stable")
    lo, hi, opp = lo[order], hi[order], opp[order]
    first = np.r_[True, (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])]
    starts = np.nonzero(first)[0]
    count = np.diff(np.r_[starts, len(lo)])
    edges = np.stack([lo[starts], hi[starts]], -1).astype(np.int32)
    s2 = starts[count == 2]
    hinges = np.stack([opp[s2], lo[s2], hi[s2], opp[s2 + 1]],
                      -1).astype(np.int32).reshape(-1, 4)
    x0 = torch.tensor(pos, dtype=torch.float32, device=dev)
    e_t = torch.as_tensor(edges, device=dev).long()
    h_t = torch.as_tensor(hinges, device=dev).long()
    rest_len = torch.linalg.vector_norm(x0[e_t[:, 0]] - x0[e_t[:, 1]],
                                        dim=-1)
    rest_angle = dihedral_angle(x0[h_t[:, 0]], x0[h_t[:, 1]],
                                x0[h_t[:, 2]], x0[h_t[:, 3]])
    free = np.ones(N, bool)
    free[list(pinned)] = False

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)
    sim = ClothSim(
        tris=torch.as_tensor(tris, device=dev),
        edges=torch.as_tensor(edges, device=dev),
        hinges=torch.as_tensor(hinges, device=dev), rest_len=rest_len,
        rest_angle=rest_angle,
        mass=torch.full((N,), mass, dtype=torch.float32, device=dev),
        free=torch.as_tensor(free, device=dev), k_stretch=f32(k_stretch),
        k_bend=f32(k_bend), gravity=f32(gravity), ground_n=f32(ground_n),
        ground_off=f32(ground_off), dhat=f32(dhat), kappa=f32(kappa),
        mu=f32(mu), epsv=f32(epsv))
    return build_grid_stencil(build_incidence(sim), ((0, nx, ny),)), x0


def _incidence_table(v, vals, N):
    """[N, D] table of ``vals`` grouped by vertex ``v`` in their order,
    -1 padded (D >= 1)."""
    order = np.argsort(v, kind="stable")
    vs, val = v[order], vals[order]
    cnt = np.bincount(vs, minlength=N)
    start = np.r_[0, np.cumsum(cnt)[:-1]]
    rank = np.arange(len(vs)) - start[vs]
    out = np.full((N, max(1, int(cnt.max(initial=1)))), -1, np.int32)
    out[vs, rank] = val
    return out


def build_incidence(sim: ClothSim) -> ClothSim:
    """Host-side static transpose tables: per vertex, the incident (edge,
    side) and (hinge, slot) contributions padded to the largest degree, so
    the edge-list operator's application is bounded row gathers and masked
    sums.  Call once per topology (make_cloth_grid does)."""
    N = int(sim.mass.shape[0])
    edges = sim.edges.cpu().numpy().astype(np.int64)
    hinges = sim.hinges.cpu().numpy().astype(np.int64)
    E = len(edges)
    et = _incidence_table(
        edges.reshape(-1),
        np.stack([np.arange(E), E + np.arange(E)], -1).reshape(-1), N)
    ht = _incidence_table(hinges.reshape(-1), np.arange(hinges.size), N)
    dev = sim.mass.device
    return dataclasses.replace(sim, edge_inc=torch.as_tensor(et, device=dev),
                               hinge_inc=torch.as_tensor(ht, device=dev))


def _grid_views(sten: ClothStencil, x: torch.Tensor):
    """Per-grid [nx, ny, 3] views of a [N, 3] field."""
    n = sum(nx * ny for _, nx, ny in sten.grids)
    if n != x.shape[0]:
        raise ValueError(
            f"stale ClothStencil: grids cover {n} vertices but the field "
            f"has {x.shape[0]} — after dataclasses.replace on topology, "
            f"rebuild with build_grid_stencil or set stencil=None")
    return [x[s:s + nx * ny].reshape(nx, ny, 3) for s, nx, ny in sten.grids]


def _stencil_elastic_energy(sim: ClothSim, x: torch.Tensor) -> torch.Tensor:
    """Stretch + bend energy in slice form; equals the edge/hinge-list
    energy up to fp32 summation order."""
    sten = sim.stencil
    e = x.new_zeros(())
    views = _grid_views(sten, x)
    for g, (_, nx, ny) in enumerate(sten.grids):
        X = views[g]
        for f, (s0, s1) in enumerate(_stretch_slices(nx, ny)):
            d = X[s0] - X[s1]
            lens = torch.sqrt(torch.sum(d * d, -1) + 1e-20)
            e = e + 0.5 * sim.k_stretch * torch.sum(
                (lens - sten.rest_len[3 * g + f]) ** 2)
        for f, (s2, s0, s1, s3) in enumerate(_bend_slices(nx, ny)):
            e = e + torch.sum(hinge_bending_energy(
                X[s2], X[s0], X[s1], X[s3],
                sten.rest_angle[3 * g + f], sim.k_bend))
    return e


def _ground_gap(sim: ClothSim, x: torch.Tensor) -> torch.Tensor:
    return x @ sim.ground_n - sim.ground_off


def cloth_energy(sim: ClothSim, x: torch.Tensor) -> torch.Tensor:
    """Elastic + ground-barrier energy (gravity enters through the inertia
    target)."""
    if sim.stencil is not None:
        e_elastic = _stencil_elastic_energy(sim, x)
    else:
        e0, e1 = sim.edges[:, 0].long(), sim.edges[:, 1].long()
        d = x[e0] - x[e1]
        lens = torch.sqrt(torch.sum(d * d, -1) + 1e-20)
        e_stretch = 0.5 * sim.k_stretch * torch.sum(
            (lens - sim.rest_len) ** 2)
        h = sim.hinges.long()
        e_bend = torch.sum(hinge_bending_energy(
            x[h[:, 0]], x[h[:, 1]], x[h[:, 2]], x[h[:, 3]],
            sim.rest_angle, sim.k_bend))
        e_elastic = e_stretch + e_bend
    gap = _ground_gap(sim, x)
    return e_elastic + torch.sum(barrier(gap * gap, sim.dhat * sim.dhat,
                                         sim.kappa))


def _compact(keep, cand_all, max_cand):
    """The kept entries of each row into ``max_cand`` slots in row order,
    -1 padded, and whether a row kept more."""
    rank = torch.cumsum(keep.to(torch.int32), 1, dtype=torch.int32) - 1
    slot = torch.where(keep & (rank < max_cand), rank, max_cand).long()
    cand = torch.full((keep.shape[0], max_cand + 1), -1, dtype=torch.int32,
                      device=keep.device)
    cand.scatter_(1, slot, cand_all)
    n_keep = keep.sum(1)
    return cand[:, :max_cand], (n_keep > max_cand).any()


def self_contact_candidates(sim: ClothSim, x: torch.Tensor,
                            max_cand: int = 8, tile: int = 512):
    """Lagged vertex-triangle candidate set for self-contact.

    Up to 512 triangles, a brute-force ``[N, M]`` AABB table.  Above, an
    LBVH over the current triangle boxes (complete-tree build) and one
    dhat-padded query per vertex through the decomposed banded join
    (``cells=8``, ``tile=512``, the vertices' shared extent); its entries
    (8 per vertex, in sorted order) are put back per vertex by an
    occurrence rank: a stable sort by query id puts entry ``j`` of the
    sorted order at occurrence ``j % 8`` of its vertex.  Triangles incident
    to the vertex are dropped.  Returns ``(cand [N, max_cand] int32,
    overflow)``: overflow when a vertex had more than ``max_cand``
    candidates, a cell more hits than its slots, or a query fell out of
    band."""
    from ..containers.bvh import build_lbvh_complete, query_overlaps_sorted
    N = x.shape[0]
    M = int(sim.tris.shape[0])
    dev = x.device
    tv = x[sim.tris.long()]                                 # [M, 3, 3]
    vid = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    if M <= 512:
        tlo, thi = tv.amin(1), tv.amax(1)
        ov = ((tlo[None] <= (x + sim.dhat)[:, None]).all(-1)
              & (thi[None] >= (x - sim.dhat)[:, None]).all(-1))
        incident = torch.zeros((N, M), dtype=torch.bool, device=dev)
        for k in range(3):
            incident = incident | (sim.tris[:, k][None, :] == vid)
        keep = ov & ~incident
        cand_all = torch.where(keep, torch.arange(
            M, dtype=torch.int32, device=dev)[None], -1)
        return _compact(keep, cand_all, max_cand)
    bvh = build_lbvh_complete(tv.amin(1), tv.amax(1))
    nq = -(-N // tile) * tile
    pts = torch.cat([x, x.new_full((nq - N, 3), 1e9)])
    R, C = 8, max_cand + 3      # per-cell slot budget
    qid, hits, cnt, band = query_overlaps_sorted(
        bvh, pts, pts, C, tile=tile, uniform_extent=sim.dhat,
        decompose=True, cells=R)
    E = nq * R
    pos = torch.arange(E, dtype=torch.int32, device=dev)
    perm = torch.sort(qid, stable=True).indices
    occ = torch.empty(E, dtype=torch.int64, device=dev)
    occ[perm] = (pos % R).long()
    hits_v = torch.full((nq, R, C), -1, dtype=torch.int32, device=dev)
    hits_v[qid.long(), occ] = hits
    hits_v = hits_v[:N].reshape(N, R * C)
    band_ok = torch.where(qid < N, band & (cnt <= C), True).all()
    # per-corner column gathers of the incident test
    hs = hits_v.clamp_min(0).long()
    incident = torch.zeros(hits_v.shape, dtype=torch.bool, device=dev)
    for k in range(3):
        incident = incident | (sim.tris[:, k][hs] == vid)
    incident = incident & (hits_v >= 0)
    cand_all = torch.where(incident, -1, hits_v)
    cand, over = _compact(cand_all >= 0, cand_all, max_cand)
    return cand, over | ~band_ok


def self_contact_energy(sim: ClothSim, x: torch.Tensor,
                        cand: torch.Tensor) -> torch.Tensor:
    """IPC barrier over the lagged vertex-triangle candidate set."""
    valid = cand >= 0
    tv = x[sim.tris[cand.clamp_min(0).long()].long()]      # [N, C, 3, 3]
    _, cl = point_triangle_closest(x[:, None, :], tv[:, :, 0],
                                   tv[:, :, 1], tv[:, :, 2])
    diff = x[:, None, :] - cl
    d2 = torch.sum(diff * diff, -1)
    e = barrier(d2, sim.dhat * sim.dhat, sim.kappa)
    return torch.sum(torch.where(valid, e, 0.0))


@dataclasses.dataclass(frozen=True)
class ContactWindow:
    """Static config of window-stencil self-contact.

    For layered regular-grid cloth a vertex's contact partners in another
    layer sit at static grid offsets from its own (i, j): triangles of
    cells ``(i+di, j+dj, parity)`` for ``|di|, |dj| <= radius``.  The
    window term evaluates every in-window pair at those static offsets,
    its corners one gather from the padded partner grid (out-of-range
    cells masked; barriers beyond dhat are exactly zero),
    and the LBVH broad phase, still run, certifies completeness: any
    candidate the window does not cover is compacted into an indexed
    residue of ``max_residue`` pairs under the overflow contract.  Needs
    ``sim.stencil`` with ``tri_starts``."""

    radius: int = 1          # offsets in [-r, r] cells
    max_residue: int = 64    # indexed residue budget


_FAR = 1.0e6               # padding sentinel: farther than any dhat

# own-grid offsets whose triangle contains vertex (i, j), per parity
_INCIDENT = ({(0, 0), (-1, 0), (-1, -1)},      # parity 0
             {(0, 0), (-1, -1), (0, -1)})      # parity 1
_CORNER_UV = (((0, 0), (1, 0), (1, 1)),        # parity 0: (a, b, d)
              ((0, 0), (1, 1), (0, 1)))        # parity 1: (a, d, c)
# masked-pair dummy triangle, offset from the query vertex
_SAFE_TRI = ((1.0, 0.0, 0.0), (1.0, 0.1, 0.0), (1.0, 0.0, 0.1))


def _window_groups(sten: ClothStencil, cw: ContactWindow):
    """In-window offsets grouped by same-shape grid pair:
    ``[(g, gp, [(di, dj, par), ...])]``; own-grid offsets whose triangle
    contains the vertex are left out, and pairs with no offset left."""
    r = cw.radius
    out = []
    for g, (_, nx, ny) in enumerate(sten.grids):
        for gp, (_, mx, my) in enumerate(sten.grids):
            if (nx, ny) != (mx, my):
                continue
            offs = [(di, dj, par)
                    for di in range(-r, r + 1) for dj in range(-r, r + 1)
                    for par in (0, 1)
                    if not (g == gp and (di, dj) in _INCIDENT[par])]
            if offs:
                out.append((g, gp, offs))
    return out


def _pad_grid(view, r, fill):
    return F.pad(view, (0, 0, r, r + 1, r, r + 1), value=fill)


def _corner_index(nx, ny, r, offs, device):
    """[O, nx, ny, 3] rows of each in-window triangle's corners (in
    sim.tris row order) in the flattened ``[(nx + 2r + 1) (ny + 2r + 1)]``
    padded grid of the partner layer."""
    u = torch.tensor([[_CORNER_UV[par][c][0] + di for c in range(3)]
                      for di, _, par in offs], device=device)
    v = torch.tensor([[_CORNER_UV[par][c][1] + dj for c in range(3)]
                      for _, dj, par in offs], device=device)
    i = torch.arange(nx, device=device)[None, :, None, None]
    j = torch.arange(ny, device=device)[None, None, :, None]
    return ((i + r + u[:, None, None, :]) * (ny + 2 * r + 1)
            + (j + r + v[:, None, None, :]))


def _stack_corners(pad_view, nx, ny, r, offs):
    """Corner stacks (A, B, C), each [O, nx, ny, 3], in sim.tris row
    order: one gather from the padded partner grid."""
    idx = _corner_index(nx, ny, r, offs, pad_view.device)
    rows = pad_view.reshape(-1, 3).index_select(0, idx.reshape(-1))
    return rows.reshape(idx.shape + (3,)).unbind(3)


def _stack_masks(nx, ny, offs, device):
    """[O, nx, ny] validity (the cell exists).  The mask, not the FAR
    padding, makes the window exact: a partly padded triangle can pass
    arbitrarily near a vertex."""
    i = torch.arange(nx, device=device)[None, :, None]
    j = torch.arange(ny, device=device)[None, None, :]
    di = torch.tensor([o[0] for o in offs], device=device)[:, None, None]
    dj = torch.tensor([o[1] for o in offs], device=device)[:, None, None]
    return ((i + di >= 0) & (i + di <= nx - 2)
            & (j + dj >= 0) & (j + dj <= ny - 2))


def _sanitize_tri(mask3, xv, A, B, C):
    """Masked triangles replaced by a well-conditioned dummy at about unit
    distance from the query vertex: the output mask zeroes their
    contribution, and this input-side mask keeps a NaN gradient of a
    degenerate (FAR-padded) triangle out of it."""
    s = [xv + xv.new_tensor(t) for t in _SAFE_TRI]
    return (torch.where(mask3, A, s[0]), torch.where(mask3, B, s[1]),
            torch.where(mask3, C, s[2]))


def window_contact_energy(sim: ClothSim, cw: ContactWindow,
                          x: torch.Tensor) -> torch.Tensor:
    """IPC barrier energy over every in-window vertex-triangle pair."""
    sten = sim.stencil
    views = _grid_views(sten, x)
    r = cw.radius
    pads = [_pad_grid(v, r, _FAR) for v in views]
    d2h = sim.dhat * sim.dhat
    e = x.new_zeros(())
    for g, gp, offs in _window_groups(sten, cw):
        _, nx, ny = sten.grids[g]
        xv = views[g][None]
        mask = _stack_masks(nx, ny, offs, x.device)
        A, B, C = _sanitize_tri(mask[..., None], xv,
                                *_stack_corners(pads[gp], nx, ny, r, offs))
        _, cl = point_triangle_closest(xv, A, B, C)
        diff = xv - cl
        d2 = torch.sum(diff * diff, -1)
        e = e + torch.sum(torch.where(mask, barrier(d2, d2h, sim.kappa),
                                      0.0))
    return e


def _window_gn(sim: ClothSim, cw: ContactWindow, y: torch.Tensor):
    """Frozen GN-PSD data per window group: (bary, diff, bpp) stacks
    [O, nx, ny, ...]."""
    sten = sim.stencil
    views = _grid_views(sten, y)
    r = cw.radius
    pads = [_pad_grid(v, r, _FAR) for v in views]
    d2h = sim.dhat * sim.dhat
    data = []
    for g, gp, offs in _window_groups(sten, cw):
        _, nx, ny = sten.grids[g]
        A, B, C = _stack_corners(pads[gp], nx, ny, r, offs)
        bary, cl = point_triangle_closest(views[g][None], A, B, C)
        diff = views[g][None] - cl
        s = torch.sum(diff * diff, -1)
        bpp = torch.where(_stack_masks(nx, ny, offs, y.device),
                          torch.clamp_min(barrier_hess(s, d2h, sim.kappa),
                                          0.0), 0.0)
        data.append((bary.detach(), diff.detach(), bpp))
    return tuple(data)


def _window_scatter(sten, cw, per_group, shapes, dev):
    """Add ``per_group[k]`` ([O, nx, ny, 3 corners, 3]) of every window
    group into its partner grid's padded accumulator, one index_add a
    group; returns each grid's [nx, ny, 3] interior."""
    r = cw.radius
    accs = [torch.zeros(((nx + 2 * r + 1) * (ny + 2 * r + 1), 3), device=dev)
            for nx, ny in shapes]
    for k, (g, gp, offs) in enumerate(_window_groups(sten, cw)):
        nx, ny = shapes[g]
        idx = _corner_index(nx, ny, r, offs, dev)
        accs[gp].index_add_(0, idx.reshape(-1), per_group[k].reshape(-1, 3))
    return [a.reshape(nx + 2 * r + 1, ny + 2 * r + 1, 3)[r:r + nx, r:r + ny]
            for a, (nx, ny) in zip(accs, shapes)]


def _window_apply(sim: ClothSim, cw: ContactWindow, data, p: torch.Tensor):
    """Window contact term of the CG apply: a gather of the partner grids'
    corners, elementwise GN algebra, an index_add into padded per-grid
    buffers."""
    sten = sim.stencil
    views = _grid_views(sten, p)
    r = cw.radius
    pads = [_pad_grid(v, r, 0.0) for v in views]
    shapes = [(nx, ny) for _, nx, ny in sten.grids]
    outs = [torch.zeros_like(v) for v in views]
    cts = []
    for k, (g, gp, offs) in enumerate(_window_groups(sten, cw)):
        nx, ny = shapes[g]
        bary, diff, bpp = data[k]
        A, B, C = _stack_corners(pads[gp], nx, ny, r, offs)
        rel = (views[g][None] - (bary[..., 0:1] * A + bary[..., 1:2] * B
                                 + bary[..., 2:3] * C))
        coef = bpp * (2.0 * torch.sum(diff * rel, -1))      # [O, nx, ny]
        outs[g] = outs[g] + torch.sum(2.0 * coef[..., None] * diff, 0)
        cts.append(-2.0 * coef[..., None, None] * bary[..., :, None]
                   * diff[..., None, :])                    # [O,nx,ny,3,3]
    acc = _window_scatter(sten, cw, cts, shapes, p.device)
    return torch.cat([(o + a).reshape(-1, 3) for o, a in zip(outs, acc)])


def _window_diag(sim: ClothSim, cw: ContactWindow, data, dev):
    """Exact diagonal contribution of the window term."""
    sten = sim.stencil
    shapes = [(nx, ny) for _, nx, ny in sten.grids]
    outs = [torch.zeros((nx, ny, 3), device=dev) for nx, ny in shapes]
    dts = []
    for k, (g, gp, offs) in enumerate(_window_groups(sten, cw)):
        bary, diff, bpp = data[k]
        dv = 4.0 * bpp[..., None] * diff * diff             # [O, nx, ny, 3]
        outs[g] = outs[g] + torch.sum(dv, 0)
        dts.append((bary ** 2)[..., :, None] * dv[..., None, :])
    acc = _window_scatter(sten, cw, dts, shapes, dev)
    return torch.cat([(o + a).reshape(-1, 3) for o, a in zip(outs, acc)])


def _window_ccd_alpha(sim: ClothSim, cw: ContactWindow, x, dx):
    """CCD step limit over the in-window pairs: the window groups of one
    grid shape stacked into one batched conservative-advancement call
    (each pair's time of impact is its own, so stacking changes none)."""
    sten = sim.stencil
    vx = _grid_views(sten, x)
    vd = _grid_views(sten, dx)
    r = cw.radius
    px = [_pad_grid(v, r, _FAR) for v in vx]
    pd = [_pad_grid(v, r, 0.0) for v in vd]
    by_shape = {}
    for g, gp, offs in _window_groups(sten, cw):
        _, nx, ny = sten.grids[g]
        n_off = len(offs)
        by_shape.setdefault((nx, ny), []).append((
            vx[g][None].expand(n_off, -1, -1, -1),
            *_stack_corners(px[gp], nx, ny, r, offs),
            vd[g][None].expand(n_off, -1, -1, -1),
            *_stack_corners(pd[gp], nx, ny, r, offs),
            _stack_masks(nx, ny, offs, x.device)))
    alpha = x.new_ones(())
    for parts in by_shape.values():
        p, A, B, C, dp, dA, dB, dC, mask = (torch.cat(col) for col in
                                            zip(*parts))
        toi = point_triangle_ccd(p, A, B, C, dp, dA, dB, dC, min_sep=1e-5)
        alpha = torch.minimum(alpha, 0.9 * torch.where(mask, toi, 1.0).min())
    return alpha


def classify_window_residue(sim: ClothSim, cw: ContactWindow,
                            cand: torch.Tensor):
    """Split the LBVH candidate set into window-covered pairs and an
    indexed residue of ``max_residue`` pairs.  Returns ``(vid [K],
    tidx [K, 3], valid [K], overflow)``; overflow when the live residue
    exceeds the budget."""
    sten = sim.stencil
    if sten is None or sten.tri_starts is None:
        raise ValueError("window contact needs a grid stencil with "
                         "make_cloth_grid triangle ordering")
    N, C = cand.shape
    G = len(sten.grids)
    r = cw.radius
    dev = cand.device

    def per_grid(fn):
        return torch.cat([fn(g, nx, ny)
                          for g, (_, nx, ny) in enumerate(sten.grids)])
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=dev)
    gv = per_grid(lambda g, nx, ny: torch.full((nx * ny,), g,
                                               dtype=torch.int32,
                                               device=dev))
    iv = per_grid(lambda g, nx, ny: ar(nx * ny) // ny)
    jv = per_grid(lambda g, nx, ny: ar(nx * ny) % ny)
    # candidate triangle -> (g', ci, cj)
    t = cand.clamp_min(0)
    gt = torch.zeros_like(cand)
    for k, ts in enumerate(sten.tri_starts[1:], 1):
        gt = torch.where(t >= ts, k, gt)
    ci = torch.zeros_like(cand)
    cj = torch.zeros_like(cand)
    for k, (_, nx, ny) in enumerate(sten.grids):
        lk = torch.div(t - sten.tri_starts[k], 2, rounding_mode="floor")
        ci = torch.where(gt == k, torch.div(lk, ny - 1,
                                            rounding_mode="floor"), ci)
        cj = torch.where(gt == k, lk % (ny - 1), cj)
    shp = [s[1:] for s in sten.grids]
    pair_ok = torch.tensor([[shp[g] == shp[gp] for gp in range(G)]
                            for g in range(G)], device=dev)
    di = ci - iv[:, None]
    dj = cj - jv[:, None]
    par = t % 2
    own = gv[:, None] == gt
    incident = torch.zeros(cand.shape, dtype=torch.bool, device=dev)
    for p_, combos in enumerate(_INCIDENT):
        for ui, uj in combos:
            incident = incident | ((par == p_) & (di == ui) & (dj == uj))
    covered = (pair_ok[gv[:, None].long(), gt.long()]
               & (di.abs() <= r) & (dj.abs() <= r) & ~(own & incident))
    live = ((cand >= 0) & ~covered).reshape(-1)
    K = cw.max_residue
    perm = torch.argsort(torch.where(live, 0, 1).to(torch.int32),
                         stable=True)[:K]
    vid = torch.div(perm, C, rounding_mode="floor").to(torch.int32)
    tri = cand.reshape(-1)[perm]
    valid = live[perm]
    overflow = live.sum() > K
    tidx = sim.tris[tri.clamp_min(0).long()]
    return vid, tidx, valid, overflow


def _pair_contact_energy(sim: ClothSim, x, vid, tidx, valid):
    """Barrier energy over an explicit (vertex, triangle) pair list (the
    window residue)."""
    tv = x[tidx.long()]                                     # [K, 3, 3]
    xv = x[vid.long()]
    a, b, c = _sanitize_tri(valid[:, None], xv, tv[:, 0], tv[:, 1], tv[:, 2])
    _, cl = point_triangle_closest(xv, a, b, c)
    diff = xv - cl
    d2 = torch.sum(diff * diff, -1)
    e = barrier(d2, sim.dhat * sim.dhat, sim.kappa)
    return torch.sum(torch.where(valid, e, 0.0))


def _pair_gn(sim: ClothSim, y, vid, tidx, valid):
    """GN-PSD data of a pair list in the ``contact_c`` layout that
    apply_operator consumes: (vid, tidx, bary, diff, bpp)."""
    tv = y[tidx.long()]
    yv = y[vid.long()]
    bary, cl = point_triangle_closest(yv, tv[:, 0], tv[:, 1], tv[:, 2])
    diff = yv - cl
    s = torch.sum(diff * diff, -1)
    bpp = torch.where(valid, torch.clamp_min(
        barrier_hess(s, sim.dhat * sim.dhat, sim.kappa), 0.0), 0.0)
    return vid, tidx, bary.detach(), diff.detach(), bpp


def _pair_ccd_alpha(sim: ClothSim, x, dx, vid, tidx, valid):
    v3 = valid[:, None]
    vid, tidx = vid.long(), tidx.long()
    a, b, c = _sanitize_tri(v3, x[vid], *(x[tidx[:, k]] for k in range(3)))
    da, db, dc = (torch.where(v3, dx[tidx[:, k]], 0.0) for k in range(3))
    toi = point_triangle_ccd(x[vid], a, b, c, dx[vid], da, db, dc,
                             min_sep=1e-5)
    toi = torch.where(valid, toi, 1.0)
    return torch.clamp_max(0.9 * toi.min(), 1.0)


def _self_contact_alpha(sim: ClothSim, x, dx, cand):
    """CCD step limit over the candidate set (conservative advancement)."""
    valid = cand >= 0
    tidx = sim.tris[cand.clamp_min(0).long()].long()       # [N, C, 3]
    a, b, c = (x[tidx[..., k]] for k in range(3))
    da, db, dc = (dx[tidx[..., k]] for k in range(3))
    toi = point_triangle_ccd(x[:, None, :], a, b, c,
                             dx[:, None, :], da, db, dc, min_sep=1e-5)
    toi = torch.where(valid, toi, 1.0)
    return torch.clamp_max(0.9 * toi.min(), 1.0)


def assemble_operator(sim: ClothSim, y: torch.Tensor, x: torch.Tensor, dt,
                      *, cand=None, lam=None, contact_budget=None,
                      window=None, window_res=None):
    """Cache per-element Gauss-Newton(-PSD) Hessian data at ``y``, once per
    Newton round.

    * stretch (exact, PSD-clamped): per edge the unit edge and two
      scalars, ``k [d d^T + max(0, 1 - L/l) (I - d d^T)]``;
    * bending (GN): ``E''(theta) grad-theta grad-theta^T`` with the
      12-vector ``grad theta`` from one batched autograd;
    * ground barrier (clamped): ``(2 b' + 4 d^2 b'') n n^T``;
    * lagged friction: ``mu lam f1(|u|)/|u|`` on the tangent plane;
    * self-contact (GN-PSD, frozen barycentric weights): ``b''(s) grad-s
      grad-s^T`` with ``grad s = 2 (c kron diff)``.

    Returns a dict that :func:`apply_operator` consumes; its ``diag [N,
    3]`` is the exact diagonal, the Jacobi preconditioner.
    ``contact_budget`` K compacts the live (``bpp > 0``) dense contact rows
    once here (stable sort over liveness), so the apply touches 4 K rows
    in place of 4 N C; ``act_ovf`` is True when live rows exceeded K.
    ``window`` with ``window_res`` puts the in-window pairs in the window's
    static-offset form and the residue in the compacted layout."""
    dt = torch.as_tensor(dt, dtype=y.dtype, device=y.device)
    n_hat = sim.ground_n
    coef_h = 2.0 * sim.k_bend                    # E = k (theta - rest)^2
    if sim.stencil is not None:
        # slice-form element data per family and the diagonal on per-grid
        # [nx, ny, 3] blocks
        sten = sim.stencil
        views = _grid_views(sten, y)
        s_fam, b_fam, dblk = [], [], []
        for g, (_, nx, ny) in enumerate(sten.grids):
            Y = views[g]
            Dg = y.new_zeros((nx, ny, 3))
            for f, (s0, s1) in enumerate(_stretch_slices(nx, ny)):
                d = Y[s0] - Y[s1]
                l = torch.sqrt(torch.sum(d * d, -1) + 1e-20)
                ed_f = d / l[..., None]
                cb = sim.k_stretch * torch.clamp_min(
                    1.0 - sten.rest_len[3 * g + f] / l, 0.0)
                s_fam.append((ed_f, cb))
                ds = (cb[..., None]
                      + (sim.k_stretch - cb)[..., None] * ed_f * ed_f)
                Dg[s0] += ds
                Dg[s1] += ds
            for sl in _bend_slices(nx, ny):
                gth_f = dihedral_angle_gradient(
                    Y[sl[0]], Y[sl[1]], Y[sl[2]], Y[sl[3]]
                ).reshape(Y[sl[0]].shape[:2] + (4, 3))
                b_fam.append(gth_f)
                dv = coef_h * gth_f * gth_f
                for k in range(4):
                    Dg[sl[k]] += dv[:, :, k, :]
            dblk.append(Dg.reshape(-1, 3))
        sten_op = (tuple(s_fam), tuple(b_fam))
        diag_elastic = torch.cat(dblk)
        ed = coef_a = coef_b = gth = None
    else:
        sten_op = None
        e0, e1 = sim.edges[:, 0].long(), sim.edges[:, 1].long()
        d = y[e0] - y[e1]
        l = torch.sqrt(torch.sum(d * d, -1) + 1e-20)
        ed = d / l[:, None]
        coef_a = sim.k_stretch.expand(l.shape)
        coef_b = sim.k_stretch * torch.clamp_min(1.0 - sim.rest_len / l, 0.0)
        h = sim.hinges.long()
        gth = dihedral_angle_gradient(
            y[h[:, 0]], y[h[:, 1]], y[h[:, 2]], y[h[:, 3]]).reshape(-1, 4, 3)

    gap = _ground_gap(sim, y)
    g2 = gap * gap
    d2h = sim.dhat * sim.dhat
    curv = torch.clamp_min(
        2.0 * barrier_grad(g2, d2h, sim.kappa)
        + 4.0 * g2 * barrier_hess(g2, d2h, sim.kappa), 0.0)

    if lam is not None:
        u = (y - x) - ((y - x) @ n_hat)[:, None] * n_hat[None, :]
        un = torch.sqrt(torch.sum(u * u, -1) + 1e-18)
        fr_c = sim.mu * lam * friction_f1_over_x(un, sim.epsv * dt)
    else:
        fr_c = y.new_zeros(y.shape[:1])

    contact = None
    if cand is not None:
        tidx = sim.tris[cand.clamp_min(0).long()]           # [N, C, 3]
        tv = y[tidx.long()]                                  # [N, C, 3, 3]
        bary, cl = point_triangle_closest(y[:, None, :], tv[:, :, 0],
                                          tv[:, :, 1], tv[:, :, 2])
        diff = y[:, None, :] - cl                            # [N, C, 3]
        s = torch.sum(diff * diff, -1)
        bpp = torch.clamp_min(barrier_hess(s, d2h, sim.kappa), 0.0)
        bpp = torch.where(cand >= 0, bpp, 0.0)
        contact = (tidx, bary.detach(), diff.detach(), bpp)

    # window-stencil contact: in-window pairs at static offsets, the
    # residue in the contact_c layout; exclusive with the cand-based path
    win = (window, _window_gn(sim, window, y)) if window is not None else None

    contact_c = act_ovf = None
    if window_res is not None:
        contact_c = _pair_gn(sim, y, *window_res)
    if contact is not None and contact_budget is not None:
        # active-set compaction: non-live rows carry bpp == 0 exactly, so
        # the ones inside the budget are harmless padding
        tidx, bary, diff, bpp = contact
        C = cand.shape[1]
        R = y.shape[0] * C
        live = (bpp > 0.0).reshape(R)
        perm = torch.argsort(torch.where(live, 0, 1).to(torch.int32),
                             stable=True)[:contact_budget]
        cvid = torch.div(perm, C, rounding_mode="floor").to(torch.int32)
        contact_c = (cvid, tidx.reshape(R, 3)[perm],
                     bary.reshape(R, 3)[perm], diff.reshape(R, 3)[perm],
                     bpp.reshape(R)[perm])
        act_ovf = live.sum() > contact_budget

    # exact diagonal of the assembled operator -> Jacobi preconditioner
    diag = (sim.mass / (dt * dt))[:, None] * y.new_ones((1, 3))
    if sten_op is not None:
        diag = diag + diag_elastic
    else:
        ds = coef_b[:, None] + (coef_a - coef_b)[:, None] * ed * ed
        diag = diag.index_add(0, e0, ds).index_add(0, e1, ds)
        diag = diag.index_add(0, sim.hinges.reshape(-1).long(),
                              (coef_h * gth * gth).reshape(-1, 3))
    diag = diag + curv[:, None] * (n_hat * n_hat)[None, :]
    diag = diag + fr_c[:, None] * (1.0 - n_hat * n_hat)[None, :]
    if contact is not None:
        tidx, bary, diff, bpp = contact
        dv = 4.0 * bpp[..., None] * diff * diff              # [N, C, 3]
        diag = diag + torch.sum(dv, 1)
        dtk = (4.0 * bpp[..., None, None] * (bary * bary)[..., None]
               * (diff * diff)[:, :, None, :])               # [N, C, 3, 3]
        diag = diag.index_add(0, tidx.reshape(-1).long(),
                              dtk.reshape(-1, 3))
    if win is not None:
        diag = diag + _window_diag(sim, win[0], win[1], y.device)
    if window_res is not None:
        cvid_r, tidx_r, bary_r, diff_r, bpp_r = contact_c
        dv_r = 4.0 * bpp_r[:, None] * diff_r * diff_r        # [K, 3]
        diag = diag.index_add(0, cvid_r.long(), dv_r)
        dtk_r = (bary_r * bary_r)[..., None] * dv_r[:, None, :]
        diag = diag.index_add(0, tidx_r.reshape(-1).long(),
                              dtk_r.reshape(-1, 3))
    return dict(ed=ed, coef_a=coef_a, coef_b=coef_b, gth=gth,
                coef_h=coef_h, curv=curv, fr_c=fr_c, sten=sten_op, win=win,
                contact=None if contact_c is not None else contact,
                contact_c=contact_c, act_ovf=act_ovf, diag=diag)


def apply_operator(sim: ClothSim, op, p: torch.Tensor, dt) -> torch.Tensor:
    """Apply the assembled GN operator (see :func:`assemble_operator`):
    batched gathers, 3-vector arithmetic and scatter-adds, no autograd."""
    dt = torch.as_tensor(dt, dtype=p.dtype, device=p.device)
    n_hat = sim.ground_n
    q = (sim.mass / (dt * dt))[:, None] * p
    if op.get("sten") is not None:
        # slice-form stretch/bend on the per-grid [nx, ny, 3] views
        sten = sim.stencil
        s_fam, b_fam = op["sten"]
        views = _grid_views(sten, p)
        qblk, fi, bi = [], 0, 0
        for g, (_, nx, ny) in enumerate(sten.grids):
            P = views[g]
            Qg = p.new_zeros((nx, ny, 3))
            for s0, s1 in _stretch_slices(nx, ny):
                ed_f, cb = s_fam[fi]
                fi += 1
                u = P[s0] - P[s1]
                du = torch.sum(ed_f * u, -1)
                f = (cb[..., None] * u
                     + ((sim.k_stretch - cb) * du)[..., None] * ed_f)
                Qg[s0] += f
                Qg[s1] -= f
            for sl in _bend_slices(nx, ny):
                gth_f = b_fam[bi]
                bi += 1
                ph = torch.stack([P[sl[k]] for k in range(4)], 2)
                w = torch.sum(gth_f * ph, (-1, -2))
                hv = (op["coef_h"] * w)[..., None, None] * gth_f
                for k in range(4):
                    Qg[sl[k]] += hv[:, :, k, :]
            qblk.append(Qg.reshape(-1, 3))
        q = q + torch.cat(qblk)
    else:
        e0, e1 = sim.edges[:, 0].long(), sim.edges[:, 1].long()
        u = p[e0] - p[e1]
        du = torch.sum(op["ed"] * u, -1)
        f = (op["coef_b"][:, None] * u
             + ((op["coef_a"] - op["coef_b"]) * du)[:, None] * op["ed"])
        ph = p[sim.hinges.long()]                            # [H, 4, 3]
        w = torch.sum(op["gth"] * ph, (-1, -2))
        hv = ((op["coef_h"] * w)[:, None, None] * op["gth"]).reshape(-1, 3)
        if sim.edge_inc is not None and sim.hinge_inc is not None:
            # scatter-free transpose through the static incidence tables
            ft = torch.cat([f, -f])                           # [2E, 3]
            gi = sim.edge_inc
            q = q + torch.sum(torch.where(
                (gi >= 0)[..., None], ft[gi.clamp_min(0).long()], 0.0), 1)
            gj = sim.hinge_inc
            q = q + torch.sum(torch.where(
                (gj >= 0)[..., None], hv[gj.clamp_min(0).long()], 0.0), 1)
        else:
            q = q.index_add(0, e0, f).index_add(0, e1, -f)
            q = q.index_add(0, sim.hinges.reshape(-1).long(), hv)
    pn = p @ n_hat
    q = q + (op["curv"] * pn)[:, None] * n_hat[None, :]
    q = q + op["fr_c"][:, None] * (p - pn[:, None] * n_hat[None, :])
    if op.get("win") is not None:
        cw, wdata = op["win"]
        q = q + _window_apply(sim, cw, wdata, p)
    if op.get("contact_c") is not None:
        # compacted active set: 4 K indexed rows per apply
        cvid, tidx, bary, diff, bpp = op["contact_c"]
        cvid, tidx = cvid.long(), tidx.long()
        pt = p[tidx]                                         # [K, 3, 3]
        rel = p[cvid] - torch.sum(bary[..., None] * pt, 1)
        coef = bpp * (2.0 * torch.sum(diff * rel, -1))       # [K]
        q = q.index_add(0, cvid, 2.0 * coef[:, None] * diff)
        ct = (-2.0 * coef[:, None, None] * bary[:, :, None]
              * diff[:, None, :])                            # [K, 3, 3]
        q = q.index_add(0, tidx.reshape(-1), ct.reshape(-1, 3))
    elif op["contact"] is not None:
        tidx, bary, diff, bpp = op["contact"]
        tidx = tidx.long()
        pt = p[tidx]                                         # [N, C, 3, 3]
        rel = p[:, None, :] - torch.sum(bary[..., None] * pt, 2)
        coef = bpp * (2.0 * torch.sum(diff * rel, -1))       # [N, C]
        q = q + torch.sum(2.0 * coef[..., None] * diff, 1)
        ct = (-2.0 * coef[..., None, None] * bary[..., None]
              * diff[:, :, None, :])                         # [N, C, 3, 3]
        q = q.index_add(0, tidx.reshape(-1), ct.reshape(-1, 3))
    return q


def implicit_step(sim: ClothSim, x: torch.Tensor, v: torch.Tensor,
                  dt, *, newton_iters: int = 2,
                  cg_iters: int = 40, self_contact: bool = False,
                  max_cand: int = 8, precondition: bool = True,
                  operator: str = "assembled",
                  contact_budget: Optional[int] = None,
                  contact_window: Optional[ContactWindow] = None,
                  with_stats: bool = False):
    """One implicit-Euler step: ``newton_iters`` Newton-CG rounds on the
    incremental potential, each limited by the analytic ground-plane step
    limiter (and, with self-contact, the CCD limiter over the lagged
    candidate set).

    ``operator``: ``"assembled"`` (the GN-PSD operator of
    :func:`assemble_operator`, its exact diagonal the Jacobi
    preconditioner) or ``"autodiff"`` (exact Hessian-vector products by a
    double backward through the gradient, with an analytic lagged
    diagonal as preconditioner).  ``contact_budget`` compacts the dense
    contact rows (see :func:`assemble_operator`); ``contact_window`` runs
    the window-stencil contact with its residue.

    Returns ``(x, v)``, or ``(x, v, overflow)`` with self-contact; the
    overflow flag (a 0-d bool tensor) covers the candidate set, the
    residue and the active-set budget.  ``with_stats=True`` appends the
    list of CG iterations of each Newton round."""
    dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
    free3 = sim.free[:, None]
    m3 = sim.mass[:, None]
    xhat = x + dt * v + (dt * dt) * sim.gravity[None, :]
    xhat = torch.where(free3, xhat, x)

    win_mode = self_contact and contact_window is not None
    cand = wres = sc_ovf = None
    if self_contact:
        # lagged candidate set, frozen over the step
        cand, sc_ovf = self_contact_candidates(sim, x, max_cand)
        if win_mode:
            # the LBVH set certifies completeness; out-of-window pairs
            # become the indexed residue
            res_vid, res_tidx, res_valid, r_ovf = \
                classify_window_residue(sim, contact_window, cand)
            wres = (res_vid, res_tidx, res_valid)
            sc_ovf = sc_ovf | r_ovf

    # lagged IPC friction: normal force magnitude from the start-of-step
    # barrier, tangential displacement mollified by f0
    n = sim.ground_n
    gap0 = _ground_gap(sim, x)
    d2h = sim.dhat * sim.dhat
    lam = torch.clamp_min(
        -2.0 * gap0 * barrier_grad(gap0 * gap0, d2h, sim.kappa), 0.0)
    epsvh = sim.epsv * dt

    def energy(z):
        u = (z - x) - ((z - x) @ n)[:, None] * n[None, :]
        un = torch.sqrt(torch.sum(u * u, -1) + 1e-18)
        e = cloth_energy(sim, z) + torch.sum(
            sim.mu * lam * friction_f0(un, epsvh))
        if win_mode:
            e = (e + window_contact_energy(sim, contact_window, z)
                 + _pair_contact_energy(sim, z, *wres))
        elif self_contact:
            e = e + self_contact_energy(sim, z, cand)
        return e

    def phi_grad(y, create_graph=False):
        with torch.enable_grad():
            z = y.detach().requires_grad_(True)
            ge = torch.autograd.grad(energy(z), z,
                                     create_graph=create_graph)[0]
            g = torch.where(free3, (m3 / (dt * dt)) * (z - xhat) + ge, 0.0)
        return z, g

    def project(p):
        return torch.where(free3, p, 0.0)

    M_pre = None
    if precondition and operator != "assembled":
        N = x.shape[0]
        deg = x.new_zeros(N).index_add(
            0, sim.edges.reshape(-1).long(),
            x.new_ones(sim.edges.numel()))
        g2 = gap0 * gap0
        # barrier(d^2(y)) with d = n.y - off: Hessian (2 b' + 4 d^2 b'')
        # n n^T, its curvature clamped at 0 so the preconditioner is SPD
        with torch.enable_grad():
            s = g2.detach().requires_grad_(True)
            bpp = torch.autograd.grad(
                torch.sum(barrier_grad(s, d2h, sim.kappa)), s)[0]
        curv = torch.clamp_min(2.0 * barrier_grad(g2, d2h, sim.kappa)
                               + 4.0 * g2 * bpp, 0.0)
        diag = sim.mass / (dt * dt) + sim.k_stretch * deg + curv
        M_pre = lambda r: r / diag[:, None]

    y = x
    stats = []
    for _ in range(newton_iters):
        if operator == "assembled":
            _, g = phi_grad(y)
            op = assemble_operator(
                sim, y, x, dt,
                cand=cand if self_contact and not win_mode else None,
                lam=lam,
                contact_budget=(contact_budget
                                if self_contact and not win_mode
                                else None),
                window=contact_window if win_mode else None,
                window_res=wres if win_mode else None)
            if self_contact and op["act_ovf"] is not None:
                sc_ovf = sc_ovf | op["act_ovf"]
            hvp = lambda p, _op=op: project(
                apply_operator(sim, _op, project(p), dt))
            pre = ((lambda r, _d=op["diag"]: r / _d)
                   if precondition else None)
        else:
            z, g = phi_grad(y, create_graph=True)
            hvp = lambda p, _z=z, _g=g: project(torch.autograd.grad(
                _g, _z, project(p), retain_graph=True)[0])
            pre = M_pre
        res = cg(hvp, -g.detach(), project=project, precondition=pre,
                 max_iters=cg_iters, rel_tol=1e-3)
        stats.append(res.iters)
        dx = project(res.x).detach()
        # plane step limiter: keep gap(y + a dx) >= 0.1 * current gap
        gap = _ground_gap(sim, y)
        dgap = dx @ sim.ground_n
        a_vert = torch.where(dgap < 0,
                             0.9 * gap / torch.clamp_min(-dgap, 1e-30), 1.0)
        alpha = torch.clamp_max(torch.where(sim.free, a_vert,
                                            torch.inf).min(), 1.0)
        if win_mode:
            alpha = torch.minimum(alpha, _window_ccd_alpha(
                sim, contact_window, y, dx))
            alpha = torch.minimum(alpha, _pair_ccd_alpha(sim, y, dx, *wres))
        elif self_contact:
            alpha = torch.minimum(alpha,
                                  _self_contact_alpha(sim, y, dx, cand))
        y = y + alpha * dx
    v_new = torch.where(free3, (y - x) / dt, 0.0)
    out = (y, v_new, sc_ovf) if self_contact else (y, v_new)
    return out + (stats,) if with_stats else out
