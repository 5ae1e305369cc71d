"""Linear BVH (LBVH) broad phase: Karras build and AABB overlap queries.

Counterpart of ``zpc_tpu/containers/bvh.py``, checked against it on the
same inputs.  The build is the JAX package's: morton quantization in one
cubic scene box, a stable sort, the Karras topology as two
nearest-smaller-element sweeps (:func:`zpc_tpu_torch.ops.nse.nse`, the hand
CUDA kernel on the card), internal boxes from a sparse table over the
sorted leaf boxes, and escape pointers by scatter-max.  Node ids: internal
nodes ``[0, n-1)`` with the root at 0, leaves ``[n-1, 2n-1)``.

Queries: :func:`query_overlaps` is the stackless escape-pointer walk, a
lockstep loop over the still-active queries; :func:`query_overlaps_sorted`
is the sorted banded tile join, with the JAX package's tiling, window and
in-band certificate, so a query's ``in_band`` means the same in both
packages; :func:`query_overlaps_exact` answers every query exactly with a
bounded walk for the out-of-band residue.

The JAX package's TPU layout workarounds are not carried over: the f32 row
packing of the walk, the transposed join orientation and the f32 halves of
the code compare become plain int32 gathers and compares with the same
results.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..math.bits import clz32, common_prefix_length, expand_bits_3d, \
    morton3d, to_int32
from ..ops.nse import nse

__all__ = ["LBvh", "aabb_overlap", "build_lbvh", "build_lbvh_complete",
           "query_overlaps", "query_overlaps_sorted", "query_overlaps_exact",
           "CHECK_EVERY", "LAST_WALK_STEPS"]

BIG = 3.4e38                   # box fill: inverted boxes overlap nothing
INT32_MAX = 2 ** 31 - 1

CHECK_EVERY = 16
"""Walk steps between two reads of the :func:`query_overlaps` exit flag."""

LAST_WALK_STEPS = 0
"""Iterations of the most recent :func:`query_overlaps` walk (a multiple of
:data:`CHECK_EVERY`)."""


def aabb_overlap(lo_a, hi_a, lo_b, hi_b):
    return torch.all(lo_a <= hi_b, -1) & torch.all(lo_b <= hi_a, -1)


@dataclasses.dataclass(frozen=True)
class LBvh:
    """n leaves (primitives, sorted by morton), n-1 internal nodes.

    ``escape`` is the stackless skip pointer of a preorder walk; -1 ends
    it.  ``codes``/``scene_lo``/``scene_extent``/``half_max`` record the
    morton quantization so the banded join can reuse it.
    """

    lo: torch.Tensor         # [2n-1, dim] node box min
    hi: torch.Tensor         # [2n-1, dim] node box max
    left: torch.Tensor       # [2n-1] int32 left child (-1 for leaves)
    right: torch.Tensor      # [2n-1] int32 right child
    escape: torch.Tensor     # [2n-1] int32 skip pointer
    leaf_prim: torch.Tensor  # [2n-1] int32 primitive id (-1 internal/invalid)
    count: torch.Tensor      # 0-d int32 active primitive count
    codes: torch.Tensor      # [n] int32 sorted leaf morton codes
    scene_lo: torch.Tensor       # [dim]
    scene_extent: torch.Tensor   # [dim]
    half_max: torch.Tensor       # [dim] max leaf half-extent

    @property
    def num_leaves(self) -> int:
        return (self.lo.shape[0] + 1) // 2


def _i32(n, device, fill=None):
    if fill is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    return torch.full((n,), fill, dtype=torch.int32, device=device)


def _karras_topology(codes: torch.Tensor):
    """Karras-2012 radix-tree topology as the min-Cartesian tree of the
    adjacent-gap delta array ``d[i] = cpl(key[i], key[i+1])`` (index
    augmented for duplicate codes): internal node i splits at gap i and
    covers leaves ``[NSEl(i)+1, NSEr(i)]``, with NSEl the nearest j < i with
    d[j] <= d[i] and NSEr the nearest j > i with d[j] < d[i]; its parent is
    the deeper of the two.  Both sweeps run on :func:`nse` (the JAX package
    runs a 126-scan loop below g = 1024; the results are the same).

    Returns (left, right, range_lo, range_hi) for the n-1 internal nodes,
    renumbered so the root is node 0.
    """
    n = codes.shape[0]
    g = n - 1
    dev = codes.device
    gi = _i32(g, dev)
    d = common_prefix_length(codes[:-1], codes[1:])
    same = codes[:-1] == codes[1:]
    d = torch.where(same, 32 + common_prefix_length(gi, gi + 1), d)

    BIG_I = 1 << 30
    sel_l = nse(d, False)
    nsel = torch.where(sel_l < 0, -1, sel_l >> 6)
    dl = torch.where(sel_l < 0, -1, sel_l & 63)
    sel_r = nse(d.flip(0), True).flip(0)
    nser = torch.where(sel_r < 0, BIG_I, g - 1 - (sel_r >> 6))
    dr = torch.where(sel_r < 0, -1, sel_r & 63)

    rlo = nsel + 1
    rhi = torch.clamp(nser, max=g)

    # parent gap: the deeper of (nsel, nser); ties -> the right one
    is_root = (dl < 0) & (dr < 0)
    par = torch.where(dr >= dl, torch.clamp(nser, max=g - 1),
                      torch.clamp(nsel, min=0))
    int_isl = par > gi                   # i sits in its parent's left range

    # leaf j attaches under the deeper of gaps (j-1, j); ties -> gap j
    lj = _i32(n, dev)
    m1 = _i32(1, dev, -1)
    d_rgt = torch.cat([d, m1])           # gap j   (right of j)
    d_lft = torch.cat([m1, d])           # gap j-1 (left of j)
    leaf_par = torch.where(d_rgt >= d_lft, lj, lj - 1)
    leaf_isl = d_rgt >= d_lft            # parent right of leaf -> left child

    ids = torch.cat([gi, g + lj])
    pars = torch.cat([par, leaf_par])
    isl = torch.cat([int_isl, leaf_isl])
    has_par = torch.cat([~is_root, torch.ones(n, dtype=torch.bool,
                                              device=dev)])
    # every internal node has exactly two children, so the keys
    # parent * 2 + is_right are unique and sorting by them lays the
    # children out pairwise (the root sorts last)
    ckey = torch.where(has_par, pars * 2 + (~isl).to(torch.int32), 2 * g)
    child_sorted = ids[torch.argsort(ckey)]
    left = child_sorted[0:2 * g:2]
    right = child_sorted[1:2 * g:2]

    # renumber so the root lands at node 0 (swap 0 <-> root everywhere)
    r = torch.argmax(is_root.to(torch.int32)).to(torch.int32)
    swap = torch.where(gi == 0, r, torch.where(gi == r, 0, gi)).long()

    def remap_ids(x):
        # internal ids 0 and r trade places; leaves (>= g) and -1 pass
        return torch.where(x == 0, r, torch.where(x == r, 0, x))

    left = remap_ids(left[swap])
    right = remap_ids(right[swap])
    return left, right, rlo[swap], rhi[swap]


def _quantize(prim_lo, prim_hi, valid):
    """Morton codes of the valid box centres in one cubic scene box
    (invalid primitives get int32-max), with the scene box and half_max."""
    centers = 0.5 * (prim_lo + prim_hi)
    vlo = torch.where(valid[:, None], prim_lo, BIG)
    vhi = torch.where(valid[:, None], prim_hi, -BIG)
    scene_lo = vlo.amin(0)
    scene_hi = vhi.amax(0)
    # cubic cells: one shared scale keeps cells world-space cubes
    extent = torch.clamp(scene_hi - scene_lo, min=1e-12).amax().expand(
        scene_lo.shape).contiguous()
    q = torch.clamp((centers - scene_lo) / extent * 1024.0, 0, 1023).to(
        torch.int32)
    codes = torch.where(valid, morton3d(q), INT32_MAX)
    half_max = 0.5 * torch.where(valid[:, None], prim_hi - prim_lo,
                                 torch.zeros_like(prim_lo)).amax(0)
    return codes, scene_lo, extent, half_max


def _sparse_table(base, combine, pad, levels):
    n = base.shape[0]
    tabs = [base]
    for k in range(1, levels):
        h = 1 << (k - 1)
        prev = tabs[-1]
        shifted = torch.cat([prev[h:], torch.full(
            (min(h, n),) + prev.shape[1:], pad, dtype=prev.dtype,
            device=prev.device)])[:n]
        tabs.append(combine(prev, shifted))
    return torch.stack(tabs)              # [levels, n, dim]


def build_lbvh(prim_lo: torch.Tensor, prim_hi: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> LBvh:
    """Build from primitive AABBs ``[n, 3]``.  Invalid primitives sort last
    and get inverted boxes."""
    n = prim_lo.shape[0]
    dev = prim_lo.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    count = valid.to(torch.int32).sum().to(torch.int32)
    codes, scene_lo, extent, half_max = _quantize(prim_lo, prim_hi, valid)
    order = torch.argsort(codes, stable=True)      # invalid go last
    codes_s = codes[order]
    if n == 1:
        m1 = _i32(1, dev, -1)
        return LBvh(prim_lo, prim_hi, m1, m1.clone(), m1.clone(),
                    _i32(1, dev, 0), count, codes, scene_lo, extent,
                    half_max)

    left, right, rlo, rhi = _karras_topology(codes_s)
    ninternal = n - 1

    # leaf boxes in sorted order; invalid leaves inverted
    vs = valid[order][:, None]
    leaf_lo = torch.where(vs, prim_lo[order], BIG)
    leaf_hi = torch.where(vs, prim_hi[order], -BIG)

    # internal boxes: range min/max over each node's sorted-leaf range
    # [rlo, rhi] from a sparse table (two lookups per node)
    levels = int(np.ceil(np.log2(n))) + 1
    tmin = _sparse_table(leaf_lo, torch.minimum, BIG, levels)
    tmax = _sparse_table(leaf_hi, torch.maximum, -BIG, levels)
    length = rhi - rlo + 1
    kk = 31 - clz32(length)                        # floor(log2(length))
    pow2 = torch.ones_like(kk) << kk
    a = (kk * n + rlo).long()
    b = (kk * n + rhi - pow2 + 1).long()
    flat_min = tmin.reshape(levels * n, -1)
    flat_max = tmax.reshape(levels * n, -1)
    lo = torch.cat([torch.minimum(flat_min[a], flat_min[b]), leaf_lo])
    hi = torch.cat([torch.maximum(flat_max[a], flat_max[b]), leaf_hi])

    # escape pointers: the skip target of a node with sorted-leaf range
    # [a, b] is the LARGEST node whose range starts at b+1; two scatter-max
    # passes find that winner per start position
    node_rlo = torch.cat([rlo, _i32(n, dev)]).long()
    node_rhi = torch.cat([rhi, _i32(n, dev)])
    maxr = _i32(n, dev, -1).scatter_reduce(0, node_rlo, node_rhi, "amax")
    idx_all = _i32(2 * n - 1, dev)
    is_winner = node_rhi == maxr[node_rlo]
    winner = _i32(n, dev, -1).scatter_reduce(
        0, torch.where(is_winner, node_rlo, n - 1),
        torch.where(is_winner, idx_all, -1), "amax")
    nxt = node_rhi + 1
    escape = torch.where(nxt < n, winner[torch.clamp(nxt, max=n - 1).long()],
                         -1)

    m1 = _i32(n, dev, -1)
    leaf_prim = torch.cat([_i32(ninternal, dev, -1),
                           torch.where(valid[order], order.to(torch.int32),
                                       -1)])
    return LBvh(lo, hi, torch.cat([left, m1]), torch.cat([right, m1]),
                escape, leaf_prim, count, codes_s, scene_lo, extent,
                half_max)


def build_lbvh_complete(prim_lo: torch.Tensor, prim_hi: torch.Tensor,
                        valid: Optional[torch.Tensor] = None) -> LBvh:
    """LBVH as an implicit complete binary tree over the sorted morton
    order: heap numbering (node i -> children 2i+1, 2i+2), leaves padded to
    a power of two m (padding leaves inverted), internal boxes by pairwise
    reductions, escape pointers by parent chasing.  Same :class:`LBvh`;
    every query works on it unchanged."""
    n = prim_lo.shape[0]
    dim = prim_lo.shape[-1]
    dev = prim_lo.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    m = 1 << int(np.ceil(np.log2(max(n, 2))))
    count = valid.to(torch.int32).sum().to(torch.int32)
    codes, scene_lo, extent, half_max = _quantize(prim_lo, prim_hi, valid)
    order = torch.argsort(codes, stable=True)
    codes_s = codes[order]

    pad = m - n
    vs = valid[order][:, None]
    leaf_lo = torch.where(vs, prim_lo[order], BIG)
    leaf_hi = torch.where(vs, prim_hi[order], -BIG)
    if pad:
        leaf_lo = torch.cat([leaf_lo, leaf_lo.new_full((pad, dim), BIG)])
        leaf_hi = torch.cat([leaf_hi, leaf_hi.new_full((pad, dim), -BIG)])
        codes_s = torch.cat([codes_s, _i32(pad, dev, INT32_MAX)])

    # bottom-up pairwise unions; heap level l occupies [2^l - 1, 2^(l+1) - 1)
    levels_lo, levels_hi = [leaf_lo], [leaf_hi]
    while levels_lo[-1].shape[0] > 1:
        levels_lo.append(levels_lo[-1].reshape(-1, 2, dim).amin(1))
        levels_hi.append(levels_hi[-1].reshape(-1, 2, dim).amax(1))
    lo = torch.cat(levels_lo[::-1])
    hi = torch.cat(levels_hi[::-1])

    total = 2 * m - 1
    idx = _i32(total, dev)
    is_leaf = idx >= m - 1
    left = torch.where(is_leaf, -1, 2 * idx + 1)
    right = torch.where(is_leaf, -1, 2 * idx + 2)

    # escape = right sibling of the deepest ancestor (or self) that is a
    # left child; -1 past the root
    esc = _i32(total, dev, -1)
    cur = idx
    for _ in range(int(np.log2(m)) + 1):
        is_left = (cur > 0) & (cur % 2 == 1)
        esc = torch.where((esc == -1) & is_left, cur + 1, esc)
        cur = torch.where(cur > 0, (cur - 1) // 2, 0)

    leaf_prim = torch.cat([_i32(m - 1, dev, -1),
                           torch.where(valid[order], order.to(torch.int32),
                                       -1),
                           _i32(pad, dev, -1)])
    return LBvh(lo, hi, left, right, esc, leaf_prim, count, codes_s,
                scene_lo, extent, half_max)


def query_overlaps(bvh: LBvh, q_lo: torch.Tensor, q_hi: torch.Tensor,
                   max_hits: int, valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABB overlap query by the stackless escape-pointer walk.

    Returns ``(hits [nq, max_hits]`` primitive ids in walk order, -1
    padded; ``counts [nq])``, the true counts (a hit list truncates, its
    count never does).  All still-active queries step in lockstep; every
    :data:`CHECK_EVERY` steps the host reads which are done and drops
    them, so the loop syncs with the device once per that many steps.  The
    number of steps run is kept in :data:`LAST_WALK_STEPS`.
    """
    global LAST_WALK_STEPS
    nq = q_lo.shape[0]
    dev = q_lo.device
    hits = torch.full((nq * max_hits,), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros(nq, dtype=torch.int32, device=dev)
    if valid is None:
        act = torch.arange(nq, device=dev)
    else:
        act = torch.nonzero(valid).flatten()
    qlo, qhi = q_lo[act], q_hi[act]
    node = torch.zeros(act.numel(), dtype=torch.int64, device=dev)
    c = torch.zeros(act.numel(), dtype=torch.int32, device=dev)
    left, esc, prim_of = bvh.left, bvh.escape, bvh.leaf_prim
    steps = 0
    while act.numel():
        for _ in range(CHECK_EVERY):
            live = node >= 0
            nd = torch.clamp(node, min=0)
            ov = live & aabb_overlap(bvh.lo[nd], bvh.hi[nd], qlo, qhi)
            lft = left[nd]
            is_leaf = lft < 0
            prim = prim_of[nd]
            record = ov & is_leaf & (prim >= 0)
            slot = act * max_hits + torch.clamp(c, max=max_hits - 1)
            put = record & (c < max_hits)
            hits[slot] = torch.where(put, prim, hits[slot])
            c = c + record.to(torch.int32)
            # descend if internal and overlapping, else escape
            node = torch.where(live, torch.where(ov & ~is_leaf, lft,
                                                 esc[nd]).long(), -1)
            steps += 1
        cnt[act] = c
        keep = node >= 0
        act, qlo, qhi, node, c = (act[keep], qlo[keep], qhi[keep],
                                  node[keep], c[keep])
    LAST_WALK_STEPS = steps
    return hits.view(nq, max_hits), cnt


def _quant(x, lo, extent):
    return torch.clamp((x - lo) / extent * 1024.0, 0, 1023).to(torch.int32)


def _decompose(bvh, q_lo, q_hi, cells):
    """Each query's covering aligned octree cells (at most ``cells`` of
    them) at the smallest level where they suffice.  Returns R-major
    ``[R * nq]`` entry arrays: interval start ``m_lo``, the packed
    ``(qid << 5) | (k << 1) | valid`` word and the valid mask."""
    nq, dim = q_lo.shape
    R = cells
    lo_cd = [_quant(q_lo[:, d] - bvh.half_max[d], bvh.scene_lo[d],
                    bvh.scene_extent[d]) for d in range(dim)]
    hi_cd = [_quant(q_hi[:, d] + bvh.half_max[d], bvh.scene_lo[d],
                    bvh.scene_extent[d]) for d in range(dim)]
    # smallest 2^k >= ext so the box spans <= 2 cells per axis
    ext = torch.maximum(torch.maximum(hi_cd[0] - lo_cd[0],
                                      hi_cd[1] - lo_cd[1]),
                        hi_cd[2] - lo_cd[2])
    k = torch.clamp(32 - clz32(torch.clamp(ext - 1, min=0)), min=0)
    if R < 8:
        # lift k until <= log2(R) axes straddle: axis d stops straddling
        # at level bitlen(lo_d ^ hi_d)
        h = [32 - clz32(lo_cd[d] ^ hi_cd[d]) for d in range(dim)]
        hmax = torch.maximum(torch.maximum(h[0], h[1]), h[2])
        hmin = torch.minimum(torch.minimum(h[0], h[1]), h[2])
        lift = hmin if R == 4 else h[0] + h[1] + h[2] - hmax - hmin
        k = torch.maximum(k, lift)
    k = torch.clamp(k, max=10).to(torch.int32)
    c0d = [lo_cd[d] >> k for d in range(dim)]
    c1d = [hi_cd[d] >> k for d in range(dim)]
    ii = torch.arange(R, dtype=torch.int32, device=q_lo.device)[:, None]
    if R == 8:
        # entry r's bit (2 - d) drives axis d
        cell = [c0d[d][None, :] + ((ii >> (2 - d)) & 1) for d in range(dim)]
        valid = ((cell[0] <= c1d[0][None, :]) & (cell[1] <= c1d[1][None, :])
                 & (cell[2] <= c1d[2][None, :]))
    else:
        # entry i's bit j drives the j-th straddling axis; entries past
        # 2**nstraddle would repeat a cell and are invalid
        s = [(c1d[d] > c0d[d]).to(torch.int32) for d in range(dim)]
        sidx = [torch.zeros_like(s[0]), s[0], s[0] + s[1]]
        cell = [c0d[d][None, :] + ((ii >> sidx[d][None, :]) & 1)
                * s[d][None, :] for d in range(dim)]
        valid = ii < (torch.ones_like(s[0]) << (s[0] + s[1] + s[2]))[None, :]
    base = to_int32(((expand_bits_3d(cell[0]) << 2)
                     | (expand_bits_3d(cell[1]) << 1)
                     | expand_bits_3d(cell[2]))
                    << (3 * k.to(torch.int64))[None, :])       # [R, nq]
    # invalid entries take their query's primary cell base with an empty
    # interval, so they stay interleaved with the live ones in the sort
    m_lo = torch.where(valid, base, base[0:1, :]).reshape(-1)
    vflat = valid.reshape(-1)
    qid0 = torch.arange(nq, dtype=torch.int32, device=q_lo.device).repeat(R)
    qidk = (qid0 << 5) | (k.repeat(R) << 1) | vflat.to(torch.int32)
    return m_lo, qidk, vflat


def query_overlaps_sorted(bvh: LBvh, q_lo: torch.Tensor, q_hi: torch.Tensor,
                          max_hits: int, tile: int = 128, group: int = 128,
                          extract: str = "peel", decompose: bool = False,
                          cells: int = 8, uniform_extent=None):
    """AABB overlap query as a sorted banded tile join.

    Queries (or, with ``decompose``, each query's covering aligned cells)
    sort by the morton code of their dilated lower corner; each tile of
    ``tile`` entries tests a 3-block window of sorted leaves anchored at
    the tile's smallest interval start, and certifies per entry that every
    leaf whose code lies in its interval is inside the window
    (``in_band``).  ``group`` tiles are joined per step.  ``extract`` is
    ``"peel"`` (the first ``max_hits`` overlapping window lanes) or
    ``"none"`` (counts only).

    Returns ``(qid, hits [E, max_hits], counts [E], in_band [E])`` in
    sorted entry order.  With ``decompose`` the rows are entry-granular:
    combine by ``qid`` (counts add, in_band ANDs, hit sets union; cells
    are disjoint).  ``uniform_extent``: every query box is ``centre +- r``;
    pass the centres as ``q_lo`` (``q_hi`` is ignored) and ``r``.
    """
    if extract not in ("peel", "none"):
        raise ValueError(f"extract must be 'peel' or 'none', got {extract!r}")
    n = bvh.num_leaves
    nq, dim = q_lo.shape
    dev = q_lo.device
    leaf_lo = bvh.lo[n - 1:]
    leaf_hi = bvh.hi[n - 1:]
    leaf_prim = bvh.leaf_prim[n - 1:]
    if uniform_extent is not None:
        uext = torch.as_tensor(uniform_extent, dtype=q_lo.dtype,
                               device=dev).expand(dim)
        centers = q_lo
        q_lo = centers - uext
        q_hi = centers + uext

    if decompose:
        if cells not in (8, 4, 2):
            raise ValueError("decompose cells must be 8, 4 or 2")
        if nq > (1 << 26):
            raise ValueError("decompose packs qid into 26 bits of one "
                             "sort operand; split batches beyond 2^26")
        R = cells
        m_lo, qidk, vflat = _decompose(bvh, q_lo, q_hi, R)
        nq = nq * R
    else:
        R = 1
        m_lo = morton3d(_quant(q_lo - bvh.half_max, bvh.scene_lo,
                               bvh.scene_extent))
        m_hi = morton3d(_quant(q_hi + bvh.half_max, bvh.scene_lo,
                               bvh.scene_extent))
        qid0 = torch.arange(nq, dtype=torch.int32, device=dev)

    T = tile
    if nq % T:
        raise ValueError("query count must be a multiple of tile")
    ntiles = nq // T
    G = min(group, ntiles)
    while ntiles % G:
        G -= 1

    # entries sorted by interval start, the query columns riding along;
    # decomposed entries that are invalid get boxes that overlap nothing
    if uniform_extent is not None:
        qcols = [centers[:, d] for d in range(dim)]
        fills = [BIG] * dim
    else:
        qcols = [q_lo[:, d] for d in range(dim)] + [q_hi[:, d]
                                                    for d in range(dim)]
        fills = [BIG] * dim + [-BIG] * dim
    if decompose:
        qcols = [torch.where(vflat, c.repeat(R), f)
                 for c, f in zip(qcols, fills)]
    if decompose:
        # JAX leaves the order of equal interval starts open (an unstable
        # sort).  Here empty entries come first, then valid ones by cell
        # level and qid: a wide interval lands in the later tile, whose
        # window starts nearer to it.  The key is unique, so every device
        # gives the same order.
        tie = (((qidk & 1) << 30) | (((qidk >> 1) & 15) << 26)
               | (qidk >> 5))
        perm = torch.argsort((m_lo.to(torch.int64) << 32) | tie)
    else:
        perm = torch.argsort(m_lo, stable=True)
    sm_lo = m_lo[perm]
    qcols = [c[perm] for c in qcols]
    if decompose:
        sqidk = qidk[perm]
        qid = sqidk >> 5
        sm_hi = sm_lo + ((sqidk & 1) << (((sqidk >> 1) & 15) * 3)) - 1
    else:
        sm_hi = m_hi[perm]
        qid = qid0[perm]
    if uniform_extent is not None:
        sq_lo = [qcols[d] - uext[d] for d in range(dim)]
        sq_hi = [qcols[d] + uext[d] for d in range(dim)]
    else:
        sq_lo, sq_hi = qcols[:dim], qcols[dim:]

    # leaf window per tile, anchored at the tile's smallest interval start
    # floored to a TL-block boundary
    TL = -(-n // ntiles)
    nlt = -(-n // TL) + 3
    tile_min = sm_lo.reshape(ntiles, T).amin(1)
    # #{j : codes[j * TL] < tile_min}: the block-leading codes are sorted
    bound = bvh.codes[::TL].contiguous()
    jstar = torch.searchsorted(bound, tile_min).to(torch.int32)
    w0 = torch.clamp(jstar - 1, 0, nlt - 3) * TL
    # in-band certificate from the window's edge codes: every leaf whose
    # code is in [m_lo, m_hi] lies inside [w0, w0 + 3TL) iff the code just
    # before the window is < m_lo and the one just after is > m_hi
    edge_l = bvh.codes[torch.clamp(w0 - 1, 0, n - 1).long()]
    edge_r = bvh.codes[torch.clamp(w0 + 3 * TL, 0, n - 1).long()]
    left_ok = ((w0 == 0)[:, None]
               | (edge_l[:, None] < sm_lo.view(ntiles, T))).view(-1)
    right_ok = ((w0 + 3 * TL >= n)[:, None]
                | (edge_r[:, None] > sm_hi.view(ntiles, T))).view(-1)
    in_band = (left_ok & right_ok) | (sm_lo > sm_hi)

    blk = (w0 // TL).long()[:, None] + torch.arange(3, device=dev)[None]

    def window(a, fill):
        # 1-D leaf column -> [ntiles, 3TL] of whole TL blocks
        ap = torch.cat([a, a.new_full((nlt * TL - n,), fill)])
        return ap.view(nlt, TL)[blk].reshape(ntiles, 3 * TL)

    wl = [window(leaf_lo[:, d], BIG) for d in range(dim)]
    wh = [window(leaf_hi[:, d], -BIG) for d in range(dim)]
    wp = window(leaf_prim, -1)
    if decompose:
        wc = window(bvh.codes, INT32_MAX)
    ql = [c.view(ntiles, T) for c in sq_lo]
    qh = [c.view(ntiles, T) for c in sq_hi]
    lo_t, hi_t = sm_lo.view(ntiles, T), sm_hi.view(ntiles, T)

    if extract == "peel":
        prim_bits = max(1, int(n - 1).bit_length())
        lane_bits = int(3 * TL - 1).bit_length()
        if prim_bits + lane_bits > 31:
            raise ValueError(
                f"peel extract: {n} prims x {3 * TL}-lane window exceeds "
                f"the 31-bit composite key; use a smaller tile")
        lane_key = (torch.arange(3 * TL, dtype=torch.int32, device=dev)
                    << prim_bits)
        kpeel = min(max_hits, 3 * TL)
    cnt = torch.empty((ntiles, T), dtype=torch.int32, device=dev)
    hits = torch.full((ntiles, T, max_hits), -1, dtype=torch.int32,
                      device=dev)
    for s in range(0, ntiles, G):
        t = slice(s, s + G)
        ov = (wp[t] >= 0)[:, None, :]                   # [G, T, 3TL]
        if decompose:
            ov = (ov & (wc[t][:, None, :] >= lo_t[t][:, :, None])
                  & (wc[t][:, None, :] <= hi_t[t][:, :, None]))
        for d in range(dim):
            ov = (ov & (wh[d][t][:, None, :] >= ql[d][t][:, :, None])
                  & (qh[d][t][:, :, None] >= wl[d][t][:, None, :]))
        cnt[t] = ov.sum(-1, dtype=torch.int32)
        if extract == "peel":
            # the first max_hits overlapping lanes, in lane order, by the
            # smallest composite (lane << prim_bits) | prim keys
            comp = torch.where(ov, lane_key | torch.clamp(wp[t], min=0)
                               [:, None, :], INT32_MAX)
            m = torch.topk(comp, kpeel, dim=-1, largest=False).values
            hits[t, :, :kpeel] = torch.where(
                m < INT32_MAX, m & ((1 << prim_bits) - 1), -1)
    return (qid, hits.view(nq, max_hits), cnt.view(nq), in_band)


def query_overlaps_exact(bvh: LBvh, q_lo: torch.Tensor, q_hi: torch.Tensor,
                         max_hits: int, *, tile: int = 128, group: int = 512,
                         cells: int = 4, residue_budget: Optional[int] = None,
                         uniform_extent=None):
    """Exact per-query overlap answers: the decomposed banded join, plus
    the escape walk for the queries it cannot certify, compacted into a
    fixed ``residue_budget`` buffer.

    Returns ``(qid_rows, hits_rows, counts, overflow)``: ``counts [nq]`` is
    the exact count of every query; ``(qid_rows, hits_rows)`` are union
    rows (the residue queries' join rows are invalidated and their walk
    rows appended).  A query with ``counts > max_hits`` has a truncated hit
    list.  ``overflow`` (0-d bool) is True when more than
    ``residue_budget`` queries fell out of band; their counts are then not
    exact and the caller must retry with a larger budget.
    """
    nq0, dim = q_lo.shape
    dev = q_lo.device
    if residue_budget is None:
        residue_budget = max(tile, nq0 // 64)
    nq = -(-nq0 // tile) * tile
    pad = nq - nq0
    if pad:
        far = q_lo.new_full((pad, dim), 1e9)
        q_lo = torch.cat([q_lo, far])
        q_hi = torch.cat([q_hi, far])
    qid, hits_e, cnt_e, band_e = query_overlaps_sorted(
        bvh, q_lo, q_hi, max_hits, tile=tile, group=group, extract="peel",
        decompose=True, cells=cells, uniform_extent=uniform_extent)
    qidl = qid.long()
    # per-query combine (disjoint cells: counts add, band ANDs)
    cnt_q = torch.zeros(nq, dtype=torch.int32, device=dev).index_add_(
        0, qidl, cnt_e)
    band_q = torch.ones(nq, dtype=torch.int32, device=dev).scatter_reduce(
        0, qidl, band_e.to(torch.int32), "amin") > 0
    # residue compaction to the fixed budget
    res = ~band_q
    rank = torch.cumsum(res.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(res & (rank < residue_budget), rank, residue_budget)
    ridx = torch.full((residue_budget + 1,), nq, dtype=torch.int32,
                      device=dev).scatter_(
        0, slot.long(), torch.arange(nq, dtype=torch.int32, device=dev)
    )[:residue_budget]
    overflow = res.sum() > residue_budget
    rvalid = ridx < nq
    rclip = torch.clamp(ridx, 0, nq - 1).long()
    if uniform_extent is not None:
        uext = torch.as_tensor(uniform_extent, dtype=q_lo.dtype,
                               device=dev).expand(dim)
        r_lo = q_lo[rclip] - uext
        r_hi = q_lo[rclip] + uext
    else:
        r_lo = q_lo[rclip]
        r_hi = q_hi[rclip]
    w_hits, w_cnt = query_overlaps(bvh, r_lo, r_hi, max_hits, valid=rvalid)
    cnt_q = torch.where(band_q, cnt_q, 0).index_add_(
        0, rclip, torch.where(rvalid, w_cnt, 0))
    # union rows: invalidate the residue queries' join rows, append walks
    hits_e = torch.where(band_q[qidl][:, None], hits_e, -1)
    qid_rows = torch.cat([qid, torch.where(rvalid, rclip.to(torch.int32),
                                           0)])
    hits_rows = torch.cat([hits_e, torch.where(rvalid[:, None], w_hits, -1)])
    return qid_rows, hits_rows, cnt_q[:nq0], overflow
