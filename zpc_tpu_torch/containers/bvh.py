"""Linear BVH (LBVH) broad phase: Karras build and AABB overlap queries.

Counterpart of ``zpc_tpu/containers/bvh.py``, checked against it on the
same inputs.  The build is the JAX package's: morton quantization in one
cubic scene box, a stable sort, the Karras topology as two
nearest-smaller-element sweeps (:func:`zpc_tpu_torch.ops.nse.nse`, the hand
CUDA kernel on the card), internal boxes from a sparse table over the
sorted leaf boxes, and escape pointers by scatter-max.  Node ids: internal
nodes ``[0, n-1)`` with the root at 0, leaves ``[n-1, 2n-1)``.

Queries: :func:`query_overlaps`, :func:`query_nearest` and
:func:`query_ray` are the stackless escape-pointer walk, a lockstep loop
over the still-active queries; :func:`query_overlaps_sorted` and
:func:`query_nearest_sorted` are the sorted banded tile joins, with the JAX
package's tiling, window and in-band certificate, so a query's ``in_band``
means the same in both packages; :func:`query_overlaps_exact` answers every
query exactly with a bounded walk for the out-of-band residue.
:class:`BvttFront` caches (query, primitive) pairs between rebuilds.

The JAX package's TPU layout workarounds are not carried over: the f32 row
packing of the walk, the transposed join orientation and the f32 halves of
the code compare become plain int32 gathers and compares with the same
results.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.executor import Executor
from ..math.bits import clz32, common_prefix_length, expand_bits_3d, \
    morton3d, to_int32
from ..math.rounding import div_rn, sqrt_rn
from ..ops.nse import nse
from ..parallel.primitives import inclusive_scan

__all__ = ["LBvh", "aabb_overlap", "build_lbvh", "build_lbvh_complete",
           "query_overlaps", "query_overlaps_sorted", "query_overlaps_exact",
           "query_nearest", "query_nearest_sorted", "query_ray", "BvttFront",
           "EXTRACTS", "CHECK_EVERY", "LAST_WALK_STEPS"]

BIG = 3.4e38                   # box fill: inverted boxes overlap nothing
INT32_MAX = 2 ** 31 - 1

CHECK_EVERY = 16
"""Walk steps between two reads of the escape walks' exit flags."""

LAST_WALK_STEPS = 0
"""Iterations of the most recent escape walk (:func:`query_overlaps`,
:func:`query_nearest` or :func:`query_ray`; a multiple of
:data:`CHECK_EVERY` unless ``max_iters`` cut it)."""

EXTRACTS = ("peel", "bitpeel", "topk", "scan", "none")
"""The hit extractions of :func:`query_overlaps_sorted`."""

_POL = Executor()            # the scans run on their tensors' device


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


def _rank_any(codes: torch.Tensor, vals: torch.Tensor,
              side: str) -> torch.Tensor:
    """``searchsorted(codes, vals, side)`` as int32, for ``vals`` in any
    order (the JAX package merges the two arrays by one packed sort, a TPU
    workaround for its slow binary search)."""
    return torch.searchsorted(codes.contiguous(), vals.contiguous(),
                              right=side == "right").to(torch.int32)


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


def _lockstep(step: Callable, carry: dict, outs: dict,
              max_iters: Optional[int] = None) -> None:
    """The escape walk's loop.  ``carry`` holds per-lane tensors, among
    them ``lane`` (the lane's row in the outputs) and ``node`` (-1 once the
    walk is over); every still-active lane advances one node per
    ``step(carry) -> carry``.  Every :data:`CHECK_EVERY` steps the host
    writes ``carry[k]`` into ``outs[k]`` at the lanes' rows and drops the
    lanes that are done, so the loop syncs with the device once per that
    many steps.  ``max_iters`` caps the steps of every lane (they start
    together).  The number of steps run is kept in
    :data:`LAST_WALK_STEPS`."""
    global LAST_WALK_STEPS
    steps = 0
    cap = float("inf") if max_iters is None else max_iters
    while carry["lane"].numel() and steps < cap:
        for _ in range(int(min(CHECK_EVERY, cap - steps))):
            carry = step(carry)
            steps += 1
        for k, o in outs.items():
            o[carry["lane"]] = carry[k]
        keep = carry["node"] >= 0
        carry = {k: v[keep] for k, v in carry.items()}
    LAST_WALK_STEPS = steps


def query_overlaps(bvh: LBvh, q_lo: torch.Tensor, q_hi: torch.Tensor,
                   max_hits: int, valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABB overlap query by the stackless escape-pointer walk.

    Returns ``(hits [nq, max_hits]`` primitive ids in walk order, -1
    padded; ``counts [nq])``, the true counts (a hit list truncates, its
    count never does).  All still-active queries step in lockstep
    (:func:`_lockstep`); the number of steps run is kept in
    :data:`LAST_WALK_STEPS`.
    """
    nq = q_lo.shape[0]
    dev = q_lo.device
    hits = torch.full((nq * max_hits,), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros(nq, dtype=torch.int32, device=dev)
    if valid is None:
        act = torch.arange(nq, device=dev)
    else:
        act = torch.nonzero(valid).flatten()
    left, esc, prim_of = bvh.left, bvh.escape, bvh.leaf_prim

    def step(w):
        node = w["node"]
        live = node >= 0
        nd = torch.clamp(node, min=0)
        ov = live & aabb_overlap(bvh.lo[nd], bvh.hi[nd], w["qlo"], w["qhi"])
        lft = left[nd]
        is_leaf = lft < 0
        prim = prim_of[nd]
        record = ov & is_leaf & (prim >= 0)
        c = w["c"]
        slot = w["lane"] * max_hits + torch.clamp(c, max=max_hits - 1)
        hits[slot] = torch.where(record & (c < max_hits), prim, hits[slot])
        # descend if internal and overlapping, else escape
        node = torch.where(live, torch.where(ov & ~is_leaf, lft,
                                             esc[nd]).long(), -1)
        return dict(w, node=node, c=c + record.to(torch.int32))

    _lockstep(step, dict(lane=act, node=torch.zeros_like(act),
                         qlo=q_lo[act], qhi=q_hi[act],
                         c=torch.zeros(act.numel(), dtype=torch.int32,
                                       device=dev)), {"c": cnt})
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
                          cells: int = 8, compact: Optional[int] = None,
                          uniform_extent=None):
    """AABB overlap query as a sorted banded tile join.

    Queries (or, with ``decompose``, each query's covering aligned cells)
    sort by the morton code of their dilated lower corner; each tile of
    ``tile`` entries tests a 3-block window of sorted leaves anchored at
    the tile's smallest interval start, and certifies per entry that every
    leaf whose code lies in its interval is inside the window
    (``in_band``).  ``group`` tiles are joined per step.  ``extract`` is
    one of :data:`EXTRACTS`: ``"peel"``, ``"bitpeel"``, ``"topk"`` and
    ``"scan"`` all give the first ``max_hits`` overlapping window lanes in
    lane order (the JAX package's four strategies for the TPU; here one
    extraction serves them, with no composite key and so without the
    JAX peel's 31-bit limit); ``"none"`` gives counts only.  The tiles are independent, so
    ``group`` only sets how many are joined at once (the JAX package
    shrinks it to a divisor of the tile count).

    Returns ``(qid, hits [E, max_hits], counts [E], in_band [E])`` in
    sorted entry order.  With ``decompose`` the rows are entry-granular:
    combine by ``qid`` (counts add, in_band ANDs, hit sets union; cells
    are disjoint).  ``compact`` (decompose only, a multiple of ``tile``) is
    a budget of live entries: the live cells sort to the front and only
    the first ``compact`` entries are joined; when more are live, every
    entry is flagged out of band and the whole call is void.  A query
    whose live cells all fell past the budget then has no row at all, and
    the combine above would read it as certified with count 0: so when
    every row is flagged under ``compact``, treat the call as overflowed.  ``uniform_extent``: every query box is
    ``centre +- r``; pass the centres as ``q_lo`` (``q_hi`` is ignored)
    and ``r``.
    """
    if extract not in EXTRACTS:
        raise ValueError(f"extract must be one of {EXTRACTS}, got "
                         f"{extract!r}")
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
        if compact is not None:
            # live cells sort to the front; the budget slice keeps them
            m_lo = torch.where(vflat, m_lo, INT32_MAX)
        nq = nq * R
    else:
        R = 1
        m_lo = morton3d(_quant(q_lo - bvh.half_max, bvh.scene_lo,
                               bvh.scene_extent))
        m_hi = morton3d(_quant(q_hi + bvh.half_max, bvh.scene_lo,
                               bvh.scene_extent))
        qid0 = torch.arange(nq, dtype=torch.int32, device=dev)
    if compact is not None:
        if not decompose:
            raise ValueError("compact requires decompose=True")
        if compact % tile or compact > nq:
            raise ValueError(f"compact budget {compact} must be a multiple "
                             f"of tile <= {nq}")

    T = tile
    if nq % T:
        raise ValueError("query count must be a multiple of tile")
    ne = nq if compact is None else compact
    ntiles = ne // T
    G = min(group, ntiles)          # the last group may be smaller

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
        # JAX leaves the order of equal interval starts open (an unstable
        # sort).  Here empty entries come first, then valid ones by cell
        # level and qid: a wide interval lands in the later tile, whose
        # window starts nearer to it.  The key is unique, so every device
        # gives the same order.
        tie = (((qidk & 1) << 30) | (((qidk >> 1) & 15) << 26)
               | (qidk >> 5))
        perm = torch.argsort((m_lo.to(torch.int64) << 32) | tie)[:ne]
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
    if compact is not None:
        in_band = in_band & (vflat.sum() <= compact)

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

    lanes = torch.arange(3 * TL, dtype=torch.int32, device=dev)
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
        if extract != "none":
            # the first max_hits overlapping lanes, in lane order
            key = torch.where(ov, lanes, 3 * TL)
            first = torch.topk(key, kpeel, dim=-1, largest=False).values
            prim = torch.gather(wp[t][:, None, :].expand(-1, T, -1), 2,
                                first.clamp_max(3 * TL - 1).long())
            hits[t, :, :kpeel] = torch.where(first < 3 * TL, prim, -1)
    return (qid, hits.view(ne, max_hits), cnt.view(ne), in_band)


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


def query_nearest_sorted(bvh: LBvh, points: torch.Tensor,
                         prim_points: torch.Tensor, tile: int = 128,
                         group: int = 128):
    """Nearest point primitive of each query as a sorted banded scan, with
    an a-posteriori certificate.

    Queries sort by morton code onto the leaf diagonal; each tile of
    ``tile`` queries takes the squared distances to a 3-tile window of
    leaf points (the leaf tiles before, at and after its own position) and
    their argmin, ``group`` tiles per step.  Any primitive closer than the
    found distance ``rb`` has a code in ``[m(q - rb), m(q + rb)]``, so when
    that leaf interval lies inside the window the answer is exact
    (``in_band``); answer the rest with :func:`query_nearest`.

    ``prim_points [n_prims, dim]`` are the primitive coordinates in
    primitive order.  Returns ``(qid, best_prim, best_d2, in_band)`` in
    sorted-query order.
    """
    n = bvh.num_leaves
    nq, dim = points.shape
    dev = points.device
    T = tile
    if nq % T:
        raise ValueError("query count must be a multiple of tile")
    ntiles = nq // T
    G = min(group, ntiles)          # the last group may be smaller
    leaf_prim = bvh.leaf_prim[n - 1:]
    lpts = torch.where((leaf_prim >= 0)[:, None],
                       prim_points[leaf_prim.clamp_min(0).long()], BIG)

    def mcode(x):
        return morton3d(_quant(x, bvh.scene_lo, bvh.scene_extent))

    perm = torch.argsort(mcode(points), stable=True)
    qid = perm.to(torch.int32)
    sp = points[perm]

    TL = -(-n // ntiles)
    lt = torch.cat([lpts, lpts.new_full((ntiles * TL - n, dim), BIG)])
    lt = lt.view(ntiles, TL, dim)
    fill = torch.full_like(lt[:1], BIG)
    wpts = torch.cat([torch.cat([fill, lt[:-1]]), lt,
                      torch.cat([lt[1:], fill])], dim=1)   # [ntiles, 3TL, dim]
    sq = sp.view(ntiles, T, dim)
    best = torch.empty((ntiles, T), dtype=points.dtype, device=dev)
    lane = torch.empty((ntiles, T), dtype=torch.int64, device=dev)
    for s in range(0, ntiles, G):
        w, q = wpts[s:s + G], sq[s:s + G]
        d2 = torch.zeros((w.shape[0], 3 * TL, T), dtype=points.dtype,
                         device=dev)
        for d in range(dim):
            diff = w[:, :, None, d] - q[:, None, :, d]
            d2 = d2 + diff * diff
        best[s:s + G] = d2.amin(1)
        lane[s:s + G] = torch.argmin(d2, 1)       # the first minimum
    best = best.view(nq)
    found = best < 1e37
    tile_of = torch.arange(nq, device=dev) // T
    leaf = torch.clamp((tile_of - 1) * TL + lane.view(nq), 0, n - 1)
    best_prim = torch.where(found, leaf_prim[leaf], -1)

    # the certificate: the whole candidate interval inside the window
    rb = sqrt_rn(torch.where(found, best, 0.0))[:, None]
    s = _rank_any(bvh.codes, mcode(sp - rb), "left")
    e = _rank_any(bvh.codes, mcode(sp + rb), "right")
    in_band = found & (s >= (tile_of - 1) * TL) & (e <= (tile_of + 2) * TL)
    return qid, best_prim, best, in_band


def query_nearest(bvh: LBvh, points: torch.Tensor, prim_dist: Callable,
                  max_iters: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest primitive of each point by the escape walk, pruned by each
    node box's distance.

    ``prim_dist(ids [m], pts [m, dim]) -> [m]`` is batched: the exact
    distance from each point to its primitive, in the same linear units as
    space (the box bound is a linear norm).  It is called on every active
    lane each step, with ids clamped to 0 where the lane is at no valid
    leaf, and those lanes' values are discarded.  (The JAX package's
    ``prim_dist(id, p)`` is a scalar function under ``vmap``.)
    ``max_iters`` caps the walk steps per query, by default ``2n - 1``
    (every node); a smaller cap trades exactness for time.  Returns
    ``(ids, dists)``, -1 and inf where nothing was found.
    """
    if max_iters is None:
        max_iters = bvh.lo.shape[0]
    nq = points.shape[0]
    dev = points.device
    ids = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    dist = torch.full((nq,), float("inf"), dtype=points.dtype, device=dev)
    left, esc, prim_of = bvh.left, bvh.escape, bvh.leaf_prim

    def step(w):
        node, p, bd = w["node"], w["p"], w["bd"]
        live = node >= 0
        nd = torch.clamp(node, min=0)
        g = (torch.clamp(bvh.lo[nd] - p, min=0.0)
             + torch.clamp(p - bvh.hi[nd], min=0.0))
        lb = torch.sqrt((g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1])
                        + g[:, 2] * g[:, 2])
        prune = lb >= bd
        lft = left[nd]
        is_leaf = lft < 0
        prim = prim_of[nd]
        d = torch.where(live & is_leaf & (prim >= 0) & ~prune,
                        prim_dist(prim.clamp_min(0), p), float("inf"))
        better = d < bd
        node = torch.where(live, torch.where(~prune & ~is_leaf, lft,
                                             esc[nd]).long(), -1)
        return dict(w, node=node, bd=torch.where(better, d, bd),
                    bid=torch.where(better, prim, w["bid"]))

    lanes = torch.arange(nq, device=dev)
    _lockstep(step, dict(lane=lanes, node=torch.zeros_like(lanes), p=points,
                         bd=dist.clone(), bid=ids.clone()),
              {"bd": dist, "bid": ids}, max_iters)
    return ids, dist


def query_ray(bvh: LBvh, origins: torch.Tensor, dirs: torch.Tensor,
              prim_hit: Callable, t_max: float = float("inf"),
              max_iters: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest hit of each ray by the escape walk, pruned by the slab test
    against the best ``t`` so far.

    ``prim_hit(ids [m], origins [m, dim], dirs [m, dim]) -> t [m]`` is
    batched (inf on a miss); it is called on every active lane each step,
    with ids clamped to 0 where the lane is at no valid leaf, and those
    lanes' values are discarded.  (The JAX package's ``prim_hit(id, o, d)``
    is a scalar function under ``vmap``.)  ``max_iters`` as in
    :func:`query_nearest`.  Returns ``(ids, t)``: -1 and ``t_max`` where no
    primitive was hit before ``t_max``.
    """
    if max_iters is None:
        max_iters = bvh.lo.shape[0]
    nq = origins.shape[0]
    dev = origins.device
    ids = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    t = torch.full((nq,), t_max, dtype=origins.dtype, device=dev)
    left, esc, prim_of = bvh.left, bvh.escape, bvh.leaf_prim
    tiny = torch.where(dirs < 0, -1e-12, 1e-12)
    inv = div_rn(1.0, torch.where(dirs.abs() < 1e-12, tiny, dirs))

    def step(w):
        node, o, bt = w["node"], w["o"], w["bt"]
        live = node >= 0
        nd = torch.clamp(node, min=0)
        t0 = (bvh.lo[nd] - o) * w["inv"]
        t1 = (bvh.hi[nd] - o) * w["inv"]
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        hit = live & (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < bt)
        lft = left[nd]
        is_leaf = lft < 0
        prim = prim_of[nd]
        th = torch.where(hit & is_leaf & (prim >= 0),
                         prim_hit(prim.clamp_min(0), o, w["d"]),
                         float("inf"))
        better = th < bt
        node = torch.where(live, torch.where(hit & ~is_leaf, lft,
                                             esc[nd]).long(), -1)
        return dict(w, node=node, bt=torch.where(better, th, bt),
                    bid=torch.where(better, prim, w["bid"]))

    lanes = torch.arange(nq, device=dev)
    _lockstep(step, dict(lane=lanes, node=torch.zeros_like(lanes), o=origins,
                         d=dirs, inv=inv, bt=t.clone(), bid=ids.clone()),
              {"bt": t, "bid": ids}, max_iters)
    return ids, t


@dataclasses.dataclass(frozen=True)
class BvttFront:
    """A retained set of candidate (query, primitive) pairs: rebuilt from
    an overlap walk, re-validated cheaply between rebuilds (the reference's
    ``Bvtt`` front).  Padded pair arrays (-1 past ``count``)."""

    qid: torch.Tensor     # [cap] int32 query index, -1 padding
    pid: torch.Tensor     # [cap] int32 primitive index
    count: torch.Tensor   # 0-d int32: pairs kept, at most cap

    @property
    def capacity(self) -> int:
        return self.qid.shape[0]

    @staticmethod
    def rebuild(bvh: LBvh, q_lo: torch.Tensor, q_hi: torch.Tensor,
                max_hits_per_query: int, capacity: int) -> "BvttFront":
        """Every pair of :func:`query_overlaps` (``max_hits_per_query`` per
        query), compacted in (query, walk) order by a prefix sum, the scan
        kernel on the card.  Past ``capacity`` the first ``capacity`` pairs
        are kept."""
        hits, _ = query_overlaps(bvh, q_lo, q_hi, max_hits_per_query)
        nq, mh = hits.shape
        dev = hits.device
        qid = torch.arange(nq, dtype=torch.int32,
                           device=dev).repeat_interleave(mh)
        pid = hits.reshape(-1)
        ok = pid >= 0
        pos = inclusive_scan(_POL, ok.to(torch.int32)) - 1
        dst = torch.where(ok & (pos < capacity), pos, capacity).long()
        qout = _i32(capacity + 1, dev, -1).scatter_(0, dst, qid)
        pout = _i32(capacity + 1, dev, -1).scatter_(0, dst, pid)
        return BvttFront(qout[:capacity], pout[:capacity],
                         torch.clamp(pos[-1] + 1, max=capacity))

    def refresh(self, prim_lo, prim_hi, q_lo, q_hi) -> torch.Tensor:
        """Mask of the pairs that still overlap under updated boxes."""
        qs = self.qid.clamp_min(0).long()
        ps = self.pid.clamp_min(0).long()
        return (self.qid >= 0) & aabb_overlap(prim_lo[ps], prim_hi[ps],
                                              q_lo[qs], q_hi[qs])
