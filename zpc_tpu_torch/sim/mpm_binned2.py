"""Binned explicit MPM, 2-D and 3-D (counterpart of
``zpc_tpu/sim/mpm_binned2.py``).

Particles live in **bin order**: ``L = bins_capacity * K`` lanes, grouped
into bins of ``K = 128`` lanes that each belong to one 4^dim-cell grid
block.  Every block's run of particles is padded with dummy lanes (m = 0,
pid = -1) to a multiple of K, so the sorted lanes reshape into bins.  The
state stays in bin order across steps; original order comes back once, in
:func:`unbin_state`.

Bins are keyed on ``floor((base - 1) / 4)`` (drift slack 1): a fresh bin's
stencil bases sit at window offsets [1, 4] of an 8-node window that spans
its block and the next one on each axis, so a particle can drift a cell
either way before it leaves the window.  The step flags ``needs_rebin``
when one has; :func:`adaptive_chain` then re-sorts (:func:`rebin_adaptive`)
before the next step.  The grid origin follows the bulk integer drift
(recentering), so pure translation never forces a rebin.  With
``migrate_capacity`` set, the rebin first moves the particles near their
window's edge into free lanes of their new block's bins
(:func:`_rebin_incremental`; ``reserve_bins`` gives every block free bins
for it) and takes the full sort only when that needs new structure.

The rebins' prefix sums go through
:func:`zpc_tpu_torch.parallel.primitives.inclusive_scan`, which launches the
CUDA scan kernel for a CUDA tensor.

The transfers are plain PyTorch, in helpers that the elastic step and the
fluid step (``sim/fluid_binned2.py``) share, in either dimension:
:func:`_make_ctx` places each lane's 3^dim stencil nodes in its bin's
window (the window's quadrant maps through the frozen ``nbr8`` table to a
block slot, and the node's cell within that block gives the flat index);
:func:`_ctx_p2g` is one ``index_add_`` of (m, m v + A dx) into an
``[nb * 4^dim + 1, 1 + dim]`` accumulator whose last row takes whatever
falls outside; :func:`_grid_update`, :func:`_ctx_g2p` and
:func:`_recenter` follow, and :func:`_advance` ends the elastic step from
the node velocities.  A state with ``Jp`` carries it as a last column
(the 27th in 3-D, the 15th in 2-D), projected with the new F by
``sim.plasticity``.  The implicit step (``sim/implicit_binned2.py``) adds
:func:`_ctx_p2g_affine`, a P2G of any number of plain-plus-affine
channels, and reads :func:`_ctx_g2p` of any node field as its operator's
gather; its mesh contact adds :func:`_ctx_p2g_squared` (squared weights)
and :func:`_advance`'s displacement scale (the CCD clamp).

Not ported (TPU workarounds, see ROADMAP.md): ``chunk_bins`` (the chunked
transfer is physics-identical to the unchunked one), ``sort_chunk``,
``use_segments`` and the one-hot spill selection, the spill tables for
slack 0, and ``recenter=False``.

The JAX 2-D step keeps its grid origin in the transform's column 2
(``matrix[:2, 2]``), where every other path reads column 3; the port keeps
it in column 3 (:attr:`SparseGrid.origin`) in 2-D as in 3-D.  The two
agree for a grid made without an origin.

Each stage runs inside a span of :mod:`zpc_tpu_torch.utils.profile`
(``zpc.ctx``, ``zpc.stress``, ``zpc.p2g``, ``zpc.grid_update``,
``zpc.advance`` with ``zpc.g2p`` inside; ``zpc.rebin.migrate`` and
``zpc.rebin.full`` with ``zpc.rebin.sort``, ``zpc.rebin.groups`` and
``zpc.rebin.finish`` inside).  The chain's flag reads and the rebin's
choice count in ``HOST_SYNCS`` as ``chain_flag`` and ``rebin_choice``, and
the stencil's and the block table's constant tables, copied to the device
where they are used, as ``ctx_offsets``, ``node_corners``,
``bin_offsets`` and ``slot_dirs``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..containers.block_table import (KEY_SENTINEL, build_block_table,
                                      pack_coords, unpack_key)
from ..core.executor import Executor
from ..geometry.collider import resolve_boundaries
from ..geometry.sparse_grid import SparseGrid, neighbor_offsets
from ..math.interpolation import bspline_weights
from ..math.vecmat import mm
from ..parallel.primitives import inclusive_scan
from ..utils.profile import read_host, span, spanned, to_device
from .mpm import MPMSim, MPMState

__all__ = ["K", "BinnedConfig2", "BinState", "bin_state", "unbin_state",
           "rebin_adaptive", "explicit_step_binned2", "adaptive_chain",
           "rollout_binned2"]

K = 128                      # lanes per bin
SLACK = 1                    # drift slack in cells
SIDE = 6 + 2 * SLACK         # window side in nodes
_POL = Executor()            # the scans run on their tensors' device


@dataclasses.dataclass(frozen=True)
class BinnedConfig2:
    """Drift slack 1 (:data:`SLACK`) and recentering are fixed in the port;
    :func:`zpc_tpu_torch.interop.config_from_jax` rejects a JAX config that
    sets them otherwise.  ``migrate_capacity`` > 0 lets
    :func:`rebin_adaptive` migrate up to that many particles into free
    lanes of their new block's bins before it falls back to the full
    sort; ``reserve_bins`` gives every block that many all-dummy bins at
    each full sort, free lanes for the migration (they cost bin budget,
    not step time)."""

    bins_capacity: int                    # static bin count (L = bins * K)
    block_capacity: Optional[int] = None  # dilated table capacity (None:
                                          # the grid's)
    migrate_capacity: int = 0
    reserve_bins: int = 0


@dataclasses.dataclass(frozen=True)
class BinState:
    """Particle state in bin order.

    ``cols``: [L, W] packed channels: x v F C m vol (W = 26 in 3-D, 14 in
    2-D), plus Jp (W = 27, 15) for a plastic state, or the fluid layout x
    v J C m vol (W = 18, 11, ``sim/fluid_binned2.py``); dummy and dead
    lanes carry m = 0.  ``pid``: [L] original particle index, -1 on dummy
    lanes.  ``bin_block``: [bins] table slot per bin frozen at rebin time
    (-1: dead bin).  ``nbr8``: [nb, 2^dim] table slots of each block and
    its +1 neighbours (the window's quadrants), -1 where absent, frozen
    with the table.  ``overflow``, ``needs_rebin``: 0-d bool tensors.
    """

    cols: torch.Tensor
    pid: torch.Tensor
    grid: SparseGrid
    max_vel: torch.Tensor
    overflow: torch.Tensor
    needs_rebin: torch.Tensor
    bin_block: torch.Tensor
    nbr8: torch.Tensor

    @property
    def has_jp(self) -> bool:
        """The elastic layout with the Jp column (27 wide in 3-D, 15 in
        2-D)."""
        d = self.grid.dim
        return self.cols.shape[1] == 2 * d + 2 * d * d + 3


def _pack_cols(p, pmask: torch.Tensor) -> torch.Tensor:
    n = p.capacity
    d = p["x"].shape[-1]
    cols = [p["x"], p["v"], p["F"].reshape(n, d * d),
            p["C"].reshape(n, d * d),
            torch.where(pmask, p["m"], 0.0)[:, None],
            torch.where(pmask, p["vol"], 0.0)[:, None]]
    if p.has_prop("Jp"):
        cols.append(p["Jp"][:, None])
    return torch.cat(cols, dim=1)


def _col_layout(dim: int) -> dict:
    """Column offsets of the packed layout."""
    dd = dim * dim
    return dict(x=(0, dim), v=(dim, 2 * dim), F=(2 * dim, 2 * dim + dd),
                C=(2 * dim + dd, 2 * dim + 2 * dd), m=2 * dim + 2 * dd,
                vol=2 * dim + 2 * dd + 1, Jp=2 * dim + 2 * dd + 2)


def _bin_keys(x: torch.Tensor, alive: torch.Tensor, grid: SparseGrid,
              order: int) -> torch.Tensor:
    """Block key of each lane's slack-shifted stencil base, or the
    sentinel for dead lanes."""
    base, _, _ = bspline_weights((x - grid.origin) / grid.dx, order)
    blk = torch.div(base - SLACK, 4, rounding_mode="floor")
    return torch.where(alive, pack_coords(blk), KEY_SENTINEL)


def _check_binnable(sim: MPMSim, grid: SparseGrid) -> None:
    if grid.dim not in (2, 3) or grid.block_size != 4:
        raise ValueError("binned2 needs 2-D or 3-D grids with 4^dim-cell "
                         "blocks")
    if sim.order != 2:
        raise ValueError("binned2 takes quadratic (order 2) B-splines")


def bin_state(sim: MPMSim, state: MPMState, cfg: BinnedConfig2) -> BinState:
    """Enter bin order: one stable sort with per-block K-padding dummies.
    Raises ValueError when ``bins_capacity * K`` lanes cannot hold the
    particle capacity."""
    p = state.particles
    grid = state.grid
    _check_binnable(sim, grid)
    N = p.capacity
    pmask = p.mask
    cols = _pack_cols(p, pmask)
    pid = torch.where(pmask, torch.arange(N, dtype=torch.int32,
                                          device=pmask.device), -1)
    keys = _bin_keys(p["x"], pmask, grid, sim.order)
    nb = cfg.block_capacity or grid.block_capacity
    st = _sort_into_bins(keys, cols, pid, cfg, nb, grid.dim)
    return dataclasses.replace(
        st, grid=dataclasses.replace(st.grid, transform=grid.transform),
        max_vel=state.max_vel)


def _groups(skey: torch.Tensor, nbq: int):
    """Runs of equal live keys in sorted ``skey``: (gkeys [nbq], gvalid
    [nbq], counts [nbq], n_groups 0-d); groups past ``nbq`` are dropped
    (``n_groups`` still counts them)."""
    dev = skey.device
    n = skey.shape[0]
    live = skey != KEY_SENTINEL
    neq = torch.ones_like(live)
    neq[1:] = skey[1:] != skey[:-1]
    neq &= live
    rank = inclusive_scan(_POL, neq.to(torch.int32)) - 1     # group id
    n_groups = torch.clamp_min(rank[-1] + 1, 0)
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    dst = torch.where(neq, rank, nbq).clamp(0, nbq).long()
    gstart = torch.zeros((nbq + 1,), dtype=torch.int32, device=dev)
    gstart[dst] = lane
    gstart = gstart[:nbq]
    nlive = live.sum(dtype=torch.int32)
    gid = torch.arange(nbq, dtype=torch.int32, device=dev)
    gvalid = gid < n_groups
    gend = torch.where(gid[1:] < n_groups, gstart[1:], nlive)
    gend = torch.cat([gend, nlive[None]])
    counts = torch.where(gvalid, gend - gstart, 0)
    gkeys = torch.full((nbq + 1,), KEY_SENTINEL, dtype=torch.int32,
                       device=dev)
    gkeys[dst] = skey
    gkeys = torch.where(gvalid, gkeys[:nbq], KEY_SENTINEL)
    return gkeys, gvalid, counts, n_groups


def _pads(counts: torch.Tensor, gvalid: torch.Tensor,
          cfg: BinnedConfig2) -> torch.Tensor:
    """Dummies per group: up to a multiple of K, plus ``reserve_bins``
    whole bins."""
    return torch.where(gvalid, (-counts) % K + cfg.reserve_bins * K, 0)


def _composite_key(keys: torch.Tensor, is_dummy: torch.Tensor):
    """(block key, is_dummy) as one int32: dummies sort after the reals of
    their block; the sentinel stays last."""
    sent = keys == KEY_SENTINEL
    return torch.where(sent, KEY_SENTINEL,
                       torch.where(sent, 0, keys) * 2 +
                       is_dummy.to(torch.int32))


def _finish_bins(sck: torch.Tensor, spid: torch.Tensor, scols: torch.Tensor,
                 gkeys: torch.Tensor, gvalid: torch.Tensor,
                 overflow: torch.Tensor, cfg: BinnedConfig2,
                 nb: int, dim: int) -> BinState:
    """Block table (dilated by +1 per axis) from the group keys, per-bin
    block slots from each bin's first lane, and the BinState."""
    dev = sck.device
    offs = to_device(neighbor_offsets(dim, 0, 1), dev, "bin_offsets")
    gcoords = unpack_key(gkeys, dim)
    cand = (gcoords[:, None, :] + offs[None]).reshape(-1, dim)
    vmask = gvalid.repeat_interleave(offs.shape[0])
    table, _ = build_block_table(cand, nb, valid=vmask, dim=dim)
    overflow = overflow | (table.count > table.capacity)
    # a block's run can span several bins: read each bin's slot off its
    # first lane (dummies carry their block's key too)
    first_ck = sck.reshape(cfg.bins_capacity, K)[:, 0]
    first_key = torch.where(first_ck == KEY_SENTINEL, KEY_SENTINEL,
                            first_ck >> 1)
    bin_block = torch.where(first_key == KEY_SENTINEL, -1,
                            table.query_keys(first_key))
    ncell = 4 ** dim
    data = {"m": torch.zeros((nb, ncell), dtype=torch.float32, device=dev),
            "v": torch.zeros((nb, ncell, dim), dtype=torch.float32,
                             device=dev)}
    grid = SparseGrid(table, data, None, 4, dim)  # transform set by caller
    return BinState(scols, spid, grid,
                    torch.zeros((), dtype=torch.float32, device=dev),
                    overflow, torch.zeros((), dtype=torch.bool, device=dev),
                    bin_block, _neighbor_slots(table))


def _sort_into_bins(keys: torch.Tensor, cols: torch.Tensor, pid: torch.Tensor,
                    cfg: BinnedConfig2, nb: int, dim: int = 3) -> BinState:
    """Sort N particle lanes into L = bins * K lanes, appending L - N
    padding dummies keyed to fill each block's last bin (and its reserve
    bins).  The returned grid holds only the table."""
    N = keys.shape[0]
    L = cfg.bins_capacity * K
    if L < N:
        raise ValueError(
            f"BinnedConfig2.bins_capacity={cfg.bins_capacity} gives only "
            f"{L} lanes (x{K}/bin) for {N} particle lanes; raise "
            f"bins_capacity to at least {-(-N // K)} (plus padding slack)")
    dev = keys.device
    npad = L - N
    nbq = cfg.bins_capacity

    skey = torch.sort(keys).values
    gkeys, gvalid, counts, n_groups = _groups(skey, nbq)
    pads = _pads(counts, gvalid, cfg)
    total = (counts + pads).sum()
    padcum = inclusive_scan(_POL, pads.to(torch.int32))
    # overflow also fires when the dummies needed exceed the npad budget:
    # truncated padding would silently mix two blocks in one bin
    overflow = (total > L) | (n_groups > nbq) | (padcum[-1] > npad)
    dense = _dummy_keys_by_rank(gkeys, gvalid, pads, padcum, npad)
    in_budget = torch.arange(npad, device=dev) < torch.clamp_max(padcum[-1],
                                                                 npad)
    dummy_keys = torch.where(in_budget, dense, KEY_SENTINEL)

    all_keys = torch.cat([keys, dummy_keys])
    is_dummy = torch.cat([torch.zeros((N,), dtype=torch.bool, device=dev),
                          torch.ones((npad,), dtype=torch.bool, device=dev)])
    ckey = _composite_key(all_keys, is_dummy)
    sck, perm = torch.sort(ckey, stable=True)
    spid = torch.cat([pid, torch.full((npad,), -1, dtype=torch.int32,
                                      device=dev)])[perm]
    scols = torch.cat([cols, cols.new_zeros((npad, cols.shape[1]))])[perm]
    return _finish_bins(sck, spid, scols, gkeys, gvalid, overflow, cfg, nb,
                        dim)


def _neighbor_slots(table) -> torch.Tensor:
    """[nb, 2^dim] slots of each block's window quadrants: own + the +1
    neighbours in ``neighbor_offsets(dim, 0, 1)`` order, -1 where
    absent."""
    dirs = to_device(neighbor_offsets(table.dim, 0, 1)[1:],
                     table.keys.device, "slot_dirs")
    coords = table.active_coords
    nbr_pos = table.query(coords[:, None, :] + dirs[None])  # [nb, 2^d - 1]
    own = torch.arange(table.capacity, dtype=torch.int32,
                       device=table.keys.device)[:, None]
    nbr = torch.cat([own, nbr_pos], dim=1)
    return torch.where(table.mask[:, None], nbr, -1)


def _dummy_keys_by_rank(gkeys, gvalid, pads, padcum, size: int):
    """Key of the j-th padding dummy, j in [0, size): the group whose
    cumulative pad range covers j.  A scatter-max at each group's
    pad-start, then a running max (group keys ascend).  Ranks past
    ``padcum[-1]`` are not masked here."""
    starts = padcum - pads
    pos = torch.where(gvalid & (pads > 0), starts, size).clamp_max(size)
    gmark = torch.zeros((size + 1,), dtype=torch.int32, device=gkeys.device)
    gmark.scatter_reduce_(0, pos.long(), torch.where(gvalid, gkeys, 0),
                          reduce="amax")
    return inclusive_scan(_POL, gmark[:size], "max")


@spanned("rebin.full")
def _rebin(sim: MPMSim, st: BinState, cfg: BinnedConfig2) -> BinState:
    """Re-sort a BinState into fresh bins (bin order in and out)."""
    grid = st.grid
    keys = _bin_keys(st.cols[:, 0:grid.dim], st.pid >= 0, grid, sim.order)
    nb = cfg.block_capacity or grid.block_capacity
    nst = _sort_into_bins_from_lanes(keys, st.cols, st.pid, cfg, nb,
                                     grid.dim)
    return dataclasses.replace(
        nst, grid=dataclasses.replace(nst.grid, transform=grid.transform),
        max_vel=st.max_vel, overflow=st.overflow | nst.overflow)


def _sort_into_bins_from_lanes(keys, cols, pid, cfg: BinnedConfig2,
                               nb: int, dim: int = 3) -> BinState:
    """Like :func:`_sort_into_bins` for input that already has L lanes:
    the dead lanes are re-keyed as the padding dummies."""
    L = keys.shape[0]
    nbq = cfg.bins_capacity
    if L != nbq * K:
        raise ValueError(f"{L} lanes do not match bins_capacity={nbq}")
    with span("rebin.sort"):
        skey = torch.sort(keys).values
    with span("rebin.groups"):
        gkeys, gvalid, counts, n_groups = _groups(skey, nbq)
        pads = _pads(counts, gvalid, cfg)
        overflow = ((counts + pads).sum() > L) | (n_groups > nbq)

        # the j-th dead lane (in lane order) pads the group whose
        # cumulative pad range covers j
        dead = keys == KEY_SENTINEL
        dead_rank = inclusive_scan(_POL, dead.to(torch.int32)) - 1
        padcum = inclusive_scan(_POL, pads.to(torch.int32))
        dense = _dummy_keys_by_rank(gkeys, gvalid, pads, padcum, L)
        in_budget = dead & (dead_rank < padcum[-1])
        keys2 = torch.where(in_budget,
                            dense[dead_rank.clamp(0, L - 1).long()], keys)
        ckey = _composite_key(keys2, dead)
    with span("rebin.sort"):
        sck, perm = torch.sort(ckey, stable=True)
    with span("rebin.finish"):
        return _finish_bins(sck, pid[perm], cols[perm], gkeys, gvalid,
                            overflow, cfg, nb, dim)


@spanned("rebin.migrate")
def _rebin_incremental(sim: MPMSim, st: BinState, cfg: BinnedConfig2,
                       m_cap: int) -> Tuple[BinState, torch.Tensor]:
    """Migrate up to ``m_cap`` particles into free (dead or dummy) lanes of
    their destination block's existing bins, leaving the bins, the table
    and the grid as they are.  Returns ``(state, ok)``; ``ok`` (a 0-d bool
    tensor) is False when the move needs new structure (a destination
    block missing from the dilated table, a block out of free lanes, or
    more than ``m_cap`` particles to move), and the caller must take the
    full :func:`_rebin` instead.

    A particle moves when its stencil base lies within one cell of its
    bin's window edge (offset outside [1, SIDE - 4]), re-keyed to its
    proper block: that restores at least a cell of slack for every
    particle, as a full rebin does.  Free lanes are taken in lane order,
    which is block order (a block's bins are consecutive and the blocks
    key-sorted), so each destination block's free lanes are one run of
    the free list.  Three scans: the free lanes' ranks, the blocks' first
    free lane, and the movers' rank within their destination."""
    grid = st.grid
    dim = grid.dim
    table = grid.table
    nb = table.capacity
    L = st.cols.shape[0]
    dev = st.cols.device
    lanes = torch.arange(L, dtype=torch.int32, device=dev)
    big = 2 ** 31 - 1
    m_cap = min(m_cap, L)

    x = st.cols[:, 0:dim]
    alive = st.pid >= 0
    base, _, _ = bspline_weights((x - grid.origin) / grid.dx, sim.order)
    keys = _bin_keys(x, alive, grid, sim.order)
    valid_bin = st.bin_block >= 0
    borigin = table.active_coords[
        torch.where(valid_bin, st.bin_block, 0).long()] * 4     # [bins, d]
    off = base - borigin.repeat_interleave(K, 0)
    moved = alive & ((off < 1) | (off > SIDE - 4)).any(-1)
    n_moved = moved.sum()

    # free lanes in lane order, and each block's count and first rank
    lane_slot = torch.where(valid_bin, st.bin_block,
                            nb).repeat_interleave(K)
    free = ~alive & (lane_slot < nb)
    free_rank = inclusive_scan(_POL, free.to(torch.int32)) - 1
    free_list = torch.zeros((L + 1,), dtype=torch.int32, device=dev)
    free_list[torch.where(free, free_rank, L).long()] = lanes
    free_cnt = torch.zeros((nb + 1,), dtype=torch.int32, device=dev)
    free_cnt.index_add_(0, torch.where(free, lane_slot, nb).long(),
                        torch.ones_like(lanes))
    free_cnt = free_cnt[:nb]
    free_start = inclusive_scan(_POL, free_cnt) - free_cnt

    # the movers sorted by destination key, and their rank in each run
    skey, slane = torch.sort(torch.where(moved, keys, big), stable=True)
    skey_c, slane_c = skey[:m_cap], slane[:m_cap]
    valid_c = skey_c != big
    dst_slot = table.query_keys(torch.where(valid_c, skey_c, KEY_SENTINEL))
    miss = (valid_c & (dst_slot < 0)).any()
    idx_c = torch.arange(m_cap, dtype=torch.int32, device=dev)
    neq = torch.ones_like(valid_c)
    neq[1:] = skey_c[1:] != skey_c[:-1]
    rank = idx_c - inclusive_scan(_POL, torch.where(neq, idx_c, 0), "max")
    slot_safe = dst_slot.clamp_min(0).long()
    short = (valid_c & (rank >= free_cnt[slot_safe])).any()
    ok = ~miss & ~short & (n_moved <= m_cap)

    # move: the destinations are free lanes and the sources live ones, so
    # the two sets are disjoint; row L takes the unused entries
    free_pos = (free_start[slot_safe] + rank).clamp(0, L - 1).long()
    dst = torch.where(valid_c, free_list[free_pos], L).long()
    src = torch.where(valid_c, slane_c, L).long()
    cols = torch.cat([st.cols, st.cols.new_zeros((1, st.cols.shape[1]))])
    pid = torch.cat([st.pid, st.pid.new_full((1,), -1)])
    rows, rpid = cols[src], pid[src]
    cols[dst] = rows
    cols[src] = 0.0
    pid[dst] = rpid
    pid[src] = -1
    nst = dataclasses.replace(
        st, cols=cols[:L], pid=pid[:L],
        needs_rebin=torch.zeros((), dtype=torch.bool, device=dev))
    return nst, ok


def rebin_adaptive(sim: MPMSim, st: BinState, cfg: BinnedConfig2) -> BinState:
    """The incremental migration when ``cfg.migrate_capacity`` > 0 and it
    succeeds, else the full sort-based rebin.  The JAX package chooses
    between the two with ``lax.cond``; here the choice is a host branch on
    ``ok``: one device read per rebin, none per step."""
    if cfg.migrate_capacity <= 0:
        return _rebin(sim, st, cfg)
    nst, ok = _rebin_incremental(sim, st, cfg, cfg.migrate_capacity)
    return nst if read_host(ok, "rebin_choice") else _rebin(sim, st, cfg)


def unbin_state(st: BinState, template: MPMState) -> MPMState:
    """Back to original particle order (one gather)."""
    p = template.particles
    N = p.capacity
    L = st.cols.shape[0]
    d = st.grid.dim
    lay = _col_layout(d)
    alive = st.pid >= 0
    dst = torch.where(alive, st.pid, N).long()
    inv = torch.zeros((N + 1,), dtype=torch.long, device=st.pid.device)
    inv[dst] = torch.arange(L, device=st.pid.device)
    mat = st.cols[inv[:N]]
    mk = p.mask[:, None]

    def col(name):
        lo, hi = lay[name]
        return mat[:, lo:hi]
    upd = dict(
        x=torch.where(mk, col("x"), p["x"]),
        v=torch.where(mk, col("v"), p["v"]),
        F=torch.where(mk[..., None], col("F").reshape(N, d, d), p["F"]),
        C=torch.where(mk[..., None], col("C").reshape(N, d, d), p["C"]))
    if st.has_jp and p.has_prop("Jp"):
        upd["Jp"] = torch.where(p.mask, mat[:, lay["Jp"]], p["Jp"])
    return MPMState(p.update(**upd), st.grid, st.max_vel)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

# per dimension: stencil node offsets and block cell offsets, last axis
# fastest (the in-block cell order)
_OFFS = {d: neighbor_offsets(d, 0, 2) for d in (2, 3)}
_CORNERS = {d: neighbor_offsets(d, 0, 3) for d in (2, 3)}


def _window_weight(t: torch.Tensor) -> torch.Tensor:
    """Quadratic B-spline at signed node distance ``t`` (cells), in the
    closed form the JAX window stencil uses: 0.5 c1^2 - 1.5 c2^2."""
    at = t.abs()
    c1 = torch.clamp_min(1.5 - at, 0.0)
    c2 = torch.clamp_min(0.5 - at, 0.0)
    return 0.5 * c1 * c1 - 1.5 * c2 * c2


@dataclasses.dataclass(frozen=True)
class _Ctx:
    """Per-step lane stencil over a :class:`BinState`, shared by the
    elastic and the fluid step: each lane's 3^dim stencil nodes at window
    positions ``base - borigin + (0..2)`` of its bin's frozen 8-node
    window, mapped through ``nbr8`` to flat grid indices (``nb * 4^dim``
    for nodes outside the window or in an absent block)."""

    grid: SparseGrid
    dx: torch.Tensor           # 0-d cell size (read once per step)
    dinv: torch.Tensor         # 0-d APIC D^-1 = 4 / dx^2
    alive: torch.Tensor        # [L] live lanes
    borigin_l: torch.Tensor    # [L, d] window origin of each lane's bin
    flat: torch.Tensor         # [L, 3^d] flat node index (long)
    w3: torch.Tensor           # [L, 3^d] weights, dead lanes zero
    xdiff: torch.Tensor        # [L, 3^d, d] x_node - x_particle
    overflow: torch.Tensor     # 0-d: st.overflow or a live bin unmapped

    @property
    def ncell(self) -> int:
        return self.grid.cells_per_block


@spanned("ctx")
def _make_ctx(st: BinState, cfg: BinnedConfig2) -> _Ctx:
    grid = st.grid
    table = grid.table
    dim = grid.dim
    nb = table.capacity
    ncell = 4 ** dim
    dev = st.cols.device
    B = cfg.bins_capacity
    L = B * K
    side = SIDE
    alive = st.pid >= 0
    dx = grid.dx

    # bin -> block mapping frozen at rebin time
    bin_live = alive.reshape(B, K).any(1)
    bin_block = torch.where(bin_live, st.bin_block, -1)
    bad_bin = bin_live & (bin_block < 0)
    overflow = st.overflow | bad_bin.any()
    bbs = bin_block.clamp(0, nb - 1).long()
    borigin = table.active_coords[bbs] * 4                      # [B, d]
    tgt8 = torch.where((bin_live & ~bad_bin)[:, None], st.nbr8[bbs], -1)
    lane_bin = torch.arange(L, device=dev) // K
    borigin_l = borigin[lane_bin]                               # [L, d]

    # nodes outside the 8-node window are dropped, as the JAX window
    # stencil drops them
    xib = (st.cols[:, 0:dim] - grid.origin) / dx
    base = torch.floor(xib - 0.5).to(torch.int32)
    offs = to_device(_OFFS[dim], dev, "ctx_offsets")            # [3^d, d]
    pos = (base - borigin_l)[:, None, :] + offs[None]           # [L, 3^d, d]
    inwin = ((pos >= 0) & (pos < side)).all(-1)
    node = borigin_l[:, None, :] + pos                          # cell index
    t = xib[:, None, :] - node.to(torch.float32)
    w3 = _window_weight(t).prod(-1) * (inwin & alive[:, None]).to(
        torch.float32)
    posc = pos.clamp(0, side - 1)
    # the window quadrant (own block or a +1 neighbour per axis) and the
    # node's cell within that block, both last axis fastest
    quad = posc[..., 0] >> 2
    cell = posc[..., 0] & 3
    for a in range(1, dim):
        quad = quad * 2 + (posc[..., a] >> 2)
        cell = cell * 4 + (posc[..., a] & 3)
    slot = tgt8[lane_bin[:, None], quad.long()]                 # [L, 3^d]
    flat = torch.where(inwin & (slot >= 0), slot * ncell + cell,
                       nb * ncell).long()
    return _Ctx(grid, dx, 4.0 / (dx * dx), alive, borigin_l, flat, w3,
                -t * dx, overflow)


@spanned("p2g")
def _ctx_p2g(ctx: _Ctx, m: torch.Tensor, v: torch.Tensor, A: torch.Tensor):
    """P2G: scatter (m, m v + A (x_i - x_p)) with the stencil weights into
    the ``[nb * 4^d + 1, 1 + d]`` accumulator (the last row takes what
    falls outside).  Returns (gm [nb, 4^d], gmv [nb, 4^d, d])."""
    nb, nc, d = ctx.grid.table.capacity, ctx.ncell, ctx.grid.dim
    Ax = torch.bmm(ctx.xdiff, A.transpose(1, 2))                # [L, 3^d, d]
    mom = ctx.w3[..., None] * (m[:, None, None] * v[:, None, :] + Ax)
    payload = torch.cat([(ctx.w3 * m[:, None])[..., None], mom], -1)
    acc = torch.zeros((nb * nc + 1, 1 + d), dtype=torch.float32,
                      device=m.device)
    acc.index_add_(0, ctx.flat.reshape(-1), payload.reshape(-1, 1 + d))
    return acc[:nb * nc, 0].reshape(nb, nc), \
        acc[:nb * nc, 1:].reshape(nb, nc, d)


@spanned("p2g")
def _ctx_p2g_affine(ctx: _Ctx, Q0: Optional[torch.Tensor],
                    A: torch.Tensor) -> torch.Tensor:
    """P2G of C channels, each a plain part plus an affine part: scatter
    ``Q0 + A (x_i - x_p)`` (``Q0 [L, C]``, zero when None; ``A [L, C,
    d]``) with the stencil weights.  Returns ``[nb, 4^d, C]``.  The
    implicit step's right-hand side (mass, momentum, force: 7 channels)
    and its operator (3) ride it.  The explicit steps keep
    :func:`_ctx_p2g`: on this one (mass as a channel with a zero affine
    row) they give the same bits with one more device activity a step
    (417 against 416 elastic, 261 against 260 fluid) and less device time
    (10.40 against 10.60-10.75 ms elastic, 8.84 against 9.16 ms fluid,
    262,144 particles; NVIDIA H100 80GB HBM3 at 700 W,
    ``tools/step_ab.py``)."""
    nb, nc = ctx.grid.table.capacity, ctx.ncell
    C = A.shape[1]
    Ax = torch.bmm(ctx.xdiff, A.transpose(1, 2))                # [L, 3^d, C]
    payload = ctx.w3[..., None] * (Ax if Q0 is None else Q0[:, None, :] + Ax)
    acc = torch.zeros((nb * nc + 1, C), dtype=torch.float32,
                      device=A.device)
    acc.index_add_(0, ctx.flat.reshape(-1), payload.reshape(-1, C))
    return acc[:nb * nc].reshape(nb, nc, C)


@spanned("p2g")
def _ctx_p2g_squared(ctx: _Ctx, Q0: torch.Tensor) -> torch.Tensor:
    """P2G of plain channels ``Q0 [L, C]`` with the squared stencil
    weights: ``node_i = sum_p w_ip^2 Q0_p``, ``[nb, 4^d, C]``.  The row
    norms a Jacobi preconditioner of the contact stiffness reads (the
    implicit step's ``contact_precond``)."""
    nb, nc = ctx.grid.table.capacity, ctx.ncell
    C = Q0.shape[1]
    payload = (ctx.w3 * ctx.w3)[..., None] * Q0[:, None, :]
    acc = torch.zeros((nb * nc + 1, C), dtype=torch.float32,
                      device=Q0.device)
    acc.index_add_(0, ctx.flat.reshape(-1), payload.reshape(-1, C))
    return acc[:nb * nc].reshape(nb, nc, C)


def _node_positions(ctx: _Ctx) -> torch.Tensor:
    """World position of every node of the table's blocks ``[nb, 4^d,
    d]``."""
    table = ctx.grid.table
    corners = to_device(_CORNERS[ctx.grid.dim], table.keys.device,
                        "node_corners")
    return (table.active_coords[:, None, :] * 4 +
            corners[None]).to(torch.float32) * ctx.dx + ctx.grid.origin


@spanned("grid_update")
def _grid_update(sim: MPMSim, ctx: _Ctx, gm: torch.Tensor,
                 gmv: torch.Tensor, dt):
    """Node velocities: momentum over mass, gravity, colliders at the node
    positions, massless nodes zeroed.  Returns (gv [nb, 4^d, d], max
    speed)."""
    has_mass = gm > 0.0
    gv = torch.where(has_mass[..., None],
                     gmv / gm.clamp_min(1e-30)[..., None], 0.0)
    gv = gv + dt * sim.gravity
    gv = resolve_boundaries(sim.colliders, _node_positions(ctx), gv)
    gv = torch.where(has_mass[..., None], gv, 0.0)
    return gv, torch.sqrt(torch.max(torch.sum(gv * gv, -1)))


@spanned("g2p")
def _ctx_g2p(ctx: _Ctx, gv: torch.Tensor):
    """G2P: (v_new [L, d], C_new [L, d, d]) gathered from the node
    velocities ``gv [nb, 4^d, d]``."""
    nb, nc, d = ctx.grid.table.capacity, ctx.ncell, ctx.grid.dim
    gvf = torch.cat([gv.reshape(nb * nc, d), gv.new_zeros((1, d))])
    wv = ctx.w3[..., None] * gvf[ctx.flat]                      # [L, 3^d, d]
    C_new = ctx.dinv * torch.bmm(wv.transpose(1, 2), ctx.xdiff)
    return wv.sum(1), C_new


def _recenter(ctx: _Ctx, x_new: torch.Tensor):
    """Follow the bulk integer drift with the grid origin (so the next
    step's bases stay centred in their windows; the grid is rebuilt every
    step, so moving its origin between steps is free) and flag a lane
    whose new base left its window.  Returns (grid, escaped)."""
    grid = ctx.grid
    dim = grid.dim
    dx = ctx.dx
    side = SIDE
    alive = ctx.alive
    base_new = torch.floor((x_new - grid.origin) / dx - 0.5).to(torch.int32)
    off_new = base_new - ctx.borigin_l
    asum = alive.sum().clamp_min(1)
    mean_off = torch.where(alive[:, None], off_new, 0).sum(0).to(
        torch.float32) / asum
    shift = torch.clamp(torch.round(mean_off - 0.5 * (side - 3)),
                        -1.0, 1.0).to(torch.int32)
    off_new = off_new - shift
    tm = grid.transform.matrix.clone()
    tm[:dim, 3] += shift.to(torch.float32) * dx
    grid = dataclasses.replace(
        grid, transform=dataclasses.replace(grid.transform, matrix=tm))
    escaped = (alive[:, None] & ((off_new < 0) | (off_new > side - 3))).any()
    return grid, escaped


def _lanes(st: BinState, ctx: _Ctx):
    """The elastic layout's lane columns: (x, v, F, C, m, vol), m and vol
    zero on dead lanes."""
    L = st.cols.shape[0]
    d = st.grid.dim
    lay = _col_layout(d)
    cols = st.cols

    def col(name):
        lo, hi = lay[name]
        return cols[:, lo:hi]
    return (col("x"), col("v"), col("F").reshape(L, d, d),
            col("C").reshape(L, d, d),
            torch.where(ctx.alive, cols[:, lay["m"]], 0.0),
            torch.where(ctx.alive, cols[:, lay["vol"]], 0.0))


@spanned("advance")
def _advance(sim: MPMSim, st: BinState, ctx: _Ctx, lanes, gm: torch.Tensor,
             gv: torch.Tensor, max_vel: torch.Tensor, dt,
             disp_scale: Optional[Callable[[torch.Tensor], torch.Tensor]]
             = None) -> BinState:
    """G2P from the node velocities ``gv``, F update (projected by
    ``sim.plasticity`` with a Jp column), advection and recentering: the
    end of a step, shared by the explicit and the implicit step.
    ``disp_scale`` maps the displacements ``dt v_new [L, d]`` to a factor
    ``[L]`` that scales them before the escape test (the implicit step's
    CCD clamp); None advects by the whole displacement."""
    xb, vb, Fb, Cb, m, vol = lanes
    L = st.cols.shape[0]
    d = st.grid.dim
    alive = ctx.alive
    v_new, C_new = _ctx_g2p(ctx, gv)
    eye = torch.eye(d, dtype=torch.float32, device=st.cols.device)
    F_new = mm(eye + dt * C_new, Fb)
    if st.has_jp:
        Jpb = st.cols[:, _col_layout(d)["Jp"]]
        Jp_new = Jpb
        if sim.plasticity is not None:
            F_new, Jp_new = sim.plasticity.project(F_new, Jpb)
    if disp_scale is None:
        x_new = xb + dt * v_new
    else:
        disp = dt * v_new
        x_new = xb + disp_scale(disp)[:, None] * disp
    grid, escaped = _recenter(ctx, x_new)

    ok = alive[:, None]
    newcols = [torch.where(ok, x_new, xb), torch.where(ok, v_new, vb),
               torch.where(ok[..., None], F_new, Fb).reshape(L, d * d),
               torch.where(ok[..., None], C_new, Cb).reshape(L, d * d),
               m[:, None], vol[:, None]]
    if st.has_jp:
        newcols.append(torch.where(alive, Jp_new, Jpb)[:, None])
    grid = dataclasses.replace(grid, data={"m": gm, "v": gv})
    return dataclasses.replace(st, cols=torch.cat(newcols, dim=1), grid=grid,
                               max_vel=max_vel, overflow=ctx.overflow,
                               needs_rebin=escaped)


# the per-model rank of a model field; a field of higher rank holds one
# value per particle (a Scene's Lame fields, [capacity])
_MODEL_RANK = {"fiber": 1}


def _lane_model(model, pid: torch.Tensor):
    """``model`` with its per-particle fields (in particle order) gathered
    into the lanes' order by ``pid``; dead lanes take particle 0's (their
    mass and volume are 0).  A model of scalar fields comes back as it
    is.  The JAX binned steps read per-particle fields in particle order
    against bin-ordered F, which fails to broadcast: a Scene's state does
    not run there."""
    idx, upd = None, {}
    for f in dataclasses.fields(model):
        v = getattr(model, f.name)
        if isinstance(v, torch.Tensor) and \
                v.dim() > _MODEL_RANK.get(f.name, 0):
            if idx is None:
                idx = pid.clamp_min(0).long()
            upd[f.name] = v[idx]
    return dataclasses.replace(model, **upd) if upd else model


def explicit_step_binned2(sim: MPMSim, st: BinState, dt, cfg: BinnedConfig2,
                          *, rebin: bool = True) -> BinState:
    """One explicit APIC step on a :class:`BinState` (bin order in and
    out, 2-D or 3-D); ``rebin=True`` re-sorts first.  With a Jp column and
    ``sim.plasticity`` the new F is projected and Jp updated, as in the
    JAX package (whose binned step, like this one, has no FLIP blend)."""
    if rebin:
        st = _rebin(sim, st, cfg)
    ctx = _make_ctx(st, cfg)
    with span("stress"):
        lanes = _lanes(st, ctx)
        _, vb, Fb, Cb, m, vol = lanes
        tau = _lane_model(sim.model, st.pid).kirchhoff(Fb)
        A = m[:, None, None] * Cb - \
            (dt * ctx.dinv * vol)[:, None, None] * tau
    gm, gmv = _ctx_p2g(ctx, m, vb, A)
    gv, max_vel = _grid_update(sim, ctx, gm, gmv, dt)
    return _advance(sim, st, ctx, lanes, gm, gv, max_vel, dt)


def adaptive_chain(step_fn: Callable[[BinState], BinState],
                   rebin_fn: Callable[[BinState], BinState], st: BinState,
                   n_steps: int) -> BinState:
    """Run ``n_steps`` of ``step_fn``, rebinning with ``rebin_fn`` after
    every step that set ``needs_rebin`` (and before the first step if it is
    already set): the JAX two-level while loop as a host loop.  Reading the
    flag costs one device-to-host synchronisation per step."""
    i = 0
    while i < n_steps:
        while i < n_steps and not read_host(st.needs_rebin, "chain_flag"):
            st = step_fn(st)
            i += 1
        if read_host(st.needs_rebin, "chain_flag"):
            st = rebin_fn(st)
    return st


def rollout_binned2(sim: MPMSim, state: MPMState, dt, cfg: BinnedConfig2,
                    n_steps: int) -> Tuple[MPMState, torch.Tensor]:
    """``n_steps`` in bin order, original order restored at the end.
    Returns ``(state, overflow)``."""
    st = bin_state(sim, state, cfg)
    st = adaptive_chain(
        lambda s: explicit_step_binned2(sim, s, dt, cfg, rebin=False),
        lambda s: rebin_adaptive(sim, s, cfg), st, n_steps)
    return unbin_state(st, state), st.overflow
