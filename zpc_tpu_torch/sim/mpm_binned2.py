"""Binned explicit MPM, 3-D (counterpart of ``zpc_tpu/sim/mpm_binned2.py``).

Particles live in **bin order**: ``L = bins_capacity * K`` lanes, grouped
into bins of ``K = 128`` lanes that each belong to one 4^3-cell grid block.
Every block's run of particles is padded with dummy lanes (m = 0, pid = -1)
to a multiple of K, so the sorted lanes reshape into bins.  The state stays
in bin order across steps; original order comes back once, in
:func:`unbin_state`.

Bins are keyed on ``floor((base - 1) / 4)`` (drift slack 1): a fresh bin's
stencil bases sit at window offsets [1, 4] of an 8-node window that spans
its block and the next one on each axis, so a particle can drift a cell
either way before it leaves the window.  The step flags ``needs_rebin``
when one has; :func:`adaptive_chain` then re-sorts (:func:`rebin_adaptive`)
before the next step.  The grid origin follows the bulk integer drift
(recentering), so pure translation never forces a rebin.

The rebin's prefix sums go through
:func:`zpc_tpu_torch.parallel.primitives.inclusive_scan`, which launches the
CUDA scan kernel for a CUDA tensor.

The transfers are plain PyTorch, in helpers that the elastic step and the
fluid step (``sim/fluid_binned2.py``) share: :func:`_make_ctx` places each
lane's 27 stencil nodes in its bin's window (the window octant maps
through the frozen ``nbr8`` table to a block slot, and the node's cell
within that block gives the flat index); :func:`_ctx_p2g` is one
``index_add_`` of (m, m v + A dx) into an ``[nb * 64 + 1, 4]``
accumulator whose last row takes whatever falls outside;
:func:`_grid_update`, :func:`_ctx_g2p` and :func:`_recenter` follow, and
:func:`_advance` ends the elastic step from the node velocities.  A state
with ``Jp`` carries it as a 27th column, projected with the new F by
``sim.plasticity``.  The implicit step (``sim/implicit_binned2.py``) adds
:func:`_ctx_p2g_affine`, a P2G of any number of plain-plus-affine
channels, and reads :func:`_ctx_g2p` of any node field as its operator's
gather; its mesh contact adds :func:`_ctx_p2g_squared` (squared weights)
and :func:`_advance`'s displacement scale (the CCD clamp).

Not ported (TPU workarounds, see ROADMAP.md): ``chunk_bins`` (the chunked
transfer is physics-identical to the unchunked one), ``sort_chunk``,
``use_segments`` and the one-hot spill selection, the spill tables for
slack 0, ``reserve_bins``, ``recenter=False`` and the incremental rebin
(``migrate_capacity``).
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
from ..math.vecmat import mm33
from ..parallel.primitives import inclusive_scan
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
    """Drift slack 1 (:data:`SLACK`), no reserve bins and recentering are
    fixed in the port; :func:`zpc_tpu_torch.interop.config_from_jax`
    rejects a JAX config that sets them otherwise."""

    bins_capacity: int                    # static bin count (L = bins * K)
    block_capacity: Optional[int] = None  # dilated table capacity (None:
                                          # the grid's)


@dataclasses.dataclass(frozen=True)
class BinState:
    """Particle state in bin order.

    ``cols``: [L, W] packed channels: x3 v3 F9 C9 m1 vol1 (W = 26), plus
    Jp1 (W = 27) for a plastic state, or the fluid layout x3 v3 J1 C9 m1
    vol1 (W = 18, ``sim/fluid_binned2.py``); dummy and dead lanes carry
    m = 0.  ``pid``: [L] original particle index, -1 on dummy
    lanes.  ``bin_block``: [bins] table slot per bin frozen at rebin time
    (-1: dead bin).  ``nbr8``: [nb, 8] table slots of each block and its
    +1 neighbours (the window's octants), -1 where absent, frozen with the
    table.  ``overflow``, ``needs_rebin``: 0-d bool tensors.
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
        """The elastic layout with the 27th (Jp) column."""
        return self.cols.shape[1] == 27


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


def bin_state(sim: MPMSim, state: MPMState, cfg: BinnedConfig2) -> BinState:
    """Enter bin order: one stable sort with per-block K-padding dummies.
    Raises ValueError when ``bins_capacity * K`` lanes cannot hold the
    particle capacity."""
    p = state.particles
    grid = state.grid
    if grid.dim != 3 or grid.block_size != 4:
        raise ValueError("binned2 needs 3-D grids with 4^3-cell blocks")
    N = p.capacity
    pmask = p.mask
    cols = _pack_cols(p, pmask)
    pid = torch.where(pmask, torch.arange(N, dtype=torch.int32,
                                          device=pmask.device), -1)
    keys = _bin_keys(p["x"], pmask, grid, sim.order)
    nb = cfg.block_capacity or grid.block_capacity
    st = _sort_into_bins(keys, cols, pid, cfg, nb)
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
                 nb: int) -> BinState:
    """Block table (dilated by +1 per axis) from the group keys, per-bin
    block slots from each bin's first lane, and the BinState."""
    dev = sck.device
    offs = torch.as_tensor(neighbor_offsets(3, 0, 1), device=dev)
    gcoords = unpack_key(gkeys, 3)
    cand = (gcoords[:, None, :] + offs[None]).reshape(-1, 3)
    vmask = gvalid.repeat_interleave(offs.shape[0])
    table, _ = build_block_table(cand, nb, valid=vmask, dim=3)
    overflow = overflow | (table.count > table.capacity)
    # a block's run can span several bins: read each bin's slot off its
    # first lane (dummies carry their block's key too)
    first_ck = sck.reshape(cfg.bins_capacity, K)[:, 0]
    first_key = torch.where(first_ck == KEY_SENTINEL, KEY_SENTINEL,
                            first_ck >> 1)
    bin_block = torch.where(first_key == KEY_SENTINEL, -1,
                            table.query_keys(first_key))
    data = {"m": torch.zeros((nb, 64), dtype=torch.float32, device=dev),
            "v": torch.zeros((nb, 64, 3), dtype=torch.float32, device=dev)}
    grid = SparseGrid(table, data, None, 4, 3)  # transform set by caller
    return BinState(scols, spid, grid,
                    torch.zeros((), dtype=torch.float32, device=dev),
                    overflow, torch.zeros((), dtype=torch.bool, device=dev),
                    bin_block, _neighbor_slots(table))


def _sort_into_bins(keys: torch.Tensor, cols: torch.Tensor, pid: torch.Tensor,
                    cfg: BinnedConfig2, nb: int) -> BinState:
    """Sort N particle lanes into L = bins * K lanes, appending L - N
    padding dummies keyed to fill each block's last bin.  The returned
    grid holds only the table."""
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
    pads = torch.where(gvalid, (-counts) % K, 0)
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
    return _finish_bins(sck, spid, scols, gkeys, gvalid, overflow, cfg, nb)


def _neighbor_slots(table) -> torch.Tensor:
    """[nb, 8] slots of each block's window octants: own + the seven +1
    neighbours in ``neighbor_offsets(3, 0, 1)`` order, -1 where absent."""
    dirs = torch.as_tensor(neighbor_offsets(3, 0, 1)[1:],
                           device=table.keys.device)
    coords = table.active_coords
    nbr_pos = table.query(coords[:, None, :] + dirs[None])      # [nb, 7]
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


def _rebin(sim: MPMSim, st: BinState, cfg: BinnedConfig2) -> BinState:
    """Re-sort a BinState into fresh bins (bin order in and out)."""
    grid = st.grid
    keys = _bin_keys(st.cols[:, 0:3], st.pid >= 0, grid, sim.order)
    nb = cfg.block_capacity or grid.block_capacity
    nst = _sort_into_bins_from_lanes(keys, st.cols, st.pid, cfg, nb)
    return dataclasses.replace(
        nst, grid=dataclasses.replace(nst.grid, transform=grid.transform),
        max_vel=st.max_vel, overflow=st.overflow | nst.overflow)


def _sort_into_bins_from_lanes(keys, cols, pid, cfg: BinnedConfig2,
                               nb: int) -> BinState:
    """Like :func:`_sort_into_bins` for input that already has L lanes:
    the dead lanes are re-keyed as the padding dummies."""
    L = keys.shape[0]
    nbq = cfg.bins_capacity
    if L != nbq * K:
        raise ValueError(f"{L} lanes do not match bins_capacity={nbq}")
    skey = torch.sort(keys).values
    gkeys, gvalid, counts, n_groups = _groups(skey, nbq)
    pads = torch.where(gvalid, (-counts) % K, 0)
    overflow = ((counts + pads).sum() > L) | (n_groups > nbq)

    # the j-th dead lane (in lane order) pads the group whose cumulative
    # pad range covers j
    dead = keys == KEY_SENTINEL
    dead_rank = inclusive_scan(_POL, dead.to(torch.int32)) - 1
    padcum = inclusive_scan(_POL, pads.to(torch.int32))
    dense = _dummy_keys_by_rank(gkeys, gvalid, pads, padcum, L)
    in_budget = dead & (dead_rank < padcum[-1])
    keys2 = torch.where(in_budget, dense[dead_rank.clamp(0, L - 1).long()],
                        keys)
    ckey = _composite_key(keys2, dead)
    sck, perm = torch.sort(ckey, stable=True)
    return _finish_bins(sck, pid[perm], cols[perm], gkeys, gvalid, overflow,
                        cfg, nb)


def rebin_adaptive(sim: MPMSim, st: BinState, cfg: BinnedConfig2) -> BinState:
    """The full sort-based rebin (the incremental migration of the JAX
    package is not ported)."""
    return _rebin(sim, st, cfg)


def unbin_state(st: BinState, template: MPMState) -> MPMState:
    """Back to original particle order (one gather)."""
    p = template.particles
    N = p.capacity
    L = st.cols.shape[0]
    lay = _col_layout(3)
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
        F=torch.where(mk[..., None], col("F").reshape(N, 3, 3), p["F"]),
        C=torch.where(mk[..., None], col("C").reshape(N, 3, 3), p["C"]))
    if st.has_jp and p.has_prop("Jp"):
        upd["Jp"] = torch.where(p.mask, mat[:, lay["Jp"]], p["Jp"])
    return MPMState(p.update(**upd), st.grid, st.max_vel)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

_OFFS27 = neighbor_offsets(3, 0, 2)          # stencil nodes, last axis fastest
_CORNERS64 = neighbor_offsets(3, 0, 3)       # block cells, in-block order


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
    elastic and the fluid step: each lane's 27 stencil nodes at window
    positions ``base - borigin + (0..2)`` of its bin's frozen 8-node
    window, mapped through ``nbr8`` to flat grid indices (``nb * 64`` for
    nodes outside the window or in an absent block)."""

    grid: SparseGrid
    dx: torch.Tensor           # 0-d cell size (read once per step)
    dinv: torch.Tensor         # 0-d APIC D^-1 = 4 / dx^2
    alive: torch.Tensor        # [L] live lanes
    borigin_l: torch.Tensor    # [L, 3] window origin of each lane's bin
    flat: torch.Tensor         # [L, 27] flat node index (long)
    w3: torch.Tensor           # [L, 27] weights, dead lanes zero
    xdiff: torch.Tensor        # [L, 27, 3] x_node - x_particle
    overflow: torch.Tensor     # 0-d: st.overflow or a live bin unmapped


def _make_ctx(st: BinState, cfg: BinnedConfig2) -> _Ctx:
    grid = st.grid
    table = grid.table
    nb = table.capacity
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
    borigin = table.active_coords[bbs] * 4                      # [B, 3]
    tgt8 = torch.where((bin_live & ~bad_bin)[:, None], st.nbr8[bbs], -1)
    lane_bin = torch.arange(L, device=dev) // K
    borigin_l = borigin[lane_bin]                               # [L, 3]

    # nodes outside the 8-node window are dropped, as the JAX window
    # stencil drops them
    xib = (st.cols[:, 0:3] - grid.origin) / dx
    base = torch.floor(xib - 0.5).to(torch.int32)
    offs = torch.as_tensor(_OFFS27, device=dev)                 # [27, 3]
    pos = (base - borigin_l)[:, None, :] + offs[None]           # [L, 27, 3]
    inwin = ((pos >= 0) & (pos < side)).all(-1)
    node = borigin_l[:, None, :] + pos                          # cell index
    t = xib[:, None, :] - node.to(torch.float32)
    w3 = _window_weight(t).prod(-1) * (inwin & alive[:, None]).to(
        torch.float32)
    posc = pos.clamp(0, side - 1)
    octant = ((posc[..., 0] >> 2) * 4 + (posc[..., 1] >> 2) * 2 +
              (posc[..., 2] >> 2)).long()
    cell = ((posc[..., 0] & 3) * 16 + (posc[..., 1] & 3) * 4 +
            (posc[..., 2] & 3))
    slot = tgt8[lane_bin[:, None], octant]                      # [L, 27]
    flat = torch.where(inwin & (slot >= 0), slot * 64 + cell, nb * 64).long()
    return _Ctx(grid, dx, 4.0 / (dx * dx), alive, borigin_l, flat, w3,
                -t * dx, overflow)


def _ctx_p2g(ctx: _Ctx, m: torch.Tensor, v: torch.Tensor, A: torch.Tensor):
    """P2G: scatter (m, m v + A (x_i - x_p)) with the stencil weights into
    the ``[nb * 64 + 1, 4]`` accumulator (the last row takes what falls
    outside).  Returns (gm [nb, 64], gmv [nb, 64, 3])."""
    nb = ctx.grid.table.capacity
    Ax = torch.bmm(ctx.xdiff, A.transpose(1, 2))                # [L, 27, 3]
    mom = ctx.w3[..., None] * (m[:, None, None] * v[:, None, :] + Ax)
    payload = torch.cat([(ctx.w3 * m[:, None])[..., None], mom], -1)
    acc = torch.zeros((nb * 64 + 1, 4), dtype=torch.float32,
                      device=m.device)
    acc.index_add_(0, ctx.flat.reshape(-1), payload.reshape(-1, 4))
    return acc[:nb * 64, 0].reshape(nb, 64), \
        acc[:nb * 64, 1:].reshape(nb, 64, 3)


def _ctx_p2g_affine(ctx: _Ctx, Q0: Optional[torch.Tensor],
                    A: torch.Tensor) -> torch.Tensor:
    """P2G of C channels, each a plain part plus an affine part: scatter
    ``Q0 + A (x_i - x_p)`` (``Q0 [L, C]``, zero when None; ``A [L, C, 3]``)
    with the stencil weights.  Returns ``[nb, 64, C]``.  The implicit step's
    right-hand side (mass, momentum, force: 7 channels) and its operator
    (3) ride it.  The explicit steps keep :func:`_ctx_p2g`: on this one
    (mass as a channel with a zero affine row) they give the same bits
    with one more device activity a step (417 against 416 elastic, 261
    against 260 fluid) and less device time (10.40 against 10.60-10.75 ms
    elastic, 8.84 against 9.16 ms fluid, 262,144 particles; NVIDIA H100
    80GB HBM3 at 700 W, ``tools/step_ab.py``)."""
    nb = ctx.grid.table.capacity
    C = A.shape[1]
    Ax = torch.bmm(ctx.xdiff, A.transpose(1, 2))                # [L, 27, C]
    payload = ctx.w3[..., None] * (Ax if Q0 is None else Q0[:, None, :] + Ax)
    acc = torch.zeros((nb * 64 + 1, C), dtype=torch.float32,
                      device=A.device)
    acc.index_add_(0, ctx.flat.reshape(-1), payload.reshape(-1, C))
    return acc[:nb * 64].reshape(nb, 64, C)


def _ctx_p2g_squared(ctx: _Ctx, Q0: torch.Tensor) -> torch.Tensor:
    """P2G of plain channels ``Q0 [L, C]`` with the squared stencil
    weights: ``node_i = sum_p w_ip^2 Q0_p``, ``[nb, 64, C]``.  The row norms
    a Jacobi preconditioner of the contact stiffness reads (the implicit
    step's ``contact_precond``)."""
    nb = ctx.grid.table.capacity
    C = Q0.shape[1]
    payload = (ctx.w3 * ctx.w3)[..., None] * Q0[:, None, :]
    acc = torch.zeros((nb * 64 + 1, C), dtype=torch.float32,
                      device=Q0.device)
    acc.index_add_(0, ctx.flat.reshape(-1), payload.reshape(-1, C))
    return acc[:nb * 64].reshape(nb, 64, C)


def _node_positions(ctx: _Ctx) -> torch.Tensor:
    """World position of every node of the table's blocks ``[nb, 64, 3]``."""
    table = ctx.grid.table
    corners = torch.as_tensor(_CORNERS64, device=table.keys.device)
    return (table.active_coords[:, None, :] * 4 +
            corners[None]).to(torch.float32) * ctx.dx + ctx.grid.origin


def _grid_update(sim: MPMSim, ctx: _Ctx, gm: torch.Tensor,
                 gmv: torch.Tensor, dt):
    """Node velocities: momentum over mass, gravity, colliders at the node
    positions, massless nodes zeroed.  Returns (gv [nb, 64, 3], max
    speed)."""
    has_mass = gm > 0.0
    gv = torch.where(has_mass[..., None],
                     gmv / gm.clamp_min(1e-30)[..., None], 0.0)
    gv = gv + dt * sim.gravity
    gv = resolve_boundaries(sim.colliders, _node_positions(ctx), gv)
    gv = torch.where(has_mass[..., None], gv, 0.0)
    return gv, torch.sqrt(torch.max(torch.sum(gv * gv, -1)))


def _ctx_g2p(ctx: _Ctx, gv: torch.Tensor):
    """G2P: (v_new [L, 3], C_new [L, 3, 3]) gathered from the node
    velocities ``gv [nb, 64, 3]``."""
    nb = ctx.grid.table.capacity
    gvf = torch.cat([gv.reshape(nb * 64, 3), gv.new_zeros((1, 3))])
    wv = ctx.w3[..., None] * gvf[ctx.flat]                      # [L, 27, 3]
    C_new = ctx.dinv * torch.bmm(wv.transpose(1, 2), ctx.xdiff)
    return wv.sum(1), C_new


def _recenter(ctx: _Ctx, x_new: torch.Tensor):
    """Follow the bulk integer drift with the grid origin (so the next
    step's bases stay centred in their windows; the grid is rebuilt every
    step, so moving its origin between steps is free) and flag a lane
    whose new base left its window.  Returns (grid, escaped)."""
    grid = ctx.grid
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
    tm[:3, 3] += shift.to(torch.float32) * dx
    grid = dataclasses.replace(
        grid, transform=dataclasses.replace(grid.transform, matrix=tm))
    escaped = (alive[:, None] & ((off_new < 0) | (off_new > side - 3))).any()
    return grid, escaped


def _lanes(st: BinState, ctx: _Ctx):
    """The elastic layout's lane columns: (x, v, F, C, m, vol), m and vol
    zero on dead lanes."""
    L = st.cols.shape[0]
    lay = _col_layout(3)
    cols = st.cols
    return (cols[:, 0:3], cols[:, 3:6], cols[:, 6:15].reshape(L, 3, 3),
            cols[:, 15:24].reshape(L, 3, 3),
            torch.where(ctx.alive, cols[:, lay["m"]], 0.0),
            torch.where(ctx.alive, cols[:, lay["vol"]], 0.0))


def _advance(sim: MPMSim, st: BinState, ctx: _Ctx, lanes, gm: torch.Tensor,
             gv: torch.Tensor, max_vel: torch.Tensor, dt,
             disp_scale: Optional[Callable[[torch.Tensor], torch.Tensor]]
             = None) -> BinState:
    """G2P from the node velocities ``gv``, F update (projected by
    ``sim.plasticity`` with a Jp column), advection and recentering: the
    end of a step, shared by the explicit and the implicit step.
    ``disp_scale`` maps the displacements ``dt v_new [L, 3]`` to a factor
    ``[L]`` that scales them before the escape test (the implicit step's
    CCD clamp); None advects by the whole displacement."""
    xb, vb, Fb, Cb, m, vol = lanes
    L = st.cols.shape[0]
    alive = ctx.alive
    v_new, C_new = _ctx_g2p(ctx, gv)
    eye = torch.eye(3, dtype=torch.float32, device=st.cols.device)
    F_new = mm33(eye + dt * C_new, Fb)
    if st.has_jp:
        Jpb = st.cols[:, _col_layout(3)["Jp"]]
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
               torch.where(ok[..., None], F_new, Fb).reshape(L, 9),
               torch.where(ok[..., None], C_new, Cb).reshape(L, 9),
               m[:, None], vol[:, None]]
    if st.has_jp:
        newcols.append(torch.where(alive, Jp_new, Jpb)[:, None])
    grid = dataclasses.replace(grid, data={"m": gm, "v": gv})
    return dataclasses.replace(st, cols=torch.cat(newcols, dim=1), grid=grid,
                               max_vel=max_vel, overflow=ctx.overflow,
                               needs_rebin=escaped)


def explicit_step_binned2(sim: MPMSim, st: BinState, dt, cfg: BinnedConfig2,
                          *, rebin: bool = True) -> BinState:
    """One explicit APIC step on a :class:`BinState` (bin order in and
    out); ``rebin=True`` re-sorts first.  With a Jp column and
    ``sim.plasticity`` the new F is projected and Jp updated, as in the
    JAX package (whose binned step, like this one, has no FLIP blend)."""
    if rebin:
        st = _rebin(sim, st, cfg)
    ctx = _make_ctx(st, cfg)
    lanes = _lanes(st, ctx)
    _, vb, Fb, Cb, m, vol = lanes
    tau = sim.model.kirchhoff(Fb)
    A = m[:, None, None] * Cb - (dt * ctx.dinv * vol)[:, None, None] * tau
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
        while i < n_steps and not bool(st.needs_rebin):
            st = step_fn(st)
            i += 1
        if bool(st.needs_rebin):
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
