"""Domain-decomposed multi-device MPM (counterpart of
``zpc_tpu/sim/domain_decomp.py``) on ``torch.distributed``: each rank owns
a contiguous range of the blocks' morton keys and holds only the grid rows
it touches, halo sums travel around a ring of point-to-point transfers,
and particles migrate to the rank that owns their block.

Per step, every rank together:

1. **key census**: an ``all_gather`` of the ranks' touched block keys
   (fixed capacity); the local table is the blocks this rank touches and
   the blocks it owns that others touch;
2. **local P2G** into that table;
3. **forward halo ring**: partial sums of rows this rank does not own go to
   rank ``r + 1`` and come from ``r - 1``, ``D - 1`` hops (one
   ``batch_isend_irecv`` pair a hop); owners absorb their rows;
4. **grid update** on the owned rows, the max speed by ``all_reduce(MAX)``;
5. **return ring**: owners send their updated velocities around; the
   other ranks fill their apron rows;
6. **G2P** and advection;
7. **migration ring**: particles whose block left this rank's range are
   packed into a fixed-capacity bundle and routed to their owner, which
   puts them into free slots.

Every buffer keeps the JAX module's fixed capacity (``all_gather`` and the
point-to-point transfers need equal shapes on every rank); one OR'd
overflow flag (``all_reduce(MAX)``) reports a table, bundle or slot
capacity exceeded, or a block outside the morton range, for the caller to
rerun the step with larger capacities.  At one rank the rings have no hop.

Block ownership is by 3-D morton key, so the step is 3-D only, as the JAX
module's (a 2-D decomposition would be an extension it lacks).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..containers.block_table import (KEY_SENTINEL, build_block_table,
                                      unpack_key)
from ..geometry.sparse_grid import neighbor_offsets
from ..math.bits import morton3d
from ..math.interpolation import bspline_weights
from ..parallel.mesh import global_array, mesh_device, mesh_rank
from .mpm import (MPMSim, MPMState, _accumulate, _g2p, _grid_velocity,
                  _p2g_payload, _weights)

__all__ = ["DDState", "make_dd_state", "explicit_step_dd",
           "gather_dd_particles", "morton_splits"]

_MORTON_OFF = 512          # block coords in [-512, 512) -> [0, 1024)


def _block_morton(coords: torch.Tensor) -> torch.Tensor:
    return morton3d(coords + _MORTON_OFF)


def _owner(mkey: torch.Tensor, splits: torch.Tensor) -> torch.Tensor:
    """The rank owning each morton key: ``splits [D+1]``, ranges
    half-open."""
    return torch.searchsorted(splits[1:-1].contiguous(), mkey.contiguous(),
                              right=True).clamp(
        0, splits.shape[0] - 2).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class DDState:
    """This rank's particles: channels ``[capP, ...]``, the alive mask, the
    original particle id, the morton splits ``[D+1]`` (the same on every
    rank) and the grid's max speed."""

    channels: Dict[str, torch.Tensor]
    alive: torch.Tensor            # [capP] bool
    pid: torch.Tensor              # [capP] int32
    splits: torch.Tensor           # [D+1] int32
    max_vel: torch.Tensor


def _host_blocks(x: np.ndarray, origin, dx: float, bs: int) -> np.ndarray:
    return np.floor((x - origin) / dx - 0.5).astype(np.int64) // bs


def _host_morton(blocks: np.ndarray) -> np.ndarray:
    return _block_morton(torch.as_tensor(blocks, dtype=torch.int32)).numpy()


def morton_splits(x: np.ndarray, dx: float, bs: int, n_devices: int,
                  origin=None) -> np.ndarray:
    """Quantile splits of the particles' block morton keys (on the host)."""
    o = np.zeros(3) if origin is None else np.asarray(origin)
    mk = _host_morton(_host_blocks(x, o, dx, bs))
    qs = np.quantile(mk, np.linspace(0, 1, n_devices + 1)[1:-1])
    return np.concatenate([[np.iinfo(np.int32).min], qs.astype(np.int64),
                           [np.iinfo(np.int32).max]]).astype(np.int32)


def make_dd_state(state: MPMState, mesh: DeviceMesh, *, axis: str = "d",
                  cap_per_device: Optional[int] = None,
                  splits: Optional[np.ndarray] = None) -> DDState:
    """This rank's part of a full state, every rank passing the same one:
    each particle goes to the rank owning its block (a shuffle on the
    host), each rank's channels padded to ``cap_per_device`` rows (by
    default the power of two at or above twice the largest share, at
    least 64)."""
    me, D = mesh_rank(mesh, axis)
    p = state.particles
    grid = state.grid
    dx = float(grid.dx)
    origin = grid.transform.matrix.detach().cpu().numpy()[:grid.dim, 3]
    n = int(p.size)
    x = p["x"][:n].detach().cpu().numpy()
    if splits is None:
        splits = morton_splits(x, dx, grid.block_size, D, origin)
    mk = _host_morton(_host_blocks(x, origin, dx, grid.block_size))
    owner = np.clip(np.searchsorted(splits[1:-1], mk, side="right"), 0,
                    D - 1)
    counts = np.bincount(owner, minlength=D)
    capP = cap_per_device or int(1 << int(np.ceil(np.log2(
        max(counts.max() * 2, 64)))))
    if counts.max() > capP:
        raise ValueError(f"cap_per_device {capP} < {counts.max()} particles "
                         f"of one rank")
    # this rank's particles, in the order of the JAX module's full layout
    order = np.argsort(owner, kind="stable")
    mine = order[owner[order] == me]
    dev = mesh_device(mesh)
    k = len(mine)
    alive = torch.zeros(capP, dtype=torch.bool, device=dev)
    alive[:k] = True
    pid = torch.full((capP,), -1, dtype=torch.int32, device=dev)
    pid[:k] = torch.from_numpy(mine.astype(np.int32)).to(dev)
    sel = torch.from_numpy(mine).to(p["x"].device)
    channels = {}
    for name, v in p.channels.items():
        a = torch.zeros((capP,) + tuple(v.shape[1:]), dtype=torch.float32,
                        device=dev)
        a[:k] = v[sel].to(dev, torch.float32)
        channels[name] = a
    return DDState(channels, alive, pid,
                   torch.as_tensor(np.asarray(splits, np.int32), device=dev),
                   state.max_vel.to(dev))


def gather_dd_particles(dds: DDState, n: int,
                        mesh: Optional[DeviceMesh] = None,
                        axis: str = "d") -> Dict[str, np.ndarray]:
    """Every rank's particles, reassembled on the host in original id order
    (a collective when ``mesh`` is given: every rank calls it)."""
    def full(t):
        if mesh is None:
            return t.detach().cpu().numpy()
        return global_array(mesh, t, axis).cpu().numpy()
    pid = full(dds.pid)
    alive = full(dds.alive.to(torch.uint8)).astype(bool)
    out = {}
    for k, v in dds.channels.items():
        a = np.zeros((n,) + tuple(v.shape[1:]), np.float32)
        a[pid[alive]] = full(v)[alive]
        out[k] = a
    return out


def _ring_shift(buf: torch.Tensor, group, me: int, D: int) -> torch.Tensor:
    """One hop of the ring (JAX's ``ppermute`` over ``i -> i + 1``): send
    ``buf`` to rank ``me + 1``, receive the buffer of rank ``me - 1``."""
    out = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf.contiguous(),
                      dist.get_global_rank(group, (me + 1) % D), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - 1) % D), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _with_keys(keys: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """One float32 buffer ``[n, 1 + w]``: the int32 keys bit for bit, then
    the rows flattened (one transfer a hop)."""
    return torch.cat([keys.view(torch.float32)[:, None],
                      rows.reshape(rows.shape[0], -1)], 1)


def _split_keys(buf: torch.Tensor, shape):
    return buf[:, 0].contiguous().view(torch.int32), buf[:, 1:].reshape(shape)


def _pack_ch(ch, pid):
    capP = pid.shape[0]
    cols = [ch["x"], ch["v"], ch["F"].reshape(capP, 9),
            ch["C"].reshape(capP, 9), ch["m"][:, None], ch["vol"][:, None]]
    if "Jp" in ch:
        cols.append(ch["Jp"][:, None])
    cols.append(pid.to(torch.float32)[:, None])
    return torch.cat(cols, 1)


def _unpack_ch(mat, ch):
    out = dict(x=mat[:, 0:3], v=mat[:, 3:6], F=mat[:, 6:15].reshape(-1, 3, 3),
               C=mat[:, 15:24].reshape(-1, 3, 3), m=mat[:, 24],
               vol=mat[:, 25])
    i = 26
    if "Jp" in ch:
        out["Jp"] = mat[:, 26]
        i = 27
    return {k: v.contiguous() for k, v in out.items()}, \
        mat[:, i].to(torch.int32)


def _out_of_range(alive, blocks):
    """A live particle whose block lies outside the morton keys' range
    (its key would wrap to another rank's)."""
    return torch.any(alive & ((blocks < -_MORTON_OFF) |
                              (blocks >= _MORTON_OFF)).any(-1))


def explicit_step_dd(sim: MPMSim, dds: DDState, dt, mesh: DeviceMesh, *,
                     grid_template, nb_local: int, mig_cap: int = 1024,
                     axis: str = "d", with_stats: bool = False):
    """One domain-decomposed explicit APIC step; every rank calls it
    together.

    ``grid_template`` gives dx, the transform and the block size (its table
    and payloads are not read: each rank holds its own ``nb_local`` rows).
    Returns ``(state, overflow)``, ``overflow`` a 0-d bool tensor, the same
    on every rank.  With ``with_stats`` also the ring diagnostics: the live
    rows of each hop of each ring summed over the ranks (``fwd_rows``,
    ``ret_rows``, ``mig_rows``, ``[D-1]`` int32), the bytes of one row of
    each (``*_row_bytes``) and the bytes every hop moves
    (``hop_wire_bytes``: each rank sends its whole fixed-capacity buffer,
    live or not).
    """
    dim = grid_template.dim
    bs = grid_template.block_size
    if dim != 3:
        raise ValueError(f"domain decomposition is 3-D only (block "
                         f"ownership by 3-D morton key), got dim={dim}")
    if sim.flip > 0.0:
        raise ValueError("the domain-decomposed step is APIC only "
                         "(flip = 0)")
    me, D = mesh_rank(mesh, axis)
    group = mesh.get_group(axis)
    ncell = bs ** dim
    capP = dds.alive.shape[0]
    cap_cells = nb_local * ncell
    ch, alive, splits = dds.channels, dds.alive, dds.splits
    dev = alive.device
    i32 = dict(dtype=torch.int32, device=dev)
    m = torch.where(alive, ch["m"], 0.0)
    vol = torch.where(alive, ch["vol"], 0.0)
    dx = grid_template.dx
    origin = grid_template.origin
    xi = (ch["x"] - origin) / dx
    cells, w3, base = _weights(sim, dim, xi)
    pblock = torch.div(base, bs, rounding_mode="floor")

    # 1. key census ---------------------------------------------------------
    ltab, _ = build_block_table(pblock, nb_local, valid=alive, dim=dim)
    doffs = torch.as_tensor(neighbor_offsets(dim, 0, 1), **i32)
    cand = (ltab.active_coords[:, None, :] + doffs[None]).reshape(-1, dim)
    vmask = ltab.mask.repeat_interleave(doffs.shape[0])
    touched, _ = build_block_table(cand, nb_local, valid=vmask, dim=dim)
    all_keys = global_array(mesh, touched.keys, axis)
    owned_remote = (_owner(_block_morton(unpack_key(all_keys, dim)), splits)
                    == me) & (all_keys != KEY_SENTINEL)
    cat = torch.cat([touched.keys, all_keys])
    catmask = torch.cat([touched.mask, owned_remote])
    table, _ = build_block_table(unpack_key(cat, dim), nb_local,
                                valid=catmask, dim=dim)
    overflow = (table.count > table.capacity) | _out_of_range(alive, pblock)
    tcoords = table.active_coords
    owned_slot = (_owner(_block_morton(tcoords), splits) == me) & table.mask

    # 2. local P2G ------------------------------------------------------------
    payload, xdiff, Dinv = _p2g_payload(sim, ch, m, vol, cells, w3, xi, dx,
                                        dt)
    blk = torch.div(cells, bs, rounding_mode="floor")
    loc = cells - blk * bs
    lin = (loc[..., 0] * bs + loc[..., 1]) * bs + loc[..., 2]
    slot = table.query(blk)
    overflow = overflow | torch.any(alive[:, None] & (slot < 0))
    flat = torch.where(slot >= 0, slot * ncell + lin, cap_cells).long()
    acc = _accumulate(payload, flat, cap_cells).reshape(nb_local, ncell,
                                                        1 + dim)

    # 3. forward halo ring ----------------------------------------------------
    send = table.mask & ~owned_slot
    bkeys = torch.where(send, table.keys, KEY_SENTINEL)
    bpay = torch.where(send[:, None, None], acc, 0.0)
    acc = torch.where(owned_slot[:, None, None], acc, 0.0)
    fwd_rows = torch.zeros((D - 1,), **i32)
    for h in range(D - 1):
        bkeys, bpay = _split_keys(
            _ring_shift(_with_keys(bkeys, bpay), group, me, D), bpay.shape)
        live = bkeys != KEY_SENTINEL
        fwd_rows[h] = live.sum()
        rc = unpack_key(bkeys, dim)
        mine = live & (_owner(_block_morton(rc), splits) == me)
        rslot = table.query(rc)
        dst = torch.where(mine & (rslot >= 0), rslot, nb_local).long()
        acc = torch.cat([acc, acc.new_zeros((1, ncell, 1 + dim))])
        acc.index_add_(0, dst, torch.where(mine[:, None, None], bpay, 0.0))
        acc = acc[:nb_local]
        bkeys = torch.where(mine, KEY_SENTINEL, bkeys)
        bpay = torch.where(mine[:, None, None], 0.0, bpay)

    # 4. grid update on the owned rows (the others hold no mass) -------------
    gm = acc[..., 0].reshape(cap_cells)
    gmv = acc[..., 1:].reshape(cap_cells, dim)
    corners = torch.as_tensor(neighbor_offsets(dim, 0, bs - 1), **i32)
    node_x = (tcoords[:, None, :] * bs + corners[None]).reshape(
        cap_cells, dim).to(gm.dtype) * dx + origin
    _, gv = _grid_velocity(sim, gm, gmv, node_x, dt)
    max_vel = torch.sqrt(torch.max(torch.sum(gv * gv, -1)))
    dist.all_reduce(max_vel, dist.ReduceOp.MAX, group=group)

    # 5. return halo ring -----------------------------------------------------
    gv = gv.reshape(nb_local, ncell, dim)
    rkeys = torch.where(owned_slot, table.keys, KEY_SENTINEL)
    rpay = torch.where(owned_slot[:, None, None], gv, 0.0)
    ret_rows = torch.zeros((D - 1,), **i32)
    for h in range(D - 1):
        rkeys, rpay = _split_keys(
            _ring_shift(_with_keys(rkeys, rpay), group, me, D), rpay.shape)
        rslot = table.query(unpack_key(rkeys, dim))
        ret_rows[h] = (rkeys != KEY_SENTINEL).sum()
        fill = (rkeys != KEY_SENTINEL) & (rslot >= 0)
        dst = torch.where(fill, rslot, nb_local).long()
        # apron rows are zero before the ring, so adding fills them
        gv = torch.cat([gv, gv.new_zeros((1, ncell, dim))])
        gv.index_add_(0, dst, torch.where(fill[:, None, None], rpay, 0.0))
        gv = gv[:nb_local]

    # 6. G2P + advect ---------------------------------------------------------
    out_ch = {**ch, **_g2p(sim, ch, alive, gv.reshape(cap_cells, dim), None,
                           flat, w3, xdiff, Dinv, dt)}

    # 7. particle migration ring ----------------------------------------------
    nbase, _, _ = bspline_weights((out_ch["x"] - origin) / dx, sim.order)
    nblock = torch.div(nbase, bs, rounding_mode="floor")
    overflow = overflow | _out_of_range(alive, nblock)
    nowner = _owner(_block_morton(nblock), splits)
    leaving = alive & (nowner != me)
    mat = _pack_ch(out_ch, dds.pid)
    # the leaving lanes first, in lane order
    src = torch.argsort((~leaving).to(torch.int8), stable=True)[:mig_cap]
    bvalid = leaving[src]
    overflow = overflow | (leaving.sum() > mig_cap)
    bmat = torch.where(bvalid[:, None], mat[src], 0.0)
    bowner = torch.where(bvalid, nowner[src], -1)
    alive2 = alive & ~leaving
    mig_rows = torch.zeros((D - 1,), **i32)
    for h in range(D - 1):
        bowner, bmat = _split_keys(
            _ring_shift(_with_keys(bowner, bmat), group, me, D), bmat.shape)
        mig_rows[h] = (bowner >= 0).sum()
        arriving = bowner == me
        n_arr = arriving.sum()
        free = torch.argsort(alive2.to(torch.int8), stable=True)
        overflow = overflow | (n_arr > (~alive2).sum())
        # the k-th arriving row goes to the k-th free slot
        rank = torch.cumsum(arriving.to(torch.int32), 0) - 1
        dst = torch.where(arriving, free[rank.clamp(0, capP - 1)],
                          capP).long()
        mat = torch.cat([mat, mat.new_zeros((1, mat.shape[1]))])
        mat[dst] = bmat
        mat = mat[:capP]
        newalive = torch.zeros((capP + 1,), dtype=torch.bool, device=dev)
        newalive[dst] = arriving
        alive2 = alive2 | newalive[:capP]
        bowner = torch.where(arriving, -1, bowner)
        bmat = torch.where(arriving[:, None], 0.0, bmat)
    out_ch, pid2 = _unpack_ch(mat, out_ch)
    flags = overflow.to(torch.int32).reshape(1)
    dist.all_reduce(flags, dist.ReduceOp.MAX, group=group)
    new = DDState(out_ch, alive2, pid2, splits, max_vel)
    if not with_stats:
        return new, flags[0] > 0
    rows = torch.stack([fwd_rows, ret_rows, mig_rows])
    dist.all_reduce(rows, dist.ReduceOp.SUM, group=group)
    ncols = 26 + (1 if "Jp" in ch else 0) + 1
    stats = {
        "fwd_rows": rows[0], "ret_rows": rows[1], "mig_rows": rows[2],
        "fwd_row_bytes": 4 + ncell * (1 + dim) * 4,
        "ret_row_bytes": 4 + ncell * dim * 4,
        "mig_row_bytes": 4 + ncols * 4,
        "hop_wire_bytes": {
            "fwd": D * nb_local * (4 + ncell * (1 + dim) * 4),
            "ret": D * nb_local * (4 + ncell * dim * 4),
            "mig": D * mig_cap * (4 + ncols * 4),
        },
    }
    return new, flags[0] > 0, stats
