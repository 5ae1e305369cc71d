"""Multi-device explicit MPM with the particles sharded and the grid
replicated (counterpart of ``zpc_tpu/sim/distributed.py``), on
``torch.distributed``: one process per rank, one device per rank.

* The particles are cut into equal shares of the leading axis, one per
  rank (:func:`shard_state`); they never move between ranks.
* Each rank builds the block table of its own particles; an
  ``all_gather`` of the fixed-capacity sorted key arrays and one more
  sort-unique (with the +1 dilation, the stencil apron) give the same
  table on every rank, with no hash race.
* P2G scatters each rank's particles into a partial grid; one
  ``all_reduce(SUM)`` of the ``[cells, 1 + dim]`` accumulator merges mass
  and momentum (JAX's ``psum``).  The grid update is replicated and G2P
  runs locally: no other communication.

The stages are :mod:`zpc_tpu_torch.sim.mpm`'s; the step equals
:func:`~zpc_tpu_torch.sim.mpm.explicit_step` up to the order of the sums.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..containers.block_table import (KEY_SENTINEL, build_block_table,
                                      unpack_key)
from ..parallel.mesh import global_array, mesh_device, mesh_rank
from .mpm import (MPMSim, MPMState, _accumulate, _g2p, _grid_velocity,
                  _p2g_payload, _weights)

__all__ = ["shard_state", "explicit_step_sharded"]


def _to(obj, dev):
    """A copy of a tree of the port's dataclasses, dicts and tensors on
    ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def shard_state(state: MPMState, mesh: DeviceMesh,
                axis: str = "d") -> MPMState:
    """This rank's share of a full state, on the rank's device: the rows
    ``[r * n_local, (r + 1) * n_local)`` of every particle channel (the
    particle capacity must divide by the mesh size; the share's live count
    is the live particles among its rows) and the whole grid."""
    r, nd = mesh_rank(mesh, axis)
    p = state.particles
    if p.capacity % nd:
        raise ValueError(f"particle capacity {p.capacity} does not divide "
                         f"by the mesh's {nd} ranks")
    n_local = p.capacity // nd
    dev = mesh_device(mesh)
    ch = {k: v[r * n_local:(r + 1) * n_local].to(dev)
          for k, v in p.channels.items()}
    size = min(max(p.size - r * n_local, 0), n_local)
    particles = dataclasses.replace(p, channels=ch, size=size)
    return MPMState(particles, _to(state.grid, dev), state.max_vel.to(dev))


def _union_tables(grid, pblock, pmask, mesh, axis):
    """The grid with the same dilated table on every rank: the local sorted
    keys gathered from every rank, unique again, +1 dilated."""
    ltab, _ = build_block_table(pblock, grid.block_capacity, valid=pmask,
                                dim=grid.dim)
    all_keys = global_array(mesh, ltab.keys, axis)
    return grid.activate(unpack_key(all_keys, grid.dim),
                         valid=all_keys != KEY_SENTINEL, dilation=1)


def explicit_step_sharded(sim: MPMSim, state: MPMState, dt,
                          mesh: DeviceMesh, axis: str = "d") -> MPMState:
    """One explicit APIC step of this rank's share (from
    :func:`shard_state`); every rank calls it together.  Returns the
    rank's new share with the replicated grid and max speed."""
    p = state.particles
    grid = state.grid
    dim, bs = grid.dim, grid.block_size
    ncell = grid.cells_per_block
    cap_cells = grid.block_capacity * ncell
    pmask = p.mask
    m = torch.where(pmask, p["m"], 0.0)
    vol = torch.where(pmask, p["vol"], 0.0)
    dx = grid.dx
    xi = (p["x"] - grid.origin) * (1.0 / dx)
    cells, w3, base = _weights(sim, dim, xi)

    # the global table: local tables gathered, unique, +1 dilation
    pblock = torch.div(base, bs, rounding_mode="floor")
    grid = _union_tables(grid, pblock, pmask, mesh, axis)

    # P2G into the local partial grid, then one sum over the ranks
    payload, xdiff, Dinv = _p2g_payload(sim, p.channels, m, vol, cells, w3,
                                        xi, dx, dt)
    slot = grid.cell_slot(cells)
    slot = torch.where(slot >= 0, slot, cap_cells).long()
    acc = _accumulate(payload, slot, cap_cells)
    dist.all_reduce(acc, dist.ReduceOp.SUM, group=mesh.get_group(axis))

    # grid update, replicated
    gm, gmv = acc[:, 0], acc[:, 1:]
    node_x = grid.node_world_positions().reshape(cap_cells, dim)
    gv0, gv = _grid_velocity(sim, gm, gmv, node_x, dt)
    max_vel = torch.sqrt(torch.max(torch.sum(gv * gv, -1)))
    grid = grid.with_data(m=gm.reshape(grid.block_capacity, ncell),
                          v=gv.reshape(grid.block_capacity, ncell, dim))

    # G2P + advect, local
    particles = p.update(**_g2p(sim, p.channels, pmask, gv, gv0, slot, w3,
                                xdiff, Dinv, dt))
    return MPMState(particles, grid, max_vel)
