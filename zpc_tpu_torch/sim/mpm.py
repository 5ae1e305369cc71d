"""Explicit APIC MPM on a block-sparse grid (counterpart of
``zpc_tpu/sim/mpm.py``): the port's readable oracle.

One step, in 2-D or 3-D: activate the blocks the B-spline stencils touch
(+1 block dilation), scatter mass and APIC momentum with the fused stress
term into the flat cell array by ``index_add_`` (with a trash slot for
misses), update grid velocities under gravity and colliders, gather back
for G2P, advect.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..containers.structured import StructuredField, structured_field
from ..core.config import prop
from ..geometry.collider import Collider, resolve_boundaries
from ..geometry.sparse_grid import SparseGrid, neighbor_offsets, sparse_grid
from ..math.interpolation import bspline_weights, stencil_size
from ..math.vecmat import mm
from ..models.constitutive import ElasticModel

__all__ = ["MPMSim", "MPMState", "make_mpm_state", "explicit_step"]


@dataclasses.dataclass(frozen=True)
class MPMSim:
    """Physical configuration: the elastic model, gravity ``[dim]``, the
    boundary colliders, an optional plasticity model (projected when the
    state carries ``Jp``), the B-spline ``order`` (2 or 3 for the APIC
    transfer; the binned path takes 2) and the FLIP blend (0: pure
    APIC)."""

    model: ElasticModel
    gravity: torch.Tensor
    colliders: Tuple[Collider, ...] = ()
    plasticity: Optional[object] = None
    order: int = 2
    flip: float = 0.0


@dataclasses.dataclass(frozen=True)
class MPMState:
    particles: StructuredField   # x, v, F, C, m, vol (+ Jp)
    grid: SparseGrid             # m [bs^3], v [bs^3, 3]
    max_vel: torch.Tensor        # 0-d, grid max speed of the last step


def make_mpm_state(x, *, dx: float, device: torch.device, rho: float = 1e3,
                   ppc: float = 8.0, block_capacity: int = 4096,
                   velocity=None, capacity: Optional[int] = None,
                   with_Jp: bool = False, Jp0: float = 0.0,
                   origin=None) -> MPMState:
    """Particle and empty-grid state from positions ``x [n, dim]`` (numpy
    or tensor, dim 2 or 3): F = I, C = 0, m = rho * dx^dim / ppc, vol =
    dx^dim / ppc, and ``Jp = Jp0`` with ``with_Jp`` (the plastic
    state)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    n, dim = x.shape
    cap = capacity or n
    vol0 = dx ** dim / ppc
    props = [prop("x", dim), prop("v", dim), prop("F", (dim, dim)),
             prop("C", (dim, dim)), prop("m"), prop("vol")]
    if with_Jp:
        props.append(prop("Jp"))
    f32 = dict(dtype=torch.float32, device=device)
    data = {
        "x": x,
        "v": (torch.as_tensor(velocity, **f32) if velocity is not None
              else torch.zeros((n, dim), **f32)),
        "F": torch.eye(dim, **f32).expand(n, dim, dim).clone(),
        "C": torch.zeros((n, dim, dim), **f32),
        "m": torch.full((n,), rho * vol0, **f32),
        "vol": torch.full((n,), vol0, **f32),
    }
    if with_Jp:
        data["Jp"] = torch.full((n,), Jp0, **f32)
    particles = structured_field(props, cap, device=device, data=data,
                                 size=n)
    grid = sparse_grid([prop("m"), prop("v", dim)], dx=dx,
                       block_capacity=block_capacity, device=device, dim=dim,
                       origin=origin)
    return MPMState(particles, grid, torch.zeros((), **f32))


def _weights(sim: MPMSim, dim: int, xi: torch.Tensor):
    """Per-particle stencil of index-space positions ``xi [N, dim]``:
    (cells [N, S^dim, dim], w3 [N, S^dim], base [N, dim]) for the stencil
    width S of ``sim.order``."""
    S = stencil_size(sim.order)
    base, w, _ = bspline_weights(xi, sim.order)       # [N,3], [N,3,S]
    offs = torch.as_tensor(neighbor_offsets(dim, 0, S - 1),
                           device=xi.device).long()
    cells = base[:, None, :] + offs[None].to(torch.int32)
    w3 = torch.ones((xi.shape[0], offs.shape[0]), dtype=xi.dtype,
                    device=xi.device)
    for d in range(dim):
        w3 = w3 * w[:, d, :][:, offs[:, d]]
    return cells, w3, base


def _stencil(sim: MPMSim, grid: SparseGrid, x: torch.Tensor):
    """(cells, w3, base, xi) of world positions ``x`` on ``grid``."""
    xi = grid.world_to_index(x)
    cells, w3, base = _weights(sim, grid.dim, xi)
    return cells, w3, base, xi


def _apic_dinv(order: int, dx):
    """The APIC inertia tensor's inverse D^-1 (a multiple of I): 4/dx^2 for
    quadratic and 3/dx^2 for cubic B-splines.  Linear B-splines have a
    D that varies with the position, which the affine transfer does not
    take."""
    if order == 2:
        return 4.0 / (dx * dx)
    if order == 3:
        return 3.0 / (dx * dx)
    raise NotImplementedError(
        f"APIC affine transfer needs order 2 or 3 B-splines, got {order}")


def _p2g_payload(sim: MPMSim, ch, m, vol, cells, w3, xi, dx, dt):
    """The P2G payload ``[N, S^d, 1 + dim]``: w m and w (m v + A dx_ip) with
    A = m C - dt D^-1 vol tau; also xdiff (the node offsets in world
    units) and D^-1.  ``m`` and ``vol`` are 0 on dead lanes."""
    Dinv = _apic_dinv(sim.order, dx)
    tau = sim.model.kirchhoff(ch["F"])
    A = m[:, None, None] * ch["C"] - (dt * Dinv * vol)[:, None, None] * tau
    xdiff = (cells.to(xi.dtype) - xi[:, None, :]) * dx     # [N, S^d, d]
    Ax = torch.bmm(xdiff, A.transpose(1, 2))
    mom = w3[..., None] * (m[:, None, None] * ch["v"][:, None, :] + Ax)
    payload = torch.cat([(w3 * m[:, None])[..., None], mom], -1)
    return payload, xdiff, Dinv


def _accumulate(payload: torch.Tensor, slot: torch.Tensor,
                cap_cells: int) -> torch.Tensor:
    """Scatter-add the payload into ``[cap_cells, 1 + dim]`` by its flat
    cell slot (``cap_cells`` is the trash slot of misses)."""
    acc = torch.zeros((cap_cells + 1, payload.shape[-1]), dtype=payload.dtype,
                      device=payload.device)
    acc.index_add_(0, slot.reshape(-1), payload.reshape(-1, payload.shape[-1]))
    return acc[:cap_cells]


def _grid_velocity(sim: MPMSim, gm, gmv, node_x, dt):
    """(v before forces, v after gravity and colliders) of the nodes;
    massless nodes read 0."""
    has_mass = gm > 0.0
    gv0 = torch.where(has_mass[:, None],
                      gmv / gm.clamp_min(1e-30)[:, None], 0.0)
    gv = gv0 + dt * sim.gravity[None, :]
    gv = resolve_boundaries(sim.colliders, node_x, gv)
    return gv0, torch.where(has_mass[:, None], gv, 0.0)


def _g2p(sim: MPMSim, ch, mask, gv, gv0, slot, w3, xdiff, Dinv, dt):
    """G2P and advection: the new x, v, F, C (and Jp, with plasticity) of
    the lanes under ``mask``, the old values elsewhere.  ``slot`` is the
    trash-slotted cell index of each stencil node; ``gv0`` (the node
    velocity before forces) is read for the FLIP blend only."""
    vnode = torch.cat([gv, torch.zeros_like(gv[:1])])[slot]   # [N,S^d,d]
    wv = w3[..., None] * vnode
    v_new = wv.sum(1)
    Bm = torch.bmm(wv.transpose(1, 2), xdiff)
    C_new = Dinv * Bm
    if sim.flip > 0.0:
        v_new = _flip_blend(sim.flip, ch["v"], v_new, w3, gv - gv0, slot)
    F = ch["F"]
    dim = F.shape[-1]
    eye = torch.eye(dim, dtype=F.dtype, device=F.device)
    F_new = mm(eye + dt * C_new, F)
    updates = {}
    if sim.plasticity is not None and "Jp" in ch:
        F_new, Jp_new = sim.plasticity.project(F_new, ch["Jp"])
        updates["Jp"] = torch.where(mask, Jp_new, ch["Jp"])
    x_new = ch["x"] + dt * v_new
    mk = mask[:, None]
    return dict(x=torch.where(mk, x_new, ch["x"]),
                v=torch.where(mk, v_new, ch["v"]),
                F=torch.where(mk[..., None], F_new, F),
                C=torch.where(mk[..., None], C_new, ch["C"]), **updates)


def explicit_step(sim: MPMSim, state: MPMState, dt) -> MPMState:
    """One explicit symplectic-Euler APIC step (2-D or 3-D)."""
    p = state.particles
    grid = state.grid
    dim, bs = grid.dim, grid.block_size
    ncell = grid.cells_per_block
    cap_cells = grid.block_capacity * ncell
    pmask = p.mask
    m = torch.where(pmask, p["m"], 0.0)
    vol = torch.where(pmask, p["vol"], 0.0)

    # 1. partition: blocks under the stencil bases, +1 dilation
    cells, w3, base, xi = _stencil(sim, grid, p["x"])
    pblock = torch.div(base, bs, rounding_mode="floor")
    grid = grid.activate(pblock, valid=pmask, dilation=1)

    # 2. P2G into the flat cell array (trash slot for misses)
    payload, xdiff, Dinv = _p2g_payload(sim, p.channels, m, vol, cells, w3,
                                        xi, grid.dx, dt)
    slot = grid.cell_slot(cells)                             # -1 on miss
    slot = torch.where(slot >= 0, slot, cap_cells).long()    # trash slot
    acc = _accumulate(payload, slot, cap_cells)
    gm, gmv = acc[:, 0], acc[:, 1:]

    # 3. grid update: velocity, gravity, colliders, massless nodes zeroed
    node_x = grid.node_world_positions().reshape(cap_cells, dim)
    gv0, gv = _grid_velocity(sim, gm, gmv, node_x, dt)
    max_vel = torch.sqrt(torch.max(torch.sum(gv * gv, -1)))
    grid = grid.with_data(m=gm.reshape(grid.block_capacity, ncell),
                          v=gv.reshape(grid.block_capacity, ncell, dim))

    # 4. G2P + advect
    particles = p.update(**_g2p(sim, p.channels, pmask, gv, gv0, slot, w3,
                                xdiff, Dinv, dt))
    return MPMState(particles, grid, max_vel)


def _flip_blend(flip: float, v_old, v_pic, w3, gdv, slot):
    """FLIP/APIC blend: ``flip (v_old + dv) + (1 - flip) v_pic``, where dv
    is the grid velocity change of this step (forces and boundaries, the
    node velocity after them minus the one before) gathered at the
    particle; ``slot`` is the trash-slotted cell index of each stencil
    node."""
    dvnode = torch.cat([gdv, torch.zeros_like(gdv[:1])])[slot]
    dv = (w3[..., None] * dvnode).sum(1)
    return flip * (v_old + dv) + (1.0 - flip) * v_pic
