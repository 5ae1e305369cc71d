"""J-only weakly compressible fluid MPM (counterpart of
``zpc_tpu/sim/fluid.py``): the fluid pipeline's readable oracle.

A fluid needs no deformation gradient: the equation-of-state stress
depends only on the volume ratio J, so particles carry a scalar J in place
of F, and the stress enters the APIC affine matrix as one scalar on its
diagonal.  J evolves as ``J' = J (1 + dt tr(C'))``, the trace of the
affine velocity gradient being the discrete divergence.  The transfers
are those of :func:`zpc_tpu_torch.sim.mpm.explicit_step` (2-D or 3-D).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..containers.structured import structured_field
from ..core.config import prop
from ..geometry.collider import resolve_boundaries
from ..geometry.sparse_grid import sparse_grid
from ..models.constitutive import EquationOfState
from .mpm import MPMSim, MPMState, _apic_dinv, _flip_blend, _stencil

__all__ = ["make_fluid_state", "explicit_fluid_step"]


def make_fluid_state(x, *, dx: float, device: torch.device, rho: float = 1e3,
                     ppc: float = 8.0, block_capacity: int = 4096,
                     velocity=None, capacity: Optional[int] = None,
                     origin=None) -> MPMState:
    """Particle state (x, v, J = 1, C = 0, m, vol) from positions
    ``x [n, dim]`` (numpy or tensor) and an empty m/v grid."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    n, dim = x.shape
    vol0 = dx ** dim / ppc
    f32 = dict(dtype=torch.float32, device=device)
    props = [prop("x", dim), prop("v", dim), prop("J"),
             prop("C", (dim, dim)), prop("m"), prop("vol")]
    data = {
        "x": x,
        "v": (torch.as_tensor(velocity, **f32) if velocity is not None
              else torch.zeros((n, dim), **f32)),
        "J": torch.ones((n,), **f32),
        "C": torch.zeros((n, dim, dim), **f32),
        "m": torch.full((n,), rho * vol0, **f32),
        "vol": torch.full((n,), vol0, **f32),
    }
    particles = structured_field(props, capacity or n, device=device,
                                 data=data, size=n)
    grid = sparse_grid([prop("m"), prop("v", dim)], dx=dx,
                       block_capacity=block_capacity, device=device, dim=dim,
                       origin=origin)
    return MPMState(particles, grid, torch.zeros((), **f32))


def explicit_fluid_step(sim: MPMSim, state: MPMState, dt,
                        j_clamp: float = 0.1) -> MPMState:
    """One explicit APIC step with the scalar-J equation-of-state stress;
    ``sim.model`` must be an :class:`EquationOfState`, and ``j_clamp``
    bounds J from below under violent compression."""
    if not isinstance(sim.model, EquationOfState):
        raise TypeError("the fluid pipeline needs an EquationOfState model")
    p = state.particles
    grid = state.grid
    dim = grid.dim
    ncell = grid.cells_per_block
    cap_cells = grid.block_capacity * ncell
    dx = grid.dx
    pmask = p.mask
    m = torch.where(pmask, p["m"], 0.0)

    cells, w3, base, xi = _stencil(sim, grid, p["x"])
    pblock = torch.div(base, grid.block_size, rounding_mode="floor")
    grid = grid.activate(pblock, valid=pmask, dilation=1)

    # tau = -p(J) J I is diagonal: the stress shifts A's diagonal by one
    # scalar per particle.  Masked lanes carry J = 0 and pressure(0) is
    # inf, so they take J = 1 (0 * inf would be NaN)
    Dinv = _apic_dinv(sim.order, dx)
    J = torch.where(pmask, p["J"], 1.0)
    tau_s = -sim.model.pressure(J) * J
    stress_s = -dt * Dinv * torch.where(pmask, p["vol"], 0.0) * tau_s
    eye = torch.eye(dim, dtype=torch.float32, device=m.device)
    A = m[:, None, None] * p["C"] + stress_s[:, None, None] * eye
    xdiff = (cells.to(xi.dtype) - xi[:, None, :]) * dx
    Ax = torch.bmm(xdiff, A.transpose(1, 2))
    mom = w3[..., None] * (m[:, None, None] * p["v"][:, None, :] + Ax)
    slot = grid.cell_slot(cells)
    slot = torch.where(slot >= 0, slot, cap_cells).long()
    payload = torch.cat([(w3 * m[:, None])[..., None], mom], -1)
    acc = torch.zeros((cap_cells + 1, 1 + dim), dtype=payload.dtype,
                      device=payload.device)
    acc.index_add_(0, slot.reshape(-1), payload.reshape(-1, 1 + dim))
    gm = acc[:cap_cells, 0]
    gmv = acc[:cap_cells, 1:]

    has_mass = gm > 0.0
    gv0 = torch.where(has_mass[:, None],
                      gmv / gm.clamp_min(1e-30)[:, None], 0.0)
    gv = gv0 + dt * sim.gravity[None, :]
    node_x = grid.node_world_positions().reshape(cap_cells, dim)
    gv = resolve_boundaries(sim.colliders, node_x, gv)
    gv = torch.where(has_mass[:, None], gv, 0.0)
    max_vel = torch.sqrt(torch.max(torch.sum(gv * gv, -1)))
    grid = grid.with_data(m=gm.reshape(grid.block_capacity, ncell),
                          v=gv.reshape(grid.block_capacity, ncell, dim))

    wv = w3[..., None] * torch.cat([gv, torch.zeros_like(gv[:1])])[slot]
    v_new = wv.sum(1)
    C_new = Dinv * torch.bmm(wv.transpose(1, 2), xdiff)
    if sim.flip > 0.0:
        v_new = _flip_blend(sim.flip, p["v"], v_new, w3, gv - gv0, slot)
    # volume update: the divergence of the affine field
    J_new = J * (1.0 + dt * torch.diagonal(C_new, dim1=-2, dim2=-1).sum(-1))
    J_new = torch.clamp_min(J_new, j_clamp)
    x_new = p["x"] + dt * v_new

    mk = pmask[:, None]
    particles = p.update(
        x=torch.where(mk, x_new, p["x"]),
        v=torch.where(mk, v_new, p["v"]),
        J=torch.where(pmask, J_new, p["J"]),
        C=torch.where(mk[..., None], C_new, p["C"]))
    return MPMState(particles, grid, max_vel)
