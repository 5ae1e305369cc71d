"""Implicit MPM: the matrix-free backward-Euler grid solve with PCG
(counterpart of ``zpc_tpu/sim/implicit.py``), 2-D or 3-D, on the unbinned
scatter path of :mod:`zpc_tpu_torch.sim.mpm`.  It is the readable oracle of the
binned implicit step (:mod:`zpc_tpu_torch.sim.implicit_binned2`).

System solved (mass-PSD form, one linearised solve per step):
    (M + dt^2 K) v_new = M v_pred,   v_pred = (m v + dt f_int + dt M g) / M
with K the elastic stiffness action, Dirichlet projection at the nodes a
collider changes and mass-Jacobi preconditioning.  The operator is one
gather -> dP/dF -> scatter round over the step's stencil arrays; dP(F)[dF]
is ``torch.func.jvp`` of the model's ``first_piola``, linearised once per
step (:meth:`~zpc_tpu_torch.models.constitutive.ElasticModel.linearize`).
In 2-D the SVD-based stresses take the closed-form
:func:`~zpc_tpu_torch.math.svd.svd2x2`, whose derivative is finite at
F = I (JAX's is NaN there, so its 2-D step from rest is NaN).
"""

from __future__ import annotations

import torch

from ..geometry.collider import resolve_boundaries
from ..math.solvers import cg
from ..math.svd import svd2x2, svd3x3
from ..math.vecmat import mm
from .mpm import MPMSim, MPMState, _stencil

__all__ = ["implicit_step"]


def implicit_step(sim: MPMSim, state: MPMState, dt, cg_iters: int = 50,
                  cg_tol: float = 1e-3, newton_iters: int = 1,
                  hessian_clamp: float = 0.0) -> MPMState:
    """One implicit (backward-Euler) MPM step.

    ``newton_iters > 1`` adds Newton refinement of the nonlinear grid
    residual G(v) = M (v - v_mom) - dt f_int(F(v)), each refinement guarded
    by a backtracking line search over {1, 1/2, 1/4, 1/8} on |G| (the first
    step length that lowers |G| is taken, else v stays).
    ``hessian_clamp = s`` evaluates the force differential at F with its
    singular values clamped to >= s (a positive-definiteness guard near
    inversion)."""
    p = state.particles
    grid = state.grid
    dim, bs = grid.dim, grid.block_size
    ncell = grid.cells_per_block
    cap_cells = grid.block_capacity * ncell
    dx = grid.dx
    pmask = p.mask
    m = torch.where(pmask, p["m"], 0.0)
    vol = torch.where(pmask, p["vol"], 0.0)
    Dinv = 4.0 / (dx * dx)

    # stencil and partition, as the explicit step has them
    cells, w3, base, xi = _stencil(sim, grid, p["x"])
    pblock = torch.div(base, bs, rounding_mode="floor")
    grid = grid.activate(pblock, valid=pmask, dilation=1)
    slot = grid.cell_slot(cells)
    slot = torch.where(slot >= 0, slot, cap_cells).long()    # trash slot
    flat = slot.reshape(-1)
    xdiff = (cells.to(xi.dtype) - xi[:, None, :]) * dx     # [N, S^d, d]
    F = p["F"]

    def scatter(vals):
        c = vals.shape[-1]
        acc = torch.zeros((cap_cells + 1, c), dtype=vals.dtype,
                          device=vals.device)
        acc.index_add_(0, flat, vals.reshape(-1, c))
        return acc[:cap_cells]

    def gather(g):
        return torch.cat([g, torch.zeros_like(g[:1])])[slot]  # [N, S^d, d]

    def affine(M):
        """M (x_i - x_p) at every stencil node: [N, S^d, d]."""
        return torch.bmm(xdiff, M.transpose(1, 2))

    def velocity_gradient(u):
        """D^-1 sum_i w u_i (x_i - x_p)^T of node values ``u``."""
        wu = w3[..., None] * gather(u)
        return Dinv * torch.bmm(wu.transpose(1, 2), xdiff)

    def internal_force(tau):
        """f_i = -sum_p vol tau D^-1 (x_i - x_p) w."""
        return scatter(-w3[..., None] * Dinv * vol[:, None, None] *
                       affine(tau))

    # P2G: mass, APIC momentum, internal force
    mom = w3[..., None] * (m[:, None, None] * p["v"][:, None, :] +
                           affine(m[:, None, None] * p["C"]))
    acc = scatter(torch.cat([(w3 * m[:, None])[..., None], mom], -1))
    gm, gmv = acc[:, 0], acc[:, 1:]
    fint = internal_force(sim.model.kirchhoff(F))

    # predictor and Dirichlet mask: nodes a collider changes are fixed at
    # the boundary-resolved velocity
    has_mass = gm > 0.0
    minv = torch.where(has_mass, 1.0 / gm.clamp_min(1e-30), 0.0)
    v_pred = (gmv + dt * fint) * minv[:, None] + dt * sim.gravity[None, :]
    v_pred = torch.where(has_mass[:, None], v_pred, 0.0)
    node_x = grid.node_world_positions().reshape(cap_cells, dim)
    v_bc = resolve_boundaries(sim.colliders, node_x, v_pred)
    constrained = ((v_bc - v_pred).abs() > 0.0).any(-1)
    free = has_mass & ~constrained

    def project(u):
        return torch.where(free[:, None], u, 0.0)

    if hessian_clamp > 0.0:
        U, S, V = (svd3x3 if dim == 3 else svd2x2)(F)
        F_h = mm(U * S.clamp_min(hessian_clamp)[..., None, :],
                   V.transpose(-1, -2))
    else:
        F_h = F
    F_hT = F_h.transpose(-1, -2)
    dP_dF = sim.model.linearize(F_h)

    # A u = M u + dt^2 K u: one dt in dF (the position change dt u), one in
    # the force integral
    def A(u):
        dF = dt * mm(velocity_gradient(u), F_h)
        dtau = mm(dP_dF(dF), F_hT)
        Ku = scatter(w3[..., None] * Dinv * vol[:, None, None] * dt *
                     affine(dtau))
        return gm[:, None] * u + Ku

    def precondition(r):
        return r * minv[:, None]

    res = cg(A, project(gm[:, None] * v_pred), x0=project(v_pred),
             project=project, precondition=precondition, max_iters=cg_iters,
             rel_tol=cg_tol)
    gv = torch.where(free[:, None], res.x, v_bc)

    if newton_iters > 1:
        eye = torch.eye(dim, dtype=F.dtype, device=F.device)
        v_mom = gmv * minv[:, None] + dt * sim.gravity[None, :]
        v_mom = torch.where(has_mass[:, None], v_mom, 0.0)

        def residual(v):
            Fv = mm(eye + dt * velocity_gradient(v), F)
            fv = internal_force(sim.model.kirchhoff(Fv))
            return project(gm[:, None] * v - gm[:, None] * v_mom - dt * fv)

        def norm2(u):
            return torch.sum(u * u)

        vk = torch.where(free[:, None], gv, 0.0)
        for _ in range(newton_iters - 1):
            Gk = residual(vk)
            gn = norm2(Gk)
            delta = cg(A, -Gk, project=project, precondition=precondition,
                       max_iters=cg_iters, rel_tol=cg_tol).x
            best_v = vk
            accepted = torch.zeros((), dtype=torch.bool, device=F.device)
            for alpha in (1.0, 0.5, 0.25, 0.125):
                cand = project(vk + alpha * delta)
                take = ~accepted & (norm2(residual(cand)) < gn)
                best_v = torch.where(take, cand, best_v)
                accepted = accepted | take
            vk = best_v
        gv = torch.where(free[:, None], vk, v_bc)
    gv = torch.where(has_mass[:, None], gv, 0.0)
    max_vel = torch.sqrt(torch.max(torch.sum(gv * gv, -1)))
    grid = grid.with_data(m=gm.reshape(grid.block_capacity, ncell),
                          v=gv.reshape(grid.block_capacity, ncell, dim))

    # G2P and advection
    v_new = (w3[..., None] * gather(gv)).sum(1)
    C_new = velocity_gradient(gv)
    eye = torch.eye(dim, dtype=F.dtype, device=F.device)
    F_new = mm(eye + dt * C_new, F)
    upd = {}
    if sim.plasticity is not None and p.has_prop("Jp"):
        F_new, Jp_new = sim.plasticity.project(F_new, p["Jp"])
        upd["Jp"] = torch.where(pmask, Jp_new, p["Jp"])
    x_new = p["x"] + dt * v_new
    mk = pmask[:, None]
    particles = p.update(
        x=torch.where(mk, x_new, p["x"]), v=torch.where(mk, v_new, p["v"]),
        F=torch.where(mk[..., None], F_new, F),
        C=torch.where(mk[..., None], C_new, p["C"]), **upd)
    return MPMState(particles, grid, max_vel)
