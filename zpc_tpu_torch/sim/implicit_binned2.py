"""Implicit MPM on the binned-v2 machinery (counterpart of
``zpc_tpu/sim/implicit_binned2.py``), 3-D.

The system of :mod:`zpc_tpu_torch.sim.implicit`, ``(M + dt^2 K) v =
M v_pred`` with Dirichlet projection and mass-Jacobi preconditioning, on
the bin-ordered lanes: the transfer context (:func:`~zpc_tpu_torch.sim.
mpm_binned2._make_ctx`: stencil weights, flat node indices, node offsets)
is built once per step and shared by the right-hand side and every CG
operator application, and the particle state stays in bin order across a
rollout.

One P2G of 7 channels (m; m v + m C (x_i - x_p); -D^-1 vol tau (x_i -
x_p)) gives the grid mass, momentum and internal force.  The operator
gathers the node field, forms dF = dt D^-1 (sum w u (x_i - x_p)^T) F,
applies the force differential and scatters 3 affine channels back.

The stress is linearised once per step, as the JAX package does with
``jax.linearize``, but not by ``torch.func.linearize``: that does trace
the SVD models, but it records the whole primal graph anew for every new
F, 28 s of host time at 1M particles on the H100 host (PERF.md).  The
model's ``linearize`` takes the SVD of F once per step and each operator
application runs ``torch.func.jvp`` of the stress around those factors,
so only the stress's cheap primal ops are repeated.

Mesh contact (``contact``, a :class:`~zpc_tpu_torch.sim.contact_implicit.
MeshContact`) adds the IPC barrier: after the context, one broad phase
per step (its overflow joins the step's), the barrier force at t^n in the
right-hand side's plain force channels, and ``dt^2 H_c`` of the particle
velocity in every operator application's plain channels.
``contact_precond`` adds the barrier Hessian's diagonal, transferred with
squared weights, to the mass-Jacobi preconditioner; ``use_ccd`` scales
each particle's advection by its conservative time of impact.

The right-hand side (through the predictor and the boundary conditions)
and the stress's linearisation run inside the spans ``zpc.implicit.rhs``
and ``zpc.implicit.linearize``; the context, the transfers, the CG loop
and the contact carry their own (:mod:`zpc_tpu_torch.utils.profile`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..geometry.collider import resolve_boundaries
from ..math.solvers import cg
from ..math.vecmat import mm33
from ..utils.profile import span
from .mpm import MPMSim, MPMState
from .mpm_binned2 import (K, BinnedConfig2, BinState, _advance, _ctx_g2p,
                          _ctx_p2g_affine, _ctx_p2g_squared, _lane_model,
                          _lanes, _make_ctx, _node_positions, _rebin,
                          adaptive_chain, bin_state, rebin_adaptive,
                          unbin_state)

__all__ = ["implicit_step_binned2", "implicit_rollout_binned2"]


def _implicit_bin_step(sim: MPMSim, st: BinState, dt, cfg: BinnedConfig2,
                       cg_iters: int, cg_tol: float, contact=None,
                       contact_precond: bool = False):
    """One implicit step on a BinState (bin order in and out).  Returns
    (BinState, CG iterations)."""
    ctx = _make_ctx(st, cfg)
    lanes = _lanes(st, ctx)
    xb, vb, Fb, Cb, m, vol = lanes
    L = st.cols.shape[0]
    dinv = ctx.dinv
    zeros = torch.zeros((L, 1, 3), dtype=torch.float32, device=vb.device)

    # the barrier at t^n: its force rides the right-hand side's plain force
    # channels, its Hessian the operator's plain channels
    fc = torch.zeros_like(vb)
    Hc = pdiag = disp_scale = None
    if contact is not None:
        B = cfg.bins_capacity
        lane_alive = ctx.alive.view(B, K)
        xbk = xb.view(B, K, 3)
        cset = contact.broad_phase(ctx, lane_alive)
        ctx = dataclasses.replace(ctx, overflow=ctx.overflow | cset.overflow)
        fc, Hc = contact.forces_and_hessians(cset, xbk, lane_alive)
        fc, Hc = fc.view(L, 3), Hc.view(L, 3, 3)
        if contact_precond:
            pdiag = _ctx_p2g_squared(
                ctx, torch.clamp_min(Hc.diagonal(dim1=-2, dim2=-1), 0.0))
        if contact.use_ccd:
            def disp_scale(disp):
                return contact.toi(cset, xbk, disp.view(B, K, 3),
                                   lane_alive).view(L)

    with span("implicit.rhs"):
        # right-hand side: mass, APIC momentum and internal force, one P2G
        model = _lane_model(sim.model, st.pid)
        tau = model.kirchhoff(Fb)
        A_m = m[:, None, None] * Cb
        A_f = (-dinv * vol)[:, None, None] * tau
        Q0 = torch.cat([m[:, None], m[:, None] * vb, fc], -1)
        acc = _ctx_p2g_affine(ctx, Q0, torch.cat([zeros, A_m, A_f], 1))
        gm, gmv, fint = acc[..., 0], acc[..., 1:4], acc[..., 4:7]

        # predictor and Dirichlet mask
        has_mass = gm > 0.0
        minv = torch.where(has_mass, 1.0 / gm.clamp_min(1e-30), 0.0)
        v_pred = (gmv + dt * fint) * minv[..., None] + dt * sim.gravity
        v_pred = torch.where(has_mass[..., None], v_pred, 0.0)
        v_bc = resolve_boundaries(sim.colliders, _node_positions(ctx),
                                  v_pred)
        constrained = ((v_bc - v_pred).abs() > 0.0).any(-1)
        free = has_mass & ~constrained
        free_f = free.to(torch.float32)[..., None]

    def project(u):
        return u * free_f

    # (M + dt^2 K [+ dt^2 K_c]) u over [nb, 64, 3]
    FbT = Fb.transpose(-1, -2)
    kscale = (dt * dinv * vol)[:, None, None]
    with span("implicit.linearize"):
        dP_dF = model.linearize(Fb)

    def A_op(u):
        s0, dC = _ctx_g2p(ctx, u)
        dP = dP_dF(dt * mm33(dC, Fb))
        Qk = None if Hc is None else (dt * dt) * torch.bmm(
            Hc, s0[..., None])[..., 0]
        return gm[..., None] * u + _ctx_p2g_affine(
            ctx, Qk, kscale * mm33(dP, FbT))

    if pdiag is None:
        def precondition(r):
            return r * minv[..., None]
    else:
        pd = torch.clamp_min(gm[..., None] + (dt * dt) * pdiag, 1e-30)

        def precondition(r):
            return torch.where(has_mass[..., None], r / pd, 0.0)

    res = cg(A_op, project(gm[..., None] * v_pred), x0=project(v_pred),
             project=project, precondition=precondition, max_iters=cg_iters,
             rel_tol=cg_tol)
    gv = torch.where(free[..., None], res.x, v_bc)
    gv = torch.where(has_mass[..., None], gv, 0.0)
    max_vel = torch.sqrt(torch.max(torch.sum(gv * gv, -1)))
    return _advance(sim, st, ctx, lanes, gm, gv, max_vel, dt,
                    disp_scale), res.iters


def implicit_step_binned2(sim: MPMSim, state, dt, cfg: BinnedConfig2,
                          cg_iters: int = 50, cg_tol: float = 1e-3,
                          contact=None, *, rebin: bool = True,
                          with_stats: bool = False,
                          contact_precond: bool = False):
    """Implicit step: MPMState -> (MPMState, overflow), or BinState ->
    BinState when called with a BinState (re-sorted first with
    ``rebin``).  ``with_stats=True`` (BinState form) also returns the CG
    iteration count the solve used.  ``contact``: a
    :class:`~zpc_tpu_torch.sim.contact_implicit.MeshContact`;
    ``contact_precond`` (with ``contact``) adds the barrier Hessian's
    squared-weight grid diagonal to the Jacobi preconditioner."""
    if isinstance(state, BinState):
        st = _rebin(sim, state, cfg) if rebin else state
        out, iters = _implicit_bin_step(sim, st, dt, cfg, cg_iters, cg_tol,
                                        contact, contact_precond)
        return (out, iters) if with_stats else out
    out, _ = _implicit_bin_step(sim, bin_state(sim, state, cfg), dt, cfg,
                                cg_iters, cg_tol, contact, contact_precond)
    return unbin_state(out, state), out.overflow


def implicit_rollout_binned2(sim: MPMSim, state: MPMState, dt,
                             cfg: BinnedConfig2, n_steps: int,
                             cg_iters: int = 50, cg_tol: float = 1e-3,
                             contact=None) -> Tuple[MPMState, torch.Tensor]:
    """``n_steps`` implicit steps in bin order through
    :func:`~zpc_tpu_torch.sim.mpm_binned2.adaptive_chain` (a rebin after
    every step that set ``needs_rebin``).  Returns ``(state, overflow)``."""
    st = adaptive_chain(
        lambda s: _implicit_bin_step(sim, s, dt, cfg, cg_iters, cg_tol,
                                     contact)[0],
        lambda s: rebin_adaptive(sim, s, cfg), bin_state(sim, state, cfg),
        n_steps)
    return unbin_state(st, state), st.overflow
