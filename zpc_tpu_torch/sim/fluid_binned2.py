"""Binned J-only fluid MPM, 2-D and 3-D (counterpart of
``zpc_tpu/sim/fluid_binned2.py``).

The elastic binned path's machinery (sort into bins with K-padding, the
frozen 8-node windows, recentering, adaptive rebinning with the hand CUDA
scan) with a payload of x v J C m vol (18 columns in 3-D, 11 in 2-D) in
place of the elastic one (26, 14): the equation-of-state stress is one
scalar on the diagonal of the APIC affine matrix, and J evolves by the
trace of the new C.  The transfers are the shared helpers of
:mod:`zpc_tpu_torch.sim.mpm_binned2`.

Not ported: the chunked 3-D step (``chunk_bins``, a TPU scratch
workaround that is physics-identical to the unchunked step).  Dead lanes
keep their J column in 2-D as in 3-D (the JAX 2-D step writes 1 there;
no live particle reads it).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..models.constitutive import EquationOfState
from .mpm import MPMSim, MPMState
from .mpm_binned2 import (BinnedConfig2, BinState, _bin_keys,
                          _check_binnable, _ctx_g2p, _ctx_p2g, _grid_update,
                          _lane_model, _make_ctx, _rebin, _recenter,
                          _sort_into_bins, adaptive_chain)

__all__ = ["bin_fluid_state", "unbin_fluid_state",
           "explicit_fluid_step_binned2", "rollout_fluid_binned2"]


def _fluid_layout(dim: int = 3) -> dict:
    """Column offsets of the x v J C m vol payload."""
    return dict(J=2 * dim, C0=2 * dim + 1, M=2 * dim + 1 + dim * dim,
                VOL=2 * dim + 2 + dim * dim, W=2 * dim + 3 + dim * dim)


def bin_fluid_state(sim: MPMSim, state: MPMState,
                    cfg: BinnedConfig2) -> BinState:
    """Enter bin order from a fluid state (x, v, J, C, m, vol).  Raises
    ValueError when ``bins_capacity * K`` lanes cannot hold the particle
    capacity."""
    p = state.particles
    grid = state.grid
    _check_binnable(sim, grid)
    d = grid.dim
    N = p.capacity
    pmask = p.mask
    cols = torch.cat([p["x"], p["v"], p["J"][:, None],
                      p["C"].reshape(N, d * d),
                      torch.where(pmask, p["m"], 0.0)[:, None],
                      torch.where(pmask, p["vol"], 0.0)[:, None]], dim=1)
    pid = torch.where(pmask, torch.arange(N, dtype=torch.int32,
                                          device=pmask.device), -1)
    keys = _bin_keys(p["x"], pmask, grid, sim.order)
    nb = cfg.block_capacity or grid.block_capacity
    st = _sort_into_bins(keys, cols, pid, cfg, nb, d)
    return dataclasses.replace(
        st, grid=dataclasses.replace(st.grid, transform=grid.transform),
        max_vel=state.max_vel)


def unbin_fluid_state(st: BinState, template: MPMState) -> MPMState:
    """Back to original particle order (one gather)."""
    p = template.particles
    N = p.capacity
    L = st.cols.shape[0]
    d = st.grid.dim
    lay = _fluid_layout(d)
    alive = st.pid >= 0
    dst = torch.where(alive, st.pid, N).long()
    inv = torch.zeros((N + 1,), dtype=torch.long, device=st.pid.device)
    inv[dst] = torch.arange(L, device=st.pid.device)
    mat = st.cols[inv[:N]]
    pmask = p.mask
    mk = pmask[:, None]
    c0 = lay["C0"]
    particles = p.update(
        x=torch.where(mk, mat[:, 0:d], p["x"]),
        v=torch.where(mk, mat[:, d:2 * d], p["v"]),
        J=torch.where(pmask, mat[:, lay["J"]], p["J"]),
        C=torch.where(mk[..., None],
                      mat[:, c0:c0 + d * d].reshape(N, d, d), p["C"]))
    return MPMState(particles, st.grid, st.max_vel)


def explicit_fluid_step_binned2(sim: MPMSim, st: BinState, dt,
                                cfg: BinnedConfig2, *, rebin: bool = True,
                                j_clamp: float = 0.1) -> BinState:
    """One explicit J-only equation-of-state step on a fluid BinState (bin
    order in and out, 2-D or 3-D); ``rebin=True`` re-sorts first."""
    if not isinstance(sim.model, EquationOfState):
        raise TypeError("the fluid pipeline needs an EquationOfState model")
    if rebin:
        st = _rebin(sim, st, cfg)
    ctx = _make_ctx(st, cfg)
    L = st.cols.shape[0]
    d = st.grid.dim
    lay = _fluid_layout(d)
    cols = st.cols
    c0 = lay["C0"]
    xb, vb = cols[:, 0:d], cols[:, d:2 * d]
    Cb = cols[:, c0:c0 + d * d].reshape(L, d, d)
    alive = ctx.alive
    # dead lanes carry J = 0 and pressure(0) is inf: 0 * inf would be NaN
    # in the scatter even though vol masks the magnitude
    Jb = torch.where(alive, cols[:, lay["J"]], 1.0)
    m = torch.where(alive, cols[:, lay["M"]], 0.0)
    vol = torch.where(alive, cols[:, lay["VOL"]], 0.0)

    eos = _lane_model(sim.model, st.pid)
    stress_s = -dt * ctx.dinv * vol * (-eos.pressure(Jb) * Jb)
    eye = torch.eye(d, dtype=torch.float32, device=cols.device)
    A = m[:, None, None] * Cb + stress_s[:, None, None] * eye
    gm, gmv = _ctx_p2g(ctx, m, vb, A)
    gv, max_vel = _grid_update(sim, ctx, gm, gmv, dt)
    v_new, C_new = _ctx_g2p(ctx, gv)
    J_new = Jb * (1.0 + dt * torch.diagonal(C_new, dim1=-2, dim2=-1).sum(-1))
    J_new = torch.clamp_min(J_new, j_clamp)
    x_new = xb + dt * v_new
    grid, escaped = _recenter(ctx, x_new)

    ok = alive[:, None]
    ncols = torch.cat([torch.where(ok, x_new, xb), torch.where(ok, v_new, vb),
                       torch.where(alive, J_new, cols[:, lay["J"]])[:, None],
                       torch.where(ok[..., None], C_new,
                                   Cb).reshape(L, d * d),
                       m[:, None], vol[:, None]], dim=1)
    grid = dataclasses.replace(grid, data={"m": gm, "v": gv})
    return dataclasses.replace(st, cols=ncols, grid=grid, max_vel=max_vel,
                               overflow=ctx.overflow, needs_rebin=escaped)


def rollout_fluid_binned2(sim: MPMSim, state: MPMState, dt,
                          cfg: BinnedConfig2, n_steps: int,
                          j_clamp: float = 0.1
                          ) -> Tuple[MPMState, torch.Tensor]:
    """``n_steps`` adaptive fluid steps in bin order (the port's host
    :func:`~zpc_tpu_torch.sim.mpm_binned2.adaptive_chain`), original order
    restored at the end.  Returns ``(state, overflow)``."""
    st = bin_fluid_state(sim, state, cfg)
    st = adaptive_chain(
        lambda s: explicit_fluid_step_binned2(sim, s, dt, cfg, rebin=False,
                                              j_clamp=j_clamp),
        lambda s: _rebin(sim, s, cfg), st, n_steps)
    return unbin_fluid_state(st, state), st.overflow
