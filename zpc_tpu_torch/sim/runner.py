"""The simulation loop with frame and checkpoint hooks
(counterpart of ``zpc_tpu/sim/runner.py``).

Runs a transfer path for a number of steps, optionally adapting dt to the
grid CFL, writes frames as bgeo files through the background IO worker
(so the writes overlap the card's work) and checkpoints the state to npz.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.cfl import timestep_velocity
from ..utils.io import AsyncIO, save_state, write_bgeo
from .mpm import MPMSim, MPMState, explicit_step
from .mpm_binned2 import BinnedConfig2, rollout_binned2

__all__ = ["simulate"]


def _binned2_config(capacity: int,
                    bins_capacity: Optional[int] = None) -> BinnedConfig2:
    """The runner's bin budget for a particle capacity: ``cap / 128 + cap /
    512 + 8`` bins (a quarter more than the lanes need, for the per-block
    padding), at least 64."""
    return BinnedConfig2(bins_capacity=bins_capacity or
                         max(64, capacity // 128 + capacity // 512 + 8))


def _frame(io: AsyncIO, prefix: str, step: int, state: MPMState):
    """Copy x and v of the live particles to the host, then queue the
    write: the next steps may overwrite the state's tensors."""
    n = state.particles.size
    x = state.particles["x"][:n].to("cpu", copy=True).numpy()
    v = state.particles["v"][:n].to("cpu", copy=True).numpy()
    io.submit(write_bgeo, f"{prefix}.{step:05d}.bgeo", x, {"v": v})


def simulate(sim: MPMSim, state: MPMState, *, dt: float, steps: int,
             path: str = "auto", bins_capacity: Optional[int] = None,
             frame_every: int = 0, frame_prefix: str = "frame",
             checkpoint_every: int = 0, checkpoint_path: str = "ckpt.npz",
             adapt_dt: bool = False, cfl: float = 0.5,
             on_frame: Optional[Callable] = None) -> MPMState:
    """Run ``steps`` explicit MPM steps on the state's device.

    ``path``: "binned2" runs whole frame segments, each one
    :func:`~zpc_tpu_torch.sim.mpm_binned2.rollout_binned2` at a fixed dt;
    "baseline" steps :func:`~zpc_tpu_torch.sim.mpm.explicit_step` one at a
    time, the only path that takes ``adapt_dt`` (dt becomes ``min(dt,
    cfl * dx / max_vel)`` after each step, computed on the card, never
    read on the host); "auto" is "baseline" with ``adapt_dt`` and
    "binned2" without.  (The JAX package's "auto" takes its v1 binned
    path with ``adapt_dt``; v1 is not ported, so "binned" raises.)

    Every ``frame_every`` steps, x and v of the live particles are copied
    to the host and written as ``{frame_prefix}.{step:05d}.bgeo`` by the
    :class:`~zpc_tpu_torch.utils.io.AsyncIO` worker, and ``on_frame(step,
    state)`` is called; every ``checkpoint_every`` steps the state goes to
    ``checkpoint_path`` (npz, overwritten).  All writes have finished when
    this returns.  A binned2 segment that overflows its bins raises
    RuntimeError (the flag is read once a segment)."""
    if path == "auto":
        path = "baseline" if adapt_dt else "binned2"
    if path == "binned":
        raise ValueError("path='binned' is the v1 binned step, which the "
                         "port does not carry (binned2 supersedes it); use "
                         "'binned2', or 'baseline' with adapt_dt")
    if path == "binned2":
        if adapt_dt:
            raise ValueError("binned2 rollouts use a fixed dt; use "
                             "path='baseline' with adapt_dt")
        return _simulate_binned2(
            sim, state, dt=dt, steps=steps, bins_capacity=bins_capacity,
            frame_every=frame_every, frame_prefix=frame_prefix,
            checkpoint_every=checkpoint_every,
            checkpoint_path=checkpoint_path, on_frame=on_frame)
    if path != "baseline":
        raise ValueError(path)

    io = AsyncIO.instance()
    dev = state.particles.device
    dt_max = torch.tensor(dt, dtype=torch.float32, device=dev)
    dt_t = dt_max
    dx = float(state.grid.dx)
    for i in range(steps):
        state = explicit_step(sim, state, dt_t)
        if adapt_dt:
            dt_t = torch.minimum(dt_max, timestep_velocity(
                state.max_vel, dx, cfl, dt_max=dt))
        if frame_every and (i + 1) % frame_every == 0:
            _frame(io, frame_prefix, i + 1, state)
            if on_frame is not None:
                on_frame(i + 1, state)
        if checkpoint_every and (i + 1) % checkpoint_every == 0:
            save_state(checkpoint_path, state)
    io.wait()
    return state


def _simulate_binned2(sim, state, *, dt, steps, bins_capacity, frame_every,
                      frame_prefix, checkpoint_every, checkpoint_path,
                      on_frame):
    """Segments between frames and checkpoints, each one bin-ordered
    rollout."""
    io = AsyncIO.instance()
    cfg = _binned2_config(state.particles.capacity, bins_capacity)
    dt_t = torch.tensor(dt, dtype=torch.float32,
                        device=state.particles.device)
    seg = min(x for x in (frame_every or steps, checkpoint_every or steps,
                          steps) if x > 0)
    done = 0
    while done < steps:
        n = min(seg, steps - done)
        state, overflow = rollout_binned2(sim, state, dt_t, cfg, n)
        done += n
        if bool(overflow):
            raise RuntimeError("binned2 overflow: grow bins_capacity")
        if frame_every and done % frame_every == 0:
            _frame(io, frame_prefix, done, state)
            if on_frame is not None:
                on_frame(done, state)
        if checkpoint_every and done % checkpoint_every == 0:
            save_state(checkpoint_path, state)
    io.wait()
    return state
