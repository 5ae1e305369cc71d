"""Scenes built from numpy inputs, identical to the JAX package's.

:func:`mpm_block` is ``examples/mpm_block.py:build`` line for line: the same
``default_rng(7)`` positions, material, colliders and CFL timestep, so a
JAX run and a port run start from the same particles.  :func:`lbvh_boxes`
is the LBVH broad-phase scene of ``benchmarks/run_all.py:bench_bvh``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .geometry.collider import Collider, ColliderType
from .geometry.levelset import ComplementLevelSet, Cuboid, HalfSpace
from .models.cfl import timestep_linear_elasticity
from .models.constitutive import FixedCorotated
from .sim.mpm import MPMSim, MPMState, make_mpm_state

__all__ = ["mpm_block", "lbvh_boxes"]


def mpm_block(n_particles: int, dx: float, device: torch.device,
              block_capacity: int = 4096) -> Tuple[MPMSim, MPMState, float]:
    """The elastic block benchmark scene: FixedCorotated (E 5e4, nu 0.3,
    rho 1e3, 8 ppc), a sticky ground plane at y = 0.05 and sticky box
    walls at 0.02 / 0.98.  Returns ``(sim, state, dt)`` with the CFL-0.4
    timestep."""
    rng = np.random.default_rng(7)
    # cube of side 0.25 centred in the unit domain, lifted by 0.2 in y
    L = 0.25
    x = rng.uniform(0.5 - L / 2, 0.5 + L / 2,
                    (n_particles, 3)).astype(np.float32)
    x[:, 1] += 0.2
    st = make_mpm_state(x, dx=dx, device=device, rho=1e3, ppc=8.0,
                        block_capacity=block_capacity)
    E, nu = 5e4, 0.3
    model = FixedCorotated.from_young_poisson(E, nu, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    ground = Collider(HalfSpace(torch.tensor([0.0, 0.05, 0.0], **f32),
                                torch.tensor([0.0, 1.0, 0.0], **f32)),
                      ColliderType.sticky)
    walls = Collider(ComplementLevelSet(Cuboid(torch.full((3,), 0.02, **f32),
                                               torch.full((3,), 0.98, **f32))),
                     ColliderType.sticky)
    sim = MPMSim(model=model, gravity=torch.tensor([0.0, -9.8, 0.0], **f32),
                 colliders=(ground, walls))
    dt = float(timestep_linear_elasticity(E, nu, 1e3, dx, cfl=0.4))
    return sim, st, dt


def lbvh_boxes(n: int, device: torch.device, seed: int = 0,
               half: float = 0.002
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n`` boxes of half-extent ``half`` on each axis around centres drawn
    uniformly in the unit cube by ``default_rng(seed)`` (float32), as
    ``bench_bvh`` makes them.  Returns ``(lo, hi, centers)`` on
    ``device``."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = np.full((n, 3), half, np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (c - h, c + h, c))
