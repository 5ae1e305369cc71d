"""Tetrahedral FEM: implicit elasticity on any constitutive model
(counterpart of ``zpc_tpu/sim/fem.py``).

Element deformation gradients ``F = Ds Dm^{-1}``, energy ``sum vol_e
psi(F_e)`` over any :class:`~zpc_tpu_torch.models.constitutive.
ElasticModel` plus the IPC ground barrier, implicit Euler by Newton-CG on
the incremental potential with the analytic half-space step limiter: the
scheme of :mod:`zpc_tpu_torch.sim.cloth`.  The gradient comes from
autograd; each Newton round builds its graph once, and every CG iteration
takes an exact Hessian-vector product from it by a second backward pass.
For the SVD-based models that second pass differentiates
:class:`~zpc_tpu_torch.math.svd._Svd3x3`'s backward rule, which is written
in differentiable operations of the factors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.executor import cuda_device
from ..geometry.contact import barrier
from ..math.solvers import cg
from ..math.vecmat import mm
from ..models.constitutive import ElasticModel

__all__ = ["FemSim", "make_tet_box", "fem_energy", "implicit_step"]


@dataclasses.dataclass(frozen=True)
class FemSim:
    """Static topology and material of a tet mesh."""

    tets: torch.Tensor        # [M, 4] int32
    Dm_inv: torch.Tensor      # [M, 3, 3] rest-shape inverses
    vol: torch.Tensor         # [M] rest volumes (positive)
    mass: torch.Tensor        # [N]
    free: torch.Tensor        # [N] bool (False = pinned)
    model: ElasticModel       # batched psi
    gravity: torch.Tensor     # [3]
    ground_n: torch.Tensor
    ground_off: torch.Tensor
    dhat: torch.Tensor
    kappa: torch.Tensor


def _tet_edges(x, tets):
    # index_select, not x[idx]: its backward is an index_add, where the
    # indexing's is a sort-based accumulating index_put on a card, and the
    # Hessian products run the backward twice per CG iteration
    a, b, c, d = (x.index_select(0, tets[:, k]) for k in range(4))
    return torch.stack([b - a, c - a, d - a], -1)           # [M, 3, 3]


# the 5-tet split of a hex cell (corners c[a*4 + b*2 + d] at (a, b, d)) and
# its mirror for cells of odd parity, so neighbouring cells' faces match
_FIVE = ((0, 1, 2, 4), (1, 2, 3, 7), (1, 4, 5, 7), (2, 4, 6, 7), (1, 2, 4, 7))
_FIVE_FLIP = ((0, 1, 3, 5), (0, 2, 3, 6), (0, 4, 5, 6), (3, 5, 6, 7),
              (0, 3, 5, 6))


def make_tet_box(nx: int, ny: int, nz: int, spacing: float, *, model,
                 density: float = 1e3, origin=(0.0, 0.0, 0.0),
                 pinned=(), ground_n=(0.0, 1.0, 0.0),
                 ground_off: float = 0.0, dhat: float = 0.01,
                 kappa: float = 1e2, gravity=(0.0, -9.8, 0.0),
                 device: Optional[torch.device] = None
                 ) -> Tuple[FemSim, torch.Tensor]:
    """Regular hex grid of nx x ny x nz vertices split into 5 tets per
    cell (parity-alternated), on ``device`` (None: the card).  Host-side
    topology; tets with a negative rest determinant swap two vertices."""
    dev = cuda_device() if device is None else device
    gx, gy, gz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    pos = (np.stack([gx, gy, gz], -1).reshape(-1, 3) * spacing
           + np.asarray(origin)).astype(np.float32)
    vid = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    # cell corners [cells, 8] in (a, b, d) order, cells i-major
    corners = np.stack([vid[a:nx - 1 + a, b:ny - 1 + b, d:nz - 1 + d]
                        for a in (0, 1) for b in (0, 1) for d in (0, 1)],
                       -1).reshape(-1, 8)
    ci, cj, ck = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    even = ((ci + cj + ck) % 2 == 0).reshape(-1, 1, 1)
    tets = np.where(even, corners[:, np.asarray(_FIVE)],
                    corners[:, np.asarray(_FIVE_FLIP)])
    tets = tets.reshape(-1, 4).astype(np.int32)
    x0 = torch.as_tensor(pos, device=dev)
    det = torch.linalg.det(_tet_edges(x0, torch.as_tensor(tets, device=dev)))
    flip = det.cpu().numpy() < 0
    tets[flip, 2], tets[flip, 3] = tets[flip, 3].copy(), tets[flip, 2].copy()
    tets_t = torch.as_tensor(tets, device=dev)
    Dm = _tet_edges(x0, tets_t)
    vol = torch.linalg.det(Dm) / 6.0
    mass = np.zeros(nx * ny * nz, np.float32)
    np.add.at(mass, tets.reshape(-1),
              np.repeat(vol.cpu().numpy() * density / 4.0, 4))
    free = np.ones(nx * ny * nz, bool)
    free[list(pinned)] = False

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)
    sim = FemSim(tets=tets_t, Dm_inv=torch.linalg.inv(Dm), vol=vol,
                 mass=torch.as_tensor(mass, device=dev),
                 free=torch.as_tensor(free, device=dev), model=model,
                 gravity=f32(gravity), ground_n=f32(ground_n),
                 ground_off=f32(ground_off), dhat=f32(dhat),
                 kappa=f32(kappa))
    return sim, x0


def fem_energy(sim: FemSim, x: torch.Tensor) -> torch.Tensor:
    """Elastic + ground-barrier energy."""
    F = mm(_tet_edges(x, sim.tets), sim.Dm_inv)
    e_el = torch.sum(sim.vol * sim.model.psi(F))
    gap = x @ sim.ground_n - sim.ground_off
    return e_el + torch.sum(barrier(gap * gap, sim.dhat * sim.dhat,
                                    sim.kappa))


def implicit_step(sim: FemSim, x: torch.Tensor, v: torch.Tensor, dt, *,
                  newton_iters: int = 2, cg_iters: int = 50,
                  with_stats: bool = False):
    """Implicit Euler on the incremental potential (Newton-CG, matrix-free
    exact Hessian-vector products).  Returns ``(x, v)``; ``with_stats=True``
    appends the list of CG iterations of each Newton round."""
    dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
    free3 = sim.free[:, None]
    m3 = torch.clamp_min(sim.mass, 1e-12)[:, None]
    xhat = x + dt * v + (dt * dt) * sim.gravity[None, :]
    xhat = torch.where(free3, xhat, x)

    def project(p):
        return torch.where(free3, p, 0.0)

    y = x
    stats = []
    for _ in range(newton_iters):
        with torch.enable_grad():
            z = y.detach().requires_grad_(True)
            ge = torch.autograd.grad(fem_energy(sim, z), z,
                                     create_graph=True)[0]
            g = torch.where(free3, (m3 / (dt * dt)) * (z - xhat) + ge, 0.0)
        hvp = lambda p, _z=z, _g=g: project(torch.autograd.grad(
            _g, _z, project(p), retain_graph=True)[0])
        res = cg(hvp, -g.detach(), project=project, max_iters=cg_iters,
                 rel_tol=1e-3)
        stats.append(res.iters)
        dx = project(res.x).detach()
        gap = y @ sim.ground_n - sim.ground_off
        dgap = dx @ sim.ground_n
        a_vert = torch.where(dgap < 0,
                             0.9 * gap / torch.clamp_min(-dgap, 1e-30), 1.0)
        alpha = torch.clamp_max(torch.where(sim.free, a_vert,
                                            torch.inf).min(), 1.0)
        y = y + alpha * dx
    v_new = torch.where(free3, (y - x) / dt, 0.0)
    return (y, v_new, stats) if with_stats else (y, v_new)
