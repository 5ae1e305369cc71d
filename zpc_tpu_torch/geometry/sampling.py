"""Particle seeding samplers (counterpart of
``zpc_tpu/geometry/sampling.py``).

Seeding is one-time set-up on the host, in numpy, with the JAX package's
arithmetic and random streams, so the same arguments and seed give the
same points bit for bit:

* :func:`sample_lattice`: a jittered lattice of ~ppc particles per cell;
* :func:`poisson_disk`: Bridson dart throwing;
* :func:`sample_levelset`: either pattern kept where a level set's sdf is
  negative (the sdf evaluated on a CPU float32 tensor).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["sample_lattice", "poisson_disk", "sample_levelset"]


def sample_lattice(lo, hi, dx: float, ppc: float = 8.0,
                   jitter: float = 0.5, seed: int = 0) -> np.ndarray:
    """Jittered lattice with ~ppc particles per dx^dim cell inside [lo,
    hi].  The lattice is ``np.arange`` over the float span, so its count
    per axis is whatever that rounds to."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    dim = lo.shape[0]
    spacing = dx / (ppc ** (1.0 / dim))
    axes = [np.arange(lo[d] + spacing / 2, hi[d], spacing)
            for d in range(dim)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, dim)
    rng = np.random.default_rng(seed)
    grid = grid + rng.uniform(-jitter, jitter, grid.shape) * spacing
    return np.clip(grid, lo, hi).astype(np.float32)


def poisson_disk(lo, hi, radius: float, k: int = 30, seed: int = 0,
                 max_points: Optional[int] = None) -> np.ndarray:
    """Bridson (2007) Poisson-disk sampling in an axis-aligned box: no two
    points closer than ``radius``."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    dim = lo.shape[0]
    cell = radius / np.sqrt(dim)
    dims = np.maximum(((hi - lo) / cell).astype(int) + 1, 1)
    grid = -np.ones(dims, dtype=np.int64)
    pts = []
    active = []

    def gcoord(p):
        return tuple(((p - lo) / cell).astype(int))

    p0 = lo + rng.uniform(0, 1, dim) * (hi - lo)
    pts.append(p0)
    grid[gcoord(p0)] = 0
    active.append(0)
    neigh = [np.array(t) - 2 for t in np.ndindex(*([5] * dim))]

    while active and (max_points is None or len(pts) < max_points):
        ai = rng.integers(len(active))
        base = pts[active[ai]]
        placed = False
        for _ in range(k):
            d = rng.standard_normal(dim)
            d /= np.linalg.norm(d)
            cand = base + d * (radius * (1 + rng.uniform()))
            if np.any(cand < lo) or np.any(cand >= hi):
                continue
            gc = np.array(gcoord(cand))
            ok = True
            for off in neigh:
                nc = gc + off
                if np.any(nc < 0) or np.any(nc >= dims):
                    continue
                j = grid[tuple(nc)]
                if j >= 0 and np.linalg.norm(pts[j] - cand) < radius:
                    ok = False
                    break
            if ok:
                pts.append(cand)
                grid[tuple(gc)] = len(pts) - 1
                active.append(len(pts) - 1)
                placed = True
                break
        if not placed:
            active.pop(ai)
    return np.asarray(pts, np.float32)


def sample_levelset(sdf: Callable[[torch.Tensor], torch.Tensor], lo, hi,
                    dx: float, ppc: float = 8.0, seed: int = 0,
                    method: str = "lattice",
                    radius: Optional[float] = None) -> np.ndarray:
    """The points of the chosen pattern in [lo, hi] where ``sdf`` (a
    level set's, taking a ``[n, dim]`` float32 tensor) is negative.  The
    sdf runs on the CPU: seeding stays on the host, and a level set built
    on the card is not needed for it (use one built on the CPU)."""
    if method == "lattice":
        pts = sample_lattice(lo, hi, dx, ppc, seed=seed)
    elif method == "poisson":
        r = radius or dx / (ppc ** (1.0 / len(np.atleast_1d(lo))))
        pts = poisson_disk(lo, hi, r, seed=seed)
    else:
        raise ValueError(method)
    d = sdf(torch.from_numpy(pts)).detach().cpu().numpy()
    return pts[d < 0.0]
