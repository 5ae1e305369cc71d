"""Plain reference of the implicit block over a large triangle mesh:
:mod:`dense_mpm` (imported, not changed) with the barrier's all-pairs
loop replaced by an exact pruning of the same sum.

It imports nothing of the program under test.  ``dense_mpm`` tests every
near particle against every triangle: over the 100,352-triangle terrain
that is ~100k rows x 100,352 triangles, ~1e10 float64 pairs a step.
Here the near rows (those inside the mesh's box grown by 2 dhat, as in
``dense_mpm``) are grouped by the (x, z) tile of side :data:`TILE` they
lie in, and each group is tested against the triangles whose bounding box
comes within dhat of the group's box on every axis.  A triangle left out
lies farther than dhat from every row of the group, so its pairs have
d >= dhat, where the barrier and its derivatives are 0: the result is the
all-pairs barrier, summed over fewer zero terms (equal up to the order of
the sums).  The pairs of a group, the closest points and the barrier are
``dense_mpm``'s own functions and formulas.
"""

from __future__ import annotations

import torch

from portbench.reference import dense_mpm

__all__ = ["DenseMPMMesh", "run", "TILE"]

TILE = 1.0 / 32


class DenseMPMMesh(dense_mpm.DenseMPM):
    """:class:`dense_mpm.DenseMPM` with the barrier summed over each
    group's triangles in reach."""

    def _contact(self):
        """Barrier force [N, 3] and Gauss-Newton Hessian [N, 3, 3]."""
        dh2, kap = self.dhat * self.dhat, self.kappa
        fc = torch.zeros_like(self.x)
        Hc = torch.zeros((self.x.shape[0], 3, 3), dtype=self.dtype,
                         device=self.dev)
        tri = self.tri
        td = tri.double()
        t_lo, t_hi = td.amin(1), td.amax(1)                     # [M, 3]
        pad = 2.0 * self.dhat
        lo = t_lo.amin(0) - pad
        hi = t_hi.amax(0) + pad
        xd = self.x.double()
        rows = torch.nonzero(((xd > lo) & (xd < hi)).all(-1))[:, 0]
        if rows.numel() == 0:
            return fc, Hc
        # rows grouped by their (x, z) tile, in order
        cell = torch.floor(xd[rows][:, [0, 2]] / TILE).long()
        key = (cell[:, 0] << 32) + cell[:, 1]
        order = torch.argsort(key, stable=True)
        rows, key = rows[order], key[order]
        _, counts = torch.unique_consecutive(key, return_counts=True)
        for r_g in torch.split(rows, counts.tolist()):
            g = xd[r_g]
            g_lo, g_hi = g.amin(0) - self.dhat, g.amax(0) + self.dhat
            near = ((t_hi >= g_lo) & (t_lo <= g_hi)).all(-1)
            t_g = tri[near]
            if t_g.shape[0] == 0:
                continue
            a, b, c = t_g[None, :, 0], t_g[None, :, 1], t_g[None, :, 2]
            step = max(1, self.PAIRS // t_g.shape[0])
            for s in range(0, r_g.shape[0], step):
                r = r_g[s:s + step]
                p = self.x[r][:, None, :]
                diff = p - dense_mpm._closest_on_triangle(p, a, b, c)
                d2 = (diff * diff).sum(-1)
                act = (d2 < dh2) & (d2 > 0)
                s2 = torch.where(act, d2, dh2)
                lg = torch.log(s2 / dh2)
                bg = -kap * (2.0 * (s2 - dh2) * lg + (s2 - dh2) ** 2 / s2)
                bh = -kap * (2.0 * lg + 2.0 * (s2 - dh2) / s2 +
                             (s2 - dh2) * (s2 + dh2) / (s2 * s2))
                bg = torch.where(act, bg, 0.0)
                bh = torch.where(act, bh.clamp_min(0.0), 0.0)
                fc[r] = -((2.0 * bg)[..., None] * diff).sum(1)
                Hc[r] = ((4.0 * bh)[..., None, None] *
                         (diff[..., :, None] * diff[..., None, :])).sum(1)
        return fc, Hc


def run(cfg: dict, x0: torch.Tensor, v0, tri, dt: float, steps: int,
        dtype: torch.dtype):
    """(x, v, F) of the particles after ``steps`` steps from positions
    ``x0`` and velocities ``v0`` (None: at rest), against the obstacle's
    triangles ``tri [M, 3, 3]`` (None: no contact)."""
    sim = DenseMPMMesh(cfg, x0, v0, tri, dt, dtype)
    for _ in range(steps):
        sim.step()
    return sim.x, sim.v, sim.F
