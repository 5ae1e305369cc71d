"""IPC-style mesh contact for the implicit binned MPM solve (counterpart of
``zpc_tpu/sim/contact_implicit.py``, BASELINE config 5 as specified).

* **Broad phase per bin.**  Each bin of K = 128 lanes maps to one grid
  block, so one dhat-padded query per bin (its window box) against the
  triangles' LBVH (:func:`~zpc_tpu_torch.containers.bvh.
  build_lbvh_complete`) finds every candidate, through the banded join
  :func:`~zpc_tpu_torch.containers.bvh.query_overlaps_sorted` with one
  shared extent.  The result is a dense ``[B, max_tris]`` triangle list.
* **Narrow phase per bin.**  Every live lane against its bin's candidate
  triangles: the point-triangle closest point, the barrier force from the
  envelope gradient ``grad d^2 = 2 (p - closest)``, the Hessian its
  Gauss-Newton PSD part ``b''(d^2) grad d^2 grad d^2^T`` (the ``b' hess
  d^2`` term is dropped), summed over the candidates
  (:func:`~zpc_tpu_torch.ops.mesh_barrier.mesh_barrier`: one hand kernel
  on the card, a block at a time on the CPU; the JAX package evaluates
  every ``[B, K, max_tris]`` slot at once and sums slot by slot).  The
  energy and the CCD take every bin's candidate slots a few columns at a
  time, so that their memory is bounded and they read nothing back to the
  host.  While a profiler runs, the work of each narrow phase is added to
  :data:`~zpc_tpu_torch.utils.profile.CONTACT_WORK` on the device.
* **Capacity contract.**  More than ``max_tris`` candidates near a live
  bin, or a live bin's query that the banded join cannot certify (out of
  band), set the overflow flag for the host; nothing raises.

The broad phase, the narrow phase and the CCD run inside the spans
``zpc.contact.broad``, ``zpc.contact.narrow`` and ``zpc.contact.ccd``
(:mod:`zpc_tpu_torch.utils.profile`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..containers.bvh import LBvh, build_lbvh_complete, query_overlaps_sorted
from ..geometry.contact import barrier
from ..geometry.distance import point_triangle_ccd, point_triangle_closest
from ..ops import mesh_barrier as _barrier
from ..utils.profile import add_contact_work, spanned
from .mpm_binned2 import SIDE, K

__all__ = ["MeshContact", "ContactSet"]


class ContactSet(NamedTuple):
    """Broad-phase result: candidate triangles per bin."""

    hits: torch.Tensor       # [B, max_tris] triangle ids, -1 padded
    overflow: torch.Tensor   # 0-d: a list truncated or a query out of band


@dataclasses.dataclass(frozen=True)
class MeshContact:
    """A static triangle mesh obstacle with an IPC barrier, for
    :func:`~zpc_tpu_torch.sim.implicit_binned2.implicit_step_binned2`."""

    tri: torch.Tensor     # [M, 3, 3] triangle vertices
    bvh: LBvh
    dhat: float           # barrier activation distance (world units)
    kappa: float          # barrier stiffness
    max_tris: int = 8     # candidate triangles per bin window
    tile: int = 128       # banded-join query tile
    use_ccd: bool = False  # conservative-advancement advection clamp

    @staticmethod
    def build(tri_verts: torch.Tensor, dhat: float, kappa: float, *,
              max_tris: int = 8, tile: int = 128,
              use_ccd: bool = False) -> "MeshContact":
        """The mesh ``tri_verts [M, 3, 3]`` (on the device it will run on)
        and the complete LBVH over its triangles' boxes."""
        tri = tri_verts.to(torch.float32)
        return MeshContact(tri, build_lbvh_complete(tri.amin(1), tri.amax(1)),
                           float(dhat), float(kappa), max_tris, tile,
                           use_ccd)

    # -- broad phase --------------------------------------------------------
    @spanned("contact.broad")
    def broad_phase(self, ctx, lane_alive: torch.Tensor) -> ContactSet:
        """One dhat-padded box query per bin window.  ``ctx`` is the step's
        :class:`~zpc_tpu_torch.sim.mpm_binned2._Ctx`, ``lane_alive [B,
        K]``."""
        bin_live, hits, counts, in_band = self._bin_query(ctx, lane_alive)
        overflow = (bin_live & ((counts > self.max_tris) | ~in_band)).any()
        return ContactSet(hits, overflow)

    def _bin_query(self, ctx, lane_alive: torch.Tensor):
        """The broad phase per bin: (live [B], hits [B, max_tris], true
        candidate counts [B], in_band [B])."""
        B = lane_alive.shape[0]
        dev = lane_alive.device
        dx = ctx.dx
        bin_live = lane_alive.any(1)
        # one extent for every window (the uniform-extent join); the 1e-5
        # relative inflation keeps the rebuilt c -+ ext outside the exact
        # window under f32 rounding (the narrow phase tests d < dhat
        # exactly anyway)
        half = 0.5 * (SIDE - 1) * dx
        borigin = ctx.borigin_l.view(B, K, 3)[:, 0]
        cen = borigin.to(torch.float32) * dx + ctx.grid.origin + half
        ext = (half + self.dhat) * (1.0 + 1e-5)
        far = 1e9
        # fewer bins than a tile make one tile of B queries: the same leaf
        # window and answers as a padded tile, without its far queries
        T = min(self.tile, B)
        nq = -(-B // T) * T
        pts = torch.cat([torch.where(bin_live[:, None], cen, far),
                         torch.full((nq - B, 3), far, dtype=torch.float32,
                                    device=dev)])
        qid, hits, counts, in_band = query_overlaps_sorted(
            self.bvh, pts, pts, self.max_tris, tile=T, uniform_extent=ext)
        qid = qid.long()
        hits_b = torch.full((nq, self.max_tris), -1, dtype=torch.int32,
                            device=dev)
        hits_b[qid] = hits
        cnt_b = torch.zeros((nq,), dtype=torch.int32, device=dev)
        cnt_b[qid] = counts
        band_b = torch.zeros((nq,), dtype=torch.bool, device=dev)
        band_b[qid] = in_band
        return bin_live, hits_b[:B], cnt_b[:B], band_b[:B]

    # -- narrow phase -------------------------------------------------------
    @spanned("contact.narrow")
    def forces_and_hessians(self, cset: ContactSet, xb: torch.Tensor,
                            lane_alive: torch.Tensor):
        """Barrier force [B, K, 3] and GN-PSD position Hessian [B, K, 3,
        3]."""
        fc, Hc, work = _barrier.mesh_barrier(xb, lane_alive, cset.hits,
                                             self.tri, self.dhat, self.kappa)
        add_contact_work(work)
        return fc, Hc

    def _columns(self, cset: ContactSet, xb, lane_alive):
        """Every bin's candidate slots, a block of columns of ``hits`` at a
        time (at most ``PAIRS`` (lane, slot) pairs, one column at least):
        (lanes [B, K, 1, 3], live pairs [B, K, c], corners a, b, c [B, 1,
        c, 3]).  No host read."""
        B = lane_alive.shape[0]
        step = max(1, _barrier.PAIRS // (B * K))
        p = xb[:, :, None]
        for s in range(0, cset.hits.shape[1], step):
            ids = cset.hits[:, s:s + step]
            tv = self.tri[ids.clamp_min(0).long()][:, None]
            live = lane_alive[:, :, None] & (ids >= 0)[:, None]
            yield p, live, tv[..., 0, :], tv[..., 1, :], tv[..., 2, :]

    def energy(self, cset: ContactSet, xb: torch.Tensor,
               lane_alive: torch.Tensor) -> torch.Tensor:
        """Total barrier energy (line search, diagnostics)."""
        dhat2 = self.dhat * self.dhat
        total = xb.new_zeros(())
        for p, live, a, b, c in self._columns(cset, xb, lane_alive):
            _, cl = point_triangle_closest(p, a, b, c)
            diff = p - cl
            d2 = torch.sum(diff * diff, -1)
            act = live & (d2 < dhat2)
            total = total + torch.where(
                act, barrier(d2, dhat2, self.kappa), 0.0).sum()
        return total

    @spanned("contact.ccd")
    def toi(self, cset: ContactSet, xb: torch.Tensor, dxb: torch.Tensor,
            lane_alive: torch.Tensor, min_sep: float = 1e-4) -> torch.Tensor:
        """Per-lane conservative time of impact in (0, 1] ``[B, K]`` of the
        displacement ``dxb`` against the candidate triangles (additive
        conservative advancement, a block of candidate slots at a
        time)."""
        out = xb.new_ones(xb.shape[:2])
        for p, live, a, b, c in self._columns(cset, xb, lane_alive):
            shape = live.shape + (3,)
            zero3 = p.new_zeros(()).expand(shape)
            ti = point_triangle_ccd(
                p.expand(shape), a.expand(shape), b.expand(shape),
                c.expand(shape), dxb[:, :, None].expand(shape), zero3,
                zero3, zero3, min_sep=min_sep)
            out = torch.minimum(out, torch.where(live, ti, 1.0).amin(-1))
        return out
