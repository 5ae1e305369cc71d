"""IPC-style mesh contact for the implicit binned MPM solve (counterpart of
``zpc_tpu/sim/contact_implicit.py``, BASELINE config 5 as specified).

* **Broad phase per bin.**  Each bin of K = 128 lanes maps to one grid
  block, so one dhat-padded query per bin (its window box) against the
  triangles' LBVH (:func:`~zpc_tpu_torch.containers.bvh.
  build_lbvh_complete`) finds every candidate, through the banded join
  :func:`~zpc_tpu_torch.containers.bvh.query_overlaps_sorted` with one
  shared extent.  The result is a dense ``[B, max_tris]`` triangle list.
* **Dense narrow phase.**  Every (lane, candidate slot) pair evaluates the
  point-triangle closest point, all slots at once over ``[B, K,
  max_tris]``.  The barrier force uses the envelope gradient ``grad d^2 =
  2 (p - closest)``, the Hessian its Gauss-Newton PSD part ``b''(d^2)
  grad d^2 grad d^2^T`` (the ``b' hess d^2`` term is dropped), summed over
  the slots as one batched ``[3, max_tris] x [max_tris, 3]`` product per
  lane, so no ``[L, max_tris, 3, 3]`` intermediate is formed.  The JAX
  package sums slot by slot; the sums here are reassociated.
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
from ..geometry.contact import barrier, barrier_grad, barrier_hess
from ..geometry.distance import point_triangle_ccd, point_triangle_closest
from ..utils.profile import spanned
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
        T = self.tile
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
    def _candidates(self, cset: ContactSet):
        """(valid [B, max_tris], vertices [B, max_tris, 3, 3])."""
        M = self.tri.shape[0]
        idx = cset.hits
        return idx >= 0, self.tri[idx.clamp(0, M - 1).long()]

    def _pairwise(self, cset: ContactSet, xb, lane_alive):
        """(active [B, K, T], diff [B, K, T, 3], d2 [B, K, T]) over every
        lane and candidate slot."""
        tvalid, tv = self._candidates(cset)
        _, cl = point_triangle_closest(
            xb[:, :, None, :], tv[:, None, :, 0], tv[:, None, :, 1],
            tv[:, None, :, 2])
        diff = xb[:, :, None, :] - cl
        d2 = torch.sum(diff * diff, -1)
        act = tvalid[:, None, :] & lane_alive[..., None] & \
            (d2 < self.dhat * self.dhat)
        return act, diff, d2

    @spanned("contact.narrow")
    def forces_and_hessians(self, cset: ContactSet, xb: torch.Tensor,
                            lane_alive: torch.Tensor):
        """Barrier force [B, K, 3] and GN-PSD position Hessian [B, K, 3,
        3]."""
        B, Kk, _ = xb.shape
        dhat2 = self.dhat * self.dhat
        act, diff, d2 = self._pairwise(cset, xb, lane_alive)
        bg = torch.where(act, barrier_grad(d2, dhat2, self.kappa), 0.0)
        bh = torch.where(
            act, torch.clamp_min(barrier_hess(d2, dhat2, self.kappa), 0.0),
            0.0)
        fc = -((2.0 * bg)[..., None] * diff).sum(2)
        T = diff.shape[2]
        u = ((4.0 * bh)[..., None] * diff).view(B * Kk, T, 3)
        Hc = torch.bmm(u.transpose(1, 2), diff.reshape(B * Kk, T, 3))
        return fc, Hc.view(B, Kk, 3, 3)

    def energy(self, cset: ContactSet, xb: torch.Tensor,
               lane_alive: torch.Tensor) -> torch.Tensor:
        """Total barrier energy (line search, diagnostics)."""
        act, _, d2 = self._pairwise(cset, xb, lane_alive)
        return torch.where(act, barrier(d2, self.dhat * self.dhat,
                                        self.kappa), 0.0).sum()

    @spanned("contact.ccd")
    def toi(self, cset: ContactSet, xb: torch.Tensor, dxb: torch.Tensor,
            lane_alive: torch.Tensor, min_sep: float = 1e-4) -> torch.Tensor:
        """Per-lane conservative time of impact in (0, 1] ``[B, K]`` of the
        displacement ``dxb`` against the candidate triangles (additive
        conservative advancement over every slot at once)."""
        tvalid, tv = self._candidates(cset)
        shape = xb.shape[:2] + (tv.shape[1], 3)
        zero3 = xb.new_zeros(()).expand(shape)
        ti = point_triangle_ccd(
            xb[:, :, None, :].expand(shape), tv[:, None, :, 0].expand(shape),
            tv[:, None, :, 1].expand(shape), tv[:, None, :, 2].expand(shape),
            dxb[:, :, None, :].expand(shape), zero3, zero3, zero3,
            min_sep=min_sep)
        ok = tvalid[:, None, :] & lane_alive[..., None]
        return torch.where(ok, ti, 1.0).amin(-1)
