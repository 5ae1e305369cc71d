"""The IPC point-triangle barrier of a bin's lanes against its candidate
triangles: the hand-written CUDA kernel and its plain version.

:func:`mesh_barrier` is the entry point, the narrow phase of
:class:`~zpc_tpu_torch.sim.contact_implicit.MeshContact`.  A bin holds K =
128 lanes; ``hits [B, max_tris]`` lists the triangles the broad phase
found near bin ``b`` (-1 where there is none).  For every live lane p and
every candidate triangle with closest point c and ``d^2 = |p - c|^2``
inside ``(0, dhat^2)``, the barrier ``b(d^2)`` of
:mod:`zpc_tpu_torch.geometry.contact` gives the force ``-2 b'(d^2) (p -
c)`` and the Gauss-Newton Hessian ``4 max(b''(d^2), 0) (p - c)(p -
c)^T``, both summed over the candidates.  It also returns the work it did,
``[pairs, lanes, tris, active]`` (int64): the sum over live bins of live
lanes x candidates, the live lanes of bins with a candidate, the
candidates of live bins, and the (live lane, candidate) pairs with ``d^2
< dhat^2``.

A tensor on the CPU goes to :func:`mesh_barrier_reference`; tensors on a
CUDA device launch the kernel in ``csrc/mesh_barrier.cu`` or raise; it
never falls back to the plain version.  Replaces no TPU kernel: the JAX
package evaluates every ``[B, K, max_tris]`` slot at once, which at the
source's 100,352-triangle terrain (``max_tris`` 648) needs 9.2 GB for one
``[..., 3]`` intermediate.

The plain version walks only the candidate slots of live bins, in blocks
of at most :data:`PAIRS` (slot, lane) pairs, so its memory does not grow
with ``max_tris``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels
from ..geometry.contact import barrier_grad, barrier_hess
from ..geometry.distance import point_triangle_closest

__all__ = ["LANES", "PAIRS", "LAUNCHES", "mesh_barrier",
           "mesh_barrier_reference", "term_magnitudes", "build"]

LANES = 128
"""Lanes per bin (K), one thread each in the kernel."""

PAIRS = 1 << 20
"""(candidate slot, lane) pairs per block of the plain version (and of
``MeshContact``'s energy and times of impact), read at every call."""

LAUNCHES = 0
"""Number of calls that launched the CUDA kernel (one per
:func:`mesh_barrier` on CUDA tensors; the plain version never counts)."""


def _check(xb, lane_alive, hits, tri) -> None:
    if xb.dim() != 3 or xb.shape[2] != 3:
        raise ValueError(f"xb must be [B, K, 3], got {tuple(xb.shape)}")
    B, K, _ = xb.shape
    if tuple(lane_alive.shape) != (B, K) or lane_alive.dtype != torch.bool:
        raise ValueError("lane_alive must be a bool [B, K]")
    if hits.dim() != 2 or hits.shape[0] != B or hits.dtype != torch.int32:
        raise ValueError("hits must be an int32 [B, max_tris]")
    if tri.dim() != 3 or tuple(tri.shape[1:]) != (3, 3):
        raise ValueError(f"tri must be [M, 3, 3], got {tuple(tri.shape)}")


def _pair_blocks(hits: torch.Tensor, lane_alive: torch.Tensor):
    """The candidate slots of live bins in (bin, slot) order, as blocks of
    at most ``PAIRS // K`` slots: yields (bins [E] long, triangle ids [E]
    long).  Reads the slots' positions back to the host (``nonzero``)."""
    K = lane_alive.shape[1]
    keep = (hits >= 0) & lane_alive.any(1)[:, None]
    bins, slots = torch.nonzero(keep, as_tuple=True)
    ids = hits[bins, slots].long()
    step = max(1, PAIRS // K)
    for s in range(0, bins.shape[0], step):
        yield bins[s:s + step], ids[s:s + step]


def _pair_terms(xb, lane_alive, hits, tri, dhat, kappa):
    """Per block of candidate slots: (bins [E], the force terms ``2 b' (p
    - c)`` [E, K, 3], the Hessian terms ``4 max(b'', 0) (p - c)(p - c)^T``
    [E, K, 3, 3], zero off the barrier's reach and on dead lanes, and the
    number of active pairs, 0-d)."""
    dhat2 = dhat * dhat
    for bins, ids in _pair_blocks(hits, lane_alive):
        tv = tri[ids]
        p = xb[bins]                                    # [E, K, 3]
        _, cl = point_triangle_closest(p, tv[:, None, 0], tv[:, None, 1],
                                       tv[:, None, 2])
        diff = p - cl
        d2 = torch.sum(diff * diff, -1)
        act = lane_alive[bins] & (d2 < dhat2)
        bg = torch.where(act, barrier_grad(d2, dhat2, kappa), 0.0)
        bh = torch.where(
            act, torch.clamp_min(barrier_hess(d2, dhat2, kappa), 0.0), 0.0)
        u = (4.0 * bh)[..., None] * diff
        yield bins, (2.0 * bg)[..., None] * diff, \
            u[..., :, None] * diff[..., None, :], act.sum()


def mesh_barrier_reference(xb: torch.Tensor, lane_alive: torch.Tensor,
                           hits: torch.Tensor, tri: torch.Tensor,
                           dhat: float, kappa: float):
    """Plain PyTorch barrier: (fc [B, K, 3], Hc [B, K, 3, 3], work [4]).
    Each lane's sums run over its bin's candidates in slot order on the
    CPU (``index_add_``; on a card in no set order), whatever the size of
    the blocks."""
    _check(xb, lane_alive, hits, tri)
    B, K, _ = xb.shape
    f = xb.new_zeros((B, K * 3))
    H = xb.new_zeros((B, K * 9))
    active = torch.zeros((), dtype=torch.int64, device=xb.device)
    for bins, ft, Ht, n in _pair_terms(xb, lane_alive, hits, tri, dhat,
                                       kappa):
        f.index_add_(0, bins, ft.flatten(1))
        H.index_add_(0, bins, Ht.flatten(1))
        active = active + n
    ncand = (hits >= 0).sum(1)
    nlive = lane_alive.sum(1)
    work = torch.stack([(nlive * ncand).sum(),
                        torch.where(ncand > 0, nlive, 0).sum(),
                        torch.where(nlive > 0, ncand, 0).sum(), active])
    return (-f).view(B, K, 3), H.view(B, K, 3, 3), work


def term_magnitudes(xb: torch.Tensor, lane_alive: torch.Tensor,
                    hits: torch.Tensor, tri: torch.Tensor, dhat: float,
                    kappa: float):
    """The sums of the terms' magnitudes, ``sum |2 b' (p - c)|`` [B, K, 3]
    and ``sum |4 b'' (p - c)(p - c)^T|`` [B, K, 3, 3] over each lane's
    candidates: two sums of the same n terms taken in any two orders
    differ by at most ``2 n 2^-24`` times these (float32)."""
    _check(xb, lane_alive, hits, tri)
    B, K, _ = xb.shape
    f = xb.new_zeros((B, K * 3))
    H = xb.new_zeros((B, K * 9))
    for bins, ft, Ht, _ in _pair_terms(xb, lane_alive, hits, tri, dhat,
                                       kappa):
        f.index_add_(0, bins, ft.abs().flatten(1))
        H.index_add_(0, bins, Ht.abs().flatten(1))
    return f.view(B, K, 3), H.view(B, K, 3, 3)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _kernels.load("mesh_barrier")
    lib.zpc_mesh_barrier.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.zpc_mesh_barrier.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    return _library()


def mesh_barrier(xb: torch.Tensor, lane_alive: torch.Tensor,
                 hits: torch.Tensor, tri: torch.Tensor, dhat: float,
                 kappa: float):
    """(fc [B, K, 3], Hc [B, K, 3, 3], work [4]) of the bins' lanes
    ``xb`` against their candidates ``hits`` among the triangles ``tri``.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    one launch per call, with no host read."""
    global LAUNCHES
    _check(xb, lane_alive, hits, tri)
    if xb.device.type == "cpu":
        return mesh_barrier_reference(xb, lane_alive, hits, tri, dhat, kappa)
    if xb.device.type != "cuda":
        raise ValueError(f"mesh_barrier runs on cpu or cuda tensors, not "
                         f"{xb.device}")
    B, K, _ = xb.shape
    if K != LANES:
        raise ValueError(f"the kernel takes bins of {LANES} lanes, got {K}")
    if xb.dtype != torch.float32 or tri.dtype != torch.float32:
        raise TypeError("the kernel takes float32 positions and triangles")
    if any(t.device != xb.device for t in (lane_alive, hits, tri)):
        raise ValueError("mesh_barrier's tensors must share one device")
    # a lane's three coordinates adjacent, the lanes at one stride (a view
    # of the state's columns passes as it is)
    if xb.stride(2) != 1 or xb.stride(0) != K * xb.stride(1):
        xb = xb.contiguous()
    lane_alive, hits, tri = (t.contiguous() for t in (lane_alive, hits, tri))
    fc = torch.empty((B, K, 3), dtype=torch.float32, device=xb.device)
    Hc = torch.empty((B, K, 3, 3), dtype=torch.float32, device=xb.device)
    work = torch.zeros((4,), dtype=torch.int64, device=xb.device)
    lib = _library()
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    _kernels.launch("mesh_barrier", lib.zpc_mesh_barrier, xb.device,
                    xb.data_ptr(), xb.stride(1), lane_alive.data_ptr(),
                    hits.data_ptr(), hits.shape[1], tri.data_ptr(),
                    tri.shape[0], B, dhat * dhat, kappa, fc.data_ptr(),
                    Hc.data_ptr(), work.data_ptr(), stream)
    LAUNCHES += 1
    return fc, Hc, work
