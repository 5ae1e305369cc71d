"""One application of the implicit MPM system's operator for a
FixedCorotated solid in 3-D: the hand-written CUDA kernel and its plain
version.

The CG loop of :mod:`zpc_tpu_torch.sim.implicit_binned2` applies ``A u =
gm u + P2G(kscale dP(dt dC F) F^T + dt^2 Hc s0)`` to a node field ``u
[nb, 64, 3]``: G2P gathers ``s0 = sum w u`` and ``dC = D^-1 sum w u (x_i -
x_p)^T`` over each lane's 27 stencil nodes, ``dP`` is the stress
differential at the lane's F, ``kscale = dt D^-1 vol``, ``Hc`` the barrier
Hessian where there is mesh contact, and P2G scatters ``w (Q + A (x_i -
x_p))`` back.  :func:`corotated_system` gathers what stays fixed over a
step (the lanes, the SVD of F taken once, the bins' tables) and
:func:`implicit_apply` applies it.

The stress differential is FixedCorotated's in closed form around the SVD
(:func:`corotated_dP`): what ``torch.func.jvp`` of ``FixedCorotated.
_piola`` through ``math.svd._Svd3x3.jvp`` computes, without the jvp.

A system on the CPU takes :func:`implicit_apply_reference`; one on a CUDA
device launches the kernel in ``csrc/implicit_apply.cu`` or raises; it
never falls back to the plain version.  Replaces no TPU kernel: the JAX
package's operator (``zpc_tpu/sim/implicit_binned2.py``) is XLA ops.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _kernels
from ..math.svd import _PAIRS, _pair_inverses, _skew, svd3x3
from ..math.vecmat import cof3, mm33
from ..models.constitutive import bcast_scalar
from ..sim.mpm_binned2 import K

__all__ = ["LAUNCHES", "CorotatedSystem", "corotated_system",
           "corotated_dP", "implicit_apply", "implicit_apply_reference",
           "as_float64", "build"]

LAUNCHES = 0
"""Number of calls that launched the CUDA kernel (one per
:func:`implicit_apply` of a system on a CUDA device; the plain version
never counts)."""


class CorotatedSystem(NamedTuple):
    """What one implicit step's operator holds fixed: the transfer context
    ``ctx`` (a :class:`~zpc_tpu_torch.sim.mpm_binned2._Ctx`), the bin state's
    ``bin_block [bins]`` and ``nbr8 [nb, 8]`` (each bin's table slot and
    each slot's window blocks, which the kernel maps as ``_make_ctx``
    does), the lanes' positions ``x [L, 3]``, ``F [L, 3, 3]`` and volumes
    ``vol [L]`` (views of the state's columns), the SVD of F ``factors``
    (U, s, V), the Lame fields ``mu`` and ``lam`` (0-d, or ``[L]`` in lane
    order), the barrier Hessian ``Hc [L, 3, 3]`` or None, the grid mass
    ``gm [nb, 64]`` and ``dt``."""

    ctx: object
    bin_block: torch.Tensor
    nbr8: torch.Tensor
    x: torch.Tensor
    F: torch.Tensor
    vol: torch.Tensor
    factors: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    mu: torch.Tensor
    lam: torch.Tensor
    Hc: Optional[torch.Tensor]
    gm: torch.Tensor
    dt: float


def corotated_system(ctx, bin_block: torch.Tensor, nbr8: torch.Tensor,
                     x: torch.Tensor, F: torch.Tensor, vol: torch.Tensor,
                     mu: torch.Tensor, lam: torch.Tensor,
                     Hc: Optional[torch.Tensor], gm: torch.Tensor,
                     dt: float) -> CorotatedSystem:
    """The step's :class:`CorotatedSystem`, with the SVD of F taken once
    (the rotation convention of :func:`~zpc_tpu_torch.math.svd.svd3x3`).
    ``dt`` is a number."""
    if F.shape[-2:] != (3, 3):
        raise ValueError(f"the operator is 3-D, got F {tuple(F.shape)}")
    return CorotatedSystem(ctx, bin_block, nbr8, x, F, vol, svd3x3(F), mu,
                           lam, Hc, gm, float(dt))


def as_float64(sys: CorotatedSystem) -> CorotatedSystem:
    """The system and its context's weights, offsets and ``D^-1`` in
    float64: :func:`implicit_apply_reference` of it and of ``u.double()``
    carries no float32 rounding worth the name, a reading to hold the
    float32 versions to."""
    d = lambda t: None if t is None else t.double()  # noqa: E731
    ctx = dataclasses.replace(sys.ctx, w3=d(sys.ctx.w3),
                              xdiff=d(sys.ctx.xdiff), dinv=d(sys.ctx.dinv))
    return sys._replace(ctx=ctx, x=d(sys.x), F=d(sys.F), vol=d(sys.vol),
                        factors=tuple(d(f) for f in sys.factors),
                        mu=d(sys.mu), lam=d(sys.lam), Hc=d(sys.Hc),
                        gm=d(sys.gm))


def _dcof3(F: torch.Tensor, dF: torch.Tensor) -> torch.Tensor:
    """The differential of :func:`~zpc_tpu_torch.math.vecmat.cof3` at F
    along dF, column by column."""
    cols = []
    for a, b in ((1, 2), (2, 0), (0, 1)):
        cols.append(torch.linalg.cross(dF[..., :, a], F[..., :, b], dim=-1) +
                    torch.linalg.cross(F[..., :, a], dF[..., :, b], dim=-1))
    return torch.stack(cols, -1)


def corotated_dP(F: torch.Tensor, factors, dF: torch.Tensor,
                 mu: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """FixedCorotated's ``dP(F)[dF]`` in closed form around ``factors``,
    the SVD (U, s, V) of F: with ``P = U^T dF V``, ``ds_i = P_ii``, ``dR =
    U skew((P_ij - P_ji) b_ij) V^T`` (``b_ij`` the clamped ``1 / (s_i +
    s_j)`` of :func:`~zpc_tpu_torch.math.svd._pair_inverses`) and ``dP = 2
    mu (dF - dR) + lam (dJ cof F + (J - 1) dcof(F)[dF])``, ``J = s_0 s_1
    s_2``.  ``mu``, ``lam``: 0-d or one per F."""
    U, s, V = factors
    P = mm33(mm33(U.transpose(-1, -2), dF), V)
    xmy = [(P[..., i, j] - P[..., j, i]) * b
           for (i, j), (_, b) in zip(_PAIRS, _pair_inverses(s))]
    dR = mm33(mm33(U, _skew(*xmy)), V.transpose(-1, -2))
    s0, s1, s2 = s.unbind(-1)
    d0, d1, d2 = P[..., 0, 0], P[..., 1, 1], P[..., 2, 2]
    J = s0 * s1 * s2
    dJ = (d0 * s1 + s0 * d1) * s2 + s0 * s1 * d2
    lam = bcast_scalar(lam, J)
    return (2.0 * bcast_scalar(mu, F)) * (dF - dR) + (
        (lam * dJ)[..., None, None] * cof3(F) +
        (lam * (J - 1.0))[..., None, None] * _dcof3(F, dF))


def implicit_apply_reference(sys: CorotatedSystem,
                             u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``A u`` ``[nb, 64, 3]``: the kernel's arithmetic with
    the stencil's weights, offsets and flat node indices read from the
    step's context (the kernel rebuilds them with the same expressions),
    and the sums taken by ``bmm`` and ``index_add_``."""
    ctx = sys.ctx
    nb, nc = u.shape[0], u.shape[1]
    uf = torch.cat([u.reshape(nb * nc, 3), u.new_zeros((1, 3))])
    wv = ctx.w3[..., None] * uf[ctx.flat]                      # [L, 27, 3]
    s0 = wv.sum(1)
    dC = ctx.dinv * torch.bmm(wv.transpose(1, 2), ctx.xdiff)
    dP = corotated_dP(sys.F, sys.factors, sys.dt * mm33(dC, sys.F), sys.mu,
                      sys.lam)
    A = (sys.dt * ctx.dinv * sys.vol)[:, None, None] * mm33(
        dP, sys.F.transpose(-1, -2))
    Ax = torch.bmm(ctx.xdiff, A.transpose(1, 2))               # [L, 27, 3]
    if sys.Hc is not None:
        Q = (sys.dt * sys.dt) * torch.bmm(sys.Hc, s0[..., None])[..., 0]
        Ax = Q[:, None, :] + Ax
    acc = u.new_zeros((nb * nc + 1, 3))
    acc.index_add_(0, ctx.flat.reshape(-1),
                   (ctx.w3[..., None] * Ax).reshape(-1, 3))
    return sys.gm[..., None] * u + acc[:nb * nc].view(nb, nc, 3)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _kernels.load("implicit_apply")
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.zpc_implicit_apply.argtypes = [
        p, p, i, p, ll, p, ll, p, ll, p, p, p, p, p, i, p, i, p, p, p, i, p,
        p, p, p, ll, f, f, p]
    lib.zpc_implicit_apply.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    return _library()


def _lane_field(v: torch.Tensor, L: int, dev) -> Tuple[torch.Tensor, int]:
    """A Lame field as the kernel reads it: (float32 tensor, lane
    stride)."""
    v = torch.as_tensor(v).to(dev, torch.float32)
    if v.numel() == 1:
        return v.reshape(1), 0
    if tuple(v.shape) != (L,):
        raise ValueError(f"a per-lane Lame field must be [{L}], got "
                         f"{tuple(v.shape)}")
    return v.contiguous(), 1


def _rows(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` as ``[L, width]`` rows, each row's values adjacent (a view of
    the state's columns passes as it is)."""
    r = t.reshape(t.shape[0], width)
    return r if width == 1 or r.stride(1) == 1 else r.contiguous()


def implicit_apply(sys: CorotatedSystem, u: torch.Tensor) -> torch.Tensor:
    """``A u`` ``[nb, 64, 3]`` of the node field ``u``.  A system on the
    CPU takes the plain version; one on a CUDA device launches the kernel,
    one launch per call (beside the ``gm u`` it starts from), with no host
    read."""
    global LAUNCHES
    if sys.x.device.type == "cpu":
        return implicit_apply_reference(sys, u)
    if sys.x.device.type != "cuda":
        raise ValueError(f"implicit_apply runs on cpu or cuda tensors, not "
                         f"{sys.x.device}")
    L = sys.x.shape[0]
    if L % K:
        raise ValueError(f"the kernel takes bins of {K} lanes (one thread "
                         f"each), got {L} lanes")
    ctx, dev = sys.ctx, sys.x.device
    origin = ctx.grid.origin
    floats = (u, sys.x, sys.F, sys.vol, *sys.factors, sys.gm, ctx.dinv,
              ctx.dx, origin) + (() if sys.Hc is None else (sys.Hc,))
    ints = (sys.bin_block, sys.nbr8, ctx.borigin_l)
    if any(t.dtype != torch.float32 or t.device != dev for t in floats) or \
            any(t.dtype != torch.int32 or t.device != dev for t in ints):
        raise TypeError("the kernel takes float32 fields and int32 tables on "
                        "one device")
    x, F, vol = _rows(sys.x, 3), _rows(sys.F, 9), _rows(sys.vol, 1)
    U, s, V = (t.contiguous() for t in sys.factors)
    mu, mu_stride = _lane_field(sys.mu, L, dev)
    lam, lam_stride = _lane_field(sys.lam, L, dev)
    Hc = None if sys.Hc is None else sys.Hc.contiguous()
    bin_block, nbr8, borigin, alive = (t.contiguous() for t in (
        sys.bin_block, sys.nbr8, ctx.borigin_l, ctx.alive))
    u = u.contiguous()
    out = sys.gm[..., None] * u
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _kernels.launch(
        "implicit_apply", lib.zpc_implicit_apply, dev, u.data_ptr(),
        out.data_ptr(), L // K, x.data_ptr(), x.stride(0),
        F.data_ptr(), F.stride(0), vol.data_ptr(), vol.stride(0),
        alive.data_ptr(), U.data_ptr(), s.data_ptr(), V.data_ptr(),
        mu.data_ptr(), mu_stride, lam.data_ptr(), lam_stride,
        None if Hc is None else Hc.data_ptr(), bin_block.data_ptr(),
        nbr8.data_ptr(), u.shape[0], borigin.data_ptr(), ctx.dinv.data_ptr(),
        ctx.dx.data_ptr(), origin.data_ptr(), origin.stride(0), sys.dt,
        sys.dt * sys.dt, stream)
    LAUNCHES += 1
    return out
