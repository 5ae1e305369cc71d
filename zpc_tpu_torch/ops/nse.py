"""Packed nearest-smaller-element sweep: the hand-written CUDA kernel and
its plain version.

For each position ``i`` of an int32 array ``d`` with values in [1, 63],
the nearest ``j < i`` with ``d[j] <= d[i]`` (``strict``: ``d[j] < d[i]``),
returned as ``(j << 6) | d[j]``, or :data:`NONE` when there is none.  Two
such sweeps give the Karras topology of the LBVH
(:func:`zpc_tpu_torch.containers.bvh._karras_topology`).

:func:`nse` is the entry point.  A tensor on the CPU goes to
:func:`nse_reference`; a tensor on a CUDA device launches the kernel in
``csrc/nse.cu`` or raises; it never falls back to the plain version.

Counterpart of ``zpc_tpu/ops/nse_pallas.py:nse_pallas`` (same contract and
sentinel), which needs 4,096 <= g < 2^24; this one takes any 1 <= g < 2^24,
in one launch (a single pass with decoupled look-back).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels

__all__ = ["NONE", "LAUNCHES", "WORKSPACE", "nse", "nse_reference", "build"]

NONE = -(1 << 30)
MAX_G = 1 << 24           # positions must fit 24 bits: (j << 6) < 2^30
_CHUNK = 8192             # positions per step of the plain version

LAUNCHES = 0
"""Number of calls that launched the CUDA kernel (one per :func:`nse` on a
CUDA tensor; the plain version never counts)."""

WORKSPACE = _kernels.Workspace()
"""The look-back scratch of every call on more than one tile, per (device,
stream), sized by the layout ``csrc/nse.cu`` reports."""


def _check(d: torch.Tensor) -> None:
    if d.dim() != 1:
        raise ValueError(f"nse takes a 1-D tensor, got shape {tuple(d.shape)}")
    if d.dtype != torch.int32:
        raise TypeError(f"nse takes int32, got {d.dtype}")
    if not 1 <= d.numel() < MAX_G:
        raise ValueError(f"nse needs 1 <= g < 2^24 elements, got {d.numel()}")


def nse_reference(d: torch.Tensor, strict: bool = False) -> torch.Tensor:
    """Plain PyTorch sweep, the torch form of ``zpc_tpu``'s
    ``_nse_dir_chunked``: chunks of C positions, a ``[64, C]`` block of
    masked packed positions, ``cummax`` along positions and then values,
    and a 64-wide carry of the last position of each value from chunk to
    chunk."""
    _check(d)
    g = d.numel()
    C = min(_CHUNK, -(-g // 128) * 128)
    n_pad = -(-g // C) * C
    dp = torch.cat([d, d.new_zeros(n_pad - g)])
    viota = torch.arange(64, dtype=torch.int32, device=d.device)[:, None]
    none = torch.tensor(NONE, dtype=torch.int32, device=d.device)
    carry = torch.full((64,), NONE, dtype=torch.int32, device=d.device)
    out = []
    for off in range(0, n_pad, C):
        dc = dp[off:off + C]
        pos = torch.arange(off, off + C, dtype=torch.int32, device=d.device)
        mask = (viota == dc[None, :]) & (pos < g)[None, :]
        packed = torch.where(mask, (pos << 6) | dc[None, :], none)
        p = torch.cummax(packed, dim=1).values
        p_excl = torch.cat([torch.full_like(p[:, :1], NONE), p[:, :-1]], 1)
        f = torch.cummax(torch.maximum(p_excl, carry[:, None]), dim=0).values
        w = dc - (1 if strict else 0)
        sel = torch.gather(f, 0, w.clamp(0, 63).long()[None, :])[0]
        # a value outside [0, 63] gets NONE, as it never answers
        inside = (dc >= 0) & (dc <= 63) & (w >= 0)
        out.append(torch.where(inside, sel, none))
        carry = torch.maximum(carry, p[:, -1])
    return torch.cat(out)[:g]


@functools.cache
def _library() -> _kernels.Library:
    lib = _kernels.load("nse")
    lib.zpc_nse.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p]
    lib.zpc_nse.restype = ctypes.c_int
    return _kernels.Library(lib, lib.zpc_nse_tile(), lib.zpc_nse_slot_words())


def build() -> _kernels.Library:
    """Compile (if needed) and load the kernel library; returns it with
    its workspace layout."""
    return _library()


def nse(d: torch.Tensor, strict: bool = False) -> torch.Tensor:
    """Packed nearest-smaller-element of a 1-D int32 tensor with values in
    [1, 63]; see the module docstring.  CPU tensors take the plain version;
    CUDA tensors launch the kernel, one launch per call."""
    global LAUNCHES
    _check(d)
    if d.device.type == "cpu":
        return nse_reference(d, strict)
    if d.device.type != "cuda":
        raise ValueError(f"nse runs on cpu or cuda tensors, not {d.device}")
    if not d.is_contiguous():
        raise ValueError("nse kernel needs a contiguous tensor")
    g = d.numel()
    kern = _library()
    dev = d.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(d)
    words = kern.status_words(g)
    ws = WORKSPACE.get(dev, stream, words) if words else None
    _kernels.launch("nse", kern.lib.zpc_nse, dev, d.data_ptr(),
                    out.data_ptr(), None if ws is None else ws.data_ptr(),
                    0 if ws is None else ws.numel(), g, int(strict), stream)
    LAUNCHES += 1
    return out
