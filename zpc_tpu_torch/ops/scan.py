"""1-D prefix scans: the hand-written CUDA kernel and its plain version.

:func:`scan` is the entry point.  A tensor on the CPU goes to
:func:`scan_reference` (``torch.cumsum``/``cummax``/``cummin``).  A tensor on
a CUDA device launches the kernel in ``csrc/scan.cu`` or raises; it never
falls back to the plain version.

Counterpart of ``zpc_tpu/ops/scan_pallas.py:scan_pallas``: the same op set
(add, max, min, inclusive; exclusive add with zero start), the same dtypes
(int32, uint32, float32) and the same mod-2^32 wrap for integer add.  The
TPU kernel needs n >= 131,072 (its chunk); this one takes any n >= 1, in one
launch (a single-pass chained scan with decoupled look-back).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels

__all__ = ["OPS", "LAUNCHES", "WORKSPACE", "scan", "scan_reference", "build"]

OPS = ("add", "max", "min")
_OPCODE = {"add": 0, "max": 1, "min": 2}
_DTYPE = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}

LAUNCHES = 0
"""Number of calls that launched the CUDA kernel (one per :func:`scan` on a
CUDA tensor; the plain version never counts)."""

WORKSPACE = _kernels.Workspace()
"""The look-back scratch of every call on more than one tile, per (device,
stream), sized by the layout ``csrc/scan.cu`` reports."""


def _check(x: torch.Tensor, op: str, exclusive: bool) -> None:
    if op not in OPS:
        raise ValueError(f"scan op must be one of {OPS}, got {op!r}")
    if exclusive and op != "add":
        raise ValueError("exclusive scans are defined for op='add' only")
    if x.dim() != 1:
        raise ValueError(
            f"scan takes a 1-D tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE:
        raise TypeError(f"scan takes int32, uint32 or float32, got {x.dtype}")


def scan_reference(x: torch.Tensor, op: str = "add",
                   exclusive: bool = False) -> torch.Tensor:
    """Plain PyTorch scan with the kernel's semantics."""
    _check(x, op, exclusive)
    if x.numel() == 0:
        return x.clone()
    if x.dtype == torch.float32:
        w = x
    else:
        w = x.to(torch.int64)       # cumsum/cummax of 32-bit ints, then wrap
    if op == "add":
        r = torch.cumsum(w, 0)
    elif op == "max":
        r = torch.cummax(w, 0).values
    else:
        r = torch.cummin(w, 0).values
    if exclusive:
        r = torch.cat([torch.zeros_like(r[:1]), r[:-1]])
    if x.dtype != torch.float32:
        r = r & 0xFFFFFFFF
        if x.dtype == torch.int32:
            r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(x.dtype)


@functools.cache
def _library() -> _kernels.Library:
    lib = _kernels.load("scan")
    lib.zpc_scan.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    lib.zpc_scan.restype = ctypes.c_int
    return _kernels.Library(lib, lib.zpc_scan_tile(),
                            lib.zpc_scan_slot_words())


def build() -> _kernels.Library:
    """Compile (if needed) and load the kernel library; returns it with
    its workspace layout."""
    return _library()


def scan(x: torch.Tensor, op: str = "add",
         exclusive: bool = False) -> torch.Tensor:
    """Inclusive scan of a 1-D tensor for op in add/max/min; exclusive scan
    (zero start) for add.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, one launch per call."""
    global LAUNCHES
    _check(x, op, exclusive)
    if x.device.type == "cpu":
        return scan_reference(x, op, exclusive)
    if x.device.type != "cuda":
        raise ValueError(f"scan runs on cpu or cuda tensors, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("scan kernel needs a contiguous tensor")
    n = x.numel()
    if n == 0:
        raise ValueError("scan kernel needs n >= 1")
    kern = _library()
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(x)
    words = kern.status_words(n)
    ws = WORKSPACE.get(dev, stream, words) if words else None
    _kernels.launch("scan", kern.lib.zpc_scan, dev, x.data_ptr(),
                    out.data_ptr(), None if ws is None else ws.data_ptr(),
                    0 if ws is None else ws.numel(), n, _DTYPE[x.dtype],
                    _OPCODE[op], int(exclusive), stream)
    LAUNCHES += 1
    return out
