"""1-D prefix scans: the hand-written CUDA kernel and its plain version.

:func:`scan` is the entry point.  A tensor on the CPU goes to
:func:`scan_reference` (``torch.cumsum``/``cummax``/``cummin``).  A tensor on
a CUDA device launches the kernel in ``csrc/scan.cu`` or raises; it never
falls back to the plain version.

Counterpart of ``zpc_tpu/ops/scan_pallas.py:scan_pallas``: the same op set
(add, max, min, inclusive; exclusive add with zero start), the same dtypes
(int32, uint32, float32) and the same mod-2^32 wrap for integer add.  The
TPU kernel needs n >= 131,072 (its chunk); this one takes any n >= 1.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels

__all__ = ["OPS", "LAUNCHES", "scan", "scan_reference"]

OPS = ("add", "max", "min")
_OPCODE = {"add": 0, "max": 1, "min": 2}
_DTYPE = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}

LAUNCHES = 0
"""Number of calls that launched the CUDA kernel (one per :func:`scan` on a
CUDA tensor; the plain version never counts)."""


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


def _library() -> ctypes.CDLL:
    lib = _kernels.load("scan")
    lib.zpc_scan_tile.argtypes = []
    lib.zpc_scan_tile.restype = ctypes.c_int
    lib.zpc_scan.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.zpc_scan.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _library()


def scan(x: torch.Tensor, op: str = "add",
         exclusive: bool = False) -> torch.Tensor:
    """Inclusive scan of a 1-D tensor for op in add/max/min; exclusive scan
    (zero start) for add.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
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
    lib = _library()
    tile = lib.zpc_scan_tile()
    tiles = -(-n // tile)
    out = torch.empty_like(x)
    partial = torch.empty((tiles if tiles > 1 else 0,), dtype=x.dtype,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.zpc_scan(x.data_ptr(), out.data_ptr(),
                           partial.data_ptr() if tiles > 1 else None, n,
                           _DTYPE[x.dtype], _OPCODE[op], int(exclusive),
                           stream)
    if err != 0:
        raise RuntimeError(f"scan kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out
