"""ctypes bindings of the native host runtime (counterpart of
``zpc_tpu/utils/native.py``): ``zpc_tpu_torch/native/host_ops.cpp``.

The library speeds up host-side loops (bgeo record packing, morton keys, a
host radix sort, an arena allocator) and is optional: it is compiled with
``g++`` at first use into ``zpc_tpu_torch/_build/`` (gitignored), under a
file name that carries the source's hash, so only a library built from the
checked-in source is ever loaded.  Without a compiler :func:`load` gives
None and :func:`available` False; :func:`morton3d_host` and
:func:`radix_sort_pairs_host` then compute the same result in PyTorch and
numpy, and the record packers return None (the port's bgeo writer packs
with numpy, byte for byte the same records).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

__all__ = ["load", "available", "morton3d_host", "radix_sort_pairs_host",
           "pack_be_records", "unpack_be_records"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "host_ops.cpp"
_BUILD = _PKG / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def _build() -> Optional[Path]:
    """Compile host_ops.cpp (once per source hash); None when the compiler
    is missing or fails."""
    tag = hashlib.sha256(_SRC.read_bytes() +
                         " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD / f"libzpc_host-{tag}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: a concurrent build never sees a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
    i64, cint, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    sigs = {
        "zpc_pack_be_records": ([ctypes.POINTER(f32p), ctypes.POINTER(cint),
                                 cint, i64, f32p], None),
        "zpc_unpack_be_records": ([f32p, ctypes.POINTER(cint), cint, i64,
                                   ctypes.POINTER(f32p)], None),
        "zpc_morton3d": ([i32p, i64, i32p], None),
        "zpc_radix_sort_pairs_i32": ([i32p, i32p, i64, cint, cint], None),
        "zpc_arena_create": ([i64], vp),
        "zpc_arena_alloc": ([vp, i64, i64], vp),
        "zpc_arena_reset": ([vp], None),
        "zpc_arena_destroy": ([vp], None),
        "zpc_abi_version": ([], cint),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first call), or None without a
    compiler."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            path = _build()
            if path is not None:
                lib = _declare(ctypes.CDLL(str(path)))
                if lib.zpc_abi_version() != 1:
                    raise RuntimeError(f"{path}: ABI version "
                                       f"{lib.zpc_abi_version()}, not 1")
                _LIB = lib
        return _LIB


def available() -> bool:
    return load() is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def morton3d_host(coords: np.ndarray) -> np.ndarray:
    """Host morton keys (int32) of int coords ``[n, 3]`` in [0, 1024)."""
    coords = np.ascontiguousarray(coords, np.int32).reshape(-1, 3)
    lib = load()
    if lib is None:
        from ..math.bits import morton3d
        return morton3d(torch.from_numpy(coords)).numpy()
    out = np.empty(len(coords), np.int32)
    lib.zpc_morton3d(_i32p(coords), len(coords), _i32p(out))
    return out


def radix_sort_pairs_host(keys: np.ndarray, vals: np.ndarray,
                          sbit: int = 0, ebit: int = 32):
    """Stable LSD radix sort of int32 (key, value) pairs on the key bits
    ``[sbit, ebit)``; returns the sorted (keys, values)."""
    keys = np.ascontiguousarray(keys, np.int32)
    vals = np.ascontiguousarray(vals, np.int32)
    if len(keys) != len(vals):
        raise ValueError(f"{len(keys)} keys, {len(vals)} values")
    if not 0 <= sbit <= ebit <= 32:
        raise ValueError(f"bit window [{sbit}, {ebit}) outside [0, 32)")
    lib = load()
    if lib is None:
        w = keys.astype(np.uint32) >> np.uint32(sbit)
        if ebit - sbit < 32:
            w = w & np.uint32((1 << (ebit - sbit)) - 1)
        order = np.argsort(w, kind="stable")
        return keys[order], vals[order]
    lib.zpc_radix_sort_pairs_i32(_i32p(keys), _i32p(vals), len(keys), sbit,
                                 ebit)
    return keys, vals


def _parts(n_parts, widths):
    arr_t = ctypes.POINTER(ctypes.c_float) * n_parts
    return arr_t, (ctypes.c_int * len(widths))(*widths)


def pack_be_records(cols, widths) -> Optional[np.ndarray]:
    """Float columns (``[n, w_p]`` each) interleaved into big-endian
    records ``[n, sum(w)]``; None without the library."""
    lib = load()
    if lib is None:
        return None
    n = len(cols[0])
    cols = [np.ascontiguousarray(c, np.float32).reshape(n, -1)
            for c in cols]
    if [c.shape[1] for c in cols] != list(widths):
        raise ValueError(f"column widths {[c.shape[1] for c in cols]}, "
                         f"not {list(widths)}")
    out = np.empty((n, sum(widths)), np.float32)
    arr_t, w_t = _parts(len(cols), widths)
    lib.zpc_pack_be_records(arr_t(*[_f32p(c) for c in cols]), w_t,
                            len(cols), n, _f32p(out))
    return out


def unpack_be_records(records: np.ndarray, widths):
    """Big-endian records ``[n, sum(w)]`` -> little-endian float columns;
    None without the library."""
    lib = load()
    if lib is None:
        return None
    records = np.ascontiguousarray(records, np.float32)
    n = len(records)
    if records.reshape(n, -1).shape[1] != sum(widths):
        raise ValueError(f"records of width {records.reshape(n, -1).shape[1]}"
                         f", not {sum(widths)}")
    cols = [np.empty((n, w), np.float32) for w in widths]
    arr_t, w_t = _parts(len(cols), widths)
    lib.zpc_unpack_be_records(_f32p(records), w_t, len(cols), n,
                              arr_t(*[_f32p(c) for c in cols]))
    return cols
