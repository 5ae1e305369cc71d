"""Build and load the port's hand-written CUDA kernels.

Each kernel lives in ``csrc/<name>.cu`` behind a plain C interface.  At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``_build/`` and loaded with :mod:`ctypes`; the library's file name
carries a hash of the source and the flags, so an edited source is rebuilt.
Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "load"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found on PATH or under CUDA_HOME={home}: the CUDA "
            "kernels are built at first use and need the CUDA toolkit")
    return str(path)


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it first
    if no library for the current source exists."""
    lib = _library_path(name)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build beside the target and rename: a concurrent build never sees
        # a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed to build {name}.cu ({res.returncode}):\n"
                f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
