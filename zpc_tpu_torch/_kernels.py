"""Build and load the port's hand-written CUDA kernels.

Each kernel lives in ``csrc/<name>.cu`` behind a plain C interface.  At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``_build/`` and loaded with :mod:`ctypes`; the library's file name
carries a hash of the source and the flags, so an edited source is rebuilt,
and what ``ptxas -v`` said of it (registers, shared memory, spills) is kept
beside it (:func:`ptxas_report`).  Nothing here runs at import time: the CPU
tests import every module on a machine with no ``nvcc``.

:class:`Workspace` is the scratch of the single-pass look-back kernels and
:class:`Library` a loaded kernel library with the workspace layout it
reports.
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
from typing import NamedTuple

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "KERNEL_FLAGS", "HEADER_WORDS",
           "EPOCH_LIMIT", "Library", "Workspace", "load", "launch",
           "ptxas_report"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one kernel beside NVCC_FLAGS: the mesh barrier keeps its
# products and sums apart (no fused multiply-add), as the plain version's
# one operator at a time does, so both evaluate a pair alike.  Fused, the
# kernel took 7% less time on an H100 at the 100,352-triangle terrain, but
# 237 of 5,313 lanes in reach then read more than 1e-4 of their largest
# force entry away from the plain version (up to 3.7e-2: lanes whose terms
# all lie near d = dhat, where (d^2 - dhat^2)^2 has no relative bound)
KERNEL_FLAGS = {"mesh_barrier": ("-fmad=false",)}


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


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
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
        cmd = [_nvcc(), *_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed to build {name}.cu ({res.returncode}):\n"
                f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        lib.with_suffix(".ptxas.txt").write_text(res.stdout + res.stderr)
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the C entry ``fn`` of kernel ``name`` with ``args`` on
    ``device`` (entering a device guard only when it is not the current
    device), and raise when it returns a cudaError_t other than 0: a launch
    the runtime refused never runs, and no later synchronise reports it."""
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` printed when ``csrc/<name>.cu`` was built (after
    :func:`load`): each kernel's registers, shared memory and spills."""
    return _library_path(name).with_suffix(".ptxas.txt").read_text()


class Library(NamedTuple):
    """A loaded kernel library and its workspace layout, as the library
    reports it."""

    lib: ctypes.CDLL
    tile: int            # elements per tile (the smaller, if it has two)
    slot_words: int      # workspace words per tile, past the header

    def status_words(self, n: int) -> int:
        """Workspace words past the header that a call on ``n`` elements
        needs: 0 when ``n`` fits one tile, which takes no workspace."""
        return 0 if n <= self.tile else -(-n // self.tile) * self.slot_words


# The header both csrc/ look-back kernels keep at the start of their
# workspace, int32 words [ticket, done, epoch, unused]; every status past it
# is tagged (epoch << 2) | flag, and the epoch counts mod EPOCH_LIMIT.
HEADER_WORDS = 4
EPOCH_LIMIT = 1 << 30
_EPOCH = 2


class Workspace:
    """Scratch of a single-pass look-back kernel, one int32 tensor per
    (device, stream): the header and then the tiles' statuses.

    A tensor is zeroed when it is made, and made anew (so zeroed again) when
    a call needs more words than it holds.  The kernel itself resets the
    header's two counters and advances its epoch at the end of every launch,
    so a call costs no host work past the dictionary lookup.

    Two arguments serve tests of the epoch's wrap only: ``epoch`` is the
    epoch each new tensor starts at (0, or just below :data:`EPOCH_LIMIT`),
    and ``stale`` fills each new tensor past the header with words below 12,
    which read as statuses of epochs 0, 1 and 2 with a valid flag: the
    launch that wraps the epoch must zero them."""

    def __init__(self, epoch: int = 0, stale: bool = False):
        if not 0 <= epoch < EPOCH_LIMIT:
            raise ValueError(f"epoch must be in [0, 2^30), got {epoch}")
        self.epoch = epoch
        self.stale = stale
        self._bufs: dict[tuple, torch.Tensor] = {}

    def get(self, device: torch.device, stream: int,
            words: int) -> torch.Tensor:
        """The tensor for ``stream`` on ``device``, with at least ``words``
        words past the header and a power of two in all (made on
        ``device``'s current stream, which should be ``stream``)."""
        key = (device.type, device.index, stream)
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < HEADER_WORDS + words:
            size = 1 << (HEADER_WORDS + words - 1).bit_length()
            buf = torch.zeros(size, dtype=torch.int32, device=device)
            if self.stale:
                gen = torch.Generator(device=device).manual_seed(0)
                buf[HEADER_WORDS:] = torch.randint(
                    0, 12, (size - HEADER_WORDS,), generator=gen,
                    dtype=torch.int32, device=device)
            buf[_EPOCH] = self.epoch
            self._bufs[key] = buf
        return buf

    @staticmethod
    def header(buf: torch.Tensor) -> tuple[int, int, int]:
        """(ticket, done, epoch) of a workspace tensor."""
        return tuple(buf[:_EPOCH + 1].tolist())
