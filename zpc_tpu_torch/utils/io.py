"""Particle, mesh and state IO (counterpart of ``zpc_tpu/utils/io.py``).

Host-side Python and numpy: OBJ triangle meshes, legacy-VTK tet meshes,
the classic big-endian Bgeo particle format (partio's "BgeoV" version 5;
the same bytes as the JAX package's writer), npz checkpoints of the
port's state dataclasses, and :class:`AsyncIO`, a background thread that
writes while the card computes.  The bgeo records are packed with numpy
(``>f4``); the JAX package's optional C codec is not needed for that.
"""

from __future__ import annotations

import dataclasses
import io as _io
import queue
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "write_obj", "read_obj", "write_vtk_tets", "read_vtk_tets",
    "write_bgeo", "read_bgeo", "save_state", "load_state", "AsyncIO",
]


def _host(a) -> np.ndarray:
    """A host copy of a tensor (a copy on the CPU too), or the array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True).numpy()
    return np.asarray(a)


# -- OBJ triangle meshes ------------------------------------------------------

def write_obj(path: str, vertices, faces=None):
    v = _host(vertices)
    with open(path, "w") as f:
        for p in v:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        if faces is not None:
            for t in _host(faces):
                f.write("f " + " ".join(str(int(i) + 1) for i in t) + "\n")


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Vertices ``[n, 3]`` float32 and triangles ``[m, 3]`` int32 (polygons
    fan-triangulated, ``v/vt/vn`` references read by their vertex)."""
    vs, fs = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "f":
                idx = [int(w.split("/")[0]) - 1 for w in t[1:]]
                for k in range(1, len(idx) - 1):
                    fs.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(vs, np.float32),
            np.asarray(fs, np.int32) if fs else np.zeros((0, 3), np.int32))


# -- legacy VTK tet meshes ----------------------------------------------------

def write_vtk_tets(path: str, vertices, tets):
    v = _host(vertices).astype(np.float64)
    t = _host(tets).astype(np.int64)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nzpc_tpu tet mesh\nASCII\n"
                "DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(v)} double\n")
        for p in v:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        f.write(f"CELLS {len(t)} {len(t) * 5}\n")
        for c in t:
            f.write("4 " + " ".join(map(str, c.tolist())) + "\n")
        f.write(f"CELL_TYPES {len(t)}\n")
        f.write("\n".join(["10"] * len(t)) + "\n")


def read_vtk_tets(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, cells = [], []
    mode = None
    remaining = 0
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "POINTS":
                mode, remaining = "points", int(t[1])
                continue
            if t[0] == "CELLS":
                mode, remaining = "cells", int(t[1])
                continue
            if t[0] == "CELL_TYPES":
                mode = None
                continue
            if mode == "points" and remaining > 0:
                vals = list(map(float, t))
                for k in range(0, len(vals), 3):
                    verts.append(vals[k:k + 3])
                    remaining -= 1
            elif mode == "cells" and remaining > 0:
                if t[0] == "4":
                    cells.append(list(map(int, t[1:5])))
                remaining -= 1
    return np.asarray(verts, np.float32), np.asarray(cells, np.int32)


# -- classic Bgeo (partio "BgeoV", version 5) ---------------------------------

def write_bgeo(path: str, positions,
               attributes: Optional[Dict[str, object]] = None):
    """Points and float point attributes as a classic big-endian Bgeo:
    the header, one definition per attribute, then per point ``x y z w``
    (w = 1) and its attributes, then the end markers."""
    pos = _host(positions).astype(np.float32)
    n = len(pos)
    attrs = {k: _host(v).astype(np.float32).reshape(n, -1)
             for k, v in (attributes or {}).items()}
    buf = _io.BytesIO()
    w = buf.write
    w(b"BgeoV")
    # version, points, prims, point groups, prim groups, point attributes,
    # vertex attributes, prim attributes, detail attributes
    w(struct.pack(">9i", 5, n, 0, 0, 0, len(attrs), 0, 0, 0))
    for name, arr in attrs.items():
        nb = name.encode()
        size = arr.shape[1]
        w(struct.pack(">h", len(nb)))
        w(nb)
        w(struct.pack(">ii", size, 0))                 # size, FLOAT type
        w(struct.pack(f">{size}f", *([0.0] * size)))   # defaults
    cols = [pos, np.ones((n, 1), np.float32)] + list(attrs.values())
    w(np.concatenate(cols, axis=1).astype(">f4").tobytes())
    w(b"\x00\xff")                                     # end markers
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def read_bgeo(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(positions ``[n, 3]``, {name: ``[n, size]``}) of a classic Bgeo."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:5] != b"BgeoV":
        raise ValueError(f"not a classic bgeo: {raw[:5]!r}")
    off = 5
    _ver, n, _, _, _, nattr, _, _, _ = struct.unpack_from(">9i", raw, off)
    off += 36
    names, sizes = [], []
    for _ in range(nattr):
        ln, = struct.unpack_from(">h", raw, off)
        off += 2
        names.append(raw[off:off + ln].decode())
        off += ln
        size, _ = struct.unpack_from(">ii", raw, off)
        off += 8 + 4 * size
        sizes.append(size)
    width = 4 + sum(sizes)
    data = np.frombuffer(raw, dtype=">f4", count=n * width,
                         offset=off).reshape(n, width).astype(np.float32)
    out, col = {}, 4
    for name, size in zip(names, sizes):
        out[name] = data[:, col:col + size]
        col += size
    return data[:, :3], out


# -- state checkpoints --------------------------------------------------------

def _key(prefix: str, name) -> str:
    return f"{prefix}/{name}" if prefix else str(name)


def _leaves(obj, prefix=""):
    """(key path, leaf) of every tensor and number in a tree of the port's
    dataclasses, dicts, tuples and lists, in a fixed order."""
    if isinstance(obj, (torch.Tensor, bool, int, float)):
        yield prefix, obj
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _leaves(obj[k], _key(prefix, k))
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _leaves(v, _key(prefix, i))
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), _key(prefix, f.name))


def save_state(path: str, tree):
    """Checkpoint a tree of the port's dataclasses (an ``MPMState``, a
    ``BinState``, ...) to npz: every tensor and every number under its
    key path.  Tensors are copied to the host here."""
    flat = {}
    for key, leaf in _leaves(tree):
        flat[key] = _host(leaf) if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf)
    np.savez_compressed(path, **flat)


def _restore(obj, data, prefix=""):
    if isinstance(obj, torch.Tensor):
        return torch.from_numpy(data[prefix]).to(dtype=obj.dtype,
                                                 device=obj.device)
    if isinstance(obj, (bool, int, float)):
        return type(obj)(data[prefix][()])
    if isinstance(obj, dict):
        return {k: _restore(v, data, _key(prefix, k)) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_restore(v, data, _key(prefix, i))
                         for i, v in enumerate(obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _restore(getattr(obj, f.name), data,
                             _key(prefix, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def load_state(path: str, like):
    """Restore a checkpoint into the structure of ``like``: each tensor
    with ``like``'s dtype on ``like``'s device, each number as its type;
    what is neither (enums, level sets' static fields) is ``like``'s.  The
    key paths must match."""
    with np.load(path) as data:
        return _restore(like, data)


# -- background IO worker -----------------------------------------------------

class AsyncIO:
    """A background thread that runs write jobs in order (the reference's
    ``IO::instance`` queue).  Jobs that raise are printed and do not stop
    the worker; :meth:`wait` returns once every submitted job is done."""

    _instance: Optional["AsyncIO"] = None

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @classmethod
    def instance(cls) -> "AsyncIO":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                break
            fn, args, kwargs = job
            try:
                fn(*args, **kwargs)
            except Exception:  # pragma: no cover
                import traceback
                traceback.print_exc()
            finally:
                self._q.task_done()

    def submit(self, fn, *args, **kwargs):
        """Enqueue ``fn(*args, **kwargs)``.  Tensor arguments are copied to
        the host now (CPU tensors too), so the caller may overwrite them;
        the copy waits for the card's work on them."""
        host = [_host(a) if isinstance(a, torch.Tensor) else a for a in args]
        self._q.put((fn, host, kwargs))

    def wait(self):
        self._q.join()
