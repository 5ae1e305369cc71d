"""VDB-lite: a pure-Python OpenVDB ``.vdb`` codec for float, int32 and
Vec3s grids (the port's own copy of ``zpc_tpu/utils/vdb.py``, numpy and
zlib only; the two packages write the same bytes and read each other's
files).

It replaces the reference's OpenVDB bridge (``geometry/VdbLevelSet.h:
26-99``, with the ``readVelVdb`` Vec3fGrid velocity surface,
``VdbLevelSet_Conversion.cpp``, ``SparseGrid_Conversion.cpp``) with a
dependency-free reader and writer of the standard 5-4-3 ``FloatGrid`` /
``Int32Grid`` / ``Vec3SGrid`` trees (leaf 8^3, internal 16^3 / 32^3), so
that assets round-trip between the port's
:class:`~zpc_tpu_torch.geometry.sparse_grid.SparseGrid` and
:class:`~zpc_tpu_torch.geometry.adaptive_grid.AdaptiveGrid` and DCC tools
(see :mod:`zpc_tpu_torch.geometry.vdb_bridge`).

The stream follows the published OpenVDB file format (a version-221
stream; value buffers uncompressed or zlib-compressed; blosc is not
supported).  The reader validates the magic, the version and the tree type
and raises ``VdbFormatError`` with context on anything it does not
understand.

The 5-4-3 tree: root -> Internal2 (32^3 children, spans 4096 voxels) ->
Internal1 (16^3, spans 128) -> Leaf (8^3).
"""

from __future__ import annotations

import dataclasses
import io
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["VdbGrid", "VdbFormatError", "read_vdb", "write_vdb",
           "dense_to_leaves", "leaves_to_dense"]

MAGIC = 0x56444220                  # int64 " BDV" -> "VDB "
FILE_VERSION = 221                  # pre-node-mask-compression stream
LIB_MAJOR, LIB_MINOR = 8, 1

LEAF_LOG2, INT1_LOG2, INT2_LOG2 = 3, 4, 5
LEAF_DIM = 1 << LEAF_LOG2           # 8
INT1_DIM = 1 << INT1_LOG2           # 16
INT2_DIM = 1 << INT2_LOG2           # 32
LEAF_SIZE = LEAF_DIM ** 3           # 512
INT1_SIZE = INT1_DIM ** 3           # 4096
INT2_SIZE = INT2_DIM ** 3           # 32768
INT1_SPAN = LEAF_DIM * INT1_DIM     # 128 voxels
INT2_SPAN = INT1_SPAN * INT2_DIM    # 4096 voxels

COMPRESS_NONE = 0
COMPRESS_ZIP = 1

# tree type -> (element dtype, vector width).  Vec3s covers the
# reference's velocity-grid surface (VdbLevelSet.h:26-99 readVelVdb /
# readMeshVdb load Vec3fGrid alongside FloatGrid).
_TREE_TYPES = {"Tree_float_5_4_3": (np.float32, 1),
               "Tree_int32_5_4_3": (np.int32, 1),
               "Tree_vec3s_5_4_3": (np.float32, 3)}


class VdbFormatError(ValueError):
    pass


@dataclasses.dataclass
class VdbGrid:
    """One grid: sparse 8^3 leaves keyed by leaf-origin voxel coord.

    ``transform`` is (voxel_size, translation): world = ijk*voxel_size + t.
    ``masks`` (optional) holds per-leaf active-voxel booleans.
    ``vec`` is the per-voxel vector width: 1 for float/int32 grids
    (leaves [8,8,8]), 3 for Vec3s grids (leaves [8,8,8,3], background a
    3-sequence).
    """

    name: str
    leaves: Dict[Tuple[int, int, int], np.ndarray]    # [8,8,8(,vec)]
    voxel_size: float = 1.0
    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    background: object = 0.0
    grid_class: str = "unknown"     # "level set" / "fog volume" / "unknown"
    masks: Optional[Dict[Tuple[int, int, int], np.ndarray]] = None
    dtype: np.dtype = np.float32
    vec: int = 1

    def mask_for(self, origin) -> np.ndarray:
        if self.masks is not None and origin in self.masks:
            return self.masks[origin]
        active = self.leaves[origin] != np.asarray(self.background)
        if self.vec > 1:
            active = np.any(active, axis=-1)
        return active


# --------------------------------------------------------------------------
# low-level stream helpers
# --------------------------------------------------------------------------

def _w_str(f, s: str):
    b = s.encode("utf-8")
    f.write(struct.pack("<I", len(b)))
    f.write(b)


def _r_str(f) -> str:
    (n,) = struct.unpack("<I", _take(f, 4))
    if n > (1 << 24):
        raise VdbFormatError(f"implausible string length {n}")
    return _take(f, n).decode("utf-8")


def _take(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise VdbFormatError(f"truncated stream: wanted {n}, got {len(b)}")
    return b


def _w_mask(f, flat_bool: np.ndarray):
    """NodeMask.save: little-endian packed bits, offset-major."""
    f.write(np.packbits(flat_bool, bitorder="little").tobytes())


def _r_mask(f, size: int) -> np.ndarray:
    raw = np.frombuffer(_take(f, size // 8), np.uint8)
    return np.unpackbits(raw, bitorder="little").astype(bool)[:size]


def _w_values(f, vals: np.ndarray, compression: int):
    raw = np.ascontiguousarray(vals).tobytes()
    if compression == COMPRESS_ZIP:
        z = zlib.compress(raw)
        if len(z) < len(raw):
            f.write(struct.pack("<q", len(z)))
            f.write(z)
        else:   # openvdb stores uncompressible buffers raw, flagged by -size
            f.write(struct.pack("<q", -len(raw)))
            f.write(raw)
    else:
        f.write(raw)


def _r_values(f, count: int, dtype, compression: int) -> np.ndarray:
    itemsize = np.dtype(dtype).itemsize
    if compression == COMPRESS_ZIP:
        (nbytes,) = struct.unpack("<q", _take(f, 8))
        if nbytes <= 0:
            raw = _take(f, -nbytes)
        else:
            raw = zlib.decompress(_take(f, nbytes))
    else:
        raw = _take(f, count * itemsize)
    vals = np.frombuffer(raw, dtype)
    if len(vals) != count:
        raise VdbFormatError(f"buffer has {len(vals)} values, want {count}")
    return vals


def _meta_entry_bytes(value) -> Tuple[str, bytes]:
    if isinstance(value, str):
        return "string", value.encode("utf-8")
    if isinstance(value, bool):
        return "bool", struct.pack("<b", int(value))
    if isinstance(value, int):
        return "int64", struct.pack("<q", value)
    if isinstance(value, float):
        return "double", struct.pack("<d", value)
    raise TypeError(f"unsupported metadata type {type(value)}")


def _w_meta(f, meta: Dict[str, object]):
    f.write(struct.pack("<I", len(meta)))
    for k, v in meta.items():
        tname, payload = _meta_entry_bytes(v)
        _w_str(f, k)
        _w_str(f, tname)
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def _r_meta(f) -> Dict[str, object]:
    (n,) = struct.unpack("<I", _take(f, 4))
    if n > 10000:
        raise VdbFormatError(f"implausible metadata count {n}")
    out = {}
    for _ in range(n):
        k = _r_str(f)
        tname = _r_str(f)
        (sz,) = struct.unpack("<I", _take(f, 4))
        payload = _take(f, sz)
        if tname == "string":
            out[k] = payload.decode("utf-8", "replace")
        elif tname == "int64" and sz == 8:
            out[k] = struct.unpack("<q", payload)[0]
        elif tname == "int32" and sz == 4:
            out[k] = struct.unpack("<i", payload)[0]
        elif tname == "double" and sz == 8:
            out[k] = struct.unpack("<d", payload)[0]
        elif tname == "float" and sz == 4:
            out[k] = struct.unpack("<f", payload)[0]
        elif tname == "bool" and sz == 1:
            out[k] = bool(payload[0])
        else:
            out[k] = payload     # opaque but preserved
    return out


def _w_vec3d(f, v):
    f.write(struct.pack("<3d", *[float(x) for x in v]))


def _r_vec3d(f):
    return struct.unpack("<3d", _take(f, 24))


# --------------------------------------------------------------------------
# tree (de)serialization
# --------------------------------------------------------------------------

def _build_hierarchy(leaves):
    """leaf origins -> {int2_origin: {int1_origin: [leaf origins]}}."""
    tree: Dict = {}
    for lo in leaves:
        i2 = tuple((c // INT2_SPAN) * INT2_SPAN for c in lo)
        i1 = tuple((c // INT1_SPAN) * INT1_SPAN for c in lo)
        tree.setdefault(i2, {}).setdefault(i1, []).append(lo)
    return tree


def _offset(origin, child_origin, node_dim, child_span):
    ix = [(c - o) // child_span for o, c in zip(origin, child_origin)]
    for d, i in enumerate(ix):
        if not 0 <= i < node_dim:
            raise VdbFormatError(f"child {child_origin} outside {origin}")
    return (ix[0] * node_dim + ix[1]) * node_dim + ix[2]


def _offset_to_origin(origin, n, node_dim, child_span):
    iz = n % node_dim
    iy = (n // node_dim) % node_dim
    ix = n // (node_dim * node_dim)
    return (origin[0] + ix * child_span, origin[1] + iy * child_span,
            origin[2] + iz * child_span)


def _write_tree(f, grid: VdbGrid, compression: int):
    dtype = np.dtype(grid.dtype)
    vec = grid.vec
    bg = np.asarray(grid.background, dtype)
    if vec > 1 and bg.shape != (vec,):
        bg = np.broadcast_to(bg, (vec,))

    def bg_node(size):
        if vec == 1:
            return np.full(size, bg, dtype)
        return np.ascontiguousarray(np.broadcast_to(bg, (size, vec)))

    hier = _build_hierarchy(grid.leaves)
    f.write(struct.pack("<I", 1))                     # buffer count
    # RootNode topology
    f.write(bg.tobytes())                             # background
    f.write(struct.pack("<I", 0))                     # tiles
    f.write(struct.pack("<I", len(hier)))             # children
    leaf_write_order: List[Tuple[int, int, int]] = []
    for i2_origin in sorted(hier):
        f.write(struct.pack("<3i", *i2_origin))
        int1s = hier[i2_origin]
        # Internal2 topology
        child_mask = np.zeros(INT2_SIZE, bool)
        offs1 = {}
        for i1_origin in int1s:
            n = _offset(i2_origin, i1_origin, INT2_DIM, INT1_SPAN)
            child_mask[n] = True
            offs1[n] = i1_origin
        _w_mask(f, child_mask)
        _w_mask(f, np.zeros(INT2_SIZE, bool))          # value mask (tiles)
        _w_values(f, bg_node(INT2_SIZE), compression)
        for n in np.flatnonzero(child_mask):
            i1_origin = offs1[int(n)]
            # Internal1 topology
            lmask = np.zeros(INT1_SIZE, bool)
            offs0 = {}
            for lo in int1s[i1_origin]:
                m = _offset(i1_origin, lo, INT1_DIM, LEAF_DIM)
                lmask[m] = True
                offs0[m] = lo
            _w_mask(f, lmask)
            _w_mask(f, np.zeros(INT1_SIZE, bool))
            _w_values(f, bg_node(INT1_SIZE), compression)
            for m in np.flatnonzero(lmask):
                lo = offs0[int(m)]
                _w_mask(f, grid.mask_for(lo).reshape(-1))  # leaf topology
                leaf_write_order.append(lo)
    # buffers, in topology (depth-first) order
    for lo in leaf_write_order:
        vals = np.ascontiguousarray(grid.leaves[lo], dtype).reshape(-1)
        if len(vals) != LEAF_SIZE * vec:
            raise ValueError(f"leaf {lo} is not 8x8x8" +
                             (f"x{vec}" if vec > 1 else ""))
        _w_values(f, vals, compression)


def _read_tree(f, dtype, compression: int, vec: int = 1) -> VdbGrid:
    dtype = np.dtype(dtype)
    (bufcount,) = struct.unpack("<I", _take(f, 4))
    if bufcount != 1:
        raise VdbFormatError(f"multi-buffer trees unsupported ({bufcount})")
    bg_arr = np.frombuffer(_take(f, dtype.itemsize * vec), dtype)
    background = (float(bg_arr[0]) if vec == 1
                  else tuple(float(x) for x in bg_arr))
    (ntiles,) = struct.unpack("<I", _take(f, 4))
    (nchildren,) = struct.unpack("<I", _take(f, 4))
    for _ in range(ntiles):
        _take(f, 12 + dtype.itemsize * vec + 1)        # coord+value+active
    leaves: Dict[Tuple[int, int, int], np.ndarray] = {}
    masks: Dict[Tuple[int, int, int], np.ndarray] = {}
    order: List[Tuple[int, int, int]] = []
    leaf_shape = ((LEAF_DIM,) * 3 if vec == 1 else (LEAF_DIM,) * 3 + (vec,))
    for _ in range(nchildren):
        i2_origin = struct.unpack("<3i", _take(f, 12))
        cmask2 = _r_mask(f, INT2_SIZE)
        _r_mask(f, INT2_SIZE)
        _r_values(f, INT2_SIZE * vec, dtype, compression)
        for n in np.flatnonzero(cmask2):
            i1_origin = _offset_to_origin(i2_origin, int(n), INT2_DIM,
                                          INT1_SPAN)
            cmask1 = _r_mask(f, INT1_SIZE)
            _r_mask(f, INT1_SIZE)
            _r_values(f, INT1_SIZE * vec, dtype, compression)
            for m in np.flatnonzero(cmask1):
                lo = _offset_to_origin(i1_origin, int(m), INT1_DIM,
                                       LEAF_DIM)
                masks[lo] = _r_mask(f, LEAF_SIZE).reshape(
                    LEAF_DIM, LEAF_DIM, LEAF_DIM)
                order.append(lo)
    for lo in order:
        leaves[lo] = _r_values(f, LEAF_SIZE * vec, dtype,
                               compression).reshape(leaf_shape)
    g = VdbGrid("", leaves, background=background, masks=masks,
                dtype=dtype, vec=vec)
    return g


# --------------------------------------------------------------------------
# archive
# --------------------------------------------------------------------------

def write_vdb(path: str, grids: List[VdbGrid], *, compress: bool = False):
    """Write float grids to an OpenVDB-format ``.vdb`` file."""
    compression = COMPRESS_ZIP if compress else COMPRESS_NONE
    f = io.BytesIO()
    f.write(struct.pack("<q", MAGIC))
    f.write(struct.pack("<I", FILE_VERSION))
    f.write(struct.pack("<II", LIB_MAJOR, LIB_MINOR))
    f.write(struct.pack("<b", 1))                     # has grid offsets
    f.write(struct.pack("<b", compression))
    f.write(b"0" * 36)                                # uuid placeholder
    _w_meta(f, {})                                    # file metadata
    f.write(struct.pack("<I", len(grids)))
    # two-phase: descriptors hold absolute stream positions
    fixups = []
    for g in grids:
        if g.vec == 3:
            if np.dtype(g.dtype) != np.float32:
                raise TypeError("vec grids must be float32 (Vec3s)")
            tname = "Tree_vec3s_5_4_3"
        else:
            tname = {np.dtype(np.float32): "Tree_float_5_4_3",
                     np.dtype(np.int32): "Tree_int32_5_4_3"}[
                         np.dtype(g.dtype)]
        _w_str(f, g.name)
        _w_str(f, tname)
        _w_str(f, "")                                 # instance parent
        fixups.append(f.tell())
        f.write(struct.pack("<3q", 0, 0, 0))          # grid/block/end pos
        grid_pos = f.tell()
        _w_meta(f, {"name": g.name, "class": g.grid_class,
                    "is_saved_as_half_float": False})
        # transform: UniformScaleTranslateMap field block
        _w_str(f, "UniformScaleTranslateMap")
        s = float(g.voxel_size)
        _w_vec3d(f, g.translation)                    # translation
        _w_vec3d(f, (s, s, s))                        # scale
        _w_vec3d(f, (s, s, s))                        # voxel size
        _w_vec3d(f, (1 / s,) * 3)                     # scale inverse
        _w_vec3d(f, (1 / s ** 2,) * 3)                # inv scale^2
        _w_vec3d(f, (0.5 / s,) * 3)                   # inv twice scale
        _write_tree(f, g, compression)
        end_pos = f.tell()
        data = f.getvalue()
        f.seek(fixups[-1])
        # block pos == grid pos (topology+buffers written contiguously)
        f.write(struct.pack("<3q", grid_pos, grid_pos, end_pos))
        f.seek(end_pos)
    with open(path, "wb") as out:
        out.write(f.getvalue())


def read_vdb(path: str) -> List[VdbGrid]:
    """Read all float/int32 5-4-3 grids from a ``.vdb`` file."""
    with open(path, "rb") as fh:
        f = io.BytesIO(fh.read())
    (magic,) = struct.unpack("<q", _take(f, 8))
    if magic != MAGIC:
        raise VdbFormatError(f"not a VDB file (magic {magic:#x})")
    (version,) = struct.unpack("<I", _take(f, 4))
    if version >= 211:
        struct.unpack("<II", _take(f, 8))
    if version >= 212:
        (has_offsets,) = struct.unpack("<b", _take(f, 1))
    else:
        has_offsets = 0
    compression = COMPRESS_NONE
    if version >= 220:
        (compression,) = struct.unpack("<b", _take(f, 1))
        if compression & ~1:
            raise VdbFormatError(
                f"unsupported compression flags {compression:#x} "
                "(blosc / mask compression not implemented)")
    if version >= 218:
        # versions 218..221 store the uuid as a 36-byte printed string;
        # the 16-byte binary-uuid encoding only appears in versions >= 222,
        # which are rejected below, so no binary branch is needed here
        _take(f, 36)                                  # uuid
    if version >= 222:
        raise VdbFormatError(
            f"file version {version} uses node-mask compression; "
            "VDB-lite reads version <= 221 streams")
    _r_meta(f)                                        # file metadata
    (ngrids,) = struct.unpack("<I", _take(f, 4))
    grids = []
    for _ in range(ngrids):
        name = _r_str(f)
        tname = _r_str(f)
        if version >= 216:
            _r_str(f)                                 # instance parent
        if has_offsets:
            struct.unpack("<3q", _take(f, 24))
        if tname not in _TREE_TYPES:
            raise VdbFormatError(f"unsupported tree type {tname!r}")
        dtype, vec = _TREE_TYPES[tname]
        meta = _r_meta(f)
        map_name = _r_str(f)
        if map_name not in ("UniformScaleTranslateMap", "ScaleTranslateMap",
                            "UniformScaleMap", "ScaleMap"):
            raise VdbFormatError(f"unsupported transform map {map_name!r}")
        if "Translate" in map_name:
            translation = _r_vec3d(f)
        else:
            translation = (0.0, 0.0, 0.0)
        scale = _r_vec3d(f)
        _r_vec3d(f)                                   # voxel size
        _r_vec3d(f)                                   # scale inverse
        _r_vec3d(f)                                   # inv scale^2
        _r_vec3d(f)                                   # inv twice scale
        g = _read_tree(f, dtype, compression, vec)
        g.name = str(meta.get("name", name))
        g.grid_class = str(meta.get("class", "unknown"))
        g.voxel_size = float(scale[0])
        g.translation = tuple(float(t) for t in translation)
        grids.append(g)
    return grids


# --------------------------------------------------------------------------
# dense <-> leaves
# --------------------------------------------------------------------------

def dense_to_leaves(arr: np.ndarray, origin_ijk=(0, 0, 0),
                    background=0.0):
    """Dense [X,Y,Z] (or [X,Y,Z,C] vector) -> sparse leaf dict (empty
    leaves dropped)."""
    arr = np.asarray(arr)
    ox, oy, oz = origin_ijk
    if any(o % LEAF_DIM for o in origin_ijk):
        raise ValueError("origin must be leaf-aligned (multiple of 8)")
    bg = np.asarray(background)
    pads = [(0, (-s) % LEAF_DIM) for s in arr.shape[:3]] + \
        [(0, 0)] * (arr.ndim - 3)
    if bg.ndim:
        arr = np.concatenate(
            [np.pad(arr[..., c:c + 1], pads, constant_values=float(bg[c]))
             for c in range(arr.shape[-1])], axis=-1)
    else:
        arr = np.pad(arr, pads, constant_values=background)
    nx, ny, nz = [s // LEAF_DIM for s in arr.shape[:3]]
    leaves = {}
    blocks = arr.reshape((nx, LEAF_DIM, ny, LEAF_DIM, nz, LEAF_DIM) +
                         arr.shape[3:])
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                leaf = np.ascontiguousarray(blocks[i, :, j, :, k, :])
                if np.any(leaf != bg):
                    leaves[(ox + i * LEAF_DIM, oy + j * LEAF_DIM,
                            oz + k * LEAF_DIM)] = leaf
    return leaves


def leaves_to_dense(leaves, background=0.0):
    """Sparse leaf dict -> (dense array, origin_ijk); vector leaves
    ([8,8,8,C]) yield a [X,Y,Z,C] dense array."""
    if not leaves:
        return np.zeros((0, 0, 0), np.float32), (0, 0, 0)
    origins = np.asarray(sorted(leaves), np.int64)
    lo = origins.min(0)
    hi = origins.max(0) + LEAF_DIM
    proto = next(iter(leaves.values()))
    out = np.full(tuple(hi - lo) + proto.shape[3:], background,
                  proto.dtype)
    for o, leaf in leaves.items():
        s = np.asarray(o) - lo
        out[s[0]:s[0] + LEAF_DIM, s[1]:s[1] + LEAF_DIM,
            s[2]:s[2] + LEAF_DIM] = leaf
    return out, tuple(int(x) for x in lo)
