"""Level sets, colliders, samplers, sparse grids, distances and contact
(counterpart of ``zpc_tpu/geometry``).

The names of ``zpc_tpu.geometry`` that the port carries are exported here
and imported on first use."""

import importlib

_EXPORTS = {
    ".levelset": ["LevelSet", "HalfSpace", "Sphere", "Cuboid", "Cylinder",
                  "Torus", "TransformedLevelSet", "UnionLevelSet",
                  "IntersectionLevelSet", "ComplementLevelSet"],
    ".collider": ["Collider", "ColliderType", "resolve_boundaries"],
    ".sparse_grid": ["SparseGrid", "sparse_grid", "neighbor_offsets"],
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = list(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_WHERE[name], __name__), name)
