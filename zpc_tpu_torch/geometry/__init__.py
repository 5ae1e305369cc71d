"""Level sets, colliders, samplers, sparse grids and sparse level sets,
distances and contact, robust predicates and cells, meshes and marching
tetrahedra (counterpart of ``zpc_tpu/geometry``).

The names of ``zpc_tpu.geometry`` that the port carries are exported here
and imported on first use."""

import importlib

_EXPORTS = {
    ".levelset": ["LevelSet", "HalfSpace", "Sphere", "Cuboid", "Cylinder",
                  "Torus", "TransformedLevelSet", "UnionLevelSet",
                  "IntersectionLevelSet", "ComplementLevelSet"],
    ".collider": ["Collider", "ColliderType", "resolve_boundaries"],
    ".marching": ["TriSoup", "marching_tets", "surface_from_levelset"],
    ".sparse_grid": ["SparseGrid", "sparse_grid", "neighbor_offsets"],
    ".sparse_levelset": ["SparseLevelSet", "levelset_from_analytic",
                         "levelset_from_points", "flood_fill", "redistance"],
    ".mesh": ["TriMesh", "TetMesh", "tri_normals", "vertex_normals",
              "tet_surface", "mesh_aabbs", "spray_points", "tet_volumes"],
    ".predicates": ["orient2d", "orient3d", "incircle", "insphere"],
    ".ccd_tight": ["CCDResult", "vertex_face_ccd", "edge_edge_ccd_tight"],
    ".dihedral": ["dihedral_angle", "dihedral_angle_gradient",
                  "dihedral_angle_hessian", "hinge_bending_energy",
                  "hinge_bending_gradient", "hinge_bending_hessian"],
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = list(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_WHERE[name], __name__), name)
