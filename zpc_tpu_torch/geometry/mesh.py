"""Simplicial meshes (counterpart of ``zpc_tpu/geometry/mesh.py``): a
triangle or tetrahedron mesh is its vertices and elements; normals,
volumes and per-face boxes are batched, and the boundary of a tet mesh and
the surface sampler are host code (numpy), as meshes are host assets.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["TriMesh", "TetMesh", "tri_normals", "vertex_normals",
           "tet_surface", "mesh_aabbs", "spray_points", "tet_volumes"]


@dataclasses.dataclass(frozen=True)
class TriMesh:
    vertices: torch.Tensor   # [nv, 3]
    faces: torch.Tensor      # [nf, 3] int32

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]


@dataclasses.dataclass(frozen=True)
class TetMesh:
    vertices: torch.Tensor   # [nv, 3]
    elements: torch.Tensor   # [ne, 4] int32


def _corners(v, f):
    return [v[f[:, k].long()] for k in range(f.shape[1])]


def tri_normals(mesh: TriMesh, normalize: bool = True) -> torch.Tensor:
    """Face normals ``(b - a) x (c - a)``, unit length if ``normalize``
    (else twice the face area long)."""
    a, b, c = _corners(mesh.vertices, mesh.faces)
    n = torch.linalg.cross(b - a, c - a, dim=-1)
    if normalize:
        n = n / torch.linalg.vector_norm(n, dim=-1,
                                         keepdim=True).clamp_min(1e-12)
    return n


def vertex_normals(mesh: TriMesh) -> torch.Tensor:
    """Area-weighted unit vertex normals."""
    fn = tri_normals(mesh, normalize=False)
    acc = torch.zeros((mesh.num_vertices, 3), dtype=fn.dtype,
                      device=fn.device)
    for k in range(3):
        acc.index_add_(0, mesh.faces[:, k].long(), fn)
    return acc / torch.linalg.vector_norm(acc, dim=-1,
                                          keepdim=True).clamp_min(1e-12)


def tet_volumes(mesh: TetMesh) -> torch.Tensor:
    """Signed volumes, positive for positively oriented tets."""
    a, b, c, d = _corners(mesh.vertices, mesh.elements)
    return torch.sum(torch.linalg.cross(b - a, c - a, dim=-1) * (d - a),
                     -1) / 6.0


def tet_surface(mesh: TetMesh) -> TriMesh:
    """The boundary triangles of a tet mesh, outward for positive tets: the
    faces that occur once, found by sorting the faces' sorted vertex
    triples (host side)."""
    e = mesh.elements.detach().cpu().numpy()
    local = [(0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2)]
    faces = np.concatenate([e[:, f] for f in local])
    key = np.sort(faces, axis=1)
    order = np.lexsort((key[:, 2], key[:, 1], key[:, 0]))
    ks, fs = key[order], faces[order]
    same = (ks[1:] == ks[:-1]).all(1)
    once = ~(np.concatenate([[False], same]) | np.concatenate([same, [False]]))
    return TriMesh(mesh.vertices, torch.as_tensor(
        fs[once], dtype=torch.int32, device=mesh.vertices.device))


def mesh_aabbs(mesh: TriMesh, pad: float = 0.0):
    """Per-face boxes ``(lo, hi)``, grown by ``pad`` (the LBVH's input for
    a mesh)."""
    pts = torch.stack(_corners(mesh.vertices, mesh.faces), 1)
    return pts.amin(1) - pad, pts.amax(1) + pad


def spray_points(mesh: TriMesh, density: float, seed: int = 0
                 ) -> torch.Tensor:
    """Points on the surface, ``density`` per unit area on average, drawn
    by ``numpy.random.default_rng(seed)`` (the JAX package's points
    exactly), as float32 on the mesh's device."""
    v = mesh.vertices.detach().cpu().numpy()
    f = mesh.faces.detach().cpu().numpy()
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    rng = np.random.default_rng(seed)
    counts = rng.poisson(np.maximum(area * density, 0.0))
    total = int(counts.sum())
    dev = mesh.vertices.device
    if total == 0:
        return torch.zeros((0, 3), dtype=torch.float32, device=dev)
    fidx = np.repeat(np.arange(len(f)), counts)
    r1 = np.sqrt(rng.uniform(size=total))
    r2 = rng.uniform(size=total)
    w0, w1, w2 = 1 - r1, r1 * (1 - r2), r1 * r2
    pts = (w0[:, None] * a[fidx] + w1[:, None] * b[fidx]
           + w2[:, None] * c[fidx])
    return torch.as_tensor(pts, dtype=torch.float32, device=dev)
