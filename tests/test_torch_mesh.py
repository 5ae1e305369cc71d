"""The port's meshes (zpc_tpu_torch.geometry.mesh) and the mesh queries on
them (mesh boxes -> build_lbvh -> query_ray with cells'
ray_triangle_intersection, query_nearest with the point-triangle distance)
against zpc_tpu on the same seeded numpy inputs, and against brute force.

Tolerances: faces, counts and sampled points equal; normals and volumes
within 1e-6; ray parameters and distances within rtol 1e-5
(tests/test_bvh.py:519), distances also within atol 1e-7: they are
differences of coordinates near 0.5, each rounded to 6e-8, so a distance
of 1e-3 carries that absolute error in either package.  Where a ray or a
point is as near to two triangles (a shared edge or vertex), either is
accepted.
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch import interop, scenes
from zpc_tpu_torch.containers import bvh as TB
from zpc_tpu_torch.geometry import cells as TC
from zpc_tpu_torch.geometry import distance as TD
from zpc_tpu_torch.geometry import mesh as TM
from zpc_tpu_torch.models.constitutive import NeoHookean
from zpc_tpu_torch.sim import fem as TF

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.containers import bvh as JB
    from zpc_tpu.geometry import cells as JC
    from zpc_tpu.geometry import distance as JD
    from zpc_tpu.geometry import mesh as JM
except ImportError:
    pass

CPU = torch.device("cpu")
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _meshes(kind):
    """tests/test_mesh.py's meshes in both packages (numpy inputs)."""
    if kind == "tri":
        v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        f = np.asarray([[0, 1, 2]], np.int32)
        return (JM.TriMesh(jnp.asarray(v), jnp.asarray(f)),
                TM.TriMesh(_t(v), _t(f)))
    if kind == "unit_tet":
        v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                       np.float32)
        e = np.asarray([[0, 1, 2, 3]], np.int32)
    else:
        v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                        [1, 1, 1]], np.float32)
        e = np.asarray([[0, 1, 2, 3], [1, 2, 3, 4]], np.int32)
    return (JM.TetMesh(jnp.asarray(v), jnp.asarray(e)),
            TM.TetMesh(_t(v), _t(e)))


@pytest.mark.parametrize("kind,faces", [("unit_tet", 4), ("two_tets", 6)])
def test_tet_surface_and_volume(kind, faces):
    """tests/test_mesh.py's tets: the boundary faces equal JAX's (the
    shared face {1, 2, 3} removed), volumes within 1e-6."""
    jm, tm = _meshes(kind)
    surf = TM.tet_surface(tm)
    assert surf.faces.shape == (faces, 3)
    np.testing.assert_array_equal(surf.faces.numpy(),
                                  np.asarray(JM.tet_surface(jm).faces))
    key = np.sort(surf.faces.numpy(), 1)
    assert any((k == [1, 2, 3]).all() for k in key) == (kind == "unit_tet")
    np.testing.assert_allclose(TM.tet_volumes(tm).numpy(),
                               np.asarray(JM.tet_volumes(jm)), atol=1e-6)
    if kind == "unit_tet":
        assert abs(float(TM.tet_volumes(tm)[0]) - 1.0 / 6) < 1e-6
    back = interop.tetmesh_from_jax(jm, CPU)
    assert torch.equal(back.elements, tm.elements)


def test_tet_box_surface():
    """The FEM box's mesh (make_tet_box, 5 x 4 x 3 vertices): its boundary
    equals JAX's, 2 triangles per boundary quad, and the volumes sum to
    the box's."""
    m = NeoHookean.from_young_poisson(5e4, 0.3, device=CPU)
    sim, x = TF.make_tet_box(5, 4, 3, 0.1, model=m, device=CPU)
    tm = TM.TetMesh(x, sim.tets)
    jm = JM.TetMesh(jnp.asarray(x.numpy()), jnp.asarray(sim.tets.numpy()))
    surf = TM.tet_surface(tm)
    np.testing.assert_array_equal(surf.faces.numpy(),
                                  np.asarray(JM.tet_surface(jm).faces))
    assert surf.faces.shape[0] == 2 * 2 * (4 * 3 + 4 * 2 + 3 * 2)
    vol = TM.tet_volumes(tm)
    assert (vol > 0).all()
    np.testing.assert_allclose(float(vol.sum()), 0.4 * 0.3 * 0.2, rtol=1e-5)


def test_normals_boxes_and_spray():
    """tests/test_mesh.py's triangle: normals, boxes and sprayed points,
    equal to JAX's (the points exactly: the same numpy generator)."""
    jm, tm = _meshes("tri")
    n = TM.tri_normals(tm)
    np.testing.assert_allclose(n.numpy(), np.asarray(JM.tri_normals(jm)),
                               atol=1e-6)
    np.testing.assert_allclose(n[0].numpy(), [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(TM.vertex_normals(tm).numpy(),
                               np.tile([0, 0, 1], (3, 1)), atol=1e-6)
    lo, hi = TM.mesh_aabbs(tm, pad=0.1)
    jlo, jhi = JM.mesh_aabbs(jm, pad=0.1)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_allclose(hi[0].numpy(), [1.1, 1.1, 0.1], atol=1e-6)
    pts = TM.spray_points(tm, density=2000.0, seed=1)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(
        JM.spray_points(jm, density=2000.0, seed=1)))
    assert len(pts) > 100 and (pts[:, 2] == 0).all()
    assert (pts[:, 0] + pts[:, 1] <= 1 + 1e-5).all()


def test_terrain_trimesh():
    """The heightfield as shared vertices: its triangles are terrain_mesh's
    bit for bit, and its vertex normals equal JAX's within 1e-6."""
    tm = scenes.terrain_trimesh(16, CPU)
    assert torch.equal(tm.vertices[tm.faces.long()],
                       scenes.terrain_mesh(16, CPU))
    assert tm.num_faces == 2 * 16 * 16 and tm.num_vertices == 17 * 17
    jm = JM.TriMesh(jnp.asarray(tm.vertices.numpy()),
                    jnp.asarray(tm.faces.numpy()))
    np.testing.assert_allclose(TM.vertex_normals(tm).numpy(),
                               np.asarray(JM.vertex_normals(jm)), atol=1e-6)
    assert (TM.tri_normals(tm)[:, 1] < -0.9).all()   # (b-a) x (c-a) is -y
    back = interop.trimesh_from_jax(jm, CPU)
    assert torch.equal(back.faces, tm.faces)


@pytest.fixture(scope="module")
def terrain():
    """The 16 x 16 heightfield's tree in both packages, from its face
    boxes."""
    tm = scenes.terrain_trimesh(16, CPU)
    tri = tm.vertices[tm.faces.long()]
    lo, hi = TM.mesh_aabbs(tm)
    jt = JB.build_lbvh(jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()))
    return dict(tri=tri, jtri=jnp.asarray(tri.numpy()), jt=jt,
                tt=TB.build_lbvh(lo, hi))


def _accept_ties(ids, vals, brute, rtol=RTOL):
    """The brute-force minimum within rtol; where the id differs from the
    brute-force argmin, its own value ties the minimum."""
    best = brute.min(1)
    np.testing.assert_allclose(vals, best, rtol=rtol, atol=1e-7)
    own = brute[np.arange(len(ids)), ids]
    np.testing.assert_allclose(own, best, rtol=rtol, atol=1e-7)


def test_ray_query_on_terrain(terrain):
    """256 downward rays from y = 1 onto the heightfield: ids equal JAX's,
    t within rtol 1e-5 of JAX's and of brute force over every triangle."""
    rng = np.random.default_rng(0)
    n = 256
    o = np.stack([rng.uniform(0, 1, n), np.ones(n), rng.uniform(0, 1, n)],
                 1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    tri, jtri = terrain["tri"], terrain["jtri"]

    def thit(i, oo, dd):
        t3 = tri[i.long()]
        hit, t = TC.ray_triangle_intersection(oo, dd, t3[:, 0], t3[:, 1],
                                              t3[:, 2])
        return torch.where(hit, t, float("inf"))

    def jhit(i, oo, dd):
        hit, t = JC.ray_triangle_intersection(oo, dd, jtri[i, 0],
                                              jtri[i, 1], jtri[i, 2])
        return jnp.where(hit, t, jnp.inf)

    tid, tt = TB.query_ray(terrain["tt"], _t(o), _t(d), thit)
    jid, jtt = jax.jit(lambda a, b: JB.query_ray(terrain["jt"], a, b, jhit)
                       )(jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jtt), rtol=RTOL)
    assert (tid >= 0).all()
    hit, t = TC.ray_triangle_intersection(
        _t(o)[:, None], _t(d)[:, None], tri[None, :, 0], tri[None, :, 1],
        tri[None, :, 2])
    _accept_ties(tid.numpy(), tt.numpy(),
                 torch.where(hit, t, float("inf")).numpy())


def test_nearest_query_on_terrain(terrain):
    """256 points in the slab above the heightfield: the nearest triangle
    by sqrt(point_triangle_dist2): ids equal JAX's, distances within rtol
    1e-5 of JAX's and of brute force."""
    rng = np.random.default_rng(1)
    n = 256
    p = np.stack([rng.uniform(0, 1, n), rng.uniform(0.5, 0.62, n),
                  rng.uniform(0, 1, n)], 1).astype(np.float32)
    tri, jtri = terrain["tri"], terrain["jtri"]

    def tdist(i, q):
        t3 = tri[i.long()]
        return torch.sqrt(TD.point_triangle_dist2(q, t3[:, 0], t3[:, 1],
                                                  t3[:, 2]))

    def jdist(i, q):
        return jnp.sqrt(JD.point_triangle_dist2(q, jtri[i, 0], jtri[i, 1],
                                                jtri[i, 2]))

    tid, td = TB.query_nearest(terrain["tt"], _t(p), tdist)
    jid, jd = jax.jit(lambda a: JB.query_nearest(terrain["jt"], a, jdist)
                      )(jnp.asarray(p))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=1e-7)
    same = tid.numpy() == np.asarray(jid)
    assert same.mean() > 0.95        # the rest are ties (shared edges)
    brute = torch.sqrt(TD.point_triangle_dist2(
        _t(p)[:, None], tri[None, :, 0], tri[None, :, 1],
        tri[None, :, 2])).numpy()
    _accept_ties(tid.numpy(), td.numpy(), brute)


@pytest.mark.cuda
def test_card_against_cpu():
    """chip_smoke phase 33 at a small size: the terrain's tree, the ray
    query (ids and t) and the tet box's surface on the card equal the
    CPU's; the nearest query's distances within rtol 1e-5 and atol 1e-7
    (the point-triangle distance sums its dot products in the device's
    order) and at least 99% of its ids equal (the rest tied)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = []
    for dev in (CPU, torch.device("cuda")):
        tm = scenes.terrain_trimesh(32, dev)
        tri = tm.vertices[tm.faces.long()]
        b = TB.build_lbvh(*TM.mesh_aabbs(tm))
        g = torch.Generator().manual_seed(0)
        o = torch.rand((4096, 3), generator=g).to(dev)
        o[:, 1] = 1.0
        d = torch.zeros_like(o)
        d[:, 1] = -1.0

        def hit(i, oo, dd):
            t3 = tri[i.long()]
            h, t = TC.ray_triangle_intersection(oo, dd, t3[:, 0], t3[:, 1],
                                                t3[:, 2])
            return torch.where(h, t, float("inf"))

        def dist(i, q):
            t3 = tri[i.long()]
            return torch.sqrt(TD.point_triangle_dist2(
                q, t3[:, 0], t3[:, 1], t3[:, 2]))

        p = o.clone()
        p[:, 1] = 0.5 + 0.12 * torch.rand(4096, generator=g).to(dev)
        m = NeoHookean.from_young_poisson(5e4, 0.3, device=dev)
        sim, x = TF.make_tet_box(5, 5, 5, 0.1, model=m, device=dev)
        r = [b.left, b.escape, b.leaf_prim, *TB.query_ray(b, o, d, hit),
             TM.tet_surface(TM.TetMesh(x, sim.tets)).faces,
             *TB.query_nearest(b, p, dist)]
        out.append([t.cpu() for t in r])
    cpu, card = out
    for a, c in zip(cpu[:6], card[:6]):
        assert torch.equal(a, c)
    torch.testing.assert_close(card[7], cpu[7], rtol=1e-5, atol=1e-7)
    assert (card[6] == cpu[6]).float().mean() > 0.99
