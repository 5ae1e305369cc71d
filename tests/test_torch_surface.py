"""The port's particle surfacing (zpc_tpu_torch.geometry.sparse_levelset and
marching) against zpc_tpu on the same seeded numpy inputs: narrow-band
level sets from an analytic set and from points, the flood fill, a sparse
level set as a collider, marching tetrahedra, and the dam break's
``--out`` path (examples/dam_break.py:97-112) as a whole at 4,096
particles, through write_obj and read_obj.

Tolerances: block tables, triangle counts and overflow flags equal; SDF
values within 1e-6; marching vertices within 1e-6 dx on the same SDF;
where the SDFs differ by their 1e-6, the vertices move with them, and the
whole path's vertices are held within 1e-6 (world units) instead.
"""

import os

import numpy as np
import pytest
import torch

from zpc_tpu_torch import interop, scenes
from zpc_tpu_torch.geometry import levelset as TL
from zpc_tpu_torch.geometry import marching as TMC
from zpc_tpu_torch.geometry import sparse_levelset as TS
from zpc_tpu_torch.geometry.collider import Collider, ColliderType
from zpc_tpu_torch.utils import io as tio

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.geometry import collider as JCOL
    from zpc_tpu.geometry import levelset as JL
    from zpc_tpu.geometry import marching as JMC
    from zpc_tpu.geometry import sparse_levelset as JS
except ImportError:
    pass

CPU = torch.device("cpu")
SDF_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_levelset(got, want):
    """Tables equal, SDF within 1e-6 on the active blocks, background
    equal."""
    np.testing.assert_array_equal(got.grid.table.keys.numpy(),
                                  np.asarray(want.grid.table.keys))
    assert int(got.grid.table.count) == int(want.grid.table.count)
    m = np.asarray(want.grid.table.mask)
    np.testing.assert_allclose(got.grid.data["sdf"].numpy()[m],
                               np.asarray(want.grid.data["sdf"])[m],
                               rtol=0, atol=SDF_TOL)
    assert float(got.background) == float(want.background)


def _same_soup(got, want, atol):
    assert int(got.count) == int(want.count)
    assert bool(got.overflow) == bool(want.overflow)
    np.testing.assert_allclose(got.verts.numpy(), np.asarray(want.verts),
                               rtol=0, atol=atol)


# ------------------------------------------------------------ level sets

def test_levelset_from_analytic():
    """tests/test_levelset.py's rasterised sphere (dx 0.02, capacity
    2,048): equal to JAX's; deep inside clipped, near the surface exact
    within a cell."""
    s = TL.Sphere(_t(np.asarray([0.5, 0.5, 0.5], np.float32)),
                  torch.tensor(0.3))
    js = JL.Sphere(jnp.asarray([0.5, 0.5, 0.5]), jnp.float32(0.3))
    ls = TS.levelset_from_analytic(s, [0, 0, 0], [1, 1, 1], dx=0.02,
                                   block_capacity=2048)
    _same_levelset(ls, JS.levelset_from_analytic(js, [0, 0, 0], [1, 1, 1],
                                                 dx=0.02,
                                                 block_capacity=2048))
    d = ls.sdf(_t(np.asarray([[0.5, 0.5, 0.5], [0.5, 0.5, 0.75],
                              [0.5, 0.82, 0.5]], np.float32))).numpy()
    assert d[0] < -0.2
    assert abs(d[1] + 0.05) < 0.01 and abs(d[2] - 0.02) < 0.01


@pytest.fixture(scope="module")
def cloud():
    """tests/test_levelset.py's 200 points in [0.4, 0.6]^3, surfaced in
    both packages (dx 0.02, radius 0.03)."""
    x = np.random.default_rng(42).uniform(0.4, 0.6, (200, 3)).astype(
        np.float32)
    return dict(x=x, t=TS.levelset_from_points(_t(x), dx=0.02, radius=0.03,
                                               block_capacity=2048),
                j=JS.levelset_from_points(jnp.asarray(x), dx=0.02,
                                          radius=0.03, block_capacity=2048))


def test_levelset_from_points(cloud):
    """The union of spheres equals JAX's; the points are inside, the
    origin outside; sampled values agree at random points."""
    _same_levelset(cloud["t"], cloud["j"])
    assert (cloud["t"].sdf(_t(cloud["x"][:10])) < 0).all()
    assert float(cloud["t"].sdf(torch.zeros(1, 3))[0]) > 0
    q = np.random.default_rng(1).uniform(0.3, 0.7, (500, 3)).astype(
        np.float32)
    np.testing.assert_allclose(cloud["t"].sdf(_t(q)).numpy(),
                               np.asarray(cloud["j"].sdf(jnp.asarray(q))),
                               rtol=0, atol=SDF_TOL)
    carried = interop.sparse_levelset_from_jax(cloud["j"], CPU)
    np.testing.assert_allclose(carried.sdf(_t(q)).numpy(),
                               np.asarray(cloud["j"].sdf(jnp.asarray(q))),
                               rtol=0, atol=SDF_TOL)


@pytest.mark.parametrize("iters", [4, 16])
def test_flood_fill(cloud, iters):
    """tests/test_levelset.py's flood fill (a sphere band at dx 0.05, 4
    sweeps) and the point cloud's at 16: equal to JAX's; the near-surface
    value kept; redistance is the fill at 8."""
    s = TL.Sphere(_t(np.asarray([0.5, 0.5, 0.5], np.float32)),
                  torch.tensor(0.2))
    js = JL.Sphere(jnp.asarray([0.5, 0.5, 0.5]), jnp.float32(0.2))
    ls = TS.levelset_from_analytic(s, [0, 0, 0], [1, 1, 1], dx=0.05,
                                   block_capacity=1024, band=2.0)
    jls = JS.levelset_from_analytic(js, [0, 0, 0], [1, 1, 1], dx=0.05,
                                    block_capacity=1024, band=2.0)
    got = TS.flood_fill(ls, iters=iters)
    _same_levelset(got, JS.flood_fill(jls, iters=iters))
    assert abs(float(got.sdf(torch.tensor([[0.5, 0.5, 0.71]]))[0])
               - 0.01) < 0.02
    _same_levelset(TS.flood_fill(cloud["t"], iters),
                   JS.flood_fill(cloud["j"], iters))
    _same_levelset(TS.redistance(cloud["t"]), JS.redistance(cloud["j"]))


def test_sparse_levelset_as_collider(cloud):
    """A SparseLevelSet in a sticky and a slip collider resolves
    velocities as JAX's does (normals by autograd of the trilinear
    field; within 1e-5)."""
    rng = np.random.default_rng(3)
    x = (cloud["x"][:64] + rng.uniform(-0.01, 0.01, (64, 3))).astype(
        np.float32)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    for kind in ("sticky", "slip"):
        tc = Collider(cloud["t"], ColliderType[kind], 0.2)
        jc = JCOL.Collider(cloud["j"], JCOL.ColliderType[kind], 0.2)
        got = tc.resolve(_t(x), _t(v)).numpy()
        np.testing.assert_allclose(got, np.asarray(jc.resolve(
            jnp.asarray(x), jnp.asarray(v))), rtol=1e-5, atol=1e-5)
        assert not np.allclose(got, v)


# ------------------------------------------------------------ marching

def _sphere_sdf(n, dx, r, c=(0.5, 0.5, 0.5)):
    ax = np.arange(n) * dx
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2
                   ).astype(np.float32) - np.float32(r)


def _edge_counts(faces):
    """How many faces share each undirected edge."""
    e = torch.cat([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = torch.sort(e, 1).values
    return torch.unique(e, dim=0, return_counts=True)[1]


def test_weld():
    """Copies of a corner within tol merge whichever lattice cells they
    fall in, collapsed triangles go, and a closed surface's edges are each
    shared by two faces; corners farther apart stay apart."""
    c = torch.tensor([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     dtype=torch.float32) * 1e-5
    faces = torch.tensor([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]])
    g = torch.Generator().manual_seed(0)
    for _ in range(20):              # copies straddle cell boundaries
        soup = c[faces] + torch.randn(4, 3, 3, generator=g) * 2e-7
        v, f = TMC.weld(soup, 1e-6)
        assert v.shape == (4, 3) and f.shape == (4, 3)
        assert (_edge_counts(f) == 2).all()
    v, f = TMC.weld(torch.cat([soup, c[None, [0, 1, 1]]]), 1e-6)
    assert f.shape == (4, 3)                         # the collapsed one goes
    assert TMC.weld(soup, 1e-8)[0].shape[0] == 12


@pytest.mark.parametrize("n,r,cap", [(48, 0.3, 100_000), (32, 0.25, 50_000),
                                     (24, 0.3, 50_000), (32, 0.25, 16)])
def test_marching_sphere(n, r, cap):
    """tests/test_marching.py's spheres: the soup equals JAX's, run op by
    op (count, overflow, vertices within 1e-6 dx, in JAX's cube-then-tet
    order; compiled, XLA contracts the interpolation's multiply-adds and
    moves vertices by an ulp), except at 48^3, where JAX's op-by-op run
    alone takes 6 s; the area within 2% of 4 pi r^2, vertices on the
    sphere within dx, normals outward, every edge shared by two triangles
    once corners within 1e-6 dx are welded; capacity 16 overflows."""
    dx = 1.0 / n
    sdf = _sphere_sdf(n, dx, r)
    got = TMC.marching_tets(_t(sdf), dx, capacity=cap)
    if n < 48:
        _same_soup(got, JMC.marching_tets(jnp.asarray(sdf), dx,
                                          capacity=cap), 1e-6 * dx)
    if cap == 16:
        assert bool(got.overflow)
        return
    cnt = int(got.count)
    v = got.verts[:cnt].numpy()
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    area = 0.5 * np.linalg.norm(nrm, axis=-1)
    np.testing.assert_allclose(area.sum(), 4 * np.pi * r * r, rtol=0.02)
    dist = np.linalg.norm(v.reshape(-1, 3) - 0.5, axis=-1)
    np.testing.assert_allclose(dist, r, atol=dx)
    keep = area > 1e-10
    out = np.einsum("nd,nd->n", nrm[keep], v.mean(1)[keep] - 0.5)
    assert (out > 0).mean() > 0.999
    assert (_edge_counts(TMC.weld(got.verts[:cnt], 1e-6 * dx)[1])
            == 2).all()
    assert (got.verts[cnt:] == 0).all()


def test_soup_corners_differ_by_a_rounding():
    """JAX's tetrahedra [0, 3, 2, 7], [0, 6, 4, 7] and [0, 5, 1, 7] list an
    upper corner first, so a grid edge shared with the next cube is
    interpolated from both ends: JAX's soup (equal to the port's) is not
    closed under exact corner merging, and is once corners within 1e-6 dx
    are welded."""
    n, dx = 24, 1.0 / 24
    sdf = jnp.asarray(_sphere_sdf(n, dx, 0.3))
    soup = JMC.marching_tets(sdf, dx, capacity=50_000)
    tris = _t(np.asarray(soup.verts)[:int(soup.count)])
    exact = torch.unique(tris.reshape(-1, 3), dim=0, return_inverse=True)[1]
    assert (_edge_counts(exact.view(-1, 3)) != 2).any()
    assert (_edge_counts(TMC.weld(tris, 1e-6 * dx)[1]) == 2).all()


def test_surface_from_levelset_shell():
    """tests/test_marching.py's shell: 400 points on a sphere of radius
    0.2 surfaced at iso 0.05 equal JAX's soup (vertices within 1e-6, the
    SDFs differing by theirs), median radius in (0.1, 0.32)."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(400, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = (0.5 + 0.2 * d).astype(np.float32)
    ls = TS.levelset_from_points(_t(x), dx=1.0 / 32, radius=0.05,
                                 block_capacity=512)
    soup = TMC.surface_from_levelset(ls, iso=0.05, capacity=100_000)
    jls = JS.levelset_from_points(jnp.asarray(x), dx=1.0 / 32, radius=0.05,
                                  block_capacity=512)
    _same_soup(soup, JMC.surface_from_levelset(jls, iso=0.05,
                                               capacity=100_000), 1e-6)
    cnt = int(soup.count)
    assert cnt > 100
    dist = np.linalg.norm(soup.verts[:cnt].numpy().reshape(-1, 3) - 0.5,
                          axis=-1)
    assert 0.1 < np.median(dist) < 0.32


def test_dam_break_surface_path(tmp_path):
    """examples/dam_break.py's --out path at 4,096 particles: the dam
    break's column, levelset_from_points(radius 1.5 dx) -> flood_fill ->
    surface_from_levelset(iso 1.2 dx) equals JAX's (tables, SDF, soup),
    the surface is closed (every edge of two triangles once corners within
    1e-4 dx are welded) and faces out of the fluid, and write_obj /
    read_obj give it back.  The block table (256) and the soup (20,000)
    are sized to the scene's 125 blocks and ~7,000 triangles, as
    chip_smoke sizes them, where the example allots 4,096 and 200,000."""
    _, st, _, _ = scenes.dam_break(4096, CPU)
    x = st.particles["x"]
    dx = 1.0 / 128
    ls = TS.flood_fill(TS.levelset_from_points(x, dx=dx, radius=1.5 * dx,
                                               block_capacity=256))
    soup = TMC.surface_from_levelset(ls, iso=1.2 * dx, capacity=20_000)
    jls = JS.flood_fill(JS.levelset_from_points(
        jnp.asarray(x.numpy()), dx=dx, radius=1.5 * dx, block_capacity=256))
    _same_levelset(ls, jls)
    _same_soup(soup, JMC.surface_from_levelset(jls, iso=1.2 * dx,
                                               capacity=20_000), 1e-6)
    cnt = int(soup.count)
    assert cnt > 1000 and not bool(soup.overflow)
    tris = soup.verts[:cnt]
    assert (_edge_counts(TMC.weld(tris, 1e-4 * dx)[1]) == 2).all()
    n = torch.linalg.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0],
                           dim=-1)
    keep = torch.linalg.vector_norm(n, dim=-1) > 1e-12
    n = n[keep] / torch.linalg.vector_norm(n[keep], dim=-1, keepdim=True)
    c = tris[keep].mean(1)
    assert (ls.sdf(c + dx * n) > ls.sdf(c - dx * n)).all()
    path = os.path.join(tmp_path, "surface.obj")
    verts = tris.reshape(-1, 3).numpy()
    faces = np.arange(len(verts)).reshape(-1, 3)
    tio.write_obj(path, verts, faces)
    v2, f2 = tio.read_obj(path)
    np.testing.assert_allclose(v2, verts, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(f2, faces)


# ------------------------------------------------------------ the card

@pytest.mark.cuda
def test_card_against_cpu():
    """chip_smoke phase 34 at a small size: the dam break's surface on the
    card equals the CPU's, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = []
    for dev in (CPU, torch.device("cuda")):
        _, st, _, _ = scenes.dam_break(4096, dev)
        dx = 1.0 / 128
        ls = TS.flood_fill(TS.levelset_from_points(
            st.particles["x"], dx=dx, radius=1.5 * dx, block_capacity=4096))
        soup = TMC.surface_from_levelset(ls, iso=1.2 * dx, capacity=200_000)
        out.append([ls.grid.table.keys.cpu(), ls.grid.data["sdf"].cpu(),
                    soup.verts.cpu(), soup.count.cpu()])
    for a, b in zip(*out):
        assert torch.equal(a, b)
