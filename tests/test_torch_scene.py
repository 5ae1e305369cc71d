"""The port's scene layer against zpc_tpu on the same seeded numpy inputs:
the analytic level sets and transforms, the samplers, particle and mesh
IO, the Scene class, state checkpoints and the simulate runner.

JAX runs on the CPU (conftest), the port on CPU tensors, where every scan
takes the kernel's plain version.  Tolerances, absolute: level sets,
their normals and velocities and the transforms 1e-6; samplers, IO bytes,
the built state and checkpoints exact; the runner's states x 1e-5, v 2e-4,
F 1e-5 (tests/test_mpm_binned2.py's, two orders of fp32 summation).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from zpc_tpu_torch import interop, scenes
from zpc_tpu_torch.geometry import sampling as tsmp
from zpc_tpu_torch.math import transform as ttr
from zpc_tpu_torch.ops import scan as tscan
from zpc_tpu_torch.sim.runner import simulate as tsimulate
from zpc_tpu_torch.sim.scene import Scene as TScene
from zpc_tpu_torch.utils import io as tio

# the cuda tests run where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.geometry import levelset as jls
    from zpc_tpu.geometry import sampling as jsmp
    from zpc_tpu.geometry.collider import Collider as JCollider
    from zpc_tpu.geometry.collider import ColliderType as JColliderType
    from zpc_tpu.math import transform as jtr
    from zpc_tpu.models.constitutive import FixedCorotated as JFixedCorotated
    from zpc_tpu.sim import mpm as jmpm
    from zpc_tpu.sim.runner import simulate as jsimulate
    from zpc_tpu.sim.scene import Scene as JScene
    from zpc_tpu.utils import io as jio
except ImportError:
    pass

CPU = torch.device("cpu")
TOL = dict(x=1e-5, v=2e-4, F=1e-5)
LS_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# level sets
# ---------------------------------------------------------------------------

def _rot(rng):
    Q = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    return (Q * np.sign(np.linalg.det(Q))).astype(np.float32)


def _jlevelsets():
    """One of each analytic level set (and the wrappers around them),
    built on the JAX side; the port's come through interop."""
    rng = np.random.default_rng(17)
    f = jnp.float32
    sphere = jls.Sphere(jnp.asarray([0.1, -0.2, 0.3]), f(0.7))
    box = jls.Cuboid(jnp.asarray([-0.5, -0.3, -0.4]),
                     jnp.asarray([0.4, 0.6, 0.2]))
    cyl = jls.Cylinder(jnp.asarray([0.0, -0.5, 0.1]), f(0.4), f(1.2), 1)
    cyl_x = jls.Cylinder(jnp.asarray([-0.6, 0.1, 0.0]), f(0.3), f(1.0), 0)
    torus = jls.Torus(jnp.asarray([0.1, 0.0, -0.1]), f(0.6), f(0.2), 2)
    moving = jls.TransformedLevelSet(
        box, jnp.asarray(_rot(rng)), jnp.asarray([0.2, 0.1, -0.3]),
        jnp.asarray([0.5, -1.0, 0.25]), jnp.asarray([0.3, -0.2, 0.8]))
    twin = jls.TransformedLevelSet(
        sphere, jnp.eye(3), jnp.zeros(3), jnp.asarray([1.0, 2.0, 3.0]),
        jnp.zeros(3))
    return {
        "halfspace": jls.HalfSpace(jnp.asarray([0.0, 0.1, 0.0]),
                                   jnp.asarray([0.6, 0.8, 0.0])),
        "sphere": sphere, "cuboid": box, "cylinder": cyl,
        "cylinder_x": cyl_x, "torus": torus,
        "transformed": moving,
        "transformed_cylinder": jls.TransformedLevelSet(
            cyl, jnp.asarray(_rot(rng)), jnp.asarray([0.1, 0.0, 0.2]),
            jnp.zeros(3), jnp.asarray([0.0, 1.0, 0.0])),
        # the twin ties with the sphere everywhere: the velocity is the
        # first set's, as jnp.argmin picks the first minimum
        "union": jls.UnionLevelSet((sphere, twin, moving, torus)),
        "union_tie_first": jls.UnionLevelSet((twin, sphere)),
        "intersection": jls.IntersectionLevelSet((sphere, box, cyl)),
        "complement": jls.ComplementLevelSet(box),
    }


def _ls_points(n=600):
    """Seeded points in [-1.2, 1.2]^3 (none lies on an axis or a box
    ridge, where the distance has no derivative)."""
    rng = np.random.default_rng(23)
    return rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)


LEVELSETS = ["halfspace", "sphere", "cuboid", "cylinder", "cylinder_x",
             "torus", "transformed", "transformed_cylinder", "union",
             "union_tie_first", "intersection", "complement"]


def _f64(obj):
    """A level set with every tensor in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double()
    if isinstance(obj, tuple):
        return tuple(_f64(v) for v in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _f64(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def _fd_normal(ls, x, h=1e-5):
    """The unit gradient of ``ls.sdf`` by central differences in
    float64."""
    ls = _f64(ls)
    x = torch.from_numpy(x.astype(np.float64))
    g = torch.stack([(ls.sdf(x + h * e) - ls.sdf(x - h * e)) / (2 * h)
                     for e in torch.eye(3, dtype=torch.float64)], -1)
    return (g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)).numpy()


@pytest.mark.parametrize("name", LEVELSETS)
def test_levelset_matches_jax(name):
    """sdf, normal (the sdf's gradient by autograd where JAX takes
    jax.grad) and velocity within 1e-6 at 600 seeded points.

    Where JAX's normal is NaN the port's must be the sdf's gradient, held
    to central differences within 1e-5: inside a cylinder, and inside any
    box that is part of a union or intersection (``jax.grad`` through
    the square root or the norm of a zero exterior offset, which is NaN
    even where that member is not the one selected; a reference fault,
    ROADMAP.md §3)."""
    jl = _jlevelsets()[name]
    tl = interop._levelset_from_jax(jl, CPU)
    assert type(tl).__name__ == type(jl).__name__
    x = _ls_points()
    for what in ("sdf", "normal", "velocity"):
        got = getattr(tl, what)(_t(x)).numpy()
        want = np.asarray(getattr(jl, what)(jnp.asarray(x)))
        ok = np.isfinite(want).reshape(len(x), -1).all(-1)
        if not ok.all():
            assert what == "normal" and name in (
                "cylinder", "cylinder_x", "transformed_cylinder", "union",
                "intersection")
            np.testing.assert_allclose(got[~ok], _fd_normal(tl, x[~ok]),
                                       rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=LS_TOL,
                                   err_msg=f"{name}.{what}")
    np.testing.assert_array_equal(tl.inside(_t(x)).numpy(),
                                  np.asarray(jl.inside(jnp.asarray(x))))


def test_union_velocity_takes_the_first_minimum():
    jl = _jlevelsets()["union_tie_first"]
    tl = interop._levelset_from_jax(jl, CPU)
    v = tl.velocity(_t(_ls_points(50))).numpy()
    np.testing.assert_array_equal(v, np.broadcast_to([1.0, 2.0, 3.0],
                                                     v.shape))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def test_transform_matches_jax():
    rng = np.random.default_rng(29)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    q2 = rng.standard_normal((64, 4)).astype(np.float32)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    ax = rng.standard_normal((64, 3)).astype(np.float32)
    ang = rng.uniform(-3.0, 3.0, 64).astype(np.float32)
    t = rng.uniform(0.0, 1.0, (64, 1)).astype(np.float32)
    qn = np.asarray(jtr.quat_normalize(jnp.asarray(q)))
    qn2 = np.asarray(jtr.quat_normalize(jnp.asarray(q2)))
    cases = {
        "quat_normalize": ((q,), {}),
        "quat_from_axis_angle": ((ax, ang), {}),
        "quat_mul": ((q, q2), {}),
        "quat_rotate": ((qn, v), {}),
        "quat_to_matrix": ((qn,), {}),
        "quat_slerp": ((qn, qn2, t), {}),
        "rotation_x": ((ang,), {}), "rotation_y": ((ang,), {}),
        "rotation_z": ((ang,), {}),
        "euler_to_matrix": ((ang, ang[::-1].copy(), 0.5 * ang), {}),
    }
    for name, (args, _) in cases.items():
        got = getattr(ttr, name)(*[_t(a) for a in args]).numpy()
        want = np.asarray(getattr(jtr, name)(*[jnp.asarray(a)
                                                for a in args]))
        np.testing.assert_allclose(got, want, rtol=0, atol=LS_TOL,
                                   err_msg=name)
    R = np.asarray(jtr.quat_to_matrix(jnp.asarray(qn)))
    got = ttr.quat_from_matrix(_t(R)).numpy()
    want = np.asarray(jtr.quat_from_matrix(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, rtol=0, atol=LS_TOL)
    np.testing.assert_array_equal(
        ttr.quat_identity(device=CPU).numpy(),
        np.asarray(jtr.quat_identity()))
    M = _rot(rng)
    tt, jt = ttr.rotation_transform(M, device=CPU), \
        jtr.rotation_transform(jnp.asarray(M))
    np.testing.assert_array_equal(tt.matrix.numpy(), np.asarray(jt.matrix))
    comp = tt.compose(ttr.translation([0.1, 0.2, 0.3], device=CPU))
    jcomp = jt.compose(jtr.translation([0.1, 0.2, 0.3]))
    for what in ("apply", "apply_vector"):
        np.testing.assert_allclose(
            getattr(comp, what)(_t(v)).numpy(),
            np.asarray(getattr(jcomp, what)(jnp.asarray(v))), rtol=0,
            atol=LS_TOL, err_msg=what)
    np.testing.assert_array_equal(ttr.Transform.identity(device=CPU)
                                  .matrix.numpy(),
                                  np.asarray(jtr.Transform.identity().matrix))


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0], 0.1, 8.0, 0.5, 0),
    ([0.375, 0.475, 0.375], [0.625, 0.725, 0.625], 1 / 32, 8.0, 0.5, 3),
    ([0.1, 0.2], [0.6, 0.9], 0.02, 4.0, 0.25, 7),
])
def test_sample_lattice_bit_equal(args):
    np.testing.assert_array_equal(tsmp.sample_lattice(*args),
                                  jsmp.sample_lattice(*args))


@pytest.mark.parametrize("args", [
    dict(lo=[0, 0], hi=[1, 1], radius=0.05, seed=1),
    dict(lo=[0, 0, 0], hi=[0.5, 0.5, 0.5], radius=0.08),
    dict(lo=[0, 0, 0], hi=[1, 1, 1], radius=0.05, seed=4, max_points=120),
])
def test_poisson_disk_bit_equal(args):
    got = tsmp.poisson_disk(**args)
    np.testing.assert_array_equal(got, jsmp.poisson_disk(**args))
    d = np.linalg.norm(got[None] - got[:, None], axis=-1)
    np.fill_diagonal(d, np.inf)
    assert d.min() >= args["radius"] * 0.999


@pytest.mark.parametrize("method", ["lattice", "poisson"])
def test_sample_levelset_matches_jax(method):
    """The same points where the two sdfs agree on the sign; they may
    differ only where |sdf| < 1e-6."""
    jl = _jlevelsets()["torus"]
    tl = interop._levelset_from_jax(jl, CPU)
    lo, hi = [-0.9, -0.9, -0.25], [0.9, 0.9, 0.25]
    # the poisson pattern is a Python loop: a coarse radius keeps it short
    kw = dict(dx=0.4 if method == "poisson" else 0.05, ppc=8.0, seed=5,
              method=method)
    got = tsmp.sample_levelset(tl.sdf, lo, hi, **kw)
    want = jsmp.sample_levelset(jl.sdf, lo, hi, **kw)
    gs, ws = {tuple(p) for p in got}, {tuple(p) for p in want}
    diff = np.asarray(sorted(gs ^ ws), np.float32).reshape(-1, 3)
    assert len(got) > (20 if method == "poisson" else 1000)
    if len(diff):
        assert np.abs(np.asarray(jl.sdf(jnp.asarray(diff)))).max() < 1e-6


# ---------------------------------------------------------------------------
# IO
# ---------------------------------------------------------------------------

def test_bgeo_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(31)
    x = rng.standard_normal((257, 3)).astype(np.float32)
    attrs = {"v": rng.standard_normal((257, 3)).astype(np.float32),
             "m": rng.uniform(0, 1, 257).astype(np.float32)}
    tio.write_bgeo(str(tmp_path / "t.bgeo"), _t(x),
                   {k: _t(a) for k, a in attrs.items()})
    jio.write_bgeo(str(tmp_path / "j.bgeo"), x, attrs)
    assert (tmp_path / "t.bgeo").read_bytes() == \
        (tmp_path / "j.bgeo").read_bytes()
    for src, reader in (("j", tio.read_bgeo), ("t", jio.read_bgeo)):
        pos, out = reader(str(tmp_path / f"{src}.bgeo"))
        np.testing.assert_array_equal(pos, x)
        np.testing.assert_array_equal(out["v"], attrs["v"])
        np.testing.assert_array_equal(out["m"][:, 0], attrs["m"])
    tio.write_bgeo(str(tmp_path / "n.bgeo"), x)
    jio.write_bgeo(str(tmp_path / "jn.bgeo"), x)
    assert (tmp_path / "n.bgeo").read_bytes() == \
        (tmp_path / "jn.bgeo").read_bytes()


def test_mesh_io_matches_jax(tmp_path):
    rng = np.random.default_rng(37)
    v = rng.standard_normal((20, 3)).astype(np.float32)
    f = rng.integers(0, 20, (15, 3)).astype(np.int32)
    t = rng.integers(0, 20, (9, 4)).astype(np.int32)
    tio.write_obj(str(tmp_path / "t.obj"), _t(v), _t(f))
    jio.write_obj(str(tmp_path / "j.obj"), v, f)
    assert (tmp_path / "t.obj").read_text() == \
        (tmp_path / "j.obj").read_text()
    (tmp_path / "q.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                                    "f 1/1 2/2 3/3 4/4\n")
    for name in ("t.obj", "q.obj"):
        a, b = tio.read_obj(str(tmp_path / name)), \
            jio.read_obj(str(tmp_path / name))
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q)
    tio.write_vtk_tets(str(tmp_path / "t.vtk"), v, t)
    jio.write_vtk_tets(str(tmp_path / "j.vtk"), v, t)
    assert (tmp_path / "t.vtk").read_text() == \
        (tmp_path / "j.vtk").read_text()
    for p, q in zip(tio.read_vtk_tets(str(tmp_path / "t.vtk")),
                    jio.read_vtk_tets(str(tmp_path / "t.vtk"))):
        np.testing.assert_array_equal(p, q)


def test_async_io_runs_jobs_in_order_and_copies_tensors():
    io = tio.AsyncIO()
    seen = []
    x = torch.arange(4.0)
    for i in range(20):
        io.submit(lambda i, a: seen.append((i, a.copy())), i, x)
        x += 1.0                      # the job holds the host copy
    io.wait()
    assert [i for i, _ in seen] == list(range(20))
    for i, a in seen:
        np.testing.assert_array_equal(a, np.arange(4.0) + i)
    assert tio.AsyncIO.instance() is tio.AsyncIO.instance()


def test_checkpoint_round_trip(tmp_path):
    """save_state / load_state restore an MPM state and a bin state bit for
    bit, with the template's dtypes and devices."""
    sim, st, dt = scenes.readme_scene(1 / 16, CPU)
    from zpc_tpu_torch.sim import mpm_binned2 as tb2
    cfg = tb2.BinnedConfig2(bins_capacity=32)
    out = tb2.explicit_step_binned2(sim, tb2.bin_state(sim, st, cfg), dt,
                                    cfg, rebin=False)
    for i, state in enumerate((st, out)):
        path = str(tmp_path / f"c{i}.npz")
        tio.save_state(path, state)
        like = _zeroed(state)
        back = tio.load_state(path, like)
        _assert_trees_identical(back, state)


def _zeroed(obj):
    if isinstance(obj, torch.Tensor):
        return torch.zeros_like(obj)
    if isinstance(obj, dict):
        return {k: _zeroed(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _zeroed(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _assert_trees_identical(a, b):
    if isinstance(b, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    elif isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _assert_trees_identical(a[k], b[k])
    elif dataclasses.is_dataclass(b):
        for f in dataclasses.fields(b):
            _assert_trees_identical(getattr(a, f.name), getattr(b, f.name))
    else:
        assert a == b


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------

def _jground(y=0.05):
    return JCollider(jls.HalfSpace(jnp.asarray([0.0, y, 0.0]),
                                   jnp.asarray([0.0, 1.0, 0.0])),
                     JColliderType.sticky)


def _build_both(capacity=None):
    """Two cubes of different stiffness and density and a sphere, on both
    sides; the port's colliders through interop."""
    def fill(scene):
        return (scene.add_cube([0.3, 0.5, 0.5], 0.15, E=1e4, rho=1e3)
                .add_cube([0.7, 0.5, 0.5], 0.15, E=1e6, rho=2e3,
                          velocity=(0.0, -1.0, 0.5))
                .add_sphere([0.5, 0.75, 0.5], 0.1, E=3e4, nu=0.25))
    jsim, jst, jdt = fill(JScene(dx=0.05)).add_boundary(_jground()).build(
        block_capacity=512, capacity=capacity)
    tscene = fill(TScene(dx=0.05, device=CPU))
    tscene.add_boundary(interop.sim_from_jax(jsim, CPU).colliders[0])
    tsim, tst, tdt = tscene.build(block_capacity=512, capacity=capacity)
    return (jsim, jst, jdt), (tsim, tst, tdt)


@pytest.mark.parametrize("capacity", [None, 3000])
def test_scene_build_matches_jax(capacity):
    (jsim, jst, jdt), (tsim, tst, tdt) = _build_both(capacity)
    assert tdt == jdt
    assert tst.particles.size == jst.particles.size
    assert tst.particles.capacity == jst.particles.capacity
    a, b = interop.state_to_numpy(jst), interop.state_to_numpy(tst)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for f in ("mu", "lam"):
        np.testing.assert_array_equal(getattr(tsim.model, f).numpy(),
                                      np.asarray(getattr(jsim.model, f)))
    np.testing.assert_array_equal(tsim.gravity.numpy(),
                                  np.asarray(jsim.gravity))
    np.testing.assert_array_equal(tst.grid.transform.matrix.numpy(),
                                  np.asarray(jst.grid.transform.matrix))
    assert tst.grid.block_capacity == jst.grid.block_capacity


def test_scene_defaults_to_the_card(monkeypatch):
    """Without a device the Scene takes cuda_device(), which raises where
    there is no card; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TScene(dx=0.05)


def test_heterogeneous_scene_on_binned2():
    """A Scene's per-particle Lamé fields on the binned path.  The JAX
    binned step reads them in particle order against bin-ordered F and
    fails to broadcast (a reference fault, ROADMAP.md §3); the port
    gathers them by pid, and its binned rollout matches JAX's unbinned
    steps."""
    (jsim, jst, jdt), (tsim, tst, tdt) = _build_both()
    from zpc_tpu.sim import mpm_binned2 as jb2
    from zpc_tpu_torch.sim import mpm_binned2 as tb2
    jcfg = jb2.BinnedConfig2(bins_capacity=64)
    with pytest.raises(TypeError):
        jb2.rollout_binned2(jsim, jst, jnp.float32(jdt), jcfg, 1)
    step = jax.jit(lambda s: jmpm.explicit_step(jsim, s, jnp.float32(jdt)))
    ref = jst
    for _ in range(5):
        ref = step(ref)
    out, overflow = tb2.rollout_binned2(tsim, tst, torch.tensor(tdt),
                                        interop.config_from_jax(jcfg), 5)
    assert not bool(overflow)
    _assert_close(out, ref)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _assert_close(got, want):
    a, b = interop.state_to_numpy(want), interop.state_to_numpy(got)
    for k in ("x", "v", "F"):
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=TOL[k],
                                   err_msg=k)


@pytest.mark.parametrize("path", ["baseline", "binned2"])
def test_simulate_matches_jax(path, tmp_path):
    """tests/test_runner.py's scene (256 particles, dx 0.05, dt 1e-4, 6
    steps, frames every 3, a checkpoint at 6) on "baseline" with adapt_dt
    and on "binned2": the same frames (read back by the port from both
    packages' files), a checkpoint that reloads bit for bit, and the final
    state within the tolerances."""
    rng = np.random.default_rng(42)
    x = jnp.asarray(rng.uniform(0.3, 0.7, (256, 3)), jnp.float32)
    jst = jmpm.make_mpm_state(x, dx=0.05, block_capacity=256)
    jsim = jmpm.MPMSim(model=JFixedCorotated.from_young_poisson(1e4, 0.3),
                       gravity=jnp.asarray([0.0, -9.8, 0.0]))
    kw = dict(dt=1e-4, steps=6, path=path, frame_every=3,
              checkpoint_every=6, adapt_dt=path == "baseline")
    if path == "binned2":
        kw["bins_capacity"] = 64
    out = {}
    for side, run, sim, st in (
            ("j", jsimulate, jsim, jst),
            ("t", tsimulate, interop.sim_from_jax(jsim, CPU),
             interop.state_from_jax(jst, CPU))):
        frames = []
        out[side] = run(sim, st, frame_prefix=str(tmp_path / side),
                        checkpoint_path=str(tmp_path / f"{side}.npz"),
                        on_frame=lambda i, s: frames.append(i), **kw)
        assert frames == [3, 6]
    _assert_close(out["t"], out["j"])
    for i in (3, 6):
        tpos, tattr = tio.read_bgeo(str(tmp_path / f"t.{i:05d}.bgeo"))
        jpos, jattr = tio.read_bgeo(str(tmp_path / f"j.{i:05d}.bgeo"))
        assert tpos.shape == (256, 3) and tattr["v"].shape == (256, 3)
        np.testing.assert_allclose(tpos, jpos, rtol=0, atol=TOL["x"])
        np.testing.assert_allclose(tattr["v"], jattr["v"], rtol=0,
                                   atol=TOL["v"])
    np.testing.assert_array_equal(
        tpos, out["t"].particles["x"].numpy()[:256])
    back = tio.load_state(str(tmp_path / "t.npz"), _zeroed(out["t"]))
    _assert_trees_identical(back, out["t"])


def test_simulate_refuses_what_is_not_ported():
    sim, st, dt = scenes.readme_scene(1 / 16, CPU)
    with pytest.raises(ValueError, match="v1"):
        tsimulate(sim, st, dt=dt, steps=1, path="binned")
    with pytest.raises(ValueError, match="fixed dt"):
        tsimulate(sim, st, dt=dt, steps=1, path="binned2", adapt_dt=True)


def test_readme_scene_counts():
    """The README scene's lattice: 64^3 points at dx = 1/128 (np.arange
    over a float span gives exactly 64 per axis there), and the runner's
    bins for it."""
    from zpc_tpu_torch.sim.runner import _binned2_config
    pts = tsmp.sample_lattice(np.array([0.375, 0.475, 0.375]),
                              np.array([0.625, 0.725, 0.625]), 1 / 128)
    assert pts.shape == (262_144, 3)
    assert _binned2_config(262_144).bins_capacity == 2568


@pytest.mark.cuda
def test_scene_and_runner_on_cuda(tmp_path):
    """The README scene at dx = 1/32 with a sphere through simulate on the
    card: frames and checkpoint written, the scan kernel launched in every
    segment's bin_state, and the state within the tolerances of the same
    run on the CPU (chip_smoke phases 21-22 at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel has no CPU mode")
    dev = torch.device("cuda")
    out = {}
    for where in (dev, CPU):
        sim, st, dt = scenes.readme_scene(1 / 32, where, sphere=True)
        before = tscan.LAUNCHES
        out[where.type] = tsimulate(
            sim, st, dt=dt, steps=60, path="binned2", frame_every=20,
            frame_prefix=str(tmp_path / where.type), checkpoint_every=60,
            checkpoint_path=str(tmp_path / f"{where.type}.npz"))
        if where.type == "cuda":
            assert tscan.LAUNCHES >= before + 3 * 4
    assert os.path.exists(tmp_path / "cuda.00060.bgeo")
    a = interop.state_to_numpy(out["cpu"])
    b = interop.state_to_numpy(out["cuda"])
    for k in ("x", "v", "F"):
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=TOL[k])
