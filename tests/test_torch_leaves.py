"""The port's leaf modules against zpc_tpu on the same seeded numpy inputs:
B-spline weights, the Newton polar, the corotated stress, the CFL
timestep, the level sets, the colliders and the block table.

Float results are held to relative 1e-5 (fp32 with the operations in a
possibly different order); integer results must be exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zpc_tpu.containers import block_table as jbt
from zpc_tpu.geometry import collider as jcol
from zpc_tpu.geometry import levelset as jls
from zpc_tpu.math.interpolation import bspline_weights as j_bspline_weights
from zpc_tpu.math.svd import polar_newton3x3 as j_polar
from zpc_tpu.models.cfl import timestep_linear_elasticity as j_timestep
from zpc_tpu.models.constitutive import FixedCorotated as JFixedCorotated

from zpc_tpu_torch.containers import block_table as tbt
from zpc_tpu_torch.geometry import collider as tcol
from zpc_tpu_torch.geometry import levelset as tls
from zpc_tpu_torch.math.interpolation import bspline_weights, stencil_size
from zpc_tpu_torch.math.svd import polar_newton3x3
from zpc_tpu_torch.math.vecmat import det3, mm
from zpc_tpu_torch.models.cfl import timestep_linear_elasticity
from zpc_tpu_torch.models.constitutive import FixedCorotated

CPU = torch.device("cpu")
RTOL = 1e-5


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


def _close(got, ref, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=atol)


def test_bspline_weights(rng):
    x = rng.uniform(-20.0, 20.0, (2000, 3)).astype(np.float32)
    jb, jw, jdw = j_bspline_weights(jnp.asarray(x), 2)
    tb, tw, tdw = bspline_weights(_t(x), 2)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    _close(tw.numpy(), jw, atol=1e-7)
    _close(tdw.numpy(), jdw, atol=1e-7)
    _close(tw.sum(-1).numpy(), np.ones((2000, 3)), atol=1e-6)
    assert stencil_size(2) == 3
    # the linear and cubic kernels: order 3's fx is taken from base + 1
    for order in (1, 3):
        jb, jw, jdw = j_bspline_weights(jnp.asarray(x), order)
        tb, tw, tdw = bspline_weights(_t(x), order)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        _close(tw.numpy(), jw, atol=1e-7)
        _close(tdw.numpy(), jdw, atol=1e-7)
        _close(tw.sum(-1).numpy(), np.ones((2000, 3)), atol=1e-6)
        assert stencil_size(order) == order + 1


def _strained(rng, n=512, strain=0.15):
    """Rotations times symmetric stretches within +-strain."""
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)
    S = np.eye(3) + rng.uniform(-strain, strain, (n, 3, 3))
    S = 0.5 * (S + np.swapaxes(S, 1, 2))
    return (R @ S).astype(np.float32)


def test_polar_newton_15pct_strain(rng):
    F = _strained(rng)
    got = polar_newton3x3(_t(F)).numpy()
    _close(got, j_polar(jnp.asarray(F)), atol=1e-6)
    # orthogonal to fp32 accuracy
    np.testing.assert_allclose(got @ np.swapaxes(got, 1, 2),
                               np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-5)


def test_vecmat(rng):
    a = rng.standard_normal((64, 3, 3)).astype(np.float32)
    b = rng.standard_normal((64, 3, 3)).astype(np.float32)
    _close(mm(_t(a), _t(b)).numpy(), a.astype(np.float64) @ b, atol=1e-5)
    _close(det3(_t(a)).numpy(), np.linalg.det(a.astype(np.float64)),
           atol=1e-5)


def test_fixed_corotated_kirchhoff(rng):
    F = _strained(rng)
    jm = JFixedCorotated.from_young_poisson(5e4, 0.3)
    tm = FixedCorotated.from_young_poisson(5e4, 0.3, device=CPU)
    assert float(tm.mu) == float(jm.mu) and float(tm.lam) == float(jm.lam)
    ref = np.asarray(jm.kirchhoff(jnp.asarray(F)))
    # stresses reach ~1e4: compare relative to the stress scale
    _close(tm.kirchhoff(_t(F)).numpy(), ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dx", [1.0 / 128, 1.0 / 32, 0.05])
def test_timestep_linear_elasticity(dx):
    ref = float(j_timestep(5e4, 0.3, 1e3, dx, cfl=0.4))
    got = float(timestep_linear_elasticity(5e4, 0.3, 1e3, dx, cfl=0.4))
    assert got == pytest.approx(ref, rel=RTOL)


def _levelsets():
    origin, direction = [0.0, 0.1, 0.0], [0.0, 1.0, 0.0]
    lo, hi = [0.2, 0.1, 0.3], [0.8, 0.7, 0.6]
    jhalf = jls.HalfSpace(jnp.asarray(origin), jnp.asarray(direction))
    thalf = tls.HalfSpace(torch.tensor(origin), torch.tensor(direction))
    jbox = jls.Cuboid(jnp.asarray(lo), jnp.asarray(hi))
    tbox = tls.Cuboid(torch.tensor(lo), torch.tensor(hi))
    return {"halfspace": (jhalf, thalf), "cuboid": (jbox, tbox),
            "complement": (jls.ComplementLevelSet(jbox),
                           tls.ComplementLevelSet(tbox))}


@pytest.mark.parametrize("name", ["halfspace", "cuboid", "complement"])
def test_levelset_sdf_normal(name, rng):
    jl, tl = _levelsets()[name]
    x = rng.uniform(-0.2, 1.2, (3000, 3)).astype(np.float32)
    _close(tl.sdf(_t(x)).numpy(), jl.sdf(jnp.asarray(x)), atol=1e-6)
    _close(tl.normal(_t(x)).numpy(), jl.normal(jnp.asarray(x)), atol=1e-6)
    np.testing.assert_array_equal(tl.velocity(_t(x)).numpy(),
                                  np.zeros_like(x))


@pytest.mark.parametrize("kind", ["sticky", "slip", "separate"])
@pytest.mark.parametrize("friction", [0.0, 0.4])
def test_resolve_boundaries(kind, friction, rng):
    ls = _levelsets()
    jc = [jcol.Collider(ls[k][0], jcol.ColliderType(kind), friction)
          for k in ("halfspace", "complement")]
    tc = [tcol.Collider(ls[k][1], tcol.ColliderType(kind), friction)
          for k in ("halfspace", "complement")]
    x = rng.uniform(-0.1, 1.1, (4000, 3)).astype(np.float32)
    v = rng.standard_normal((4000, 3)).astype(np.float32)
    ref = np.asarray(jcol.resolve_boundaries(jc, jnp.asarray(x),
                                             jnp.asarray(v)))
    got = tcol.resolve_boundaries(tc, _t(x), _t(v)).numpy()
    _close(got, ref, atol=1e-6)
    assert not np.array_equal(got, v)       # some nodes were projected


def _coords(rng, n):
    return rng.integers(-40, 40, (n, 3)).astype(np.int32)


@pytest.mark.parametrize("capacity", [512, 64])
def test_build_block_table(capacity, rng):
    """Duplicates, invalid lanes and (at capacity 64) overflow."""
    c = _coords(rng, 300)
    c = np.concatenate([c, c[:120]])              # duplicated keys
    valid = rng.uniform(size=c.shape[0]) < 0.9
    jt, jinv = jbt.build_block_table(jnp.asarray(c), capacity,
                                     valid=jnp.asarray(valid))
    tt, tinv = tbt.build_block_table(_t(c), capacity, valid=_t(valid))
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    assert int(tt.count) == int(jt.count)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    assert bool(tbt.build_overflowed(tt)) == bool(jbt.build_overflowed(jt))
    assert bool(tbt.build_overflowed(tt)) == (capacity == 64)
    np.testing.assert_array_equal(tt.active_coords.numpy(),
                                  np.asarray(jt.active_coords))
    np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
    q = np.concatenate([c[:200], _coords(rng, 200)])
    np.testing.assert_array_equal(tt.query(_t(q)).numpy(),
                                  np.asarray(jt.query(jnp.asarray(q))))
    qk = np.array(jbt.pack_coords(jnp.asarray(q)))
    qk[::7] = jbt.KEY_SENTINEL
    np.testing.assert_array_equal(tt.query_keys(_t(qk)).numpy(),
                                  np.asarray(jt.query_keys(jnp.asarray(qk))))


def test_pack_unpack_round_trip(rng):
    c = rng.integers(-512, 512, (1000, 3)).astype(np.int32)
    k = tbt.pack_coords(_t(c))
    np.testing.assert_array_equal(k.numpy(),
                                  np.asarray(jbt.pack_coords(jnp.asarray(c))))
    np.testing.assert_array_equal(tbt.unpack_key(k, 3).numpy(), c)
    assert tbt.KEY_SENTINEL == int(jbt.KEY_SENTINEL)
