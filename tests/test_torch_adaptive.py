"""The port's AdaptiveGrid (zpc_tpu_torch.geometry.adaptive_grid) against
zpc_tpu's on the same seeded cells: every case of tests/test_adaptive.py
in both packages.

Tolerances: the levels (block keys, payloads, child masks) and every probe
equal JAX's bit for bit (gathers of the same values); the trilinear
samples, their gradients and the staggered samples within 1e-6 of JAX's
(the same products and sums; JAX's oracle tolerances, 1e-6 for a probe,
1e-5 for a constant sample and 1e-3 for the gradient of a linear field,
are held too); the SDF collider's 3 MPM steps within 5e-4 of the analytic
collider's (tests/test_adaptive.py:197-199) and within 1e-6 of JAX's same
steps.
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch import interop
from zpc_tpu_torch.geometry import adaptive_grid as TA
from zpc_tpu_torch.geometry.collider import Collider, ColliderType
from zpc_tpu_torch.geometry.levelset import HalfSpace
from zpc_tpu_torch.geometry.vdb_bridge import (adaptive_to_vdb_grid,
                                               vdb_grid_to_adaptive)
from zpc_tpu_torch.models.constitutive import FixedCorotated
from zpc_tpu_torch.sim import mpm as TM
from zpc_tpu_torch.utils import vdb as TV

from _jax_jit import jit

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax.numpy as jnp
    from zpc_tpu.geometry import adaptive_grid as JA
    from zpc_tpu.geometry import collider as JCol
    from zpc_tpu.geometry import levelset as JL
    from zpc_tpu.models import constitutive as JC
    from zpc_tpu.sim import mpm as JM
except ImportError:
    pass

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# JAX's grid builds, probes, activations and leaf updates, each one program
# (they gather and scatter, so compiled they give op by op's values; the
# samples, which interpolate, run op by op)
@jit(static_argnames=("dx", "capacities", "background"))
def _jax_grid(cells, vals, dx, capacities, background=0.0):
    return JA.adaptive_grid_from_leaves(cells, vals, dx=dx,
                                        capacities=capacities,
                                        background=background)


@jit
def _jax_probe(grid, x):
    return grid.probe(x)


@jit
def _jax_activate(grid, cells):
    return grid.activate_leaves(cells)


@jit
def _jax_update(grid, cells, vals):
    return grid.update_leaf_values(cells, vals)


def _both(cells, vals, dx, capacities, background=0.0):
    """The same grid in both packages."""
    jg = _jax_grid(jnp.asarray(cells), jnp.asarray(vals), dx,
                   tuple(capacities), background)
    tg = TA.adaptive_grid_from_leaves(_t(cells), _t(vals), dx=dx,
                                      capacities=capacities,
                                      background=background)
    return jg, tg


def _same_levels(jg, tg):
    for lj, lt in zip(jg.levels, tg.levels, strict=True):
        np.testing.assert_array_equal(lt.table.keys.numpy(),
                                      np.asarray(lj.table.keys))
        assert int(lt.table.count) == int(lj.table.count)
        np.testing.assert_array_equal(lt.value.numpy(), np.asarray(lj.value))
        np.testing.assert_array_equal(lt.child.numpy(), np.asarray(lj.child))


def _random_grid(rng, n=200, dx=0.1):
    """tests/test_adaptive.py's grid: unique cells in [-20, 20)^3."""
    cells = np.unique(rng.integers(-20, 20, (n, 3)).astype(np.int32), axis=0)
    vals = rng.standard_normal(len(cells)).astype(np.float32)
    jg, tg = _both(cells, vals, dx=dx, capacities=[512, 256, 64],
                   background=-7.0)
    return jg, tg, cells, vals, dx


def _solid(n=16):
    ax = np.arange(0, n)
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                    -1).reshape(-1, 3).astype(np.int32)


def test_levels_equal_jax(rng):
    """Negative cells: every level's keys, payload and child mask equal
    JAX's (floor divisions, not truncation)."""
    jg, tg, *_ = _random_grid(rng)
    _same_levels(jg, tg)


def test_probe_leaf_values(rng):
    jg, tg, cells, vals, dx = _random_grid(rng)
    x = ((cells + 0.5) * dx).astype(np.float32)
    got = tg.probe(_t(x)).numpy()
    np.testing.assert_allclose(got, vals, atol=1e-6)
    np.testing.assert_array_equal(got, np.asarray(_jax_probe(
        jg, jnp.asarray(x))))


def test_probe_everywhere_equals_jax(rng):
    """Probes over the grid's box and beyond, bit for bit JAX's."""
    jg, tg, *_ = _random_grid(rng)
    x = rng.uniform(-3.0, 3.0, (4096, 3)).astype(np.float32)
    np.testing.assert_array_equal(tg.probe(_t(x)).numpy(),
                                  np.asarray(_jax_probe(jg, jnp.asarray(x))))


def test_probe_background(rng):
    jg, tg, *_ = _random_grid(rng)
    far = np.asarray([[100.0, 100.0, 100.0]], np.float32) * 0.1
    assert float(tg.probe(_t(far))[0]) == -7.0
    assert float(_jax_probe(jg, jnp.asarray(far))[0]) == -7.0


def test_probe_inside_leaf_block_unset_cell():
    """A cell of an allocated leaf block that was never set reads the
    leaf level's default (the background)."""
    jg, tg = _both(np.asarray([[0, 0, 0]], np.int32),
                   np.asarray([5.0], np.float32), dx=1.0,
                   capacities=[16, 16, 16], background=0.0)
    x = np.asarray([[1.5, 0.5, 0.5]], np.float32)
    assert float(tg.probe(_t(x))[0]) == 0.0
    assert float(_jax_probe(jg, jnp.asarray(x))[0]) == 0.0


def test_sample_constant_field(rng):
    cells = _solid(8)
    vals = np.full(len(cells), 3.0, np.float32)
    jg, tg = _both(cells, vals, dx=0.5, capacities=[64, 32, 16])
    x = rng.uniform(1.0, 3.0, (32, 3)).astype(np.float32)
    got = tg.sample(_t(x)).numpy()
    np.testing.assert_allclose(got, 3.0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jg.sample(jnp.asarray(x))),
                               atol=1e-6)


def test_sample_random_field_equals_jax(rng):
    jg, tg, *_ = _random_grid(rng)
    x = rng.uniform(-2.5, 2.5, (2048, 3)).astype(np.float32)
    np.testing.assert_allclose(tg.sample(_t(x)).numpy(),
                               np.asarray(jg.sample(jnp.asarray(x))),
                               atol=1e-6)


def test_update_leaf_values(rng):
    jg, tg, cells, vals, dx = _random_grid(rng)
    new = vals * 3.0 + 1.0
    tg2, ovf = tg.update_leaf_values(_t(cells), _t(new))
    jg2, jovf = _jax_update(jg, jnp.asarray(cells), jnp.asarray(new))
    assert not bool(ovf) and not bool(jovf)
    x = _t((cells + 0.5) * dx).float()
    np.testing.assert_allclose(tg2.probe(x).numpy(), new, atol=1e-6)
    np.testing.assert_allclose(tg.probe(x).numpy(), vals, atol=1e-6)
    _same_levels(jg2, tg2)


def test_update_inactive_cell_flags_overflow(rng):
    jg, tg, *_ = _random_grid(rng)
    c = np.asarray([[500, 500, 500]], np.int32)
    v = np.asarray([1.0], np.float32)
    _, ovf = tg.update_leaf_values(_t(c), _t(v))
    _, jovf = _jax_update(jg, jnp.asarray(c), jnp.asarray(v))
    assert bool(ovf) and bool(jovf)


def test_activate_extends_topology(rng):
    jg, tg, cells, vals, dx = _random_grid(rng, n=60)
    new_cells = np.asarray([[100, 100, 100], [101, 100, 100]], np.int32)
    tg2, ovf = tg.activate_leaves(_t(new_cells))
    jg2, jovf = _jax_activate(jg, jnp.asarray(new_cells))
    assert not bool(ovf) and not bool(jovf)
    _same_levels(jg2, tg2)
    x_old = _t((cells + 0.5) * dx).float()
    np.testing.assert_allclose(tg2.probe(x_old).numpy(), vals, atol=1e-6)
    nv = _t(np.asarray([2.5, -3.5], np.float32))
    _, ovf_pre = tg.update_leaf_values(_t(new_cells), nv)
    assert bool(ovf_pre)
    tg3, ovf_post = tg2.update_leaf_values(_t(new_cells), nv)
    assert not bool(ovf_post)
    x_new = _t((new_cells + 0.5) * dx).float()
    np.testing.assert_allclose(tg3.probe(x_new).numpy(), nv.numpy(),
                               atol=1e-6)


def test_activate_capacity_overflow(rng):
    c = np.asarray([[0, 0, 0]], np.int32)
    v = np.asarray([1.0], np.float32)
    jg, tg = _both(c, v, dx=1.0, capacities=[2, 16, 16])
    many = (rng.integers(0, 400, (64, 3)) * 8).astype(np.int32)
    _, ovf = tg.activate_leaves(_t(many))
    _, jovf = _jax_activate(jg, jnp.asarray(many))
    assert bool(ovf) and bool(jovf)


def test_gradient_of_linear_field(rng):
    """f = 2x + 3y - z at the cell centres: the gradient (through the
    trilinear weights) is (2, 3, -1) inside, 0 where the field is the
    constant background, as JAX's autodiff gives."""
    cells = _solid(16)
    dx = 0.5
    ctr = (cells + 0.5) * dx
    vals = (2 * ctr[:, 0] + 3 * ctr[:, 1] - ctr[:, 2]).astype(np.float32)
    jg, tg = _both(cells, vals, dx=dx, capacities=[64, 32, 16])
    x = rng.uniform(2 * dx, 13 * dx, (40, 3)).astype(np.float32)
    grad = tg.sample_gradient(_t(x)).numpy()
    np.testing.assert_allclose(grad, np.tile([2.0, 3.0, -1.0], (40, 1)),
                               atol=1e-3)
    far = np.concatenate([x, x + 40.0])
    np.testing.assert_allclose(tg.sample_gradient(_t(far)).numpy(),
                               np.asarray(jg.sample_gradient(
                                   jnp.asarray(far))), atol=1e-6)
    assert (tg.sample_gradient(_t(x + 40.0)).numpy() == 0.0).all()


def test_staggered_shifted_sample(rng):
    cells = _solid(16)
    dx = 0.5
    vals = rng.standard_normal(len(cells)).astype(np.float32)
    jg, tg = _both(cells, vals, dx=dx, capacities=[64, 32, 16])
    x = rng.uniform(3 * dx, 12 * dx, (10, 3)).astype(np.float32)
    got = tg.sample_staggered(_t(x)).numpy()
    for d in range(3):
        shift = np.zeros(3, np.float32)
        shift[d] = 0.5 * dx
        np.testing.assert_allclose(got[:, d],
                                   tg.sample(_t(x + shift)).numpy(),
                                   atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jg.sample_staggered(
        jnp.asarray(x))), atol=1e-6)


def test_interop_carries_jax_grids(rng):
    jg, _, *_ = _random_grid(rng)
    ig = interop.adaptive_grid_from_jax(jg, CPU)
    x = rng.uniform(-2.5, 2.5, (512, 3)).astype(np.float32)
    np.testing.assert_array_equal(ig.probe(_t(x)).numpy(),
                                  np.asarray(_jax_probe(jg, jnp.asarray(x))))


@jit
def _jax_sdf_collider_step(model, gravity, grid, state, dt):
    """JAX's MPM step with ``grid``'s SDF as a sticky collider."""
    sim = JM.MPMSim(model=model, gravity=gravity, colliders=(JCol.Collider(
        JA.AdaptiveGridLevelSet(grid), JCol.ColliderType.sticky),))
    return JM.explicit_step(sim, state, dt)


def test_sdf_collider_in_mpm(rng):
    """The coarse-fine collision SDF: the narrow-band adaptive SDF of a
    half space (equal to JAX's, level for level) drives an MPM collider;
    3 steps match the analytic collider within 5e-4 and JAX's same steps
    within 1e-6."""
    floor = HalfSpace(torch.tensor([0.0, 0.3, 0.0]),
                      torch.tensor([0.0, 1.0, 0.0]))
    jfloor = JL.HalfSpace(jnp.asarray([0.0, 0.3, 0.0]),
                          jnp.asarray([0.0, 1.0, 0.0]))
    kw = dict(dx=0.025, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0), band=0.2)
    ag = TA.adaptive_from_sdf(floor, device=CPU, **kw)
    jag = JA.adaptive_from_sdf(jfloor, **kw)
    _same_levels(jag, ag)
    ls = TA.AdaptiveGridLevelSet(ag)
    pts = rng.uniform(0.1, 0.9, (50, 3)).astype(np.float32)
    pts[:, 1] = rng.uniform(0.2, 0.42, 50)
    np.testing.assert_allclose(ls.sdf(_t(pts)).numpy(),
                               floor.sdf(_t(pts)).numpy(), atol=0.01)
    n = ls.normal(_t(pts)).numpy()
    np.testing.assert_allclose(n, np.asarray(JA.AdaptiveGridLevelSet(
        jag).normal(jnp.asarray(pts))), atol=1e-6)
    x = np.stack([rng.uniform(0.4, 0.6, 400), rng.uniform(0.33, 0.45, 400),
                  rng.uniform(0.4, 0.6, 400)], -1).astype(np.float32)
    st = TM.make_mpm_state(x, dx=0.025, device=CPU, block_capacity=512)
    model = FixedCorotated.from_young_poisson(1e4, 0.3, device=CPU)
    g = torch.tensor([0.0, -9.8, 0.0])
    sim_a = TM.MPMSim(model, g, (Collider(ls, ColliderType.sticky),))
    sim_b = TM.MPMSim(model, g, (Collider(floor, ColliderType.sticky),))
    jsim = JM.MPMSim(model=JC.FixedCorotated.from_young_poisson(1e4, 0.3),
                     gravity=jnp.asarray([0.0, -9.8, 0.0]),
                     colliders=(JCol.Collider(JA.AdaptiveGridLevelSet(jag),
                                              JCol.ColliderType.sticky),))
    sa, sb = st, st
    js = JM.make_mpm_state(jnp.asarray(x), dx=0.025, block_capacity=512)
    for _ in range(3):
        sa = TM.explicit_step(sim_a, sa, 2e-4)
        sb = TM.explicit_step(sim_b, sb, 2e-4)
        js = _jax_sdf_collider_step(jsim.model, jsim.gravity, jag, js,
                                    jnp.float32(2e-4))
    np.testing.assert_allclose(sa.particles["x"].numpy(),
                               sb.particles["x"].numpy(), atol=5e-4)
    np.testing.assert_allclose(sa.particles["x"].numpy(),
                               np.asarray(js.particles["x"]), atol=1e-6)
    # the JAX sim's adaptive collider carried across by interop
    isim = interop.sim_from_jax(jsim, CPU)
    np.testing.assert_array_equal(
        isim.colliders[0].levelset.sdf(_t(pts)).numpy(),
        ls.sdf(_t(pts)).numpy())


def test_vdb_roundtrip(rng, tmp_path):
    """adaptive -> VdbGrid -> .vdb -> adaptive keeps the leaf values; the
    port's file equals JAX's byte for byte, and each package reads the
    other's."""
    from zpc_tpu.geometry import vdb_bridge as JB
    from zpc_tpu.utils import vdb as JV
    cells = np.unique(rng.integers(0, 40, (300, 3)).astype(np.int32), axis=0)
    vals = rng.standard_normal(len(cells)).astype(np.float32)
    jg, tg = _both(cells, vals, dx=0.1, capacities=[128, 64, 16],
                   background=0.0)
    tpath, jpath = str(tmp_path / "t.vdb"), str(tmp_path / "j.vdb")
    TV.write_vdb(tpath, [adaptive_to_vdb_grid(tg, name="sdf")])
    JV.write_vdb(jpath, [JB.adaptive_to_vdb_grid(jg, name="sdf")])
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    x = ((cells + 0.5) * 0.1).astype(np.float32)
    back = vdb_grid_to_adaptive(TV.read_vdb(jpath)[0], device=CPU)
    np.testing.assert_allclose(back.probe(_t(x)).numpy(), vals, atol=1e-6)
    jback = JB.vdb_grid_to_adaptive(JV.read_vdb(tpath)[0])
    _same_levels(jback, back)
