"""Plasticity, FLIP and the Jp column through the port's MPM steps
against zpc_tpu on the same inputs: the explicit step with snow
plasticity and with a FLIP blend, the binned path's plasticity cases of
tests/test_mpm_binned2.py, the 27-column layout, and snow hardening.

Inputs are made with seeded numpy and handed to both packages (JAX on the
CPU, the port on CPU tensors).  Tolerances are those of
tests/test_mpm_binned2.py: x 1e-5, v 2e-4 (5e-4 with a collider), F and
Jp 1e-5, absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zpc_tpu.geometry.collider import Collider as JCollider
from zpc_tpu.geometry.collider import ColliderType as JColliderType
from zpc_tpu.geometry.levelset import HalfSpace as JHalfSpace
from zpc_tpu.models.constitutive import FixedCorotated as JFixedCorotated
from zpc_tpu.models.plasticity import SnowPlasticity as JSnowPlasticity
from zpc_tpu.sim import mpm as jmpm
from zpc_tpu.sim import mpm_binned2 as jb2

from zpc_tpu_torch import interop, scenes
from zpc_tpu_torch.sim import mpm as tmpm
from zpc_tpu_torch.sim import mpm_binned2 as tb2

CPU = torch.device("cpu")
TOL = dict(x=1e-5, v=2e-4, F=1e-5, Jp=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jsim(plasticity=None, flip=0.0, colliders=()):
    return jmpm.MPMSim(model=JFixedCorotated.from_young_poisson(1e4, 0.3),
                       gravity=jnp.asarray([0.0, -9.8, 0.0]),
                       colliders=colliders, plasticity=plasticity, flip=flip)


def _assert_states(got, want, atol_v=TOL["v"]):
    a = interop.state_to_numpy(want)
    b = interop.state_to_numpy(got)
    assert a.keys() == b.keys()
    for k, tol in (("x", TOL["x"]), ("v", atol_v), ("F", TOL["F"]),
                   ("Jp", TOL["Jp"])):
        if k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=tol,
                                       err_msg=k)


def _pre_stretched(st, n, diag=(1.2, 0.8, 1.0)):
    F0 = jnp.broadcast_to(jnp.diag(jnp.asarray(diag)), (n, 3, 3))
    return type(st)(st.particles.update(F=F0), st.grid, st.max_vel)


@pytest.mark.parametrize("kind", ["snow", "flip"])
def test_explicit_step_plasticity_and_flip(kind, rng):
    x = jnp.asarray(rng.uniform(0.3, 0.6, (384, 3)), jnp.float32)
    v0 = jnp.asarray(rng.normal(0.0, 0.5, (384, 3)), jnp.float32)
    if kind == "snow":
        sim = _jsim(plasticity=JSnowPlasticity())
        st = _pre_stretched(jmpm.make_mpm_state(
            x, dx=0.05, block_capacity=256, with_Jp=True, Jp0=1.0,
            velocity=v0), 384)
    else:
        sim = _jsim(flip=0.5)
        st = jmpm.make_mpm_state(x, dx=0.05, block_capacity=256, velocity=v0)
    tsim = interop.sim_from_jax(sim, CPU)
    assert tsim.flip == sim.flip
    tst = interop.state_from_jax(st, CPU)
    jstep = jax.jit(lambda s: jmpm.explicit_step(sim, s, jnp.float32(1e-4)))
    for _ in range(3):
        st = jstep(st)
        tst = tmpm.explicit_step(tsim, tst, 1e-4)
    _assert_states(tst, st)
    if kind == "snow":
        assert np.abs(tst.particles["Jp"].numpy() - 1.0).max() > 1e-3


def _compare_binned(sim, st, dt, cfg, steps, atol_v=TOL["v"]):
    out, overflow = jax.jit(
        lambda s: jb2.rollout_binned2(sim, s, dt, cfg, steps))(st)
    tout, toverflow = tb2.rollout_binned2(
        interop.sim_from_jax(sim, CPU), interop.state_from_jax(st, CPU),
        float(dt), interop.config_from_jax(cfg), steps)
    assert not bool(overflow) and not bool(toverflow)
    _assert_states(tout, out, atol_v)
    return tout


class TestBinnedPlasticityMatchesJax:
    """tests/test_mpm_binned2.py test_plasticity and
    test_chunked_collider_plasticity on both packages."""

    def test_plasticity(self, rng):
        x = jnp.asarray(rng.uniform(0.3, 0.6, (256, 3)), jnp.float32)
        st = _pre_stretched(jmpm.make_mpm_state(
            x, dx=0.05, block_capacity=256, with_Jp=True, Jp0=1.0), 256)
        out = _compare_binned(_jsim(plasticity=JSnowPlasticity()), st,
                              jnp.float32(1e-4),
                              jb2.BinnedConfig2(bins_capacity=64), 1)
        assert np.abs(out.particles["Jp"].numpy() - 1.0).max() > 1e-3

    def test_collider_plasticity(self, rng):
        x = jnp.asarray(rng.uniform(0.1, 0.4, (500, 3)), jnp.float32)
        st = jmpm.make_mpm_state(x, dx=0.02, block_capacity=1024,
                                 capacity=640, with_Jp=True, Jp0=1.0)
        ground = JCollider(JHalfSpace(jnp.asarray([0.0, 0.12, 0.0]),
                                      jnp.asarray([0.0, 1.0, 0.0])),
                           JColliderType.slip)
        _compare_binned(_jsim(plasticity=JSnowPlasticity(),
                              colliders=(ground,)), st, jnp.float32(2e-4),
                        jb2.BinnedConfig2(bins_capacity=128,
                                          use_segments=True, chunk_bins=32),
                        4, atol_v=5e-4)

    def test_jp_column_round_trip(self, rng):
        """bin_state packs Jp as the 27th column (dead lanes too), the
        step carries it without plasticity, unbin_state restores it."""
        x = rng.uniform(0.3, 0.6, (300, 3)).astype(np.float32)
        st = tmpm.make_mpm_state(x, dx=0.05, device=CPU, block_capacity=256,
                                 capacity=320, with_Jp=True, Jp0=0.7)
        sim = interop.sim_from_jax(_jsim(), CPU)
        cfg = tb2.BinnedConfig2(bins_capacity=64)
        bst = tb2.bin_state(sim, st, cfg)
        assert bst.cols.shape[1] == 27 and bst.has_jp
        bst = tb2.explicit_step_binned2(sim, bst, 1e-4, cfg, rebin=True)
        out = tb2.unbin_state(bst, st)
        np.testing.assert_array_equal(out.particles["Jp"].numpy(),
                                      st.particles["Jp"].numpy())
        jst = jmpm.make_mpm_state(jnp.asarray(x), dx=0.05, block_capacity=256,
                                  capacity=320, with_Jp=True, Jp0=0.7)
        jcfg = jb2.BinnedConfig2(bins_capacity=64)
        jbst = jax.jit(lambda s: jb2.bin_state(_jsim(), s, jcfg))(jst)
        np.testing.assert_array_equal(
            tb2.bin_state(sim, interop.state_from_jax(jst, CPU),
                          cfg).cols.numpy(), np.asarray(jbst.cols))



def test_snow_hardens_jp_binned():
    """tests/test_materials.py test_snow_hardens_Jp on the port's binned
    path: a pre-compressed snow state moves volume into Jp and clamps the
    elastic stretches."""
    sim, st, dt = scenes.materials("snow", n=512, dx=1.0 / 32, device=CPU)
    F0 = torch.diag(torch.tensor([0.9, 0.9, 0.9])).expand(512, 3, 3)
    st = tmpm.MPMState(st.particles.update(F=F0.clone()), st.grid,
                       st.max_vel)
    out, _ = tb2.rollout_binned2(sim, st, dt,
                                 tb2.BinnedConfig2(bins_capacity=64), 1)
    Jp = out.particles["Jp"].numpy()
    assert np.isfinite(Jp).all()
    assert (np.abs(Jp - 1.0) > 1e-3).all()
    s_min = np.linalg.svd(out.particles["F"].numpy(), compute_uv=False).min()
    assert s_min > 0.97
