"""The port's J-only fluid pipeline (zpc_tpu_torch.sim.fluid and
fluid_binned2) and the dam-break scene against zpc_tpu on the same inputs.

Inputs are made with seeded numpy and handed to both packages (JAX on the
CPU, the port on CPU tensors, where every scan takes the kernel's plain
version).  Tolerances are those of tests/test_fluid.py: x 1e-5, v 2e-4
(5e-4 with a collider), J 1e-5, absolute.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zpc_tpu_torch import interop, scenes
from zpc_tpu_torch.ops import scan as tscan
from zpc_tpu_torch.sim import fluid as tfluid
from zpc_tpu_torch.sim import fluid_binned2 as tfb
from zpc_tpu_torch.sim import mpm_binned2 as tb2

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.geometry.collider import Collider as JCollider
    from zpc_tpu.geometry.collider import ColliderType as JColliderType
    from zpc_tpu.geometry.levelset import HalfSpace as JHalfSpace
    from zpc_tpu.models.constitutive import (
        EquationOfState as JEquationOfState)
    from zpc_tpu.models.constitutive import FixedCorotated as JFixedCorotated
    from zpc_tpu.sim import fluid as jfluid
    from zpc_tpu.sim import fluid_binned2 as jfb
    from zpc_tpu.sim import mpm as jmpm
    from zpc_tpu.sim import mpm_binned2 as jb2
except ImportError:
    pass

CPU = torch.device("cpu")
TOL = dict(x=1e-5, v=2e-4, J=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jsim(flip=0.0, colliders=()):
    model = JEquationOfState(mu=jnp.float32(0.0), lam=jnp.float32(1e4),
                             gamma=jnp.float32(7.15))
    return jmpm.MPMSim(model=model, gravity=jnp.asarray([0.0, -9.8, 0.0]),
                       colliders=colliders, flip=flip)


def _floor(y, kind):
    return JCollider(JHalfSpace(origin=jnp.asarray([0.0, y, 0.0]),
                                direction=jnp.asarray([0.0, 1.0, 0.0])),
                     kind=kind)


def _assert_close(got, want, atol_v=TOL["v"]):
    a = interop.state_to_numpy(want)
    b = interop.state_to_numpy(got)
    for k, tol in (("x", TOL["x"]), ("v", atol_v), ("J", TOL["J"])):
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("case", ["plain", "flip", "collider"])
def test_explicit_fluid_step_matches_jax(case, rng):
    n = 384
    x = jnp.asarray(rng.uniform(0.3, 0.7, (n, 3)), jnp.float32)
    v0 = jnp.asarray(rng.normal(0.0, 0.5, (n, 3)), jnp.float32)
    sim = {"plain": _jsim(), "flip": _jsim(flip=0.5),
           "collider": _jsim(colliders=(_floor(0.32, JColliderType.slip),))
           }[case]
    st = jfluid.make_fluid_state(x, dx=0.05, block_capacity=512, velocity=v0,
                                 capacity=400)
    tsim = interop.sim_from_jax(sim, CPU)
    tst = interop.state_from_jax(st, CPU)
    assert set(tst.particles.channels) == set(st.particles.channels)
    jstep = jax.jit(lambda s: jfluid.explicit_fluid_step(sim, s,
                                                         jnp.float32(2e-4)))
    for _ in range(4):
        st = jstep(st)
        tst = tfluid.explicit_fluid_step(tsim, tst, 2e-4)
    _assert_close(tst, st, 5e-4 if case == "collider" else TOL["v"])
    np.testing.assert_allclose(tst.grid.data["m"].numpy(),
                               np.asarray(st.grid.data["m"]), rtol=1e-5,
                               atol=1e-9)
    # the port's own state agrees with a fresh one of the port
    fresh = tfluid.make_fluid_state(np.asarray(x), dx=0.05, device=CPU,
                                    block_capacity=512, velocity=np.asarray(
                                        v0), capacity=400)
    b = interop.state_to_numpy(interop.state_from_jax(
        jfluid.make_fluid_state(x, dx=0.05, block_capacity=512, velocity=v0,
                                capacity=400), CPU))
    for k, arr in interop.state_to_numpy(fresh).items():
        np.testing.assert_array_equal(arr, b[k], err_msg=k)


def test_fluid_step_needs_eos():
    sim = interop.sim_from_jax(jmpm.MPMSim(
        model=JFixedCorotated.from_young_poisson(1e4, 0.3),
        gravity=jnp.zeros(3)), CPU)
    st = tfluid.make_fluid_state(np.full((8, 3), 0.5, np.float32), dx=0.05,
                                 device=CPU, block_capacity=16)
    with pytest.raises(TypeError, match="EquationOfState"):
        tfluid.explicit_fluid_step(sim, st, 1e-4)


class TestFluidBinned2MatchesJax:
    """tests/test_fluid.py TestFluidBinned2 test_matches_scatter_fluid and
    test_collider: the port's binned rollout against the JAX oracle
    (explicit_fluid_step) and against the JAX binned rollout."""

    def _compare(self, sim, st, dt, cfg, steps, atol_v=TOL["v"]):
        ref = st
        jstep = jax.jit(lambda s: jfluid.explicit_fluid_step(sim, s, dt))
        for _ in range(steps):
            ref = jstep(ref)
        jout, joverflow = jax.jit(lambda s: jfb.rollout_fluid_binned2(
            sim, s, dt, cfg, steps))(st)
        out, overflow = tfb.rollout_fluid_binned2(
            interop.sim_from_jax(sim, CPU), interop.state_from_jax(st, CPU),
            float(dt), interop.config_from_jax(cfg), steps)
        assert not bool(overflow) and not bool(joverflow)
        _assert_close(out, ref, atol_v)
        _assert_close(out, jout, atol_v)

    def test_matches_scatter_fluid(self, rng):
        x = jnp.asarray(rng.uniform(0.3, 0.7, (768, 3)), jnp.float32)
        v0 = jnp.broadcast_to(jnp.asarray([0.2, -0.5, 0.1]), (768, 3))
        st = jfluid.make_fluid_state(x, dx=0.05, block_capacity=256,
                                     velocity=v0)
        self._compare(_jsim(), st, jnp.float32(1e-4),
                      jb2.BinnedConfig2(bins_capacity=64), steps=5)

    def test_collider(self, rng):
        x = jnp.asarray(rng.uniform(0.3, 0.7, (512, 3)), jnp.float32)
        v0 = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (512, 3))
        st = jfluid.make_fluid_state(x, dx=0.05, block_capacity=256,
                                     velocity=v0)
        sim = _jsim(colliders=(_floor(0.28, JColliderType.slip),))
        self._compare(sim, st, jnp.float32(2e-4),
                      jb2.BinnedConfig2(bins_capacity=64), steps=8,
                      atol_v=5e-4)


def test_bins_capacity_too_small_raises(rng):
    x = rng.uniform(0.3, 0.7, (384, 3)).astype(np.float32)
    st = tfluid.make_fluid_state(x, dx=0.05, device=CPU, block_capacity=256)
    sim = interop.sim_from_jax(_jsim(), CPU)
    with pytest.raises(ValueError, match="bins_capacity"):
        tfb.bin_fluid_state(sim, st, tb2.BinnedConfig2(bins_capacity=2))


def test_bin_and_rebin_parity(rng):
    """bin_fluid_state and a _rebin of the 18-column layout equal JAX's
    integer for integer (stable-sort tie order included)."""
    x = jnp.asarray(rng.uniform(0.3, 0.7, (1000, 3)), jnp.float32)
    st = jfluid.make_fluid_state(x, dx=0.05, block_capacity=256,
                                 capacity=1100)
    sim, cfg = _jsim(), jb2.BinnedConfig2(bins_capacity=96)
    tsim, tcfg = interop.sim_from_jax(sim, CPU), interop.config_from_jax(cfg)
    jbst = jax.jit(lambda s: jfb.bin_fluid_state(sim, s, cfg))(st)
    tbst = tfb.bin_fluid_state(tsim, interop.state_from_jax(st, CPU), tcfg)
    assert tbst.cols.shape[1] == 18 and not tbst.has_jp
    _assert_bins_equal(jbst, tbst)
    jitter = rng.uniform(-0.075, 0.075, (96 * 128, 3)).astype(np.float32)
    alive = np.asarray(jbst.pid) >= 0
    cols = np.asarray(jbst.cols).copy()
    cols[alive, 0:3] += jitter[alive]
    jbst = dataclasses.replace(jbst, cols=jnp.asarray(cols))
    tbst = dataclasses.replace(tbst, cols=torch.from_numpy(cols))
    _assert_bins_equal(jax.jit(lambda s: jb2._rebin(sim, s, cfg))(jbst),
                       tb2.rebin_adaptive(tsim, tbst, tcfg))


def _assert_bins_equal(jst, tst):
    a = interop.state_to_numpy(jst)
    b = interop.state_to_numpy(tst)
    for key in ("pid", "bin_block", "nbr8", "table_keys", "table_count",
                "overflow", "needs_rebin", "cols"):
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)


class _Captured(Exception):
    pass


def _bench_fluid_scene(n, monkeypatch):
    """The scene, sim and BinnedConfig2 of benchmarks/run_all.py
    bench_fluid(n), captured from its own calls (it stops before binning
    anything)."""
    from benchmarks import run_all
    import zpc_tpu.sim.fluid as fluid_mod
    import zpc_tpu.sim.mpm as mpm_mod
    import zpc_tpu.sim.mpm_binned2 as b2_mod

    got = {}
    real_sim = mpm_mod.MPMSim

    def fake_state(x, **kw):
        got["x"], got["state_kw"] = np.asarray(x), kw

    def fake_sim(**kw):
        got["sim"] = real_sim(**kw)
        return got["sim"]

    def fake_cfg(**kw):
        got["cfg"] = kw
        raise _Captured

    monkeypatch.setattr(fluid_mod, "make_fluid_state", fake_state)
    monkeypatch.setattr(mpm_mod, "MPMSim", fake_sim)
    monkeypatch.setattr(b2_mod, "BinnedConfig2", fake_cfg)
    with pytest.raises(_Captured):
        run_all.bench_fluid(n)
    monkeypatch.undo()
    return got


def test_dam_break_scene_matches_bench(monkeypatch):
    """scenes.dam_break(262,144) is bench_fluid's scene array for array,
    with the bench's bins (2,560) and table (4,096)."""
    n = 262_144
    got = _bench_fluid_scene(n, monkeypatch)
    sim, st, dt, cfg = scenes.dam_break(n, CPU)
    assert dt == 2e-4
    assert cfg.bins_capacity == got["cfg"]["bins_capacity"] == 2560
    assert cfg.block_capacity == got["cfg"]["block_capacity"] == 4096
    jst = jfluid.make_fluid_state(jnp.asarray(got["x"]), **got["state_kw"])
    a, b = interop.state_to_numpy(jst), interop.state_to_numpy(st)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert st.grid.block_capacity == jst.grid.block_capacity
    conv = interop.sim_from_jax(got["sim"], CPU)
    for f in ("mu", "lam", "gamma"):
        assert torch.equal(getattr(sim.model, f), getattr(conv.model, f)), f
    assert torch.equal(sim.gravity, conv.gravity)
    (tank,), (jtank,) = sim.colliders, conv.colliders
    assert tank.kind == jtank.kind and tank.friction == jtank.friction
    for attr in ("minimum", "maximum"):
        assert torch.equal(getattr(tank.levelset.base, attr),
                           getattr(jtank.levelset.base, attr))


def test_dam_break_bins_derived_from_n(monkeypatch):
    """Bins follow n: the bench's two values at 262,144 and 1,048,576, and
    at 400,000 enough lanes where the bench's two-point choice (2,560 bins,
    327,680 lanes) cannot hold the particles."""
    got = _bench_fluid_scene(1_048_576, monkeypatch)["cfg"]
    cfg = scenes.dam_break_config(1_048_576)
    assert (cfg.bins_capacity, cfg.block_capacity) == (
        got["bins_capacity"], got["block_capacity"]) == (10240, 8192)
    n = 400_000
    bench = _bench_fluid_scene(n, monkeypatch)["cfg"]
    sim, st, dt, cfg = scenes.dam_break(n, CPU)
    assert bench["bins_capacity"] * tb2.K < n
    assert cfg.bins_capacity == 3907 and cfg.block_capacity == 4096
    with pytest.raises(ValueError, match="bins_capacity"):
        tfb.bin_fluid_state(sim, st, tb2.BinnedConfig2(
            bins_capacity=bench["bins_capacity"]))
    bst = tfb.bin_fluid_state(sim, st, cfg)
    assert not bool(bst.overflow)
    assert int((bst.pid >= 0).sum()) == n
    assert scenes.dam_break_config(4096).bins_capacity == 64


def _jax_chain_with_history(sim, bst, dt, cfg, n_steps):
    """JAX adaptive_chain over the fluid step, recording needs_rebin after
    every step and the rebins through ordered host callbacks."""
    hist, rebins = [], []

    def step(s):
        s = jfb.explicit_fluid_step_binned2(sim, s, dt, cfg, rebin=False)
        jax.debug.callback(lambda a: hist.append(bool(a)), s.needs_rebin,
                           ordered=True)
        return s

    def rebin(s):
        jax.debug.callback(lambda: rebins.append(1), ordered=True)
        return jb2.rebin_adaptive(sim, s, cfg)

    out = jax.jit(lambda s: jb2.adaptive_chain(step, rebin, s, n_steps))(bst)
    jax.block_until_ready(out)
    jax.effects_barrier()
    return out, hist, len(rebins)


def test_slice_dam_break_adaptive_chain(monkeypatch):
    """The fluid path at small size: the dam break at 4,096 particles,
    bin_fluid_state then 120 steps of adaptive_chain on both packages (the
    same needs_rebin history), then one rebin of the final state, equal
    integer for integer."""
    n, steps = 4096, 120
    sim, st, dt, cfg = scenes.dam_break(n, CPU)
    got = _bench_fluid_scene(n, monkeypatch)
    jsim = got["sim"]
    jst = jfluid.make_fluid_state(jnp.asarray(got["x"]), dx=1.0 / 128,
                                  block_capacity=cfg.block_capacity)
    jcfg = jb2.BinnedConfig2(bins_capacity=cfg.bins_capacity,
                             block_capacity=cfg.block_capacity)
    assert interop.config_from_jax(jcfg) == cfg
    jbst = jax.jit(lambda s: jfb.bin_fluid_state(jsim, s, jcfg))(jst)
    jout, jhist, jrebins = _jax_chain_with_history(jsim, jbst,
                                                   jnp.float32(dt), jcfg,
                                                   steps)
    hist, rebins = [], []

    def step(s):
        s = tfb.explicit_fluid_step_binned2(sim, s, dt, cfg, rebin=False)
        hist.append(bool(s.needs_rebin))
        return s

    def rebin(s):
        rebins.append(1)
        return tb2.rebin_adaptive(sim, s, cfg)

    bst = tfb.bin_fluid_state(sim, st, cfg)
    _assert_bins_equal(jbst, bst)
    out = tb2.adaptive_chain(step, rebin, bst, steps)
    assert hist == jhist and len(rebins) == jrebins
    assert not bool(out.overflow)
    np.testing.assert_array_equal(out.grid.transform.matrix.numpy(),
                                  np.asarray(jout.grid.transform.matrix))
    _assert_close(tfb.unbin_fluid_state(out, st),
                  jfb.unbin_fluid_state(jout, jst))
    # one rebin of the same lanes on both sides
    jre = jax.jit(lambda s: jb2.rebin_adaptive(jsim, s, jcfg))(jout)
    tre = tb2.rebin_adaptive(sim, dataclasses.replace(
        out, cols=torch.from_numpy(np.asarray(jout.cols))), cfg)
    _assert_bins_equal(jre, tre)


@pytest.mark.cuda
def test_dam_break_on_cuda_runs_the_scan_kernel():
    """A short dam break on the card: bin_fluid_state and every rebin
    launch the scan kernel (no plain version on a CUDA tensor), and the
    card's binning equals the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel has no CPU mode")
    dev = torch.device("cuda")
    sim, st, dt, cfg = scenes.dam_break(4096, dev)
    before = tscan.LAUNCHES
    bst = tfb.bin_fluid_state(sim, st, cfg)
    torch.cuda.synchronize()
    assert tscan.LAUNCHES > before
    csim, cst, _, _ = scenes.dam_break(4096, CPU)
    ref = tfb.bin_fluid_state(csim, cst, cfg)
    for name in ("pid", "bin_block", "nbr8", "cols"):
        assert torch.equal(getattr(bst, name).cpu(), getattr(ref, name))
    out = tb2.adaptive_chain(
        lambda s: tfb.explicit_fluid_step_binned2(sim, s, dt, cfg,
                                                  rebin=False),
        lambda s: tb2.rebin_adaptive(sim, s, cfg), bst, 50)
    before = tscan.LAUNCHES
    out = tb2.rebin_adaptive(sim, out, cfg)
    torch.cuda.synchronize()
    assert tscan.LAUNCHES > before
    assert not bool(out.overflow)
    assert bool(torch.isfinite(out.cols).all())
