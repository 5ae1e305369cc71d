"""The port's MPM (zpc_tpu_torch.sim) against zpc_tpu on the same inputs.

Inputs are made with seeded numpy and handed to both packages.  JAX runs on
the CPU (conftest), the port on CPU tensors, where every scan takes the
kernel's plain version.  Tolerances are those of tests/test_mpm_binned2.py
(x 1e-5, v 2e-4, F 1e-5, absolute): the two sides sum the same fp32
contributions in different orders (XLA's scatter/einsum vs index_add_).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zpc_tpu.containers.block_table import KEY_SENTINEL as J_SENTINEL
from zpc_tpu.containers.block_table import pack_coords as j_pack_coords
from zpc_tpu.geometry.collider import Collider as JCollider
from zpc_tpu.geometry.collider import ColliderType as JColliderType
from zpc_tpu.geometry.levelset import HalfSpace as JHalfSpace
from zpc_tpu.models.constitutive import FixedCorotated as JFixedCorotated
from zpc_tpu.sim import mpm as jmpm
from zpc_tpu.sim import mpm_binned2 as jb2

import zpc_tpu_torch
from zpc_tpu_torch import interop, scenes
from zpc_tpu_torch.containers.block_table import pack_coords
from zpc_tpu_torch.sim import mpm as tmpm
from zpc_tpu_torch.sim import mpm_binned2 as tb2

CPU = torch.device("cpu")
TOL = dict(x=1e-5, v=2e-4, F=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jsim(colliders=()):
    return jmpm.MPMSim(model=JFixedCorotated.from_young_poisson(1e4, 0.3),
                       gravity=jnp.asarray([0.0, -9.8, 0.0]),
                       colliders=colliders)


def _assert_close(jax_state, torch_state, atol_v=TOL["v"]):
    a = interop.state_to_numpy(jax_state)
    b = interop.state_to_numpy(torch_state)
    np.testing.assert_allclose(b["x"], a["x"], rtol=0, atol=TOL["x"])
    np.testing.assert_allclose(b["v"], a["v"], rtol=0, atol=atol_v)
    np.testing.assert_allclose(b["F"], a["F"], rtol=0, atol=TOL["F"])


def _deformed(st, rng, n, with_C=True):
    F0 = jnp.broadcast_to(jnp.diag(jnp.asarray([1.05, 0.97, 1.0])),
                          (n, 3, 3))
    upd = dict(F=F0)
    if with_C:
        upd["C"] = jnp.asarray(rng.standard_normal((n, 3, 3)) * 0.1,
                               jnp.float32)
    return type(st)(st.particles.update(**upd), st.grid, st.max_vel)


def test_explicit_step_matches_jax(rng):
    x = jnp.asarray(rng.uniform(0.3, 0.7, (768, 3)), jnp.float32)
    st = _deformed(jmpm.make_mpm_state(x, dx=0.05, block_capacity=256),
                   rng, 768)
    sim = _jsim()
    tsim = interop.sim_from_jax(sim, CPU)
    tst = interop.state_from_jax(st, CPU)
    jstep = jax.jit(lambda s: jmpm.explicit_step(sim, s, jnp.float32(1e-4)))
    for _ in range(3):
        st = jstep(st)
        tst = tmpm.explicit_step(tsim, tst, 1e-4)
    _assert_close(st, tst)
    # the grid itself: same active blocks, same node masses
    np.testing.assert_array_equal(np.asarray(st.grid.table.keys),
                                  tst.grid.table.keys.numpy())
    np.testing.assert_allclose(tst.grid.data["m"].numpy(),
                               np.asarray(st.grid.data["m"]), rtol=1e-5,
                               atol=1e-9)


def _compare_rollout(sim, st, dt, cfg, steps=1, atol_v=TOL["v"]):
    out, overflow = jax.jit(
        lambda s: jb2.rollout_binned2(sim, s, dt, cfg, steps))(st)
    tout, toverflow = tb2.rollout_binned2(
        interop.sim_from_jax(sim, CPU), interop.state_from_jax(st, CPU),
        float(dt), interop.config_from_jax(cfg), steps)
    assert bool(overflow) == bool(toverflow)
    assert not bool(toverflow)
    _assert_close(out, tout, atol_v)


class TestRolloutBinned2MatchesJax:
    """Mirrors tests/test_mpm_binned2.py TestBinned2MatchesBaseline."""

    def test_uniform_block(self, rng):
        x = jnp.asarray(rng.uniform(0.3, 0.7, (768, 3)), jnp.float32)
        st = _deformed(jmpm.make_mpm_state(x, dx=0.05, block_capacity=256),
                       rng, 768)
        _compare_rollout(_jsim(), st, jnp.float32(1e-4),
                         jb2.BinnedConfig2(bins_capacity=64))

    def test_multi_step_collider_padding(self, rng):
        x = jnp.asarray(rng.uniform(0.1, 0.4, (500, 3)), jnp.float32)
        st = jmpm.make_mpm_state(x, dx=0.02, block_capacity=1024,
                                 capacity=640)
        ground = JCollider(JHalfSpace(jnp.asarray([0.0, 0.12, 0.0]),
                                      jnp.asarray([0.0, 1.0, 0.0])),
                           JColliderType.slip)
        _compare_rollout(_jsim((ground,)), st, jnp.float32(2e-4),
                         jb2.BinnedConfig2(bins_capacity=128), steps=5)

    def test_skewed_density(self, rng):
        a = rng.uniform(0.30, 0.34, (900, 3))
        b = rng.uniform(0.1, 0.9, (100, 3))
        x = jnp.asarray(np.concatenate([a, b]), jnp.float32)
        st = jmpm.make_mpm_state(x, dx=0.02, block_capacity=2048)
        _compare_rollout(_jsim(), st, jnp.float32(1e-4),
                         jb2.BinnedConfig2(bins_capacity=256))

    def test_translated_origin(self, rng):
        x = jnp.asarray(rng.uniform(10.3, 10.7, (512, 3)), jnp.float32)
        x = x.at[:, 1:].add(-10.0)
        st = jmpm.make_mpm_state(x, dx=0.05, block_capacity=512,
                                 origin=jnp.asarray([10.0, 0.0, 0.0]))
        st = _deformed(st, rng, 512, with_C=False)
        _compare_rollout(_jsim(), st, jnp.float32(1e-4),
                         jb2.BinnedConfig2(bins_capacity=64), steps=3)

    def test_overflow_detected(self, rng):
        # 600 particles over ~64 blocks: K-padding needs ~64 bins >> 5
        x = jnp.asarray(rng.uniform(0.1, 0.9, (600, 3)), jnp.float32)
        st = jmpm.make_mpm_state(x, dx=0.05, block_capacity=512)
        cfg = jb2.BinnedConfig2(bins_capacity=5)
        _, overflow = jax.jit(lambda s: jb2.rollout_binned2(
            _jsim(), s, jnp.float32(1e-4), cfg, 1))(st)
        _, toverflow = tb2.rollout_binned2(
            interop.sim_from_jax(_jsim(), CPU),
            interop.state_from_jax(st, CPU), 1e-4,
            interop.config_from_jax(cfg), 1)
        assert bool(overflow) and bool(toverflow)

    def test_overflow_padding_budget_exhausted(self):
        # counts 100/1/100/99 over 4 blocks, N=400, L=512: npad=112 but the
        # pads sum to 212, so both packages must flag overflow
        counts = [100, 1, 100, 99]
        blocks = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                            np.int32)
        keys = np.concatenate(
            [np.full((c,), np.asarray(j_pack_coords(jnp.asarray(
                blocks[i:i + 1])))[0]) for i, c in enumerate(counts)] +
            [np.full((100,), J_SENTINEL)]).astype(np.int32)
        n = keys.shape[0]
        pid = np.where(keys != J_SENTINEL, np.arange(n), -1).astype(np.int32)
        cols = np.zeros((n, 26), np.float32)
        cfg = jb2.BinnedConfig2(bins_capacity=4)
        jst = jax.jit(lambda k, c, p: jb2._sort_into_bins(
            k, c, p, cfg, nb=64))(jnp.asarray(keys), jnp.asarray(cols),
                                  jnp.asarray(pid))
        tst = tb2._sort_into_bins(torch.from_numpy(keys),
                                  torch.from_numpy(cols),
                                  torch.from_numpy(pid),
                                  interop.config_from_jax(cfg), nb=64)
        assert bool(jst.overflow) and bool(tst.overflow)
        # the same keys must pack identically in the port
        assert np.array_equal(
            pack_coords(torch.from_numpy(blocks)).numpy(),
            np.asarray(j_pack_coords(jnp.asarray(blocks))))

    def test_too_few_lanes_raises(self, rng):
        x = rng.uniform(0.3, 0.7, (300, 3)).astype(np.float32)
        st = tmpm.make_mpm_state(x, dx=0.05, device=CPU, block_capacity=64)
        sim = interop.sim_from_jax(_jsim(), CPU)
        with pytest.raises(ValueError, match="bins_capacity"):
            tb2.bin_state(sim, st, tb2.BinnedConfig2(bins_capacity=2))


def _assert_bins_equal(jst, tst):
    a = interop.state_to_numpy(jst)
    b = interop.state_to_numpy(tst)
    for key in ("pid", "bin_block", "nbr8", "table_keys", "table_count",
                "overflow", "needs_rebin"):
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    np.testing.assert_array_equal(b["cols"], a["cols"])


def test_sort_into_bins_parity(rng):
    """Stable-sort tie order: the port's pid and bin_block after bin_state
    and after a _rebin equal JAX's integer for integer."""
    x = jnp.asarray(rng.uniform(0.3, 0.7, (1000, 3)), jnp.float32)
    st = jmpm.make_mpm_state(x, dx=0.05, block_capacity=256, capacity=1100)
    sim = _jsim()
    cfg = jb2.BinnedConfig2(bins_capacity=96)
    tsim = interop.sim_from_jax(sim, CPU)
    tcfg = interop.config_from_jax(cfg)
    jbst = jax.jit(lambda s: jb2.bin_state(sim, s, cfg))(st)
    tbst = tb2.bin_state(tsim, interop.state_from_jax(st, CPU), tcfg)
    _assert_bins_equal(jbst, tbst)
    # move every live particle by a seeded jitter of up to 1.5 cells, then
    # rebin both from the same lanes
    jitter = rng.uniform(-0.075, 0.075, (96 * 128, 3)).astype(np.float32)
    alive = np.asarray(jbst.pid) >= 0
    cols = np.asarray(jbst.cols).copy()
    cols[alive, 0:3] += jitter[alive]
    jbst = dataclasses.replace(jbst, cols=jnp.asarray(cols))
    tbst = dataclasses.replace(tbst, cols=torch.from_numpy(cols))
    _assert_bins_equal(jax.jit(lambda s: jb2._rebin(sim, s, cfg))(jbst),
                       tb2._rebin(tsim, tbst, tcfg))


def test_translation_needs_no_rebin():
    """Recentering: bulk translation never escapes a window, the origin
    follows the drift by the same shift in both packages."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0.3, 0.7, (512, 3)).astype(np.float32)
    v0 = np.broadcast_to(np.asarray([2.0, 0.0, 0.0], np.float32), (512, 3))
    sim = jmpm.MPMSim(model=JFixedCorotated.from_young_poisson(1e4, 0.3),
                      gravity=jnp.zeros((3,)))
    st = jmpm.make_mpm_state(jnp.asarray(x), dx=0.05, block_capacity=256,
                             velocity=jnp.asarray(v0))
    cfg = jb2.BinnedConfig2(bins_capacity=64, recenter=True)
    tsim = interop.sim_from_jax(sim, CPU)
    tcfg = interop.config_from_jax(cfg)
    tbst = tb2.bin_state(tsim, interop.state_from_jax(st, CPU), tcfg)
    for _ in range(60):                       # 2.4 cells of bulk drift
        tbst = tb2.explicit_step_binned2(tsim, tbst, 1e-3, tcfg,
                                         rebin=False)
        assert not bool(tbst.needs_rebin)
    assert not bool(tbst.overflow)
    ox = float(tbst.grid.transform.matrix[0, 3])
    assert 1.5 * 0.05 < ox < 3.5 * 0.05
    out = tb2.unbin_state(tbst, interop.state_from_jax(st, CPU))
    np.testing.assert_allclose(out.particles["x"].numpy(),
                               x + np.asarray([2.0, 0, 0]) * 60e-3,
                               atol=5e-4)


def _jax_chain_with_history(sim, bst, dt, cfg, n_steps):
    """JAX adaptive_chain, recording (needs_rebin, overflow) after every
    step and a count of rebins through ordered host callbacks."""
    hist, rebins = [], []

    def step(s):
        s = jb2.explicit_step_binned2(sim, s, dt, cfg, rebin=False)
        jax.debug.callback(lambda a, b: hist.append((bool(a), bool(b))),
                           s.needs_rebin, s.overflow, ordered=True)
        return s

    def rebin(s):
        jax.debug.callback(lambda: rebins.append(1), ordered=True)
        return jb2.rebin_adaptive(sim, s, cfg)

    out = jax.jit(lambda s: jb2.adaptive_chain(step, rebin, s, n_steps))(bst)
    jax.block_until_ready(out)
    jax.effects_barrier()
    return out, hist, len(rebins)


def test_slice_block_adaptive_chain():
    """The main path at small size: the bench scene (examples/mpm_block.py)
    at 4096 particles and dx = 1/32, bin_state then adaptive_chain with
    slack 1 and recentering, long enough for the first rebin (the block
    reaches the sticky ground after ~210 steps and the first rebin fires
    at step 236).

    x and v are held to 1e-5 and 2e-4.  F is held to 1e-5 plus twice the
    reference's own spread: over a long free fall the fp32 reference's F
    drifts from the exact F = I by ~1e-5 per 150 steps (a rounding bias
    of the APIC moment under a large uniform velocity; an fp64 run of the
    port stays at 1e-15 and the fp32 port at 1.5e-6), and the JAX
    package's chunked path (the bench's chunk_bins) already differs from
    its unchunked path by ~9e-6 here.
    """
    from examples.mpm_block import build

    n, dx, steps = 4096, 1.0 / 32, 240
    jsim, jst, jdt = build(n, dx, block_capacity=256)
    sim, st, dt = scenes.mpm_block(n, dx, CPU, block_capacity=256)
    # the port's scene is the JAX scene, input for input
    assert dt == jdt
    a = interop.state_to_numpy(jst)
    b = interop.state_to_numpy(st)
    for k in ("x", "v", "F", "C", "m", "vol"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)

    jcfg = jb2.BinnedConfig2(bins_capacity=64, block_capacity=256)
    cfg = interop.config_from_jax(jcfg)
    jbst = jax.jit(lambda s: jb2.bin_state(jsim, s, jcfg))(jst)
    jout, jhist, jrebins = _jax_chain_with_history(
        jsim, jbst, jnp.float32(jdt), jcfg, steps)
    jcfg_chunked = dataclasses.replace(jcfg, chunk_bins=16,
                                       use_segments=True)
    jchunked, chist, _ = _jax_chain_with_history(
        jsim, jbst, jnp.float32(jdt), jcfg_chunked, steps)
    assert chist == jhist

    hist, rebins = [], []

    def step(s):
        s = tb2.explicit_step_binned2(sim, s, dt, cfg, rebin=False)
        hist.append((bool(s.needs_rebin), bool(s.overflow)))
        return s

    def rebin(s):
        rebins.append(1)
        return tb2.rebin_adaptive(sim, s, cfg)

    out = tb2.adaptive_chain(step, rebin, tb2.bin_state(sim, st, cfg), steps)
    assert len(hist) == len(jhist) == steps
    assert hist == jhist
    assert len(rebins) == jrebins >= 1
    assert not bool(out.overflow)
    np.testing.assert_array_equal(
        out.grid.transform.matrix.numpy(),
        np.asarray(jout.grid.transform.matrix))
    ref = interop.state_to_numpy(jb2.unbin_state(jout, jst))
    got = interop.state_to_numpy(tb2.unbin_state(out, st))
    spread = np.abs(interop.state_to_numpy(
        jb2.unbin_state(jchunked, jst))["F"] - ref["F"]).max()
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=TOL["x"])
    np.testing.assert_allclose(got["v"], ref["v"], rtol=0, atol=TOL["v"])
    np.testing.assert_allclose(got["F"], ref["F"], rtol=0,
                               atol=TOL["F"] + 2 * spread)


def test_interop_round_trip(rng):
    x = jnp.asarray(rng.uniform(0.3, 0.7, (300, 3)), jnp.float32)
    st = _deformed(jmpm.make_mpm_state(x, dx=0.05, block_capacity=64,
                                       capacity=320), rng, 320)
    st = jax.jit(lambda s: jmpm.explicit_step(_jsim(), s,
                                              jnp.float32(1e-4)))(st)
    tst = interop.state_from_jax(st, CPU)
    assert tst.particles.size == 300 and tst.particles.capacity == 320
    a, b = interop.state_to_numpy(st), interop.state_to_numpy(tst)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_array_equal(tst.grid.transform.matrix.numpy(),
                                  np.asarray(st.grid.transform.matrix))
    cfg = jb2.BinnedConfig2(bins_capacity=16)
    jbst = jax.jit(lambda s: jb2.bin_state(_jsim(), s, cfg))(st)
    a = interop.state_to_numpy(jbst)
    b = interop.state_to_numpy(interop.binstate_from_jax(jbst, CPU))
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    ground = JCollider(JHalfSpace(jnp.asarray([0.0, 0.1, 0.0]),
                                  jnp.asarray([0.0, 1.0, 0.0])),
                       JColliderType.separate, friction=0.3)
    tsim = interop.sim_from_jax(_jsim((ground,)), CPU)
    assert float(tsim.model.mu) == float(_jsim().model.mu)
    assert tsim.colliders[0].kind.value == "separate"
    assert tsim.colliders[0].friction == pytest.approx(0.3)
    assert interop.config_from_jax(jb2.BinnedConfig2(
        bins_capacity=8, migrate_capacity=4)) == tb2.BinnedConfig2(
            bins_capacity=8, migrate_capacity=4)


@pytest.mark.parametrize("field", [dict(slack=0), dict(reserve_bins=1),
                                   dict(recenter=False),
                                   dict(migrate_capacity=4)])
def test_config_from_jax_rejects_unported(field):
    """The port fixes slack 1 and recentering: other values raise.  The
    reserve bins and the incremental rebin's capacity are ported and
    convert as they are; the TPU-only restructurings convert silently."""
    jcfg = jb2.BinnedConfig2(bins_capacity=8, **field)
    if "slack" in field or "recenter" in field:
        with pytest.raises(NotImplementedError):
            interop.config_from_jax(jcfg)
    else:
        assert interop.config_from_jax(jcfg) == tb2.BinnedConfig2(
            bins_capacity=8, **field)
    cfg = interop.config_from_jax(jb2.BinnedConfig2(
        bins_capacity=8, block_capacity=64, chunk_bins=4, sort_chunk=2,
        use_segments=True))
    assert cfg == tb2.BinnedConfig2(bins_capacity=8, block_capacity=64)


def test_tf32_off():
    assert zpc_tpu_torch.__name__ == "zpc_tpu_torch"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
