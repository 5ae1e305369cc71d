"""The port's 2-D explicit family, cubic B-splines and the incremental
rebin against zpc_tpu on the same seeded numpy inputs.

JAX runs on the CPU (conftest), the port on CPU tensors, where every scan
takes the kernel's plain version.  Tolerances, absolute: the 2x2 SVD, the
QR and the small-matrix helpers 1e-6, the 2-D stresses relative 1e-5;
states x 1e-5, v 2e-4, F and J 1e-5 (tests/test_mpm_binned2.py:158-179's
2-D tolerances, the two sides summing fp32 contributions in different
orders); the incremental rebin's migrations exact (pid, bin_block and
columns).
"""

import dataclasses

import numpy as np
import pytest
import torch

from zpc_tpu_torch import interop, scenes
from zpc_tpu_torch.math import svd as tsvd
from zpc_tpu_torch.math import vecmat as tvm
from zpc_tpu_torch.models import constitutive as tc
from zpc_tpu_torch.ops import scan as tscan
from zpc_tpu_torch.sim import fluid as tfl
from zpc_tpu_torch.sim import fluid_binned2 as tfb
from zpc_tpu_torch.sim import implicit as timp
from zpc_tpu_torch.sim import mpm as tmpm
from zpc_tpu_torch.sim import mpm_binned2 as tb2

# the cuda tests run where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.geometry.collider import Collider as JCollider
    from zpc_tpu.geometry.collider import ColliderType as JColliderType
    from zpc_tpu.geometry.levelset import HalfSpace as JHalfSpace
    from zpc_tpu.math import svd as jsvd
    from zpc_tpu.math import vecmat as jvm
    from zpc_tpu.models import constitutive as jc
    from zpc_tpu.sim import fluid as jfl
    from zpc_tpu.sim import fluid_binned2 as jfb
    from zpc_tpu.sim import implicit as jimp
    from zpc_tpu.sim import mpm as jmpm
    from zpc_tpu.sim import mpm_binned2 as jb2
except ImportError:
    pass

CPU = torch.device("cpu")
TOL = dict(x=1e-5, v=2e-4, F=1e-5, J=1e-5, C=2e-3)
SMALL = 1e-6


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


def _strained2(rng, n=256, strain=0.2):
    """Rotations times symmetric stretches within +-strain, 2x2."""
    th = rng.uniform(-np.pi, np.pi, n)
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2)
    S = np.eye(2) + rng.uniform(-strain, strain, (n, 2, 2))
    S = 0.5 * (S + np.swapaxes(S, 1, 2))
    return (R @ S).astype(np.float32)


def _assert_close(got, want, keys=("x", "v", "F")):
    a, b = interop.state_to_numpy(want), interop.state_to_numpy(got)
    for k in keys:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=TOL[k],
                                   err_msg=k)


# ---------------------------------------------------------------------------
# small-matrix math
# ---------------------------------------------------------------------------

def test_svd2x2_and_qr3x3_match_jax():
    rng = np.random.default_rng(41)
    A = np.concatenate([_strained2(rng),
                        rng.standard_normal((256, 2, 2)).astype(np.float32),
                        np.zeros((1, 2, 2), np.float32)])
    for got, want in zip(tsvd.svd2x2(_t(A)), jsvd.svd2x2(jnp.asarray(A))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=SMALL)
    U, s, V = (a.numpy() for a in tsvd.svd2x2(_t(A)))
    np.testing.assert_allclose(U @ (s[..., None] * np.swapaxes(V, 1, 2)), A,
                               rtol=0, atol=1e-5)
    B = rng.standard_normal((256, 3, 3)).astype(np.float32)
    for got, want in zip(tsvd.qr3x3(_t(B)), jsvd.qr3x3(jnp.asarray(B))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=SMALL)


def test_vecmat_matches_jax():
    rng = np.random.default_rng(43)
    A2 = rng.standard_normal((64, 2, 2)).astype(np.float32)
    B2 = rng.standard_normal((64, 2, 2)).astype(np.float32)
    A3 = rng.standard_normal((64, 3, 3)).astype(np.float32)
    w = rng.standard_normal((64, 3)).astype(np.float32)
    cases = [("mm", tvm.mm, jvm.mm, (A2, B2)),
             ("det3", tvm.det3, jvm.det3, (A2,)),
             ("det3", tvm.det3, jvm.det3, (A3,)),
             ("mv", tvm.mv, jvm.mv, (A3, w)),
             ("outer", tvm.outer, jvm.outer, (w, w[::-1].copy())),
             ("trace", tvm.trace, jvm.trace, (A2,)),
             ("frobenius", tvm.frobenius, jvm.frobenius, (A3,)),
             ("identity_like", tvm.identity_like, jvm.identity_like, (A2,)),
             ("cross_matrix", tvm.cross_matrix, jvm.cross_matrix, (w,)),
             ("cof", tvm.cof3, jc._cof, (A2,))]
    for name, tf, jf, args in cases:
        np.testing.assert_allclose(
            tf(*[_t(a) for a in args]).numpy(),
            np.asarray(jf(*[jnp.asarray(a) for a in args])), rtol=0,
            atol=1e-5, err_msg=name)


def _models2():
    """Every elastic model the JAX package runs in 2-D (AnisotropicArap's
    fibre is 3-D in both packages)."""
    mu, lam = jc.lame_parameters(1e4, 0.3)
    f = jnp.float32
    return {
        "NeoHookean": jc.NeoHookean(f(mu), f(lam)),
        "FixedCorotated": jc.FixedCorotated(f(mu), f(lam)),
        "StvkWithHencky": jc.StvkWithHencky(f(mu), f(lam)),
        "EquationOfState": jc.EquationOfState(f(0.0), f(lam), f(7.0)),
    }


@pytest.mark.parametrize("name", ["EquationOfState", "FixedCorotated",
                                  "NeoHookean", "StvkWithHencky"])
def test_models_2d_match_jax(name):
    """psi, P, tau and dP(F)[dF] of each model on strained 2x2 F, relative
    1e-5 of the largest entry."""
    jm = _models2()[name]
    tm = interop.sim_from_jax(jmpm.MPMSim(
        model=jm, gravity=jnp.zeros(2)), CPU).model
    rng = np.random.default_rng(47)
    F = _strained2(rng)
    dF = (0.1 * rng.standard_normal(F.shape)).astype(np.float32)
    for what in ("psi", "first_piola", "kirchhoff"):
        got = getattr(tm, what)(_t(F)).numpy()
        want = np.asarray(getattr(jm, what)(jnp.asarray(F)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)
    got = tm.linearize(_t(F))(_t(dF)).numpy()
    want = np.asarray(jm.dP_dF_action(jnp.asarray(F), jnp.asarray(dF)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_corotated_2d_differential_at_rest():
    """At F = I the JAX 2x2 SVD differentiates sqrt and atan2 at 0, so its
    force differential is NaN, and with it the 2-D implicit step from rest
    (a reference fault, ROADMAP.md §3).  The port's is the exact
    linearisation mu (dF + dF^T) + lam tr(dF) I: R = U V^T turns by
    atan2(H, E) alone, which needs no derivative at 0."""
    jm = _models2()["FixedCorotated"]
    tm = interop.sim_from_jax(jmpm.MPMSim(model=jm, gravity=jnp.zeros(2)),
                              CPU).model
    rng = np.random.default_rng(53)
    dF = rng.standard_normal((16, 2, 2)).astype(np.float32)
    eye = np.broadcast_to(np.eye(2, dtype=np.float32), dF.shape).copy()
    jdp = np.asarray(jm.dP_dF_action(jnp.asarray(eye), jnp.asarray(dF)))
    assert np.isnan(jdp).all()
    got = tm.linearize(_t(eye))(_t(dF)).numpy()
    mu, lam = float(tm.mu), float(tm.lam)
    want = mu * (dF + np.swapaxes(dF, 1, 2)) + \
        lam * np.trace(dF, axis1=1, axis2=2)[:, None, None] * np.eye(2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_implicit_2d_from_rest(monkeypatch):
    """The 2-D implicit step from rest (F = I) with random velocities.
    JAX's operator is NaN there (above), so its CG stops at iteration 0 on
    a NaN residual and returns its initial guess, the explicit predictor:
    the solve is skipped without a sign (a reference fault, ROADMAP.md
    §3).  The port's CG runs, and its step matches JAX's from a strain of
    1e-5, where JAX's derivative is finite."""
    rng = np.random.default_rng(59)
    x = jnp.asarray(rng.uniform(0.3, 0.7, (256, 2)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((256, 2)) * 0.1, jnp.float32)
    jst = jmpm.make_mpm_state(x, dx=0.05, block_capacity=256, velocity=v)
    jsim = jmpm.MPMSim(model=jc.FixedCorotated.from_young_poisson(1e4, 0.3),
                       gravity=jnp.asarray([0.0, -9.8]))
    near = type(jst)(jst.particles.update(F=jnp.broadcast_to(
        jnp.diag(jnp.asarray([1.0 + 1e-5, 1.0 - 1e-5])), (256, 2, 2))),
        jst.grid, jst.max_vel)
    solves, solve = [], jimp.cg

    def cg(*args, **kw):
        res = solve(*args, **kw)
        solves.append(res)
        return res
    monkeypatch.setattr(jimp, "cg", cg)
    step = jax.jit(lambda s: (jimp.implicit_step(
        jsim, s, jnp.float32(1e-3), cg_iters=20), solves[-1].iters,
        solves[-1].residual))
    rest, iters, residual = step(jst)
    assert int(iters) == 0 and np.isnan(float(residual))
    ref, iters, _ = step(near)
    assert int(iters) > 0
    titers, tsolve = [], timp.cg

    def tcg(*args, **kw):
        res = tsolve(*args, **kw)
        titers.append(res.iters)
        return res
    monkeypatch.setattr(timp, "cg", tcg)
    out = timp.implicit_step(interop.sim_from_jax(jsim, CPU),
                             interop.state_from_jax(jst, CPU), 1e-3,
                             cg_iters=20)
    assert titers[0] > 0
    _assert_close(out, ref, ("x", "v"))
    np.testing.assert_allclose(out.particles["F"].numpy() - np.eye(2),
                               np.asarray(ref.particles["F"] -
                                          near.particles["F"]),
                               rtol=0, atol=TOL["F"])
    skipped = np.abs(np.asarray(rest.particles["v"]) -
                     out.particles["v"].numpy()).max()
    assert skipped > TOL["v"]


# ---------------------------------------------------------------------------
# the unbinned 2-D steps (tests/test_mpm2d.py, tests/test_fluid.py)
# ---------------------------------------------------------------------------

def _jsim2(E=1e4, colliders=(), order=2):
    return jmpm.MPMSim(model=jc.FixedCorotated.from_young_poisson(E, 0.3),
                       gravity=jnp.asarray([0.0, -9.8]),
                       colliders=colliders, order=order)


def _ground2(y, kind, friction=0.0):
    return JCollider(JHalfSpace(jnp.asarray([0.0, y]),
                                jnp.asarray([0.0, 1.0])), kind,
                     friction=friction)


def _run_both(jsim, jst, dt, steps):
    """``steps`` unbinned steps on both sides."""
    step = jax.jit(lambda s: jmpm.explicit_step(jsim, s, jnp.float32(dt)))
    ref = jst
    for _ in range(steps):
        ref = step(ref)
    tsim = interop.sim_from_jax(jsim, CPU)
    out = interop.state_from_jax(jst, CPU)
    for _ in range(steps):
        out = tmpm.explicit_step(tsim, out, torch.tensor(dt))
    return out, ref


@pytest.mark.parametrize("case", ["mass", "free_fall", "ground", "order3"])
def test_explicit_step_2d_matches_jax(case):
    """tests/test_mpm2d.py's three scenes (one step; 5 steps of free fall;
    30 steps onto a sticky ground) and the free fall with cubic
    B-splines."""
    rng = np.random.default_rng(42)
    if case == "ground":
        x = jnp.asarray(rng.uniform(0.12, 0.3, (256, 2)), jnp.float32)
        jst = jmpm.make_mpm_state(
            x, dx=0.02, block_capacity=512,
            velocity=jnp.tile(jnp.asarray([[0.0, -1.0]]), (256, 1)))
        jsim = _jsim2(colliders=(_ground2(0.1, JColliderType.sticky),))
        out, ref = _run_both(jsim, jst, 5e-4, 30)
        assert out.particles["x"][:, 1].min() > 0.1 - 0.02 - 1e-3
    else:
        n = 256 if case == "mass" else 128
        x = jnp.asarray(rng.uniform(0.3, 0.7, (n, 2)), jnp.float32)
        jst = jmpm.make_mpm_state(x, dx=0.05, block_capacity=256)
        jsim = _jsim2(order=3 if case == "order3" else 2)
        steps, dt = (1, 1e-4) if case == "mass" else (5, 1e-3)
        out, ref = _run_both(jsim, jst, dt, steps)
        np.testing.assert_allclose(out.grid.data["m"].sum().item(),
                                   float(jnp.sum(jst.particles["m"])),
                                   rtol=1e-5)
    assert out.grid.dim == 2
    _assert_close(out, ref)


def _jeos():
    return jc.EquationOfState(mu=jnp.float32(0.0), lam=jnp.float32(1e4),
                              gamma=jnp.float32(7.15))


def test_fluid_2d_matches_jax():
    """tests/test_fluid.py:107 (one 2-D step of 256 particles) and :194
    (4 binned steps of 384 with a velocity), each against JAX's."""
    rng = np.random.default_rng(0)
    jsim = jmpm.MPMSim(model=_jeos(), gravity=jnp.asarray([0.0, -9.8]))
    tsim = interop.sim_from_jax(jsim, CPU)
    x = jnp.asarray(rng.uniform(0.3, 0.7, (256, 2)), jnp.float32)
    jst = jfl.make_fluid_state(x, dx=0.05, block_capacity=256)
    ref = jax.jit(lambda s: jfl.explicit_fluid_step(
        jsim, s, jnp.float32(1e-4)))(jst)
    out = tfl.explicit_fluid_step(tsim, interop.state_from_jax(jst, CPU),
                                  1e-4)
    _assert_close(out, ref, ("x", "v", "J"))
    x = jnp.asarray(rng.uniform(0.3, 0.7, (384, 2)), jnp.float32)
    v0 = jnp.broadcast_to(jnp.asarray([0.1, -0.4]), (384, 2))
    jst = jfl.make_fluid_state(x, dx=0.05, block_capacity=256, velocity=v0)
    jcfg = jb2.BinnedConfig2(bins_capacity=64)
    ref, jov = jax.jit(lambda s: jfb.rollout_fluid_binned2(
        jsim, s, jnp.float32(1e-4), jcfg, 4))(jst)
    out, ov = tfb.rollout_fluid_binned2(
        tsim, interop.state_from_jax(jst, CPU), torch.tensor(1e-4),
        interop.config_from_jax(jcfg), 4)
    assert not bool(jov) and not bool(ov)
    _assert_close(out, ref, ("x", "v", "J", "C"))


# ---------------------------------------------------------------------------
# the binned 2-D step (tests/test_mpm_binned2.py:158-179)
# ---------------------------------------------------------------------------

def _strained_state(jst, rng, n):
    F0 = jnp.broadcast_to(jnp.diag(jnp.asarray([1.08, 0.94])), (n, 2, 2))
    C0 = jnp.asarray(rng.standard_normal((n, 2, 2)) * 0.1, jnp.float32)
    return type(jst)(jst.particles.update(F=F0, C=C0), jst.grid,
                     jst.max_vel)


def _binned_both(jsim, jst, dt, jcfg, steps):
    ref, jov = jax.jit(lambda s: jb2.rollout_binned2(
        jsim, s, jnp.float32(dt), jcfg, steps))(jst)
    rebins = []
    tsim = interop.sim_from_jax(jsim, CPU)
    cfg = interop.config_from_jax(jcfg)
    tst = interop.state_from_jax(jst, CPU)

    def rebin(s):
        rebins.append(1)
        return tb2.rebin_adaptive(tsim, s, cfg)
    st = tb2.adaptive_chain(
        lambda s: tb2.explicit_step_binned2(tsim, s, torch.tensor(dt), cfg,
                                            rebin=False), rebin,
        tb2.bin_state(tsim, tst, cfg), steps)
    assert not bool(jov) and not bool(st.overflow)
    return tb2.unbin_state(st, tst), ref, st, len(rebins)


def test_binned_2d_matches_jax():
    """tests/test_mpm_binned2.py:158's case: 600 particles, a strained F
    and random C, 3 steps; the port's binned rollout against JAX's binned
    rollout and against JAX's unbinned steps."""
    rng = np.random.default_rng(42)
    x = jnp.asarray(rng.uniform(0.2, 0.8, (600, 2)), jnp.float32)
    jst = _strained_state(jmpm.make_mpm_state(x, dx=0.05, block_capacity=256),
                          rng, 600)
    jsim = _jsim2()
    out, ref, st, _ = _binned_both(jsim, jst, 1e-4,
                                   jb2.BinnedConfig2(bins_capacity=64), 3)
    assert st.cols.shape[1] == 14 and not st.has_jp
    _assert_close(out, ref)
    step = jax.jit(lambda s: jmpm.explicit_step(jsim, s, jnp.float32(1e-4)))
    oracle = jst
    for _ in range(3):
        oracle = step(oracle)
    _assert_close(out, oracle)


def test_binned_2d_rebins_onto_the_ground():
    """The 2-D ground scene with a Jp column (the 15-column layout, Jp
    carried), a cloud spreading at 20 /s as it falls onto a slip ground
    with friction, 60 binned steps at dt 5e-4: the chain rebins (the
    spread is what recentering cannot absorb), and the states match JAX's
    binned rollout.  The ground is at y = 0.107, off the node lines: on a
    node line (0.1 = 5 dx) a node's inside test is a tie of fp32
    rounding, which the recentred grid (nodes at k dx + origin) and an
    unshifted one (k dx) break differently."""
    rng = np.random.default_rng(61)
    x = rng.uniform(0.12, 0.3, (400, 2)).astype(np.float32)
    v = (20.0 * (x - 0.21) + np.asarray([0.3, -1.0])).astype(np.float32)
    jst = jmpm.make_mpm_state(
        jnp.asarray(x), dx=0.02, block_capacity=512, capacity=448,
        with_Jp=True, Jp0=1.0, velocity=jnp.asarray(v))
    jsim = _jsim2(colliders=(_ground2(0.107, JColliderType.slip, 0.2),))
    out, ref, st, rebins = _binned_both(
        jsim, jst, 5e-4, jb2.BinnedConfig2(bins_capacity=64), 60)
    assert rebins >= 1 and st.has_jp and st.cols.shape[1] == 15
    _assert_close(out, ref)
    np.testing.assert_array_equal(out.particles["Jp"].numpy(),
                                  np.asarray(ref.particles["Jp"]))


def test_binstate_2d_layouts_cross():
    """The 11-, 14- and 15-column 2-D bin states cross field for field;
    the origin moves to the column the port keeps it in."""
    rng = np.random.default_rng(67)
    x = jnp.asarray(rng.uniform(0.3, 0.7, (300, 2)), jnp.float32)
    cfg = jb2.BinnedConfig2(bins_capacity=16)
    fsim = jmpm.MPMSim(model=_jeos(), gravity=jnp.asarray([0.0, -9.8]))
    binner = jax.jit(lambda s: jb2.bin_state(_jsim2(), s, cfg))
    states = {
        11: jax.jit(lambda s: jfb.bin_fluid_state(fsim, s, cfg))(
            jfl.make_fluid_state(x, dx=0.05, block_capacity=64)),
        14: binner(jmpm.make_mpm_state(x, dx=0.05, block_capacity=64)),
        15: binner(jmpm.make_mpm_state(x, dx=0.05, block_capacity=64,
                                       with_Jp=True, Jp0=1.0)),
    }
    for w, jbst in states.items():
        tbst = interop.binstate_from_jax(jbst, CPU)
        assert tbst.cols.shape[1] == w and tbst.has_jp == (w == 15)
        assert tbst.nbr8.shape[1] == 4
        a, b = interop.state_to_numpy(jbst), interop.state_to_numpy(tbst)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        # the port's own binning of the same state is JAX's, lane for lane
        tst = (interop.state_from_jax(jfl.make_fluid_state(
            x, dx=0.05, block_capacity=64), CPU) if w == 11 else None)
        if tst is not None:
            mine = tfb.bin_fluid_state(interop.sim_from_jax(fsim, CPU), tst,
                                       interop.config_from_jax(cfg))
            m = interop.state_to_numpy(mine)
            for k in a:
                np.testing.assert_array_equal(m[k], a[k], err_msg=k)


# ---------------------------------------------------------------------------
# the incremental rebin (tests/test_mpm_binned2.py:220-320)
# ---------------------------------------------------------------------------

def _shifted(shift_cells, migrate=512, reserve=1, dim=3):
    """tests/test_mpm_binned2.py's TestIncrementalRebin._shifted: a binned
    cloud contracted along axis 0 (edges in by ``shift_cells``, the
    centre fixed), or translated when ``shift_cells`` >= 4; both packages'
    bin states."""
    rng = np.random.default_rng(42)
    n = 768 if dim == 3 else 600
    x = jnp.asarray(rng.uniform(0.3, 0.7, (n, dim)), jnp.float32)
    jst = jmpm.make_mpm_state(x, dx=0.05, block_capacity=256)
    jsim = jmpm.MPMSim(model=jc.FixedCorotated.from_young_poisson(1e4, 0.3),
                       gravity=jnp.asarray([0.0, -9.8, 0.0][:dim]))
    jcfg = jb2.BinnedConfig2(bins_capacity=96, migrate_capacity=migrate,
                             reserve_bins=reserve)
    jbst = jax.jit(lambda s: jb2.bin_state(jsim, s, jcfg))(jst)
    alive = jbst.pid >= 0
    x0 = jbst.cols[:, 0]
    if shift_cells < 4:
        newx0 = jnp.where(alive, 0.5 + (1.0 - shift_cells / 4.0) *
                          (x0 - 0.5), x0)
    else:
        newx0 = jnp.where(alive, x0 + shift_cells * 0.05, x0)
    jbst = dataclasses.replace(jbst, cols=jbst.cols.at[:, 0].set(newx0))
    return jsim, jst, jcfg, jbst


def _assert_migration_equal(got, ok, jnst, jok):
    assert bool(ok) == bool(jok)
    a, b = interop.state_to_numpy(jnst), interop.state_to_numpy(got)
    for k in ("pid", "bin_block", "cols", "needs_rebin"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("case", ["migrate", "capacity", "missing_block",
                                  "migrate_2d"])
def test_rebin_incremental_matches_jax(case):
    """The migration of JAX's cases lane for lane: a contraction by 1.2
    cells migrates (ok); with m_cap 4 or past the dilated table (a 6-cell
    translation) it must fall back (not ok); the same contraction in
    2-D."""
    shift, m_cap, dim = {"migrate": (1.2, 512, 3), "capacity": (1.2, 4, 3),
                         "missing_block": (6.0, 512, 3),
                         "migrate_2d": (1.2, 512, 2)}[case]
    jsim, jst, jcfg, jbst = _shifted(shift, dim=dim)
    jnst, jok = jax.jit(lambda s: jb2._rebin_incremental(
        jsim, s, jcfg, m_cap))(jbst)
    tsim = interop.sim_from_jax(jsim, CPU)
    tcfg = interop.config_from_jax(jcfg)
    tbst = interop.binstate_from_jax(jbst, CPU)
    nst, ok = tb2._rebin_incremental(tsim, tbst, tcfg, m_cap)
    _assert_migration_equal(nst, ok, jnst, jok)
    assert bool(ok) == (case in ("migrate", "migrate_2d"))
    if not bool(ok):
        return
    # a second pass moves nothing; physics after the migration equals
    # physics after a full rebin
    again, ok2 = tb2._rebin_incremental(tsim, nst, tcfg, m_cap)
    assert bool(ok2) and torch.equal(again.pid, nst.pid)
    dt = 1e-4
    a = tb2.explicit_step_binned2(tsim, nst, dt, tcfg, rebin=False)
    b = tb2.explicit_step_binned2(tsim, tb2._rebin(tsim, tbst, tcfg), dt,
                                  tcfg, rebin=False)
    tst = interop.state_from_jax(jst, CPU)
    ua, ub = tb2.unbin_state(a, tst), tb2.unbin_state(b, tst)
    assert not bool(a.overflow) and not bool(b.overflow)
    for k in ("x", "v", "F"):
        np.testing.assert_allclose(ua.particles[k].numpy(),
                                   ub.particles[k].numpy(), rtol=0,
                                   atol=2e-5)


def test_rebin_adaptive_falls_back_on_the_host():
    """rebin_adaptive takes the migration when it fits and the full sort
    when it does not: the same states as JAX's lax.cond."""
    for shift in (1.2, 6.0):
        jsim, _, jcfg, jbst = _shifted(shift)
        jout = jax.jit(lambda s: jb2.rebin_adaptive(jsim, s, jcfg))(jbst)
        out = tb2.rebin_adaptive(interop.sim_from_jax(jsim, CPU),
                                 interop.binstate_from_jax(jbst, CPU),
                                 interop.config_from_jax(jcfg))
        a, b = interop.state_to_numpy(jout), interop.state_to_numpy(out)
        for k in ("pid", "bin_block", "nbr8", "cols", "table_keys"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_rollout_with_migration_and_reserve_bins():
    """tests/test_mpm_binned2.py:298 and :305: with migrate_capacity 512
    and one reserve bin, bin_state equals JAX's lane for lane, every
    active block owns at least K free lanes, and a 3-step rollout matches
    the unbinned steps."""
    rng = np.random.default_rng(42)
    x = jnp.asarray(rng.uniform(0.3, 0.7, (768, 3)), jnp.float32)
    jst = jmpm.make_mpm_state(x, dx=0.05, block_capacity=256)
    jsim = jmpm.MPMSim(model=jc.FixedCorotated.from_young_poisson(1e4, 0.3),
                       gravity=jnp.asarray([0.0, -9.8, 0.0]))
    jcfg = jb2.BinnedConfig2(bins_capacity=96, migrate_capacity=512,
                             reserve_bins=1)
    tsim, tcfg = interop.sim_from_jax(jsim, CPU), \
        interop.config_from_jax(jcfg)
    tst = interop.state_from_jax(jst, CPU)
    bst = tb2.bin_state(tsim, tst, tcfg)
    a = interop.state_to_numpy(
        jax.jit(lambda s: jb2.bin_state(jsim, s, jcfg))(jst))
    b = interop.state_to_numpy(bst)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    dead = (bst.pid < 0).reshape(-1, tb2.K).sum(1)
    free = {}
    for slot, d in zip(bst.bin_block.tolist(), dead.tolist()):
        if slot >= 0:
            free[slot] = free.get(slot, 0) + d
    assert free and min(free.values()) >= tb2.K
    step = jax.jit(lambda s: jmpm.explicit_step(jsim, s, jnp.float32(1e-4)))
    ref = jst
    for _ in range(3):
        ref = step(ref)
    out, overflow = tb2.rollout_binned2(tsim, tst, torch.tensor(1e-4), tcfg,
                                        3)
    assert not bool(overflow)
    _assert_close(out, ref)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel has no CPU mode")
    return torch.device("cuda")


def _discs_run(dev, steps):
    sim, st = scenes.discs_2d(8192, 1.0 / 128, dev)
    cfg = scenes.discs_2d_config(st.particles.capacity)
    out, overflow = tb2.rollout_binned2(sim, st, 1e-4, cfg, steps)
    return out, overflow


@pytest.mark.cuda
def test_discs_2d_on_cuda():
    """examples/mpm2d.py's discs binned on the card (chip_smoke phases
    23-24): bin_state launches the scan kernel, and 100 steps match the
    CPU's."""
    dev = _needs_card()
    before = tscan.LAUNCHES
    out, overflow = _discs_run(dev, 100)
    assert tscan.LAUNCHES >= before + 4 and not bool(overflow)
    ref, _ = _discs_run(CPU, 100)
    for k in ("x", "v", "F"):
        np.testing.assert_allclose(out.particles[k].cpu().numpy(),
                                   ref.particles[k].numpy(), rtol=0,
                                   atol=TOL[k])


@pytest.mark.cuda
def test_incremental_rebin_on_cuda():
    """The migration on the card equals the CPU's lane for lane, and its
    scans launch the kernel (chip_smoke phase 26)."""
    dev = _needs_card()
    sim, st, dt = scenes.readme_scene(1.0 / 32, CPU)
    cfg = tb2.BinnedConfig2(bins_capacity=128, migrate_capacity=2048,
                            reserve_bins=1)
    bst = tb2.bin_state(sim, st, cfg)
    bst = dataclasses.replace(bst, cols=torch.cat(
        [bst.cols[:, :1] * 0.98 + 0.01, bst.cols[:, 1:]], 1))
    ref, rok = tb2._rebin_incremental(sim, bst, cfg, cfg.migrate_capacity)
    before = tscan.LAUNCHES
    got, ok = tb2._rebin_incremental(_to(sim, dev), _to(bst, dev), cfg,
                                     cfg.migrate_capacity)
    assert tscan.LAUNCHES == before + 3
    assert bool(ok) == bool(rok)
    for k in ("pid", "cols"):
        assert torch.equal(getattr(got, k).cpu(), getattr(ref, k))


def _to(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_to(v, dev) for v in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _to(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    return obj


@pytest.mark.cuda
def test_rest_of_the_family_on_cuda():
    """The 2-D fluid, the 2-D implicit step and the order-3 step on the
    card against the CPU (chip_smoke phase 25)."""
    dev = _needs_card()
    rng = np.random.default_rng(0)
    x2 = rng.uniform(0.3, 0.7, (384, 2)).astype(np.float32)
    res = {}
    for where in (dev, CPU):
        eos = tc.EquationOfState(torch.tensor(0.0, device=where),
                                 torch.tensor(1e4, device=where),
                                 torch.tensor(7.15, device=where))
        fsim = tmpm.MPMSim(eos, torch.tensor([0.0, -9.8], device=where))
        fst = tfl.make_fluid_state(x2, dx=0.05, device=where,
                                   block_capacity=256)
        fout, _ = tfb.rollout_fluid_binned2(
            fsim, fst, 1e-4, tb2.BinnedConfig2(bins_capacity=64), 4)
        esim = tmpm.MPMSim(tc.FixedCorotated.from_young_poisson(
            1e4, 0.3, device=where), torch.tensor([0.0, -9.8],
                                                  device=where))
        est = tmpm.make_mpm_state(x2, dx=0.05, device=where,
                                  block_capacity=256)
        iout = timp.implicit_step(esim, est, 1e-3, cg_iters=20)
        osim = dataclasses.replace(esim, order=3)
        oout = tmpm.explicit_step(osim, est, 1e-3)
        res[where.type] = (fout, iout, oout)
    for g, c in zip(res["cuda"], res["cpu"]):
        for k in ("x", "v"):
            np.testing.assert_allclose(g.particles[k].cpu().numpy(),
                                       c.particles[k].numpy(), rtol=0,
                                       atol=5e-4)
