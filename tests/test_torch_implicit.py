"""The port's implicit MPM (zpc_tpu_torch.sim.implicit, implicit_binned2)
and the models' force differential against zpc_tpu on the same inputs.

Inputs are made with seeded numpy and handed to both packages (JAX on the
CPU, the port on CPU tensors).  Tolerances, absolute: x 1e-6 and v 5e-4,
those of tests/test_implicit.py's binned-against-scatter checks, and F
1e-5; dP(F)[dF] within 1e-5 of its largest entry.  Those alone would pass
a step that did nothing at a small dt, so what a step changes (x - x0, v
- v0, F - F0) is held too: within 1e-4 of its largest entry plus 4 fp32
ulps of the values, and v must change by more than that.  CG iteration
counts must be equal, the scatter step's included.  Measured: x differs
by at most 1.2e-7, v by 4e-7, F by 3.6e-7 (the 5-step chain), a step's
change by at most 8.6e-5 of its largest entry (F under the Hessian clamp,
two ulps of F), the force differential by 8.8e-7 of its largest entry
(off the one reference fault below), and every CG count is equal.

The reference fault: at equal singular values (F = I included) the JAX
package's closed-form SVD differential drops the divided difference that a
principal-stretch stress such as StvkWithHencky needs there, so that
model's tangent is not the derivative: at F = I it has no shear part, and
with two equal singular values in a random frame it moves by thousands of
stress units under a 1e-6 change of F.  The port carries the same rule;
that last case is held to the reference within twice the reference's own
spread (ROADMAP.md §3).
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch import interop, scenes
from zpc_tpu_torch.models import constitutive as tc
from zpc_tpu_torch.sim import implicit as timp
from zpc_tpu_torch.sim import implicit_binned2 as ti2
from zpc_tpu_torch.sim import mpm_binned2 as tb2

# the cuda tests run where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.models import constitutive as jc
    from zpc_tpu.sim import implicit as jimp
    from zpc_tpu.sim import implicit_binned2 as ji2
    from zpc_tpu.sim import mpm as jmpm
    from zpc_tpu.sim import mpm_binned2 as jb2
except ImportError:
    pass

CPU = torch.device("cpu")
TOL = dict(x=1e-6, v=5e-4, F=1e-5)
CHANGE_TOL = 1e-4
N = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the force differential
# ---------------------------------------------------------------------------

def _rotations(rng, n):
    Q = np.linalg.qr(rng.standard_normal((n, 3, 3)))[0]
    return Q * np.sign(np.linalg.det(Q))[:, None, None]


def _deformations(n=64):
    """F near I, F = I exactly, F with two equal singular values in random
    frames, and the same along the axes (where both SVDs give exactly
    equal singular values); one tangent dF for all."""
    rng = np.random.default_rng(3)
    near = np.eye(3) + 0.1 * rng.standard_normal((n, 3, 3))
    eye = np.broadcast_to(np.eye(3), (n, 3, 3))
    U, V = _rotations(rng, n), _rotations(rng, n)
    equal = U @ np.diag([1.2, 0.9, 0.9]) @ V.transpose(0, 2, 1)
    axes = np.broadcast_to(np.diag([0.9, 1.2, 0.9]), (n, 3, 3))
    dF = 0.1 * rng.standard_normal((n, 3, 3))
    return ({"near_I": near.astype(np.float32),
             "I": eye.astype(np.float32),
             "two_equal": equal.astype(np.float32),
             "two_equal_axes": axes.astype(np.float32)},
            dF.astype(np.float32))


MODELS = ("NeoHookean", "FixedCorotated", "StvkWithHencky",
          "EquationOfState", "AnisotropicArap")


def _jmodel(name):
    if name == "EquationOfState":
        return jc.EquationOfState(jnp.float32(0.0), jnp.float32(2e4),
                                  jnp.float32(7.0))
    if name == "AnisotropicArap":
        return jc.AnisotropicArap(jnp.float32(3e3), jnp.float32(0.0),
                                  jnp.asarray([0.6, 0.8, 0.0], jnp.float32),
                                  jnp.float32(2e3))
    return getattr(jc, name).from_young_poisson(1e4, 0.3)


@pytest.fixture(scope="module")
def jax_tangents():
    """jax.jvp of every model's first_piola at every F kind, and (for the
    ill-conditioned case) at F moved by 1e-6 dF."""
    Fs, dF = _deformations()
    out = {}
    for name in MODELS:
        m = _jmodel(name)
        jvp = jax.jit(lambda F, t, m=m: jax.jvp(m.first_piola, (F,),
                                                 (t,))[1])
        for kind, F in Fs.items():
            out[name, kind] = np.asarray(jvp(jnp.asarray(F),
                                             jnp.asarray(dF)))
        out[name, "moved"] = np.asarray(jvp(
            jnp.asarray(Fs["two_equal"] + 1e-6 * dF), jnp.asarray(dF)))
    return Fs, dF, out


@pytest.mark.parametrize("kind", ["near_I", "I", "two_equal",
                                  "two_equal_axes"])
@pytest.mark.parametrize("name", MODELS)
def test_dP_dF_action_matches_jax(name, kind, jax_tangents):
    Fs, dF, ref = jax_tangents
    model = interop._same_fields(_jmodel(name), tc, CPU)
    got = model.dP_dF_action(torch.from_numpy(Fs[kind]),
                             torch.from_numpy(dF)).numpy()
    want = ref[name, kind]
    assert np.isfinite(want).all()
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    tol = 1e-5 * scale
    if name == "StvkWithHencky" and kind == "two_equal":
        # the reference fault: a tangent set by the rounding of s1 - s2,
        # held to twice the reference's own move under a 1e-6 change of F
        tol += 2.0 * np.abs(ref[name, "moved"] - want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("name", MODELS)
def test_linearize_is_dP_dF_action(name):
    """The step's linearisation (the SVD taken once) gives the jvp's
    numbers exactly, at every F kind."""
    Fs, dF = _deformations()
    model = interop._same_fields(_jmodel(name), tc, CPU)
    dF = torch.from_numpy(dF)
    for F in Fs.values():
        F = torch.from_numpy(F)
        lin = model.linearize(F)
        for t in (dF, 2.0 * dF.flip(0)):
            assert torch.equal(lin(t), model.dP_dF_action(F, t))


def test_dP_dF_action_at_identity_is_the_linear_response():
    """At F = I NeoHookean and FixedCorotated give the small-strain
    response dP = mu (dF + dF^T) + lam tr(dF) I.  (StvkWithHencky does
    not: with all singular values equal the closed-form SVD differential
    it shares with the reference keeps only the diagonal of U^T dF V, so
    its tangent there has no shear part; test_dP_dF_action_matches_jax
    holds it to the reference.)"""
    dF = torch.from_numpy(_deformations(8)[1])
    eye = torch.eye(3).expand(8, 3, 3).contiguous()
    mu, lam = tc.lame_parameters(1e4, 0.3)
    tr = dF.diagonal(dim1=-2, dim2=-1).sum(-1)[:, None, None] * torch.eye(3)
    sym = dF + dF.transpose(-1, -2)
    for cls, want in ((tc.NeoHookean, mu * sym + lam * tr),
                      (tc.FixedCorotated, mu * sym + lam * tr)):
        got = cls.from_young_poisson(1e4, 0.3, device=CPU).dP_dF_action(
            eye, dF)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())


# ---------------------------------------------------------------------------
# the implicit steps
# ---------------------------------------------------------------------------

def _jsetup():
    """tests/test_implicit.py's setup: 512 particles in [0.3, 0.7]^3,
    dx 0.05, FixedCorotated (E 1e4, nu 0.3), gravity."""
    rng = np.random.default_rng(42)
    x = jnp.asarray(rng.uniform(0.3, 0.7, (N, 3)), jnp.float32)
    st = jmpm.make_mpm_state(x, dx=0.05, block_capacity=512)
    sim = jmpm.MPMSim(model=jc.FixedCorotated.from_young_poisson(1e4, 0.3),
                      gravity=jnp.asarray([0.0, -9.8, 0.0]))
    return sim, st


def _stretched(st, diag):
    F0 = jnp.broadcast_to(jnp.diag(jnp.asarray(diag, jnp.float32)),
                          (N, 3, 3))
    return type(st)(st.particles.update(F=F0), st.grid, st.max_vel)


def _assert_close(k, got, want, init):
    """``got`` within TOL[k] of ``want``, and its change from ``init``
    within CHANGE_TOL of the largest change plus 4 fp32 ulps of the
    values.  Returns whether ``want`` moved by more than that tolerance,
    so that the comparison tells the step from one that did nothing."""
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[k], err_msg=k)
    change = want - init
    tol = CHANGE_TOL * np.abs(change).max() + \
        4 * np.finfo(np.float32).eps * np.abs(want).max()
    np.testing.assert_allclose(got - init, change, rtol=0, atol=tol,
                               err_msg=f"{k} - {k}0")
    return np.abs(change).max() > tol


def _assert_states(got, want, init):
    a, b = interop.state_to_numpy(want), interop.state_to_numpy(got)
    z = interop.state_to_numpy(init)
    moved = {k: _assert_close(k, b[k], a[k], z[k]) for k in ("x", "v", "F")}
    assert moved["v"], "the reference step left v as it was"


# (F diagonal, dt, keyword arguments): test_matches_explicit_small_dt,
# test_stable_at_large_dt, and Newton refinement with the Hessian clamp
# near inversion (test_hessian_clamp_near_inversion, three iterations)
STEP_CASES = {
    "small_dt": ([1.02, 0.98, 1.0], 1e-5, dict(cg_iters=100, cg_tol=1e-6)),
    "large_dt": ([1.1, 0.9, 1.0], 5e-3, dict(cg_iters=60)),
    "newton_clamp": ([0.05, 1.0, 1.0], 2e-3,
                     dict(cg_iters=60, newton_iters=3, hessian_clamp=0.2)),
}


def _counting(module, monkeypatch):
    """Record the iteration count of every ``cg`` solve that ``module``
    runs (JAX's as traced values of the same program)."""
    counts, solve = [], module.cg

    def cg(*args, **kw):
        res = solve(*args, **kw)
        counts.append(res.iters)
        return res
    monkeypatch.setattr(module, "cg", cg)
    return counts


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_implicit_step_matches_jax(case, monkeypatch):
    diag, dt, kw = STEP_CASES[case]
    sim, st = _jsetup()
    st = _stretched(st, diag)
    jcounts = _counting(jimp, monkeypatch)
    ref, jiters = jax.jit(lambda s: (jimp.implicit_step(
        sim, s, jnp.float32(dt), **kw), list(jcounts)))(st)
    titers = _counting(timp, monkeypatch)
    out = timp.implicit_step(interop.sim_from_jax(sim, CPU),
                             interop.state_from_jax(st, CPU), dt, **kw)
    assert [int(i) for i in jiters] == titers and min(titers) > 0
    _assert_states(out, ref, st)
    v = out.particles["v"]
    assert bool(torch.isfinite(v).all()) and bool(torch.isfinite(
        out.max_vel))
    assert v.abs().max().item() < 10.0


def test_implicit_step_rejects_2d(monkeypatch):
    """The 2-D step, which the port once refused, against JAX's from a
    strained F = diag(1.05, 0.97) at dt 1e-3: the same CG counts and the
    same tolerances as the 3-D cases.  (From rest JAX's 2-D force
    differential is NaN, the port's is not: tests/test_torch_mpm2d.py.)"""
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.uniform(0.3, 0.7, (N, 2)), jnp.float32)
    st = jmpm.make_mpm_state(x, dx=0.05, block_capacity=256)
    st = type(st)(st.particles.update(F=jnp.broadcast_to(
        jnp.diag(jnp.asarray([1.05, 0.97])), (N, 2, 2))), st.grid,
        st.max_vel)
    sim = jmpm.MPMSim(model=jc.FixedCorotated.from_young_poisson(1e4, 0.3),
                      gravity=jnp.asarray([0.0, -9.8]))
    jcounts = _counting(jimp, monkeypatch)
    ref, jiters = jax.jit(lambda s: (jimp.implicit_step(
        sim, s, jnp.float32(1e-3), cg_iters=60), list(jcounts)))(st)
    titers = _counting(timp, monkeypatch)
    out = timp.implicit_step(interop.sim_from_jax(sim, CPU),
                             interop.state_from_jax(st, CPU), 1e-3,
                             cg_iters=60)
    assert out.grid.dim == 2
    assert [int(i) for i in jiters] == titers and min(titers) > 0
    _assert_states(out, ref, st)


CG_ITERS, CG_TOL = 60, 1e-3


@pytest.fixture(scope="module")
def jax_binned():
    """The JAX binned implicit step (dt an argument, so one compiled
    program serves the single step and the 5-step chain): one step at
    dt 5e-4 from the 1.03/0.97 stretch, and 5 steps at dt 5e-3 from the
    1.1/0.9 stretch, with the CG iteration counts."""
    sim, st = _jsetup()
    cfg = jb2.BinnedConfig2(bins_capacity=64)
    bin_ = jax.jit(lambda s: jb2.bin_state(sim, s, cfg))
    step = jax.jit(lambda b, dt: ji2.implicit_step_binned2(
        sim, b, dt, cfg, cg_iters=CG_ITERS, cg_tol=CG_TOL, rebin=False,
        with_stats=True))
    one = _stretched(st, [1.03, 0.97, 1.0])
    out1, it1 = step(bin_(one), jnp.float32(5e-4))
    five = _stretched(st, [1.1, 0.9, 1.0])
    b = bin_(five)
    iters = []
    for _ in range(5):
        b, it = step(b, jnp.float32(5e-3))
        assert not bool(b.needs_rebin) and not bool(b.overflow)
        iters.append(int(it))
    return dict(sim=sim, cfg=cfg, one=one, out1=out1, it1=int(it1),
                five=five, out5=jb2.unbin_state(b, five), iters5=iters)


def test_implicit_step_binned2_matches_jax(jax_binned, monkeypatch):
    j = jax_binned
    sim = interop.sim_from_jax(j["sim"], CPU)
    cfg = interop.config_from_jax(j["cfg"])
    bst = tb2.bin_state(sim, interop.state_from_jax(j["one"], CPU), cfg)
    z = bst.cols.numpy()
    out, iters = ti2.implicit_step_binned2(
        sim, bst, 5e-4, cfg, cg_iters=CG_ITERS, cg_tol=CG_TOL, rebin=False,
        with_stats=True)
    assert iters == j["it1"] and iters > 0
    a, b = np.asarray(j["out1"].cols), out.cols.numpy()
    moved = {k: _assert_close(k, b[:, sl], a[:, sl], z[:, sl])
             for k, sl in (("x", slice(0, 3)), ("v", slice(3, 6)),
                           ("F", slice(6, 15)))}
    assert moved["v"]
    np.testing.assert_array_equal(out.pid.numpy(), np.asarray(
        j["out1"].pid))
    assert not bool(out.overflow) and not bool(out.needs_rebin)
    # the MPMState form, and the scatter step it is the binned form of:
    # the same system, so the same CG count
    st = interop.state_from_jax(j["one"], CPU)
    mp, overflow = ti2.implicit_step_binned2(sim, st, 5e-4, cfg,
                                             cg_iters=CG_ITERS, cg_tol=CG_TOL)
    assert not bool(overflow)
    counts = _counting(timp, monkeypatch)
    ref = timp.implicit_step(sim, st, 5e-4, cg_iters=CG_ITERS, cg_tol=CG_TOL)
    assert counts == [iters]
    _assert_states(mp, ref, st)


def test_implicit_rollout_binned2_matches_jax(jax_binned):
    j = jax_binned
    sim = interop.sim_from_jax(j["sim"], CPU)
    cfg = interop.config_from_jax(j["cfg"])
    st = interop.state_from_jax(j["five"], CPU)
    out, overflow = ti2.implicit_rollout_binned2(
        sim, st, 5e-3, cfg, 5, cg_iters=CG_ITERS, cg_tol=CG_TOL)
    assert not bool(overflow)
    _assert_states(out, j["out5"], st)
    v = out.particles["v"]
    assert bool(torch.isfinite(v).all()) and v.abs().max().item() < 10.0
    # the same chain step by step: the CG counts match JAX's
    bst = tb2.bin_state(sim, st, cfg)
    iters = []
    for _ in range(5):
        bst, it = ti2.implicit_step_binned2(
            sim, bst, 5e-3, cfg, cg_iters=CG_ITERS, cg_tol=CG_TOL,
            rebin=False, with_stats=True)
        iters.append(it)
    assert iters == j["iters5"]


def test_implicit_scenes():
    sim, st, dt = scenes.implicit_block(4096, CPU)
    assert dt == 5e-4 and st.grid.block_capacity == 4096
    assert abs(float(st.grid.dx) - 1.0 / 128) < 1e-9
    assert scenes.implicit_config(1_000_000) == tb2.BinnedConfig2(
        bins_capacity=9216, block_capacity=8192)
    assert scenes.implicit_config(262_144) == tb2.BinnedConfig2(
        bins_capacity=2560, block_capacity=2048)
    assert scenes.implicit_block(600_000, CPU)[1].grid.block_capacity == 8192


@pytest.mark.cuda
def test_implicit_on_cuda_matches_cpu():
    """The scatter step and a 20-step binned chain of the small block on
    the card against the CPU: the same CG counts (within one), x, v and F
    within the tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel has no CPU mode")
    dev = torch.device("cuda")
    cfg = tb2.BinnedConfig2(bins_capacity=64, block_capacity=256)

    def run(where):
        sim, st, _ = scenes.mpm_block(4096, 1.0 / 32, where,
                                      block_capacity=256)
        one = timp.implicit_step(sim, st, 5e-4)
        bst = tb2.bin_state(sim, st, cfg)
        iters = []
        for _ in range(20):
            if bool(bst.needs_rebin):
                bst = tb2.rebin_adaptive(sim, bst, cfg)
            bst, it = ti2.implicit_step_binned2(sim, bst, 5e-4, cfg,
                                                rebin=False, with_stats=True)
            iters.append(it)
        return one, tb2.unbin_state(bst, st), iters
    g1, g, gi = run(dev)
    c1, c, ci = run(CPU)
    assert all(abs(a - b) <= 1 for a, b in zip(gi, ci))
    for a, b in ((g1, c1), (g, c)):
        for k in ("x", "v", "F"):
            err = (a.particles[k].cpu() - b.particles[k]).abs().max().item()
            assert err <= TOL[k], (k, err)
