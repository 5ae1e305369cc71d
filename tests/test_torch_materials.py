"""The port's material family against zpc_tpu on the same inputs: the 3x3
SVD and eigensolver, every constitutive and plasticity model, the
materials scenes through the binned path, interop and the diagnostics
(plasticity inside the MPM steps: tests/test_torch_plastic_mpm.py).

Inputs are made with seeded numpy and handed to both packages (JAX on the
CPU, the port on CPU tensors).  Tolerances: decompositions, models and
their energy gradients 1e-5 (relative to the largest entry); rollouts
those of tests/test_mpm_binned2.py (x 1e-5, v 2e-4, 5e-4 with a collider,
F and Jp 1e-5, absolute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zpc_tpu.math import svd as jsvd
from zpc_tpu.models import constitutive as jc
from zpc_tpu.models import plasticity as jp
from zpc_tpu.sim import mpm as jmpm
from zpc_tpu.sim import mpm_binned2 as jb2
from zpc_tpu.utils import diagnostics as jdiag

from zpc_tpu_torch import interop, scenes
from zpc_tpu_torch.math import svd as tsvd
from zpc_tpu_torch.sim import mpm as tmpm
from zpc_tpu_torch.sim import mpm_binned2 as tb2
from zpc_tpu_torch.utils import diagnostics as tdiag

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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-5, what=""):
    """|got - want| <= rtol * max |want| (entries near zero in a batch of
    large ones compare at the batch's scale)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def _rot(rng, n):
    """n random rotations (det +1)."""
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q


def _svd_cases(rng):
    n = 64
    R1, R2 = _rot(rng, n), _rot(rng, n)
    near = np.einsum("nij,j,nkj->nik", R1,
                     np.asarray([1.0, 1.0 + 1e-4, 1.0 - 1e-4]), R2)
    refl = (np.eye(3) + 0.2 * rng.standard_normal((n, 3, 3)))
    refl[:, :, 2] *= -1                              # det < 0
    return {
        "random": np.eye(3) + 0.3 * rng.standard_normal((n, 3, 3)),
        "near-degenerate": near,
        "identity": np.broadcast_to(np.eye(3), (n, 3, 3)),
        "reflective": refl,
    }


@pytest.mark.parametrize("case", ["random", "near-degenerate", "identity",
                                  "reflective"])
def test_svd3x3_matches_jax(case):
    F = _svd_cases(np.random.default_rng(0))[case].astype(np.float32)
    U, s, V = (np.asarray(a) for a in jsvd.svd3x3(jnp.asarray(F)))
    tU, ts, tV = (a.numpy() for a in tsvd.svd3x3(_t(F)))
    # the rotation convention: det U = det V = +1, s sorted by magnitude,
    # the smallest signed (negative exactly where det F < 0)
    np.testing.assert_allclose(np.linalg.det(tU), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(tV), 1.0, atol=1e-5)
    assert (ts[:, 0] >= ts[:, 1] - 1e-6).all()
    assert (ts[:, 1] >= np.abs(ts[:, 2]) - 1e-6).all()
    np.testing.assert_array_equal(ts[:, 2] < 0, np.linalg.det(F) < 0)
    np.testing.assert_allclose(ts, s, rtol=0, atol=1e-5)
    rec = np.einsum("nij,nj,nkj->nik", tU, ts, tV)
    np.testing.assert_allclose(rec, F, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        np.einsum("nij,nj,nkj->nik", U, s, V), rec, rtol=0, atol=1e-5)
    # U and V columns only where the singular values are separated
    gaps = np.abs(np.diff(np.abs(s), axis=1))
    for j in range(3):
        apart = np.ones(len(F), bool)
        if j > 0:
            apart &= gaps[:, j - 1] > 1e-3
        if j < 2:
            apart &= gaps[:, j] > 1e-3
        np.testing.assert_allclose(tU[apart, :, j], U[apart, :, j], atol=1e-5)
        np.testing.assert_allclose(tV[apart, :, j], V[apart, :, j], atol=1e-5)
    R, S = (a.numpy() for a in tsvd.polar_decomposition(_t(F)))
    jR, jS = (np.asarray(a) for a in jsvd.polar_decomposition(
        jnp.asarray(F)))
    np.testing.assert_allclose(np.einsum("nij,njk->nik", R, S), F,
                               atol=1e-5)
    if case != "identity":
        np.testing.assert_allclose(R, jR, atol=1e-5)
        np.testing.assert_allclose(S, jS, atol=1e-5)


@pytest.mark.parametrize("case", ["random", "near-degenerate", "identity"])
def test_eigh3x3_matches_jax(case):
    F = _svd_cases(np.random.default_rng(1))[case]
    A = np.einsum("nji,njk->nik", F, F).astype(np.float32)      # SPD
    w, V = (np.asarray(a) for a in jsvd.eigh3x3(jnp.asarray(A)))
    tw, tV = (a.numpy() for a in tsvd.eigh3x3(_t(A)))
    np.testing.assert_allclose(tw, w, rtol=0, atol=1e-5)
    assert (tw[:, :-1] >= tw[:, 1:]).all()
    np.testing.assert_allclose(np.einsum("nij,njk->nik", A, tV),
                               tV * tw[:, None, :], atol=1e-5)
    np.testing.assert_allclose(np.einsum("nji,njk->nik", tV, tV),
                               np.broadcast_to(np.eye(3), A.shape),
                               atol=1e-5)


def _jmodels():
    mu, lam = jc.lame_parameters(1e4, 0.3)
    return {
        "NeoHookean": jc.NeoHookean.from_young_poisson(1e4, 0.3),
        "FixedCorotated": jc.FixedCorotated.from_young_poisson(1e4, 0.3),
        "StvkWithHencky": jc.StvkWithHencky(jnp.float32(mu),
                                            jnp.float32(lam)),
        "EquationOfState": jc.EquationOfState(jnp.float32(0.0),
                                              jnp.float32(1e4),
                                              jnp.float32(7.0)),
        "AnisotropicArap": jc.AnisotropicArap(
            jnp.float32(1e3), jnp.float32(1e3),
            fiber=jnp.asarray([0.6, 0.8, 0.0]), mu_fiber=jnp.float32(5e2)),
    }


@pytest.mark.parametrize("name", ["NeoHookean", "FixedCorotated",
                                  "StvkWithHencky", "EquationOfState",
                                  "AnisotropicArap"])
def test_constitutive_matches_jax(name):
    rng = np.random.default_rng(2)
    F = (np.eye(3) + 0.25 * rng.standard_normal((256, 3, 3))
         ).astype(np.float32)
    F = F[np.linalg.det(F) > 0.2]
    jm = _jmodels()[name]
    tm = interop.sim_from_jax(jmpm.MPMSim(model=jm, gravity=jnp.zeros(3)),
                              CPU).model
    assert type(tm).__name__ == name
    for fn in ("psi", "first_piola", "kirchhoff"):
        _close(getattr(tm, fn)(_t(F)), getattr(jm, fn)(jnp.asarray(F)),
               what=f"{name}.{fn}")
    # per-particle (hardened) Lame parameters broadcast the same way
    if name != "EquationOfState":
        scale = (1.0 + rng.random(len(F))).astype(np.float32)
        jh = dataclasses.replace(jm, mu=jm.mu * jnp.asarray(scale),
                                 lam=jm.lam * jnp.asarray(scale))
        th = dataclasses.replace(tm, mu=tm.mu * _t(scale),
                                 lam=tm.lam * _t(scale))
        _close(th.first_piola(_t(F)), jh.first_piola(jnp.asarray(F)),
               what=f"{name} per particle")
    if name == "EquationOfState":
        J = rng.uniform(0.5, 1.5, 64).astype(np.float32)
        _close(tm.kirchhoff_from_J(_t(J)), jm.kirchhoff_from_J(
            jnp.asarray(J)), what="kirchhoff_from_J")


@pytest.mark.parametrize("name", ["NeoHookean", "FixedCorotated",
                                  "StvkWithHencky", "EquationOfState",
                                  "AnisotropicArap"])
def test_energy_gradient_matches_jax(name):
    """Reverse mode through every model's energy (the SVD's transposed
    closed-form rule for three of them): the gradient of psi is JAX's and
    is the model's own first_piola."""
    rng = np.random.default_rng(5)
    F = (np.eye(3) + 0.2 * rng.standard_normal((64, 3, 3))
         ).astype(np.float32)
    F = F[np.linalg.det(F) > 0.2]
    jm = _jmodels()[name]
    tm = interop.sim_from_jax(jmpm.MPMSim(model=jm, gravity=jnp.zeros(3)),
                              CPU).model
    got = torch.func.grad(lambda f: tm.psi(f).sum())(_t(F))
    want = jax.jit(jax.grad(lambda f: jm.psi(f).sum()))(jnp.asarray(F))
    _close(got, want, what=f"{name} dpsi/dF")
    _close(got, tm.first_piola(_t(F)).numpy(), what=f"{name} dpsi/dF = P")


@pytest.mark.parametrize("name", ["FixedCorotated", "StvkWithHencky"])
def test_associative_von_mises_through_svd(name):
    """AssociativeVonMises takes the derivative of the gradient of the
    elastic energy; with an energy that goes through the SVD that is a
    forward rule over the SVD's reverse rule.  One Newton round on a few
    F: JAX runs it op by op (its compiled form takes minutes to build)."""
    rng = np.random.default_rng(4)
    amp = np.where(np.arange(8) % 2 == 0, 0.3, 0.003)
    F = (np.eye(3) + amp[:, None, None] * rng.standard_normal((8, 3, 3))
         ).astype(np.float32)
    pl = jp.AssociativeVonMises(initial_stress=jnp.float32(4e3), iters=1)
    jm = getattr(jc, name).from_young_poisson(3e5, 0.3)
    tsim = interop.sim_from_jax(jmpm.MPMSim(model=jm, gravity=jnp.zeros(3),
                                            plasticity=pl), CPU)
    with jax.disable_jit():
        jout = pl.project(jnp.asarray(F), jm)[0]
    tout = tsim.plasticity.project(_t(F), tsim.model)[0]
    _close(tout, jout, what=f"AssociativeVonMises over {name}")
    assert np.abs(tout.numpy() - F).max() > 1e-3


def test_inverted_elements_keep_the_signed_stretch():
    """For det F < 0 the SVD models use the signed smallest stretch, as the
    JAX package does (torch.linalg.svd would reflect U or V instead)."""
    rng = np.random.default_rng(3)
    F = (np.eye(3) + 0.2 * rng.standard_normal((128, 3, 3)))
    F[:, :, 2] *= -1
    F = F.astype(np.float32)
    assert (np.linalg.det(F) < 0).all()
    for name in ("FixedCorotated", "StvkWithHencky"):
        jm = _jmodels()[name]
        tm = interop.sim_from_jax(jmpm.MPMSim(model=jm, gravity=jnp.zeros(3)),
                                  CPU).model
        for fn in ("psi", "first_piola"):
            _close(getattr(tm, fn)(_t(F)), getattr(jm, fn)(jnp.asarray(F)),
                   what=f"{name}.{fn} inverted")


def _plastic_cases():
    mu, lam = (jnp.float32(v) for v in jc.lame_parameters(3.5e5, 0.3))
    return {
        "SnowPlasticity": (jp.SnowPlasticity(), "Jp"),
        "VonMisesCapped": (jp.VonMisesCapped(
            yield_stress=jnp.float32(2e3), mu=jnp.float32(1e5),
            lam=jnp.float32(2e5), k1_compress=jnp.float32(1e4),
            k1_stretch=jnp.float32(1e4)), None),
        "VonMisesCapped+rate": (jp.VonMisesCapped(
            yield_stress=jnp.float32(2e3), rate_c=jnp.float32(10.0),
            rate_p=jnp.float32(1.5)), "rate"),
        "DruckerPrager": (jp.DruckerPrager(mu, lam, jnp.float32(35.0),
                                           jnp.float32(10.0)), "logJp"),
        "NACC": (jp.NACC(mu, lam), "logJp"),
        "NACC no hardening": (jp.NACC(mu, lam, hardening_on=False), "logJp"),
        "NonAssociativeVonMises": (jp.NonAssociativeVonMises(
            tau_y=jnp.float32(2e3), alpha=jnp.float32(0.1),
            hardening_coeff=jnp.float32(1e3)), None),
        "AssociativeVonMises": (jp.AssociativeVonMises(
            initial_stress=jnp.float32(4e3)), "model"),
    }


@pytest.mark.parametrize("name", list(_plastic_cases()))
def test_plasticity_matches_jax(name):
    rng = np.random.default_rng(4)
    n = 96
    amp = np.where(np.arange(n) % 2 == 0, 0.3, 0.003)
    F = (np.eye(3) + amp[:, None, None] * rng.standard_normal((n, 3, 3))
         ).astype(np.float32)
    F = F[np.linalg.det(F) > 0.3]
    pl, arg = _plastic_cases()[name]
    tpl = interop.sim_from_jax(jmpm.MPMSim(
        model=_jmodels()["FixedCorotated"], gravity=jnp.zeros(3),
        plasticity=pl), CPU).plasticity
    assert type(tpl).__name__ == type(pl).__name__
    if arg == "Jp":
        s = rng.uniform(0.5, 2.0, len(F)).astype(np.float32)
        jout = pl.project(jnp.asarray(F), jnp.asarray(s))
        tout = tpl.project(_t(F), _t(s))
    elif arg == "logJp":
        s = rng.uniform(-0.3, 0.1, len(F)).astype(np.float32)
        jout = pl.project(jnp.asarray(F), jnp.asarray(s))
        tout = tpl.project(_t(F), _t(s))
    elif arg == "rate":
        r = rng.uniform(0.0, 100.0, len(F)).astype(np.float32)
        jout = pl.project(jnp.asarray(F), None, strain_rate=jnp.asarray(r))
        tout = tpl.project(_t(F), None, strain_rate=_t(r))
    elif arg == "model":
        jm = jc.NeoHookean.from_young_poisson(3e5, 0.3)
        tm = interop.sim_from_jax(jmpm.MPMSim(model=jm, gravity=jnp.zeros(3)),
                                  CPU).model
        jout = jax.jit(lambda f: pl.project(f, jm))(jnp.asarray(F))
        tout = tpl.project(_t(F), tm)
    else:
        jout = pl.project(jnp.asarray(F))
        tout = tpl.project(_t(F))
    _close(tout[0], jout[0], what=f"{name} F")
    # the projection did something on part of the batch
    assert np.abs(tout[0].numpy() - F).max() > 1e-3
    if arg in ("Jp", "logJp"):
        _close(tout[1], jout[1], what=f"{name} state")
    else:
        assert tout[1] is None and jout[1] is None


def _jsim(plasticity=None, flip=0.0, colliders=(), model=None):
    return jmpm.MPMSim(model=model or jc.FixedCorotated.from_young_poisson(
        1e4, 0.3), gravity=jnp.asarray([0.0, -9.8, 0.0]),
        colliders=colliders, plasticity=plasticity, flip=flip)


def _assert_states(got, want, atol_v=TOL["v"], atol_jp=TOL["Jp"]):
    a = interop.state_to_numpy(want)
    b = interop.state_to_numpy(got)
    assert a.keys() == b.keys()
    for k, tol in (("x", TOL["x"]), ("v", atol_v), ("F", TOL["F"]),
                   ("Jp", atol_jp)):
        if k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("material", scenes.MATERIALS)
def test_materials_scene_and_rollout(material):
    """scenes.materials is examples/materials.py:build input for input; 10
    binned steps of the port against 10 JAX explicit steps (the material
    gates of tests/test_materials.py hold too).

    Sand's logJp is held to 1e-5 plus twice the reference's own spread:
    near F = I every expanding particle projects to the cone's tip, so
    logJp sums fp32 rounding of log(s) from step to step, and the JAX
    package's binned path already differs from its explicit step by ~2e-4
    there (logJp itself stays below ~2e-4)."""
    from examples.materials import build

    jsim, jst, jdt = build(material, n=512, dx=1.0 / 32)
    sim, st, dt = scenes.materials(material, n=512, dx=1.0 / 32, device=CPU)
    assert dt == jdt
    a, b = interop.state_to_numpy(jst), interop.state_to_numpy(st)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    conv = interop.sim_from_jax(jsim, CPU)
    assert type(sim.model) is type(conv.model)
    assert type(sim.plasticity) is type(conv.plasticity)
    for obj, ref in ((sim.model, conv.model),
                     (sim.plasticity, conv.plasticity)):
        for f in dataclasses.fields(ref) if ref is not None else ():
            assert torch.equal(torch.as_tensor(getattr(obj, f.name)),
                               torch.as_tensor(getattr(ref, f.name))), f.name
    assert sim.colliders[0].friction == conv.colliders[0].friction

    ref = jst
    jstep = jax.jit(lambda s: jmpm.explicit_step(jsim, s, jnp.float32(jdt)))
    for _ in range(10):
        ref = jstep(ref)
    jcfg = jb2.BinnedConfig2(bins_capacity=64)
    spread = 0.0
    if material == "sand":
        jout, _ = jax.jit(lambda s: jb2.rollout_binned2(
            jsim, s, jnp.float32(jdt), jcfg, 10))(jst)
        spread = float(np.abs(np.asarray(jout.particles["Jp"]) -
                              np.asarray(ref.particles["Jp"])).max())
    out, overflow = tb2.rollout_binned2(sim, st, dt,
                                        interop.config_from_jax(jcfg), 10)
    assert not bool(overflow)
    _assert_states(out, ref, atol_v=5e-4, atol_jp=TOL["Jp"] + 2 * spread)
    x, v = out.particles["x"].numpy(), out.particles["v"].numpy()
    assert np.isfinite(x).all() and np.isfinite(v).all()
    assert np.abs(v).max() < 50.0
    assert x[:, 1].min() > 0.1 - 3.0 / 32


def test_interop_accepts_every_model():
    """sim_from_jax maps all five elastic and all six plasticity models of
    zpc_tpu/models field for field; anything else raises."""
    for name, jm in _jmodels().items():
        tm = interop.sim_from_jax(_jsim(model=jm), CPU).model
        assert type(tm).__name__ == name
        for f in dataclasses.fields(jm):
            np.testing.assert_array_equal(
                np.asarray(getattr(tm, f.name)), np.asarray(getattr(jm,
                                                                    f.name)))
    assert set(_jmodels()) == set(jc.__all__) - {"lame_parameters",
                                                 "bcast_scalar",
                                                 "ElasticModel"}
    seen = set()
    for pl, _ in _plastic_cases().values():
        tpl = interop.sim_from_jax(_jsim(plasticity=pl), CPU).plasticity
        seen.add(type(tpl).__name__)
        for f in dataclasses.fields(pl):
            np.testing.assert_array_equal(np.asarray(getattr(tpl, f.name)),
                                          np.asarray(getattr(pl, f.name)))
    assert seen == set(jp.__all__)

    @dataclasses.dataclass(frozen=True)
    class Unknown:
        mu: float = 1.0
    with pytest.raises(NotImplementedError):
        interop.sim_from_jax(_jsim(plasticity=Unknown()), CPU)
    # cubic B-splines are ported: the order converts, and one step of the
    # order-3 transfer matches JAX's
    jsim3 = dataclasses.replace(_jsim(), order=3)
    tsim3 = interop.sim_from_jax(jsim3, CPU)
    assert tsim3.order == 3
    x = jnp.asarray(np.random.default_rng(5).uniform(0.3, 0.7, (256, 3)),
                    jnp.float32)
    jst = jmpm.make_mpm_state(x, dx=0.05, block_capacity=256)
    ref = jax.jit(lambda s: jmpm.explicit_step(jsim3, s,
                                               jnp.float32(1e-4)))(jst)
    out = tmpm.explicit_step(tsim3, interop.state_from_jax(jst, CPU), 1e-4)
    _assert_states(out, ref)


def test_binstate_from_jax_layouts(rng):
    """18-, 26- and 27-column bin states cross field for field."""
    from zpc_tpu.sim.fluid import make_fluid_state
    from zpc_tpu.sim.fluid_binned2 import bin_fluid_state

    x = jnp.asarray(rng.uniform(0.3, 0.7, (300, 3)), jnp.float32)
    cfg = jb2.BinnedConfig2(bins_capacity=16)
    fsim = _jsim(model=_jmodels()["EquationOfState"])
    states = {
        18: jax.jit(lambda s: bin_fluid_state(fsim, s, cfg))(
            make_fluid_state(x, dx=0.05, block_capacity=64)),
        26: jax.jit(lambda s: jb2.bin_state(_jsim(), s, cfg))(
            jmpm.make_mpm_state(x, dx=0.05, block_capacity=64)),
        27: jax.jit(lambda s: jb2.bin_state(_jsim(), s, cfg))(
            jmpm.make_mpm_state(x, dx=0.05, block_capacity=64, with_Jp=True,
                                Jp0=1.0)),
    }
    for w, jbst in states.items():
        tbst = interop.binstate_from_jax(jbst, CPU)
        assert tbst.cols.shape[1] == w and tbst.has_jp == (w == 27)
        a, b = interop.state_to_numpy(jbst), interop.state_to_numpy(tbst)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    bad = dataclasses.replace(states[26], cols=states[26].cols[:, :20])
    with pytest.raises(NotImplementedError):
        interop.binstate_from_jax(bad, CPU)


# ---------------------------------------------------------------------------
# diagnostics (tests/test_diagnostics.py on both packages)
# ---------------------------------------------------------------------------

def _dstates(rng, n=128):
    x = jnp.asarray(rng.uniform(0.3, 0.7, (n, 3)), jnp.float32)
    jst = jmpm.make_mpm_state(x, dx=0.05, block_capacity=256)
    return jst, interop.state_from_jax(jst, CPU)


def _poke(jst, tst, name, idx, value):
    ja = np.asarray(jst.particles[name]).copy()
    ja[idx] = value
    jst = jmpm.MPMState(jst.particles.update(**{name: jnp.asarray(ja)}),
                        jst.grid, jst.max_vel)
    tst = tmpm.MPMState(tst.particles.update(**{name: _t(ja)}), tst.grid,
                        tst.max_vel)
    return jst, tst


@pytest.mark.parametrize("case", ["healthy", "nan", "explosion", "escaped"])
def test_validate_state_matches_jax(case, rng):
    jst, tst = _dstates(rng)
    kw = {}
    if case == "nan":
        jst, tst = _poke(jst, tst, "v", (3, 1), np.nan)
    elif case == "explosion":
        jst, tst = _poke(jst, tst, "v", 0, [1e6, 0, 0])
    elif case == "escaped":
        jst, tst = _poke(jst, tst, "x", 0, [99.0, 0, 0])
        kw = dict(bounds=([0, 0, 0], [1, 1, 1]))
    jrep = jdiag.validate_state(jst, **kw)
    trep = tdiag.validate_state(tst, **kw)
    for a, b in zip(jrep, trep):
        np.testing.assert_allclose(float(b), float(a), rtol=1e-6)
    assert bool(trep.healthy) == (case in ("healthy", "escaped"))
    assert int(trep.nan_count) == (case == "nan")
    assert int(trep.escaped) == (case == "escaped")


def test_watchdog_rollback_and_give_up(rng):
    _, st = _dstates(rng)
    sim = interop.sim_from_jax(_jsim(), CPU)
    calls = {"n": 0}

    def flaky(s, d):
        calls["n"] += 1
        out = tmpm.explicit_step(sim, s, d)
        if calls["n"] == 2:                  # a blow-up on the 2nd call
            v = out.particles["v"].clone()
            v[0, 0] = float("nan")
            out = tmpm.MPMState(out.particles.update(v=v), out.grid,
                                out.max_vel)
        return out

    wd = tdiag.Watchdog(step=flaky, dt=1e-4)
    out = wd.run(st, steps=4)
    assert wd.rollbacks == 1
    assert wd.dt == pytest.approx(5e-5)
    assert torch.isfinite(out.particles["v"]).all()

    def always_bad(s, d):
        v = s.particles["v"].clone()
        v[0, 0] = float("nan")
        return tmpm.MPMState(s.particles.update(v=v), s.grid, s.max_vel)

    wd = tdiag.Watchdog(step=always_bad, dt=1e-4, max_retries=3)
    with pytest.raises(RuntimeError, match="diverged"):
        wd.run(st, steps=2)


def test_momentum_report_matches_jax(rng):
    x = jnp.asarray(rng.uniform(0.3, 0.7, (256, 3)), jnp.float32)
    v0 = jnp.asarray(rng.normal(0.0, 1.0, (256, 3)), jnp.float32)
    jst = jmpm.make_mpm_state(x, dx=0.05, block_capacity=256, velocity=v0,
                              capacity=300)
    jst = jax.jit(lambda s: jmpm.explicit_step(_jsim(), s,
                                               jnp.float32(1e-4)))(jst)
    tst = interop.state_from_jax(jst, CPU)
    for a, b in zip(jdiag.momentum_report(jst), tdiag.momentum_report(tst)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)
