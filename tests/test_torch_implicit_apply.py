"""The implicit step's fused operator for a FixedCorotated solid
(zpc_tpu_torch.ops.implicit_apply) and its routing in
zpc_tpu_torch.sim.implicit_binned2.

No JAX: the closed-form stress differential is held to the port's own
``FixedCorotated.linearize`` (forward-mode autodiff through the SVD's
differential, itself held to JAX's in tests/test_torch_implicit.py), the
plain fused operator to the composition it replaces (G2P, ``linearize``,
P2G), and the kernel (marked ``cuda``) to the plain version.  Tolerances:

* closed form against the jvp: 1e-5 of the largest entry of dP.  The two
  take the same products in another order, and the jvp forms the
  rotation's differential as ``0.5 (x + y) - 0.5 (x - y)`` of the SVD's
  pair solutions, where x + y carries the clamped 1 / (s_j - s_i): near
  repeated singular values its rounding reaches a few 1e-7 of dP;
* the plain fused operator against the composition: 1e-5 of the largest
  entry of the stiffness part ``A u - gm u`` (the same sums and products,
  and dP as above);
* symmetry, ``<v, A u>`` against ``<u, A v>``: 1e-6 of the sum of the
  magnitudes of the products (a few 1e-9 read), float32 rounding of a
  symmetric operator;
* the kernel against the plain version in float64: 1e-5 of the largest
  entry of the stiffness part, where the plain version in float32 reads
  a few 1e-7 (the sums' order, atomics in no set order, fused
  multiply-adds).
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch.models.constitutive import FixedCorotated, NeoHookean
from zpc_tpu_torch.math.svd import svd3x3
from zpc_tpu_torch.ops import implicit_apply as IA
from zpc_tpu_torch.sim import implicit_binned2 as ib2
from zpc_tpu_torch.sim import mpm_binned2 as b2
from zpc_tpu_torch.sim.mpm import MPMSim, make_mpm_state
from zpc_tpu_torch.math.vecmat import mm33

CPU = torch.device("cpu")
N, DX, DT = 512, 0.05, 5e-3
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rotations(rng, n):
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    return q * np.sign(np.linalg.det(q))[:, None, None]


def _deformations(n=64):
    """F near I, F = I, two equal singular values in random frames and
    along the axes, an inverted F (a negative smallest singular value) and
    F drawn at random (about half of them inverted); one tangent dF."""
    rng = np.random.default_rng(3)
    U, V = _rotations(rng, n), _rotations(rng, n)
    Vt = V.transpose(0, 2, 1)
    Fs = {"near_I": np.eye(3) + 0.1 * rng.standard_normal((n, 3, 3)),
          "I": np.broadcast_to(np.eye(3), (n, 3, 3)),
          "two_equal": U @ np.diag([1.2, 0.9, 0.9]) @ Vt,
          "two_equal_axes": np.broadcast_to(np.diag([0.9, 1.2, 0.9]),
                                            (n, 3, 3)),
          "inverted": U @ np.diag([1.1, 0.9, -0.8]) @ Vt,
          "random": rng.standard_normal((n, 3, 3))}
    dF = 0.1 * rng.standard_normal((n, 3, 3))
    return ({k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
             for k, v in Fs.items()}, torch.tensor(dF, dtype=torch.float32))


def _lame(kind, n, dev=CPU):
    """FixedCorotated with scalar Lame fields (E 1e4, nu 0.3), or with one
    per F drawn around them."""
    m = FixedCorotated.from_young_poisson(1e4, 0.3, device=dev)
    if kind == "scalar":
        return m
    scale = torch.linspace(0.5, 2.0, n, device=dev)
    return FixedCorotated(m.mu * scale, m.lam * scale.flip(0))


@pytest.mark.parametrize("lame", ["scalar", "per_lane"])
@pytest.mark.parametrize("kind", ["near_I", "I", "two_equal",
                                  "two_equal_axes", "inverted", "random"])
def test_closed_form_dP_matches_linearize(kind, lame):
    Fs, dF = _deformations()
    F = Fs[kind]
    model = _lame(lame, F.shape[0])
    want = model.linearize(F)(dF)
    got = IA.corotated_dP(F, svd3x3(F), dF, model.mu, model.lam)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    scale = want.abs().max()
    assert scale > 0
    assert (got - want).abs().max() <= TOL * scale, \
        ((got - want).abs().max() / scale).item()


def _scene(dev=CPU, lame="scalar"):
    """512 particles in [0.3, 0.7]^3 at dx 0.05 (tests/test_implicit.py's
    block) with F drawn near I, binned into 64 bins; the bin state, the
    step's context, lanes, lane-order model and grid mass, a node field u
    on the massive nodes and a barrier Hessian."""
    rng = np.random.default_rng(7)
    st = make_mpm_state(rng.uniform(0.3, 0.7, (N, 3)), dx=DX, device=dev,
                        block_capacity=512)
    F = np.eye(3) + 0.05 * rng.standard_normal((N, 3, 3))
    st = type(st)(st.particles.update(F=torch.tensor(
        F, dtype=torch.float32, device=dev)), st.grid, st.max_vel)
    sim = MPMSim(model=_lame("scalar", N, dev),
                 gravity=torch.tensor([0.0, -9.8, 0.0], device=dev))
    cfg = b2.BinnedConfig2(bins_capacity=64)
    bst = b2.bin_state(sim, st, cfg)
    ctx = b2._make_ctx(bst, cfg)
    lanes = b2._lanes(bst, ctx)
    L = bst.cols.shape[0]
    model = _lame(lame, L, dev)
    m = lanes[4]
    gm = b2._ctx_p2g_affine(ctx, m[:, None],
                            torch.zeros((L, 1, 3), device=dev))[..., 0]
    u = torch.tensor(rng.standard_normal(tuple(gm.shape) + (3,)),
                     dtype=torch.float32, device=dev)
    u = torch.where((gm > 0)[..., None], u, 0.0)
    # a barrier Hessian on a third of the live lanes, symmetric positive
    # semi-definite, at contact's stiffness
    B = torch.tensor(rng.standard_normal((L, 3, 3)), dtype=torch.float32,
                     device=dev)
    some = ctx.alive & (torch.arange(L, device=dev) % 3 == 0)
    Hc = torch.where(some[:, None, None], 1e3 * (B @ B.transpose(1, 2)), 0.0)
    return bst, ctx, lanes, model, gm, u, Hc


def _system(bst, ctx, lanes, model, Hc, gm):
    xb, _, Fb, _, _, vol = lanes
    return IA.corotated_system(ctx, bst.bin_block, bst.nbr8, xb, Fb, vol,
                               model.mu, model.lam, Hc, gm, DT)


def _composition(ctx, lanes, model, Hc, gm, u):
    """The operator as the implicit step applied it before the fused op:
    G2P, the jvp of the stress around the step's SVD, P2G."""
    _, _, Fb, _, _, vol = lanes
    s0, dC = b2._ctx_g2p(ctx, u)
    dP = model.linearize(Fb)(DT * mm33(dC, Fb))
    Qk = None if Hc is None else (DT * DT) * torch.bmm(
        Hc, s0[..., None])[..., 0]
    kscale = (DT * ctx.dinv * vol)[:, None, None]
    return gm[..., None] * u + b2._ctx_p2g_affine(
        ctx, Qk, kscale * mm33(dP, Fb.transpose(-1, -2)))


def _stiffness_gap(got, want, gm, u):
    """|got - want| over the largest entry of want's stiffness part."""
    scale = (want - gm[..., None] * u).abs().max()
    assert scale > 0
    return ((got - want).abs().max() / scale).item()


@pytest.mark.parametrize("lame", ["scalar", "per_lane"])
@pytest.mark.parametrize("contact", [False, True])
def test_fused_operator_matches_the_composition(contact, lame):
    bst, ctx, lanes, model, gm, u, Hc = _scene(lame=lame)
    Hc = Hc if contact else None
    got = IA.implicit_apply(_system(bst, ctx, lanes, model, Hc, gm), u)
    want = _composition(ctx, lanes, model, Hc, gm, u)
    assert torch.isfinite(got).all()
    assert _stiffness_gap(got, want, gm, u) <= TOL
    if contact:         # the barrier's part is there and is not small
        free = _composition(ctx, lanes, model, None, gm, u)
        assert _stiffness_gap(free, want, gm, u) > 1e-2


@pytest.mark.parametrize("contact", [False, True])
def test_fused_operator_is_symmetric(contact):
    bst, ctx, lanes, model, gm, u, Hc = _scene()
    sys = _system(bst, ctx, lanes, model, Hc if contact else None, gm)
    v = torch.roll(u, 1, 0).flip(-1) * (gm > 0)[..., None]
    Au, Av = IA.implicit_apply(sys, u), IA.implicit_apply(sys, v)
    vAu = (v.double() * Au.double()).sum()
    uAv = (u.double() * Av.double()).sum()
    mag = (v.double() * Au.double()).abs().sum()
    assert (vAu - uAv).abs() <= 1e-6 * mag, ((vAu - uAv).abs() / mag).item()


def _counting(monkeypatch):
    """Counts the fused applications the implicit step makes."""
    calls = []
    apply = IA.implicit_apply

    def counted(sys, u):
        calls.append(1)
        return apply(sys, u)
    monkeypatch.setattr(IA, "implicit_apply", counted)
    return calls


def _block(model, dev):
    """The scene's binned state under ``model``, stepped at dt 5e-3."""
    rng = np.random.default_rng(11)
    st = make_mpm_state(rng.uniform(0.3, 0.7, (N, 3)), dx=DX, device=dev,
                        block_capacity=512)
    F = np.diag([1.1, 0.9, 1.0]).astype(np.float32)
    st = type(st)(st.particles.update(F=torch.tensor(
        np.broadcast_to(F, (N, 3, 3)).copy(), device=dev)), st.grid,
        st.max_vel)
    sim = MPMSim(model=model,
                 gravity=torch.tensor([0.0, -9.8, 0.0], device=dev))
    cfg = b2.BinnedConfig2(bins_capacity=64)
    return sim, b2.bin_state(sim, st, cfg), cfg


def _no_jvp(*a, **k):
    raise AssertionError("torch.func.jvp ran in a FixedCorotated step")


def test_corotated_step_takes_the_fused_route(monkeypatch):
    calls = _counting(monkeypatch)
    monkeypatch.setattr(torch.func, "jvp", _no_jvp)
    sim, bst, cfg = _block(FixedCorotated.from_young_poisson(
        1e4, 0.3, device=CPU), CPU)
    n0 = IA.LAUNCHES
    out, iters = ib2.implicit_step_binned2(sim, bst, DT, cfg, rebin=False,
                                           with_stats=True)
    assert iters > 0 and len(calls) == iters + 1
    assert IA.LAUNCHES == n0                 # the plain version on the CPU
    assert torch.isfinite(out.cols).all()


def test_neohookean_step_takes_the_jvp_route(monkeypatch):
    calls = _counting(monkeypatch)
    lin = []
    linearize = NeoHookean.linearize

    def counted(self, F):
        lin.append(1)
        return linearize(self, F)
    monkeypatch.setattr(NeoHookean, "linearize", counted)
    sim, bst, cfg = _block(NeoHookean.from_young_poisson(
        1e4, 0.3, device=CPU), CPU)
    out, iters = ib2.implicit_step_binned2(sim, bst, DT, cfg, rebin=False,
                                           with_stats=True)
    assert iters > 0 and not calls and lin == [1]
    assert torch.isfinite(out.cols).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lame", ["scalar", "per_lane"])
def test_kernel_matches_plain_on_cuda(lame, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    bst, ctx, lanes, model, gm, u, Hc = _scene(dev, lame)
    for H in (None, Hc):
        sys = _system(bst, ctx, lanes, model, H, gm)
        n0 = IA.LAUNCHES
        got = IA.implicit_apply(sys, u)
        torch.cuda.synchronize()
        assert IA.LAUNCHES == n0 + 1
        plain = IA.implicit_apply_reference(sys, u)
        want = IA.implicit_apply_reference(IA.as_float64(sys), u.double())
        assert _stiffness_gap(got.double(), want, gm.double(),
                              u.double()) <= TOL
        assert _stiffness_gap(plain.double(), want, gm.double(),
                              u.double()) <= TOL
    # the implicit step: one launch an application, no jvp; NeoHookean
    # launches none
    monkeypatch.setattr(torch.func, "jvp", _no_jvp)
    sim, bst, cfg = _block(FixedCorotated.from_young_poisson(
        1e4, 0.3, device=dev), dev)
    n0 = IA.LAUNCHES
    _, iters = ib2.implicit_step_binned2(sim, bst, DT, cfg, rebin=False,
                                         with_stats=True)
    assert iters > 0 and IA.LAUNCHES == n0 + iters + 1
    monkeypatch.undo()
    sim, bst, cfg = _block(NeoHookean.from_young_poisson(
        1e4, 0.3, device=dev), dev)
    n0 = IA.LAUNCHES
    ib2.implicit_step_binned2(sim, bst, DT, cfg, rebin=False)
    assert IA.LAUNCHES == n0
