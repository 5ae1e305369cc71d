"""The port's tet FEM (zpc_tpu_torch.sim.fem) against zpc_tpu on the same
seeded numpy inputs, the mesh carried across by ``interop.fem_from_jax``.

Scenes are tests/test_fem.py's boxes (2 x 2 x 2 to 4 x 3 x 3 vertices,
spacing 0.05 to 0.1).  Tolerances:

* the mesh (tets, pinned flags) equal bit for bit, rest-shape inverses,
  volumes and masses within 1e-6 of their largest entry (JAX and torch
  take the determinant and inverse by their own LU);
* energy within rtol 1e-5, gradient and Hessian-vector product within
  1e-5 and 1e-4 of their largest entry (tests/test_torch_contact.py's
  derivative and Hessian tolerances), for NeoHookean and FixedCorotated;
* trajectories within tests/test_cloth.py's rtol 3e-4, atol 5e-6.

JAX's Hessian-vector product through an SVD model is NaN at every state:
its ``svd3x3`` jvp rule recomputes the factors by the raw Jacobi sweeps,
so a second derivative differentiates the sweeps themselves.  So its FEM
step with FixedCorotated never moves: the CG's first residual is NaN, its
loop test fails at once, and the step returns its input with zero
velocity.  The tests hold that, and hold the
port's FixedCorotated product (a second backward pass through the SVD's
backward rule) to central differences of JAX's own float64 gradient at a
state whose singular values lie well apart: near repeated singular values
the SVD differential's clamped inverses bend the product (at exactly
repeated ones they drop the shear terms), in both packages' rule.  The
port's FixedCorotated steps are held to tests/test_fem.py's physics.
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch import interop, scenes
from zpc_tpu_torch.models.constitutive import FixedCorotated, NeoHookean
from zpc_tpu_torch.sim import fem as TF

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.models import constitutive as JM
    from zpc_tpu.sim import fem as JF
except ImportError:
    pass

CPU = torch.device("cpu")
E_RTOL, GRAD_REL, HVP_REL = 1e-5, 1e-5, 1e-4
TRAJ = dict(rtol=3e-4, atol=5e-6)
MODELS = ("NeoHookean", "FixedCorotated")
FD_H = 1e-6          # central-difference step of the float64 oracle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, rel, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def _box(model, n=(2, 2, 2), spacing=0.1, **kw):
    """The same box in both packages, clear of the ground barrier: (jax
    sim, x0, port sim)."""
    jm = getattr(JM, model).from_young_poisson(1e5, 0.3)
    sj, xj = JF.make_tet_box(*n, spacing, model=jm, origin=(0.0, 0.5, 0.0),
                             **kw)
    return sj, xj, interop.fem_from_jax(sj, CPU)


def _grad64(sj):
    """JAX's gradient of the FEM energy in float64 (call under
    ``jax.enable_x64()``), as a numpy function of float64 positions."""
    s64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                       if jnp.issubdtype(a.dtype, jnp.floating) else a, sj)
    g = jax.jit(jax.grad(lambda z: JF.fem_energy(s64, z)))
    return lambda y: np.asarray(g(y))


@pytest.mark.parametrize("n", [(4, 3, 3), (2, 2, 2), (3, 2, 4)])
def test_make_tet_box(n):
    pinned = (0, 1)
    jm = JM.NeoHookean.from_young_poisson(1e5, 0.3)
    sj, xj = JF.make_tet_box(*n, 0.1, model=jm, pinned=pinned)
    tm = NeoHookean.from_young_poisson(1e5, 0.3, device=CPU)
    st, xt = TF.make_tet_box(*n, 0.1, model=tm, pinned=pinned, device=CPU)
    np.testing.assert_array_equal(_np(xt), _np(xj))
    np.testing.assert_array_equal(_np(st.tets), _np(sj.tets))
    np.testing.assert_array_equal(_np(st.free), _np(sj.free))
    for f in ("Dm_inv", "vol", "mass"):
        _close(getattr(st, f), getattr(sj, f), 1e-6, f)
    assert (_np(st.vol) > 0).all()
    box = float(np.prod(np.asarray(n) - 1)) * 0.1 ** 3
    np.testing.assert_allclose(float(st.vol.sum()), box, rtol=1e-5)
    carried = interop.fem_from_jax(sj, CPU)
    assert type(carried.model) is NeoHookean
    assert float(carried.model.mu) == float(tm.mu)


@pytest.mark.parametrize("model", MODELS)
def test_energy_gradient_hvp(model):
    sj, xj, st = _box(model)
    rng = np.random.default_rng(5)
    # stretched so that every tet's singular values lie well apart
    y = (_np(xj) * np.float32([1.3, 1.0, 0.8])
         + 1e-3 * rng.standard_normal(xj.shape)).astype(np.float32)
    p = rng.standard_normal(xj.shape).astype(np.float32)
    energy = lambda z: JF.fem_energy(sj, z)
    with jax.disable_jit(model == "FixedCorotated"):
        e_j, g_j, hv_j = (energy(jnp.asarray(y)),
                          jax.grad(energy)(jnp.asarray(y)),
                          jax.jvp(jax.grad(energy), (jnp.asarray(y),),
                                  (jnp.asarray(p),))[1])
    if model == "FixedCorotated":
        assert np.isnan(_np(hv_j)).all()         # the reference fault
        y64, p64 = y.astype(np.float64), p.astype(np.float64)
        with jax.enable_x64():
            g64 = _grad64(sj)
            hv_j = (g64(y64 + FD_H * p64) - g64(y64 - FD_H * p64)) / (
                2 * FD_H)
    z = torch.from_numpy(y).requires_grad_(True)
    e_t = TF.fem_energy(st, z)
    np.testing.assert_allclose(e_t.item(), float(e_j), rtol=E_RTOL)
    g_t = torch.autograd.grad(e_t, z, create_graph=True)[0]
    _close(g_t, g_j, GRAD_REL, "gradient")
    hv_t = torch.autograd.grad(g_t, z, torch.from_numpy(p))[0]
    _close(hv_t, hv_j, HVP_REL, "Hessian-vector product")


def test_rest_state_is_equilibrium():
    """tests/test_fem.py's rest state: zero gradient without gravity."""
    sim, x0 = TF.make_tet_box(
        3, 3, 3, 0.1, device=CPU, gravity=(0.0, 0.0, 0.0),
        model=NeoHookean.from_young_poisson(1e5, 0.3, device=CPU))
    z = x0.clone().requires_grad_(True)
    g = torch.autograd.grad(TF.fem_energy(sim, z), z)[0]
    torch.testing.assert_close(g, torch.zeros_like(g), rtol=0, atol=1e-3)


def _hanging(model):
    """The hanging box of tests/test_fem.py (3 x 5 x 3 at spacing 0.05,
    the top row pinned) in zpc_tpu, and its pinned ids."""
    jm = getattr(JM, model).from_young_poisson(5e4, 0.3)
    top = [i * 15 + 4 * 3 + k for i in range(3) for k in range(3)]
    sj, xj = JF.make_tet_box(3, 5, 3, 0.05, model=jm, density=1e3,
                             origin=(0.0, 0.3, 0.0), pinned=top)
    return sj, xj, top


def test_trajectory_neo_hookean():
    """10 steps of the hanging box against JAX's."""
    sj, xj, top = _hanging("NeoHookean")
    st = interop.fem_from_jax(sj, CPU)
    step = jax.jit(lambda x, v: JF.implicit_step(sj, x, v, 0.01))
    x0 = _np(xj)
    vj = jnp.zeros_like(xj)
    x, v = torch.from_numpy(x0.copy()), torch.zeros(xj.shape)
    for k in range(10):
        xj, vj = step(xj, vj)
        x, v, iters = TF.implicit_step(st, x, v, 0.01, with_stats=True)
        assert max(iters) > 1
        np.testing.assert_allclose(_np(x), _np(xj), **TRAJ,
                                   err_msg=f"step {k}")
    np.testing.assert_array_equal(_np(x)[top], x0[top])


def test_trajectory_fixed_corotated():
    """JAX's FixedCorotated step does not move the hanging box; the
    port's 20 steps stay finite, keep the pins and sag."""
    sj, xj, top = _hanging("FixedCorotated")
    with jax.disable_jit():
        xn, vn = JF.implicit_step(sj, xj, jnp.zeros_like(xj), 0.01,
                                  newton_iters=1)
    # the reference fault: the NaN product stops the CG before it starts
    np.testing.assert_array_equal(_np(xn), _np(xj))
    assert not _np(vn).any()
    st = interop.fem_from_jax(sj, CPU)
    x0 = torch.from_numpy(_np(xj).copy())
    x, v = x0, torch.zeros_like(x0)
    for _ in range(20):
        x, v, iters = TF.implicit_step(st, x, v, 0.01, with_stats=True)
        assert bool(torch.isfinite(x).all()) and max(iters) > 1
    torch.testing.assert_close(x[top], x0[top], rtol=0, atol=0)
    assert x[:, 1].min().item() < x0[:, 1].min().item() - 1e-4


def test_hanging_scene_sags_and_drop_stays_above_ground():
    """tests/test_fem.py's hang (scenes.tet_box_hanging at the test's
    3 x 5 x 3) and drop on the port: pins fixed, the block sags and
    settles; the dropped block never crosses the ground."""
    sim, x0, top = scenes.tet_box_hanging((3, 5, 3), CPU)
    x, v = x0, torch.zeros_like(x0)
    for _ in range(40):
        x, v = TF.implicit_step(sim, x, v, 0.01)
    assert bool(torch.isfinite(x).all())
    torch.testing.assert_close(x[top], x0[top], rtol=0, atol=1e-6)
    assert x[:, 1].min().item() < x0[:, 1].min().item() - 1e-4
    assert v.abs().max().item() < 0.2
    sim, x0 = TF.make_tet_box(
        3, 3, 3, 0.05, device=CPU, density=1e3, origin=(0.0, 0.05, 0.0),
        dhat=0.02, kappa=5.0,
        model=NeoHookean.from_young_poisson(5e4, 0.3, device=CPU))
    x, v = x0, torch.zeros_like(x0)
    for _ in range(50):
        x, v = TF.implicit_step(sim, x, v, 0.005)
        assert x[:, 1].min().item() > 0.0
    assert v.abs().max().item() < 0.5
    assert x[:, 1].min().item() < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_card_against_cpu(model):
    """The hanging 3 x 5 x 3 box, 5 steps on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = []
    for dev in (CPU, torch.device("cuda")):
        m = (NeoHookean if model == "NeoHookean" else
             FixedCorotated).from_young_poisson(5e4, 0.3, device=dev)
        sim, x, _ = scenes.tet_box_hanging((3, 5, 3), dev, m)
        v = torch.zeros_like(x)
        for _ in range(5):
            x, v = TF.implicit_step(sim, x, v, 0.01)
        out.append(x.cpu())
    torch.testing.assert_close(out[1], out[0], **TRAJ)
