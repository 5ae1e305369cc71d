"""The port's hinge kernels (zpc_tpu_torch.geometry.dihedral) against
zpc_tpu on the same seeded numpy hinges.

Tolerances, from tests/test_dihedral.py: the angle within 2e-6 of JAX's
and of the reference acos + sign form; the gradient within 1e-5 of the
largest entry of JAX's (its finite-difference test holds the gradient to
rtol 2e-4, atol 2e-5); the Hessian within 3e-6 of the largest entry
(JAX's symmetry tolerance) and symmetric to 3e-6; the bending energy,
gradient and Hessian within rtol 1e-6 of JAX's, the Hessian's entries
within 2e-4 of the largest (JAX's symmetry tolerance for it).  The flat
hinge gives angle 0 within 1e-7 and a finite gradient equal to JAX's; a
degenerate hinge gives JAX's angle, and a zero gradient where JAX's is NaN
(torch's derivative of atan2 at (0, 0) is zero, JAX's NaN).
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch.geometry import dihedral as TD

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax.numpy as jnp
    from zpc_tpu.geometry import dihedral as JD
except ImportError:
    pass

ANGLE_TOL, GRAD_REL, HESS_TOL = 2e-6, 1e-5, 3e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hinges(seed, n):
    """tests/test_dihedral.py's hinges: v0 standard normal, the others
    v0 plus standard normals; float32."""
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal((n, 3))
    v1 = v0 + rng.standard_normal((n, 3))
    v2 = v0 + rng.standard_normal((n, 3))
    v3 = v0 + rng.standard_normal((n, 3))
    return [a.astype(np.float32) for a in (v2, v0, v1, v3)]


def _ref_angle(v2, v0, v1, v3):
    """The reference's acos of the normalised normals with the sign flip
    where (n2 x n1).(v0 - v1) < 0, in float64."""
    v2, v0, v1, v3 = (a.astype(np.float64) for a in (v2, v0, v1, v3))
    n1 = np.cross(v0 - v2, v1 - v2)
    n2 = np.cross(v1 - v3, v0 - v3)
    c = (n1 * n2).sum(-1) / np.sqrt((n1 * n1).sum(-1) * (n2 * n2).sum(-1))
    da = np.arccos(np.clip(c, -1.0, 1.0))
    flip = (np.cross(n2, n1) * (v0 - v1)).sum(-1) < 0
    return np.where(flip, -da, da)


def _both(fn, hinges, *extra):
    j = np.asarray(getattr(JD, fn)(*map(jnp.asarray, hinges), *extra))
    t = getattr(TD, fn)(*map(torch.from_numpy, hinges), *extra)
    return t.detach().numpy(), j


@pytest.mark.parametrize("seed", [3, 4])
def test_angle(seed):
    h = _hinges(seed, 64)
    t, j = _both("dihedral_angle", h)
    np.testing.assert_allclose(t, j, rtol=0, atol=ANGLE_TOL)
    np.testing.assert_allclose(t, _ref_angle(*h), rtol=0, atol=ANGLE_TOL)


@pytest.mark.parametrize("branch", [1, -1])
def test_branch_shifts(branch):
    h = _hinges(3, 256)
    t, j = _both("dihedral_angle", h, branch)
    np.testing.assert_allclose(t, j, rtol=0, atol=ANGLE_TOL)
    if branch > 0:
        assert (t >= 0).all() and (t < 2 * np.pi).all()
    else:
        assert (t <= 0).all() and (t > -2 * np.pi).all()


@pytest.mark.parametrize("seed", [3, 5])
def test_gradient(seed):
    t, j = _both("dihedral_angle_gradient", _hinges(seed, 128))
    assert t.shape == j.shape == (128, 12)
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=GRAD_REL * np.abs(j).max())


def test_hessian():
    t, j = _both("dihedral_angle_hessian", _hinges(3, 16))
    assert t.shape == j.shape == (16, 12, 12)
    np.testing.assert_allclose(t, j, rtol=0, atol=HESS_TOL * np.abs(j).max())
    np.testing.assert_allclose(t, np.swapaxes(t, -1, -2), rtol=0,
                               atol=HESS_TOL * np.abs(t).max())


def test_flat_and_degenerate_hinges():
    """The flat hinge of tests/test_dihedral.py: angle 0 and a finite
    gradient, equal to JAX's; a hinge whose shared edge has zero length
    and one with a degenerate triangle: JAX's angle, and a zero gradient
    where JAX's is NaN."""
    flat = [np.asarray([v], np.float32) for v in
            ([0.5, 1.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
             [0.5, -1.0, 0.0])]
    t, j = _both("dihedral_angle", flat)
    np.testing.assert_allclose(t, 0.0, atol=1e-7)
    np.testing.assert_allclose(t, j, atol=1e-7)
    g, gj = _both("dihedral_angle_gradient", flat)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, gj, rtol=1e-6, atol=1e-7)
    zero_edge = [np.asarray([v], np.float32) for v in
                 ([0.5, 1.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                  [0.5, -1.0, 0.3])]
    flat_tri = [np.asarray([v], np.float32) for v in
                ([2.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                 [0.5, -1.0, 0.3])]
    for h in (zero_edge, flat_tri):
        t, j = _both("dihedral_angle", h)
        np.testing.assert_array_equal(t, j)
        g, gj = _both("dihedral_angle_gradient", h)
        assert np.isnan(gj).all()
        np.testing.assert_array_equal(g, 0.0)


def test_bending_energy_gradient_hessian():
    h = _hinges(3, 16)
    rest, k = np.float32(0.3), np.float32(2.5)
    e, ej = _both("hinge_bending_energy", h, rest, k)
    np.testing.assert_allclose(e, ej, rtol=1e-6, atol=1e-6)
    g, gj = _both("hinge_bending_gradient", h, rest, k)
    np.testing.assert_allclose(g, gj, rtol=0,
                               atol=GRAD_REL * np.abs(gj).max())
    H, Hj = _both("hinge_bending_hessian", h, rest, k)
    np.testing.assert_allclose(H, Hj, rtol=0, atol=2e-4 * np.abs(Hj).max())
    # per-hinge stiffness broadcasts over the Hessian's two axes
    kk = np.linspace(1.0, 2.0, 16).astype(np.float32)
    Hk = TD.hinge_bending_hessian(*map(torch.from_numpy, h), rest,
                                  torch.from_numpy(kk)).numpy()
    Hkj = np.asarray(JD.hinge_bending_hessian(*map(jnp.asarray, h), rest,
                                              jnp.asarray(kk)))
    np.testing.assert_allclose(Hk, Hkj, rtol=0, atol=2e-4 * np.abs(Hkj).max())


@pytest.mark.cuda
def test_card_against_cpu():
    """Angle, gradient and Hessian on the card against the CPU port."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    h = [torch.from_numpy(a) for a in _hinges(7, 4096)]
    for fn, tol in (("dihedral_angle", ANGLE_TOL),
                    ("dihedral_angle_gradient", 1e-5),
                    ("dihedral_angle_hessian", 1e-4)):
        c = getattr(TD, fn)(*h)
        g = getattr(TD, fn)(*(a.to(dev) for a in h)).cpu()
        torch.testing.assert_close(g, c, rtol=0,
                                   atol=tol * c.abs().max().item())
