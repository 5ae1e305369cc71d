"""The port's matrix-free solvers (zpc_tpu_torch.math.solvers) against
zpc_tpu.math.solvers on the systems of tests/test_math.py TestSolvers.

Each system is made with seeded numpy and handed to both packages (JAX on
the CPU, the port on CPU tensors).  Both run the same recurrences with the
same stopping rule, so the iteration counts must be equal and x must agree
within 1e-5 of max |x| (the two sum fp32 products in different orders;
the largest difference measured is 1.2e-7, on MinRes).
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch import scenes
from zpc_tpu_torch.math import solvers as tsolvers

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax.numpy as jnp
    from zpc_tpu.math import solvers as jsolvers
except ImportError:
    pass

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(rng, n):
    M = rng.standard_normal((n, n)).astype(np.float32)
    A = M @ M.T + n * np.eye(n, dtype=np.float32)
    return A, rng.standard_normal(n).astype(np.float32)


def _indefinite(rng, n=24):
    M = rng.standard_normal((n, n)).astype(np.float32)
    return 0.5 * (M + M.T), rng.standard_normal(n).astype(np.float32)


def _both(A):
    """The operator x -> A x in each package."""
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    return (lambda x: Aj @ x), (lambda x: At @ x)


def _assert_same(jres, tres, flat=lambda x: x):
    xj = np.asarray(flat(jres.x), np.float64)
    xt = flat(tres.x)
    xt = (xt.numpy() if isinstance(xt, torch.Tensor) else np.asarray(xt)
          ).astype(np.float64)
    assert tres.iters == int(jres.iters)
    scale = np.abs(xj).max()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=RTOL * scale)
    assert bool(tres.converged) == bool(jres.converged)


# (name, system maker, solver keyword arguments): the cases of TestSolvers
CASES = {
    "cg": (lambda rng: _spd(rng, 40), {}),
    "cg_preconditioned": (lambda rng: _spd(rng, 40), {"jacobi": True}),
    "cg_projected": (lambda rng: _spd(rng, 20), {"freeze0": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cg_matches_jax(case, rng):
    (make, opts) = CASES[case]
    A, b = make(rng)
    Aj, At = _both(A)
    kw_j, kw_t = {}, {}
    if opts.get("jacobi"):
        dinv = (1.0 / np.diag(A)).astype(np.float32)
        kw_j["precondition"] = lambda r: jnp.asarray(dinv) * r
        kw_t["precondition"] = lambda r: torch.from_numpy(dinv) * r
    if opts.get("freeze0"):
        mask = np.ones(A.shape[0], np.float32)
        mask[0] = 0.0
        kw_j["project"] = lambda v: jnp.asarray(mask) * v
        kw_t["project"] = lambda v: torch.from_numpy(mask) * v
    jres = jsolvers.cg(Aj, jnp.asarray(b), max_iters=200, rel_tol=1e-6,
                       **kw_j)
    tres = tsolvers.cg(At, torch.from_numpy(b), max_iters=200, rel_tol=1e-6,
                       **kw_t)
    _assert_same(jres, tres)
    assert tres.iters > 1
    if opts.get("freeze0"):
        assert float(tres.x[0]) == 0.0


@pytest.mark.parametrize("view", ["dict", "tuple", "list"])
def test_cg_dof_view_matches_jax(view, rng):
    """tests/test_math.py test_cg_pytree: the unknowns split over a dict
    (or a tuple or list) of two tensors."""
    A, b = _spd(rng, 16)

    def split(v, mod):
        if view == "dict":
            return {"a": v[:8], "b": v[8:]}
        parts = (v[:8], v[8:])
        return list(parts) if view == "list" else parts

    def joined(v, cat):
        return cat([v["a"], v["b"]] if view == "dict" else list(v))

    def mul_j(x):
        return split(jnp.asarray(A) @ joined(x, jnp.concatenate), jnp)

    def mul_t(x):
        return split(torch.from_numpy(A) @ joined(x, torch.cat), torch)

    if view == "list":      # JAX flattens lists too; hand it a tuple
        bj = tuple(split(jnp.asarray(b), jnp))
    else:
        bj = split(jnp.asarray(b), jnp)
    jres = jsolvers.cg(lambda x: (tuple(mul_j(x)) if view == "list"
                                  else mul_j(x)), bj, max_iters=100,
                       rel_tol=1e-6)
    tres = tsolvers.cg(mul_t, split(torch.from_numpy(b), torch),
                       max_iters=100, rel_tol=1e-6)
    assert type(tres.x) is {"dict": dict, "tuple": tuple,
                            "list": list}[view]
    _assert_same(jres, tres,
                 flat=lambda x: (np.concatenate([np.asarray(x["a"]),
                                                 np.asarray(x["b"])])
                                 if isinstance(x, dict) else
                                 np.concatenate([np.asarray(p) for p in x])))
    ref = np.linalg.solve(A.astype(np.float64), b)
    got = np.concatenate([np.asarray(p) for p in (
        tres.x.values() if view == "dict" else tres.x)])
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_conjugate_residual_matches_jax(rng):
    A, b = _spd(rng, 24)
    Aj, At = _both(A)
    jres = jsolvers.conjugate_residual(Aj, jnp.asarray(b), max_iters=200,
                                       rel_tol=1e-6)
    tres = tsolvers.conjugate_residual(At, torch.from_numpy(b),
                                       max_iters=200, rel_tol=1e-6)
    _assert_same(jres, tres)
    np.testing.assert_allclose(tres.x.numpy(), np.linalg.solve(A, b),
                               atol=1e-3, rtol=1e-3)


def test_minres_matches_jax(rng):
    """An indefinite system with eigenvalues of both signs kept off 0
    (|lambda| in [1, 3]): the Lanczos recurrences of both packages stay
    together to convergence."""
    n = 24
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    lam = rng.uniform(1.0, 3.0, n) * np.where(np.arange(n) % 2, -1.0, 1.0)
    A = ((Q * lam) @ Q.T).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    Aj, At = _both(A)
    jres = jsolvers.minres(Aj, jnp.asarray(b), max_iters=300, rel_tol=1e-6)
    tres = tsolvers.minres(At, torch.from_numpy(b), max_iters=300,
                           rel_tol=1e-6)
    _assert_same(jres, tres)
    np.testing.assert_allclose(tres.x.numpy(), np.linalg.solve(A, b),
                               atol=1e-4, rtol=1e-4)


def test_minres_test_math_system(rng):
    """tests/test_math.py test_cr_minres_indefinite's system (cond ~100,
    eigenvalues near 0): in fp32 the Lanczos vectors lose orthogonality,
    and the two packages' residuals, equal to 6e-7 relative through
    iteration 13, part from iteration ~19 on (summation order; my CPU
    run).  Both converge, after 38 (port) and 46 (JAX) iterations, so the
    counts are not compared here; x is held to the dense solve as the
    JAX test holds it, and to JAX's x within 1e-4 of max |x| (measured
    9e-6)."""
    A, b = _indefinite(rng)
    Aj, At = _both(A)
    jres = jsolvers.minres(Aj, jnp.asarray(b), max_iters=300, rel_tol=1e-6)
    tres = tsolvers.minres(At, torch.from_numpy(b), max_iters=300,
                           rel_tol=1e-6)
    assert bool(tres.converged) and bool(jres.converged)
    xj = np.asarray(jres.x)
    np.testing.assert_allclose(tres.x.numpy(), xj, rtol=0,
                               atol=1e-4 * np.abs(xj).max())
    np.testing.assert_allclose(tres.x.numpy(), np.linalg.solve(A, b),
                               atol=5e-2, rtol=5e-2)


def test_dof_view_rejects_other_types():
    with pytest.raises(TypeError, match="dof view"):
        tsolvers.dot(np.ones(3), np.ones(3))


def test_laplace_is_bench_poisson_operator():
    """scenes.laplace against a dense 7-point matrix with zero boundary,
    and CG on it from scenes.poisson_rhs against the JAX package's CG on
    bench_poisson's own operator."""
    n = 6
    u = np.random.default_rng(1).standard_normal((n, n, n)).astype(
        np.float32)
    want = 6.0 * u
    for d in range(3):
        want -= np.roll(u, -1, d) * (np.arange(n) < n - 1).reshape(
            [-1 if k == d else 1 for k in range(3)])
        want -= np.roll(u, 1, d) * (np.arange(n) > 0).reshape(
            [-1 if k == d else 1 for k in range(3)])
    np.testing.assert_allclose(scenes.laplace(torch.from_numpy(u)).numpy(),
                               want, rtol=0, atol=1e-5)

    def jlaplace(v):
        out = 6.0 * v
        out = out - jnp.pad(v[1:], ((0, 1), (0, 0), (0, 0)))
        out = out - jnp.pad(v[:-1], ((1, 0), (0, 0), (0, 0)))
        out = out - jnp.pad(v[:, 1:], ((0, 0), (0, 1), (0, 0)))
        out = out - jnp.pad(v[:, :-1], ((0, 0), (1, 0), (0, 0)))
        out = out - jnp.pad(v[:, :, 1:], ((0, 0), (0, 0), (0, 1)))
        out = out - jnp.pad(v[:, :, :-1], ((0, 0), (0, 0), (1, 0)))
        return out
    b = scenes.poisson_rhs(12, torch.device("cpu"))
    jres = jsolvers.cg(jlaplace, jnp.asarray(b.numpy()), max_iters=20,
                       rel_tol=0.0)
    tres = tsolvers.cg(scenes.laplace, b, max_iters=20, rel_tol=0.0)
    _assert_same(jres, tres)


@pytest.mark.cuda
def test_cg_poisson_on_cuda_matches_cpu():
    """bench_poisson's CG at 32^3 for 100 iterations on the card against
    the CPU: x within 1e-5 of max |x|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xs = [tsolvers.cg(scenes.laplace, scenes.poisson_rhs(32, dev),
                      max_iters=100, rel_tol=0.0).x.cpu()
          for dev in (torch.device("cuda"), torch.device("cpu"))]
    assert (xs[0] - xs[1]).abs().max().item() <= \
        1e-5 * xs[1].abs().max().item()
