"""The port's hashes, probability helpers and samplers
(zpc_tpu_torch.math.random) against zpc_tpu.math.random.

The hashes are deterministic and held bit for bit; the normal pdf, cdf and
inverse erf at 1e-6 relative.  A ``jax.random`` stream cannot be drawn in
PyTorch, so the samplers are held to their distributions, from fixed seeds
of a ``torch.Generator``, with bounds stated at each test (each is several
standard errors wide at its sample size).
"""

import numpy as np
import pytest
import torch

# JAX is imported where it is installed (the machine with the card has
# none, and runs only the cuda test); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.math import random as jr
except ImportError:
    jax = jnp = jr = None

from zpc_tpu_torch.math import random as tr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    x[:6] = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 65_536]
    return x


def _eq(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_int_hash_and_unhash_match(seed):
    x = _ints(4096, seed)
    h = tr.int_hash(torch.from_numpy(x))
    _eq(h, jr.int_hash(jnp.asarray(x)))
    _eq(tr.int_unhash(torch.from_numpy(x)), jr.int_unhash(jnp.asarray(x)))
    _eq(tr.int_unhash(h), x)                  # invertible
    u = x.view(np.uint32)
    _eq(tr.int_hash(torch.from_numpy(u)), jr.int_hash(jnp.asarray(u)))


def test_hash_combine_matches():
    s, v = _ints(2048, 2), _ints(2048, 3)
    _eq(tr.hash_combine(torch.from_numpy(s), torch.from_numpy(v)),
        jr.hash_combine(jnp.asarray(s), jnp.asarray(v)))
    _eq(tr.hash_combine(7, torch.from_numpy(v)),
        jr.hash_combine(7, jnp.asarray(v)))


@pytest.mark.parametrize("a,b,m", [(3, 5, 97), (0x9E3779B1, 12345, 1 << 20),
                                   (2 ** 32 - 1, 2 ** 32 - 1, 2 ** 31 + 11)])
def test_universal_hash_matches(a, b, m):
    """Large ``a`` takes the product past 2^64, which the port splits."""
    x = _ints(4096, a % 1000)
    _eq(tr.universal_hash(torch.from_numpy(x), a, b, m),
        jr.universal_hash(jnp.asarray(x), np.uint32(a), np.uint32(b),
                          np.uint32(m)))


def test_hash_distribution():
    h = tr.int_hash(torch.arange(10_000, dtype=torch.int32)).numpy()
    buckets = np.bincount(h.view(np.uint32) % 64, minlength=64)
    assert buckets.min() > 10_000 / 64 * 0.7


def test_pdf_cdf_erfinv_match():
    rng = np.random.default_rng(4)
    x = rng.uniform(-4, 4, 2000).astype(np.float32)
    t = torch.from_numpy(x)
    for mean, std in ((0.0, 1.0), (0.5, 2.0)):
        np.testing.assert_allclose(
            tr.pdf_normal(t, mean, std).numpy(),
            np.asarray(jr.pdf_normal(jnp.asarray(x), mean, std)),
            rtol=1e-6)
        np.testing.assert_allclose(
            tr.cdf_normal(t, mean, std).numpy(),
            np.asarray(jr.cdf_normal(jnp.asarray(x), mean, std)),
            rtol=1e-6, atol=1e-7)
    p = rng.uniform(-0.99, 0.99, 2000).astype(np.float32)
    np.testing.assert_allclose(tr.erf_inv(torch.from_numpy(p)).numpy(),
                               np.asarray(jr.erf_inv(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-7)


def test_sphere_and_ball():
    """Unit norms (1e-5, the JAX test's); the mean of each axis within
    0.05 (4.5 standard errors of 1/sqrt(3 n) at n = 10,000); in the ball,
    r^3 is uniform: its mean within 0.015 of 1/2 (5 standard errors)."""
    n = 10_000
    v = tr.sample_uniform_sphere(_gen(0), (n,))
    jv = jr.sample_uniform_sphere(jax.random.PRNGKey(0), (n,))
    assert v.shape == tuple(jv.shape) and v.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.vector_norm(v, dim=1).numpy(),
                               1.0, atol=1e-5)
    assert (v.mean(0).abs() < 0.05).all()
    b = tr.sample_uniform_ball(_gen(1), (n,))
    assert b.shape == tuple(jr.sample_uniform_ball(jax.random.PRNGKey(1),
                                                   (n,)).shape)
    r3 = torch.linalg.vector_norm(b, dim=1) ** 3
    assert (r3 <= 1.0 + 1e-6).all() and abs(float(r3.mean()) - 0.5) < 0.015


def test_normal_moments():
    """Mean within 0.03 and std within 0.03 of (1.5, 2.0) at n = 40,000
    (3 and 4 standard errors)."""
    x = tr.sample_normal(_gen(2), (40_000,), mean=1.5, std=2.0)
    assert x.shape == tuple(jr.sample_normal(jax.random.PRNGKey(2),
                                             (40_000,)).shape)
    assert abs(float(x.mean()) - 1.5) < 0.03
    assert abs(float(x.std()) - 2.0) < 0.03


def test_categorical():
    """Frequencies within 0.01 of the normalised weights at n = 50,000
    (about 5 standard errors); zero-weight categories never drawn."""
    probs = torch.tensor([0.0, 2.0, 1.0, 0.0, 5.0])
    s = tr.sample_categorical(_gen(3), probs, (50_000,))
    assert s.dtype == torch.int32 and s.shape == (50_000,)
    freq = np.bincount(s.numpy(), minlength=5) / 50_000
    np.testing.assert_allclose(freq, [0, 0.25, 0.125, 0, 0.625], atol=0.01)
    one = tr.sample_categorical(_gen(4), torch.tensor([0.0, 0.0, 1.0]),
                                (100,))
    ref = jr.sample_categorical(jax.random.PRNGKey(1),
                                jnp.asarray([0.0, 0.0, 1.0]), (100,))
    _eq(one, ref)


@pytest.mark.cuda
def test_random_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_ints(1 << 20, 5))
    for fn in (tr.int_hash, tr.int_unhash):
        assert torch.equal(fn(x.cuda()).cpu(), fn(x))
    assert torch.equal(tr.universal_hash(x.cuda(), 2 ** 32 - 1, 7, 1 << 20)
                       .cpu(), tr.universal_hash(x, 2 ** 32 - 1, 7, 1 << 20))
    assert torch.equal(tr.hash_combine(x.cuda(), x.cuda()).cpu()
                       .to(torch.int64), tr.hash_combine(x, x)
                       .to(torch.int64))
    gen = torch.Generator(device="cuda").manual_seed(0)
    s = tr.sample_categorical(gen, torch.tensor([1.0, 3.0], device="cuda"),
                              (100_000,))
    assert abs(float((s == 1).float().mean()) - 0.75) < 0.01
