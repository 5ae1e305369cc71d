"""The port's scan (zpc_tpu_torch.ops.scan, parallel.primitives) against
zpc_tpu's Pallas scan and primitives.

The JAX kernel runs in interpret mode on the CPU, as tests/test_scan_pallas.py
runs it.  Integer results must be exact (add wraps mod 2^32 on both sides);
float add is held to rtol 2e-4 / atol 1e-3, the tolerance of
tests/test_scan_pallas.py, because the two sides sum in different orders;
float max/min are exact.
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch.ops import scan as tscan
from zpc_tpu_torch.parallel import primitives as tprim

# zpc_tpu (and so JAX) is imported inside the tests that compare against
# it, so the GPU test below also runs where JAX is not installed
CHUNK = 131072           # zpc_tpu/ops/scan_pallas.py: the TPU kernel's chunk

DTYPES = ["int32", "uint32", "float32"]
CASES = [("add", False), ("max", False), ("min", False), ("add", True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _input(dtype: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return rng.standard_normal(n).astype(np.float32)
    if dtype == "int32":
        return rng.integers(-(2 ** 30), 2 ** 30, n).astype(np.int32)
    return rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def _to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.copy())


def _check(got: np.ndarray, ref: np.ndarray, dtype: str):
    if dtype == "float32":
        np.testing.assert_allclose(got.astype(np.float64),
                                   ref.astype(np.float64), rtol=2e-4,
                                   atol=1e-3)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("op,exclusive", CASES)
@pytest.mark.parametrize("n", [CHUNK, CHUNK + 777])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_scan_matches_scan_pallas(dtype, n, op, exclusive):
    import jax.numpy as jnp
    from zpc_tpu.ops import scan_pallas as sp

    assert sp.CHUNK == CHUNK
    x = _input(dtype, n, seed=n)
    ref = np.asarray(sp.scan_pallas(jnp.asarray(x), exclusive=exclusive,
                                    interpret=True, op=op))
    got = tscan.scan(_to_torch(x), op, exclusive).numpy()
    if dtype == "float32" and op != "add":
        np.testing.assert_array_equal(got, ref)
    else:
        _check(got, ref, dtype)


def _numpy_scan(x: np.ndarray, op: str, exclusive: bool) -> np.ndarray:
    if op == "add":
        if x.dtype == np.float32:
            inc = np.cumsum(x.astype(np.float64))
        else:
            inc = np.cumsum(x.astype(np.int64)) & 0xFFFFFFFF
    else:
        inc = (np.maximum if op == "max" else np.minimum).accumulate(x)
    if exclusive:
        inc = np.concatenate([np.zeros(1, inc.dtype), inc[:-1]])
    if x.dtype == np.float32:
        return inc
    return inc.astype(np.uint32).view(x.dtype) if op == "add" else inc


@pytest.mark.parametrize("op,exclusive", CASES)
@pytest.mark.parametrize("n", [1, 2, 7, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_scan_small_sizes(dtype, n, op, exclusive):
    x = _input(dtype, n, seed=3)
    got = tscan.scan(_to_torch(x), op, exclusive).numpy()
    _check(got, _numpy_scan(x, op, exclusive), dtype)


def test_int32_add_wraps():
    x = np.asarray([2 ** 31 - 1, 1, 5, -7], np.int32)
    got = tscan.scan(_to_torch(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        [2 ** 31 - 1, -2 ** 31, -2 ** 31 + 5, -2 ** 31 - 2 + 2 ** 32],
        np.int64).astype(np.int32))


def test_scan_rejects_bad_input():
    with pytest.raises(ValueError):
        tscan.scan(torch.zeros(4, dtype=torch.int32), "max", exclusive=True)
    with pytest.raises(ValueError):
        tscan.scan(torch.zeros(4, dtype=torch.int32), "mul")
    with pytest.raises(TypeError):
        tscan.scan(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        tscan.scan(torch.zeros((2, 2), dtype=torch.int32))


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_primitives_match_zpc_tpu(dtype, op):
    import jax.numpy as jnp
    from zpc_tpu.core.executor import jit_exec
    from zpc_tpu.parallel import primitives as jprim

    x = _input(dtype, 5000, seed=11)
    pol = jit_exec()
    inc = np.asarray(jprim.inclusive_scan(pol, jnp.asarray(x), op=op))
    exc = np.asarray(jprim.exclusive_scan(pol, jnp.asarray(x), op=op))
    _check(tprim.inclusive_scan(_to_torch(x), op).numpy(), inc, dtype)
    _check(tprim.exclusive_scan(_to_torch(x), op).numpy(), exc, dtype)
    # a non-zero init lands at position 0 only, as in the JAX package
    exc7 = np.asarray(jprim.exclusive_scan(pol, jnp.asarray(x), op=op,
                                           init=7))
    _check(tprim.exclusive_scan(_to_torch(x), op, init=7).numpy(), exc7,
           dtype)


def test_primitives_empty():
    e = torch.zeros(0, dtype=torch.int32)
    assert tprim.inclusive_scan(e).numel() == 0
    assert tprim.exclusive_scan(e, "max").numel() == 0


@pytest.mark.parametrize("op,lead", [("max", -np.inf), ("min", np.inf)])
def test_plain_scan_infinite_lead(op, lead):
    """A max (min) scan over leading -inf (+inf) stays infinite there: the
    float identity is +-inf, not +-FLT_MAX."""
    x = np.asarray([lead, lead, 1.5, -2.0, lead], np.float32)
    got = tscan.scan(_to_torch(x), op).numpy()
    np.testing.assert_array_equal(got, _numpy_scan(x, op, False))
    assert got[0] == got[1] == lead


def test_plain_version_does_not_count_launches():
    before = tscan.LAUNCHES
    tscan.scan(torch.arange(10, dtype=torch.int32))
    assert tscan.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("op,exclusive", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_cuda(dtype, op, exclusive):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel has no CPU mode")
    for n in (1, 1000, 2048, 2049, 327_680, 2 ** 22 + 7):
        x = _to_torch(_input(dtype, n, seed=n))
        before = tscan.LAUNCHES
        got = tscan.scan(x.cuda(), op, exclusive)
        torch.cuda.synchronize()
        assert tscan.LAUNCHES == before + 1
        _check(got.cpu().numpy(), tscan.scan_reference(x, op,
                                                       exclusive).numpy(),
               dtype)
    if dtype == "float32" and op != "add":
        # leading identities across a tile boundary: +-inf must survive
        lead = -np.inf if op == "max" else np.inf
        x = _to_torch(_input(dtype, 5000, seed=1))
        x[:3000] = lead
        got = tscan.scan(x.cuda(), op).cpu()
        np.testing.assert_array_equal(got.numpy(),
                                      tscan.scan_reference(x, op).numpy())
        assert got[2999] == lead
