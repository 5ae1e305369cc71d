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

from zpc_tpu_torch import _kernels
from zpc_tpu_torch.core.executor import seq_exec
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
    cpu = seq_exec()
    _check(tprim.inclusive_scan(cpu, _to_torch(x), op).numpy(), inc, dtype)
    _check(tprim.exclusive_scan(cpu, _to_torch(x), op).numpy(), exc, dtype)
    # a non-zero init lands at position 0 only, as in the JAX package
    exc7 = np.asarray(jprim.exclusive_scan(pol, jnp.asarray(x), op=op,
                                           init=7))
    _check(tprim.exclusive_scan(cpu, _to_torch(x), op, init=7).numpy(),
           exc7, dtype)


def test_primitives_empty():
    e = torch.zeros(0, dtype=torch.int32)
    assert tprim.inclusive_scan(seq_exec(), e).numel() == 0
    assert tprim.exclusive_scan(seq_exec(), e, "max").numel() == 0


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


def test_workspace_sizing_and_growth():
    """The look-back scratch: zeroed, a power of two in words, one tensor
    per (device, stream), made anew and zeroed when a call needs more."""
    ws = _kernels.Workspace()
    cpu = torch.device("cpu")
    head = _kernels.HEADER_WORDS
    a = ws.get(cpu, 7, 10)
    assert a.dtype == torch.int32 and a.device == cpu and a.numel() == 16
    assert not a.any()
    assert ws.get(cpu, 7, 16 - head) is a and ws.get(cpu, 7, 1) is a
    assert ws.get(cpu, 8, 10) is not a               # another stream
    a[0] = 3                                         # grown: zeroed again
    b = ws.get(cpu, 7, 17 - head)
    assert b is not a and b.numel() == 32 and not b.any()
    assert ws.get(cpu, 7, 32 - head) is b
    assert ws.get(cpu, 9, 1).numel() == 8


def test_workspace_start_epoch():
    limit = _kernels.EPOCH_LIMIT
    assert limit == 1 << 30
    buf = _kernels.Workspace(epoch=limit - 2).get(torch.device("cpu"), 0, 3)
    assert _kernels.Workspace.header(buf) == (0, 0, limit - 2)
    assert not buf[_kernels.HEADER_WORDS:].any()
    for bad in (-1, limit):
        with pytest.raises(ValueError):
            _kernels.Workspace(epoch=bad)


def test_workspace_stale_statuses():
    """The wrap test's workspace: every word past the header is below 12,
    a status of epoch 0, 1 or 2, and the flags 1, 2 and 3 all occur."""
    buf = _kernels.Workspace(epoch=5, stale=True).get(
        torch.device("cpu"), 0, 500)
    assert _kernels.Workspace.header(buf) == (0, 0, 5)
    rest = buf[_kernels.HEADER_WORDS:]
    assert ((rest >= 0) & (rest < 12)).all()
    assert set((rest & 3).unique().tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("n,words", [(1, 0), (4096, 0), (4097, 4),
                                     (8193, 6), (16_777_223, 8194)])
def test_library_status_words(n, words):
    """Workspace words past the header: none for one tile, else
    slot_words per tile (a tile of 4,096 and 2 words a tile here)."""
    assert _kernels.Library(None, 4096, 2).status_words(n) == words


def test_cpu_scan_needs_no_kernel_library(monkeypatch):
    """A CPU tensor takes the plain version and never loads the library."""
    def no_library():
        raise AssertionError("the CPU path loaded the kernel library")
    monkeypatch.setattr(tscan, "_library", no_library)
    x = _input("int32", 9000, seed=4)
    for op, exclusive in CASES:
        got = tscan.scan(_to_torch(x), op, exclusive).numpy()
        _check(got, _numpy_scan(x, op, exclusive), "int32")


def _cuda_check(got: torch.Tensor, x: torch.Tensor, op: str, exclusive: bool,
                dtype: str):
    _check(got.cpu().numpy(),
           tscan.scan_reference(x.cpu(), op, exclusive).numpy(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("op,exclusive", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_cuda(dtype, op, exclusive, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel has no CPU mode")
    kern = tscan.build()
    tile = kern.tile
    # one tile, one tile plus one, an exact multiple, the rebin's lanes,
    # and many tiles (from 2^20 on the kernel takes tiles twice as large),
    # all on signed input
    for n in (1, 1000, tile, tile + 1, 3 * tile, 327_680, 2 ** 20 - 1,
              2 ** 20 + 2 * tile + 1, 2 ** 22 + 7, 16_777_223):
        x = _to_torch(_input(dtype, n, seed=n))
        before = tscan.LAUNCHES
        got = tscan.scan(x.cuda(), op, exclusive)
        torch.cuda.synchronize()
        assert tscan.LAUNCHES == before + 1
        _cuda_check(got, x, op, exclusive, dtype)
    # back to back with no sync, same and growing sizes: a stale status or
    # ticket of the call before would show
    xs = [_to_torch(_input(dtype, n, seed=100 + k)).cuda() for k, n in
          enumerate((100_000, 100_000, 300_000, 1_000_000, 40_000))]
    outs = [tscan.scan(x, op, exclusive) for x in xs]
    for x, got in zip(xs, outs):
        _cuda_check(got, x, op, exclusive, dtype)
    # views at 1, 2 and 3 elements: not 16-byte aligned
    base = _to_torch(_input(dtype, 327_680 + 8, seed=5)).cuda()
    for off in (1, 2, 3):
        x = base[off:off + 327_680 + 5]
        assert x.data_ptr() % 16 != 0
        _cuda_check(tscan.scan(x, op, exclusive), x, op, exclusive, dtype)
    # two streams at once, each with its own workspace
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    x1 = _to_torch(_input(dtype, 2 ** 20 + 3, seed=21)).cuda()
    x2 = _to_torch(_input(dtype, 2 ** 20 + 5, seed=22)).cuda()
    s1.wait_stream(torch.cuda.current_stream())
    s2.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        g1 = tscan.scan(x1, op, exclusive)
    with torch.cuda.stream(s2):
        g2 = tscan.scan(x2, op, exclusive)
    torch.cuda.synchronize()
    _cuda_check(g1, x1, op, exclusive, dtype)
    _cuda_check(g2, x2, op, exclusive, dtype)
    # across the epoch's wrap: a workspace that starts 2 below it, full of
    # stale statuses of epochs 0-2; two small calls, the second of which
    # wraps the epoch and must zero them, then three large ones that would
    # read any it left as predecessors
    monkeypatch.setattr(tscan, "WORKSPACE", _kernels.Workspace(
        epoch=_kernels.EPOCH_LIMIT - 2, stale=True))
    sizes = (3 * tile, 2 * tile + 1, 327_680, 327_680 - 999, 300_000)
    xs = [_to_torch(_input(dtype, n, seed=30 + k)).cuda()
          for k, n in enumerate(sizes)]
    stream = torch.cuda.current_stream().cuda_stream
    ws = tscan.WORKSPACE.get(xs[0].device, stream,
                             kern.status_words(max(sizes)))
    assert ws[_kernels.HEADER_WORDS:].any()
    for k, x in enumerate(xs):
        _cuda_check(tscan.scan(x, op, exclusive), x, op, exclusive, dtype)
        if k == 1:
            assert _kernels.Workspace.header(ws) == (0, 0, 0)
            assert not ws[_kernels.HEADER_WORDS:].any()
    assert tscan.WORKSPACE.get(xs[0].device, stream, 1) is ws
    assert _kernels.Workspace.header(ws) == (0, 0, 3)
    if dtype == "float32" and op != "add":
        # leading identities across a tile boundary: +-inf must survive
        lead = -np.inf if op == "max" else np.inf
        x = _to_torch(_input(dtype, 3 * tile, seed=1))
        x[:tile + 1000] = lead
        got = tscan.scan(x.cuda(), op).cpu()
        np.testing.assert_array_equal(got.numpy(),
                                      tscan.scan_reference(x, op).numpy())
        assert got[tile + 999] == lead
