"""The port's profiling and logging (zpc_tpu_torch.utils.profile,
zpc_tpu_torch.utils.logger) and the config module's default dtypes.

No JAX test covers these modules, so the checks are the port's own:
timers measure what ran, ``trace`` writes a Chrome trace of the block,
``memory_stats`` answers -1 and ``{}`` on the CPU as JAX's does for a
runtime without statistics, and the logger writes to its rotating file.
Tolerances: the timed sleeps (20 ms) read at least 20 ms.
"""

import json
import logging
import time

import pytest
import torch

from zpc_tpu_torch import utils
from zpc_tpu_torch.core import config
from zpc_tpu_torch.utils import logger as L
from zpc_tpu_torch.utils import profile as P

# the config names are held to zpc_tpu's where JAX is present
try:
    import jax.numpy as jnp
    from zpc_tpu.core import config as jax_config
except ImportError:
    pass


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config_dtypes_match_jax():
    for name in ("default_float", "default_int", "index_dtype"):
        assert name in config.__all__
        t = getattr(config, name)
        assert isinstance(t, torch.dtype)
        assert torch.empty((), dtype=t).numpy().dtype == \
            jnp.dtype(getattr(jax_config, name))
    assert config.default_float == torch.float32
    assert config.default_int == config.index_dtype == torch.int32


def test_utils_exports():
    assert utils.Timer is P.Timer and utils.bench is P.bench
    assert utils.trace is P.trace
    for name in ("get_logger", "log", "warn", "error",
                 "enable_file_logging"):
        assert getattr(utils, name) is getattr(L, name)


def test_timer_measures_the_block(capsys):
    t = P.Timer("sleep")
    with t:
        time.sleep(0.02)
    assert t.elapsed_ms >= 20.0
    assert "[timer] sleep:" in capsys.readouterr().out
    x = torch.ones(1000)
    ms = P.Timer("sum").tick().tock({"a": (x.sum(), [x])}, echo=False)
    assert ms >= 0.0


def test_bench_median_with_warmup():
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.02)
        return x * 2
    ms = P.bench(fn, torch.ones(4), warmup=2, iters=3)
    assert len(calls) == 5 and ms >= 20.0


def test_block_until_ready_walks_trees():
    """Only CUDA tensors are waited for: a CPU tree is returned as it is,
    and its CUDA devices (none here) are found through dicts, lists and
    dataclasses."""
    from zpc_tpu_torch.sim.mpm import make_mpm_state
    st = make_mpm_state(torch.rand(16, 3), dx=0.1,
                        device=torch.device("cpu"))
    assert P.block_until_ready(st) is st
    assert P._cuda_devices({"s": [st, (torch.ones(2),)]}, set()) == set()


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with P.trace(str(logdir)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    with open(logdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_memory_stats_on_the_cpu():
    s = P.memory_stats(torch.device("cpu"))
    assert s == {"bytes_in_use": -1, "peak_bytes_in_use": -1,
                 "bytes_limit": -1, "raw": {}}
    if not torch.cuda.is_available():
        assert P.memory_stats() == s


def test_logger_and_file_sink(tmp_path):
    lg = L.get_logger()
    assert lg.name == "zpc_tpu_torch" and lg is L.get_logger()
    assert len(lg.handlers) >= 1
    path = tmp_path / "run.log"
    h = L.enable_file_logging(str(path), max_bytes=1 << 16)
    try:
        L.log("step %d", 7)
        L.warn("low %s", "mass")
        L.error("overflow")
    finally:
        lg.removeHandler(h)
        h.close()
    text = path.read_text()
    assert "I] step 7" in text and "W] low mass" in text and \
        "E] overflow" in text
    assert isinstance(h, logging.handlers.RotatingFileHandler)


@pytest.mark.cuda
def test_cuda_timing_and_memory(tmp_path):
    """On the card: tock waits for queued work (a ~25 ms sleeping kernel is
    inside the time), bench syncs, memory_stats reads the allocator with
    the device's total memory as the limit, and the trace holds CUDA
    kernel events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    x = torch.ones(1 << 20, device=dev)
    t = P.Timer("sleep").tick()
    torch.cuda._sleep(50_000_000)
    assert t.tock(x + 1, echo=False) >= 5.0
    assert P.bench(lambda: x * 2, warmup=1, iters=3) > 0.0
    s = P.memory_stats(dev)
    assert s["bytes_in_use"] >= x.numel() * 4
    assert s["peak_bytes_in_use"] >= s["bytes_in_use"]
    assert s["bytes_limit"] == \
        torch.cuda.get_device_properties(dev).total_memory
    assert s["raw"]["allocated_bytes.all.current"] == s["bytes_in_use"]
    with P.trace(str(tmp_path)):
        x * 2
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
