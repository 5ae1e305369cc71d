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


# -- spans and host syncs in the stepping code ------------------------------

def _small_scene(contact: bool = False, model=None):
    """A 1,024-particle elastic block at dx = 1/32 in 64 bins (scenes'
    FixedCorotated, or ``model``), optionally over a two-triangle floor
    5 mm below it (with the CCD clamp)."""
    import dataclasses as dc
    from zpc_tpu_torch import scenes
    from zpc_tpu_torch.sim import contact_implicit as ci
    from zpc_tpu_torch.sim import mpm_binned2 as b2
    cpu = torch.device("cpu")
    sim, st, dt = scenes.mpm_block(1024, 1.0 / 32, cpu, block_capacity=256)
    if model is not None:
        sim = dc.replace(sim, model=model)
    cfg = b2.BinnedConfig2(bins_capacity=64, block_capacity=256)
    mc = None
    if contact:
        mc = ci.MeshContact.build(scenes.floor_mesh(0.57, 0.0, 1.0, cpu),
                                  0.01, 10.0, max_tris=2, use_ccd=True)
    return sim, b2.bin_state(sim, st, cfg), dt, cfg, mc


def _run_both_paths(scene, n_explicit: int = 2):
    """On ``_small_scene(contact=True)``: a short explicit chain that
    starts with a full rebin, a migration, and one implicit step over the
    floor; returns its CG iterations."""
    import dataclasses as dc
    from zpc_tpu_torch.sim import implicit_binned2 as ib2
    from zpc_tpu_torch.sim import mpm_binned2 as b2
    sim, bst, dt, cfg, mc = scene
    st = dc.replace(bst, needs_rebin=torch.ones((), dtype=torch.bool))
    st = b2.adaptive_chain(
        lambda s: b2.explicit_step_binned2(sim, s, dt, cfg, rebin=False),
        lambda s: b2.rebin_adaptive(sim, s, cfg), st, n_explicit)
    b2.rebin_adaptive(sim, st, dc.replace(cfg, migrate_capacity=256))
    _, iters = ib2.implicit_step_binned2(sim, bst, 1e-3, cfg, cg_iters=20,
                                         contact=mc, rebin=False,
                                         with_stats=True)
    return iters


# span -> the spans one of which holds it (None: anywhere)
_NESTED = {
    "zpc.ctx": None, "zpc.stress": None, "zpc.p2g": None,
    "zpc.grid_update": None, "zpc.advance": None,
    "zpc.g2p": "zpc.advance", "zpc.rebin.migrate": None,
    "zpc.rebin.full": None, "zpc.rebin.sort": "zpc.rebin.full",
    "zpc.rebin.groups": "zpc.rebin.full",
    "zpc.rebin.finish": "zpc.rebin.full",
    "zpc.implicit.rhs": None, "zpc.implicit.linearize": None,
    "zpc.cg": None, "zpc.cg.apply": "zpc.cg",
    "zpc.contact.broad": None, "zpc.contact.narrow": None,
    "zpc.contact.ccd": "zpc.advance",
    "zpc.sync.chain_flag": None, "zpc.sync.rebin_choice": None,
    "zpc.sync.cg_poll": "zpc.cg", "zpc.sync.ctx_offsets": "zpc.ctx",
    "zpc.sync.node_corners": ("zpc.grid_update", "zpc.implicit.rhs"),
    "zpc.sync.bin_offsets": "zpc.rebin.finish",
    "zpc.sync.slot_dirs": "zpc.rebin.finish",
}


def _zpc_ancestors(path):
    """Each ``zpc.*`` range of a Chrome trace with the names of the
    ``zpc.*`` ranges that hold it on its thread."""
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("zpc.")]
    out = []
    for e in ev:
        s, t = e["ts"], e["ts"] + e["dur"]
        out.append((e["name"], {
            o["name"] for o in ev if o is not e and o["tid"] == e["tid"]
            and o["ts"] <= s and t <= o["ts"] + o["dur"]}))
    return out


def _spans_in_place(tmp_path, scene, nested):
    """Runs ``_run_both_paths(scene)`` under the profiler and checks that
    the trace holds each span of ``nested`` and no other, each inside one
    of its holders, the transfers inside the right-hand side and no stage
    inside another; returns the spans with their holders."""
    with P.trace(str(tmp_path)):
        _run_both_paths(scene)
    spans = _zpc_ancestors(tmp_path / "trace.json")
    assert {n for n, _ in spans} == set(nested)
    for name, holders in spans:
        want = nested[name]
        if want is not None:
            assert holders & set((want,) if isinstance(want, str) else
                                 want), (name, holders)
    assert "zpc.p2g" in {n for n, h in spans if "zpc.implicit.rhs" in h}
    stages = {"zpc.ctx", "zpc.stress", "zpc.cg", "zpc.advance",
              "zpc.rebin.full", "zpc.rebin.migrate", "zpc.implicit.rhs"}
    assert not any(h & stages for n, h in spans if n in stages)
    return spans


def test_spans_nest_in_the_trace(tmp_path):
    """Every span of the explicit chain, the rebins, the implicit step and
    the contact is in the Chrome trace, and each sits where it belongs:
    G2P and the CCD inside the advance, the rebin's phases inside the
    full rebin, the operator applications and the polls inside the CG
    loop, the transfers inside the right-hand side and none inside the
    applications (a FixedCorotated operator is one fused application),
    the table copies inside their stages."""
    spans = _spans_in_place(tmp_path, _small_scene(contact=True), _NESTED)
    assert "zpc.cg.apply" in {n for n, _ in spans}
    assert not {n for n, h in spans if "zpc.cg.apply" in h}


def test_spans_nest_on_the_jvp_route(tmp_path):
    """A NeoHookean block's operator takes G2P, the jvp and P2G: its
    applications hold the G2P and P2G spans, G2P sits in an application
    or in the advance, and every other span where it sits for the fused
    operator."""
    from zpc_tpu_torch.models.constitutive import NeoHookean
    model = NeoHookean.from_young_poisson(5e4, 0.3,
                                          device=torch.device("cpu"))
    nested = {**_NESTED, "zpc.g2p": ("zpc.advance", "zpc.cg.apply")}
    spans = _spans_in_place(tmp_path, _small_scene(True, model), nested)
    in_cg = {n for n, h in spans if "zpc.cg.apply" in h}
    assert {"zpc.g2p", "zpc.p2g"} <= in_cg


def test_no_span_without_a_profiler(monkeypatch):
    """With no profiler running the stepping code enters no profiler
    range at all; with the profiler's flag up the same code would."""
    import torch.autograd.profiler as ap
    entered = []

    class Counting:
        def __init__(self, *a, **k):
            entered.append(a)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(ap, "record_function", Counting)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    assert not ap._is_profiler_enabled
    _run_both_paths(_small_scene(contact=True), n_explicit=1)
    assert entered == []
    monkeypatch.setattr(ap, "_is_profiler_enabled", True)
    with P.span("ctx"):
        pass
    assert entered == [("zpc.ctx",)]


def test_host_syncs_count_the_chain_flag_and_the_cg_polls():
    """An n-step chain with no rebin reads its flag n + 1 times and copies
    the stencil's and the nodes' tables once a step; a CG solve that
    converges before max_iters reads iters + 2 scalars (the threshold,
    then one poll per iteration and the last)."""
    from zpc_tpu_torch.math import solvers
    from zpc_tpu_torch.sim import mpm_binned2 as b2
    sim, bst, dt, cfg, _ = _small_scene()
    sites = ("chain_flag", "ctx_offsets", "node_corners", "rebin_choice")
    before = {k: P.HOST_SYNCS[k] for k in sites}
    out = b2.adaptive_chain(
        lambda s: b2.explicit_step_binned2(sim, s, dt, cfg, rebin=False),
        lambda s: pytest.fail("no rebin expected"), bst, 3)
    assert not bool(out.needs_rebin)
    assert {k: P.HOST_SYNCS[k] - before[k] for k in sites} == {
        "chain_flag": 3 + 1, "ctx_offsets": 3, "node_corners": 3,
        "rebin_choice": 0}

    diag = torch.linspace(1.0, 4.0, 64)
    b = torch.ones(64)
    before = P.HOST_SYNCS["cg_poll"]
    res = solvers.cg(lambda v: diag * v, b, max_iters=200, rel_tol=1e-6)
    assert bool(res.converged) and 0 < res.iters < 200
    assert P.HOST_SYNCS["cg_poll"] - before == res.iters + 2
    before = P.HOST_SYNCS["test_site"]
    assert P.read_host(torch.tensor(2.5), "test_site") == 2.5
    assert P.HOST_SYNCS["test_site"] - before == 1


def test_executor_scope_emits_its_span(capsys):
    from zpc_tpu_torch.core.executor import Executor
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with Executor(device=torch.device("cpu")).scope("region"):
            torch.ones(8) + 1
        with Executor(device=torch.device("cpu")).profile(True).scope(
                "timed"):
            torch.ones(8) + 1
    names = [e.name for e in prof.events()]
    assert "zpc.region" in names and "zpc.timed" in names
    assert "timed" in capsys.readouterr().out
