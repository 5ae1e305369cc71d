"""The benchmark's files found by name, its count functions and trace
reduction against hand sums, the program's spans and counters as the
readers get them, the module sets of a run and of the references, and
the set-up's snapshot left as it was by a segment."""

import collections
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import ROOT, cell_names, tiny
from portbench.harness import inputs, trace
from portbench.harness.cell import _Slice, prepare, run_cell
from portbench.harness.program import Counters
from portbench.harness.spec import BENCH, load_cell, load_module
from zpc_tpu_torch.utils import profile as zprof


@pytest.mark.parametrize("name", cell_names())
def test_cell_files_load_by_name(name):
    cell = load_cell(name)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    w = {c["name"]: c for c in spec["workloads"]}[name]
    assert cell.config["name"] == w["config"]
    assert {"segment_steps", "snapshot_steps", "warmup_steps",
            "warm_rebin", "contact", "trace_from_step",
            "trace_steps"} <= set(cell.traffic)
    assert cell.limits["compare"]
    for m in cell.per_layer:
        assert callable(cell.readers[m["name"]].read)
    ref = load_module(BENCH / "reference" /
                      f"{cell.config['reference']}.py")
    assert callable(ref.run)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}


def test_every_metric_and_config_has_its_file():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for m in spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_roofline_counts_by_hand():
    mod = load_module(BENCH / "metrics" / "explicit_step_roofline.py")
    shapes = {"particles": 10, "touched_blocks": 2}
    assert mod.step_bytes(shapes) == 10 * 26 * 4 * 2 + 2 * 64 * (4 + 3) * 4
    stress = 4 * (27 + 5 + 1 + 18 + 18) + 36 + 45
    per_p = stress + 36 + 54 + 27 + 27 * 22 + 27 * 24 + 54 + 6
    assert mod.step_flops(shapes) == 10 * per_p + 2 * 64 * 12
    peaks = {"hbm_bytes_per_s": 1000.0, "fp32_flop_per_s": 1e9}
    assert mod.least_seconds(shapes, peaks) == mod.step_bytes(shapes) / 1e3


def _slice(**kw):
    base = dict(window_s=2.0, busy_s=1.5, span_device_s={"step": 0.4,
                                                         "rebin": 0.02},
                steps=100, rebins=4, cg_iters=[], window_steps=600,
                window_rebins=30,
                shapes={"particles": 10, "touched_blocks": 2}, peaks=None,
                program_spans={"zpc.p2g": (100, 0.439),
                               "zpc.stress": (100, 0.118)},
                counters={"HOST_SYNCS.chain_flag": 100,
                          "HOST_SYNCS.ctx_offsets": 100,
                          "HOST_SYNCS.node_corners": 100, "OTHER.x": 7})
    base.update(kw)
    return trace.Slice(**base)


def _reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py").read


def test_readers_by_hand():
    t = _slice()
    assert _reader("device_idle_share")(t) == pytest.approx(25.0)
    assert _reader("explicit_step_device_ms")(t) == pytest.approx(4.0)
    assert _reader("rebin_device_ms")(t) == pytest.approx(5.0)
    assert _reader("rebins_per_kstep")(t) == pytest.approx(50.0)
    assert _reader("implicit_step_device_ms")(t) is None
    assert _reader("cg_iters_per_step")(t) is None
    assert _reader("explicit_step_roofline")(t) is None       # no peaks
    peaks = {"hbm_bytes_per_s": 1e6, "fp32_flop_per_s": 1e12}
    share = _reader("explicit_step_roofline")(_slice(peaks=peaks))
    assert share == pytest.approx(100 * (2080 + 3584) / 1e6 / 4e-3)
    imp = _slice(cg_iters=[3, 4, 5])
    assert _reader("cg_iters_per_step")(imp) == pytest.approx(4.0)
    assert _reader("implicit_step_device_ms")(imp) == pytest.approx(4.0)
    assert _reader("explicit_step_device_ms")(imp) is None
    # nothing to read: nothing reported, never a 0 share
    empty = _slice(busy_s=0.0, span_device_s={}, rebins=0)
    assert _reader("device_idle_share")(empty) is None
    assert _reader("rebin_device_ms")(empty) is None
    assert _reader("explicit_step_roofline")(
        _slice(peaks=peaks, span_device_s={})) is None
    # the program's spans and counters
    assert _reader("host_syncs_per_step")(t) == pytest.approx(3.0)
    assert _reader("p2g_device_ms")(t) == pytest.approx(4.39)
    assert _reader("cg_apply_device_ms")(t) is None
    assert _reader("contact_device_ms")(t) is None
    ranges = [(0, 10, "zpc.contact.broad", 0.014),
              (20, 90, "zpc.contact.narrow", 4.5),
              (30, 40, "zpc.contact.narrow.pairs", 1.0),   # inside: once
              (40, 80, "zpc.cg.apply", 9.0)]
    con = _slice(cg_iters=[4, 4], steps=2,
                 counters={"HOST_SYNCS.cg_poll": 10,
                           "HOST_SYNCS.chain_flag": 2},
                 program_spans={"zpc.p2g": (14, 1.0),
                                "zpc.cg.apply": (10, 0.325)},
                 program_ranges=ranges)
    assert _reader("host_syncs_per_step")(con) == pytest.approx(6.0)
    assert _reader("p2g_device_ms")(con) is None     # not the explicit step
    assert _reader("cg_apply_device_ms")(con) == pytest.approx(32.5)
    assert _reader("contact_device_ms")(con) == pytest.approx(
        1e3 * (0.014 + 4.5) / 2)
    # nothing to read: nothing reported, never a 0
    bare = _slice(program_spans={}, counters={"OTHER.x": 3})
    for name in ("host_syncs_per_step", "p2g_device_ms",
                 "cg_apply_device_ms", "contact_device_ms"):
        assert _reader(name)(bare) is None
    assert _reader("host_syncs_per_step")(_slice(steps=0)) is None
    assert _reader("p2g_device_ms")(
        _slice(program_spans={"zpc.p2g": (100, 0.0)})) is None


def _ev(name, s, e, dev, device_time=0.0):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=s, end=e),
        device_type=DeviceType.CPU if dev == "cpu" else DeviceType.CUDA,
        device_time_total=device_time)


def test_trace_reduction_by_hand():
    ev = [_ev("portbench.step", 0, 100, "cpu", 60.0),
          _ev("portbench.step", 120, 220, "cpu", 50.0),
          _ev("portbench.step", 130, 140, "cuda"),     # its device copy
          _ev("k1", 10, 40, "cuda"), _ev("k2", 30, 70, "cuda"),
          _ev("k1", 130, 180, "cuda"), _ev("memcpy", 200, 210, "cuda")]
    busy, span_dev, ops, gaps = trace.reduce_profile(ev)
    assert busy == pytest.approx((60 + 50 + 10) * 1e-6)
    assert span_dev == {"step": pytest.approx(110e-6)}
    assert ops[0] == ("k1", pytest.approx(80e-6))
    # gaps: 70-130 (middle 100: in the first step span's end -> step),
    # 180-200 (in the second step span)
    assert dict(gaps) == {"step": pytest.approx(80e-6)}
    ev.append(_ev("k3", 300, 310, "cuda"))          # 210-300: no span
    _, _, _, gaps = trace.reduce_profile(ev)
    assert dict(gaps)["chain"] == pytest.approx(90e-6)

    # the program's ranges, nested, and one device-side copy of a range
    prog = [_ev("zpc.advance", 60, 105, "cpu", 10.0),
            _ev("zpc.g2p", 90, 102, "cpu", 5.0),        # inside advance
            _ev("zpc.p2g", 125, 200, "cpu", 50.0),
            _ev("zpc.p2g", 125, 215, "cuda"),           # its device copy
            _ev("zpc.sync.chain_flag", 250, 260, "cpu"),
            _ev("zpc.rebin.full", 400, 500, "cpu", 7.0),
            _ev("zpc.rebin.sort", 400, 450, "cpu", 3.0)]   # same start
    red = trace.reduce_events(ev + prog)
    busy, span_dev, ops, _ = trace.reduce_profile(ev)
    assert red.busy_s == busy and red.span_device_s == span_dev
    assert red.ops == ops
    assert red.program_spans == {
        "zpc.advance": (1, pytest.approx(10e-6)),
        "zpc.g2p": (1, pytest.approx(5e-6)),
        "zpc.p2g": (1, pytest.approx(50e-6)),
        "zpc.sync.chain_flag": (1, 0.0),
        "zpc.rebin.full": (1, pytest.approx(7e-6)),
        "zpc.rebin.sort": (1, pytest.approx(3e-6))}
    # 70-130 (middle 100: advance and g2p open, g2p innermost), 180-200
    # (middle 190: p2g), 210-300 (middle 255: chain, the flag read)
    assert dict(red.gaps) == {"step/zpc.g2p": pytest.approx(60e-6),
                              "step/zpc.p2g": pytest.approx(20e-6),
                              "chain/zpc.sync.chain_flag":
                              pytest.approx(90e-6)}
    assert [r[2] for r in red.program_ranges][-2:] == ["zpc.rebin.full",
                                                       "zpc.rebin.sort"]
    view = _slice(program_ranges=red.program_ranges)
    assert view.device_s_under("zpc.rebin.") == pytest.approx(7e-6)
    assert view.device_s_under("zpc.g2p") == pytest.approx(5e-6)
    assert view.device_s_under("zpc.contact.") is None


def test_the_slice_takes_the_program_counters_over_it_alone(cpu,
                                                           monkeypatch):
    syncs = collections.Counter(setup=5)
    monkeypatch.setattr(zprof, "HOST_SYNCS", syncs)
    sl = _Slice(cpu, 1, 2, Counters)
    for i in range(5):
        sl.hook()                      # the slice is steps 1 and 2
        syncs["flag"] += 1
        if i == 2:
            syncs["table"] += 3
    sl.stop()
    syncs["flag"] += 10
    assert sl.program_counters == {"HOST_SYNCS.setup": 0,
                                   "HOST_SYNCS.flag": 2,
                                   "HOST_SYNCS.table": 3}
    monkeypatch.delattr(zprof, "HOST_SYNCS")
    sl = _Slice(cpu, 0, 1, Counters)
    sl.hook()
    sl.stop()
    assert sl.program_counters == {}


STAND_IN = """
def read(t):
    count, device_s = t.program_spans["zpc.p2g"]
    return (count, device_s, t.counters["HOST_SYNCS.chain_flag"],
            t.config["particles"], t.steps)
"""


def test_a_new_reader_file_reads_spans_counters_and_sizes(cpu, tmp_path):
    """A reader file that no harness file names gets the program's span
    counts and device times, its counters and the configuration."""
    path = tmp_path / "stand_in.py"
    path.write_text(STAND_IN)
    spec = importlib.util.spec_from_file_location("stand_in", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cell = tiny("elastic_block_256k.freefall", segment_steps=6)
    metric = {"name": "stand_in", "unit": "x", "better": "lower",
              "source": "program_span", "layer": "explicit step",
              "moves": "mpart_steps_per_s"}
    cell = dataclasses.replace(cell, per_layer=[metric],
                               readers={"stand_in": mod})
    res = run_cell(cell, 2 ** 31 + 5, 0.0, True, cpu, time.perf_counter(),
                   "cpu")
    count, device_s, flags, particles, steps = \
        res["metrics"]["stand_in"]["value"]
    # steps 0-5 of the second segment: a p2g range and a flag read each
    assert steps == 6 and count == 6 and flags == 6
    assert device_s == 0.0                   # no device on the CPU
    assert particles == 4096
    assert res["correct"], res["check"]


_SCRIPT = """
import sys
sys.path.insert(0, {root!r})
import importlib.util, pathlib
spec = importlib.util.spec_from_file_location("portbench_run_main",
                                              {run!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
{body}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_names(body):
    code = _SCRIPT.format(root=ROOT, run=os.path.join(ROOT, "portbench",
                                                      "run.py"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         env={**os.environ, "PYTHONPATH": ""})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    body = ("from portbench.harness import cell, spec\n"
            "for n in " + repr(cell_names()) + ":\n"
            "    spec.load_cell(n)\n")
    names = _top_names(body)
    assert "zpc_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "zpc_tpu"}


def test_the_references_import_nothing_of_the_program():
    body = ("import pathlib\n"
            "from portbench.harness.spec import BENCH, load_module\n"
            "for p in sorted((BENCH / 'reference').glob('*.py')):\n"
            "    load_module(p)\n")
    names = _top_names(body)
    assert not names & {"jax", "jaxlib", "flax", "zpc_tpu", "zpc_tpu_torch"}


@pytest.mark.parametrize("name", cell_names())
def test_a_segment_leaves_its_snapshot_unchanged(name, cpu):
    cell = tiny(name, segment_steps=3)
    tr = cell.traffic
    prog, start, _ = prepare(cell, 2 ** 31 + 17, cpu)
    cols, pid = start.cols.clone(), start.pid.clone()
    a, bad_a = prog.segment(start, tr["segment_steps"])
    b, bad_b = prog.segment(start, tr["segment_steps"])
    assert torch.equal(start.cols, cols) and torch.equal(start.pid, pid)
    assert not bad_a and not bad_b
    for u, v in zip(prog.particles(a), prog.particles(b)):
        assert torch.equal(u, v)
    assert not torch.equal(prog.particles(a)[0], prog.particles(start)[0])


@pytest.mark.parametrize("name", cell_names())
def test_inputs_follow_the_seed(name, cpu):
    cell = tiny(name)
    cfg, tr = cell.config, cell.traffic
    big = 2 ** 31 + 12345
    a = inputs.make(cfg, tr, big, cpu)
    b = inputs.make(cfg, tr, big, cpu)
    assert torch.equal(a.x0, b.x0)
    assert not torch.equal(a.x0, inputs.particles(cfg, big + 1, cpu))
    lo = torch.tensor(cfg["block"]["center"]) - 0.5 * cfg["block"]["side"]
    assert bool((a.x0 >= lo).all() and
                (a.x0 <= lo + cfg["block"]["side"]).all())
    assert (a.v0 is None) == ("velocity" not in tr)
    if a.v0 is not None:
        assert torch.equal(a.v0, b.v0) and a.v0.abs().max() > 0
    assert (a.tri is None) == (not tr["contact"])


def test_the_terrain_by_hand(cpu):
    cfg = {"obstacle": {"mesh": "heightfield", "res": 2, "y0": 0.5,
                        "amp": 0.1, "lo": 0.0, "hi": 1.0}}
    tri = inputs.obstacle(cfg, cpu)
    assert tri.shape == (8, 3, 3) and tri.dtype == torch.float32

    def h(x, z):
        return 0.5 + 0.1 * math.sin(6.2832 * x) * math.cos(6.2832 * z)
    # cell (0, 0): a = (0, 0), b = (0.5, 0), c = (0.5, 0.5), d = (0, 0.5)
    want = [[0.0, h(0, 0), 0.0], [0.5, h(0.5, 0), 0.0],
            [0.5, h(0.5, 0.5), 0.5]]
    assert torch.allclose(tri[0].double(), torch.tensor(want,
                          dtype=torch.float64), atol=1e-7)
    assert torch.equal(tri[4, 0], tri[0, 0]) and \
        torch.equal(tri[4, 1], tri[0, 2])
    assert abs(float(tri[4, 2, 0])) == 0.0 and float(tri[4, 2, 2]) == 0.5


def test_the_velocity_field_by_hand(cpu):
    tr = {"velocity": {"about": [1.0, 2.0, 3.0],
                       "gradient": [[0, 4, -2], [0, 0, 0], [2, 0, 0]]}}
    x = torch.tensor([[1.5, 2.25, 2.0]])
    v = inputs.velocities(tr, x)
    assert torch.allclose(v, torch.tensor([[4 * 0.25 + 2.0, 0.0, 1.0]]))
    assert inputs.velocities({}, x) is None
