"""The comparison that decides ``correct``, driven through a whole run of
each cell at a size the CPU holds (the harness's look for a card
skipped): a sound run comes out correct; with the timed path broken
underneath, or with the control (the reference in bfloat16) in the
program's place, it comes out not correct under the cell's own limits.

The faults a cell of this benchmark can have: a step that returns its
state unchanged, half of the particles left out of the step, and an
answer (one particle's position) altered where it is produced; in the
implicit cells also a force differential that returns 0 and a CG solve
that returns its start vector (``readings.FAULTS``, which reads them,
and a barrier that pushes nothing, at the cells' own size on the
card).  No cell runs on more than
one card, so none has an exchange between cards to leave out.  A run
that has loaded JAX by its end prints no result.
"""

import dataclasses
import json
import sys
import time
import types

import pytest
import torch

from conftest import cell_names, tiny
from portbench import readings, run as run_mod
from portbench.harness import cell as cell_mod, check, inputs
from portbench.harness.cell import run_cell
from portbench.harness.spec import BENCH, load_module
from zpc_tpu_torch.sim import implicit_binned2 as ib2
from zpc_tpu_torch.sim import mpm_binned2 as b2

SEED = 2 ** 31 + 977


def _run(cell, dev, seed=SEED, trace=False):
    return run_cell(cell, seed, 0.0, trace, dev, time.perf_counter(),
                    str(dev))


@pytest.mark.parametrize("name", cell_names())
def test_a_sound_run_is_correct(name, cpu):
    res = _run(tiny(name), cpu)
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["correct"], res["check"]
    assert set(res["check"]) == set(tiny(name).limits["compare"]) | {
        "nonfinite"}


def _unchanged(step):
    def broken(*a, **kw):
        out = step(*a, **kw)
        st = a[1]
        same = dataclasses.replace(st, needs_rebin=torch.zeros_like(
            st.needs_rebin))
        return (same, out[1]) if isinstance(out, tuple) else same
    return broken


def _half_left_out(step):
    def broken(*a, **kw):
        out = step(*a, **kw)
        res = out[0] if isinstance(out, tuple) else out
        L = res.cols.shape[0]
        cols = res.cols.clone()
        cols[L // 2:] = a[1].cols[L // 2:]
        res = dataclasses.replace(res, cols=cols)
        return (res, out[1]) if isinstance(out, tuple) else res
    return broken


def _answer_altered(step):
    def broken(*a, **kw):
        out = step(*a, **kw)
        res = out[0] if isinstance(out, tuple) else out
        live = torch.nonzero(res.pid >= 0)[0, 0]
        cols = res.cols.clone()
        cols[live, 0] += 0.5 * float(res.grid.dx)
        res = dataclasses.replace(res, cols=cols)
        return (res, out[1]) if isinstance(out, tuple) else res
    return broken


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", cell_names())
def test_a_broken_step_is_not_correct(name, fault, cpu, monkeypatch):
    cell = tiny(name, segment_steps=4)
    if cell.config["integrator"]["kind"] == "explicit":
        monkeypatch.setattr(b2, "explicit_step_binned2",
                            FAULTS[fault](b2.explicit_step_binned2))
    else:
        monkeypatch.setattr(ib2, "implicit_step_binned2",
                            FAULTS[fault](ib2.implicit_step_binned2))
    res = _run(cell, cpu)
    assert not res["correct"], res["check"]


# contact_off is read at the cells' own size only: at this size the
# particles lie 1/64 apart and none comes near enough the terrain for the
# barrier to move it measurably
SOLVE_FAULTS = [(n, f) for n in cell_names() for f in sorted(readings.FAULTS)
                if readings.fault_applies(tiny(n), f) and f != "contact_off"]


@pytest.mark.parametrize("name,fault", SOLVE_FAULTS)
def test_a_broken_solve_is_not_correct(name, fault, cpu, monkeypatch):
    owner, attr, wrap, _ = readings.FAULTS[fault]
    monkeypatch.setattr(owner, attr, wrap(getattr(owner, attr)))
    res = _run(tiny(name), cpu)
    assert not res["correct"], res["check"]


FREE = "implicit_block_1m.free"


def test_a_run_prints_its_result_line_last(cpu, capsys):
    rc = run_mod.report(tiny(FREE), SEED, 0.0, False, cpu, "cpu",
                        time.perf_counter())
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert err.strip().splitlines()[-1].startswith("check ")


def test_a_run_that_loaded_jax_prints_no_result(cpu, capsys, monkeypatch):
    """A reference that loads ``jax`` (a stand-in module) voids the run,
    though it loads it after the window has closed."""
    load = cell_mod.load_module

    def loader(path):
        real = load(path)

        def run(*a, **kw):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return real.run(*a, **kw)
        return types.SimpleNamespace(run=run)
    monkeypatch.setattr(cell_mod, "load_module", loader)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    rc = run_mod.report(tiny(FREE), SEED, 0.0, False, cpu, "cpu",
                        time.perf_counter())
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == ""
    assert "jax" in err.strip().splitlines()[-1]


@pytest.mark.parametrize("name", cell_names())
def test_the_control_is_not_correct(name, cpu):
    """The reference in bfloat16 in the program's place fails the cell's
    limits; the reference in float32 (the configuration's precision)
    passes them."""
    cell = tiny(name)
    cfg, tr = cell.config, cell.traffic
    ref = load_module(BENCH / "reference" / f"{cfg['reference']}.py")
    inp = inputs.make(cfg, tr, SEED, cpu)
    steps = tr["snapshot_steps"] + tr["segment_steps"]

    def run(dtype):
        return ref.run(cfg, inp.x0, inp.v0, inp.tri, inp.dt, steps, dtype)
    exact = run(torch.float64)
    low = run(torch.bfloat16)
    ok, compared = check.judge(check.gaps(low, exact, cfg["dx"]),
                               cell.limits)
    assert not ok, compared
    f32 = run(torch.float32)
    ok, compared = check.judge(check.gaps(f32, exact, cfg["dx"]),
                               cell.limits)
    assert ok, compared


@pytest.mark.cuda
@pytest.mark.parametrize("name", cell_names())
def test_a_short_run_on_the_card_is_correct(name, card):
    res = _run(tiny(name), card)
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
