"""One run of one cell: set-up, the measured window (or its traced slice),
then the comparison with the plain reference.

The window replays fixed segments: every segment starts from the same
state that the set-up made (the binned initial state, or the traffic's
snapshot), runs ``segment_steps`` steps through ``adaptive_chain`` and
ends in one synchronisation that reads whether it failed.  Segments run
back to back until ``seconds`` have passed; the rate counts every
particle-step of every segment over the time from the window's start to
the end of its last segment.  With ``trace``, steps ``trace_from_step``
to ``trace_from_step + trace_steps`` of the window's second segment run
under ``torch.profiler`` and give the per-layer metrics instead.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable

import torch

from . import check, inputs
from .peaks import peaks_for
from .program import Counters, Program, program_counters
from .spec import BENCH, Cell, load_module
from .trace import Slice, reduce_events

__all__ = ["prepare", "run_cell", "touched_blocks"]


def touched_blocks(x: torch.Tensor, dx: float) -> int:
    """Grid blocks of 4^3 cells that the particles' quadratic stencils
    touch (the world frame's tiling)."""
    base = torch.floor(x / dx - 0.5).long()
    keys = []
    for o in range(8):
        off = torch.tensor([(o >> 2) & 1, (o >> 1) & 1, o & 1],
                           device=x.device) * 2
        b = torch.div(base + off, 4, rounding_mode="floor") + 1024
        keys.append((b[:, 0] * 4096 + b[:, 1]) * 4096 + b[:, 2])
    return int(torch.unique(torch.cat(keys)).numel())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mem(dev, what):
    if dev.type != "cuda":
        return 0
    return getattr(torch.cuda, what)(dev)


def _device_allocs(dev) -> int:
    """The caching allocator's count of device allocations so far."""
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(dev).get("num_device_alloc", 0))


class _Slice:
    """Starts ``torch.profiler`` before step ``first`` of the traced
    segment and stops it before step ``first + n`` (or at the segment's
    end), each time after a synchronisation.  The benchmark's counters
    are copied at both ends, and so are the program's
    (:func:`~.program.program_counters`), whose delta over the slice is
    ``program_counters``."""

    def __init__(self, dev, first: int, n: int, counters):
        self.dev, self.first, self.n = dev, first, n
        self.counters = counters
        self.i = 0
        self.prof = None
        self.done = None            # (seconds, counters before, after)
        self.program_counters = None    # "<COUNTER>.<site>" -> delta

    def _copy(self):
        c = self.counters()
        return dataclasses.replace(c, cg_iters=list(c.cg_iters))

    def hook(self):
        if self.i == self.first:
            _sync(self.dev)
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.c0 = self._copy()
            self.p0 = program_counters()
            self.t = time.perf_counter()
        elif self.i == self.first + self.n:
            self.stop()
        self.i += 1

    def stop(self):
        if self.prof is None or self.done is not None:
            return
        _sync(self.dev)
        secs = time.perf_counter() - self.t
        p1 = program_counters()
        self.prof.__exit__(None, None, None)
        self.done = (secs, self.c0, self._copy())
        self.program_counters = {k: v - self.p0.get(k, 0)
                                 for k, v in p1.items()}


def prepare(cell: Cell, seed: int, dev: torch.device,
            mark: Callable[[str], None] = lambda what: None):
    """The set-up: the inputs from the seed, the program's scene in bin
    order, the traffic's snapshot and warm-up.  Returns (program, the
    state every segment starts from, the inputs)."""
    cfg, traffic = cell.config, cell.traffic
    inp = inputs.make(cfg, traffic, seed, dev)
    mark("inputs")
    prog = Program(cfg, inp)
    mark("scene and bin_state")
    start = prog.start
    if traffic["snapshot_steps"]:
        start = prog.chain(start, traffic["snapshot_steps"])
        mark("snapshot")
    if traffic["warmup_steps"]:
        prog.chain(start, traffic["warmup_steps"])
    if traffic["warm_rebin"]:
        prog.rebin(start)
    mark("warm-up")
    prog.counters = Counters()
    return prog, start, inp


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             dev: torch.device, t0: float, card: str,
             log: Callable[[str], None] = lambda s: None) -> dict:
    """Run ``cell`` once; returns the result line's object."""
    cfg, traffic = cell.config, cell.traffic
    n_seg = traffic["segment_steps"]
    marks = [("imports", time.perf_counter() - t0)]

    def mark(what):
        _sync(dev)
        marks.append((what, time.perf_counter() - t0))

    prog, start, inp = prepare(cell, seed, dev, mark)
    shapes = dict(particles=int(inp.x0.shape[0]),
                  lanes=int(start.cols.shape[0]),
                  touched_blocks=touched_blocks(prog.particles(start)[0],
                                                cfg["dx"]),
                  segment_steps=n_seg)
    setup_peak = _mem(dev, "max_memory_allocated")
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.4f} s (" + ", ".join(
        f"{k} {v:.3f}" for k, v in marks) + f"): {shapes}")

    # -- the window ---------------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tracker = check.Tracker()
    attempted = failed = 0
    sl = None
    allocs0 = _device_allocs(dev)
    gc0 = [g["collections"] for g in gc.get_stats()]
    seg_log = []                    # (seconds, rebins) of each segment
    t_w = t_seg = time.perf_counter()
    while True:
        r_seg = prog.counters.rebins
        if trace and attempted == 1:
            sl = _Slice(dev, min(traffic["trace_from_step"], n_seg - 1),
                        traffic["trace_steps"], lambda: prog.counters)
            prog.step_hook = sl.hook
        out, bad = prog.segment(start, n_seg)
        if sl is not None:
            sl.stop()
            prog.step_hook = None
        t = time.perf_counter()
        seg_log.append((t - t_seg, prog.counters.rebins - r_seg))
        t_seg = t
        tracker.add(prog.particles(out))
        del out
        attempted += 1
        failed += int(bad)
        if time.perf_counter() - t_w >= seconds and \
                (not trace or sl is not None):
            break
    _sync(dev)
    window_s = time.perf_counter() - t_w
    window_peak = _mem(dev, "max_memory_allocated")
    counters = prog.counters
    memory_peak = max(setup_peak, window_peak)

    result = {"attempted": attempted, "failed": failed}
    n = shapes["particles"]
    if trace:
        slice_s, c0, c1 = sl.done
        red = reduce_events(sl.prof.events())
        busy, ops, gaps = red.busy_s, red.ops, red.gaps
        view = Slice(window_s=slice_s, busy_s=busy,
                     span_device_s=red.span_device_s,
                     steps=c1.steps - c0.steps, rebins=c1.rebins - c0.rebins,
                     cg_iters=c1.cg_iters[len(c0.cg_iters):],
                     window_steps=counters.steps,
                     window_rebins=counters.rebins, shapes=shapes,
                     peaks=peaks_for(card), program_spans=red.program_spans,
                     program_ranges=red.program_ranges,
                     counters=sl.program_counters, config=cfg)
        sl = red = None
        metrics = {}
        for m in cell.per_layer:
            val = cell.readers[m["name"]].read(view)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        result["metrics"] = metrics
        result["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                               "idle_gaps": [[k, v] for k, v in gaps]}
        dev_extra = {"busy_s": busy, "window_s": slice_s}
        log(f"traced slice: {view.steps} steps, {view.rebins} rebins, "
            f"{slice_s:.4f} s, busy {busy:.4f} s")
        for k, (cnt, dev_s) in sorted(view.program_spans.items(),
                                      key=lambda kv: -kv[1][1]):
            log(f"  span {k}: {cnt} ranges, {1e3 * dev_s:.4f} ms device")
        log("  program counters " + ", ".join(
            f"{k} {v}" for k, v in sorted(view.counters.items())))
    else:
        steps_done = attempted * n_seg
        metrics = {
            "mpart_steps_per_s": n * steps_done / window_s / 1e6,
            "peak_mem_gib": window_peak / 2 ** 30,
            "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in metrics.items() if k in units}
        dev_extra = {}
    log(f"window {window_s:.4f} s, {attempted} segments of {n_seg} steps, "
        f"{failed} failed, {counters.rebins} rebins in "
        f"{counters.steps} steps, CG iterations {counters.cg_iters[:40]}")
    log(f"segments (s, rebins): {[(round(a, 4), b) for a, b in seg_log]}; "
        f"{_device_allocs(dev) - allocs0} device allocations, garbage "
        f"collections by generation "
        f"{[g['collections'] - c for g, c in zip(gc.get_stats(), gc0)]}")

    # -- the comparison, after the window and the memory reading ----------
    prog_xvF, delta = tracker.first, tracker.delta
    del prog, start, tracker
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_mod = load_module(BENCH / "reference" / f"{cfg['reference']}.py")
    t_r = time.perf_counter()
    ref = ref_mod.run(cfg, inp.x0, inp.v0, inp.tri, inp.dt,
                      traffic["snapshot_steps"] + n_seg, torch.float64)
    log(f"reference {time.perf_counter() - t_r:.4f} s")
    values = check.gaps(prog_xvF, ref, cfg["dx"], delta)
    ok, compared = check.judge(values, cell.limits)
    log("gaps " + ", ".join(f"{k} {v!r}" for k, v in values.items()))
    result["correct"] = bool(ok and failed == 0)
    result["device"] = dict(platform="gpu" if dev.type == "cuda" else
                            dev.type, kind=card, count=cell.chips,
                            memory_peak_bytes=int(memory_peak), **dev_extra)
    result["check"] = compared
    return result
