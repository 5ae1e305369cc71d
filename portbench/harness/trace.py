"""Reduction of a ``torch.profiler`` trace of a slice of the window to
what the per-layer metric readers take (:class:`Slice`).

Device activity is every event the profiler put on the device (kernels,
copies, sets), less the device-side copies of the benchmark's own spans
and of the program's.  A span's device time is the time of the device
work launched while the host was inside it (``FunctionEvent.
device_time_total``, children included).  Busy time is the union of the
device intervals.  Each idle gap between them is named by the benchmark
span the host was in at the gap's middle (``chain`` when it was in none:
the chain driver between calls, where ``adaptive_chain`` reads the rebin
flag) and by the innermost of the program's own spans open there
(``zpc.*``, ``zpc_tpu_torch.utils.profile.span``), as ``<benchmark
span>/<program span>``; the benchmark span alone where no program span is
open.  Every ``zpc.*`` host range is kept with its device time, so a
reader can take any program span's count and device time without an edit
here.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from torch.autograd import DeviceType

__all__ = ["Reduction", "Slice", "reduce_events", "reduce_profile"]

PREFIX = "portbench."
PROGRAM_PREFIX = "zpc."


@dataclasses.dataclass
class Slice:
    """One traced slice: what the metric readers read."""

    window_s: float                 # host wall time of the slice
    busy_s: float                   # union of device activity
    span_device_s: Dict[str, float]  # span short name -> device seconds
    steps: int
    rebins: int
    cg_iters: List[int]
    window_steps: int               # the whole window's, slice included
    window_rebins: int
    shapes: dict                    # counts the roofline functions take
    peaks: Optional[dict]           # the card's, None when not in the table
    # program span ("zpc.p2g") -> (ranges, device seconds under them)
    program_spans: Dict[str, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)
    # (host start us, host end us, name, device seconds) of every program
    # range, by start, an enclosing range before the ranges inside it
    program_ranges: List[tuple] = dataclasses.field(default_factory=list)
    # "<COUNTER>.<site>" -> the slice's delta of a program counter
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    config: dict = dataclasses.field(default_factory=dict)  # the cell's

    def device_s_under(self, prefix: str) -> Optional[float]:
        """Device seconds under the outermost program ranges whose name
        starts with ``prefix`` (a range inside another such range is not
        counted again); None where no range has it."""
        total, end, found = 0.0, float("-inf"), False
        for s, e, name, dev in self.program_ranges:
            if not name.startswith(prefix):
                continue
            found = True
            if s >= end:                  # not inside the last outermost
                total += dev
                end = e
        return total if found else None


@dataclasses.dataclass
class Reduction:
    """What :func:`reduce_events` takes from ``prof.events()``."""

    busy_s: float
    span_device_s: Dict[str, float]          # benchmark span -> seconds
    ops: List[Tuple[str, float]]             # top device ops by time
    gaps: List[Tuple[str, float]]            # top idle gaps by name
    program_spans: Dict[str, Tuple[int, float]]
    program_ranges: List[tuple]


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(ranges, mids):
    """For each of the sorted times ``mids``, the index in ``ranges``
    (sorted by start, outer first) of the innermost range open there
    (start <= t <= end; the latest in that order), or -1."""
    marks = [(s, 0, i) for i, (s, _, _, _) in enumerate(ranges)]
    marks += [(t, 1, j) for j, t in enumerate(mids)]
    marks += [(e, 2, i) for i, (_, e, _, _) in enumerate(ranges)]
    marks.sort()
    open_, out = [], [-1] * len(mids)
    for _, kind, i in marks:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            open_.remove(i)
        elif open_:
            out[i] = max(open_)
    return out


def reduce_events(events, top: int = 10) -> Reduction:
    """The slice's device activity, benchmark spans, program spans and
    idle gaps from ``prof.events()``."""
    dev_iv, by_op = [], defaultdict(float)
    spans, span_dev = [], defaultdict(float)
    ranges = []
    for e in events:
        on_host = e.device_type == DeviceType.CPU
        if e.name.startswith(PREFIX):
            if on_host:
                short = e.name[len(PREFIX):]
                spans.append((e.time_range.start, e.time_range.end, short))
                span_dev[short] += e.device_time_total * 1e-6
            continue
        if e.name.startswith(PROGRAM_PREFIX):
            if on_host:
                ranges.append((e.time_range.start, e.time_range.end,
                               e.name, e.device_time_total * 1e-6))
            continue
        if not on_host:
            s, t = e.time_range.start, e.time_range.end
            dev_iv.append((s, t))
            by_op[e.name] += (t - s) * 1e-6
    merged = _merged(dev_iv)
    busy = sum(t - s for s, t in merged) * 1e-6
    # the benchmark's spans do not nest: the one that started last before
    # a gap's middle holds it if it has not ended
    spans.sort()
    starts = [s for s, _, _ in spans]
    ranges.sort(key=lambda r: (r[0], -r[1]))       # outer before inner
    gap_iv = [(e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])]
    mids = [0.5 * (e0 + s1) for e0, s1 in gap_iv]
    inner = _innermost(ranges, mids)
    idle = defaultdict(float)
    for (e0, s1), mid, j in zip(gap_iv, mids, inner):
        i = bisect.bisect_right(starts, mid) - 1
        name = "chain"
        if i >= 0 and spans[i][1] >= mid:
            name = spans[i][2]
        if j >= 0:
            name = f"{name}/{ranges[j][2]}"
        idle[name] += (s1 - e0) * 1e-6
    prog = defaultdict(lambda: [0, 0.0])
    for _, _, name, dev in ranges:
        prog[name][0] += 1
        prog[name][1] += dev
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return Reduction(busy, dict(span_dev), ops, gaps,
                     {k: (c, d) for k, (c, d) in prog.items()}, ranges)


def reduce_profile(events, top: int = 10):
    """(busy_s, benchmark span device seconds, top device ops, idle
    seconds by gap name) of :func:`reduce_events`."""
    r = reduce_events(events, top)
    return r.busy_s, r.span_device_s, r.ops, r.gaps
