"""Reduction of a ``torch.profiler`` trace of a slice of the window to
what the per-layer metric readers take (:class:`Slice`).

Device activity is every event the profiler put on the device (kernels,
copies, sets), less the device-side copies of the benchmark's own spans.
A span's device time is the time of the device work launched while the
host was inside it (``FunctionEvent.device_time_total``, children
included).  Busy time is the union of the device intervals; the idle
gaps between them are named by the benchmark span the host was in at the
gap's middle, ``chain`` when it was in none (the chain driver between
calls, where ``adaptive_chain`` reads the rebin flag).  The busy-share
arithmetic follows ``tools/profile_torch_step.py``, which sums the
device events of ``key_averages`` the same way.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

from torch.autograd import DeviceType

__all__ = ["Slice", "reduce_profile"]

PREFIX = "portbench."


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


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_profile(events, top: int = 10):
    """(busy_s, span device seconds, top device ops, idle seconds by host
    span) from ``prof.events()``."""
    dev_iv, by_op = [], defaultdict(float)
    spans, span_dev = [], defaultdict(float)
    for e in events:
        if e.name.startswith(PREFIX):
            if e.device_type == DeviceType.CPU:
                short = e.name[len(PREFIX):]
                spans.append((e.time_range.start, e.time_range.end, short))
                span_dev[short] += e.device_time_total * 1e-6
            continue
        if e.device_type != DeviceType.CPU:
            s, t = e.time_range.start, e.time_range.end
            dev_iv.append((s, t))
            by_op[e.name] += (t - s) * 1e-6
    merged = _merged(dev_iv)
    busy = sum(t - s for s, t in merged) * 1e-6
    # the benchmark's spans do not nest: the one that started last before
    # a gap's middle holds it if it has not ended
    spans.sort()
    starts = [s for s, _, _ in spans]
    idle = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid) - 1
        name = "chain"
        if i >= 0 and spans[i][1] >= mid:
            name = spans[i][2]
        idle[name] += (s1 - e0) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return busy, dict(span_dev), ops, gaps
