"""The program's spans and host syncs in one benchmark cell, on one NVIDIA
GPU.

Run from the repository root:

    python3 tools/cell_spans.py --workload elastic_block_256k.freefall \\
        [--seed 12345]

It makes the cell's set-up as ``portbench/run.py`` does
(``portbench.harness.cell.prepare``), runs one segment, then a second
segment whose steps ``trace_from_step`` to ``trace_from_step +
trace_steps`` run under ``torch.profiler`` (the benchmark's own traced
slice), then a third under ``torch.cuda.set_sync_debug_mode("warn")``.
It prints:

* the slice's wall time, busy time and idle share as
  ``portbench/harness/trace.py:reduce_profile`` reduces them;
* one line per ``zpc.*`` span of ``zpc_tpu_torch.utils.profile``: its
  count, host ms, device ms (the work launched inside it) and the idle ms
  of the device gaps whose middle it holds innermost;
* the idle gaps named ``<benchmark span>/<innermost zpc span>`` (the
  benchmark span alone where no program span is open);
* host syncs a step (``HOST_SYNCS`` over the traced segment), the device
  ms of P2G a step, of a CG operator application and of the contact a
  step;
* every synchronising call that sync debug mode reports in the third
  segment, by the innermost site in the program (or the benchmark), beside
  ``HOST_SYNCS`` over the same segment.

The same numbers go to ``chiprun_out/cell_spans_<workload>.json``.
"""

import argparse
import bisect
import collections
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from portbench.harness import trace  # noqa: E402
from portbench.harness.cell import _Slice, prepare  # noqa: E402
from portbench.harness.spec import load_cell  # noqa: E402
from zpc_tpu_torch.utils import profile as zprof  # noqa: E402

ZPC = "zpc."


def span_table(events):
    """(per-span rows, idle seconds by ``<benchmark span>/<zpc span>``,
    device-side ``zpc.*`` records) of ``prof.events()``.  Device activity
    and its union are those of :func:`trace.reduce_profile`; a gap is
    named by the benchmark span open at its middle (``chain`` where none
    is) and the innermost program span open there."""
    dev_iv, bench, spans, dev_copies = [], [], [], 0
    rows = collections.defaultdict(lambda: [0, 0.0, 0.0, 0.0])
    for e in events:
        on_host = e.device_type == DeviceType.CPU
        if e.name.startswith(trace.PREFIX):
            if on_host:
                bench.append((e.time_range.start, e.time_range.end,
                              e.name[len(trace.PREFIX):]))
            continue
        if e.name.startswith(ZPC):
            if not on_host:
                dev_copies += 1
                continue
            s, t = e.time_range.start, e.time_range.end
            spans.append((s, t, e.name))
            r = rows[e.name]
            r[0] += 1
            r[1] += (t - s) * 1e-3
            r[2] += e.device_time_total * 1e-3
            continue
        if not on_host:
            dev_iv.append((e.time_range.start, e.time_range.end))
    merged = trace._merged(dev_iv)
    bench.sort()
    spans.sort()
    b_starts = [s for s, _, _ in bench]
    z_starts = [s for s, _, _ in spans]
    idle = collections.defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(b_starts, mid) - 1
        name = bench[i][2] if i >= 0 and bench[i][1] >= mid else "chain"
        j = bisect.bisect_right(z_starts, mid) - 1
        while j >= 0 and spans[j][1] < mid:    # the latest open one holds it
            j -= 1
        if j >= 0:
            rows[spans[j][2]][3] += (s1 - e0) * 1e-3
            name = f"{name}/{spans[j][2]}"
        idle[name] += (s1 - e0) * 1e-6
    return dict(rows), dict(idle), dev_copies


class SyncSites:
    """Counts the warnings of ``torch.cuda.set_sync_debug_mode("warn")``
    by the innermost frame in the program (else in the benchmark)."""

    def __init__(self):
        self.sites = collections.Counter()

    def show(self, message, category, filename, lineno, file=None,
             line=None):
        stack = traceback.extract_stack()[:-1]
        for tree in ("zpc_tpu_torch", "portbench"):
            frames = [f for f in stack if f"/{tree}/" in f.filename]
            if frames:
                f = frames[-1]
                self.sites[f"{tree}/{f.filename.split(f'/{tree}/')[1]}:"
                           f"{f.lineno} {f.name}"] += 1
                return
        self.sites[f"{filename}:{lineno}"] += 1

    def run(self, fn):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self.show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 4321)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("this probe needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    tr = cell.traffic
    n = tr["segment_steps"]
    t0 = time.perf_counter()
    prog, start, _ = prepare(cell, args.seed, dev)
    prog.segment(start, n)
    torch.cuda.synchronize()
    print(f"{cell.name} ({card}): set-up and one segment "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the traced segment
    syncs0 = sum(zprof.HOST_SYNCS.values())
    steps0 = prog.counters.steps
    sl = _Slice(dev, min(tr["trace_from_step"], n - 1), tr["trace_steps"],
                lambda: prog.counters)
    prog.step_hook = sl.hook
    prog.segment(start, n)
    sl.stop()
    prog.step_hook = None
    seg_steps = prog.counters.steps - steps0
    seg_syncs = sum(zprof.HOST_SYNCS.values()) - syncs0
    slice_s, c0, c1 = sl.done
    steps = c1.steps - c0.steps
    events = sl.prof.events()
    busy, span_dev, _, gaps = trace.reduce_profile(events)
    rows, idle, dev_copies = span_table(events)
    out = {"workload": cell.name, "card": card, "seed": args.seed,
           "slice_steps": steps, "slice_rebins": c1.rebins - c0.rebins,
           "slice_s": slice_s, "busy_s": busy,
           "bench_span_device_s": span_dev, "bench_idle_gaps": dict(gaps),
           "zpc_device_records": dev_copies,
           "spans": {k: dict(zip(("count", "host_ms", "device_ms",
                                  "idle_ms"), v)) for k, v in rows.items()},
           "idle_gaps": idle}
    print(f"traced slice: {steps} steps, {out['slice_rebins']} rebins, "
          f"wall {slice_s * 1e3:.4f} ms ({slice_s * 1e3 / steps:.4f} a "
          f"step), busy {busy * 1e3:.4f} ms, idle share "
          f"{100 * (1 - busy / slice_s):.3f}%; device-side zpc records "
          f"{dev_copies}", flush=True)
    print(f"{'span':28s} {'count':>7s} {'host ms':>11s} {'device ms':>11s} "
          f"{'idle ms':>10s}")
    for k, (cnt, host, devms, idl) in sorted(rows.items(),
                                             key=lambda kv: -kv[1][2]):
        print(f"{k:28s} {cnt:7d} {host:11.4f} {devms:11.4f} {idl:10.4f}")
    total = sum(idle.values())
    print(f"idle gaps ({total * 1e3:.4f} ms):")
    for k, v in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"  {k:40s} {v * 1e3:10.4f} ms {100 * v / total:6.2f}%")
    step_idle = sum(v for k, v in idle.items() if k.split("/")[0] == "step")
    named = sum(v for k, v in idle.items() if k.startswith("step/"))
    print(f"step idle named by a program span: {named * 1e3:.4f} of "
          f"{step_idle * 1e3:.4f} ms "
          f"({100 * named / max(step_idle, 1e-30):.2f}%)")

    def dev_ms(*names):
        return sum(v[2] for k, v in rows.items() if k in names or
                   any(k.startswith(p + ".") for p in names))
    apply_n = rows.get("zpc.cg.apply", [0])[0]
    readings = {
        "host_syncs_per_step": seg_syncs / seg_steps,
        "p2g_device_ms": (dev_ms("zpc.p2g") / steps
                          if not c1.cg_iters else None),
        "cg_apply_device_ms": (dev_ms("zpc.cg.apply") / apply_n
                               if apply_n else None),
        "contact_device_ms": (dev_ms("zpc.contact") / steps
                              if "zpc.contact.narrow" in rows else None)}
    out["readings"] = readings
    print("readings: " + ", ".join(f"{k} {v!r}" for k, v in
                                   readings.items()), flush=True)
    del sl, events

    # the synchronising calls of one more segment
    before = collections.Counter(zprof.HOST_SYNCS)
    sync = SyncSites()
    sync.run(lambda: prog.segment(start, n))
    counted = collections.Counter(zprof.HOST_SYNCS)
    counted.subtract(before)
    counted = {k: v for k, v in counted.items() if v}
    in_prog = sum(v for k, v in sync.sites.items()
                  if k.startswith("zpc_tpu_torch/"))
    out["sync_debug_sites"] = dict(sync.sites)
    out["host_syncs_by_site_segment"] = counted
    print(f"sync debug mode over one segment ({n} steps): "
          f"{sum(sync.sites.values())} synchronising calls, {in_prog} in "
          f"the program; HOST_SYNCS counted {sum(counted.values())} "
          f"({counted})")
    for k, v in sync.sites.most_common():
        print(f"  {v:7d}  {k}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"cell_spans_{cell.name}.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
