"""Profiling and timing (counterpart of ``zpc_tpu/utils/profile.py``;
reference ``profile/CppTimers.hpp`` and ``cuda/profile/CudaTimers.cuh``).

PyTorch queues CUDA work and returns, so every timer here waits for the
device of the tensors it is given before it reads the clock:
:class:`Timer`'s ``tock(result)`` and :func:`bench` synchronise each CUDA
device that the result's tensors live on (a CPU result needs no wait).
:func:`trace` is ``torch.profiler`` over the CPU and, where there is a card,
CUDA activities, written as a Chrome trace; :func:`memory_stats` reads the
caching allocator's statistics.

The hot path carries named spans and one counter.  :func:`span` (and
:func:`spanned` for a whole function) records ``zpc.<name>`` as a host
range in the profiler's own trace, on the clock of the device records,
while a profiler is running, and is a shared no-op context otherwise.  The
range is an operator-level record, not ``record_function``'s user range:
the profiler draws no copy of it on the device's timeline (a user range's
copy there spans the gaps between the work inside it), so the device
activity of a trace holds only the work itself, and a range's device time
(``device_time_total`` of its event) is that of the work launched inside
it, hand kernels launched outside any operator included.
:func:`read_host` is the one way the stepping code reads a device value on
the host, and :func:`to_device` the one way it copies a host table to the
device; each waits for the device and is counted in :data:`HOST_SYNCS` by
site.  :data:`CONTACT_WORK` counts the mesh contact's narrow-phase work on
the device while a profiler runs, as the spans appear then
(:func:`add_contact_work`), with no host read.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
import statistics
import time
from typing import Callable, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["Timer", "bench", "trace", "memory_stats", "span", "spanned",
           "read_host", "to_device", "add_contact_work", "HOST_SYNCS",
           "CONTACT_WORK"]

# host syncs of the stepping code (reads and table copies), by site;
# always on
HOST_SYNCS: collections.Counter = collections.Counter()

# the mesh contact's narrow phases under a profiler, summed: "pairs" (live
# lanes x candidates over live bins), "lanes" (live lanes of bins with a
# candidate), "tris" (candidates of live bins), "active" (the pairs with
# d^2 < dhat^2).  Each value is a 0-d int64
# tensor on the device, replaced by a new one at every narrow phase (never
# added to in place, so a copy of the counter taken earlier keeps its
# values)
CONTACT_WORK: collections.Counter = collections.Counter()

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The range ``zpc.<name>`` in a running profiler's trace; one shared
    no-op context when no profiler runs (checked at every call)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast("zpc." + name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: every call of the function runs inside :func:`span`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def read_host(t: torch.Tensor, site: str):
    """``t.item()`` inside the span ``sync.<site>``, counted in
    :data:`HOST_SYNCS` under ``site``."""
    HOST_SYNCS[site] += 1
    with span("sync." + site):
        return t.item()


def add_contact_work(work: torch.Tensor) -> None:
    """Add one narrow phase's ``[pairs, lanes, tris, active]`` (int64, on
    its device) to :data:`CONTACT_WORK` while a profiler runs (checked at
    every call, as :func:`span` checks); four additions on the device, no
    host read."""
    if _autograd_profiler._is_profiler_enabled:
        for i, key in enumerate(("pairs", "lanes", "tris", "active")):
            CONTACT_WORK[key] = CONTACT_WORK[key] + work[i]


def to_device(values, device: torch.device, site: str) -> torch.Tensor:
    """``torch.as_tensor(values, device=device)`` of a host table: on a
    CUDA device a copy from pageable memory, which waits for the device's
    queue to drain, so it is counted and spanned as :func:`read_host`'s
    reads are."""
    HOST_SYNCS[site] += 1
    with span("sync." + site):
        return torch.as_tensor(values, device=device)


def _cuda_devices(obj, out):
    """The CUDA devices of the tensors in a tree of tuples, lists, dicts
    and dataclasses."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), out)
    return out


def block_until_ready(result):
    """Wait until every CUDA device holding a tensor of ``result`` has
    finished its queued work (``jax.block_until_ready``); returns
    ``result``."""
    for dev in _cuda_devices(result, set()):
        torch.cuda.synchronize(dev)
    return result


class Timer:
    """tick/tock timer in ms (CppTimer); ``tock(result)`` first waits for
    the devices of ``result``."""

    def __init__(self, label: str = ""):
        self.label = label
        self._t0 = None
        self.elapsed_ms = 0.0

    def tick(self):
        self._t0 = time.perf_counter()
        return self

    def tock(self, result=None, echo: bool = True) -> float:
        if result is not None:
            block_until_ready(result)
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        if echo:
            print(f"[timer] {self.label}: {self.elapsed_ms:.3f} ms")
        return self.elapsed_ms

    def __enter__(self):
        return self.tick()

    def __exit__(self, *exc):
        self.tock()


def bench(fn: Callable, *args, warmup: int = 2, iters: int = 10,
          label: Optional[str] = None, echo: bool = False) -> float:
    """Median wall-clock ms of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` calls, each call waited for on its result's devices."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    if echo:
        print(f"[bench] {label or getattr(fn, '__name__', '?')}: "
              f"{med:.3f} ms (min {min(times):.3f})")
    return med


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activities, and CUDA
    ones where a card is present) and write the Chrome trace
    ``<logdir>/trace.json``; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def memory_stats(device=None) -> dict:
    """The caching allocator's memory snapshot of a CUDA device (the
    current one by default), under the JAX keys: ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit`` (the device's total memory) and
    ``raw`` (``torch.cuda.memory_stats``).  On the CPU, which keeps no
    such record, every count is -1 and ``raw`` is empty, as the JAX
    version answers for a runtime without statistics."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return {"bytes_in_use": -1, "peak_bytes_in_use": -1,
                "bytes_limit": -1, "raw": {}}
    raw = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": raw.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": raw.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
        "raw": raw,
    }
