"""Execution policies (counterpart of ``zpc_tpu/core/executor.py``).

The reference launches every kernel through an execution policy
(``ExecutionPolicy.hpp:99-127``) with fluent settings: ``.sync(bool)``,
``.profile(bool)``, ``.device(i)``.  Here a policy is an :class:`Executor`
value that every primitive takes first, and that decides

* **device**: the device its tensors must be on.  A policy that names a
  device refuses a tensor on another one (it never copies it quietly);
  ``device=None`` follows the tensors, which is what the port's own
  modules pass;
* **role**: the device says it.  A CPU policy is the oracle
  (:func:`seq_exec`, ``is_sequential``): every wrapper takes its kernel's
  plain version there.  A CUDA policy is the card's (:func:`tpu_exec`),
  where the wrappers launch the kernels.  PyTorch runs both eagerly, so
  there is no ``jit``/``interp`` backend to choose;
* **checks**: with ``check(True)`` every floating output of a launch is
  checked for NaN, and an index out of range raises from torch's own
  index checks (the CPU raises ``IndexError``; the JAX package's
  ``checkify`` plays both parts there);
* **profiling**: labelled times per launch with the caller's file:line,
  between CUDA events on a CUDA device and on the host's clock on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import time
from typing import Callable, Optional

import torch

__all__ = ["Executor", "cuda_device", "seq_exec", "tpu_exec", "jit_exec",
           "par_exec"]


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when no CUDA device is present
    (never substitutes the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    return torch.device("cuda", index)


def _call_site(depth: int = 2) -> str:
    """The caller's file:line (the reference's ``source_location``)."""
    fr = inspect.stack(0)[depth]
    return f"{fr.filename.rsplit('/', 1)[-1]}:{fr.lineno}"


def _tensors(obj):
    """The tensors of a tree of tuples, lists, dicts and dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    return a.index is None or b.index is None or a.index == b.index


@dataclasses.dataclass(frozen=True)
class Executor:
    """Value-semantic execution policy (fluent setters return new values)."""

    profile_flag: bool = False
    sync_flag: bool = False
    check_flag: bool = False
    device: Optional[torch.device] = None

    def profile(self, on: bool = True) -> "Executor":
        return dataclasses.replace(self, profile_flag=on)

    def sync(self, on: bool = True) -> "Executor":
        return dataclasses.replace(self, sync_flag=on)

    def check(self, on: bool = True) -> "Executor":
        """Check every floating output for NaN."""
        return dataclasses.replace(self, check_flag=on)

    def on(self, device) -> "Executor":
        return dataclasses.replace(self, device=torch.device(device))

    @property
    def is_sequential(self) -> bool:
        """The oracle's role: a policy on the CPU."""
        return self.device is not None and self.device.type == "cpu"

    def _check_devices(self, args, kwargs) -> Optional[torch.device]:
        """The device of the launch: the policy's, which every tensor
        argument must be on, or the first tensor's when the policy names
        none."""
        dev = self.device
        for t in _tensors((args, kwargs)):
            if dev is None:
                dev = t.device
            elif not _same_device(t.device, dev):
                raise ValueError(f"the policy runs on {dev}, a tensor "
                                 f"argument is on {t.device}")
        return dev

    def compile(self, fn: Callable, *, static_argnums=(),
                donate_argnums=()) -> Callable:
        """The launchable form of ``fn`` under this policy: ``fn`` itself,
        wrapped for the NaN check when ``check`` is on.  PyTorch runs
        eagerly, so nothing is traced or compiled; ``static_argnums`` and
        ``donate_argnums`` are accepted for the JAX package's signature and
        have no meaning here (no buffer is donated)."""
        if not self.check_flag:
            return fn

        @functools.wraps(fn)
        def checked(*args, **kw):
            out = fn(*args, **kw)
            for t in _tensors(out):
                if t.is_floating_point() and bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"{getattr(fn, '__name__', 'launch')} produced NaN")
            return out

        return checked

    def _synchronize(self, dev: Optional[torch.device]) -> None:
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(self, fn: Callable, *args, label: Optional[str] = None,
            **kwargs):
        """Launch ``fn(*args, **kwargs)`` under this policy, honouring
        profile and sync."""
        dev = self._check_devices(args, kwargs)
        launch = self.compile(fn)
        if not self.profile_flag:
            out = launch(*args, **kwargs)
            if self.sync_flag:
                self._synchronize(dev)
            return out
        where = label or getattr(fn, "__name__", "<fn>")
        site = _call_site()
        with self._timer(dev) as elapsed:
            out = launch(*args, **kwargs)
        print(f"[zpc_tpu_torch exec | {site}] {where}: {elapsed():.3f} ms")
        return out

    @contextlib.contextmanager
    def _timer(self, dev):
        """Yields a function that returns the block's milliseconds: CUDA
        events on a CUDA device, the host's clock elsewhere."""
        res = {}
        if dev is not None and dev.type == "cuda":
            with torch.cuda.device(dev):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                yield lambda: res["ms"]
                e1.record()
                e1.synchronize()
                res["ms"] = e0.elapsed_time(e1)
            return
        t0 = time.perf_counter()
        yield lambda: res["ms"]
        res["ms"] = (time.perf_counter() - t0) * 1e3

    def foreach(self, fn: Callable, n: int, *args):
        """``policy(range(n), f)``: the stacked results of ``fn(i, *args)``
        for i in [0, n) (int32 i), batched by ``torch.func.vmap``.  The index
        lies on the policy's device, else on the arguments', else on the
        card (:func:`cuda_device`, which raises where there is none)."""
        dev = self._check_devices(args, {}) or cuda_device()
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        batched = torch.func.vmap(lambda i: fn(i, *args))
        return self.run(batched, idx, label=getattr(fn, "__name__",
                                                    "foreach"))

    def map(self, fn: Callable, *arrays):
        """Elementwise map over the leading axis (``transform``)."""
        return self.run(torch.func.vmap(fn), *arrays,
                        label=getattr(fn, "__name__", "map"))

    @contextlib.contextmanager
    def scope(self, label: str):
        """Time a region (the reference's ``CppTimer`` tick/tock)."""
        if not self.profile_flag:
            yield
            return
        site = _call_site(3)
        with self._timer(self.device) as elapsed:
            yield
        print(f"[zpc_tpu_torch scope | {site}] {label}: {elapsed():.3f} ms")


def seq_exec() -> Executor:
    """The oracle policy: on the CPU, with checks on (``zs::seq_exec()``,
    whose serial implementations every backend is tested against)."""
    return Executor(check_flag=True, device=torch.device("cpu"))


def tpu_exec(index: int = 0) -> Executor:
    """The card's policy (``cuda_exec()``): :class:`Executor` on
    :func:`cuda_device`; raises where there is no CUDA device."""
    return Executor(device=cuda_device(index))


jit_exec = tpu_exec


def par_exec(*launches):
    """Launch several ``(policy, fn, *args)`` tuples; returns their results
    (the reference's multi-policy ``par_exec``).  The launches go to each
    device's current stream in order."""
    return tuple(pol.run(fn, *args) for pol, fn, *args in launches)
