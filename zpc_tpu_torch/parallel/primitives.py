"""Parallel primitives (counterpart of ``zpc_tpu/parallel/primitives.py``).

``reduce / inclusive_scan / exclusive_scan / sort / sort_pair /
merge_sort(_pair) / radix_sort(_pair) / argsort_stable / histogram /
segment_reduce / scatter_drop / count_if / select_if / unique``, each with
the policy first (:class:`~zpc_tpu_torch.core.executor.Executor`), the JAX
package's signatures and its results.  An op is a name (``"add"``/``"sum"``,
``"mul"``/``"prod"``, ``"min"``, ``"max"``) or the matching torch function;
any other callable is a custom associative op.

Every 1-D add/max/min scan of int32, uint32 or float32 goes to the scan
kernel (:mod:`zpc_tpu_torch.ops.scan`): on a CUDA tensor the hand CUDA
kernel at any size, on a CPU tensor its plain version; the prefix sums of
``select_if`` and ``unique`` and of the containers built on them go through
:func:`inclusive_scan` too.  The JAX package computes the rest in XLA
(``lax.sort``, ``segment_sum``, ``jnp.sum``); here that is PyTorch's own
calls: ``torch.sort``, ``index_add_``/``scatter_reduce_``, ``torch.sum``.

Integer dtypes follow the JAX package with 64-bit types off: sums and
products of int32 wrap mod 2^32, and indices, counts and ranks are int32.
``torch.uint32`` lacks most arithmetic, on the CPU and the card alike, so a
uint32 tensor is only ever viewed as int32: computed with as an int64 in
[0, 2^32), gathered and written through its int32 view.  Out-of-range
indices never reach an indexing op: ``scatter_drop``, ``histogram`` and
``segment_reduce`` send them to a trash slot, where XLA drops them.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..core.executor import Executor
from ..math.bits import to_int32
from ..ops.scan import scan

__all__ = [
    "monoid_identity",
    "reduce",
    "inclusive_scan",
    "exclusive_scan",
    "sort",
    "sort_pair",
    "merge_sort",
    "merge_sort_pair",
    "radix_sort",
    "radix_sort_pair",
    "argsort_stable",
    "histogram",
    "segment_reduce",
    "scatter_drop",
    "count_if",
    "select_if",
    "unique",
]

Op = Union[str, Callable]

_NAMES = {"add": "add", "sum": "add", "mul": "mul", "prod": "mul",
          "min": "min", "max": "max",
          torch.add: "add", torch.mul: "mul", torch.multiply: "mul",
          torch.minimum: "min", torch.maximum: "max"}
_BINARY = {"add": torch.add, "mul": torch.mul, "min": torch.minimum,
           "max": torch.maximum}
_SCAN_DTYPES = (torch.int32, torch.uint32, torch.float32)
_M32 = 0xFFFFFFFF


def _op_name(op: Op) -> Optional[str]:
    """The monoid's name of ``op``, or None for a custom callable."""
    try:
        return _NAMES.get(op)
    except TypeError:                 # an unhashable callable
        return None


# -- dtypes -------------------------------------------------------------------

def _wide(t: torch.Tensor) -> torch.Tensor:
    """uint32 as its value in an int64 (order kept); any other dtype
    unchanged."""
    if t.dtype != torch.uint32:
        return t
    return t.view(torch.int32).to(torch.int64) & _M32


def _narrow(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Wide integer results back to ``dtype``: the low 32 bits, two's
    complement for int32, as XLA's 32-bit integer arithmetic wraps."""
    if t.dtype == dtype:
        return t
    if dtype in (torch.int32, torch.uint32):
        t = to_int32(t)
        return t if dtype == torch.int32 else t.view(torch.uint32)
    return t.to(dtype)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]``, through the int32 view of a uint32 tensor."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)[idx].view(torch.uint32)
    return t[idx]


def _full(shape, value, like: torch.Tensor) -> torch.Tensor:
    """``torch.full`` in ``like``'s dtype and device (uint32 made through
    int64)."""
    if like.dtype == torch.uint32:
        return _narrow(torch.full(shape, value, dtype=torch.int64,
                                  device=like.device), torch.uint32)
    return torch.full(shape, value, dtype=like.dtype, device=like.device)


def _is_int(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool


def _limits(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf"), float("inf")
    if dtype == torch.bool:
        return False, True
    info = torch.iinfo(dtype)
    return int(info.min), int(info.max)


def monoid_identity(op: Op, dtype: torch.dtype):
    """Identity of ``op`` at ``dtype`` (``zs::monoid<Op>::identity``): 0 for
    add, 1 for mul, +-inf or the integer limits for min/max."""
    name = _op_name(op)
    if name is None:
        raise ValueError(f"no known identity for op {op!r}; pass init= "
                         f"explicitly")
    if name == "add":
        return 0
    if name == "mul":
        return 1
    lo, hi = _limits(dtype)
    return hi if name == "min" else lo


def _full_reduce(name: str, a: torch.Tensor) -> torch.Tensor:
    """``jnp.sum/prod/min/max`` of every element, in ``a``'s dtype (bool
    sums to int32, as in JAX)."""
    if name in ("add", "mul"):
        out_dtype = torch.int32 if a.dtype == torch.bool else a.dtype
        if _is_int(out_dtype) or a.dtype == torch.bool:
            w = _wide(a).to(torch.int64)
            r = torch.sum(w) if name == "add" else torch.prod(w)
            return _narrow(r, out_dtype)
        return torch.sum(a) if name == "add" else torch.prod(a)
    r = torch.amin(_wide(a)) if name == "min" else torch.amax(_wide(a))
    return _narrow(r, a.dtype)


def _tree_reduce(fn: Callable, a: torch.Tensor, init) -> torch.Tensor:
    """Fold a custom associative ``fn`` over every element by pairwise
    halving; ``init`` pads the odd element and starts the fold."""
    a = a.reshape(-1)
    acc = _full((), init, a)
    while a.numel() > 1:
        if a.numel() % 2:
            a = torch.cat([a, acc.reshape(1)])
        a = fn(a[0::2], a[1::2])
    return fn(acc, a[0]) if a.numel() else acc


def reduce(pol: Executor, arr: torch.Tensor, op: Op = "add", init=None):
    """Full reduction to a 0-d tensor (``zs::reduce``).  With ``init`` the
    fold starts from it; without, the monoid's own reduction runs (which,
    like ``jnp.min``, raises on an empty min/max)."""
    name = _op_name(op)

    def kern(a):
        if name is None:
            return _tree_reduce(op, a, init if init is not None
                                else monoid_identity(op, a.dtype))
        if init is None:
            return _full_reduce(name, a)
        acc = _full((), init, a)
        if a.numel() == 0:
            return acc
        r = _wide(_full_reduce(name, a))
        if name in ("add", "mul") and _is_int(a.dtype):
            r, acc = r.to(torch.int64), _wide(acc).to(torch.int64)
        return _narrow(_BINARY[name](r, _wide(acc)), a.dtype)

    return pol.run(kern, arr, label="reduce")


# -- scans --------------------------------------------------------------------

def _assoc_scan(fn: Callable, a: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along axis 0 by recursive doubling (Hillis-Steele),
    ``fn(earlier, later)`` as ``lax.associative_scan`` applies it."""
    n, k = a.shape[0], 1
    out = a
    while k < n:
        out = torch.cat([out[:k], fn(out[:-k], out[k:])])
        k *= 2
    return out


def _kernel_scan(a: torch.Tensor, name: Optional[str]) -> bool:
    return name in ("add", "max", "min") and a.dim() == 1 \
        and a.dtype in _SCAN_DTYPES


_CUM = {"add": torch.cumsum, "mul": torch.cumprod,
        "min": lambda a, dim: torch.cummin(a, dim).values,
        "max": lambda a, dim: torch.cummax(a, dim).values}


def _generic_scan(a: torch.Tensor, name: Optional[str], op: Op):
    """The scans the kernel does not take.  A named op is one ``torch.cum*``
    call along axis 0: integers in int64 and wrapped back to their dtype,
    as XLA's arithmetic wraps; bool's add and mul are or and and.  A custom
    callable scans by recursive doubling."""
    if name is None:
        return _assoc_scan(op, a)
    if a.dtype == torch.bool:
        name = {"add": "max", "mul": "min"}.get(name, name)
        return _CUM[name](a.to(torch.uint8), 0).to(torch.bool)
    return _narrow(_CUM[name](_wide(a), 0), a.dtype)


def inclusive_scan(pol: Executor, arr: torch.Tensor,
                   op: Op = "add") -> torch.Tensor:
    """Inclusive scan along axis 0 (ExecutionPolicy.hpp:247-255)."""
    name = _op_name(op)

    def kern(a):
        if a.shape[0] == 0:
            return a.clone()
        if _kernel_scan(a, name):
            return scan(a, name)
        return _generic_scan(a, name, op)

    return pol.run(kern, arr, label="inclusive_scan")


def exclusive_scan(pol: Executor, arr: torch.Tensor, op: Op = "add",
                   init=None) -> torch.Tensor:
    """Exclusive scan (ExecutionPolicy.hpp:256-266).  As in the JAX
    package, ``init`` (default: the op's identity) is placed at position 0
    and the rest is the inclusive scan shifted by one; it is not folded into
    the later elements."""
    name = _op_name(op)
    if init is None:
        init = monoid_identity(op, arr.dtype)

    def kern(a):
        if a.shape[0] == 0:
            return a.clone()
        if _kernel_scan(a, name) and name == "add" and not init:
            return scan(a, "add", exclusive=True)
        inc = scan(a, name) if _kernel_scan(a, name) else \
            _generic_scan(a, name, op)
        first = _full((1,) + a.shape[1:], init, a)
        if a.dtype == torch.uint32:
            return torch.cat([first.view(torch.int32),
                              inc[:-1].view(torch.int32)]).view(torch.uint32)
        return torch.cat([first, inc[:-1]])

    return pol.run(kern, arr, label="exclusive_scan")


# -- sorts --------------------------------------------------------------------

def _bits_for(bound) -> int:
    """Bits needed for values in [0, bound)."""
    return max(1, int(np.ceil(np.log2(max(int(bound), 2)))))


def _pack_ok(key_bound, val_bound) -> bool:
    """Static bounds small enough to pack (key, val) into one int32 and
    sort a single array (the JAX package's 1.75x pair sort)."""
    return (key_bound is not None and val_bound is not None
            and _bits_for(key_bound) + _bits_for(val_bound) <= 31)


def _sort(keys: torch.Tensor, stable: bool):
    """(sorted keys, sorting permutation) along the last axis; uint32
    compares as unsigned."""
    v, perm = torch.sort(_wide(keys), stable=stable)
    return _narrow(v, keys.dtype), perm


def sort(pol: Executor, keys: torch.Tensor) -> torch.Tensor:
    """Sort along the last axis (``zs::sort``; unstable contract)."""
    return pol.run(lambda k: _sort(k, False)[0], keys, label="sort")


def sort_pair(pol: Executor, keys: torch.Tensor, vals: torch.Tensor,
              key_bound=None, val_bound=None):
    """Key-value sort (``zs::sort_pair``).  With static exclusive bounds
    whose widths fit 31 bits, the pair sorts as one packed int32 array and
    ties order by value; otherwise the order of ties is unspecified."""
    if _pack_ok(key_bound, val_bound):
        vb = _bits_for(val_bound)

        def kern_packed(k, v):
            p = (_wide(k).to(torch.int32) << vb) | _wide(v).to(torch.int32)
            sp = torch.sort(p).values
            return _narrow(sp >> vb, k.dtype), \
                _narrow(sp & ((1 << vb) - 1), v.dtype)

        return pol.run(kern_packed, keys, vals, label="sort_pair")

    def kern(k, v):
        sk, o = _sort(k, False)
        return sk, _take(v, o)

    return pol.run(kern, keys, vals, label="sort_pair")


def merge_sort(pol: Executor, keys: torch.Tensor) -> torch.Tensor:
    """Stable sort (``zs::merge_sort``)."""
    return pol.run(lambda k: _sort(k, True)[0], keys, label="merge_sort")


def merge_sort_pair(pol: Executor, keys: torch.Tensor, vals: torch.Tensor):
    """Stable key-value sort."""
    def kern(k, v):
        sk, o = _sort(k, True)
        return sk, _take(v, o)

    return pol.run(kern, keys, vals, label="merge_sort_pair")


def _nbits(keys: torch.Tensor) -> int:
    return keys.element_size() * 8


def _bit_window(keys: torch.Tensor, sbit: int, ebit: int) -> torch.Tensor:
    """Bits [sbit, ebit) of integer keys as a non-negative int64 (the
    unsigned window the JAX package compares); the whole key compares as
    the key itself."""
    nbits = _nbits(keys)
    if sbit == 0 and ebit >= nbits:
        return _wide(keys)
    w = _wide(keys).to(torch.int64)
    if nbits < 64:
        w = w & ((1 << nbits) - 1)
    width = min(ebit, nbits) - sbit
    return (w >> sbit) & ((1 << width) - 1) if width < 64 else w


def _window_order(keys: torch.Tensor, sbit: int, ebit: int) -> torch.Tensor:
    """The stable order of ``keys`` on bits [sbit, ebit): one stable sort of
    the window, as int32 when it fits 31 bits (half the radix passes of
    int64)."""
    wk = _bit_window(keys, sbit, ebit)
    if ebit - sbit <= 31:
        wk = wk.to(torch.int32)
    return torch.sort(wk, stable=True).indices


def radix_sort(pol: Executor, keys: torch.Tensor, sbit: int = 0,
               ebit: Optional[int] = None) -> torch.Tensor:
    """Stable sort of integer keys on the bit window [sbit, ebit)
    (``zs::radix_sort``)."""
    nbits = _nbits(keys)
    ebit = nbits if ebit is None else ebit
    if sbit == 0 and ebit >= nbits:
        # the whole key: stable equals unstable for a key-only sort
        return sort(pol, keys)
    return pol.run(lambda k: _take(k, _window_order(k, sbit, ebit)), keys,
                   label="radix_sort")


def radix_sort_pair(pol: Executor, keys: torch.Tensor, vals: torch.Tensor,
                    sbit: int = 0, ebit: Optional[int] = None,
                    vals_are_ranks: bool = False):
    """Stable key-value sort on the bit window [sbit, ebit).

    ``vals_are_ranks`` (vals distinct and ascending with position) lets the
    JAX package pack (window, val) into one key for the TPU's unstable
    sort; the stable sort here gives that order already, so the flag is
    accepted for the signature and chooses nothing."""
    nbits = _nbits(keys)
    ebit = nbits if ebit is None else ebit

    def kern(k, v):
        o = _window_order(k, sbit, ebit)
        return _take(k, o), _take(v, o)

    return pol.run(kern, keys, vals, label="radix_sort_pair")


def argsort_stable(pol: Executor, keys: torch.Tensor,
                   key_bound=None) -> torch.Tensor:
    """Stable argsort (int32), the backbone of the sort+segment idiom.
    ``key_bound`` lets the JAX package pack (key, rank) for the TPU; it is
    accepted for the signature and chooses nothing here."""
    return pol.run(lambda k: _sort(k, True)[1].to(torch.int32), keys,
                   label="argsort_stable")


# -- histogram / segment ops (the atomics' replacement) -----------------------

def _trash_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 ids with every one outside [0, n) sent to the trash slot n."""
    ids = ids.to(torch.int64)
    return torch.where((ids >= 0) & (ids < n), ids, n)


def histogram(pol: Executor, indices: torch.Tensor, num_bins: int,
              weights: Optional[torch.Tensor] = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Counting (or weighted) histogram; indices outside [0, num_bins) are
    dropped.  The JAX package's one-hot matmul for small bin counts is a
    stand-in for the TPU's matrix unit: every bin count scatters here."""
    dtype = dtype or (weights.dtype if weights is not None else torch.int32)

    def kern(idx, w):
        n = idx.shape[0]
        data = torch.ones((n,), dtype=dtype, device=idx.device) \
            if w is None else w.to(dtype)
        out = torch.zeros((num_bins + 1,), dtype=dtype, device=idx.device)
        return out.index_add_(0, _trash_ids(idx, num_bins), data)[:num_bins]

    return pol.run(kern, indices, weights, label="histogram")


_SEG_REDUCE = {"min": "amin", "max": "amax", "mul": "prod"}


def _segment(data: torch.Tensor, sid: torch.Tensor, num_segments: int,
             name: str) -> torch.Tensor:
    """``jax.ops.segment_<name>``: ids outside [0, num_segments) dropped,
    empty segments at the op's identity."""
    ids = _trash_ids(sid, num_segments)
    shape = (num_segments + 1,) + tuple(data.shape[1:])
    if name == "add":
        if _is_int(data.dtype):
            w = torch.zeros(shape, dtype=torch.int64, device=data.device)
            w.index_add_(0, ids, _wide(data).to(torch.int64))
            return _narrow(w, data.dtype)[:num_segments]
        out = torch.zeros(shape, dtype=data.dtype, device=data.device)
        return out.index_add_(0, ids, data)[:num_segments]
    wd = _wide(data)
    if name == "mul" and data.dtype == torch.int32:
        wd = data.to(torch.int64)
    out = torch.full(shape, monoid_identity(name, data.dtype),
                     dtype=wd.dtype, device=data.device)
    idx = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(wd)
    out.scatter_reduce_(0, idx, wd, reduce=_SEG_REDUCE[name],
                        include_self=True)
    return _narrow(out, data.dtype)[:num_segments] if _is_int(data.dtype) \
        else out[:num_segments]


def segment_reduce(pol: Executor, data: torch.Tensor,
                   segment_ids: torch.Tensor, num_segments: int,
                   op: Op = "add",
                   indices_are_sorted: bool = False) -> torch.Tensor:
    """Segmented reduction (add, min, max, mul) along axis 0: a scatter
    without atomics in the JAX package, ``index_add_``/``scatter_reduce_``
    here.  ``indices_are_sorted`` is a hint the scatter does not need."""
    name = _op_name(op)
    if name is None:
        raise ValueError(f"unsupported segment op {op!r}")
    return pol.run(lambda d, s: _segment(d, s, num_segments, name), data,
                   segment_ids, label="segment_reduce")


# -- stream compaction --------------------------------------------------------

_SCATTER_REDUCE = {"max": "amax", "min": "amin"}


def scatter_drop(target: torch.Tensor, dst: torch.Tensor, vals,
                 op: str = "set") -> torch.Tensor:
    """Scatter with drop semantics that stays in bounds: the buffer grows a
    trash slot, lanes with ``dst >= n`` land there (negative ``dst`` clips
    to 0, as ``jnp.clip`` does), and the slot is sliced off.  ``op``: "set",
    "add", "max" or "min".  Returns a new tensor."""
    n = target.shape[0]
    wide = _wide(target)
    buf = torch.cat([wide, wide.new_zeros((1,) + target.shape[1:])])
    d = dst.to(torch.int64).clamp(0, n)
    v = torch.as_tensor(vals, device=target.device)
    v = _wide(v).to(buf.dtype).expand(d.shape + target.shape[1:])
    if op == "set":
        buf[d] = v
    elif op == "add":
        buf.index_put_((d,), v, accumulate=True)
    else:
        idx = d.view((-1,) + (1,) * (target.dim() - 1)).expand_as(v)
        buf.scatter_reduce_(0, idx, v, reduce=_SCATTER_REDUCE[op],
                            include_self=True)
    return _narrow(buf[:n], target.dtype)


def count_if(pol: Executor, mask: torch.Tensor) -> torch.Tensor:
    """The number of true lanes (0-d int32)."""
    return pol.run(lambda m: torch.count_nonzero(m).to(torch.int32), mask,
                   label="count_if")


def _ranks(flags: torch.Tensor) -> torch.Tensor:
    """0-based rank of each true lane among the true lanes (int32; the
    prefix sum runs through :func:`inclusive_scan`)."""
    return inclusive_scan(Executor(), flags.to(torch.int32)) - 1


def _count(rank: torch.Tensor) -> torch.Tensor:
    if rank.shape[0] == 0:
        return torch.zeros((), dtype=torch.int32, device=rank.device)
    return rank[-1] + 1


def select_if(pol: Executor, data: torch.Tensor, mask: torch.Tensor,
              fill=0):
    """Compact the lanes where ``mask`` is true into the front of a buffer
    of the same capacity; returns ``(packed, count)`` with ``fill`` in the
    tail and ``count`` a 0-d int32 tensor (the reference's ``copy_if``)."""
    def kern(d, m):
        n = d.shape[0]
        pos = _ranks(m)
        dst = torch.where(m, pos, n)        # dropped lanes land in the trash
        out = _full((n,) + d.shape[1:], fill, d)
        return scatter_drop(out, dst, d), _count(pos)

    return pol.run(kern, data, mask, label="select_if")


def unique(pol: Executor, sorted_keys: torch.Tensor,
           valid_mask: Optional[torch.Tensor] = None, fill=None):
    """Unique over **sorted** keys: ``(unique_padded, count, inverse)``,
    ``inverse[i]`` the index of ``sorted_keys[i]`` in the unique list (-1
    on invalid lanes); the tail of ``unique_padded`` is ``fill`` (default:
    the dtype's maximum)."""
    if fill is None:
        fill = int(torch.iinfo(sorted_keys.dtype).max)

    def kern(k, vm):
        n = k.shape[0]
        neq = torch.ones((n,), dtype=torch.bool, device=k.device)
        if n:
            w = _wide(k)
            neq[1:] = w[1:] != w[:-1]
        if vm is not None:
            neq &= vm
        inv = _ranks(neq)
        dst = torch.where(neq, inv, n)
        uniq = scatter_drop(_full((n,), fill, k), dst, k)
        cnt = _count(inv)
        if vm is not None:
            inv = torch.where(vm, inv, -1)
        return uniq, cnt, inv

    return pol.run(kern, sorted_keys, valid_mask, label="unique")
