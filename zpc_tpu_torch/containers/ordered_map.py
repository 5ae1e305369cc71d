"""``OrderedMap`` and ``RingBuffer`` (counterpart of
``zpc_tpu/containers/ordered_map.py``; the reference's ``RBTreeMap`` and
``RingBuffer``).

The ordered map is a sorted, sentinel-padded int32 key array with aligned
values and a 0-d count: lookups are binary searches, bulk insert and erase
are sort-and-compact passes whose ranks come from
:func:`~zpc_tpu_torch.parallel.primitives.inclusive_scan` (the scan kernel
on a CUDA tensor).  Every operation returns a new container.

One deliberate difference from the JAX package: :meth:`OrderedMap.erase`
marks its hits through a trash slot.  The JAX version scatters ``hit >= 0``
at ``max(hit, 0)``, so a missing key that comes after a key found in slot 0
writes False over that slot's mark, and the smallest key survives its
erase.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.executor import Executor
from ..parallel.primitives import inclusive_scan

__all__ = ["OrderedMap", "ordered_map", "RingBuffer", "ring_buffer"]

_SENTINEL = 2 ** 31 - 1
_POL = Executor()            # the scans run on their tensors' device


@dataclasses.dataclass(frozen=True)
class OrderedMap:
    keys: torch.Tensor      # [capacity] int32, ascending, sentinel-padded
    values: torch.Tensor    # [capacity, ...] aligned with keys
    count: torch.Tensor     # 0-d int32

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.keys.device) < \
            self.count

    def find(self, qkeys: torch.Tensor) -> torch.Tensor:
        """Slot per query key, -1 when absent (int32)."""
        idx = torch.searchsorted(self.keys, qkeys.contiguous())
        idx = idx.clamp_max(self.capacity - 1)
        hit = (self.keys[idx] == qkeys) & (qkeys != _SENTINEL)
        return torch.where(hit, idx, -1).to(torch.int32)

    def get(self, qkeys: torch.Tensor, default=0) -> torch.Tensor:
        idx = self.find(qkeys)
        val = self.values[idx.clamp_min(0).long()]
        miss = (idx < 0).reshape(idx.shape + (1,) * (val.dim() - idx.dim()))
        return torch.where(miss, torch.as_tensor(default, dtype=val.dtype,
                                                 device=val.device), val)

    def lower_bound(self, qkeys: torch.Tensor) -> torch.Tensor:
        return torch.searchsorted(self.keys, qkeys.contiguous()).to(
            torch.int32)

    def insert(self, new_keys: torch.Tensor,
               new_values: torch.Tensor) -> "OrderedMap":
        """Batch upsert: within the batch the last occurrence of a key
        wins, and a batch entry replaces an existing one.  Keys past the
        capacity are dropped."""
        cap = self.capacity
        m = new_keys.shape[0]
        dev = self.keys.device
        vshape = tuple(self.values.shape[1:])
        all_keys = torch.cat([self.keys, new_keys.to(torch.int32)])
        all_vals = torch.cat([self.values,
                              new_values.reshape((m,) + vshape).to(
                                  self.values.dtype)])
        live = torch.cat([self.mask,
                          torch.ones((m,), dtype=torch.bool, device=dev)])
        keys_m = torch.where(live, all_keys, _SENTINEL)
        # priority: existing 0, batch entry i 1 + i; sorted by key, then by
        # priority descending, the first of each run is the winner
        prio = torch.cat([torch.zeros((cap,), dtype=torch.int64, device=dev),
                          torch.arange(1, m + 1, device=dev)])
        order = torch.sort((keys_m.to(torch.int64) << 32) + (m - prio),
                           stable=True).indices
        sk, sv = keys_m[order], all_vals[order]
        first = torch.ones_like(sk, dtype=torch.bool)
        first[1:] = sk[1:] != sk[:-1]
        first &= sk != _SENTINEL
        rank = inclusive_scan(_POL, first.to(torch.int32)) - 1
        count = rank[-1] + 1
        dst = torch.where(first, rank.clamp_max(cap), cap).long()
        out_keys = torch.full((cap + 1,), _SENTINEL, dtype=torch.int32,
                              device=dev)
        out_keys[dst] = sk
        out_vals = torch.zeros((cap + 1,) + vshape, dtype=sv.dtype,
                               device=dev)
        out_vals[dst] = sv
        return OrderedMap(out_keys[:cap], out_vals[:cap],
                          count.clamp_max(cap).to(torch.int32))

    def erase(self, del_keys: torch.Tensor) -> "OrderedMap":
        cap = self.capacity
        hit = self.find(del_keys)
        kill = torch.zeros((cap + 1,), dtype=torch.bool,
                           device=self.keys.device)
        kill[torch.where(hit >= 0, hit, cap).long()] = True
        keep = self.mask & ~kill[:cap]
        keys_m = torch.where(keep, self.keys, _SENTINEL)
        sk, order = torch.sort(keys_m, stable=True)
        return OrderedMap(sk, self.values[order],
                          torch.count_nonzero(keep).to(torch.int32))


def ordered_map(capacity: int, value_shape=(), *, device: torch.device,
                value_dtype: torch.dtype = torch.float32) -> OrderedMap:
    return OrderedMap(
        torch.full((capacity,), _SENTINEL, dtype=torch.int32, device=device),
        torch.zeros((capacity,) + tuple(value_shape), dtype=value_dtype,
                    device=device),
        torch.zeros((), dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class RingBuffer:
    """Fixed-capacity FIFO; a push into a full buffer drops the oldest."""

    data: torch.Tensor     # [capacity, ...]
    head: torch.Tensor     # 0-d int32, the oldest entry
    size: torch.Tensor     # 0-d int32

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def push(self, value) -> "RingBuffer":
        cap = self.capacity
        tail = ((self.head + self.size) % cap).long().reshape(1)
        data = self.data.index_put((tail,), torch.as_tensor(
            value, dtype=self.data.dtype, device=self.data.device))
        full = self.size >= cap
        return RingBuffer(data,
                          torch.where(full, (self.head + 1) % cap,
                                      self.head),
                          (self.size + 1).clamp_max(cap))

    def pop(self) -> Tuple["RingBuffer", torch.Tensor]:
        val = self.data[self.head.long()]
        empty = self.size == 0
        return (RingBuffer(self.data,
                           torch.where(empty, self.head,
                                       (self.head + 1) % self.capacity),
                           (self.size - 1).clamp_min(0)), val)

    def peek(self, i) -> torch.Tensor:
        return self.data[((self.head + i) % self.capacity).long()]


def ring_buffer(capacity: int, item_shape=(), *, device: torch.device,
                dtype: torch.dtype = torch.float32) -> RingBuffer:
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return RingBuffer(torch.zeros((capacity,) + tuple(item_shape),
                                  dtype=dtype, device=device), zero, zero)
