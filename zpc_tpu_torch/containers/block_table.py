"""``BlockTable``: the sorted-key spatial hash of grid blocks (counterpart of
``zpc_tpu/containers/block_table.py``).

Block coordinates pack into one int32 key (10 bits per axis in 3-D, 15 in
2-D, offset so negative coordinates sort).  A table is the sorted, unique,
sentinel-padded list of active keys; queries are binary searches
(``torch.searchsorted``).  The build is sort, mark first-of-run, rank by a
prefix sum (the CUDA scan kernel for a CUDA tensor) and compact.
``count`` is exact even past ``capacity``, so ``count > capacity`` reports
an overflow.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..parallel.primitives import inclusive_scan

__all__ = ["KEY_SENTINEL", "pack_coords", "unpack_key", "BlockTable",
           "build_block_table", "build_overflowed"]

KEY_SENTINEL = 2 ** 31 - 1

_BITS = {2: 15, 3: 10}


def _offset(dim: int) -> int:
    return 1 << (_BITS[dim] - 1)


def pack_coords(coords: torch.Tensor) -> torch.Tensor:
    """Integer block coords ``[..., dim]`` -> sortable int32 keys."""
    dim = coords.shape[-1]
    bits, off = _BITS[dim], _offset(dim)
    key = torch.zeros(coords.shape[:-1], dtype=torch.int32,
                      device=coords.device)
    for d in range(dim):
        key = (key << bits) | (coords[..., d].to(torch.int32) + off)
    return key


def unpack_key(key: torch.Tensor, dim: int) -> torch.Tensor:
    bits, off = _BITS[dim], _offset(dim)
    mask = (1 << bits) - 1
    comps = [((key >> (bits * (dim - 1 - d))) & mask) - off
             for d in range(dim)]
    return torch.stack(comps, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BlockTable:
    """``keys``: [capacity] int32, ascending, ``KEY_SENTINEL``-padded;
    ``count``: 0-d int32 tensor, the number of distinct active keys."""

    keys: torch.Tensor
    count: torch.Tensor
    dim: int = 3

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def active_coords(self) -> torch.Tensor:
        """Block coords per slot ``[capacity, dim]`` (garbage on sentinel
        slots: mask with :attr:`mask`)."""
        return unpack_key(self.keys, self.dim)

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.keys.device) < \
            self.count

    def query_keys(self, qkeys: torch.Tensor) -> torch.Tensor:
        """Slot per packed query key, -1 if absent (int32)."""
        idx = torch.searchsorted(self.keys, qkeys.contiguous())
        idx = idx.clamp_max(self.capacity - 1)
        hit = (self.keys[idx] == qkeys) & (qkeys != KEY_SENTINEL)
        return torch.where(hit, idx, -1).to(torch.int32)

    def query(self, coords: torch.Tensor) -> torch.Tensor:
        """Slot per block coord ``[..., dim]``, -1 if absent."""
        return self.query_keys(pack_coords(coords))


def build_block_table(coords: torch.Tensor, capacity: int,
                      valid: Optional[torch.Tensor] = None,
                      dim: Optional[int] = None
                      ) -> Tuple[BlockTable, torch.Tensor]:
    """Table from (possibly duplicated) candidate coords ``[n, dim]``.

    Returns ``(table, inverse)``: ``inverse[i]`` is the slot of
    ``coords[i]``, -1 for invalid lanes and for keys past ``capacity``.
    """
    dim = dim if dim is not None else coords.shape[-1]
    n = coords.shape[0]
    dev = coords.device
    keys = pack_coords(coords)
    if valid is not None:
        keys = torch.where(valid, keys, KEY_SENTINEL)
    skeys, order = torch.sort(keys, stable=True)
    neq = torch.ones_like(skeys, dtype=torch.bool)
    neq[1:] = skeys[1:] != skeys[:-1]
    neq &= skeys != KEY_SENTINEL
    rank = inclusive_scan(neq.to(torch.int32)) - 1   # unique slot per lane
    count = rank[-1] + 1 if n else torch.zeros((), dtype=torch.int32,
                                               device=dev)
    dst = torch.where(neq, rank, capacity).clamp(0, capacity).long()
    table_keys = torch.full((capacity + 1,), KEY_SENTINEL, dtype=torch.int32,
                            device=dev)
    table_keys[dst] = skeys                 # overflow lanes land in the pad
    inverse = torch.empty((n,), dtype=torch.int32, device=dev)
    inverse[order] = torch.where(skeys != KEY_SENTINEL, rank, -1)
    inverse = torch.where(inverse >= capacity, -1, inverse)
    return BlockTable(table_keys[:capacity], count.to(torch.int32),
                      dim), inverse


def build_overflowed(table: BlockTable) -> torch.Tensor:
    """True when the last build found more keys than ``capacity``."""
    return table.count > table.capacity
