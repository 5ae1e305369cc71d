"""``BlockTable``: the sorted-key spatial hash of grid blocks (counterpart of
``zpc_tpu/containers/block_table.py``).

Block coordinates pack into one int32 key (10 bits per axis in 3-D, 15 in
2-D, offset so negative coordinates sort).  A table is the sorted, unique,
sentinel-padded list of active keys; queries are binary searches
(``torch.searchsorted``).  The build is sort, mark first-of-run, rank by a
prefix sum (the CUDA scan kernel for a CUDA tensor) and compact.
``count`` is exact even past ``capacity``, so ``count > capacity`` reports
an overflow.

:class:`WideBlockTable` keys 3-D blocks by a lexicographic pair of int32s
(``kx``, ``kyz``) for domains past the packed key's 1024^3 blocks; its
build sorts and queries the pair as one int64 ``kx * 2^32 + kyz`` (both
halves are non-negative), which orders as the pair does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.executor import Executor
from ..parallel.primitives import inclusive_scan

__all__ = ["KEY_SENTINEL", "pack_coords", "unpack_key", "BlockTable",
           "build_block_table", "build_overflowed", "pack_coords_wide",
           "unpack_key_wide", "WideBlockTable", "build_wide_block_table"]

KEY_SENTINEL = 2 ** 31 - 1

_BITS = {2: 15, 3: 10}
_POL = Executor()            # the scans run on their tensors' device


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
    rank = inclusive_scan(_POL, neq.to(torch.int32)) - 1   # unique slot per lane
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


# -- wide (dual-int32) keys: domains beyond 1024^3 blocks ---------------------

_YW_OFF = 1 << 14         # y in [-16384, 16384) blocks (15 bits, no sign)
_ZW_OFF = 1 << 15         # z in [-32768, 32768) blocks (16 bits)
_XW_OFF = 1 << 29         # x in [-2^29, 2^29) (never the sentinel)


def pack_coords_wide(coords: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-D block coords -> the lexicographic int32 pair (kx, kyz); kyz keeps
    its sign bit clear, so the pair sorts as two plain int32s."""
    kx = coords[..., 0].to(torch.int32) + _XW_OFF
    kyz = ((coords[..., 1].to(torch.int32) + _YW_OFF) << 16) | \
        (coords[..., 2].to(torch.int32) + _ZW_OFF)
    return kx, kyz


def unpack_key_wide(kx: torch.Tensor, kyz: torch.Tensor) -> torch.Tensor:
    x = kx - _XW_OFF
    y = ((kyz >> 16) & 0x7FFF) - _YW_OFF
    z = (kyz & 0xFFFF) - _ZW_OFF
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def _pair_key(kx: torch.Tensor, kyz: torch.Tensor) -> torch.Tensor:
    """The pair as one int64 with the pair's order."""
    return (kx.to(torch.int64) << 32) | kyz.to(torch.int64)


@dataclasses.dataclass(frozen=True)
class WideBlockTable:
    """The :class:`BlockTable` contract over (kx, kyz) keys (3-D only):
    both columns ascending lexicographically, ``KEY_SENTINEL``-padded."""

    kx: torch.Tensor      # [capacity] int32, major
    kyz: torch.Tensor     # [capacity] int32, minor
    count: torch.Tensor
    dim: int = 3

    @property
    def capacity(self) -> int:
        return self.kx.shape[0]

    @property
    def keys(self) -> torch.Tensor:
        """The major column, for shape-generic callers; a block's identity
        is the pair."""
        return self.kx

    @property
    def active_coords(self) -> torch.Tensor:
        return unpack_key_wide(self.kx, self.kyz)

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.kx.device) < \
            self.count

    def query(self, coords: torch.Tensor) -> torch.Tensor:
        """Slot per block coord ``[..., 3]``, -1 if absent (int32): the
        lower bound of the pair among the first ``count`` slots."""
        qkey = _pair_key(*pack_coords_wide(coords))
        lo = torch.searchsorted(_pair_key(self.kx, self.kyz),
                                qkey.contiguous())
        idx = lo.clamp_max(self.capacity - 1)
        hit = (self.kx[idx] == qkey >> 32) & \
            (self.kyz[idx] == (qkey & 0xFFFFFFFF)) & (lo < self.count)
        return torch.where(hit, idx, -1).to(torch.int32)


def build_wide_block_table(coords: torch.Tensor, capacity: int,
                           valid: Optional[torch.Tensor] = None
                           ) -> Tuple[WideBlockTable, torch.Tensor]:
    """Sort-based build over (kx, kyz) keys, with
    :func:`build_block_table`'s ``(table, inverse)`` contract."""
    n = coords.shape[0]
    dev = coords.device
    kx, kyz = pack_coords_wide(coords)
    if valid is not None:
        kx = torch.where(valid, kx, KEY_SENTINEL)
        kyz = torch.where(valid, kyz, KEY_SENTINEL)
    skey, order = torch.sort(_pair_key(kx, kyz), stable=True)
    sx = (skey >> 32).to(torch.int32)
    syz = (skey & 0xFFFFFFFF).to(torch.int32)
    neq = torch.ones((n,), dtype=torch.bool, device=dev)
    neq[1:] = skey[1:] != skey[:-1]
    neq &= sx != KEY_SENTINEL
    rank = inclusive_scan(_POL, neq.to(torch.int32)) - 1
    count = rank[-1] + 1 if n else torch.zeros((), dtype=torch.int32,
                                               device=dev)
    dst = torch.where(neq, rank, capacity).clamp(0, capacity).long()
    tx = torch.full((capacity + 1,), KEY_SENTINEL, dtype=torch.int32,
                    device=dev)
    tyz = tx.clone()
    tx[dst] = sx                              # overflow lanes land in the pad
    tyz[dst] = syz
    inverse = torch.empty((n,), dtype=torch.int32, device=dev)
    inverse[order] = torch.where(sx != KEY_SENTINEL, rank, -1)
    inverse = torch.where(inverse >= capacity, -1, inverse)
    return WideBlockTable(tx[:capacity], tyz[:capacity],
                          count.to(torch.int32), 3), inverse
