"""``StructuredField``: named SoA particle channels (counterpart of
``zpc_tpu/containers/structured.py``).

A dict of tensors, one per property, each ``[capacity, *prop_shape]``, with
``size`` live entries at the front.  Only what the MPM state uses is here:
indexing by name, ``mask``, ``capacity``, ``update`` and ``has_prop``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import torch

from ..core.config import PropertyTag

__all__ = ["StructuredField", "structured_field"]


@dataclasses.dataclass(frozen=True)
class StructuredField:
    channels: Dict[str, torch.Tensor]
    size: int = 0

    @property
    def capacity(self) -> int:
        for v in self.channels.values():
            return v.shape[0]
        return 0

    @property
    def device(self) -> torch.device:
        return next(iter(self.channels.values())).device

    def has_prop(self, name: str) -> bool:
        return name in self.channels

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.size

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.channels[name]

    def update(self, **named_values: torch.Tensor) -> "StructuredField":
        ch = dict(self.channels)
        ch.update(named_values)
        return dataclasses.replace(self, channels=ch)


def structured_field(props: Sequence[PropertyTag], capacity: int, *,
                     device: torch.device, dtype=torch.float32,
                     data: Optional[Mapping[str, torch.Tensor]] = None,
                     size: Optional[int] = None) -> StructuredField:
    """Zero-initialised channels for ``props``; ``data`` fills the leading
    rows (its length is the default ``size``)."""
    ch: Dict[str, torch.Tensor] = {
        t.name: torch.zeros((capacity,) + t.shape, dtype=dtype, device=device)
        for t in props}
    n = 0
    for k, v in (data or {}).items():
        v = torch.as_tensor(v, device=device)
        if k in ch:
            v = v.to(ch[k].dtype)
        n = max(n, v.shape[0])
        if v.shape[0] < capacity:
            pad = torch.zeros((capacity - v.shape[0],) + tuple(v.shape[1:]),
                              dtype=v.dtype, device=device)
            v = torch.cat([v, pad])
        ch[k] = v
    return StructuredField(ch, size if size is not None else n)
