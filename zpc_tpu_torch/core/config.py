"""Property vocabulary (counterpart of ``zpc_tpu/core/config.py``):
:class:`MemSrc` and :class:`Layout` (the reference's ``memsrc_e`` and
``layout_e``, kept for API parity: memory is a ``torch.device`` here, and
every container is stored SoA), :class:`PropertyTag` and :func:`prop`, which
declare the named multi-channel properties of a structured field, and the
port's default dtypes (fp32 compute, int32 indices)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple, Union

import torch

__all__ = ["MemSrc", "Layout", "PropertyTag", "prop", "default_float",
           "default_int", "index_dtype"]

default_float = torch.float32
default_int = torch.int32
index_dtype = torch.int32


class MemSrc(enum.Enum):
    """Memory source (reference ``memsrc_e``): host is the CPU, device a
    CUDA device; unified memory aliases device."""

    host = "host"
    device = "device"
    um = "um"


class Layout(enum.Enum):
    """Storage layout (reference ``layout_e``); every container of the
    port is SoA."""

    aos = "aos"
    soa = "soa"
    aosoa = "aosoa"


@dataclasses.dataclass(frozen=True)
class PropertyTag:
    """Named property; ``num_channels`` is an int (flat channel count) or a
    shape tuple for tensor-valued properties (``(3, 3)`` for F)."""

    name: str
    num_channels: Union[int, Tuple[int, ...]] = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        if isinstance(self.num_channels, tuple):
            return self.num_channels
        if self.num_channels == 1:
            return ()
        return (int(self.num_channels),)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


def prop(name: str,
         num_channels: Union[int, Tuple[int, ...]] = 1) -> PropertyTag:
    return PropertyTag(name, num_channels)
