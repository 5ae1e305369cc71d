"""Property vocabulary (counterpart of ``zpc_tpu/core/config.py``):
:class:`PropertyTag` and :func:`prop`, which declare the named multi-channel
properties of a structured field."""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

__all__ = ["PropertyTag", "prop"]


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


def prop(name: str,
         num_channels: Union[int, Tuple[int, ...]] = 1) -> PropertyTag:
    return PropertyTag(name, num_channels)
