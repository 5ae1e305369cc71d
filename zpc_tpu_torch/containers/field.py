"""``Field``: a padded capacity buffer with a live size (counterpart of
``zpc_tpu/containers/field.py``, the reference's ``zs::Vector``).

``data[capacity, *item_shape]`` holds the live entries at the front;
``size`` is a Python int.  Every mutation returns a new Field on a new
tensor, as the JAX package's functional updates do; ``resize`` grows the
capacity geometrically (the reference's ``Vector::resize``).  Placement is
explicit: :meth:`to_device` copies to the device it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["Field", "field"]


@dataclasses.dataclass(frozen=True)
class Field:
    data: torch.Tensor                        # [capacity, *item_shape]
    size: int = 0

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def item_shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __len__(self) -> int:
        return self.size

    @property
    def active(self) -> torch.Tensor:
        """The live prefix (a view)."""
        return self.data[: self.size]

    @property
    def mask(self) -> torch.Tensor:
        """Validity mask over the capacity's lanes."""
        return torch.arange(self.capacity, device=self.device) < self.size

    def __getitem__(self, idx):
        return self.data[idx]

    def set(self, idx, value) -> "Field":
        data = self.data.clone()
        data[idx] = value
        return dataclasses.replace(self, data=data)

    def fill(self, value) -> "Field":
        return dataclasses.replace(self, data=torch.full_like(self.data,
                                                              value))

    def resize(self, new_size: int, fill=0) -> "Field":
        """Set the live size; past the capacity, the capacity grows to
        ``max(new_size, 2 * capacity)`` (8 from empty), padded with
        ``fill``."""
        cap = self.capacity
        if new_size > cap:
            new_cap = max(new_size, 2 * cap if cap else 8)
            pad = torch.full((new_cap - cap,) + self.item_shape, fill,
                             dtype=self.dtype, device=self.device)
            return Field(torch.cat([self.data, pad]), new_size)
        return dataclasses.replace(self, size=new_size)

    def append(self, values: torch.Tensor) -> "Field":
        """Bulk ``push_back``."""
        n = values.shape[0]
        out = self.resize(self.size + n)
        data = out.data.clone()
        data[self.size:self.size + n] = values.to(self.dtype)
        return dataclasses.replace(out, data=data)

    def to_device(self, device) -> "Field":
        """A copy on ``device`` (the reference's ``clone(MemoryLocation)``)."""
        return dataclasses.replace(self, data=self.data.to(device))

    def to_host(self) -> np.ndarray:
        return self.data[: self.size].cpu().numpy()


def field(values=None, *, device: torch.device,
          capacity: Optional[int] = None, item_shape=(),
          dtype: torch.dtype = torch.float32, fill=0) -> Field:
    """A Field on ``device``: from ``values`` (size = their length, the
    capacity padded with ``fill``), or an empty buffer of ``capacity``."""
    if values is not None:
        values = torch.as_tensor(values, dtype=dtype, device=device)
        n = values.shape[0]
        cap = capacity or n
        if cap > n:
            pad = torch.full((cap - n,) + tuple(values.shape[1:]), fill,
                             dtype=dtype, device=device)
            values = torch.cat([values, pad])
        return Field(values, n)
    cap = capacity or 0
    return Field(torch.full((cap,) + tuple(item_shape), fill, dtype=dtype,
                            device=device), 0)
