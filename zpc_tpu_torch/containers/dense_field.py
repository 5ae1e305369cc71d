"""``DenseField``: an N-d dense array with the reference's
``container/DenseField.hpp`` surface (counterpart of
``zpc_tpu/containers/dense_field.py``): named construction, ``f(i, j, k)``
access, flat views and explicit placement.  Updates return new fields."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["DenseField", "dense_field"]


@dataclasses.dataclass(frozen=True)
class DenseField:
    data: torch.Tensor

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def __getitem__(self, idx):
        return self.data[idx]

    def __call__(self, *idx):
        return self.data[idx]

    @property
    def flat(self) -> torch.Tensor:
        return self.data.reshape(-1)

    def set(self, idx, value) -> "DenseField":
        data = self.data.clone()
        data[idx] = value
        return DenseField(data)

    def fill(self, value) -> "DenseField":
        return DenseField(torch.full_like(self.data, value))

    def reshape(self, *shape) -> "DenseField":
        return DenseField(self.data.reshape(*shape))

    def to_device(self, device) -> "DenseField":
        return DenseField(self.data.to(device))


def dense_field(shape, *, device: torch.device,
                dtype: torch.dtype = torch.float32, fill=0) -> DenseField:
    return DenseField(torch.full(tuple(shape), fill, dtype=dtype,
                                 device=device))
