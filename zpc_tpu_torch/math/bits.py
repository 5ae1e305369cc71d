"""Bit tricks: morton codes, clz, power-of-two helpers.

Counterpart of ``zpc_tpu/math/bits.py``, bit for bit.  The JAX module
multiplies and shifts uint32 values and relies on their wrap mod 2^32;
PyTorch's ``uint32`` lacks most arithmetic on the CPU, so every function
here computes in int64 and masks with ``& 0xFFFFFFFF`` after each multiply
and left shift.  Results that the JAX module returns as int32 come back as
int32 (two's-complement wrap); :func:`expand_bits_3d` returns its uint32
value in an int64 tensor.
"""

from __future__ import annotations

import torch

__all__ = ["expand_bits_3d", "morton3d", "morton2d", "clz32",
           "common_prefix_length", "next_pow2", "to_int32"]

_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of an integer tensor, as int64."""
    return x.to(torch.int64) & _M32


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an integer tensor as int32 (two's complement),
    as ``astype(jnp.int32)`` of a uint32 value gives them."""
    x = x.to(torch.int64) & _M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def expand_bits_3d(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each
    (the classic magic-number dilation).  Returns int64 in [0, 2^30)."""
    v = _u32(v) & 0x3FF
    v = ((v * 0x00010001) & _M32) & 0xFF0000FF
    v = ((v * 0x00000101) & _M32) & 0x0F00F00F
    v = ((v * 0x00000011) & _M32) & 0xC30C30C3
    v = ((v * 0x00000005) & _M32) & 0x49249249
    return v


def morton3d(q: torch.Tensor) -> torch.Tensor:
    """30-bit morton code (int32) from integer coords ``[..., 3]`` in
    [0, 1024)."""
    x = expand_bits_3d(q[..., 0])
    y = expand_bits_3d(q[..., 1])
    z = expand_bits_3d(q[..., 2])
    return to_int32((x << 2) | (y << 1) | z)


def _expand_bits_2d(v: torch.Tensor) -> torch.Tensor:
    v = _u32(v) & 0xFFFF
    v = (v | ((v << 8) & _M32)) & 0x00FF00FF
    v = (v | ((v << 4) & _M32)) & 0x0F0F0F0F
    v = (v | ((v << 2) & _M32)) & 0x33333333
    v = (v | ((v << 1) & _M32)) & 0x55555555
    return v


def morton2d(q: torch.Tensor) -> torch.Tensor:
    """32-bit morton code (int32, wrapped) from integer coords ``[..., 2]``
    in [0, 65536)."""
    x = _expand_bits_2d(q[..., 0])
    y = _expand_bits_2d(q[..., 1])
    return to_int32(((x << 1) & _M32) | y)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of the uint32 pattern of ``x`` (int32 result,
    clz(0) = 32), by the JAX module's smear-and-popcount arithmetic."""
    x = _u32(x)
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    v = (x - ((x >> 1) & 0x55555555)) & _M32
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = ((((v + (v >> 4)) & 0x0F0F0F0F) * 0x01010101) & _M32) >> 24
    return (32 - v).to(torch.int32)


def common_prefix_length(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Length of the common binary prefix of two 32-bit keys (the Karras
    ``delta`` function)."""
    return clz32(_u32(a) ^ _u32(b))


def next_pow2(x: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= x (int32; wraps to 0 above 2^31, as the
    JAX module's uint32 arithmetic does)."""
    x = torch.clamp(_u32(x), min=1) - 1
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return to_int32(x + 1)
