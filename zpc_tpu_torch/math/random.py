"""Random sampling, probability helpers and integer hashes (counterpart of
``zpc_tpu/math/random.py``; the reference's ``RandomNumber.hpp``,
``probability/`` and ``Hash.hpp``).

The hashes are the JAX module's uint32 arithmetic, bit for bit: computed in
int64 and masked to 32 bits after each step (``torch.uint32`` lacks shifts
and products), ``universal_hash``'s product split into 16-bit halves so it
never leaves int64.  The samplers draw from an explicit
``torch.Generator`` on the device they sample on; a ``jax.random`` stream
cannot be reproduced, so they agree with the JAX module in distribution,
not draw for draw.
"""

from __future__ import annotations

import math

import torch

from ..core.executor import Executor
from ..parallel.primitives import inclusive_scan
from .bits import to_int32

__all__ = ["hash_combine", "int_hash", "int_unhash", "universal_hash",
           "sample_uniform_sphere", "sample_uniform_ball",
           "sample_normal", "pdf_normal", "cdf_normal", "erf_inv",
           "sample_categorical"]

_M32 = 0xFFFFFFFF
_POL = Executor()            # the scans run on their tensors' device


def _u32(x) -> torch.Tensor:
    """The uint32 value of an integer tensor or Python int, as int64 (a
    negative int32 wraps, as ``astype(jnp.uint32)`` does; a uint32 tensor
    is read through its int32 view)."""
    x = torch.as_tensor(x)
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & _M32


def hash_combine(seed, value) -> torch.Tensor:
    """boost-style ``hash_combine`` on uint32 lanes (returns uint32)."""
    s, v = _u32(seed), _u32(value)
    mix = (v + 0x9E3779B9 + ((s << 6) & _M32) + (s >> 2)) & _M32
    return to_int32(s ^ mix).view(torch.uint32)


def _mix(x, c: int) -> torch.Tensor:
    x = _u32(x)
    x = (((x >> 16) ^ x) * c) & _M32
    x = (((x >> 16) ^ x) * c) & _M32
    return to_int32((x >> 16) ^ x)


def int_hash(x) -> torch.Tensor:
    """Invertible 32-bit mix (``Hash.hpp`` ``hash``), as int32."""
    return _mix(x, 0x45D9F3B)


def int_unhash(x) -> torch.Tensor:
    """Inverse of :func:`int_hash`."""
    return _mix(x, 0x119DE1F3)


def universal_hash(x, a, b, m) -> torch.Tensor:
    """Carter-Wegman universal hash ``((a x + b) mod 2^32 >> 1) mod m``,
    as int32."""
    x, a, b, m = _u32(x), _u32(a), _u32(b), _u32(m)
    lo = a * (x & 0xFFFF)                            # < 2^48
    hi = ((a * (x >> 16)) & 0xFFFF) << 16            # (a x_hi 2^16) mod 2^32
    ax_b = (lo + hi + b) & _M32
    return to_int32((ax_b >> 1) % m)


def sample_uniform_sphere(gen: torch.Generator, shape=()) -> torch.Tensor:
    """Uniform on the unit sphere, ``[*shape, 3]`` on ``gen``'s device."""
    v = torch.randn(tuple(shape) + (3,), generator=gen, device=gen.device)
    return v / torch.linalg.vector_norm(v, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def sample_uniform_ball(gen: torch.Generator, shape=()) -> torch.Tensor:
    d = sample_uniform_sphere(gen, shape)
    r = torch.rand(tuple(shape) + (1,), generator=gen,
                   device=gen.device) ** (1.0 / 3.0)
    return d * r


def sample_normal(gen: torch.Generator, shape=(), mean=0.0,
                  std=1.0) -> torch.Tensor:
    return mean + std * torch.randn(tuple(shape), generator=gen,
                                    device=gen.device)


def pdf_normal(x: torch.Tensor, mean=0.0, std=1.0) -> torch.Tensor:
    z = (x - mean) / std
    return torch.exp(-0.5 * z * z) / (std * math.sqrt(2.0 * math.pi))


def cdf_normal(x: torch.Tensor, mean=0.0, std=1.0) -> torch.Tensor:
    return 0.5 * (1.0 + torch.special.erf((x - mean) /
                                          (std * math.sqrt(2.0))))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    return torch.special.erfinv(x)


def sample_categorical(gen: torch.Generator, probs: torch.Tensor,
                       shape=()) -> torch.Tensor:
    """Inverse-CDF draws of category ids (int32) from unnormalised
    ``probs``; the CDF's prefix sum is the scan kernel's on a CUDA tensor."""
    cdf = inclusive_scan(_POL, probs)
    cdf = cdf / cdf[-1]
    u = torch.rand(tuple(shape), generator=gen, device=probs.device)
    return torch.searchsorted(cdf, u).to(torch.int32)
