"""Parallel primitives: scans.

Counterpart of the scans in ``zpc_tpu/parallel/primitives.py:167-201``.
The JAX package routes large add/max/min scans to its Pallas kernel on an
accelerator; here every scan of a CUDA tensor goes to the CUDA kernel at
any size, and a CPU tensor to the kernel's plain version
(:mod:`zpc_tpu_torch.ops.scan`).  The op set and the ``init`` rule are the
JAX package's.
"""

from __future__ import annotations

import torch

from ..ops.scan import scan

__all__ = ["monoid_identity", "inclusive_scan", "exclusive_scan"]

_NAMES = {"add": "add", "sum": "add", "max": "max", "min": "min"}


def _resolve_op(op: str) -> str:
    if op not in _NAMES:
        raise ValueError(
            f"scan op must be one of {sorted(_NAMES)}, got {op!r}")
    return _NAMES[op]


def monoid_identity(op: str, dtype: torch.dtype):
    """Identity of ``op`` at ``dtype``: 0 for add; +-inf or the integer
    limits for min/max (``zs::monoid``)."""
    op = _resolve_op(op)
    if op == "add":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def inclusive_scan(x: torch.Tensor, op: str = "add") -> torch.Tensor:
    """Inclusive scan of a 1-D tensor (ExecutionPolicy.hpp:247-255)."""
    op = _resolve_op(op)
    if x.numel() == 0:
        return x.clone()
    return scan(x, op)


def exclusive_scan(x: torch.Tensor, op: str = "add",
                   init=None) -> torch.Tensor:
    """Exclusive scan (ExecutionPolicy.hpp:256-266).

    As in the JAX package, ``init`` (default: the op's identity) is placed
    at position 0 and the rest is the inclusive scan shifted by one; it is
    not folded into the later elements.
    """
    op = _resolve_op(op)
    if init is None:
        init = monoid_identity(op, x.dtype)
    if x.numel() == 0:
        return x.clone()
    if op == "add" and not bool(torch.as_tensor(init)):
        return scan(x, "add", exclusive=True)
    out = torch.roll(scan(x, op), 1)
    out[0] = init
    return out
