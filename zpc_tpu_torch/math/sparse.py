"""Sparse matrices: static-capacity CSR built by sorting (counterpart of
``zpc_tpu/math/sparse.py``; the reference's ``SparseMatrix.hpp`` and
``SparseMatrixOperations.hpp``).

COO triplets are stable-sorted by the key ``row * ncols + col``, duplicates
merged by a segmented sum (or max), and the row pointers recovered from a
histogram and a prefix sum; every prefix sum goes through
:func:`~zpc_tpu_torch.parallel.primitives.inclusive_scan` (the scan kernel
on a CUDA tensor).  SpMV gathers ``x[cols]``, multiplies and segment-reduces
by row over padded row ids; semirings (plus-times, min-plus, max-plus,
min-times, max-times, or-and) back the graph algorithms.

Two deliberate differences from the JAX package, both faults there:

* the key is int64 whenever ``nrows * ncols`` exceeds 2^31 - 1.  The JAX
  package asks for int64 there too, but runs with 64-bit types off, so
  its key is int32 and wraps, and distinct entries can merge;
* or-and SpMV gives False on a row with no entries.  The JAX package
  reduces the or as an int32 ``segment_max``, whose empty segments are
  ``INT32_MIN``, which its cast to bool reads as True.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core.executor import Executor
from ..parallel.primitives import inclusive_scan

__all__ = ["CSRMatrix", "csr_from_coo", "spmv", "spmv_semiring", "spmv_mask",
           "csr_transpose", "spgemm", "SEMIRINGS"]

_POL = Executor()            # the scans run on their tensors' device


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """``indptr[nrows + 1]`` int32; ``cols``/``vals`` padded to the
    capacity, the padding lanes with ``cols = -1``; ``nnz`` a 0-d int32."""

    indptr: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    nnz: torch.Tensor
    nrows: int = 0
    ncols: int = 0

    @property
    def capacity(self) -> int:
        return self.cols.shape[0]

    @property
    def row_ids(self) -> torch.Tensor:
        """Row of each nnz lane (int32; padding lanes get ``nrows``)."""
        lane = torch.arange(self.capacity, dtype=torch.int32,
                            device=self.cols.device)
        r = torch.searchsorted(self.indptr, lane, right=True) - 1
        return torch.where(lane < self.nnz, r.to(torch.int32), self.nrows)

    def todense(self) -> torch.Tensor:
        d = torch.zeros((self.nrows, self.ncols), dtype=self.vals.dtype,
                        device=self.vals.device)
        rid = self.row_ids
        valid = rid < self.nrows
        r = torch.where(valid, rid, 0).long()
        c = torch.where(valid, self.cols, 0).long()
        v = torch.where(valid, self.vals, 0)
        return d.index_put_((r, c), v, accumulate=True)


def csr_from_coo(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 nrows: int, ncols: int,
                 valid: Optional[torch.Tensor] = None,
                 combine: str = "add") -> CSRMatrix:
    """CSR from COO triplets, duplicates merged by ``combine`` ("add" or
    "max"); capacity = ``len(rows)``."""
    if combine not in ("add", "max"):
        raise ValueError(combine)
    n = rows.shape[0]
    dev = rows.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    kdt = torch.int64 if nrows * ncols > 2 ** 31 - 1 else torch.int32
    key = rows.to(kdt) * ncols + cols.to(kdt)
    big = torch.iinfo(kdt).max
    key = torch.where(valid, key, big)
    skey, order = torch.sort(key, stable=True)
    svals = vals[order]
    live = skey != big
    neq = torch.ones((n,), dtype=torch.bool, device=dev)
    neq[1:] = skey[1:] != skey[:-1]
    neq &= live
    uid = inclusive_scan(_POL, neq.to(torch.int32)) - 1     # merged lane id
    nnz = uid[-1] + 1 if n else torch.zeros((), dtype=torch.int32,
                                            device=dev)
    seg = torch.where(live, uid, n).long()
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    if combine == "add":
        merged_vals = torch.zeros((n + 1,), dtype=vals.dtype, device=dev)
        merged_vals = merged_vals.index_add_(0, seg, svals)[:n]
    else:
        merged_vals = torch.full((n + 1,), float("-inf"), dtype=vals.dtype,
                                 device=dev)
        merged_vals.scatter_reduce_(0, seg, svals, reduce="amax",
                                    include_self=True)
        merged_vals = torch.where(lane < nnz, merged_vals[:n], 0)
    merged_key = torch.full((n + 1,), big, dtype=kdt, device=dev)
    merged_key[torch.where(neq, uid, n).long()] = skey
    merged_key = merged_key[:n]
    pad = lane >= nnz
    mcols = torch.where(pad, -1, (merged_key % ncols).to(torch.int32))
    mrows = torch.where(pad, nrows, (merged_key // ncols).to(torch.int32))
    # a row outside [0, nrows) counts in the dropped last slot, where the
    # JAX package's scatter drops it
    mrows = torch.where((mrows >= 0) & (mrows < nrows), mrows, nrows)
    counts = torch.zeros((nrows + 1,), dtype=torch.int32, device=dev)
    counts.index_add_(0, mrows.long(), torch.ones_like(mrows))
    indptr = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                        inclusive_scan(_POL, counts[:nrows])])
    return CSRMatrix(indptr, mcols, merged_vals, nnz.to(torch.int32), nrows,
                     ncols)


def csr_transpose(A: CSRMatrix) -> CSRMatrix:
    """Transpose by re-sorting on (col, row)."""
    rid = A.row_ids
    valid = rid < A.nrows
    return csr_from_coo(torch.where(valid, A.cols, 0),
                        torch.where(valid, rid, 0), A.vals, A.ncols, A.nrows,
                        valid=valid)


# -- semirings: (reduce op, map op, identity) ---------------------------------

SEMIRINGS: dict = {
    "plus_times": ("add", torch.mul, 0.0),
    "min_plus": ("min", torch.add, math.inf),
    "max_plus": ("max", torch.add, -math.inf),
    "min_times": ("min", torch.mul, math.inf),
    "max_times": ("max", torch.mul, -math.inf),
    "or_and": ("or", torch.logical_and, False),
}
_REDUCE_NAMES = {torch.add: "add", torch.minimum: "min",
                 torch.maximum: "max", torch.logical_or: "or"}


def _semiring(semiring):
    reduce_op, map_op, ident = SEMIRINGS[semiring] \
        if isinstance(semiring, str) else semiring
    return _REDUCE_NAMES.get(reduce_op, reduce_op), map_op, ident


def _row_reduce(prod: torch.Tensor, rid: torch.Tensor, nrows: int,
                name: str) -> torch.Tensor:
    """Per-row reduction of the lane products; padding lanes (row
    ``nrows``) fall in a dropped last row; a row with no lane is the op's
    identity."""
    rid = rid.long()
    if name == "add":
        out = torch.zeros((nrows + 1,), dtype=prod.dtype, device=prod.device)
        return out.index_add_(0, rid, prod)[:-1]
    if name == "or":
        out = torch.zeros((nrows + 1,), dtype=torch.int32,
                          device=prod.device)
        out.scatter_reduce_(0, rid, prod.to(torch.int32), reduce="amax",
                            include_self=True)
        return out[:-1].to(torch.bool)
    ident = math.inf if name == "min" else -math.inf
    if not prod.dtype.is_floating_point:
        info = torch.iinfo(prod.dtype)
        ident = info.max if name == "min" else info.min
    out = torch.full((nrows + 1,), ident, dtype=prod.dtype,
                     device=prod.device)
    out.scatter_reduce_(0, rid, prod, reduce="a" + name, include_self=True)
    return out[:-1]


def _gather(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    return x[cols.clamp_min(0).long()]


def spmv(A: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x (plus-times): one lane per nonzero, a segmented sum by row."""
    prod = torch.where(A.cols >= 0, A.vals * _gather(x, A.cols), 0)
    return _row_reduce(prod, A.row_ids, A.nrows, "add")


def spmv_semiring(A: CSRMatrix, x: torch.Tensor,
                  semiring="plus_times") -> torch.Tensor:
    """Semiring SpMV: ``reduce_j map(A_ij, x_j)``; a semiring is a name of
    :data:`SEMIRINGS` or a (reduce op, map op, identity) triple."""
    name, map_op, ident = _semiring(semiring)
    prod = map_op(A.vals, _gather(x, A.cols))
    prod = torch.where(A.cols >= 0, prod,
                       torch.as_tensor(ident, dtype=prod.dtype,
                                       device=prod.device))
    return _row_reduce(prod, A.row_ids, A.nrows, name)


def spmv_mask(A: CSRMatrix, x: torch.Tensor, mask: torch.Tensor,
              semiring="plus_times") -> torch.Tensor:
    """Masked semiring SpMV: entries whose column is masked off are
    skipped (frontier propagation)."""
    name, map_op, ident = _semiring(semiring)
    colm = _gather(mask, A.cols) & (A.cols >= 0)
    prod = map_op(A.vals, _gather(x, A.cols))
    prod = torch.where(colm, prod, torch.as_tensor(
        ident, dtype=prod.dtype, device=prod.device))
    return _row_reduce(prod, A.row_ids, A.nrows, name)


def spgemm(A: CSRMatrix, B: CSRMatrix, max_row_nnz_b: int,
           semiring="plus_times"):
    """C = A (x) B with each A entry fanned out against B's row, at most
    ``max_row_nnz_b`` entries of it; returns ``(C, overflow)``, overflow a
    0-d bool set when some row of B was truncated."""
    name, map_op, _ = _semiring(semiring)
    ridA = A.row_ids
    validA = ridA < A.nrows
    colA = A.cols.clamp_min(0)
    startB = B.indptr[colA.clamp(0, B.nrows - 1).long()]
    endB = B.indptr[(colA + 1).clamp(0, B.nrows).long()]
    overflow = torch.any(validA & (endB - startB > max_row_nnz_b))
    lane = torch.arange(max_row_nnz_b, dtype=torch.int32,
                        device=A.cols.device)
    pos = startB[:, None] + lane[None, :]
    ok = validA[:, None] & (pos < endB[:, None])
    safe = pos.clamp(0, B.capacity - 1).long()
    colsC = torch.where(ok, B.cols[safe], 0)
    valsC = map_op(A.vals[:, None], B.vals[safe])
    rowsC = ridA[:, None].expand(ok.shape)
    C = csr_from_coo(torch.where(ok, rowsC, 0).reshape(-1),
                     colsC.reshape(-1),
                     torch.where(ok, valsC, 0).reshape(-1),
                     A.nrows, B.ncols, valid=ok.reshape(-1),
                     combine="add" if name == "add" else "max")
    return C, overflow
