"""Graph algorithms on CSR adjacency (counterpart of
``zpc_tpu/utils/graph.py``; the reference's ``graph/``).

* connected components: min-label propagation by min-times SpMV plus
  pointer jumping, for a fixed ``ceil(log2 n) + 2`` rounds as in the JAX
  package (label propagation stops short of the components on graphs of
  larger diameter);
* greedy colouring: Jones-Plassmann rounds, the local maximum of random
  priorities takes the smallest colour its coloured neighbours leave;
* max flow: Edmonds-Karp on the dense residual, a frontier BFS per
  augmentation.

The JAX package's ``lax`` loops become Python loops: the colouring and the
max flow read one flag on the host per round, the components none.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..math.sparse import CSRMatrix, spmv_semiring

__all__ = ["connected_components", "greedy_color", "max_flow"]


def connected_components(A: CSRMatrix,
                         max_rounds: Optional[int] = None) -> torch.Tensor:
    """Component label per vertex (the smallest vertex id of its component
    once the rounds have converged), int32."""
    n = A.nrows
    rounds = max_rounds or (int(math.ceil(math.log2(max(n, 2)))) + 2)
    aone = CSRMatrix(A.indptr, A.cols, torch.ones_like(A.vals), A.nnz,
                     A.nrows, A.ncols)
    L = torch.arange(n, dtype=torch.int32, device=A.cols.device)
    for _ in range(rounds):
        neigh = spmv_semiring(aone, L.to(torch.float32), "min_times")
        # a vertex with no neighbour finds +inf, which keeps its label (XLA
        # saturates the cast to INT32_MAX; PyTorch's cast is undefined)
        neigh = torch.where(torch.isfinite(neigh), neigh, L.to(torch.float32))
        L = torch.minimum(L, neigh.to(torch.int32))
        L = torch.minimum(L, L[L.clamp(0, n - 1).long()])   # pointer jumping
    return L


def greedy_color(A: CSRMatrix, gen: torch.Generator,
                 max_colors: int = 64) -> torch.Tensor:
    """Colour id per vertex (int32, -1 if still uncoloured after
    ``max_colors`` rounds).  The priorities are ``n`` uniform draws from
    ``gen`` on its own device, moved to the matrix's device, so a CPU
    generator gives the same colouring on every device."""
    n = A.nrows
    dev = A.cols.device
    prio = torch.rand((n,), generator=gen, device=gen.device).to(dev)
    rid = A.row_ids
    cols = A.cols.clamp_min(0).long()
    valid_e = A.cols >= 0
    seg = torch.where(valid_e, rid, n).long()
    colors = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for _ in range(max_colors):
        uncol = colors < 0
        if not bool(uncol.any()):
            break
        # the largest priority among each vertex's uncoloured neighbours
        pn = torch.where(valid_e & uncol[cols], prio[cols], -1.0)
        nmax = torch.full((n + 1,), -1.0, device=dev)
        nmax.scatter_reduce_(0, seg, pn, reduce="amax", include_self=True)
        winner = uncol & (prio > nmax[:n])
        # the smallest of 32 colours no coloured neighbour has
        ccol = colors[cols]
        taken = torch.zeros((n + 1, 32), dtype=torch.int32, device=dev)
        taken.index_put_((seg, ccol.clamp(0, 31).long()),
                         (valid_e & (ccol >= 0)).to(torch.int32),
                         accumulate=True)
        first_free = torch.argmin((taken[:n] > 0).to(torch.int32), dim=1)
        colors = torch.where(winner, first_free.to(torch.int32), colors)
    return colors


def _bfs_parents(R: torch.Tensor, source: int) -> torch.Tensor:
    """BFS tree over residual edges > 1e-9: each reached vertex's
    predecessor (the smallest id among the candidates), -1 elsewhere;
    ``n`` rounds, as in the JAX package."""
    n = R.shape[0]
    dev = R.device
    inf = n + 1
    dist = torch.full((n,), inf, dtype=torch.int32, device=dev)
    dist[source] = 0
    parent = torch.full((n,), -1, dtype=torch.int32, device=dev)
    parent[source] = source
    edge = R > 1e-9
    for _ in range(n):
        reach = dist < inf
        cand = reach[:, None] & edge & ~reach[None, :]
        has = cand.any(dim=0)
        pred = torch.argmax(cand.to(torch.int32), dim=0).to(torch.int32)
        parent = torch.where(has & (parent < 0), pred, parent)
        step = torch.where(cand, dist[:, None] + 1, inf).amin(dim=0)
        dist = torch.where(has & (dist == inf), step, dist)
    return parent


def max_flow(A_cap: CSRMatrix, source: int, sink: int,
             max_aug: Optional[int] = None) -> torch.Tensor:
    """Edmonds-Karp max flow of a capacity matrix (dense residual, for
    moderate n); returns the flow as a 0-d tensor."""
    n = A_cap.nrows
    R = A_cap.todense()
    flow = torch.zeros((), dtype=R.dtype, device=R.device)
    for _ in range(max_aug or 4 * n):
        parent = _bfs_parents(R, source)
        par = parent.tolist()
        if par[sink] < 0:
            break
        path, v = [], sink
        while v != source:
            path.append((par[v], v))
            v = par[v]
        u, w = (torch.tensor(c, dtype=torch.long, device=R.device)
                for c in zip(*path))
        bottleneck = R[u, w].min()
        R = R.index_put((u, w), -bottleneck.expand(len(path)),
                        accumulate=True)
        R = R.index_put((w, u), bottleneck.expand(len(path)),
                        accumulate=True)
        flow = flow + bottleneck
    return flow
