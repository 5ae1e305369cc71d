"""In-band fraction of the decomposed banded join, port against JAX, on
the CPU.

Run from the repository root:
    JAX_PLATFORMS=cpu python3 tools/lbvh_inband.py [n ...]

For each n (default 65,536, 262,144 and 524,288) it builds the LBVH over
the first n boxes of the ``bench_bvh`` scene (``scenes.lbvh_boxes``) and
runs the counts-only c8 query with the scene's uniform extent (0.006),
tile 128, group 512, in both packages on the same tree.  A query is in band
when every one of its cell entries is.  The two differ only in the order
of entries with equal interval starts: JAX sorts them unstably, the port
puts empty entries first (``containers/bvh.py:query_overlaps_sorted``).
Prints one JSON object per n.  Keep n at half a million or below here: the
JAX side holds several GB at that size.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from zpc_tpu.containers import bvh as jbvh  # noqa: E402
from zpc_tpu_torch import interop, scenes  # noqa: E402
from zpc_tpu_torch.containers import bvh as tbvh  # noqa: E402

KW = dict(tile=128, group=512, extract="none", decompose=True, cells=8,
          uniform_extent=0.006)


def inband(n):
    lo, hi, c = scenes.lbvh_boxes(n, torch.device("cpu"))
    jt = jax.jit(jbvh.build_lbvh)(jnp.asarray(lo.numpy()),
                                  jnp.asarray(hi.numpy()))
    qid, _, _, band = tbvh.query_overlaps_sorted(
        interop.lbvh_from_jax(jt, torch.device("cpu")), c, c, 16, **KW)
    port = torch.ones(n, dtype=torch.int32).scatter_reduce(
        0, qid.long(), band.to(torch.int32), "amin")
    jq, _, _, jb = jax.jit(lambda b, x: jbvh.query_overlaps_sorted(
        b, x, x, 16, **KW))(jt, jnp.asarray(c.numpy()))
    ref = jnp.ones((n,), bool).at[jq].min(jb)
    return dict(n=n, port=port.float().mean().item(),
                jax=float(ref.astype(jnp.float32).mean()))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for n in [int(a) for a in sys.argv[1:]] or [65_536, 262_144, 524_288]:
        print(json.dumps(inband(n)), flush=True)
