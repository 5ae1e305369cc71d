"""The contact broad phase of BASELINE config 5 as specified, port against
JAX, on the CPU: which bin windows reach the mesh, and which of them the
banded join cannot certify.

Run from the repository root:
    JAX_PLATFORMS=cpu python3 tools/contact_overflow.py [n]

Builds ``examples/mpm_block.build(n, dx=1/128)`` (default n = 65,536),
bins it with ``BinnedConfig2(bins_capacity=9216)`` (bench_implicit's bins
at 1M), and queries, for each mesh (the bench's heightfields of 2,048 and
100,352 triangles, ``benchmarks/run_all.py:_terrain_mesh``, and the
two-triangle floor at y = 0.57 that chip_smoke phase 16 uses), one
dhat-padded window per bin with ``MeshContact``'s parameters (dhat 0.01,
max_tris 8).  JAX's side repeats ``MeshContact.broad_phase``'s query to
read its counts and band flags, which the method folds into the flag; the
port's is ``MeshContact._bin_query``; a brute-force AABB test in numpy
says which live bins have a triangle in reach.  Prints one JSON object per
mesh: live bins, bins in reach, in reach but out of band, out of band,
truncated (more than max_tris candidates), the most candidates, and the
overflow flag, for both packages.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples.mpm_block import build  # noqa: E402
from zpc_tpu.containers.bvh import query_overlaps_sorted  # noqa: E402
from zpc_tpu.sim import mpm_binned2 as jb2  # noqa: E402
from zpc_tpu.sim.contact_implicit import MeshContact as JMesh  # noqa: E402
from zpc_tpu_torch import interop, scenes  # noqa: E402
from zpc_tpu_torch.sim import mpm_binned2 as tb2  # noqa: E402
from zpc_tpu_torch.sim.contact_implicit import MeshContact  # noqa: E402

DHAT, MAX_TRIS, BINS = 0.01, 8, 9216
CPU = torch.device("cpu")


def jax_query(mc, ctx, alive):
    """JAX's broad-phase query per bin: (live, counts, in_band), as
    ``MeshContact.broad_phase`` computes them before folding them into its
    flag."""
    B = alive.shape[0]
    f32 = jnp.float32
    live = jnp.any(alive, axis=1)
    half = 0.5 * (ctx.side - 1) * ctx.dx
    cen = ctx.borigin.astype(f32) * ctx.dx + ctx.origin_w + half
    ext = (half + mc.dhat) * (1.0 + 1e-5)
    nq = -(-B // mc.tile) * mc.tile
    pts = jnp.concatenate([jnp.where(live[:, None], cen, f32(1e9)),
                           jnp.full((nq - B, 3), 1e9, f32)])
    qid, _, counts, band = query_overlaps_sorted(
        mc.bvh, pts, pts, mc.max_tris, tile=mc.tile, uniform_extent=ext)
    cnt = jnp.zeros((nq,), jnp.int32).at[qid].set(counts)[:B]
    inb = jnp.zeros((nq,), bool).at[qid].set(band)[:B]
    return (np.asarray(live), np.asarray(cnt), np.asarray(inb),
            np.asarray(cen), float(ext))


def brute_reach(cen, ext, live, tri):
    """Live bins whose window box overlaps a triangle's box (numpy)."""
    lo, hi = tri.min(1), tri.max(1)
    reach = np.zeros(len(cen), bool)
    for b in np.flatnonzero(live):
        c = cen[b]
        reach[b] = np.any(np.all((lo <= c + ext) & (hi >= c - ext), -1))
    return reach


def summary(live, counts, band, reach):
    return dict(live=int(live.sum()), in_reach=int(reach.sum()),
                in_reach_out_of_band=int((reach & ~band).sum()),
                out_of_band=int((live & ~band).sum()),
                truncated=int((live & (counts > MAX_TRIS)).sum()),
                most_candidates=int(np.where(live, counts, 0).max()),
                overflow=bool((live & ((counts > MAX_TRIS) | ~band)).any()))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 65_536
    torch.set_num_threads(4)
    sim, st, _ = build(n, dx=1.0 / 128)
    cfg = jb2.BinnedConfig2(bins_capacity=BINS)
    bst = jax.jit(lambda s: jb2.bin_state(sim, s, cfg))(st)
    jctx = jb2._make_ctx3(bst, cfg)
    jalive = (bst.pid >= 0).reshape(BINS, jb2.K)
    tctx = tb2._make_ctx(interop.binstate_from_jax(bst, CPU),
                         interop.config_from_jax(cfg))
    talive = tctx.alive.view(BINS, tb2.K)
    meshes = {"terrain_32": scenes.terrain_mesh(32, CPU),
              "terrain_224": scenes.terrain_mesh(224, CPU),
              "floor_0.57": scenes.floor_mesh(0.57, 0.0, 1.0, CPU)}
    for name, tri in meshes.items():
        jm = JMesh.build(jnp.asarray(tri.numpy()), dhat=DHAT, kappa=10.0,
                         max_tris=MAX_TRIS)
        live, cnt, band, cen, ext = jax_query(jm, jctx, jalive)
        reach = brute_reach(cen, ext, live, tri.numpy())
        tm = MeshContact.build(tri, DHAT, 10.0, max_tris=MAX_TRIS)
        tl, _, tc, tb = (a.numpy() for a in tm._bin_query(tctx, talive))
        print(json.dumps({"mesh": name, "triangles": int(tri.shape[0]),
                          "particles": n, "bins": BINS,
                          "jax": summary(live, cnt, band, reach),
                          "port": summary(tl, tc, tb, reach)}), flush=True)


if __name__ == "__main__":
    main()
