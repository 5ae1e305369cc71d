"""Smoke run of the PyTorch/CUDA port (zpc_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Thirteen paths run at full width: the explicit-MPM elastic block, the LBVH
broad phase with its query family, the weakly compressible dam break and
its surface, the implicit-MPM block
(BASELINE config 5 without contact), the same block over a mesh with IPC
contact (config 5 as specified, over a two-triangle floor and over the
bench's two heightfields), the README's Quick start through ``Scene`` and
``simulate`` with bgeo frames and checkpoints, examples/mpm2d.py's
discs in 2-D at a user's scale, the bench's two-layer self-contact cloth
at 8,192 and 131,072 vertices, a 33^3 tet FEM block and ray and nearest
queries over config 5's 100,352-triangle heightfield, the README scene
again over an adaptive-grid ground, examples/mpm_block.py's steps with
the port's timers, trace, .vdb export and host ops, and its sharded and
domain-decomposed steps on one NCCL rank; the four
materials of examples/materials.py run at their own size, the CG Poisson
solve of
BASELINE config 2 at its bench size, the parallel primitives of BASELINE
config 1 through the top-level API at 1M and 16M elements, and the
containers, sparse grid, CSR and graph algorithms built on them at the
sizes their users hold on a card.  Phases (each prints its
results; a failed check raises and the script exits non-zero; nothing is
caught):

1. environment: torch and CUDA versions, the card's name and power limit;
   fails when no CUDA device is visible;
2. build: compiles the CUDA kernels from csrc/ with nvcc (sm_90a; the
   mesh barrier with -fmad=false), one nvcc per source, all started
   together, and prints each kernel's
   registers, shared memory and spills as ptxas reports them;
3. kernel against plain: the scan kernel against its plain PyTorch version
   on the card, every dtype and op, n from 1 to 16M + 7 (the main path's
   sizes and the tile edges included); the look-back under stress (calls
   back to back, views that are not 16-byte aligned, two streams at once,
   the epoch's wrap, over stale statuses); then, at 327,680 and
   16,777,223, the device time per call from torch.profiler, the CUDA
   kernels each call launches (must be 1) and the back-to-back time per
   call, beside torch.cumsum's;
3b. the same for the NSE kernel: g from 1 to 2^24 - 1, both directions,
   random and adversarial values, exact; the same stress; the split at
   g = 1,048,575;
4. main path at full width: the 262,144-particle elastic block
   (dx = 1/128), bin_state, a 720-step adaptive_chain with
   BinnedConfig2(bins_capacity=2560, block_capacity=2048) and one rebin of
   the final state, with the scan launch counts and physics checks; every
   scan the path launched is replayed against the plain version on the
   same input, and the rebin is held integer-exact against the CPU's;
5. card against CPU: the same port on a small scene (4096 particles,
   dx = 1/32) for 240 steps, past its first rebin, on CUDA and on the CPU;
6. the first number: particle-steps/s of the 720-step chain, best of 3,
   and the cost of one step (with and without the per-step flag read),
   one rebin and one bin_state;
7. LBVH path at full width: the 1,048,576-box scene of bench_bvh,
   build_lbvh (2 NSE launches, both replayed against the plain version,
   the tree equal to the CPU port's integer for integer) and
   query_overlaps_exact at c8 with the scene's uniform extent (the
   in-band fraction and residue walk printed, no overflow; 2,048 sampled
   queries against a brute force on the card);
8. LBVH card against CPU at 65,536 boxes: both builds, the masked build,
   the plain-band, decomposed and exact queries and the escape walk,
   integer for integer;
9. LBVH numbers at 1M: build and its layers, topology alone,
   complete-tree build, escape walk, exact query and its join, and the
   counts-only sorted query;
10. dam break at full width: the 262,144-particle scene of bench_fluid
   (bins derived from n), bin_fluid_state, 100 warm-up steps, the bench's
   window of 20 steps best of 3 (ms/step and particle-steps/s), then the
   collapse on until 3 rebins have fired in the chain (or 3,000 steps),
   each rebin timed; every scan replayed against the plain version; the
   gates: no overflow, finite columns, particle mass unchanged, grid mass
   within 1e-4, J >= j_clamp, every particle in the tank within 3 cells,
   a rebin of the final state equal to the CPU's, at least one rebin;
11. fluid card against CPU: the 4,096-particle dam break for 240 steps on
   CUDA and on the CPU (needs_rebin history, x, v, J);
12. materials: jello, snow, sand (elastic binned path, the plastic ones
   with the Jp column) and fluid (fluid_binned2) at 32,768 particles for
   200 steps each, with the gates of tests/test_materials.py; snow
   pre-compressed at 4,096 particles for 50 steps on the card against the
   CPU (x, F, Jp within 1e-5 plus the CPU's own spread over summation
   order), and Jp must move;
13. implicit block at full width: the 1,000,000-particle scene of
   bench_implicit (dx = 1/128, dt 5e-4, BinnedConfig2(bins_capacity=9216,
   block_capacity=8192)), bin_state, one implicit_step_binned2 with its
   CG iteration count (beside the TPU's 4, a check, not a gate), a
   10-step adaptive_chain (cg_iters 50, cg_tol 1e-3) and one rebin of the
   final state, every scan replayed against the plain version; the gates:
   no overflow, finite columns, particle mass unchanged, grid mass within
   1e-4, mean v_y within 1% of free fall, one operator kernel launch
   (csrc/implicit_apply.cu) an application, CG iterations + 1 a step;
   then the chain best of 3 (ms/step, particle-steps/s, CG iterations per
   step);
14. implicit card against CPU: phase 5's small scene for 20 implicit
   steps on CUDA and on the CPU (CG iterations per step equal within 1;
   x, v, F within 1e-6, 5e-4, 1e-5 plus the CPU's own spread over
   summation order; one operator kernel launch an application on the
   card, none on the CPU);
15. CG Poisson: 100 iterations at 32^3 on the card against the CPU
   (within 1e-5 of max |x|), then at 128^3 timed (best of 3): ms,
   iterations/s and GB/s under bench_poisson's byte model;
16. contact at full width: phase 13's block over a two-triangle floor at
   y = 0.57 spanning [0, 1]^2 with MeshContact.build(dhat=0.01,
   kappa=10.0, max_tris=8) (bench_implicit's values), bin_state, one step
   with its CG count, a 10-step adaptive_chain and one rebin, every scan
   replayed; the gates: no overflow, finite columns, particle mass
   unchanged, grid mass within 1e-4, the broad phase's hits, counts and
   band flags equal to the CPU port's on the same bin state, the mean v_y
   of the particles within dhat of the floor after one step above the
   contact-free step's, no particle below the floor, one mesh barrier
   launch a step with contact and none without, one operator kernel
   launch an application with and without; then the chain best of 3
   beside phase 13's;
17. BASELINE config 5's contact rows at the benchmark's settings: the
   bench's heightfields of 2,048 and 100,352 triangles under the same
   block, with max_tris 32 and 648 and the join's tile 3072
   (portbench/configs/implicit_block_1m*.json), each gated on no overflow
   (no live bin truncated or out of band, the flag equal to the CPU
   port's on the same bin state, and unset after one step), finite
   columns and mass; CG iterations and ms/step best of 3 of a 10-step
   chain, with one mesh barrier launch a step and one operator kernel
   launch an application; then the mesh barrier
   kernel (csrc/mesh_barrier.cu) replayed against its plain version on
   the CPU on the row's first contact set (the work counts equal; forces
   and Hessians within (2 n + 16) 2^-24 of each entry's sum of term
   magnitudes over the lane's n candidates: the sums' order), the plain
   version on the card's widest gaps printed, and the kernel's device
   time and back-to-back time per call beside the plain version's on the
   card and the least time the benchmark's roofline counts;
17b. the implicit operator kernel (csrc/implicit_apply.cu) at the cells'
   shape: phase 13's block over the 2,048-triangle terrain, three steps
   (one kernel launch an application, CG iterations + 1 a step), then on
   the state they reach, without and with the barrier's Hessian, the
   kernel and the plain version (float32, on the card) each within 1e-5
   of the largest stiffness entry of the plain version in float64, the
   kernel's device time and back-to-back time per call beside the plain
   version's, the composition's it replaced (G2P, the jvp, P2G) and the
   least time at the card's published peaks;
18. contact card against CPU: tests/test_contact_implicit.py's 100-step
   scene (512 particles, dx 0.05, 96 bins, floor at 0.2, dhat 0.02, kappa
   2e4, max_tris 4, use_ccd, dt 2e-3) for 20 steps, then one
   contact_precond step, on CUDA and on the CPU (CG iterations equal
   within 1; x, v, F within phase 14's tolerances plus the CPU's own
   spread over summation order; no particle below floor - dhat; one mesh
   barrier launch a step and one operator kernel launch an application on
   the card, none on the CPU);
19. BASELINE config 1 through ``zpc_tpu_torch.tpu_exec()`` at 1,048,576
   and 16,777,216 elements (``default_rng(0)``): reduce (f32 add, int32
   add, min, max), both scans (f32, int32), sort and radix_sort (full
   width and bits [4, 20)), sort_pair packed and unpacked,
   radix_sort_pair on a 30-bit window, merge_sort_pair, argsort_stable,
   histogram at 256 and 65,536 bins, segment_reduce, select_if and
   unique, and the uint32 forms at 1M; each held against the CPU port on
   the same input (integers and permutations exact, the unpacked pair
   sort's pairs as a multiset, f32 within 1e-5 of the sum of |terms|),
   every scan replayed against the plain version; then reduce, exclusive
   scan and radix sort at both sizes timed (best of 3 between CUDA
   events, device time from torch.profiler) beside torch.sum,
   torch.cumsum and torch.sort and the byte bound at 3.35 TB/s;
20. the containers on the card against the CPU port: an OrderedMap of
   2,097,152 slots (1,048,576 inserts with duplicates, 65,536 finds,
   gets and erases), IndexBuckets of 1,048,576 points at dx = 1/128 with
   65,536 neighbourhoods, a wide-key block table over 1,310,720 far
   coordinates, a wide-key sparse grid's activation, sample and
   sample_gradient at 262,144 points, csr_from_coo of the 64^3 7-point
   Laplacian from triplets with duplicates with spmv and min-plus spmv
   (timed best of 3), connected_components and greedy_color on its
   adjacency, max_flow on 64 vertices, and one csr_from_coo at 70,000 x
   70,000 (int64 keys) held to numpy; every scan replayed;
21. the README's Quick start at full width: ``Scene(dx=1/128)
   .add_cube([0.5, 0.6, 0.5], 0.25, E=5e4)`` over a sticky ground at
   y = 0.05 (262,144 particles, dt from ``suggest_dt``), the README's loop
   of 100 unbinned ``explicit_step``s (ms/step), then ``simulate`` for
   1,000 binned2 steps with a bgeo frame every 100 and a checkpoint every
   500; gated: 10 frames read back equal to the state ``on_frame`` saw,
   the checkpoint reloaded bit for bit, finite channels, particle mass
   unchanged, no particle below y = 0.05 - dx, at least one rebin after
   the impact near step 770 (counted from the scan launches beyond each
   segment's 4 in ``bin_state``), every scan replayed; then ms/step and
   particle-steps/s of the same ``simulate`` with and without the IO;
22. the same scene at dx = 1/32 with an ``add_sphere`` ball (5,187
   particles), 240 steps through ``simulate`` on CUDA and on the CPU (x, v,
   F within 1e-5, 2e-4, 1e-5 plus the CPU's own spread over summation
   order);
23. examples/mpm2d.py at its defaults (8,192 draws, dx = 1/128, dt =
   1e-4, a slip ground at y = 0.1 with friction 0.2, the example's bins):
   200 unbinned steps and one 3,000-step binned rollout (past the impact
   near step 2,860, so the 2-D rebin runs), card against CPU as phase 22;
24. the same discs at a user's scale: 327,680 draws (257,635 particles)
   at dx = 1/1024, dt 5e-5, ``block_capacity`` 8,192 and the example's
   bins, one 6,000-step chain (impact near step 5,700), ms/step and
   particle-steps/s; gated: rebins, no overflow, mass, finite columns, no
   particle below y = 0.1 - dx - 1e-3, every scan replayed;
25. the rest of the family at its JAX tests' sizes, card against CPU: the
   2-D fluid unbinned and binned, the 2-D implicit step on a strained F,
   the cubic-B-spline step, and phase 5's block falling onto a tilted,
   spinning slab (a ``TransformedLevelSet`` collider, slip);
26. the incremental rebin: phase 21's scene through ``adaptive_chain(
   explicit_step_binned2, rebin_adaptive)`` for 1,000 steps with
   ``migrate_capacity`` 8,192 and one reserve bin per block (as
   benchmarks/probe_fluid_cost.py sets them, at 4,096 bins: its 3,072
   cannot hold the scene's reserve bins), then with ``migrate_capacity``
   n / 2, then with full rebins only; migrations, full rebins and the
   particles each rebin had to move printed; the first two migrations
   equal to the CPU port's (pid, bin_block, columns exact), the chain
   with migrations within the tolerances (plus twice the spread between
   the other two) of the one with full rebins, ms per migration beside
   ms per full rebin;
27. the hinge and tight-CCD kernels card against CPU: angle and gradient
   of 1,048,576 seeded hinges, the Hessians of 65,536 of them (within
   2e-6, and 1e-5 of the largest entry), and 65,536 vertex-face and
   65,536 edge-edge tight-CCD queries (toi, overflowed and iterations
   equal), with their times;
28. examples/cloth_drape.py at its defaults (24 x 24, 40 frames x 4
   substeps of dt 0.008), pinned and free: ms per frame; gated: the
   pinned corners fixed to 1e-6, no vertex below the ground in any step,
   the first 8 steps card against CPU (rtol 3e-4, atol 5e-6);
29. the bench's two-layer cloth (benchmarks/run_all.py bench_cloth) at
   8,192 vertices: 40 window steps to settle, then chains of 10 window
   and 10 dense steps, best of 3: ms/step and M vert-steps/s, CG
   iterations per Newton round; gated: the candidate set after settling
   not overflowed (certified), the window residue within its budget (the
   bench's 1,024 overflows: ROADMAP §3), no timed step flagged, every
   inner vertex of layer B above layer A, 3 steps card against CPU;
30. the same at 131,072 vertices (bench_cloth_128k): 20 window steps,
   then 5 timed, one step card against CPU;
31. tet FEM: the hanging NeoHookean block of tests/test_fem.py at 33^3
   vertices (163,840 tets), 40 steps: ms/step; gated: the pinned row
   fixed, the block sags and settles; tests/test_fem.py's drop above the
   ground; the 3 x 5 x 3 box, NeoHookean and FixedCorotated, 5 steps
   card against CPU.

32. the LBVH query family on phase 7's tree (bench_bvh's query boxes,
   the boxes grown by 0.004): every extraction (peel, bitpeel, topk,
   scan, none) at tile 256, group 32 and 16 and 8 hits, plain and
   decomposed c8, each equal to peel; 2,048 sampled c8 queries against a
   brute force; the c8 join under bench_bvh's compact budget (0.4 x nq x
   8, flagged iff the live cells exceed it) and under the live count,
   equal to the uncompacted join where both certify a query;
   query_nearest_sorted of the 1,048,576 queries c + 0.001 against the
   point primitives c, query_nearest on the out-of-band residue, 2,048
   sampled against a brute force (distances equal, ties accepted);
   BvttFront.rebuild at 65,536 queries (the scan kernel) and refresh
   after a move, against a brute force; build_bvs/bvs_query at 65,536
   boxes with a window no query overflows, every count equal to the
   exact LBVH query's; each timed (CUDA events, mean of 5; the residue
   walk, launch-bound, once; of the extractions peel and none, the
   others being one code path with peel); every scan and NSE sweep the
   counted calls launch (the front's compaction, the Bvs check's
   build_lbvh) replayed against the plain version on its own input;
33. mesh queries on config 5's large heightfield
   (``scenes.terrain_trimesh(224)``, 100,352 triangles): mesh_aabbs ->
   build_lbvh (2 NSE launches, each replayed against the plain version),
   query_ray of 1,048,576 downward rays from
   y = 1 (ray_triangle_intersection) and query_nearest of 1,048,576
   points in [0, 1] x [0.5, 0.62] x [0, 1] (sqrt of
   point_triangle_dist2), 2,048 of each against a brute force over every
   triangle (within 1e-5, either triangle at a shared edge); ms, Mq/s and
   walk steps; tet_surface of phase 31's 33^3 mesh (12,288 faces) and its
   volumes (the box's);
34. the surface of phase 10's final dam-break state (262,144 particles,
   dx = 1/128) as examples/dam_break.py makes it:
   levelset_from_points(radius 1.5 dx) -> flood_fill ->
   surface_from_levelset(iso 1.2 dx), the block table and the soup sized
   from the host counts (neither overflows), the block activation's
   scans replayed against the plain version; gated: watertight (every
   edge of two triangles once corners within 1e-4 dx are welded),
   normals out of the fluid, write_obj/read_obj exact, and a 1/8
   subsample's table, SDF and soup on the card equal to the CPU port's
   bit for bit (the CPU side in a worker beside phases 22-23);
35. robust geometry card against CPU: the four predicates on 65,536
   near-degenerate configurations (lattice points, 1-ulp moves) bit for
   bit, their signs against an exact oracle on 2,048; BigInt and
   RationalW arithmetic limb for limb; the cells' tests on lattice and
   random batches.  It runs, untimed, beside phase 23's CPU worker, after
   phases 22 and 25, and before phase 36b;
36. the adaptive grid: (a, after phase 34) card against CPU: 65,536 unique leaf cells in
   [-256, 256)^3 (negative coordinates), the three levels equal, probe at
   262,144 points bit for bit, sample, sample_gradient and
   sample_staggered within 1e-5 of the largest magnitude,
   update_leaf_values and activate_leaves equal, their overflow flags
   equal (a write to an inactive cell and an activation past the
   capacity raise them); (b, beside phase 23's CPU worker, after phase
   35: the card would wait on the worker otherwise) phase 21's scene
   through the same
   ``simulate`` over ``AdaptiveGridLevelSet(adaptive_from_sdf(ground,
   dx=1/128, [0, 1]^3, band=0.1))``: x, v, F within TOL plus twice the
   card's spread (the analytic run with its particles reversed) of phase
   21's analytic ground, through the impact; ms/step beside phase 21's
   and beside the reversed run's in the same window;
37. examples/mpm_block.py's path (262,144 particles, dx = 1/128, 50
   explicit_steps) timed with the port's ``Timer`` and ``bench``, 3 steps
   in ``trace`` (CUDA kernel events in the Chrome trace),
   ``memory_stats``, ``save_vdb(grid, ["m", "v"])`` read back by
   ``load_vdb_grids`` bit for bit, phase 36's ground through
   ``adaptive_to_vdb_grid`` -> .vdb -> ``vdb_grid_to_adaptive`` (probes
   equal), the host ops built with g++ (``morton3d_host`` = the card's
   morton keys), a log file through ``utils/logger``;
38. NCCL at world size 1 (a ``file://`` rendezvous with a timeout):
   ``shard_state`` + ``explicit_step_sharded`` and ``make_dd_state`` +
   ``explicit_step_dd`` for 50 steps each over phase 37's scene, no
   overflow, each within TOL plus twice the card's spread of phase 37's
   explicit_step run; ms/step of each beside it.

The scan's launches in the kernel record are those of phases 4, 10, 12,
13, 16, 19, 20, 21, 24, 26, 32-34 and 36-38, NSE's those of phases 7 and
32-34 (a line before gives them per path, with phases 27-31's, which
launch neither kernel), the mesh barrier's those of phases 16-18 (one a
narrow phase; none elsewhere, checked).  The last two lines are the kernel record and the
contract line ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import contextlib
import dataclasses
import datetime
import importlib
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import (  # noqa: E402
    ProfilerActivity, profile, record_function)

import zpc_tpu_torch  # noqa: E402
from zpc_tpu_torch import _kernels, scenes  # noqa: E402
from zpc_tpu_torch.containers import block_table  # noqa: E402
from zpc_tpu_torch.containers import bvh as bvh_mod  # noqa: E402
from zpc_tpu_torch.containers import bvs as bvs_mod  # noqa: E402
from zpc_tpu_torch.ops import implicit_apply as apply_op  # noqa: E402
from zpc_tpu_torch.ops import mesh_barrier as barrier_op  # noqa: E402
from zpc_tpu_torch.ops import nse as nse_op  # noqa: E402
from zpc_tpu_torch.ops import scan as scan_op  # noqa: E402
from zpc_tpu_torch.geometry import ccd_tight, dihedral  # noqa: E402
from zpc_tpu_torch.geometry import cells as cells_mod  # noqa: E402
from zpc_tpu_torch.geometry import distance, marching  # noqa: E402
from zpc_tpu_torch.geometry import levelset  # noqa: E402
from zpc_tpu_torch.geometry import mesh as mesh_mod  # noqa: E402
from zpc_tpu_torch.geometry import predicates  # noqa: E402
from zpc_tpu_torch.geometry import sparse_levelset as sls_mod  # noqa: E402
from zpc_tpu_torch.geometry.sparse_grid import (  # noqa: E402
    neighbor_offsets)
from zpc_tpu_torch.geometry.collider import (Collider,  # noqa: E402
                                             ColliderType)
from zpc_tpu_torch.math import solvers  # noqa: E402
from zpc_tpu_torch.math.vecmat import mm33  # noqa: E402
from zpc_tpu_torch.models import cfl as fl_cfl  # noqa: E402
from zpc_tpu_torch.models import constitutive  # noqa: E402
from zpc_tpu_torch.models.constitutive import (  # noqa: E402
    FixedCorotated, NeoHookean)
from zpc_tpu_torch.parallel import primitives  # noqa: E402
from zpc_tpu_torch.sim import cloth  # noqa: E402
from zpc_tpu_torch.sim import contact_implicit as ci  # noqa: E402
from zpc_tpu_torch.sim import fem  # noqa: E402
from zpc_tpu_torch.sim import fluid as fl  # noqa: E402
from zpc_tpu_torch.sim import fluid_binned2 as fb  # noqa: E402
from zpc_tpu_torch.sim import implicit as imp  # noqa: E402
from zpc_tpu_torch.sim import implicit_binned2 as ib2  # noqa: E402
from zpc_tpu_torch.sim import mpm as mpm_mod  # noqa: E402
from zpc_tpu_torch.sim import mpm_binned2 as b2  # noqa: E402
from zpc_tpu_torch.sim import runner  # noqa: E402
from zpc_tpu_torch.utils import io as io_mod  # noqa: E402
from zpc_tpu_torch.geometry import adaptive_grid as ag_mod  # noqa: E402
from zpc_tpu_torch.geometry import vdb_bridge  # noqa: E402
from zpc_tpu_torch.math import bits  # noqa: E402
from zpc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from zpc_tpu_torch.sim import distributed as dist_mod  # noqa: E402
from zpc_tpu_torch.sim import domain_decomp as dd_mod  # noqa: E402
from zpc_tpu_torch.utils import logger as log_mod  # noqa: E402
from zpc_tpu_torch.utils import native  # noqa: E402
from zpc_tpu_torch.utils import profile as prof_mod  # noqa: E402
from zpc_tpu_torch.utils import vdb as vdb_mod  # noqa: E402

# zpc_tpu_torch.math exports a function named bigint over its submodule
bigint_mod = importlib.import_module("zpc_tpu_torch.math.bigint")

N_MAIN, DX_MAIN, CHAIN = 262_144, 1.0 / 128, 720
CFG_MAIN = b2.BinnedConfig2(bins_capacity=2560, block_capacity=2048)
# 2,560 (the pad sums), 20,480 (the table rank), 65,536 (the dummy keys),
# 262,144 and 327,680 (the lane ranks) are the main path's scan sizes
# 4,096, 4,097 and 12,288 are one tile, one tile plus one, and three tiles;
# from 1,048,576 on the kernel takes tiles of 8,192
SCAN_SIZES = (1, 1000, 2_560, 4_096, 4_097, 12_288, 20_480, 65_536, 131_072,
              262_144, 327_680, 1_048_575, 1_048_576 + 8_193,
              16_777_216 + 7)
TOL = dict(x=1e-5, v=2e-4, F=1e-5)
N_BVH, UEXT, MAX_HITS, RESIDUE = 1_048_576, 0.006, 16, 524_288
WALK_QUERIES = 16_384
# NSE sizes: one element, one warp's worth, the TPU kernel's block, a
# ragged size under one tile, one tile, one tile plus one, three tiles, the
# 1M build's gap count, and the largest allowed
NSE_SIZES = (1, 63, 4_096, 4_096 + 1_234, 8_192, 8_193, 24_576, N_BVH - 1,
             (1 << 24) - 1)
# the dam break (benchmarks/run_all.py bench_fluid): warm-up, the bench's
# window, and the collapse run on until REBINS_WANT rebins or MAX_COLLAPSE
# steps; the small fluid run for the card against the CPU
N_FLUID, FLUID_WARM, FLUID_WINDOW = 262_144, 100, 20
REBINS_WANT, MAX_COLLAPSE = 3, 3_000
N_FLUID_SMALL, FLUID_SMALL_STEPS = 4_096, 240
TOL_FLUID = dict(x=1e-5, v=2e-4, J=1e-5)
# the materials of examples/materials.py at their own size (32,768
# particles fill 283 bins) and the snow run held against the CPU
N_MAT, DX_MAT, MAT_STEPS = 32_768, 1.0 / 64, 200
CFG_MAT = b2.BinnedConfig2(bins_capacity=384)
N_SNOW, SNOW_STEPS = 4_096, 50
# the implicit block of bench_implicit (BASELINE config 5 without contact):
# one step with its CG count, then a chain; the small run for the card
# against the CPU; the CG Poisson solve of bench_poisson (config 2)
N_IMP, IMP_CHAIN, CG_ITERS, CG_TOL = 1_000_000, 10, 50, 1e-3
TPU_CG_ITERS = 4                      # BENCHMARKS.md:107, TPU v5e
IMP_SMALL_STEPS = 20
TOL_IMP = dict(x=1e-6, v=5e-4, F=1e-5)
N_POISSON, POISSON_ITERS, N_POISSON_SMALL = 128, 100, 32
# mesh contact (scenes.contact_block: bench_implicit's barrier): the floor
# under phase 13's block (its particles start at y >= 0.575); the bench's
# two heightfields (2,048 and 100,352 triangles); the small scene of
# tests/test_contact_implicit.py's 100-step test for the card against the
# CPU
FLOOR_Y = 0.57
TERRAIN_RES = (32, 224)
# (max_tris, join tile) of each heightfield in the benchmark's configurations
TERRAIN_CONTACT = {32: (32, 3072), 224: (648, 3072)}
N_CSMALL, CSMALL_STEPS, CSMALL_FLOOR, CSMALL_DHAT = 512, 20, 0.2, 0.02
# BASELINE config 1 (reduce / scan / sort on a 1M-element Vector) and the
# second size of BENCHMARKS.md's primitive rows; the 7-point Laplacian's
# grid side for phase 20's CSR
CONFIG1_SIZES = (1_048_576, 16_777_216)
LAPLACE_M = 64
# the README's Quick start through Scene and simulate (1,000 steps, a
# frame every 100, a checkpoint every 500) after the README's own loop of
# unbinned steps; the same scene at dx = 1/32 with a sphere for the card
# against the CPU
N_README, DX_README, README_LOOP = 262_144, 1.0 / 128, 100
README_STEPS, README_FRAME, README_CKPT, README_LATE = 1000, 100, 500, 700
DX_SMALL_README, SMALL_README_STEPS = 1.0 / 32, 240
# examples/mpm2d.py at its defaults (8,192 draws, dx = 1/128, dt = 1e-4;
# impact near step 2,860), and the same discs at a user's scale (327,680
# draws at dx = 1/1024, dt = 5e-5 under the CFL dt of 5.95e-5; impact
# near step 5,700)
N_DISCS, DT_DISCS, DISCS_UNBINNED, DISCS_BINNED = 8192, 1e-4, 200, 3000
N_DISCS_BIG, DT_DISCS_BIG, DISCS_BIG_STEPS = 327_680, 5e-5, 6000
# the paddle scene of phase 25; the incremental rebin's chain and bins
# (3,072, benchmarks/probe_fluid_cost.py's, cannot hold the README scene's
# reserve bins)
REST_PADDLE_STEPS = 200
REBIN_STEPS, REBIN_BINS = 1000, 4096
# the hinge and tight-CCD batches of phase 27 (the distributions of
# tests/test_dihedral.py and tests/test_ccd_tight.py); the drape of
# examples/cloth_drape.py (its defaults); the bench's two-layer cloth
# (benchmarks/run_all.py bench_cloth and bench_cloth_128k); the hanging
# NeoHookean block of tests/test_fem.py at 33^3 vertices
N_HINGES, N_HESS, N_CCD = 1_048_576, 65_536, 65_536
DRAPE_NX, DRAPE_FRAMES, DRAPE_SUBSTEPS, DRAPE_DT, DRAPE_CMP = 24, 40, 4, \
    0.008, 8
CLOTH_DT, CLOTH_NEWTON, CLOTH_CG, CLOTH_MC = 0.005, 2, 24, 32
# the bench's window budgets (1,024 and 8,192) overflow once the layers
# touch (ROADMAP §3): the rows run with budgets that hold the residue
CLOTH_8K = dict(nx=64, bench_residue=1024, residue=65_536, settle=40,
                chain=10, reps=3, cpu=3)
CLOTH_128K = dict(nx=256, bench_residue=8192, residue=1 << 20, settle=20,
                  chain=5, reps=1, cpu=1)
TOL_CLOTH = dict(rtol=3e-4, atol=5e-6)    # tests/test_cloth.py:490
N_FEM, FEM_STEPS, FEM_DT, FEM_CMP = 33, 40, 0.01, 5
# the LBVH query family on phase 7's tree (2,048 queries of each sampled
# for brute force; the front's and the sweep structure's sizes), the
# 1,048,576 rays and points over the 224 x 224 heightfield, and the robust
# geometry's batches (the exact oracle runs on the first N_EXACT)
N_SAMPLE, N_FRONT, N_BVS, N_RAYS = 2_048, 65_536, 65_536, 1_048_576
N_PRED, N_EXACT, N_BIG = 65_536, 2_048, 4_096
# the adaptive grid card against CPU: 65,536 unique leaf cells in
# [-256, 256)^3 (58,039 leaf blocks) queried at 262,144 points, capacities
# that hold an activation of 4,096 far cells and not one of 16,384 spread
# cells; samples held within AG_TOL of the largest magnitude (fp32 sums of
# 8 products); the README scene's adaptive ground (band 0.1 covers y in
# [0, 0.15)); examples/mpm_block.py's 50 steps for phases 37-38
AG_CELLS, AG_HALF, AG_DX, AG_QUERIES = 65_536, 256, 1.0 / 128, 262_144
AG_CAPS, AG_TOL, AG_BAND = [65_536, 8_192, 128], 1e-5, 0.1
IO_STEPS = 50
HBM_BYTES_PER_MS = 3.35e12 / 1e3     # H100 SXM HBM3 rate (data sheet)
_WINDOW = "timed calls"               # the profiler window of device_split
_T0 = time.perf_counter()             # the phases print their start time


def phase(name):
    print(f"== {name}  [{time.perf_counter() - _T0:.1f} s]", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def cuda_ms(fn, reps, warmup=5):
    """Mean time per call of ``fn`` over ``reps`` back-to-back calls,
    between two CUDA events: the larger of the host's time to launch the
    calls and the device's time."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# host calls that put work on the card: kernel launches, memsets, copies
_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemset", "cuMemset",
             "cudaMemcpy", "cuMemcpy")


def _profiled_window(fn, reps):
    """torch.profiler's events of ``reps`` calls of ``fn`` in one marked
    window, and that window's host time range."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(_WINDOW):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    win = [e.time_range for e in events
           if e.name == _WINDOW and e.device_type == DeviceType.CPU]
    if len(win) != 1:
        raise RuntimeError(f"{len(win)} profiler windows, not 1")
    return events, win[0]


def _queued_ms(fn, reps):
    """Device ms per call between CUDA events, with the calls queued behind
    a sleeping kernel (~25 ms) so that the host's launch time is hidden."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_split(fn, reps=100, tries=3):
    """(device ms per call, device activities per call, their names) of
    ``fn`` from torch.profiler.  The activities per call are the host's
    launch, memset and copy calls inside a window of ``reps`` calls (the
    host's clock, exact); the device time per call is the mean duration of
    the device events times that count, so an event the profiler failed to
    record (it drops a few) does not count as a missing launch.  Now and
    then the profiler records no device event at all in a window: the
    window is profiled again, and after ``tries`` such windows the device
    time comes from CUDA events around calls queued behind a sleeping
    kernel (:func:`_queued_ms`), which the line printed says."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        events, win = _profiled_window(fn, reps)
        launches = [e for e in events if e.device_type == DeviceType.CPU
                    and e.name.startswith(_LAUNCHES)
                    and win.start <= e.time_range.start <= win.end]
        per_call = len(launches) / reps
        ev = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name != _WINDOW]
        if ev:
            mean_ms = sum(e.time_range.elapsed_us() for e in ev) / len(ev)
            return mean_ms / 1e3 * per_call, per_call, \
                sorted({e.name for e in ev})
        time.sleep(0.5)
    dev_ms = _queued_ms(fn, reps)
    print(f"  (the profiler recorded no device event in {tries} windows of "
          f"{reps} calls; {per_call:g} host launches a call; device time "
          f"{dev_ms:.6f} ms a call from CUDA events around calls queued "
          f"behind a sleeping kernel)", flush=True)
    return dev_ms, per_call, ["not recorded by the profiler"]


def split(label, fn, card, kernel=True):
    """Device time and per-call time of ``fn``, printed; a kernel of the
    port must launch exactly one CUDA kernel per call."""
    dev_ms, per_call, names = device_split(fn)
    ms = cuda_ms(fn, 200)
    print(f"  {label}: device {dev_ms:.6f} ms, per call {ms:.6f} ms, "
          f"{per_call:g} kernels per call {names} ({card})", flush=True)
    if kernel:
        check(per_call == 1, f"{label}: one CUDA kernel per call, no memset")
    return {"device_ms": dev_ms, "ms": ms, "kernels_per_call": per_call}


def stress(name, call, plain, make, n, module):
    """The look-back under stress, each result against its plain version
    (``call(x, k)`` and ``plain(x, k)`` for the k-th input ``make(n, k)``):
    calls back to back on inputs of the same and of growing sizes, views at
    1, 2 and 3 elements (not 16-byte aligned), two streams at once, and the
    epoch's wrap (a workspace started 2 below it and full of stale statuses
    of epochs 0-2; 2 small calls, the second of which wraps and must zero
    them, then 3 at n)."""
    def same(x, k, got):
        want = plain(x, k)
        if got.dtype == torch.uint32:       # compared as their bits
            got, want = got.view(torch.int32), want.view(torch.int32)
        if not torch.equal(got, want):
            bad = torch.nonzero(got != want)[:5].flatten().tolist()
            raise AssertionError(f"{name} n={x.numel()}: differs at {bad}")
    xs = [make(m, k) for k, m in enumerate((n, n, 3 * n, 10 * n, n // 3))]
    outs = [call(x, k) for k, x in enumerate(xs)]
    for k, (x, got) in enumerate(zip(xs, outs)):
        same(x, k, got)
    base = make(n + 8, 9)
    for off in (1, 2, 3):
        x = base[off:off + n + 5]
        if x.data_ptr() % 16 == 0:
            raise AssertionError("the offset view is 16-byte aligned")
        same(x, off, call(x, off))
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    x1, x2 = make(2 * n + 3, 10), make(2 * n + 5, 11)
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        g1 = call(x1, 0)
    with torch.cuda.stream(s2):
        g2 = call(x2, 1)
    torch.cuda.synchronize()
    same(x1, 0, g1)
    same(x2, 1, g2)
    keep = module.WORKSPACE
    module.WORKSPACE = _kernels.Workspace(
        epoch=_kernels.EPOCH_LIMIT - 2, stale=True)
    try:
        tile = module.build().tile
        xs = [make(m, 20 + k) for k, m in enumerate(
            (3 * tile, 2 * tile + 1, n, n - 999, n - 1998))]
        ws = module.WORKSPACE.get(
            xs[0].device, torch.cuda.current_stream().cuda_stream,
            module.build().status_words(n))
        for k, x in enumerate(xs):
            same(x, k, call(x, k))
            if k == 1 and (ws[_kernels.HEADER_WORDS:].any() or
                           _kernels.Workspace.header(ws) != (0, 0, 0)):
                raise AssertionError(f"{name}: the call that wrapped the "
                                     f"epoch left stale statuses")
        if _kernels.Workspace.header(ws) != (0, 0, 3):
            raise AssertionError(f"{name}: workspace header after the wrap "
                                 f"{_kernels.Workspace.header(ws)}, not "
                                 f"(0, 0, 3)")
    finally:
        module.WORKSPACE = keep
    check(True, f"{name} under stress = plain: 5 calls back to back (n to "
                f"{10 * n}), 3 unaligned views, 2 streams at once, 5 calls "
                f"across the epoch's wrap (stale statuses zeroed at the wrap, "
                f"counters reset, epoch 3 after)")


def environment():
    phase("1 environment")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def build():
    phase("2 build")

    def timed(op):
        t0 = time.perf_counter()
        op.build()
        return time.perf_counter() - t0
    # one nvcc per source, all started together
    ops = {"scan": scan_op, "nse": nse_op, "mesh_barrier": barrier_op,
           "implicit_apply": apply_op}
    with concurrent.futures.ThreadPoolExecutor(len(ops)) as pool:
        secs = dict(zip(ops, pool.map(timed, ops.values())))
    for name, sec in secs.items():
        print(f"  {name}.cu built and loaded in {sec:.2f} s", flush=True)
        for kernel, regs, smem, spill in _ptxas_lines(
                _kernels.ptxas_report(name)):
            print(f"    {kernel}: {regs} registers, {smem} B shared memory, "
                  f"{spill} B spilled (ptxas -v)", flush=True)


_TYPES = {"i": "int32", "j": "uint32", "f": "float32"}


def _ptxas_lines(report):
    """(kernel, registers, shared bytes, spill bytes) per entry function of
    a ptxas -v report, with template arguments spelled out."""
    out = []
    for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores"
            r".*?Used (\d+) registers.*?(\d+) bytes smem", report, re.S):
        mangled = m.group(1)
        name = re.search(r"([a-z]+_kernel)", mangled).group(1)
        args = re.search(r"_kernelI([ijf])NS_3(Add|Max|Min)I[ijf]EELi(\d+)E"
                         r"Lb([01])", mangled)
        if args:
            name += (f"<{_TYPES[args.group(1)]}, {args.group(2)}, "
                     f"{args.group(3)} items, "
                     f"{'aligned' if args.group(4) == '1' else 'scalar'}>")
        out.append((name, int(m.group(3)), int(m.group(4)),
                    int(m.group(2))))
    if not out:
        raise AssertionError("no kernel in the ptxas report")
    return out


def _scan_input(dtype, n, gen, dev):
    if dtype == torch.float32:
        return torch.rand(n, generator=gen, device=dev)
    x = torch.randint(-1000, 1000, (n,), generator=gen, device=dev,
                      dtype=torch.int64)
    if dtype == torch.uint32:
        x = x.abs()
    return x.to(dtype)


def kernel_vs_plain(dev, card):
    phase("3 scan kernel against its plain version")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for n in SCAN_SIZES:
        for dtype in (torch.int32, torch.uint32, torch.float32):
            x = _scan_input(dtype, n, gen, dev)
            for op, excl in (("add", False), ("max", False), ("min", False),
                             ("add", True)):
                got = scan_op.scan(x, op, excl)
                ref = scan_op.scan_reference(x, op, excl)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    err = (got.double() - ref.double()).abs().max().item()
                    ok = torch.allclose(got.double(), ref.double(),
                                        rtol=2e-4, atol=1e-3)
                else:
                    err = (got.to(torch.int64) -
                           ref.to(torch.int64)).abs().max().item()
                    ok = err == 0
                max_err = max(max_err, err)
                if not ok:
                    raise AssertionError(
                        f"scan {op} exclusive={excl} {dtype} n={n}: "
                        f"max abs err {err}")
    check(True, f"kernel = plain on {len(SCAN_SIZES) * 12} cases "
                f"(ints exact, f32 rtol 2e-4 atol 1e-3); max abs err "
                f"{max_err}")
    for dtype in (torch.int32, torch.uint32, torch.float32):
        for op, excl in (("add", False), ("max", False), ("add", True)):
            if dtype == torch.float32 and op == "add":
                continue            # float add is not exact: checked above
            stress(f"scan {op}{'/excl' if excl else ''} {dtype}",
                   lambda x, k, op=op, excl=excl: scan_op.scan(x, op, excl),
                   lambda x, k, op=op, excl=excl: scan_op.scan_reference(
                       x, op, excl),
                   lambda m, k, dtype=dtype: _scan_input(dtype, m, gen, dev),
                   327_680, scan_op)
    times = {}
    for n in (327_680, 16_777_216 + 7):
        x = torch.randint(0, 2, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        times[n] = split(f"scan int32 add n={n}",
                         lambda: scan_op.scan(x), card)
        times[n]["plain_ms"] = cuda_ms(lambda: scan_op.scan_reference(x),
                                       200)
        print(f"  plain version n={n}: {times[n]['plain_ms']:.6f} ms per "
              f"call; bound {8 * n / HBM_BYTES_PER_MS:.6f} ms (8 bytes per "
              f"element at 3.35 TB/s; {card})", flush=True)
        lib = split(f"torch.cumsum int32 n={n}",
                    lambda: torch.cumsum(x, 0, dtype=torch.int32), card,
                    kernel=False)
        if n == 327_680:
            times["library"] = lib
    return max_err, times


def _alive_cols(st):
    return st.cols[st.pid >= 0]


@contextlib.contextmanager
def recorded_scans():
    """Keep (input, op, exclusive, output) of every scan the port's
    primitives run inside the block, for a replay against the plain
    version (the replay launches no kernel)."""
    calls = []
    inner = primitives.scan

    def record(x, op="add", exclusive=False):
        out = inner(x, op, exclusive)
        if x.is_cuda:               # the CPU port's scans launch nothing
            calls.append((x.clone(), op, exclusive, out.clone()))
        return out
    primitives.scan = record
    try:
        yield calls
    finally:
        primitives.scan = inner


def replay_scans(calls, f32=False):
    """Each recorded scan against scan_reference on the same tensor: ints
    exact (the MPM paths scan int32 only); with ``f32``, float32 add
    within 1e-5 of the prefix sums of |x| and float max/min exact."""
    for x, op, excl, out in calls:
        if f32 and x.dtype == torch.float32 and op == "add":
            scale = torch.cumsum(x.double().abs(), 0)
            if excl:
                scale = torch.cat([scale.new_zeros(1), scale[:-1]])
            _within_abs_sum(out, scan_op.scan_reference(x, op, excl).cpu(),
                            scale.cpu(), f"scan add f32 n={x.numel()}")
            continue
        if x.dtype not in ((torch.int32, torch.uint32, torch.float32) if f32
                           else (torch.int32,)):
            raise AssertionError(f"main-path scan of {x.dtype}")
        ref = scan_op.scan_reference(x, op, excl)
        if x.dtype == torch.uint32:
            out, ref = out.view(torch.int32), ref.view(torch.int32)
        if not torch.equal(out, ref):
            err = (out.long() - ref.long()).abs().max().item()
            raise AssertionError(f"main-path scan {op} exclusive={excl} "
                                 f"n={x.numel()}: max abs err {err}")
    return sorted({(x.numel(), op + ("/excl" if excl else ""))
                   for x, op, excl, _ in calls})


def _to_device(obj, dev):
    """A copy of a tree of the port's dataclasses, dicts, tuples and
    tensors on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to_device(v, dev) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_to_device(v, dev) for v in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _assert_bins_equal(got, ref):
    """Two BinStates with the same bins, integer for integer."""
    for name, a, b in (
            ("pid", got.pid, ref.pid),
            ("bin_block", got.bin_block, ref.bin_block),
            ("nbr8", got.nbr8, ref.nbr8),
            ("table keys", got.grid.table.keys, ref.grid.table.keys),
            ("table count", got.grid.table.count, ref.grid.table.count),
            ("overflow", got.overflow, ref.overflow),
            ("cols", got.cols, ref.cols)):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"rebin on the card differs from the CPU's "
                                 f"in {name}")


def main_path(dev):
    phase("4 main path at full width")
    sim, st, dt = scenes.mpm_block(N_MAIN, DX_MAIN, dev)
    m0 = st.particles["m"].double().sum().item()
    rebins = [0]
    last = {}

    def step(s):
        last["st"] = b2.explicit_step_binned2(sim, s, dt, CFG_MAIN,
                                              rebin=False)
        return last["st"]

    def rebin(s):
        rebins[0] += 1
        return b2.rebin_adaptive(sim, s, CFG_MAIN)

    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    with recorded_scans() as calls:
        bst = b2.bin_state(sim, st, CFG_MAIN)
        torch.cuda.synchronize()
        launches_bin = scan_op.LAUNCHES
        out = b2.adaptive_chain(step, rebin, bst, CHAIN)
        torch.cuda.synchronize()
        launches_chain = scan_op.LAUNCHES - launches_bin
        # the chain's free fall is pure translation, which recentering
        # absorbs, so it may not rebin: rebin its final state once
        reb = b2.rebin_adaptive(sim, out, CFG_MAIN)
        torch.cuda.synchronize()
    launches = scan_op.LAUNCHES
    check(nse_op.LAUNCHES == 0, "the MPM path launched no NSE kernel")
    print(f"  {CHAIN} steps, {rebins[0]} rebins in the chain, scan launches "
          f"{launches}: {launches_bin} in bin_state, {launches_chain} in the "
          f"chain, {launches - launches_bin - launches_chain} in the final "
          f"rebin", flush=True)
    check(launches_bin > 0, "bin_state launched the scan kernel")
    check(launches > launches_bin + launches_chain,
          "the final rebin launched the scan kernel")
    check(len(calls) == launches, f"{len(calls)} scans recorded")
    sizes = replay_scans(calls)
    check(True, f"every main-path scan = plain on the same input, ints "
                f"exact; (n, op): {sizes}")
    check(not bool(out.overflow), "no overflow")
    check(bool(torch.isfinite(out.cols).all()), "every column finite")
    cols = _alive_cols(out)
    check(cols.shape[0] == N_MAIN, "every particle alive in bin order")
    m1 = cols[:, 24].double().sum().item()
    check(abs(m1 - m0) <= 1e-9 * m0, f"particle mass unchanged ({m1:.9g})")
    lst = last["st"]
    gmass = lst.grid.data["m"].double().sum().item()
    pmass = _alive_cols(lst)[:, 24].double().sum().item()
    check(abs(gmass - pmass) <= 1e-4 * pmass,
          f"grid mass {gmass:.9g} within 1e-4 of particle mass on the last "
          f"step")
    vy = cols[:, 4].double().mean().item()
    vff = -9.8 * CHAIN * dt
    check(abs(vy - vff) <= 0.01 * abs(vff),
          f"mean v_y {vy:.6f} within 1% of free fall {vff:.6f}")
    cpu = torch.device("cpu")
    ref = b2.rebin_adaptive(_to_device(sim, cpu), _to_device(out, cpu),
                            CFG_MAIN)
    _assert_bins_equal(reb, ref)
    check(not bool(reb.overflow),
          f"rebin of {CFG_MAIN.bins_capacity * b2.K} lanes on the card = "
          f"the CPU's (pid, bin_block, nbr8, table, cols), no overflow")
    return sim, st, bst, dt, launches


def _small_run(dev, steps):
    sim, st, dt = scenes.mpm_block(4096, 1.0 / 32, dev, block_capacity=256)
    cfg = b2.BinnedConfig2(bins_capacity=64, block_capacity=256)
    hist = []

    def step(s):
        s = b2.explicit_step_binned2(sim, s, dt, cfg, rebin=False)
        hist.append(bool(s.needs_rebin))
        return s
    out = b2.adaptive_chain(step, lambda s: b2.rebin_adaptive(sim, s, cfg),
                            b2.bin_state(sim, st, cfg), steps)
    return b2.unbin_state(out, st), out, hist


def card_vs_cpu(dev):
    phase("5 card against CPU, same port")
    steps = 240
    g, gb, ghist = _small_run(dev, steps)
    c, cb, chist = _small_run(torch.device("cpu"), steps)
    check(ghist == chist and any(ghist),
          f"same needs_rebin history ({sum(ghist)} rebins in {steps} steps)")
    check(not bool(gb.overflow) and not bool(cb.overflow), "no overflow")
    check(torch.equal(gb.grid.transform.matrix.cpu(),
                      cb.grid.transform.matrix), "same recentred origin")
    for k in ("x", "v", "F"):
        err = (g.particles[k].cpu() - c.particles[k]).abs().max().item()
        check(err <= TOL[k], f"{k} max abs diff {err:.3g} <= {TOL[k]}")


def _chain_seconds(sim, bst, dt):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = b2.adaptive_chain(
        lambda s: b2.explicit_step_binned2(sim, s, dt, CFG_MAIN,
                                           rebin=False),
        lambda s: b2.rebin_adaptive(sim, s, CFG_MAIN), bst, CHAIN)
    e1.record()
    torch.cuda.synchronize()
    check(not bool(out.overflow), "no overflow")
    return e0.elapsed_time(e1) / 1e3


def _steps_ms(sim, bst, dt, n, read_flag):
    """Mean ms of ``n`` chained steps, reading ``needs_rebin`` on the host
    after each (as adaptive_chain does) or not at all."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    s = bst
    e0.record()
    for _ in range(n):
        s = b2.explicit_step_binned2(sim, s, dt, CFG_MAIN, rebin=False)
        if read_flag:
            bool(s.needs_rebin)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def throughput(sim, st, bst, dt, card):
    phase("6 first number on the card")
    best = min(_chain_seconds(sim, bst, dt) for _ in range(3))
    pps = N_MAIN * CHAIN / best
    print(f"  {CHAIN}-step chain best of 3: {best:.4f} s = "
          f"{pps / 1e6:.4f} M particle-steps/s ({card})", flush=True)
    for read_flag in (True, False, True, False):
        ms = _steps_ms(sim, bst, dt, 50, read_flag)
        print(f"  one step, {'with' if read_flag else 'without'} the "
              f"needs_rebin read: {ms:.4f} ms (mean of 50; {card})",
              flush=True)
    rb = cuda_ms(lambda: b2.rebin_adaptive(sim, bst, CFG_MAIN), 10)
    bs = cuda_ms(lambda: b2.bin_state(sim, st, CFG_MAIN), 10)
    print(f"  rebin {rb:.4f} ms, bin_state {bs:.4f} ms (mean of 10; {card})",
          flush=True)
    return pps


def _nse_pattern(name, g, gen, dev):
    i = torch.arange(g, device=dev, dtype=torch.int32)
    if name == "random":
        return torch.randint(1, 64, (g,), generator=gen, device=dev,
                             dtype=torch.int32)
    if name == "equal":
        return torch.full((g,), 17, device=dev, dtype=torch.int32)
    if name == "increasing":
        return i % 63 + 1
    if name == "decreasing":
        return 63 - i % 63
    if name == "ones":
        return torch.ones(g, device=dev, dtype=torch.int32)
    return torch.where(i % 2 == 0, 1, 63).to(torch.int32)   # alternating


def nse_vs_plain(dev, card):
    phase("3b NSE kernel against its plain version")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases, max_err = 0, 0
    for g in NSE_SIZES:
        for name in ("random", "equal", "increasing", "decreasing", "ones",
                     "alternating"):
            d = _nse_pattern(name, g, gen, dev)
            for strict in (False, True):
                got = nse_op.nse(d, strict)
                ref = nse_op.nse_reference(d, strict)
                torch.cuda.synchronize()
                max_err = max(max_err, (got.long() - ref.long()).abs().max()
                              .item())
                if not torch.equal(got, ref):
                    bad = torch.nonzero(got != ref)[:5].flatten().tolist()
                    raise AssertionError(
                        f"nse {name} g={g} strict={strict}: differs at "
                        f"{bad}")
                cases += 1
    check(True, f"NSE kernel = plain on {cases} cases, exact (NONE "
                f"included); g in {NSE_SIZES}")
    # strict on odd calls
    stress("nse", lambda d, k: nse_op.nse(d, k % 2 == 1),
           lambda d, k: nse_op.nse_reference(d, k % 2 == 1),
           lambda g, k: _nse_pattern("random", g, gen, dev), 100_000,
           nse_op)
    d = _nse_pattern("random", N_BVH - 1, gen, dev)
    t = split(f"nse g={N_BVH - 1} random", lambda: nse_op.nse(d), card)
    t["plain_ms"] = cuda_ms(lambda: nse_op.nse_reference(d), 10, warmup=2)
    print(f"  plain version g={N_BVH - 1}: {t['plain_ms']:.4f} ms per call; "
          f"bound {8 * (N_BVH - 1) / HBM_BYTES_PER_MS:.6f} ms ({card})",
          flush=True)
    return max_err, t


@contextlib.contextmanager
def recorded_nse():
    """Keep (input, strict, output) of every NSE sweep the LBVH build runs
    inside the block, for a replay against the plain version."""
    calls = []
    inner = bvh_mod.nse

    def record(d, strict=False):
        out = inner(d, strict)
        calls.append((d.clone(), strict, out.clone()))
        return out
    bvh_mod.nse = record
    try:
        yield calls
    finally:
        bvh_mod.nse = inner


@contextlib.contextmanager
def replayed(what):
    """Record every scan and NSE sweep that the block runs, then replay
    each against its plain version on the same input (exact) and print
    the shapes replayed.  The replays launch no kernel."""
    with recorded_scans() as scans, recorded_nse() as sweeps:
        yield
    sizes = replay_scans(scans)
    for d, strict, out in sweeps:
        if not torch.equal(out, nse_op.nse_reference(d, strict)):
            raise AssertionError(f"{what}: NSE strict={strict} g="
                                 f"{d.numel()} differs from the plain "
                                 f"version")
    check(True, f"{what}: its {len(scans)} scans (n, op) {sizes} and "
                f"{len(sweeps)} NSE sweeps (g = "
                f"{sorted({d.numel() for d, _, _ in sweeps})}) = the plain "
                f"versions on the same inputs, exact")


_TREE_INTS = ("codes", "left", "right", "escape", "leaf_prim")


def _assert_trees_equal(got, ref, what):
    """Two LBvh trees equal integer for integer, boxes bit for bit; where
    the codes differ, print the first such primitives."""
    if not torch.equal(got.codes.cpu(), ref.codes):
        bad = torch.nonzero(got.codes.cpu() != ref.codes).flatten()
        print(f"  codes differ at {bad.numel()} sorted leaves, first "
              f"{bad[:5].tolist()}: card {got.codes.cpu()[bad[:5]].tolist()}"
              f" cpu {ref.codes[bad[:5]].tolist()}", flush=True)
    for name in _TREE_INTS + ("lo", "hi", "count", "scene_lo",
                              "scene_extent", "half_max"):
        if not torch.equal(getattr(got, name).cpu(), getattr(ref, name)):
            raise AssertionError(f"{what}: {name} differs from the CPU's")


def _sample_brute(lo, hi, qlo, qhi, chunk=32_768):
    """Counts and (query, prim) hit pairs of query boxes against every
    primitive box, on the card, chunked over the primitives."""
    cnt = torch.zeros(qlo.shape[0], dtype=torch.int64, device=lo.device)
    pairs = []
    for s in range(0, lo.shape[0], chunk):
        ov = ((lo[None, s:s + chunk] <= qhi[:, None]).all(-1)
              & (qlo[:, None] <= hi[None, s:s + chunk]).all(-1))
        cnt += ov.sum(1)
        q, p = torch.nonzero(ov, as_tuple=True)
        pairs.append(torch.stack([q, p + s], 1))
    return cnt, torch.cat(pairs)


def _row_pairs(qid_rows, hits_rows, qmap):
    """Sorted (query slot, prim) pairs of union rows whose qid is mapped
    by ``qmap`` (qid -> slot, -1 elsewhere); raises on a duplicate hit."""
    slot = qmap[qid_rows.long()]
    keep = slot >= 0
    h = hits_rows[keep]
    s = slot[keep][:, None].expand_as(h)
    live = h >= 0
    key = s[live].long() * (1 << 32) + h[live].long()
    if torch.unique(key).numel() != key.numel():
        raise AssertionError("a query's union rows hold a duplicate hit")
    return torch.sort(key).values


def lbvh_path(dev, card):
    phase("7 LBVH path at full width")
    lo, hi, c = scenes.lbvh_boxes(N_BVH, dev)
    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    with recorded_nse() as calls:
        bvh = bvh_mod.build_lbvh(lo, hi)
        torch.cuda.synchronize()
        launches_build = nse_op.LAUNCHES
        qid_r, hits_r, cnt, ovf = bvh_mod.query_overlaps_exact(
            bvh, c, c, MAX_HITS, cells=8, uniform_extent=UEXT,
            residue_budget=RESIDUE)
        torch.cuda.synchronize()
    walk_steps = bvh_mod.LAST_WALK_STEPS
    launches = nse_op.LAUNCHES
    print(f"  NSE launches {launches} ({launches_build} in build_lbvh), scan "
          f"launches {scan_op.LAUNCHES}", flush=True)
    check(launches_build == 2 and launches == 2,
          "build_lbvh launched the NSE kernel twice, the query not at all")
    for d, strict, out in calls:
        if not torch.equal(out, nse_op.nse_reference(d, strict)):
            raise AssertionError(f"the build's NSE strict={strict} "
                                 f"differs from the plain version")
    check(len(calls) == 2, f"both NSE sweeps of the build (g = "
                           f"{calls[0][0].numel()}, forward and strict "
                           f"reversed) = plain on the same input, exact")
    ref = bvh_mod.build_lbvh(lo.cpu(), hi.cpu())
    _assert_trees_equal(bvh, ref, "1M build")
    check(True, "1M build on the card = the CPU port's: codes, left, "
                "right, escape, leaf_prim, lo, hi")
    n = N_BVH
    check(torch.equal(bvh.lo[0], lo.amin(0)) and torch.equal(
        bvh.hi[0], hi.amax(0)), "the root box is the union of all boxes")
    check(torch.equal(torch.sort(bvh.leaf_prim[n - 1:]).values,
                      torch.arange(n, dtype=torch.int32, device=dev)),
          "leaf_prim is a permutation of the primitives")

    qid_s, _, _, band_e = bvh_mod.query_overlaps_sorted(
        bvh, c, c, MAX_HITS, tile=128, group=512, extract="none",
        decompose=True, cells=8, uniform_extent=UEXT)
    band = torch.ones(n, dtype=torch.int32, device=dev).scatter_reduce(
        0, qid_s.long(), band_e.to(torch.int32), "amin")
    in_band = band.float().mean().item()
    print(f"  c8 in-band fraction {in_band:.6f} ({int((band == 0).sum())} "
          f"residue queries); residue walk {walk_steps} iterations",
          flush=True)
    check(not bool(ovf), f"exact query: no residue overflow at budget "
                         f"{RESIDUE}")
    gen = torch.Generator().manual_seed(0)
    sample = torch.randperm(n, generator=gen)[:2048].to(dev)
    print(f"  {int((band[sample] == 0).sum())} of the 2,048 sampled queries "
          f"went to the residue walk", flush=True)
    u = torch.tensor(UEXT, dtype=torch.float32, device=dev)
    bcnt, bpairs = _sample_brute(lo, hi, c[sample] - u, c[sample] + u)
    check(torch.equal(cnt[sample].long(), bcnt),
          f"counts of 2,048 sampled queries = brute force (mean "
          f"{bcnt.float().mean().item():.3f}, max {int(bcnt.max())})")
    qmap = torch.full((n,), -1, dtype=torch.int64, device=dev)
    qmap[sample] = torch.arange(2048, device=dev)
    small = bcnt[bpairs[:, 0]] <= MAX_HITS
    want = torch.sort(bpairs[small, 0] * (1 << 32) + bpairs[small, 1]).values
    got = _row_pairs(qid_r, hits_r, qmap)
    got = got[bcnt[got >> 32] <= MAX_HITS]
    check(torch.equal(got, want), f"hit sets of the sampled queries with "
                                  f"count <= {MAX_HITS} = brute force")
    return bvh, lo, hi, c, launches


def _lbvh_small(n, where):
    """Every LBVH entry point on the n-box scene, on one device."""
    lo, hi, c = scenes.lbvh_boxes(n, where)
    u = torch.tensor(UEXT, dtype=torch.float32, device=where)
    keep = torch.arange(n, device=where) % 3 != 0
    b = bvh_mod.build_lbvh(lo, hi)
    out = {"build": b, "masked build": bvh_mod.build_lbvh(lo, hi, keep),
           "complete build": bvh_mod.build_lbvh_complete(lo, hi)}
    out["plain band"] = bvh_mod.query_overlaps_sorted(
        b, c - u, c + u, MAX_HITS, tile=128)
    out["sorted c8"] = bvh_mod.query_overlaps_sorted(
        b, c, c, MAX_HITS, tile=128, group=512, decompose=True, cells=8,
        uniform_extent=UEXT)
    out["sorted c4 counts"] = bvh_mod.query_overlaps_sorted(
        b, c, c, MAX_HITS, tile=128, group=512, extract="none",
        decompose=True, cells=4, uniform_extent=UEXT)
    out["exact"] = bvh_mod.query_overlaps_exact(
        b, c, c, MAX_HITS, cells=8, uniform_extent=UEXT)
    # the escape walk alone (the exact query's residue engine, idle at
    # this size) on the first WALK_QUERIES boxes
    q = c[:WALK_QUERIES]
    out["walk"] = bvh_mod.query_overlaps(b, q - u, q + u, MAX_HITS) + (
        bvh_mod.LAST_WALK_STEPS,)
    return out


def lbvh_card_vs_cpu(dev):
    phase("8 LBVH card against CPU, same port")
    n = 65_536
    got, ref = (_lbvh_small(n, w) for w in (dev, torch.device("cpu")))
    for name in ("build", "masked build", "complete build"):
        _assert_trees_equal(got[name], ref[name], f"{n} {name}")
    check(True, f"{n} boxes: build_lbvh (also with every third box "
                f"masked) and build_lbvh_complete on the card = the CPU's")
    # every order in the queries is unique, so both devices give the same
    # rows in the same places
    for name in ("plain band", "sorted c8", "sorted c4 counts", "exact",
                 "walk"):
        for a, b in zip(got[name], ref[name]):
            if not (torch.equal(a.cpu(), b) if isinstance(a, torch.Tensor)
                    else a == b):
                raise AssertionError(f"{name} on the card differs from "
                                     f"the CPU's")
    check(not bool(got["exact"][3]), "exact: no overflow")
    check(True, f"plain band and c8 sorted queries (peel), c4 (counts only), "
                f"the exact query and the escape walk of {WALK_QUERIES} "
                f"queries ({got['walk'][2]} iterations): every output on the "
                f"card = the CPU's, integer for integer")


def lbvh_numbers(bvh, lo, hi, c, card):
    phase("9 LBVH numbers on the card")
    n = N_BVH
    ms = {}
    ms["build"] = cuda_ms(lambda: bvh_mod.build_lbvh(lo, hi), 5, warmup=1)
    ms["topology"] = cuda_ms(lambda: bvh_mod._karras_topology(bvh.codes), 5,
                             warmup=1)
    ms["complete"] = cuda_ms(lambda: bvh_mod.build_lbvh_complete(lo, hi), 5,
                             warmup=1)

    def exact():
        ovf = bvh_mod.query_overlaps_exact(
            bvh, c, c, MAX_HITS, cells=8, uniform_extent=UEXT,
            residue_budget=RESIDUE)[3]
        if bool(ovf):
            raise AssertionError("exact query overflowed")
    ms["exact"] = cuda_ms(exact, 5, warmup=1)

    def quantize_sort():
        keep = torch.ones(n, dtype=torch.bool, device=lo.device)
        codes = bvh_mod._quantize(lo, hi, keep)[0]
        return codes[torch.argsort(codes, stable=True)]
    ms["quantize_sort"] = cuda_ms(quantize_sort, 5, warmup=1)
    ms["sorted_peel"] = cuda_ms(lambda: bvh_mod.query_overlaps_sorted(
        bvh, c, c, MAX_HITS, tile=128, group=512, decompose=True, cells=8,
        uniform_extent=UEXT), 5, warmup=1)
    ms["sorted_none"] = cuda_ms(lambda: bvh_mod.query_overlaps_sorted(
        bvh, c, c, MAX_HITS, tile=128, group=512, extract="none",
        decompose=True, cells=8, uniform_extent=UEXT), 5, warmup=1)
    u = torch.tensor(UEXT, dtype=torch.float32, device=c.device)
    q = c[:WALK_QUERIES]
    ms["walk"] = cuda_ms(lambda: bvh_mod.query_overlaps(
        bvh, q - u, q + u, MAX_HITS), 5, warmup=1)
    print(f"  query_overlaps (escape walk) of {WALK_QUERIES} queries "
          f"{ms['walk']:.4f} ms, {bvh_mod.LAST_WALK_STEPS} iterations "
          f"(mean of 5; {card})", flush=True)
    print(f"  build_lbvh {ms['build']:.4f} ms = "
          f"{n / ms['build'] / 1e3:.4f} Mprims/s; _karras_topology "
          f"{ms['topology']:.4f} ms; build_lbvh_complete "
          f"{ms['complete']:.4f} ms (mean of 5; {card})", flush=True)
    print(f"  query_overlaps_exact c8 {ms['exact']:.4f} ms = "
          f"{n / ms['exact'] / 1e3:.4f} Mq/s; query_overlaps_sorted c8 "
          f"peel {ms['sorted_peel']:.4f} ms, counts only "
          f"{ms['sorted_none']:.4f} ms (mean of 5; {card})", flush=True)
    print(f"  layers: quantize + sort {ms['quantize_sort']:.4f} ms, "
          f"topology {ms['topology']:.4f} ms, boxes + escape (the rest of "
          f"the build) "
          f"{ms['build'] - ms['quantize_sort'] - ms['topology']:.4f} ms; "
          f"banded join {ms['sorted_peel']:.4f} ms, residue compaction + "
          f"walk (the rest of the exact query) "
          f"{ms['exact'] - ms['sorted_peel']:.4f} ms ({card})", flush=True)
    return ms


def _fluid_gates(sim, out, last, m0, n, cfg, what):
    """The fluid path's physics gates on its final bin state ``out`` and
    the last step's state ``last``."""
    check(not bool(out.overflow), f"{what}: no overflow")
    check(bool(torch.isfinite(out.cols).all()), f"{what}: every column "
                                                f"finite")
    cols = _alive_cols(out)
    check(cols.shape[0] == n, f"{what}: every particle alive in bin order")
    lay = fb._fluid_layout(out.grid.dim)
    m1 = cols[:, lay["M"]].double().sum().item()
    check(abs(m1 - m0) <= 1e-9 * m0, f"{what}: particle mass unchanged "
                                     f"({m1:.9g})")
    gmass = last.grid.data["m"].double().sum().item()
    pmass = _alive_cols(last)[:, lay["M"]].double().sum().item()
    check(abs(gmass - pmass) <= 1e-4 * pmass,
          f"{what}: grid mass {gmass:.9g} within 1e-4 of particle mass on "
          f"the last step")
    jmin = cols[:, lay["J"]].min().item()
    check(jmin >= 0.1, f"{what}: J >= j_clamp 0.1 (min {jmin:.6f})")
    dx = float(out.grid.dx)
    x = cols[:, 0:3]
    lo, hi = x.min().item(), x.max().item()
    check(lo >= 0.02 - 3 * dx and hi <= 0.98 + 3 * dx,
          f"{what}: every particle inside the tank within 3 cells "
          f"(x in [{lo:.6f}, {hi:.6f}])")
    cpu = torch.device("cpu")
    reb = b2.rebin_adaptive(sim, out, cfg)
    ref = b2.rebin_adaptive(_to_device(sim, cpu), _to_device(out, cpu), cfg)
    _assert_bins_equal(reb, ref)
    check(not bool(reb.overflow), f"{what}: a rebin of the final state on "
                                  f"the card = the CPU's, no overflow")


def dam_break_path(dev, card):
    phase("10 dam break at full width")
    sim, st, dt, cfg = scenes.dam_break(N_FLUID, dev)
    print(f"  {N_FLUID} particles, dx = 1/128, dt = {dt}, BinnedConfig2("
          f"bins_capacity={cfg.bins_capacity}, block_capacity="
          f"{cfg.block_capacity}) derived from n", flush=True)
    m0 = st.particles["m"].double().sum().item()
    count = {"rebins": 0, "window_rebins": 0}
    last = {}

    def step(s):
        last["st"] = fb.explicit_fluid_step_binned2(sim, s, dt, cfg,
                                                    rebin=False)
        return last["st"]

    def rebin(s):
        count["rebins"] += 1
        return b2.rebin_adaptive(sim, s, cfg)

    def window(s):
        before = count["rebins"]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        s = b2.adaptive_chain(step, rebin, s, FLUID_WINDOW)
        e1.record()
        torch.cuda.synchronize()
        check(not bool(s.overflow), "timed window: no overflow")
        count["window_rebins"] += count["rebins"] - before
        return e0.elapsed_time(e1) / FLUID_WINDOW

    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    with recorded_scans() as calls:
        bst = fb.bin_fluid_state(sim, st, cfg)
        torch.cuda.synchronize()
        launches_bin = scan_op.LAUNCHES
        warm = b2.adaptive_chain(step, rebin, bst, FLUID_WARM)
        torch.cuda.synchronize()
        check(not bool(warm.overflow), f"{FLUID_WARM} warm-up steps: no "
                                       f"overflow")
        times = [window(warm) for _ in range(3)]
        ms = min(times)
        print(f"  bench window: {FLUID_WINDOW} steps from the state after "
              f"{FLUID_WARM} ({count['rebins'] - count['window_rebins']} "
              f"rebins in the warm-up, {count['window_rebins'] // 3} in "
              f"each window), best of 3: {ms:.4f} ms/step = "
              f"{N_FLUID / ms / 1e3:.4f} M particle-steps/s (windows "
              f"{', '.join(f'{t:.4f}' for t in times)} ms/step; {card})",
              flush=True)
        warm_rebins = count["rebins"] - count["window_rebins"]
        # the collapse, on from the warm state, until REBINS_WANT rebins
        # have fired in the chain (or MAX_COLLAPSE steps); a rebin that
        # overflows stops it at the last state that fits
        out, cut = warm, None
        steps, rebins, reb_ms = FLUID_WARM, warm_rebins, []
        while rebins < REBINS_WANT and steps < MAX_COLLAPSE:
            nxt = step(out)
            steps += 1
            if bool(nxt.needs_rebin):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                nxt = b2.rebin_adaptive(sim, nxt, cfg)
                e1.record()
                torch.cuda.synchronize()
                reb_ms.append(e0.elapsed_time(e1))
                rebins += 1
            if bool(nxt.overflow):
                cut = steps
                break
            out = nxt
        torch.cuda.synchronize()
    launches = scan_op.LAUNCHES
    check(nse_op.LAUNCHES == 0, "the fluid path launched no NSE kernel")
    if cut is not None:
        print(f"  the collapse overflowed at step {cut}: stopped at the last "
              f"state that fits, step {cut - 1}", flush=True)
    print(f"  chain: {rebins} rebins in {steps} steps ({warm_rebins} in the "
          f"warm-up; the collapse's took "
          f"{', '.join(f'{t:.4f}' for t in reb_ms) or 'none'} ms each; "
          f"{card}); scan launches {launches}: {launches_bin} in "
          f"bin_fluid_state, {launches - launches_bin} in the chain and the "
          f"timed windows", flush=True)
    check(launches_bin > 0, "bin_fluid_state launched the scan kernel")
    check(rebins >= 1, f"at least one rebin fired in the chain ({rebins}); "
                       f"without one the scan kernel never ran inside it")
    check(launches > launches_bin, "the chain's rebins launched the scan "
                                   "kernel")
    check(len(calls) == launches, f"{len(calls)} scans recorded")
    sizes = replay_scans(calls)
    check(True, f"every dam-break scan = plain on the same input, ints "
                f"exact; (n, op): {sizes}")
    _fluid_gates(sim, out, last["st"], m0, N_FLUID, cfg, "dam break")
    rb = cuda_ms(lambda: b2.rebin_adaptive(sim, out, cfg), 10)
    bs = cuda_ms(lambda: fb.bin_fluid_state(sim, st, cfg), 10)
    print(f"  rebin of the final state {rb:.4f} ms, bin_fluid_state "
          f"{bs:.4f} ms (mean of 10; {card})", flush=True)
    return launches, {"ms_per_step": ms, "pps": N_FLUID / ms * 1e3,
                      "rebins": rebins, "steps": steps,
                      "rebin_ms": reb_ms, "launches_bin": launches_bin,
                      "x": _alive_cols(out)[:, 0:3].contiguous()}


def _small_fluid_run(dev, steps):
    sim, st, dt, cfg = scenes.dam_break(N_FLUID_SMALL, dev)
    hist = []

    def step(s):
        s = fb.explicit_fluid_step_binned2(sim, s, dt, cfg, rebin=False)
        hist.append(bool(s.needs_rebin))
        return s
    out = b2.adaptive_chain(step, lambda s: b2.rebin_adaptive(sim, s, cfg),
                            fb.bin_fluid_state(sim, st, cfg), steps)
    return fb.unbin_fluid_state(out, st), out, hist


def fluid_card_vs_cpu(dev):
    phase("11 fluid card against CPU, same port")
    g, gb, ghist = _small_fluid_run(dev, FLUID_SMALL_STEPS)
    c, cb, chist = _small_fluid_run(torch.device("cpu"), FLUID_SMALL_STEPS)
    check(ghist == chist, f"same needs_rebin history ({sum(ghist)} rebins "
                          f"in {FLUID_SMALL_STEPS} steps)")
    check(not bool(gb.overflow) and not bool(cb.overflow), "no overflow")
    check(torch.equal(gb.grid.transform.matrix.cpu(),
                      cb.grid.transform.matrix), "same recentred origin")
    for k in ("x", "v", "J"):
        err = (g.particles[k].cpu() - c.particles[k]).abs().max().item()
        check(err <= TOL_FLUID[k], f"{k} max abs diff {err:.3g} <= "
                                   f"{TOL_FLUID[k]}")


def _material_run(material, dev, steps):
    """``steps`` binned steps of one material of examples/materials.py
    (fluid as a J state on fluid_binned2); returns (state in original
    order, sim, dt)."""
    sim, st, dt = scenes.materials(material, N_MAT, DX_MAT, device=dev)
    if material == "fluid":
        st = fl.make_fluid_state(st.particles["x"], dx=DX_MAT, device=dev,
                                 block_capacity=st.grid.block_capacity)
        bst = fb.bin_fluid_state(sim, st, CFG_MAT)
        out = b2.adaptive_chain(
            lambda s: fb.explicit_fluid_step_binned2(sim, s, dt, CFG_MAT,
                                                     rebin=False),
            lambda s: b2.rebin_adaptive(sim, s, CFG_MAT), bst, steps)
        check(not bool(out.overflow), f"{material}: no overflow")
        return fb.unbin_fluid_state(out, st)
    out = b2.adaptive_chain(
        lambda s: b2.explicit_step_binned2(sim, s, dt, CFG_MAT, rebin=False),
        lambda s: b2.rebin_adaptive(sim, s, CFG_MAT),
        b2.bin_state(sim, st, CFG_MAT), steps)
    check(not bool(out.overflow), f"{material}: no overflow")
    return b2.unbin_state(out, st)


def _snow_run(where, reverse):
    """The snow scene at N_SNOW particles, pre-compressed to F = 0.9 I (so
    the projection moves volume into Jp from the first step), SNOW_STEPS
    binned steps; ``reverse`` feeds the particles in reverse order (the
    same physics, another summation order), the result comes back in the
    scene's order."""
    sim, st, dt = scenes.materials("snow", N_SNOW, 1.0 / 32, device=where)
    F0 = 0.9 * torch.eye(3, device=where).expand(N_SNOW, 3, 3)
    p = st.particles.update(F=F0.clone())
    if reverse:
        p = p.update(**{k: v.flip(0) for k, v in p.channels.items()})
    st = mpm_mod.MPMState(p, st.grid, st.max_vel)
    cfg = b2.BinnedConfig2(bins_capacity=64)
    out = b2.adaptive_chain(
        lambda s: b2.explicit_step_binned2(sim, s, dt, cfg, rebin=False),
        lambda s: b2.rebin_adaptive(sim, s, cfg), b2.bin_state(sim, st, cfg),
        SNOW_STEPS)
    check(not bool(out.overflow), f"snow {N_SNOW} on {where}: no overflow")
    ch = b2.unbin_state(out, st).particles.channels
    return {k: (v.flip(0) if reverse else v).cpu() for k, v in ch.items()}


def materials_path(dev, card):
    phase("12 materials")
    scan_op.LAUNCHES = 0
    for material in scenes.MATERIALS:
        t0 = time.perf_counter()
        out = _material_run(material, dev, MAT_STEPS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        x, v = out.particles["x"], out.particles["v"]
        check(bool(torch.isfinite(x).all() and torch.isfinite(v).all()),
              f"{material}: {N_MAT} particles, {MAT_STEPS} steps in "
              f"{sec:.3f} s ({card}): finite")
        vmax = v.abs().max().item()
        check(vmax < 50.0, f"{material}: |v| max {vmax:.4f} < 50")
        ymin = x[:, 1].min().item()
        check(ymin > 0.1 - 3 * DX_MAT, f"{material}: nothing more than 3 "
                                       f"cells below the ground (y min "
                                       f"{ymin:.6f})")
    launches = scan_op.LAUNCHES
    print(f"  scan launches over the four materials: {launches}",
          flush=True)
    check(launches > 0, "the materials launched the scan kernel")
    g = _snow_run(dev, False)
    c = _snow_run(torch.device("cpu"), False)
    c_rev = _snow_run(torch.device("cpu"), True)
    moved = (g["Jp"] - 1.0).abs().max().item()
    check(moved > 1e-3, f"snow: Jp moved (max |Jp - 1| {moved:.6f})")
    for k in ("x", "F", "Jp"):
        spread = (c_rev[k] - c[k]).abs().max().item()
        err = (g[k] - c[k]).abs().max().item()
        check(err <= 1e-5 + spread,
              f"snow {N_SNOW} card against CPU, {SNOW_STEPS} steps: {k} max "
              f"abs diff {err:.3g} <= 1e-5 + the CPU's own spread over "
              f"summation order {spread:.3g}")
    return launches


def implicit_path(dev, card):
    phase("13 implicit block at full width")
    sim, st, dt = scenes.implicit_block(N_IMP, dev)
    cfg = scenes.implicit_config(N_IMP)
    print(f"  {N_IMP} particles, dx = 1/128, dt = {dt}, BinnedConfig2("
          f"bins_capacity={cfg.bins_capacity}, block_capacity="
          f"{cfg.block_capacity}), cg_iters {CG_ITERS}, cg_tol {CG_TOL}",
          flush=True)
    m0 = st.particles["m"].double().sum().item()
    iters, rebins, last = [], [0], {}

    def step(s):
        out, it = ib2.implicit_step_binned2(
            sim, s, dt, cfg, cg_iters=CG_ITERS, cg_tol=CG_TOL, rebin=False,
            with_stats=True)
        iters.append(it)
        last["st"] = out
        return out

    def rebin(s):
        rebins[0] += 1
        return b2.rebin_adaptive(sim, s, cfg)

    scan_op.LAUNCHES = nse_op.LAUNCHES = apply_op.LAUNCHES = 0
    with recorded_scans() as calls:
        bst = b2.bin_state(sim, st, cfg)
        torch.cuda.synchronize()
        launches_bin = scan_op.LAUNCHES
        _, it0 = ib2.implicit_step_binned2(
            sim, bst, dt, cfg, cg_iters=CG_ITERS, cg_tol=CG_TOL, rebin=False,
            with_stats=True)
        print(f"  one step from the binned state: {it0} CG iterations (a "
              f"check, not a gate: BENCHMARKS.md:107 records "
              f"{TPU_CG_ITERS} on TPU v5e)", flush=True)
        out = b2.adaptive_chain(step, rebin, bst, IMP_CHAIN)
        torch.cuda.synchronize()
        launches_chain = scan_op.LAUNCHES - launches_bin
        # the chain is a free fall, which recentering absorbs: rebin its
        # final state once, so a rebin runs the scan kernel on this path
        reb = b2.rebin_adaptive(sim, out, cfg)
        torch.cuda.synchronize()
    launches = scan_op.LAUNCHES
    check(nse_op.LAUNCHES == 0, "the implicit path launched no NSE kernel")
    apply_launches = _apply_launches(
        [it0] + iters, "the implicit path's steps")
    print(f"  {IMP_CHAIN}-step chain: CG iterations per step {iters}, "
          f"{rebins[0]} rebins; scan launches {launches}: {launches_bin} in "
          f"bin_state, {launches_chain} in the chain, "
          f"{launches - launches_bin - launches_chain} in the final rebin",
          flush=True)
    check(launches_bin > 0 and launches > launches_bin + launches_chain,
          "bin_state and the final rebin launched the scan kernel")
    check(len(calls) == launches, f"{len(calls)} scans recorded")
    sizes = replay_scans(calls)
    check(True, f"every implicit-path scan = plain on the same input, ints "
                f"exact; (n, op): {sizes}")
    check(not bool(out.overflow) and not bool(reb.overflow),
          "no overflow (chain and final rebin)")
    check(bool(torch.isfinite(out.cols).all()), "every column finite")
    cols = _alive_cols(out)
    check(cols.shape[0] == N_IMP, "every particle alive in bin order")
    m1 = cols[:, 24].double().sum().item()
    check(abs(m1 - m0) <= 1e-9 * m0, f"particle mass unchanged ({m1:.9g})")
    lst = last["st"]
    gmass = lst.grid.data["m"].double().sum().item()
    pmass = _alive_cols(lst)[:, 24].double().sum().item()
    check(abs(gmass - pmass) <= 1e-4 * pmass,
          f"grid mass {gmass:.9g} within 1e-4 of particle mass on the last "
          f"step")
    vy = cols[:, 4].double().mean().item()
    vff = -9.8 * IMP_CHAIN * dt
    check(abs(vy - vff) <= 0.01 * abs(vff),
          f"mean v_y {vy:.6f} within 1% of free fall {vff:.6f}")

    times, outs = _timed_chains(step, rebin, bst)
    for o in outs:
        check(not bool(o.overflow), "timed chain: no overflow")
    ms = min(times)
    print(f"  {IMP_CHAIN}-step chain best of 3: {ms:.4f} ms/step = "
          f"{N_IMP / ms / 1e3:.4f} M particle-steps/s (chains "
          f"{', '.join(f'{t:.4f}' for t in times)} ms/step; CG iterations "
          f"per step {iters[-IMP_CHAIN:]}; {card})", flush=True)
    return launches, apply_launches, ms


def _apply_launches(iters, what):
    """Checks one operator kernel launch an application, CG iterations + 1
    a step (``iters``: the CG iterations of every implicit step since the
    count was zeroed); returns the count."""
    want = sum(iters) + len(iters)
    check(apply_op.LAUNCHES == want,
          f"{what}: {apply_op.LAUNCHES} operator kernel launches in "
          f"{len(iters)} steps of {sum(iters)} CG iterations (CG iterations "
          f"+ 1 a step)")
    return apply_op.LAUNCHES


def _implicit_small(dev, reverse=False):
    """The small block (4,096 particles, dx = 1/32) for IMP_SMALL_STEPS
    implicit steps; ``reverse`` feeds the particles in reverse order (the
    same physics, another summation order).  Returns (state in the
    scene's order, final BinState, CG iterations per step)."""
    sim, st, _ = scenes.mpm_block(4096, 1.0 / 32, dev, block_capacity=256)
    cfg = b2.BinnedConfig2(bins_capacity=64, block_capacity=256)
    p = st.particles
    if reverse:
        p = p.update(**{k: v.flip(0) for k, v in p.channels.items()})
    st = mpm_mod.MPMState(p, st.grid, st.max_vel)
    iters = []

    def step(s):
        s, it = ib2.implicit_step_binned2(sim, s, 5e-4, cfg, cg_tol=CG_TOL,
                                          rebin=False, with_stats=True)
        iters.append(it)
        return s
    out = b2.adaptive_chain(step, lambda s: b2.rebin_adaptive(sim, s, cfg),
                            b2.bin_state(sim, st, cfg), IMP_SMALL_STEPS)
    ch = b2.unbin_state(out, st).particles.channels
    return ({k: (v.flip(0) if reverse else v).cpu() for k, v in ch.items()},
            out, iters)


def implicit_card_vs_cpu(dev):
    phase("14 implicit card against CPU, same port")
    apply_op.LAUNCHES = 0
    g, gb, gi = _implicit_small(dev)
    launches = _apply_launches(gi, "the card's steps")
    c, cb, ci = _implicit_small(torch.device("cpu"))
    c_rev, _, ri = _implicit_small(torch.device("cpu"), reverse=True)
    _apply_launches(gi, "the CPU's plain version launched none: the card's "
                        "steps")
    print(f"  CG iterations per step: card {gi}, CPU {ci}, CPU reversed "
          f"{ri}", flush=True)
    for k, (a, b) in enumerate(zip(gi, ci)):
        if a != b:
            print(f"  step {k}: card {a} against CPU {b} CG iterations: the "
                  f"stopping test r.z > 1e-6 r0.z0 read on the two "
                  f"devices' sums in different orders", flush=True)
    check(all(abs(a - b) <= 1 for a, b in zip(gi, ci)),
          "CG iterations per step equal within 1")
    check(not bool(gb.overflow) and not bool(cb.overflow), "no overflow")
    for k in ("x", "v", "F"):
        spread = (c_rev[k] - c[k]).abs().max().item()
        err = (g[k] - c[k]).abs().max().item()
        check(err <= TOL_IMP[k] + spread,
              f"{k} max abs diff {err:.3g} <= {TOL_IMP[k]} + the CPU's own "
              f"spread over summation order {spread:.3g}")
    return launches


def poisson(dev, card):
    phase("15 CG Poisson (config 2)")
    xg, xc = (solvers.cg(scenes.laplace,
                         scenes.poisson_rhs(N_POISSON_SMALL, where),
                         max_iters=POISSON_ITERS, rel_tol=0.0).x.cpu()
              for where in (dev, torch.device("cpu")))
    err = (xg - xc).abs().max().item() / xc.abs().max().item()
    check(err <= 1e-5, f"{N_POISSON_SMALL}^3 after {POISSON_ITERS} "
                       f"iterations: the card's x = the CPU port's within "
                       f"{err:.3g} of max |x| (<= 1e-5)")
    b = scenes.poisson_rhs(N_POISSON, dev)
    out = {}

    def solve():
        out["res"] = solvers.cg(scenes.laplace, b, max_iters=POISSON_ITERS,
                                rel_tol=0.0)
    solve()                                       # warm-up
    ms = min(cuda_ms(solve, 1, warmup=0) for _ in range(3))
    check(out["res"].iters == POISSON_ITERS and bool(torch.isfinite(
        out["res"].x).all()), f"{POISSON_ITERS} iterations, x finite")
    n3 = N_POISSON ** 3
    gbs = POISSON_ITERS * 8 * n3 * 4 / (ms / 1e3) / 1e9
    print(f"  CG Poisson {N_POISSON}^3, {POISSON_ITERS} iterations: "
          f"{ms:.4f} ms (best of 3) = {POISSON_ITERS / ms * 1e3:.2f} "
          f"iterations/s, {gbs:.2f} GB/s under bench_poisson's byte model "
          f"(8 n^3 x 4 bytes an iteration, benchmarks/run_all.py:198); "
          f"that model's bound at 3.35 TB/s "
          f"{POISSON_ITERS * 8 * n3 * 4 / HBM_BYTES_PER_MS:.4f} ms ({card})",
          flush=True)
    return ms


def _timed_chains(step, rebin, bst, reps=3):
    """ms/step of ``reps`` IMP_CHAIN-step chains from ``bst`` (CUDA
    events), and each chain's final state."""
    times, outs = [], []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        outs.append(b2.adaptive_chain(step, rebin, bst, IMP_CHAIN))
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / IMP_CHAIN)
    return times, outs


def _bin_query(mc, bst, cfg):
    """The broad phase of ``mc`` per bin on ``bst``: (live, hits, counts,
    in_band)."""
    ctx = b2._make_ctx(bst, cfg)
    return mc._bin_query(ctx, ctx.alive.view(cfg.bins_capacity, b2.K))


def _bin_query_cpu(tri, mc, bst, cfg):
    """The same broad phase by the CPU port: the mesh built anew there, the
    bin state copied."""
    cpu = torch.device("cpu")
    mcc = ci.MeshContact.build(tri.cpu(), mc.dhat, mc.kappa,
                               max_tris=mc.max_tris, tile=mc.tile)
    return _bin_query(mcc, _to_device(bst, cpu), cfg)


def _query_counts(mc, query):
    """(live bins, bins with a triangle in reach, truncated, out of band,
    the most candidates of one bin, the overflow flag) of a
    :func:`_bin_query` result."""
    live, _, counts, band = (a.cpu() for a in query)
    trunc = live & (counts > mc.max_tris)
    return (int(live.sum()), int((live & (counts > 0)).sum()),
            int(trunc.sum()), int((live & ~band).sum()),
            int(torch.where(live, counts, 0).max()),
            bool((trunc | (live & ~band)).any()))


def _mass_gates(st, m0, n, what):
    """Finite columns, every particle alive, particle mass unchanged, grid
    mass within 1e-4 of particle mass on ``st``'s step."""
    check(bool(torch.isfinite(st.cols).all()), f"{what}: every column "
                                               f"finite")
    cols = _alive_cols(st)
    check(cols.shape[0] == n, f"{what}: every particle alive in bin order")
    m1 = cols[:, 24].double().sum().item()
    check(abs(m1 - m0) <= 1e-9 * m0,
          f"{what}: particle mass unchanged ({m1:.9g})")
    gmass = st.grid.data["m"].double().sum().item()
    check(abs(gmass - m1) <= 1e-4 * m1,
          f"{what}: grid mass {gmass:.9g} within 1e-4 of particle mass")


def contact_path(dev, card, free_ms):
    phase("16 contact at full width")
    tri = scenes.floor_mesh(FLOOR_Y, 0.0, 1.0, dev)
    sim, st, dt, cfg, mc = scenes.contact_block(N_IMP, tri, dev)
    print(f"  {N_IMP} particles (phase 13's block) over a 2-triangle floor "
          f"at y = {FLOOR_Y} spanning [0, 1]^2: dhat {mc.dhat}, kappa "
          f"{mc.kappa}, max_tris {mc.max_tris}, dt {dt}, cg_iters "
          f"{CG_ITERS}, cg_tol {CG_TOL}", flush=True)
    m0 = st.particles["m"].double().sum().item()
    iters, rebins, last = [], [0], {}

    def step(s):
        out, it = ib2.implicit_step_binned2(
            sim, s, dt, cfg, cg_iters=CG_ITERS, cg_tol=CG_TOL, contact=mc,
            rebin=False, with_stats=True)
        iters.append(it)
        last["st"] = out
        return out

    def rebin(s):
        rebins[0] += 1
        return b2.rebin_adaptive(sim, s, cfg)

    scan_op.LAUNCHES = nse_op.LAUNCHES = barrier_op.LAUNCHES = 0
    apply_op.LAUNCHES = 0
    with recorded_scans() as calls:
        bst = b2.bin_state(sim, st, cfg)
        torch.cuda.synchronize()
        launches_bin = scan_op.LAUNCHES
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        one, it0 = ib2.implicit_step_binned2(
            sim, bst, dt, cfg, cg_iters=CG_ITERS, cg_tol=CG_TOL, contact=mc,
            rebin=False, with_stats=True)
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        out = b2.adaptive_chain(step, rebin, bst, IMP_CHAIN)
        torch.cuda.synchronize()
        launches_chain = scan_op.LAUNCHES - launches_bin
        reb = b2.rebin_adaptive(sim, out, cfg)
        torch.cuda.synchronize()
    launches = scan_op.LAUNCHES
    check(nse_op.LAUNCHES == 0, "the contact path launched no NSE kernel "
                                "(its tree is the complete one)")
    _barrier_launches(1 + len(iters), "the contact path's steps")
    _apply_launches([it0] + iters, "the contact path's steps")
    print(f"  one step: {it0} CG iterations; {IMP_CHAIN}-step chain: CG "
          f"iterations per step {iters}, {rebins[0]} rebins; scan launches "
          f"{launches}: {launches_bin} in bin_state, {launches_chain} in "
          f"the chain, {launches - launches_bin - launches_chain} in the "
          f"final rebin", flush=True)
    check(launches_bin > 0 and launches > launches_bin + launches_chain,
          "bin_state and the final rebin launched the scan kernel")
    check(len(calls) == launches, f"{len(calls)} scans recorded")
    sizes = replay_scans(calls)
    check(True, f"every contact-path scan = plain on the same input, ints "
                f"exact; (n, op): {sizes}")
    check(not bool(one.overflow) and not bool(out.overflow)
          and not bool(reb.overflow),
          "no overflow (the broad phase's flag included; chain and rebin)")
    _mass_gates(one, m0, N_IMP, "one step")
    _mass_gates(last["st"], m0, N_IMP, "chain's last step")

    q = _bin_query(mc, bst, cfg)
    qc = _bin_query_cpu(tri, mc, bst, cfg)
    for name, a, b in zip(("live", "hits", "counts", "in_band"), q, qc):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"broad phase on the card differs from the "
                                 f"CPU's in {name}")
    nlive, reach, trunc, oob, most, _ = _query_counts(mc, q)
    check(True, f"broad phase on the card = the CPU port's on the same bin "
                f"state (hits, counts, band flags): {nlive} live bins, "
                f"{reach} with a triangle in reach, {trunc} truncated, "
                f"{oob} out of band, at most {most} candidates")

    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    free, it_free = ib2.implicit_step_binned2(
        sim, bst, dt, cfg, cg_iters=CG_ITERS, cg_tol=CG_TOL, rebin=False,
        with_stats=True)
    peak_free = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    _barrier_launches(1 + len(iters), "the contact-free step launched none: "
                                      "the contact path's steps")
    print(f"  peak device memory one step allocates above what was held: "
          f"{peak:.4f} GiB with contact, {peak_free:.4f} GiB without "
          f"({card})", flush=True)
    near = (bst.pid >= 0) & (bst.cols[:, 1] < FLOOR_Y + mc.dhat)
    vy_c = one.cols[near, 4].double().mean().item()
    vy_f = free.cols[near, 4].double().mean().item()
    check(int(near.sum()) > 0 and vy_c > vy_f,
          f"after one step the {int(near.sum())} particles within dhat of "
          f"the floor fall slower with contact: mean v_y {vy_c:.6f} > "
          f"{vy_f:.6f} without")
    ymin = _alive_cols(out)[:, 1].min().item()
    check(ymin > FLOOR_Y, f"no particle below the floor after the chain "
                          f"(min y {ymin:.6f} > {FLOOR_Y})")

    times, outs = _timed_chains(step, rebin, bst)
    check(not any(bool(o.overflow) for o in outs),
          "timed chains: no overflow")
    barrier = _barrier_launches(1 + len(iters), "the contact path's steps "
                                                "with the timed chains")
    applies = _apply_launches([it0, it_free] + iters, "the contact path's "
                              "steps, the contact-free step and the timed "
                              "chains")
    ms = min(times)
    print(f"  {IMP_CHAIN}-step chain best of 3: {ms:.4f} ms/step = "
          f"{N_IMP / ms / 1e3:.4f} M particle-steps/s (chains "
          f"{', '.join(f'{t:.4f}' for t in times)} ms/step; CG iterations "
          f"per step {iters[-IMP_CHAIN:]}); phase 13 without contact "
          f"{free_ms:.4f} ms/step: contact costs {ms - free_ms:.4f} ms a "
          f"step ({card})", flush=True)
    return launches, barrier, applies


def _barrier_launches(steps, what):
    """Checks one mesh barrier launch a narrow phase (``steps`` implicit
    steps with contact since the count was zeroed); returns the count."""
    check(barrier_op.LAUNCHES == steps,
          f"{what}: {barrier_op.LAUNCHES} mesh barrier launches in {steps} "
          f"narrow phases")
    return barrier_op.LAUNCHES


def _barrier_gap(name, got, want, mag, n):
    """The worst of |got - want| over its bound ``(2 n + 16) 2^-24 mag``:
    two float32 sums of a lane's n terms in two orders, each term rounded
    a few times apart, differ by at most that (``mag``: the sum of the
    terms' magnitudes, ``n`` the lane's candidates)."""
    g, w, m = (t.flatten(2).double().cpu() for t in (got, want, mag))
    bound = (2.0 * n.cpu()[:, None, None].double() + 16.0) * 2.0 ** -24 * m
    err = (g - w).abs()
    ratio = torch.where(err > 0, err / bound, 0.0)
    b, lane, e = np.unravel_index(int(ratio.argmax()), ratio.shape)
    print(f"    {name}: worst at bin {b}, lane {lane}, entry {e}: "
          f"{g[b, lane, e]:.9g} against {w[b, lane, e]:.9g}, sum of "
          f"magnitudes {m[b, lane, e]:.9g}, {int(n[b])} candidates",
          flush=True)
    return ratio.max().item()


def _barrier_replay(mc, bst, cfg, card):
    """The mesh barrier kernel against its plain version on the CPU (the
    same rounding of each pair, the same order of sums), on the contact
    set of ``bst``'s broad phase; prints the kernel's and the plain
    version's times on the card."""
    ctx = b2._make_ctx(bst, cfg)
    alive = ctx.alive.view(cfg.bins_capacity, b2.K)
    xb = bst.cols[:, 0:3].view(cfg.bins_capacity, b2.K, 3)   # a view
    hits = mc.broad_phase(ctx, alive).hits
    args = (xb, alive, hits, mc.tri, mc.dhat, mc.kappa)
    cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args)
    n0 = barrier_op.LAUNCHES
    fc, Hc, work = barrier_op.mesh_barrier(*args)
    check(barrier_op.LAUNCHES == n0 + 1, "one mesh barrier launch a call")
    ncand = (hits >= 0).sum(1)
    mag_f, mag_H = barrier_op.term_magnitudes(*cpu_args)
    pfc, pHc, pwork = barrier_op.mesh_barrier_reference(*cpu_args)
    check(torch.equal(work.cpu(), pwork),
          f"work counts equal the plain version's: pairs {int(work[0]):,}, "
          f"lanes in reach {int(work[1]):,}, candidates {int(work[2]):,}, "
          f"active pairs (d < dhat) {int(work[3]):,}")
    worst = max(_barrier_gap("fc", fc, pfc, mag_f, ncand),
                _barrier_gap("Hc", Hc, pHc, mag_H, ncand))
    check(worst <= 1.0, f"forces and Hessians = the plain version's on the "
                        f"CPU within (2 n + 16) 2^-24 of each entry's sum "
                        f"of magnitudes (worst {worst:.4f} of that)")
    # torch's CUDA operators round a pair's d^2 an ulp apart from these
    # (the CPU's and the kernel's agree), and near d = dhat a term carries
    # (d^2 - dhat^2)^2, whose relative rounding there has no bound: printed
    cfc, cHc, _ = barrier_op.mesh_barrier_reference(*args)
    print("  the plain version on the card, widest gaps to the kernel over "
          "the largest entry: " + ", ".join(
              f"{k} {((a - b).abs().max() / b.abs().max()).item():.3e}"
              for k, a, b in (("fc", fc, cfc), ("Hc", Hc, cHc))),
          flush=True)
    # two device activities a call: the kernel and the zeroing of its
    # four work counters
    kern = split(f"mesh barrier kernel, {mc.tri.shape[0]} triangles, "
                 f"max_tris {mc.max_tris}", lambda: barrier_op.mesh_barrier(
                     *args), card, kernel=False)
    kern["plain_ms"] = cuda_ms(
        lambda: barrier_op.mesh_barrier_reference(*args), 5, warmup=1)
    kern["worst_of_bound"] = worst
    kern.update(_barrier_bound(work, xb.shape[0] * xb.shape[1], card))
    print(f"  plain version on the card: {kern['plain_ms']:.4f} ms a call; "
          f"least time {kern['bound_ms']:.6f} ms ({kern['bound_by']}-bound, "
          f"portbench/metrics/contact_narrow_roofline.py's count): "
          f"{100 * kern['bound_ms'] / kern['device_ms']:.2f}% of it "
          f"({card})", flush=True)
    return kern


def _barrier_bound(work, lanes, card):
    """The least time of one narrow phase that did ``work`` (pairs, lanes,
    tris, active) over ``lanes`` lanes, counted as the benchmark's
    ``contact_narrow_roofline`` counts it, at the card's published
    peaks."""
    from portbench.harness.peaks import peaks_for
    roof = importlib.import_module("portbench.metrics.contact_narrow_roofline")
    peaks = peaks_for(card)
    w = dict(zip(roof.KEYS, (int(v) for v in work)))
    flop_s = (w["tris"] * roof.FLOPS_PER_TRI + w["pairs"] *
              roof.FLOPS_PER_PAIR + w["active"] * roof.FLOPS_PER_ACTIVE) / \
        peaks["fp32_flop_per_s"]
    least = roof.least_seconds(1, lanes, w, peaks)
    return {"bound_ms": 1e3 * least,
            "bound_by": "flops" if least == flop_s else "bytes"}


def config5_rows(dev, card):
    phase("17 config 5's contact rows at the benchmark's settings")
    launches, applies = {}, {}
    for res in TERRAIN_RES:
        tri = scenes.terrain_mesh(res, dev)
        sim, st, dt, cfg, mc = scenes.contact_block(N_IMP, tri, dev)
        max_tris, tile = TERRAIN_CONTACT[res]
        mc = dataclasses.replace(mc, max_tris=max_tris, tile=tile)
        m0 = st.particles["m"].double().sum().item()
        bst = b2.bin_state(sim, st, cfg)
        counts = _query_counts(mc, _bin_query(mc, bst, cfg))
        counts_c = _query_counts(mc, _bin_query_cpu(tri, mc, bst, cfg))
        check(counts == counts_c and not counts[5],
              f"{tri.shape[0]} triangles, max_tris {max_tris}, tile {tile}: "
              f"no overflow, as on the CPU port on the same bin state; live "
              f"bins {counts[0]}, {counts[1]} with a triangle in reach, "
              f"{counts[2]} truncated, {counts[3]} out of band, at most "
              f"{counts[4]} candidates")
        iters = []
        barrier_op.LAUNCHES = apply_op.LAUNCHES = 0

        def step(s):
            out, it = ib2.implicit_step_binned2(
                sim, s, dt, cfg, cg_iters=CG_ITERS, cg_tol=CG_TOL,
                contact=mc, rebin=False, with_stats=True)
            iters.append(it)
            return out
        one = step(bst)
        check(not bool(one.overflow), f"one step: no overflow, {iters[0]} "
                                      f"CG iterations")
        _mass_gates(one, m0, N_IMP, f"{tri.shape[0]} triangles, one step")
        times, outs = _timed_chains(
            step, lambda s: b2.rebin_adaptive(sim, s, cfg), bst)
        check(all(bool(torch.isfinite(o.cols).all()) and
                  not bool(o.overflow) for o in outs),
              f"{tri.shape[0]} triangles: the chains' columns finite, no "
              f"overflow")
        launches[res] = _barrier_launches(
            len(iters), f"{tri.shape[0]} triangles, one step and the chains")
        applies[res] = _apply_launches(
            iters, f"{tri.shape[0]} triangles, one step and the chains")
        ms = min(times)
        print(f"  config 5 + LBVH contact, {tri.shape[0]} triangles: "
              f"{ms:.4f} ms/step best of 3 = {N_IMP / ms / 1e3:.4f} M "
              f"particle-steps/s (chains "
              f"{', '.join(f'{t:.4f}' for t in times)} ms/step; CG "
              f"iterations per step {iters[-IMP_CHAIN:]}; {card})",
              flush=True)
        kern = _barrier_replay(mc, bst, cfg, card)
    return launches, applies, kern


def _apply_bound(sys, card):
    """The least time of one application at the card's published peaks,
    from csrc/implicit_apply.cu's count (its note, "Bound"): a live lane's
    position, F, volume, the step's U, s and V, per-lane Lame fields and
    Hc; every lane's alive flag; each bin's 12 ints; u and gm read and the
    output written once a node; 2,070 flops a live lane, 18 more with
    Hc."""
    from portbench.harness.peaks import peaks_for
    peaks = peaks_for(card)
    L = sys.x.shape[0]
    live = int(sys.ctx.alive.sum())
    hc = sys.Hc is not None
    lane = 4 * (3 + 9 + 1 + 9 + 3 + 9 + (9 if hc else 0))
    lane += 4 * ((sys.mu.numel() > 1) + (sys.lam.numel() > 1))
    nodes = sys.gm.numel()
    nbytes = live * lane + L + (L // b2.K) * 4 * 12 + nodes * 4 * (3 + 1 + 3)
    flops = live * (2_070 + (18 if hc else 0))
    t_b = nbytes / peaks["hbm_bytes_per_s"]
    t_f = flops / peaks["fp32_flop_per_s"]
    return {"bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "flops",
            "bound_bytes": nbytes}


def implicit_apply_path(dev, card):
    phase("17b the implicit operator kernel at the cells' shape")
    for kernel, regs, smem, spill in _ptxas_lines(
            _kernels.ptxas_report("implicit_apply")):
        check(spill == 0, f"{kernel}: {regs} registers, {smem} B shared "
                          f"memory, no spill (ptxas -v)")
    res = TERRAIN_RES[0]
    tri = scenes.terrain_mesh(res, dev)
    sim, st, dt, cfg, mc = scenes.contact_block(N_IMP, tri, dev)
    mc = dataclasses.replace(mc, max_tris=TERRAIN_CONTACT[res][0],
                             tile=TERRAIN_CONTACT[res][1])
    bst = b2.bin_state(sim, st, cfg)
    iters = []
    apply_op.LAUNCHES = 0

    def step(s):
        out, it = ib2.implicit_step_binned2(
            sim, s, dt, cfg, cg_iters=CG_ITERS, cg_tol=CG_TOL, contact=mc,
            rebin=False, with_stats=True)
        iters.append(it)
        return out
    # three steps over the terrain, so F is off I and the barrier is on
    for _ in range(3):
        bst = step(bst)
    torch.cuda.synchronize()
    launches = _apply_launches(iters, "three steps over the terrain")
    ctx = b2._make_ctx(bst, cfg)
    lanes = b2._lanes(bst, ctx)
    xb, _, Fb, _, m, vol = lanes
    L, B = xb.shape[0], cfg.bins_capacity
    model = b2._lane_model(sim.model, bst.pid)
    gm = b2._ctx_p2g_affine(ctx, m[:, None],
                            torch.zeros((L, 1, 3), device=dev))[..., 0]
    alive = ctx.alive.view(B, b2.K)
    cset = mc.broad_phase(ctx, alive)
    _, Hc, _ = barrier_op.mesh_barrier(xb.view(B, b2.K, 3), alive, cset.hits,
                                       mc.tri, mc.dhat, mc.kappa)
    Hc = Hc.view(L, 3, 3)
    gen = torch.Generator(device=dev).manual_seed(0)
    u = 0.1 * torch.randn(tuple(gm.shape) + (3,), generator=gen, device=dev)
    u = torch.where((gm > 0)[..., None], u, 0.0)
    print(f"  {int(ctx.alive.sum()):,} live lanes in {B} bins, "
          f"{int((gm > 0).sum()):,} massive nodes of {gm.numel():,}; "
          f"{int((Hc.abs().sum((1, 2)) > 0).sum()):,} lanes with a barrier "
          f"Hessian ({tri.shape[0]} triangles); CG iterations per step "
          f"{iters}", flush=True)
    out = {}
    for label, H in (("no contact", None), ("contact", Hc)):
        sys = apply_op.corotated_system(ctx, bst.bin_block, bst.nbr8, xb,
                                        Fb, vol, model.mu, model.lam, H,
                                        gm, dt)
        n0 = apply_op.LAUNCHES
        got = apply_op.implicit_apply(sys, u)
        torch.cuda.synchronize()
        check(apply_op.LAUNCHES == n0 + 1, f"{label}: one kernel launch a "
                                           f"call")
        plain = apply_op.implicit_apply_reference(sys, u)
        want = apply_op.implicit_apply_reference(apply_op.as_float64(sys),
                                                 u.double())
        scale = (want - sys.gm.double()[..., None] * u.double()).abs().max()
        gaps = {k: ((v.double() - want).abs().max() / scale).item()
                for k, v in (("kernel", got), ("plain", plain))}
        check(gaps["kernel"] <= 1e-5 and gaps["plain"] <= 1e-5,
              f"{label}: kernel and plain version (float32, on the card) "
              f"within 1e-5 of the largest stiffness entry of the plain "
              f"version in float64 (kernel {gaps['kernel']:.3e}, plain "
              f"{gaps['plain']:.3e})")
        # the composition the kernel replaced: G2P, the jvp, P2G
        FbT = Fb.transpose(-1, -2)
        kscale = (dt * ctx.dinv * vol)[:, None, None]
        dP_dF = model.linearize(Fb)

        def composition():
            s0, dC = b2._ctx_g2p(ctx, u)
            dP = dP_dF(dt * mm33(dC, Fb))
            Qk = None if H is None else (dt * dt) * torch.bmm(
                H, s0[..., None])[..., 0]
            return gm[..., None] * u + b2._ctx_p2g_affine(
                ctx, Qk, kscale * mm33(dP, FbT))
        gaps["composition"] = ((composition().double() - want).abs().max()
                               / scale).item()
        # two device activities a call: gm u and the kernel
        kern = split(f"operator kernel, {label}",
                     lambda: apply_op.implicit_apply(sys, u), card,
                     kernel=False)
        kern["plain_ms"] = cuda_ms(
            lambda: apply_op.implicit_apply_reference(sys, u), 5, warmup=1)
        kern["composition_ms"] = cuda_ms(composition, 5, warmup=1)
        kern.update(_apply_bound(sys, card))
        kern["gaps"] = gaps
        print(f"  {label}: plain fused version {kern['plain_ms']:.4f} ms, "
              f"the composition it replaced {kern['composition_ms']:.4f} ms "
              f"a call (gap {gaps['composition']:.3e}); least time "
              f"{kern['bound_ms']:.6f} ms ({kern['bound_by']}-bound, "
              f"{kern['bound_bytes'] / 1e6:.1f} MB): "
              f"{100 * kern['bound_ms'] / kern['device_ms']:.2f}% of the "
              f"kernel's device time ({card})", flush=True)
        out[label] = kern
    return launches, out


def _contact_small(dev, reverse=False):
    """tests/test_contact_implicit.py's 100-step scene for CSMALL_STEPS
    steps, then one contact_precond step; ``reverse`` feeds the particles
    in reverse order.  Returns (state after the chain, state after the
    precond step, in the scene's order; CG iterations per step; min y
    over the run)."""
    rng = np.random.default_rng(42)
    x = np.stack([rng.uniform(0.3, 0.7, N_CSMALL),
                  rng.uniform(0.22, 0.42, N_CSMALL),
                  rng.uniform(0.3, 0.7, N_CSMALL)], -1).astype(np.float32)
    if reverse:
        x = np.ascontiguousarray(x[::-1])
    st = mpm_mod.make_mpm_state(x, dx=0.05, device=dev, block_capacity=512)
    sim = mpm_mod.MPMSim(
        model=FixedCorotated.from_young_poisson(1e4, 0.3, device=dev),
        gravity=torch.tensor([0.0, -9.8, 0.0], device=dev))
    cfg = b2.BinnedConfig2(bins_capacity=96)
    mc = ci.MeshContact.build(
        scenes.floor_mesh(CSMALL_FLOOR, -1.0, 2.0, dev), CSMALL_DHAT, 2e4,
        max_tris=4, use_ccd=True)
    iters, ymin, overflow = [], [np.inf], []

    def step(s, **kw):
        s, it = ib2.implicit_step_binned2(sim, s, 2e-3, cfg, cg_iters=30,
                                          contact=mc, with_stats=True, **kw)
        iters.append(it)
        ymin[0] = min(ymin[0], _alive_cols(s)[:, 1].min().item())
        overflow.append(bool(s.overflow))
        return s
    out = b2.adaptive_chain(lambda s: step(s, rebin=False),
                            lambda s: b2.rebin_adaptive(sim, s, cfg),
                            b2.bin_state(sim, st, cfg), CSMALL_STEPS)
    pre = step(out, rebin=True, contact_precond=True)
    check(not any(overflow), f"{dev}: no overflow in any step")

    def channels(s):
        ch = b2.unbin_state(s, st).particles.channels
        return {k: (v.flip(0) if reverse else v).cpu()
                for k, v in ch.items()}
    return channels(out), channels(pre), iters, ymin[0]


def contact_card_vs_cpu(dev):
    phase("18 contact card against CPU, same port")
    barrier_op.LAUNCHES = apply_op.LAUNCHES = 0
    g, gp, g_it, gy = _contact_small(dev)
    launches = _barrier_launches(len(g_it), "the card's steps")
    applies = _apply_launches(g_it, "the card's steps")
    c, cp, c_it, cy = _contact_small(torch.device("cpu"))
    r, rp, r_it, _ = _contact_small(torch.device("cpu"), reverse=True)
    _barrier_launches(len(g_it), "the CPU's plain version launched none: "
                                 "the card's steps")
    _apply_launches(g_it, "the CPU's plain version launched none: the "
                          "card's steps")
    print(f"  CG iterations per step ({CSMALL_STEPS} steps, then the "
          f"contact_precond step): card {g_it}, CPU {c_it}, CPU reversed "
          f"{r_it}", flush=True)
    check(all(abs(a - b) <= 1 for a, b in zip(g_it, c_it)),
          "CG iterations per step equal within 1")
    floor = CSMALL_FLOOR - CSMALL_DHAT
    check(gy > floor and cy > floor,
          f"no particle below floor - dhat = {floor} (min y: card {gy:.6f}, "
          f"CPU {cy:.6f})")
    for what, (a, b, rev) in (("chain", (g, c, r)),
                              ("contact_precond step", (gp, cp, rp))):
        for k in ("x", "v", "F"):
            spread = (rev[k] - b[k]).abs().max().item()
            err = (a[k] - b[k]).abs().max().item()
            check(err <= TOL_IMP[k] + spread,
                  f"{what}: {k} max abs diff {err:.3g} <= {TOL_IMP[k]} + the "
                  f"CPU's own spread over summation order {spread:.3g}")
    return launches, applies


def _same(got, ref, what):
    """Integer (or bool) results equal, element for element."""
    got = got.cpu()
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} on the "
                             f"card, {ref.dtype}{tuple(ref.shape)} on the "
                             f"CPU")
    if got.dtype == torch.uint32:
        got, ref = got.to(torch.int64), ref.to(torch.int64)
    if not torch.equal(got, ref):
        bad = torch.nonzero(got != ref)[:5].flatten().tolist()
        raise AssertionError(f"{what}: card differs from the CPU port at "
                             f"{bad}")


def _within_abs_sum(got, ref, scale, what, rel=1e-5):
    """|card - CPU| <= rel * scale element for element, scale the sum of
    |terms| each element adds; returns the largest difference."""
    err = (got.cpu().double() - ref.double()).abs()
    if not bool((err <= rel * scale.double()).all()):
        raise AssertionError(f"{what}: max abs diff {err.max().item():.3g} "
                             f"over {rel} of the sum of |terms|")
    return err.max().item()


def _timed(label, fn, lib_label, lib, n, bytes_moved, card, keys=False):
    """Best of 3 windows of back-to-back calls between CUDA events, device
    time from torch.profiler, the same for one PyTorch call computing the
    same function, and the byte bound at 3.35 TB/s; printed."""
    reps = 50 if n > 2_000_000 else 200
    ms = min(cuda_ms(fn, reps) for _ in range(3))
    dev_ms, per_call, _ = device_split(fn)
    lms = min(cuda_ms(lib, reps) for _ in range(3))
    ldev, lper, _ = device_split(lib)
    bound = bytes_moved / HBM_BYTES_PER_MS
    rate = (f"{n / ms / 1e3:.1f} Mkeys/s" if keys
            else f"{bytes_moved / ms / 1e6:.1f} GB/s")
    print(f"  {label} n={n}: {ms:.6f} ms best of 3 ({rate}), device "
          f"{dev_ms:.6f} ms ({per_call:g} device activities); bound "
          f"{bound:.6f} ms ({bytes_moved} bytes at 3.35 TB/s); {lib_label}: "
          f"{lms:.6f} ms, device {ldev:.6f} ms ({lper:g} activities) "
          f"({card})", flush=True)
    return {"ms": ms, "device_ms": dev_ms, "bound_ms": bound,
            "library_ms": lms, "library_device_ms": ldev}


def _config1_size(n, pol, cpu, rng, dev):
    """Every primitive of config 1 at ``n`` on the card, each result held
    against the CPU port's on the same input."""
    f = rng.standard_normal(n).astype(np.float32)
    a = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    k = rng.integers(0, 4096, n).astype(np.int32)
    h = rng.integers(0, 65_536, n).astype(np.int32)
    inputs = {name: torch.from_numpy(x) for name, x in
              (("f", f), ("a", a), ("k", k), ("h", h))}
    inputs["v"] = torch.arange(n, dtype=torch.int32)
    inputs["k128"] = inputs["k"] % 128
    inputs["h256"] = inputs["h"] % 256
    inputs["sk"] = torch.sort(inputs["k"]).values
    inputs["pos"] = inputs["a"] > 0
    g = {name: x.to(dev) for name, x in inputs.items()}
    absf = inputs["f"].abs()
    # reductions: integers exact, f32 within 1e-5 of sum |x|
    for op in ("add", "min", "max"):
        _same(zpc_tpu_torch.reduce(pol, g["a"], op),
              zpc_tpu_torch.reduce(cpu, inputs["a"], op), f"reduce {op} "
                                                          f"int32 n={n}")
    err = _within_abs_sum(zpc_tpu_torch.reduce(pol, g["f"]),
                          zpc_tpu_torch.reduce(cpu, inputs["f"]),
                          absf.double().sum(), f"reduce add f32 n={n}")
    # scans: integers exact; f32 prefix i within 1e-5 of sum_{j<=i} |x_j|
    prefix = torch.cumsum(absf.double(), 0)
    for fn in (zpc_tpu_torch.inclusive_scan, zpc_tpu_torch.exclusive_scan):
        _same(fn(pol, g["a"]), fn(cpu, inputs["a"]),
              f"{fn.__name__} int32 n={n}")
    err = max(err, _within_abs_sum(
        zpc_tpu_torch.inclusive_scan(pol, g["f"]),
        zpc_tpu_torch.inclusive_scan(cpu, inputs["f"]), prefix,
        f"inclusive_scan f32 n={n}"))
    err = max(err, _within_abs_sum(
        zpc_tpu_torch.exclusive_scan(pol, g["f"]),
        zpc_tpu_torch.exclusive_scan(cpu, inputs["f"]),
        torch.cat([prefix.new_zeros(1), prefix[:-1]]),
        f"exclusive_scan f32 n={n}"))
    # sorts: keys and permutations exact
    calls = [
        ("sort", zpc_tpu_torch.sort, ("a",), {}),
        ("radix_sort", zpc_tpu_torch.radix_sort, ("a",), {}),
        ("radix_sort [4, 20)", zpc_tpu_torch.radix_sort, ("a",),
         dict(sbit=4, ebit=20)),
        ("sort_pair packed", zpc_tpu_torch.sort_pair, ("k128", "v"),
         dict(key_bound=128, val_bound=n)),
        ("radix_sort_pair wide window", zpc_tpu_torch.radix_sort_pair,
         ("a", "v"), dict(sbit=0, ebit=30)),
        ("merge_sort_pair", zpc_tpu_torch.merge_sort_pair, ("k", "v"), {}),
        ("argsort_stable", primitives.argsort_stable, ("k",), {}),
        ("histogram 256", zpc_tpu_torch.histogram, ("h256", 256), {}),
        ("histogram 65,536", zpc_tpu_torch.histogram, ("h", 65_536), {}),
        ("segment_reduce max", zpc_tpu_torch.segment_reduce,
         ("a", "k", 4096), dict(op="max")),
        ("select_if", zpc_tpu_torch.select_if, ("a", "pos"), {}),
        ("unique", zpc_tpu_torch.unique, ("sk",), {})]
    for name, fn, args, kw in calls:
        got = fn(pol, *(g[x] if isinstance(x, str) else x for x in args),
                 **kw)
        ref = fn(cpu, *(inputs[x] if isinstance(x, str) else x
                        for x in args), **kw)
        for i, (gt, rf) in enumerate(zip(
                got if isinstance(got, tuple) else (got,),
                ref if isinstance(ref, tuple) else (ref,))):
            _same(gt, rf, f"{name} n={n} output {i}")
    # the unpacked pair sort orders ties as it likes: keys exact, the
    # (key, value) pairs equal as a multiset
    ko, vo = zpc_tpu_torch.sort_pair(pol, g["k"], g["v"])
    rk, rv = zpc_tpu_torch.sort_pair(cpu, inputs["k"], inputs["v"])
    _same(ko, rk, f"sort_pair keys n={n}")
    pairs = (ko.long() << 32) | vo.long()
    _same(torch.sort(pairs).values, torch.sort((rk.long() << 32) |
                                               rv.long()).values,
          f"sort_pair (key, value) multiset n={n}")
    # segment sums of f32 within 1e-5 of each segment's sum |x|
    seg = torch.zeros(4096, dtype=torch.float64).index_add_(
        0, inputs["k"].long(), absf.double())
    err = max(err, _within_abs_sum(
        zpc_tpu_torch.segment_reduce(pol, g["f"], g["k"], 4096),
        zpc_tpu_torch.segment_reduce(cpu, inputs["f"], inputs["k"], 4096),
        seg, f"segment_reduce add f32 n={n}"))
    names = [c[0] for c in calls]
    return g, err, names


def _uint32_ops(pol, cpu, rng, dev, n=1_048_576):
    """The uint32 forms (computed in int64 where PyTorch lacks uint32
    arithmetic) on this machine's torch, against the CPU port."""
    u = torch.from_numpy(rng.integers(0, 2 ** 32, n, dtype=np.uint64)
                         .astype(np.uint32))
    gu = u.to(dev)
    for name, fn, kw in (
            ("reduce add", zpc_tpu_torch.reduce, {}),
            ("reduce max", zpc_tpu_torch.reduce, dict(op="max")),
            ("inclusive_scan add", zpc_tpu_torch.inclusive_scan, {}),
            ("inclusive_scan max", zpc_tpu_torch.inclusive_scan,
             dict(op="max")),
            ("exclusive_scan", zpc_tpu_torch.exclusive_scan, {}),
            ("sort", zpc_tpu_torch.sort, {}),
            ("radix_sort [4, 20)", zpc_tpu_torch.radix_sort,
             dict(sbit=4, ebit=20)),
            ("argsort_stable", primitives.argsort_stable, {})):
        _same(fn(pol, gu, **kw), fn(cpu, u, **kw), f"uint32 {name} n={n}")
    su = zpc_tpu_torch.sort(cpu, u)
    for gt, rf in zip(zpc_tpu_torch.unique(pol, su.to(dev)),
                      zpc_tpu_torch.unique(cpu, su)):
        _same(gt, rf, f"uint32 unique n={n}")


def config1(dev, card):
    phase("19 BASELINE config 1: the primitives through tpu_exec()")
    pol = zpc_tpu_torch.tpu_exec()
    check(pol.device == dev and not pol.is_sequential,
          f"tpu_exec() is the card's policy ({pol.device})")
    cpu = zpc_tpu_torch.seq_exec()
    rng = np.random.default_rng(0)
    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    inputs, max_err = {}, 0.0
    with recorded_scans() as calls:
        for n in CONFIG1_SIZES:
            inputs[n], err, names = _config1_size(n, pol, cpu, rng, dev)
            max_err = max(max_err, err)
        _uint32_ops(pol, cpu, rng, dev)
        torch.cuda.synchronize()
    launches = scan_op.LAUNCHES
    check(nse_op.LAUNCHES == 0, "config 1 launched no NSE kernel")
    check(True, f"at n = {', '.join(map(str, CONFIG1_SIZES))}: reduce "
                f"(add, min, max), both scans (int32, f32), "
                f"{', '.join(names)}, the unpacked sort_pair and the f32 "
                f"segment sum on the card = the CPU port's (integers and "
                f"permutations exact; f32 within 1e-5 of the sum of |terms|, "
                f"max abs diff {max_err:.3g}); the uint32 forms at 1,048,576 "
                f"exact")
    check(len(calls) == launches and launches > 0,
          f"{launches} scan launches, all recorded")
    sizes = replay_scans(calls, f32=True)
    check(True, f"every config-1 scan = plain on the same input (ints "
                f"exact, f32 add within 1e-5 of the prefix sums of |x|); "
                f"(n, op): {sizes}")
    times = {}
    for n in CONFIG1_SIZES:
        g = inputs[n]
        f, a = g["f"], g["a"]
        times[("reduce", n)] = _timed(
            "reduce add f32", lambda: zpc_tpu_torch.reduce(pol, f),
            "torch.sum", lambda: torch.sum(f), n, 4 * n + 4, card)
        times[("exclusive_scan", n)] = _timed(
            "exclusive_scan add f32",
            lambda: zpc_tpu_torch.exclusive_scan(pol, f), "torch.cumsum",
            lambda: torch.cumsum(f, 0), n, 8 * n, card)
        times[("radix_sort", n)] = _timed(
            "radix_sort int32", lambda: zpc_tpu_torch.radix_sort(pol, a),
            "torch.sort", lambda: torch.sort(a), n, 8 * n, card, keys=True)
    return launches, times


def _laplace_coo(m):
    """The 7-point Laplacian of an m^3 grid as COO triplets with
    duplicates: each diagonal entry 6 as two triplets of 3, each
    off-diagonal -1 once per direction."""
    idx = np.arange(m ** 3).reshape(m, m, m)
    rows, cols, vals = [idx.ravel()] * 2, [idx.ravel()] * 2, \
        [np.full(m ** 3, 3.0)] * 2
    for axis in range(3):
        for lo, hi in ((slice(None, -1), slice(1, None)),
                       (slice(1, None), slice(None, -1))):
            sl_a = [slice(None)] * 3
            sl_b = [slice(None)] * 3
            sl_a[axis], sl_b[axis] = lo, hi
            rows.append(idx[tuple(sl_a)].ravel())
            cols.append(idx[tuple(sl_b)].ravel())
            vals.append(np.full(rows[-1].shape, -1.0))
    return (torch.from_numpy(np.concatenate(rows).astype(np.int32)),
            torch.from_numpy(np.concatenate(cols).astype(np.int32)),
            torch.from_numpy(np.concatenate(vals).astype(np.float32)))


def _same_fields(got, ref, what, names):
    for name in names:
        _same(getattr(got, name), getattr(ref, name), f"{what} {name}")


def containers_path(dev, card):
    phase("20 containers, sparse grid, CSR and graphs on the card")
    from zpc_tpu_torch.containers import block_table as bt
    from zpc_tpu_torch.containers import index_buckets as ibk
    from zpc_tpu_torch.containers import ordered_map as om
    from zpc_tpu_torch.geometry import sparse_grid as sg
    from zpc_tpu_torch.math import sparse as sp
    from zpc_tpu_torch.utils import graph as gr
    cpu = torch.device("cpu")
    rng = np.random.default_rng(1)
    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    with recorded_scans() as calls:
        # OrderedMap: 1,048,576 keys with duplicates into 2,097,152 slots
        keys = torch.from_numpy(rng.integers(0, 1 << 21, 1 << 20)
                                .astype(np.int32))
        vals = torch.from_numpy(rng.standard_normal(1 << 20)
                                .astype(np.float32))
        q = torch.from_numpy(rng.integers(0, 1 << 21, 65_536)
                             .astype(np.int32))
        maps = [om.ordered_map(1 << 21, device=d).insert(keys.to(d),
                                                         vals.to(d))
                for d in (dev, cpu)]
        _same_fields(maps[0], maps[1], "OrderedMap.insert",
                     ("keys", "values", "count"))
        _same(maps[0].find(q.to(dev)), maps[1].find(q), "OrderedMap.find")
        _same(maps[0].get(q.to(dev), -1.0), maps[1].get(q, -1.0),
              "OrderedMap.get")
        erased = [m.erase(q.to(d)) for m, d in zip(maps, (dev, cpu))]
        _same_fields(erased[0], erased[1], "OrderedMap.erase",
                     ("keys", "values", "count"))
        check(True, f"OrderedMap (capacity 2,097,152): insert of 1,048,576 "
                    f"keys ({int(maps[1].count)} distinct), find, get and "
                    f"erase of 65,536 ({int(erased[1].count)} left) = the "
                    f"CPU port's")
        # IndexBuckets over 1,048,576 points at dx = 1/128
        x = torch.from_numpy(rng.random((1 << 20, 3), dtype=np.float32))
        xq = torch.from_numpy(rng.random((65_536, 3), dtype=np.float32))
        ibs = [ibk.build_index_buckets(x.to(d), 1 / 128, 1 << 20)
               for d in (dev, cpu)]
        _same_fields(ibs[0], ibs[1], "IndexBuckets", ("offsets", "indices",
                                                      "count"))
        _same(ibs[0].table.keys, ibs[1].table.keys, "IndexBuckets table")
        cand = [ibk.neighbor_candidates(ib, xq.to(d), 4)
                for ib, d in zip(ibs, (dev, cpu))]
        for gt, rf in zip(*cand):
            _same(gt, rf, "neighbor_candidates")
        check(True, f"IndexBuckets of 1,048,576 points at dx = 1/128 "
                    f"({int(ibs[1].table.count)} cells) and 65,536 "
                    f"neighbourhoods of 27 cells x 4 = the CPU port's")
        # a wide-key block table over 1,048,576 far coordinates
        far = torch.from_numpy(np.stack(
            [rng.integers(-(1 << 28), 1 << 28, 1 << 20),
             rng.integers(-16_000, 16_000, 1 << 20),
             rng.integers(-32_000, 32_000, 1 << 20)], -1).astype(np.int32))
        far = torch.cat([far, far[: 1 << 18]])             # duplicates
        wts = [bt.build_wide_block_table(far.to(d), 1 << 20)
               for d in (dev, cpu)]
        _same_fields(wts[0][0], wts[1][0], "WideBlockTable",
                     ("kx", "kyz", "count"))
        _same(wts[0][1], wts[1][1], "WideBlockTable inverse")
        _same(wts[0][0].query(far[:65_536].to(dev)),
              wts[1][0].query(far[:65_536]), "WideBlockTable.query")
        check(True, f"build_wide_block_table over {far.shape[0]} far "
                    f"coordinates ({int(wts[1][0].count)} blocks) and "
                    f"65,536 queries = the CPU port's")
        # a wide-key sparse grid: 262,144 points in cells 5,120-5,183 of
        # each axis (blocks past the packed key's +-512)
        pts = torch.from_numpy(80.0 + rng.random((1 << 18, 3),
                                                 dtype=np.float32))
        grids, samples = [], []
        for d in (dev, cpu):
            g = sg.sparse_grid([zpc_tpu_torch.prop("rho")], dx=1 / 64,
                               block_capacity=8192, device=d,
                               wide_keys=True)
            cells = torch.floor(g.world_to_index(pts.to(d))).to(torch.int32)
            g, slots = g.activate_with_slots(
                torch.div(cells, 4, rounding_mode="floor"), dilation=1)
            grids.append((g, slots))
        _same_fields(grids[0][0].table, grids[1][0].table, "sparse grid "
                     "table", ("kx", "kyz", "count"))
        _same(grids[0][1], grids[1][1], "activate_with_slots slots")
        nw = grids[1][0].node_world_positions()
        rho = (torch.sin(3 * nw[..., 0]) + nw[..., 1] * nw[..., 2]) * \
            grids[1][0].table.mask[:, None]
        for (g, _), d in zip(grids, (dev, cpu)):
            g = g.with_data(rho=rho.to(d))
            samples.append((g.sample("rho", pts.to(d)),
                            g.sample_gradient("rho", pts.to(d))))
        (s_g, d_g), (s_c, d_c) = samples
        e_s = (s_g.cpu() - s_c).abs().max().item()
        e_d = (d_g.cpu() - d_c).abs().max().item()
        check(e_s <= 1e-6 * s_c.abs().max().item() and
              e_d <= 1e-6 * d_c.abs().max().item(),
              f"sparse_grid(wide_keys=True): {int(grids[1][0].table.count)} "
              f"blocks; sample and sample_gradient at 262,144 points = the "
              f"CPU port's within 1e-6 of their largest (max abs diff "
              f"{e_s:.3g}, {e_d:.3g})")
        # CSR: the 7-point Laplacian at 64^3 from triplets with duplicates
        r, c, v = _laplace_coo(LAPLACE_M)
        nr = LAPLACE_M ** 3
        mats = [sp.csr_from_coo(r.to(d), c.to(d), v.to(d), nr, nr)
                for d in (dev, cpu)]
        _same_fields(mats[0], mats[1], "csr_from_coo",
                     ("indptr", "cols", "vals", "nnz"))
        xv = torch.from_numpy(rng.standard_normal(nr).astype(np.float32))
        y = [sp.spmv(A, xv.to(A.cols.device)) for A in mats]
        scale = sp.spmv(sp.CSRMatrix(mats[1].indptr, mats[1].cols,
                                     mats[1].vals.abs(), mats[1].nnz, nr,
                                     nr), xv.abs())
        e_y = _within_abs_sum(y[0], y[1], scale, "spmv", rel=1e-6)
        mp = [sp.spmv_semiring(A, xv.to(A.cols.device), "min_plus")
              for A in mats]
        _same(mp[0], mp[1], "spmv_semiring min_plus")
        check(True, f"csr_from_coo of {r.shape[0]} triplets -> "
                    f"{int(mats[1].nnz)} nonzeros at {nr} rows; spmv within "
                    f"1e-6 of sum |A||x| (max abs diff {e_y:.3g}) and "
                    f"min-plus spmv exact = the CPU port's")
        # the wide key: 70,000 x 70,000, held to numpy
        n7 = 70_000
        wr = rng.integers(0, n7, 200_000).astype(np.int32)
        wc = rng.integers(0, n7, 200_000).astype(np.int32)
        wr[:2], wc[:2] = (0, 61_356), (5, 47_301)   # keys 5, 2^32 + 5
        wv = rng.standard_normal(200_000).astype(np.float32)
        W = sp.csr_from_coo(torch.from_numpy(wr).to(dev),
                            torch.from_numpy(wc).to(dev),
                            torch.from_numpy(wv).to(dev), n7, n7)
        key = wr.astype(np.int64) * n7 + wc
        uk, inv = np.unique(key, return_inverse=True)
        nnz = int(W.nnz)
        ok = (nnz == len(uk) and np.array_equal(
            W.cols[:nnz].cpu().numpy(), uk % n7) and np.array_equal(
            W.row_ids[:nnz].cpu().numpy(), uk // n7) and np.array_equal(
            W.indptr.cpu().numpy(), np.searchsorted(uk // n7,
                                                    np.arange(n7 + 1))))
        wsum = np.bincount(inv, wv.astype(np.float64))
        wabs = np.bincount(inv, np.abs(wv).astype(np.float64))
        ok &= bool((np.abs(W.vals[:nnz].cpu().numpy() - wsum) <=
                    1e-6 * wabs).all())
        check(ok, f"csr_from_coo at {n7} x {n7} (int64 keys): {nnz} "
                  f"nonzeros, rows, columns and sums = numpy's (the "
                  f"colliding pair kept apart)")
        # graphs on the Laplacian's adjacency (its off-diagonal triplets: a
        # self-loop never wins a colouring round) and a 64-vertex network
        adj = [sp.csr_from_coo(r.to(d), c.to(d), v.to(d), nr, nr,
                               valid=(r != c).to(d)) for d in (dev, cpu)]
        labels = [gr.connected_components(A) for A in adj]
        _same(labels[0], labels[1], "connected_components")
        colors = [gr.greedy_color(A, torch.Generator().manual_seed(0))
                  for A in adj]
        _same(colors[0], colors[1], "greedy_color")
        cc = colors[0]
        rid = adj[0].row_ids
        live = adj[0].cols >= 0
        proper = bool((cc >= 0).all()) and not bool(
            (cc[rid[live].long()] == cc[adj[0].cols[live].long()]).any())
        check(proper, f"connected_components ({labels[1].unique().numel()} "
                      f"labels after its fixed rounds) and greedy_color "
                      f"({int(cc.max()) + 1} colours, proper) = the CPU "
                      f"port's")
        fr = rng.integers(0, 64, 400)
        fc = rng.integers(0, 64, 400)
        keep = fr != fc
        flow_in = [torch.from_numpy(a[keep].astype(t)) for a, t in (
            (fr, np.int32), (fc, np.int32),
            (rng.uniform(0.5, 4.0, 400), np.float32))]
        flows = [float(gr.max_flow(sp.csr_from_coo(
            *(a.to(d) for a in flow_in), 64, 64), 0, 63))
            for d in (dev, cpu)]
        check(abs(flows[0] - flows[1]) <= 1e-6 * abs(flows[1]),
              f"max_flow on 64 vertices: {flows[0]:.6f} = the CPU port's "
              f"{flows[1]:.6f} within 1e-6")
        torch.cuda.synchronize()
    launches = scan_op.LAUNCHES
    check(nse_op.LAUNCHES == 0, "phase 20 launched no NSE kernel")
    check(len(calls) == launches and launches > 0,
          f"{launches} scan launches, all recorded")
    sizes = replay_scans(calls)
    check(True, f"every phase-20 scan = plain on the same input, ints "
                f"exact; (n, op): {sizes}")
    A = mats[0]
    x = xv.to(dev)
    for label, fn in (("spmv", lambda: sp.spmv(A, x)),
                      ("spmv_semiring min_plus",
                       lambda: sp.spmv_semiring(A, x, "min_plus"))):
        ms = min(cuda_ms(fn, 50) for _ in range(3))
        nz = int(A.nnz)
        print(f"  {label} at {nr} rows, {nz} nonzeros: {ms:.6f} ms best of "
              f"3 ({nz / ms / 1e6:.3f} Gnnz/s; {card})", flush=True)
    return launches


def _flipped(sim, st):
    """The scene with its particles in reverse order (the same physics,
    another summation order): every particle channel and every
    per-particle model field (a Scene's Lame fields) flipped."""
    p = st.particles
    n, cap = p.size, p.capacity

    def flip(v):
        return torch.cat([v[:n].flip(0), v[n:]])
    model = sim.model
    per = {f.name: flip(getattr(model, f.name))
           for f in dataclasses.fields(model)
           if isinstance(getattr(model, f.name), torch.Tensor)
           and getattr(model, f.name).dim() >= 1
           and getattr(model, f.name).shape[0] == cap}
    sim = dataclasses.replace(sim, model=dataclasses.replace(model, **per))
    p = p.update(**{k: flip(v) for k, v in p.channels.items()})
    return sim, mpm_mod.MPMState(p, st.grid, st.max_vel)


def _unflip(ch, n):
    return {k: torch.cat([v[:n].flip(0), v[n:]]) for k, v in ch.items()}


def _within(g, c, other, tol, what, spread_of="the CPU's"):
    """``g`` (the card's) within ``tol`` of ``c`` (the CPU's) plus twice
    the spread over summation order between ``other`` (the same run with
    its particles reversed) and its unreversed twin, as ROADMAP §3 holds
    long runs: a contact amplifies fp32 rounding step by step."""
    base = c if spread_of == "the CPU's" else g
    for k in tol:
        spread = (other[k].cpu() - base[k].cpu()).abs().max().item()
        err = (g[k].cpu() - c[k]).abs().max().item()
        check(err <= tol[k] + 2 * spread,
              f"{what}: {k} max abs diff {err:.3g} <= {tol[k]} + twice "
              f"{spread_of} own spread over summation order {spread:.3g}")


def _state_gates(out, m0, n, y_min, what):
    """A final MPMState: finite channels, particle mass unchanged, no
    particle below ``y_min``."""
    p = out.particles
    fin = all(bool(torch.isfinite(p[k][:n]).all()) for k in ("x", "v", "F",
                                                            "C"))
    check(fin, f"{what}: x, v, F, C finite")
    m1 = p["m"][:n].double().sum().item()
    check(abs(m1 - m0) <= 1e-9 * m0, f"{what}: particle mass unchanged "
                                     f"({m1:.9g})")
    lo = p["x"][:n, 1].min().item()
    check(lo >= y_min, f"{what}: no particle below y = {y_min:.6f} (y min "
                       f"{lo:.6f})")


def _event_seconds(fn):
    """(result, seconds) of ``fn()`` between two CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1) / 1e3


def readme_path(dev, card, tmp):
    phase("21 the README's Scene -> simulate at full width")
    sim, st, dt = scenes.readme_scene(DX_README, dev)
    n = st.particles.size
    cfg = runner._binned2_config(st.particles.capacity)
    check(n == N_README, f"Scene(dx=1/128).add_cube([0.5, 0.6, 0.5], 0.25) "
                         f"on the card: {n} particles (a 64^3 lattice), dt "
                         f"{dt:.6e} from suggest_dt, the runner's "
                         f"{cfg.bins_capacity} bins")
    m0 = st.particles["m"][:n].double().sum().item()

    def readme_loop():
        s = st
        for _ in range(README_LOOP):
            s = mpm_mod.explicit_step(sim, s, dt)
        return s
    s, sec = _event_seconds(readme_loop)
    ms = sec * 1e3 / README_LOOP
    print(f"  the README's loop, {README_LOOP} unbinned explicit_steps: "
          f"{ms:.4f} ms/step = {n / ms / 1e3:.4f} M particle-steps/s "
          f"({card})", flush=True)
    check(bool(torch.isfinite(s.particles["v"]).all()),
          "the README's loop: v finite")

    frames, seg_launches = {}, []

    def on_frame(i, state):
        seg_launches.append(scan_op.LAUNCHES)
        frames[i] = tuple(state.particles[k][:n].cpu().numpy()
                          for k in ("x", "v"))
    prefix, ckpt = os.path.join(tmp, "frame"), os.path.join(tmp, "ckpt.npz")
    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    with recorded_scans() as calls:
        out, sec = _event_seconds(lambda: runner.simulate(
            sim, st, dt=dt, steps=README_STEPS, path="binned2",
            frame_every=README_FRAME, frame_prefix=prefix,
            checkpoint_every=README_CKPT, checkpoint_path=ckpt,
            on_frame=on_frame))
    launches = scan_op.LAUNCHES
    check(nse_op.LAUNCHES == 0, "the runner launched no NSE kernel")
    per_seg = np.diff([0] + seg_launches).tolist()
    segs = README_STEPS // README_FRAME
    rebins = [(k - 4) / 5 for k in per_seg]
    print(f"  simulate: {README_STEPS} steps in {segs} rollout_binned2 "
          f"segments, scan launches per segment {per_seg} (4 in each "
          f"bin_state, 5 in each rebin); {sec:.3f} s with the scans "
          f"recorded", flush=True)
    check(len(per_seg) == segs and all(r >= 0 and r == int(r)
                                       for r in rebins),
          f"every segment launched its bin_state's 4 scans and 5 per rebin "
          f"(rebins per segment {[int(r) for r in rebins]})")
    late = sum(int(r) for r, i in zip(rebins, range(
        README_FRAME, README_STEPS + 1, README_FRAME)) if i > README_LATE)
    check(late >= 1, f"{late} rebins in the segments past step "
                     f"{README_LATE} (the block reaches the ground near step "
                     f"770; free fall is translation, which recentering "
                     f"absorbs): the scan ran inside the chain")
    check(len(calls) == launches, f"{launches} scans recorded")
    sizes = replay_scans(calls)
    check(True, f"every runner scan = plain on the same input, ints exact; "
                f"(n, op): {sizes}")
    check(sorted(frames) == list(range(README_FRAME, README_STEPS + 1,
                                       README_FRAME)),
          f"{len(frames)} frames, on_frame at {sorted(frames)}")
    for i, (x, v) in frames.items():
        pos, attrs = io_mod.read_bgeo(f"{prefix}.{i:05d}.bgeo")
        if not (np.array_equal(pos, x) and np.array_equal(attrs["v"], v)):
            raise AssertionError(f"frame {i}: the bgeo file differs from "
                                 f"the state on_frame saw")
    check(True, f"each of the {len(frames)} bgeo frames read back by "
                f"read_bgeo = the x and v on_frame saw, bit for bit")
    back = io_mod.load_state(ckpt, _zeroed(out))
    _same_tree(back, out, "checkpoint")
    check(True, f"the checkpoint of step {README_STEPS} reloads bit for bit "
                f"(dtypes and devices of the state)")
    _state_gates(out, m0, n, 0.05 - DX_README, "runner")
    lo = min(float(x[:, 1].min()) for x, _ in frames.values())
    check(lo >= 0.05 - DX_README, f"no particle below y = 0.05 - dx in any "
                                  f"frame (y min {lo:.6f})")
    for io_on in (True, False):
        kw = (dict(frame_every=README_FRAME, frame_prefix=prefix,
                   checkpoint_every=README_CKPT, checkpoint_path=ckpt)
              if io_on else {})
        _, sec = _event_seconds(lambda: runner.simulate(
            sim, st, dt=dt, steps=README_STEPS, path="binned2", **kw))
        ms = sec * 1e3 / README_STEPS
        print(f"  simulate {README_STEPS} steps "
              f"{'with' if io_on else 'without'} frames and checkpoints: "
              f"{ms:.4f} ms/step = {n / ms / 1e3:.4f} M particle-steps/s "
              f"({card})", flush=True)
    # the analytic ground's final state and ms/step, for phase 36
    final = {k: out.particles[k][:n].cpu() for k in TOL}
    return sim, st, dt, launches, final, ms


def _zeroed(obj):
    if isinstance(obj, torch.Tensor):
        return torch.zeros_like(obj)
    if isinstance(obj, dict):
        return {k: _zeroed(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _zeroed(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _same_tree(got, ref, what):
    if isinstance(ref, torch.Tensor):
        if not (got.dtype == ref.dtype and got.device == ref.device and
                torch.equal(got, ref)):
            raise AssertionError(f"{what} differs")
    elif isinstance(ref, dict):
        for k in ref:
            _same_tree(got[k], ref[k], f"{what}/{k}")
    elif dataclasses.is_dataclass(ref):
        for f in dataclasses.fields(ref):
            _same_tree(getattr(got, f.name), getattr(ref, f.name),
                       f"{what}/{f.name}")
    elif got != ref:
        raise AssertionError(f"{what} differs")


def _readme_small(where, reverse):
    sim, st, dt = scenes.readme_scene(DX_SMALL_README, where, sphere=True)
    if reverse:
        sim, st = _flipped(sim, st)
    out = runner.simulate(sim, st, dt=dt, steps=SMALL_README_STEPS,
                          path="binned2")
    ch = out.particles.channels
    n = st.particles.size
    return (_unflip(ch, n) if reverse else ch), n


def readme_card_vs_cpu(dev):
    phase("22 Scene and runner, card against CPU, same port")
    g, n = _readme_small(dev, False)
    c, _ = _readme_small(torch.device("cpu"), False)
    c_rev, _ = _readme_small(torch.device("cpu"), True)
    print(f"  the README scene at dx = 1/32 with a sphere: {n} particles "
          f"(4,096 in the cube, {n - 4096} seeded in the sphere by "
          f"sample_levelset), {SMALL_README_STEPS} steps through simulate",
          flush=True)
    check(n > 4096, "add_sphere seeded particles")
    _within(g, c, c_rev, TOL, "card against CPU")


def _discs_run(where, steps, binned, reverse=False):
    """examples/mpm2d.py's discs at their defaults: ``steps`` unbinned
    explicit_steps or one rollout_binned2 (the example's bins).  Returns
    (channels in the scene's order, particle count, overflow)."""
    sim, st = scenes.discs_2d(N_DISCS, 1.0 / 128, where)
    n = st.particles.size
    if reverse:
        sim, st = _flipped(sim, st)
    overflow = False
    if binned:
        cfg = scenes.discs_2d_config(st.particles.capacity)
        out, overflow = b2.rollout_binned2(sim, st, DT_DISCS, cfg, steps)
        overflow = bool(overflow)
    else:
        out = st
        for _ in range(steps):
            out = mpm_mod.explicit_step(sim, out, DT_DISCS)
    ch = out.particles.channels
    return (_unflip(ch, n) if reverse else ch), n, overflow


def discs_cpu_reference(steps):
    """Phase 23's binned run on the CPU (~130 s of the chip machine's
    CPU), in a worker process that runs while the card works through
    phase 22 and phase 23's own card runs.  Returns (channels, seconds,
    overflow)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    t0 = time.perf_counter()
    ch, _, overflow = _discs_run(torch.device("cpu"), steps, True)
    return ch, time.perf_counter() - t0, overflow


def discs_card_vs_cpu(dev, binned_ref):
    phase("23 2-D as published: examples/mpm2d.py, card against CPU")
    cpu = torch.device("cpu")
    for binned, steps in ((False, DISCS_UNBINNED), (True, DISCS_BINNED)):
        scan_op.LAUNCHES = 0
        g, n, g_over = _discs_run(dev, steps, binned)
        launches = scan_op.LAUNCHES
        if binned:
            c, sec, c_over = binned_ref.result()
            where = "a worker process's"
        else:
            t0 = time.perf_counter()
            c, _, c_over = _discs_run(cpu, steps, binned)
            sec, where = time.perf_counter() - t0, "the CPU's"
        what = f"{n} particles, {steps} {'binned' if binned else 'unbinned'} " \
            f"steps"
        check(not (g_over or c_over), f"{what}: no overflow on the card or "
                                      f"the CPU")
        print(f"  {what}: {where} run on the CPU took {sec:.1f} s",
              flush=True)
        if binned:
            check(launches > 4, f"{what}: {launches} scan launches (4 in "
                                f"bin_state, the rest in rebins after the "
                                f"impact near step 2,860)")
            # the CPU takes ~40 ms a binned step here: the spread over
            # summation order comes from a reversed run on the card
            g_rev, _, _ = _discs_run(dev, steps, binned, True)
            _within(g, c, g_rev, TOL, what, spread_of="the card's")
        else:
            c_rev, _, _ = _discs_run(cpu, steps, binned, True)
            _within(g, c, c_rev, TOL, what)
        y = g["x"][:n, 1].min().item()
        print(f"  {what}: y min {y:.6f}", flush=True)


def discs_at_scale(dev, card):
    phase("24 2-D at a user's scale")
    sim, st = scenes.discs_2d(N_DISCS_BIG, 1.0 / 1024, dev,
                              block_capacity=8192)
    n = st.particles.size
    cfg = scenes.discs_2d_config(st.particles.capacity, 8192)
    m0 = st.particles["m"][:n].double().sum().item()
    bst = b2.bin_state(sim, st, cfg)
    blocks = int(bst.grid.table.count)
    print(f"  {N_DISCS_BIG} draws, {n} particles at dx = 1/1024, dt "
          f"{DT_DISCS_BIG} (CFL dt at cfl 0.5: "
          f"{float(0.5 / 1024 / fl_cfl.sound_speed(5e4, 0.3, 1e3)):.4e}), "
          f"{cfg.bins_capacity} bins, {blocks} active blocks of "
          f"block_capacity 8192", flush=True)
    check(not bool(bst.overflow), "bin_state: no overflow")
    rebins = [0]

    def rebin(s):
        rebins[0] += 1
        return b2.rebin_adaptive(sim, s, cfg)
    scan_op.LAUNCHES = 0
    with recorded_scans() as calls:
        bst = b2.bin_state(sim, st, cfg)
        out, sec = _event_seconds(lambda: b2.adaptive_chain(
            lambda s: b2.explicit_step_binned2(sim, s, DT_DISCS_BIG, cfg,
                                               rebin=False),
            rebin, bst, DISCS_BIG_STEPS))
    launches = scan_op.LAUNCHES
    ms = sec * 1e3 / DISCS_BIG_STEPS
    print(f"  one {DISCS_BIG_STEPS}-step chain (rollout_binned2's): "
          f"{sec:.3f} s = {ms:.4f} ms/step = {n / ms / 1e3:.4f} M "
          f"particle-steps/s, {rebins[0]} rebins, {launches} scan launches "
          f"({card})", flush=True)
    check(rebins[0] >= 1 and launches == 4 + 5 * rebins[0],
          f"{rebins[0]} rebins in the chain (impact near step 5,700), each "
          f"5 scan launches")
    check(len(calls) == launches, f"{launches} scans recorded")
    sizes = replay_scans(calls)
    check(True, f"every scan = plain on the same input, ints exact; "
                f"(n, op): {sizes}")
    check(not bool(out.overflow), "no overflow")
    check(bool(torch.isfinite(out.cols).all()), "every column finite")
    cols = _alive_cols(out)
    check(cols.shape[0] == n, "every particle alive in bin order")
    m1 = cols[:, 12].double().sum().item()
    check(abs(m1 - m0) <= 1e-9 * m0, f"particle mass unchanged ({m1:.9g})")
    lo = cols[:, 1].min().item()
    floor = 0.1 - 1.0 / 1024 - 1e-3
    check(lo >= floor, f"no particle below y = {floor:.6f} (y min "
                       f"{lo:.6f})")
    return launches, {"ms_per_step": ms, "pps": n / ms * 1e3,
                      "rebins": rebins[0]}


def _rest_runs(where):
    """Phase 25's small scenes on ``where``: the 2-D fluid unbinned (one
    step of 256) and binned (4 steps of 384), the 2-D implicit step on a
    strained F, the cubic-B-spline step, and a block falling past a
    rotating paddle (a TransformedLevelSet collider, slip) on the binned
    path."""
    f32 = dict(dtype=torch.float32, device=where)
    rng = np.random.default_rng(0)
    res = {}
    eos = constitutive.EquationOfState(torch.tensor(0.0, **f32),
                                       torch.tensor(1e4, **f32),
                                       torch.tensor(7.15, **f32))
    fsim = mpm_mod.MPMSim(eos, torch.tensor([0.0, -9.8], **f32))
    x = rng.uniform(0.3, 0.7, (256, 2)).astype(np.float32)
    res["fluid 2-D"] = fl.explicit_fluid_step(fsim, fl.make_fluid_state(
        x, dx=0.05, device=where, block_capacity=256), 1e-4)
    x = rng.uniform(0.3, 0.7, (384, 2)).astype(np.float32)
    v0 = np.broadcast_to(np.float32([0.1, -0.4]), (384, 2))
    res["fluid 2-D binned"], _ = fb.rollout_fluid_binned2(
        fsim, fl.make_fluid_state(x, dx=0.05, device=where,
                                  block_capacity=256, velocity=v0),
        1e-4, b2.BinnedConfig2(bins_capacity=64), 4)
    esim = mpm_mod.MPMSim(FixedCorotated.from_young_poisson(1e4, 0.3,
                                                            device=where),
                          torch.tensor([0.0, -9.8], **f32))
    x = rng.uniform(0.3, 0.7, (512, 2)).astype(np.float32)
    st = mpm_mod.make_mpm_state(x, dx=0.05, device=where, block_capacity=256)
    st = mpm_mod.MPMState(st.particles.update(F=torch.diag(torch.tensor(
        [1.05, 0.97], **f32)).expand(512, 2, 2).clone()), st.grid,
        st.max_vel)
    res["implicit 2-D"] = imp.implicit_step(esim, st, 1e-3, cg_iters=60)
    x = rng.uniform(0.3, 0.7, (256, 3)).astype(np.float32)
    osim = mpm_mod.MPMSim(FixedCorotated.from_young_poisson(1e4, 0.3,
                                                            device=where),
                          torch.tensor([0.0, -9.8, 0.0], **f32), order=3)
    out = mpm_mod.make_mpm_state(x, dx=0.05, device=where, block_capacity=256)
    for _ in range(5):
        out = mpm_mod.explicit_step(osim, out, 1e-3)
    res["order 3"] = out
    return res


def _paddle_run(where, reverse):
    """Phase 5's block (4,096 particles, dx = 1/32) falling for
    REST_PADDLE_STEPS binned steps onto a tilted slab that spins about y
    and rises (a TransformedLevelSet of a Cuboid, slip)."""
    f32 = dict(dtype=torch.float32, device=where)
    R = torch.tensor([[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]],
                     **f32)
    paddle = Collider(levelset.TransformedLevelSet(
        levelset.Cuboid(torch.tensor([-0.2, -0.02, -0.2], **f32),
                        torch.tensor([0.2, 0.02, 0.2], **f32)),
        R, torch.tensor([0.5, 0.35, 0.5], **f32),
        torch.tensor([0.0, 0.1, 0.0], **f32),
        torch.tensor([0.0, 2.0, 0.0], **f32)), ColliderType.slip)
    sim, st, dt = scenes.mpm_block(4096, 1.0 / 32, where, block_capacity=256)
    sim = dataclasses.replace(sim, colliders=sim.colliders + (paddle,))
    if reverse:
        sim, st = _flipped(sim, st)
    out, overflow = b2.rollout_binned2(
        sim, st, dt, b2.BinnedConfig2(bins_capacity=96, block_capacity=256),
        REST_PADDLE_STEPS)
    check(not bool(overflow), f"paddle on {where}: no overflow")
    ch = out.particles.channels
    return _unflip(ch, 4096) if reverse else ch


def rest_card_vs_cpu(dev):
    phase("25 the rest of the family, card against CPU")
    g, c = _rest_runs(dev), _rest_runs(torch.device("cpu"))
    tols = {"fluid 2-D": TOL_FLUID, "fluid 2-D binned": TOL_FLUID,
            "implicit 2-D": TOL_IMP, "order 3": TOL}
    for name, tol in tols.items():
        a, b = g[name].particles, c[name].particles
        for k, t in tol.items():
            err = (a[k].cpu() - b[k]).abs().max().item()
            check(bool(torch.isfinite(a[k]).all()) and err <= t,
                  f"{name}: {k} max abs diff {err:.3g} <= {t}")
    gp = _paddle_run(dev, False)
    cp, cp_rev = (_paddle_run(torch.device("cpu"), r) for r in (False, True))
    moved = (gp["v"][:, 0].abs().max()).item()
    check(moved > 1e-3, f"the paddle pushed the block sideways (max |v_x| "
                        f"{moved:.4f})")
    _within(gp, cp, cp_rev, TOL, f"paddle, {REST_PADDLE_STEPS} steps")


def _movers(sim, s):
    """The particles the incremental rebin's guard band would move: a
    stencil base within one cell of its bin's window edge."""
    grid, alive = s.grid, s.pid >= 0
    base = torch.floor((s.cols[:, :3] - grid.origin) / grid.dx - 0.5).to(
        torch.int32)
    slot = torch.where(s.bin_block >= 0, s.bin_block, 0).long()
    off = base - (grid.table.active_coords[slot] * 4).repeat_interleave(
        b2.K, 0)
    return int((alive & ((off < 1) | (off > b2.SIDE - 4)).any(-1)).sum())


def _migration_run(sim, st, dt, cfg, keep=0):
    """A REBIN_STEPS chain of adaptive_chain(explicit_step_binned2,
    rebin_adaptive) under ``cfg``; each rebin timed and classified (a
    migration keeps the table), with the number of particles it had to
    move; the states before the first ``keep`` migrations and their
    results kept."""
    log = {"migrations": [], "fallbacks": [], "kept": [], "movers": []}

    def rebin(s):
        if cfg.migrate_capacity:
            log["movers"].append(_movers(sim, s))
        out, sec = _event_seconds(lambda: b2.rebin_adaptive(sim, s, cfg))
        migrated = out.grid.table is s.grid.table
        log["migrations" if migrated else "fallbacks"].append(sec * 1e3)
        if migrated and len(log["kept"]) < keep:
            log["kept"].append((s, out))
        return out
    bst = b2.bin_state(sim, st, cfg)
    check(not bool(bst.overflow), f"bin_state at {cfg.bins_capacity} bins: "
                                  f"no overflow")
    out = b2.adaptive_chain(
        lambda s: b2.explicit_step_binned2(sim, s, dt, cfg, rebin=False),
        rebin, bst, REBIN_STEPS)
    check(not bool(out.overflow), f"{REBIN_STEPS} steps at "
                                  f"{cfg.bins_capacity} bins: no overflow")
    return b2.unbin_state(out, st), log


def incremental_rebin(sim, st, dt, card):
    phase("26 the incremental rebin")
    small = b2.BinnedConfig2(bins_capacity=3072, migrate_capacity=8192,
                             reserve_bins=1)
    over = bool(b2.bin_state(sim, st, small).overflow)
    p = st.particles
    n = p.size
    keys = b2._bin_keys(p["x"], p.mask, st.grid, sim.order)
    _, counts = torch.unique(keys[p.mask], return_counts=True)
    need = int(((counts + b2.K - 1) // b2.K).sum()) + counts.numel()
    print(f"  BinnedConfig2(bins_capacity=3072, migrate_capacity=8192, "
          f"reserve_bins=1) (benchmarks/probe_fluid_cost.py's): bin_state "
          f"overflow {over}; the scene's {counts.numel()} block groups need "
          f"{need} bins with one reserve bin each, so the phase runs at "
          f"{REBIN_BINS}", flush=True)
    check(need <= REBIN_BINS, f"{REBIN_BINS} bins hold the start")
    cfgs = {"as specified": dataclasses.replace(small,
                                                bins_capacity=REBIN_BINS),
            "wide": b2.BinnedConfig2(bins_capacity=REBIN_BINS,
                                     migrate_capacity=n // 2,
                                     reserve_bins=1),
            "full": b2.BinnedConfig2(bins_capacity=REBIN_BINS)}
    scan_op.LAUNCHES = 0
    runs = {}
    with recorded_scans() as calls:
        for name, cfg in cfgs.items():
            runs[name] = _migration_run(sim, st, dt, cfg,
                                        keep=2 if name == "wide" else 0)
    launches = scan_op.LAUNCHES
    sizes = replay_scans(calls)
    check(len(calls) == launches, f"{launches} scan launches, all "
                                  f"replayed = plain; (n, op): {sizes}")
    for name, (_, log) in runs.items():
        mv = log["movers"]
        print(f"  {name} (migrate_capacity "
              f"{cfgs[name].migrate_capacity}): {len(log['migrations'])} "
              f"migrations, {len(log['fallbacks'])} full rebins in "
              f"{REBIN_STEPS} steps" + (
                  f"; particles to move at each rebin: min {min(mv)}, "
                  f"median {int(np.median(mv))}, max {max(mv)}" if mv
                  else ""), flush=True)
    mig, log = runs["wide"]
    nm = len(log["migrations"])
    check(nm >= 2, f"{nm} migrations at migrate_capacity {n // 2} (at least "
                   f"two to check)")
    cfg, cpu = cfgs["wide"], torch.device("cpu")
    for k, (before, after) in enumerate(log["kept"]):
        ref, ok = b2._rebin_incremental(_to_device(sim, cpu),
                                        _to_device(before, cpu), cfg,
                                        cfg.migrate_capacity)
        check(bool(ok), f"migration {k + 1}: the CPU port migrates too")
        for name in ("pid", "bin_block", "cols"):
            if not torch.equal(getattr(after, name).cpu(),
                               getattr(ref, name)):
                raise AssertionError(f"migration {k + 1}: {name} differs "
                                     f"from the CPU port's")
        check(True, f"migration {k + 1} on the card = the CPU port's (pid, "
                    f"bin_block and columns exact)")
    ref, flog = runs["full"]
    other = runs["as specified"][0]
    for k in ("x", "v", "F"):
        spread = (other.particles[k][:n] - ref.particles[k][:n]).abs() \
            .max().item()
        err = (mig.particles[k][:n] - ref.particles[k][:n]).abs().max() \
            .item()
        check(err <= TOL[k] + 2 * spread,
              f"the chain with migrations against the chain with full "
              f"rebins: {k} max abs diff {err:.3g} <= {TOL[k]} + twice the "
              f"spread between the chain as specified and the one with "
              f"full rebins {spread:.3g}")
    mig_ms = float(np.median(log["migrations"]))
    full_ms = float(np.median(flog["fallbacks"]))
    print(f"  ms per migration (median of {nm}): {mig_ms:.4f}; ms per full "
          f"rebin at the same {REBIN_BINS} bins (median of "
          f"{len(flog['fallbacks'])}): {full_ms:.4f} ({card})", flush=True)
    return launches, {"migrations": nm, "migration_ms": mig_ms,
                      "full_rebin_ms": full_ms}


def _hinge_batch(n, seed):
    """tests/test_dihedral.py's hinges: v0 standard normal, the others v0
    plus standard normals, float32 on the CPU."""
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal((n, 3))
    v1, v2, v3 = (v0 + rng.standard_normal((n, 3)) for _ in range(3))
    return [torch.from_numpy(a.astype(np.float32)) for a in (v2, v0, v1, v3)]


def _close_rel(g, c, rel, what):
    """The card's ``g`` within ``rel`` of the CPU's largest entry."""
    err = (g.cpu() - c).abs().max().item()
    scale = c.abs().max().item()
    check(err <= rel * scale, f"{what}: max abs diff {err:.3g} <= {rel} x "
                              f"the largest entry {scale:.3g}")


def _ccd_batch():
    rng = np.random.default_rng(4)
    return [torch.from_numpy(rng.uniform(-1, 1, (N_CCD, 3)).astype(
        np.float32)) for _ in range(8)]


_CCD_FNS = ("vertex_face_ccd", "edge_edge_ccd_tight")


def geometry_cpu_reference():
    """Phase 27's CPU side on the same seeded inputs, in a worker process
    that runs beside phases 22-23 (whose own worker holds their CPU
    reference): the hinges' angle, gradient and Hessians, and both CCD
    batches as (toi, overflowed, iterations, seconds)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    h = _hinge_batch(N_HINGES, 9)
    out = {"angle": dihedral.dihedral_angle(*h),
           "gradient": dihedral.dihedral_angle_gradient(*h),
           "hessian": dihedral.dihedral_angle_hessian(
               *(a[:N_HESS] for a in h))}
    q = _ccd_batch()
    for name in _CCD_FNS:
        t0 = time.perf_counter()
        r = getattr(ccd_tight, name)(*q)
        out[name] = (r.toi, r.overflowed, r.iters, time.perf_counter() - t0)
    return out


def geometry_path(dev, card, cpu_ref):
    phase("27 dihedral and tight CCD, card against CPU, same port")
    ref = cpu_ref.result()
    hg = [a.to(dev) for a in _hinge_batch(N_HINGES, 9)]
    ms = cuda_ms(lambda: (dihedral.dihedral_angle(*hg),
                          dihedral.dihedral_angle_gradient(*hg)), 5, 1)
    ang_g = dihedral.dihedral_angle(*hg)
    grad_g = dihedral.dihedral_angle_gradient(*hg)
    print(f"  {N_HINGES} hinges: angle and gradient {ms:.3f} ms on the card "
          f"({card})", flush=True)
    err = (ang_g.cpu() - ref["angle"]).abs().max().item()
    check(err <= 2e-6, f"angle: max abs diff {err:.3g} <= 2e-6")
    _close_rel(grad_g, ref["gradient"], 1e-5, "gradient")
    sub = [a[:N_HESS] for a in hg]
    ms = cuda_ms(lambda: dihedral.dihedral_angle_hessian(*sub), 3, 1)
    hess_g = dihedral.dihedral_angle_hessian(*sub)
    print(f"  {N_HESS} hinges: 12x12 Hessians {ms:.3f} ms on the card",
          flush=True)
    _close_rel(hess_g, ref["hessian"], 1e-5, "Hessian")

    qg = [a.to(dev) for a in _ccd_batch()]
    for name in _CCD_FNS:
        r_g, sec = _event_seconds(lambda: getattr(ccd_tight, name)(*qg))
        toi_c, ovf_c, iters_c, cpu_s = ref[name]
        print(f"  {name}: {N_CCD} queries, {r_g.iters} iterations, "
              f"{sec * 1e3:.3f} ms on the card ({iters_c} iterations, "
              f"{cpu_s:.1f} s on the CPU), {int(r_g.hit.sum())} hits, "
              f"{int(r_g.overflowed.sum())} overflowed", flush=True)
        _same(r_g.toi, toi_c, f"{name} toi")
        _same(r_g.overflowed, ovf_c, f"{name} overflowed")
        check(r_g.iters == iters_c, f"{name}: toi and overflowed equal the "
                                    f"CPU port's, iterations equal")


def _drape_run(where, pin, steps):
    sim, x = scenes.cloth_drape(DRAPE_NX, DRAPE_NX, pin, where)
    x0, v = x, torch.zeros_like(x)
    xs = []
    for _ in range(steps):
        x, v = cloth.implicit_step(sim, x, v, DRAPE_DT)
        xs.append(x)
    return x0, xs, v


def drape_path(dev, card):
    phase("28 the drape (examples/cloth_drape.py), card against CPU")
    cpu = torch.device("cpu")
    steps = DRAPE_FRAMES * DRAPE_SUBSTEPS
    pins = [0, (DRAPE_NX - 1) * DRAPE_NX]
    out = {}
    for pin in (True, False):
        what = "pinned" if pin else "free"
        (x0, xs, v), sec = _event_seconds(lambda: _drape_run(dev, pin,
                                                             steps))
        x = xs[-1]
        print(f"  {what}: {DRAPE_NX}x{DRAPE_NX}, {DRAPE_FRAMES} frames x "
              f"{DRAPE_SUBSTEPS} substeps: {sec * 1e3 / DRAPE_FRAMES:.3f} "
              f"ms/frame ({card}), y min {x[:, 1].min().item():.5f}, "
              f"|v| max {v.abs().max().item():.4f}", flush=True)
        check(bool(torch.isfinite(x).all()), f"{what}: every position "
                                             f"finite")
        lo = min(xk[:, 1].min().item() for xk in xs)
        check(lo > 0.0, f"{what}: no vertex below the ground in any step "
                        f"(y min {lo:.6f})")
        if pin:
            err = (x[pins] - x0[pins]).abs().max().item()
            check(err <= 1e-6, f"pinned corners fixed ({err:.3g})")
        _, xs_c, _ = _drape_run(cpu, pin, DRAPE_CMP)
        for k in range(DRAPE_CMP):
            torch.testing.assert_close(xs[k].cpu(), xs_c[k], **TOL_CLOTH)
        check(True, f"{what}: the first {DRAPE_CMP} steps on the card = "
                    f"the CPU port's (rtol 3e-4, atol 5e-6)")
        out[what] = sec * 1e3 / DRAPE_FRAMES
    return out


def _cloth_step(sim, x, v, window):
    return cloth.implicit_step(
        sim, x, v, CLOTH_DT, newton_iters=CLOTH_NEWTON, cg_iters=CLOTH_CG,
        self_contact=True, max_cand=CLOTH_MC, contact_window=window,
        with_stats=True)


def _cloth_gates(x, nx, what):
    """Every position finite; every inner vertex of layer B (over A's
    triangles: the half-cell shift leaves B's last row and column over
    A's edge) above A's plane at 0.2 less 1e-4."""
    n = nx * nx
    check(bool(torch.isfinite(x).all()), f"{what}: every position finite")
    i = torch.arange(nx - 1, device=x.device)
    inner = (n + i[:, None] * nx + i[None, :]).reshape(-1)
    lo = x[inner, 1].min().item()
    check(lo > 0.2 - 1e-4, f"{what}: every inner vertex of layer B above "
                           f"layer A's plane less 1e-4 (y min {lo:.6f})")


def cloth_bench(dev, card, cfg, label):
    """The bench's two-layer self-contact drop at ``cfg``: settle with the
    window step, certify the candidate set, time the window row (and at
    8k the dense row) by CUDA events over chained steps, gate, and hold a
    few steps from the settled state against the CPU port."""
    nx = cfg["nx"]
    sim, x0 = scenes.cloth_two_layer(nx, dev)
    nv, nt = x0.shape[0], sim.tris.shape[0]
    cw = cloth.ContactWindow(radius=1, max_residue=cfg["residue"])
    print(f"  {nv} vertices, {nt} triangles, dt {CLOTH_DT}, Newton "
          f"{CLOTH_NEWTON} x CG {CLOTH_CG}, max_cand {CLOTH_MC}, "
          f"ContactWindow(radius=1, max_residue={cfg['residue']})",
          flush=True)
    x, v = x0, torch.zeros_like(x0)
    iters, settle_ovf = [], 0

    def settle():
        nonlocal x, v, settle_ovf
        for _ in range(cfg["settle"]):
            x, v, ovf, it = _cloth_step(sim, x, v, cw)
            settle_ovf += int(bool(ovf))
            iters.append(it)
    _, sec = _event_seconds(settle)
    print(f"  settle: {cfg['settle']} window steps in {sec:.3f} s, "
          f"{settle_ovf} flagged an overflow", flush=True)
    _, ovf = cloth.self_contact_candidates(sim, x, CLOTH_MC)
    check(not bool(ovf), f"{label}: the candidate set after settling is not "
                         f"overflowed (certified)")
    cand, _ = cloth.self_contact_candidates(sim, x, CLOTH_MC)
    _, _, valid, rovf = cloth.classify_window_residue(sim, cw, cand)
    bench = cloth.ContactWindow(radius=1, max_residue=cfg["bench_residue"])
    bench_ovf = bool(cloth.classify_window_residue(sim, bench, cand)[3])
    check(not bool(rovf), f"{label}: {int(valid.sum())} residue pairs at the "
                          f"settled state fit max_residue {cfg['residue']} "
                          f"(the bench's {cfg['bench_residue']} overflows: "
                          f"{bench_ovf})")
    _cloth_gates(x, nx, f"{label} settled")
    rows = {}
    for row, window in (("window", cw), ("dense", None)):
        if row == "dense" and cfg is CLOTH_128K:
            continue
        best, flags = None, 0
        for _ in range(cfg["reps"]):
            def chain():
                nonlocal flags
                xc, vc = x, v
                for _ in range(cfg["chain"]):
                    xc, vc, ovf, it = _cloth_step(sim, xc, vc, window)
                    flags += int(bool(ovf))
                    iters.append(it)
                return xc
            xc, sec = _event_seconds(chain)
            best = sec if best is None else min(best, sec)
            _cloth_gates(xc, nx, f"{label} {row} chain")
        ms = best * 1e3 / cfg["chain"]
        check(flags == 0, f"{label} {row}: no timed step raised the overflow "
                          f"flag")
        print(f"  {row} row: {ms:.3f} ms/step = {nv / ms / 1e3:.4f} M "
              f"vert-steps/s (best of {cfg['reps']} chains of "
              f"{cfg['chain']}, {card})", flush=True)
        rows[row] = ms
    per_round = [r for it in iters for r in it]
    print(f"  CG iterations per Newton round: mean "
          f"{np.mean(per_round):.2f}, max {max(per_round)}, the last step's "
          f"{iters[-1]}", flush=True)
    cpu = torch.device("cpu")
    sim_c, _ = scenes.cloth_two_layer(nx, cpu)
    xg, vg, xc, vc = x, v, x.cpu(), v.cpu()
    for k in range(cfg["cpu"]):
        xg, vg, og, _ = _cloth_step(sim, xg, vg, cw)
        xc, vc, oc, _ = _cloth_step(sim_c, xc, vc, cw)
        check(bool(og) == bool(oc), f"step {k}: overflow flags equal")
        torch.testing.assert_close(xg.cpu(), xc, **TOL_CLOTH)
    check(True, f"{label}: {cfg['cpu']} window steps from the settled state "
                f"on the card = the CPU port's (rtol 3e-4, atol 5e-6)")
    rows["cg_mean"] = float(np.mean(per_round))
    return rows


def cloth_8k(dev, card):
    phase("29 the bench's two-layer cloth at 8,192 vertices")
    return cloth_bench(dev, card, CLOTH_8K, "8k")


def cloth_128k(dev, card):
    phase("30 the reference-scale two-layer cloth at 131,072 vertices")
    return cloth_bench(dev, card, CLOTH_128K, "128k")


def _fem_small(where, model_cls):
    m = model_cls.from_young_poisson(5e4, 0.3, device=where)
    sim, x, _ = scenes.tet_box_hanging((3, 5, 3), where, m)
    v = torch.zeros_like(x)
    for _ in range(FEM_CMP):
        x, v = fem.implicit_step(sim, x, v, FEM_DT)
    return x


def fem_path(dev, card):
    phase("31 tet FEM")
    sim, x0, top = scenes.tet_box_hanging(N_FEM, dev)
    print(f"  hanging NeoHookean block (E 5e4, nu 0.3): {x0.shape[0]} "
          f"vertices, {sim.tets.shape[0]} tets, dt {FEM_DT}, Newton 2 x "
          f"CG 50, {FEM_STEPS} steps", flush=True)
    iters = []

    def run():
        x, v = x0, torch.zeros_like(x0)
        for _ in range(FEM_STEPS):
            x, v, it = fem.implicit_step(sim, x, v, FEM_DT, with_stats=True)
            iters.append(it)
        return x, v
    (x, v), sec = _event_seconds(run)
    ms = sec * 1e3 / FEM_STEPS
    rounds = [r for it in iters for r in it]
    print(f"  {ms:.3f} ms/step = {x0.shape[0] / ms / 1e3:.4f} M "
          f"vertex-steps/s ({card}); CG iterations per Newton round: mean "
          f"{np.mean(rounds):.2f}, max {max(rounds)}", flush=True)
    check(bool(torch.isfinite(x).all()), "every position finite")
    err = (x[top] - x0[top]).abs().max().item()
    check(err <= 1e-6, f"the pinned top row fixed ({err:.3g})")
    sag = x0[:, 1].min().item() - x[:, 1].min().item()
    check(sag > 1e-4, f"the block sags ({sag:.3g} m)")
    vmax = v.abs().max().item()
    check(vmax < 0.2, f"it settles (|v| max {vmax:.4f} < 0.2)")
    # tests/test_fem.py's drop
    sim_d, x = fem.make_tet_box(
        3, 3, 3, 0.05, device=dev, density=1e3, origin=(0.0, 0.05, 0.0),
        dhat=0.02, kappa=5.0,
        model=NeoHookean.from_young_poisson(5e4, 0.3, device=dev))
    v, lo = torch.zeros_like(x), 1.0
    for _ in range(50):
        x, v = fem.implicit_step(sim_d, x, v, 0.005)
        lo = min(lo, x[:, 1].min().item())
    check(lo > 0.0, f"the dropped block: no vertex below the ground (y min "
                    f"{lo:.5f})")
    for cls in (NeoHookean, FixedCorotated):
        torch.testing.assert_close(_fem_small(dev, cls).cpu(),
                                   _fem_small(torch.device("cpu"), cls),
                                   **TOL_CLOTH)
        check(True, f"3x5x3 {cls.__name__} box: {FEM_CMP} steps on the card "
                    f"= the CPU port's (rtol 3e-4, atol 5e-6)")
    return {"ms_per_step": ms, "cg_mean": float(np.mean(rounds))}


def cloth_and_fem(dev, card, geometry_ref):
    """Phases 27-31, with the scan and NSE launch counts over them;
    ``geometry_ref`` is the future of :func:`geometry_cpu_reference`."""
    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    geometry_path(dev, card, geometry_ref)
    drape = drape_path(dev, card)
    rows8k = cloth_8k(dev, card)
    rows128k = cloth_128k(dev, card)
    fem_row = fem_path(dev, card)
    launches = (scan_op.LAUNCHES, nse_op.LAUNCHES)
    print(f"  phases 27-31: {launches[0]} scan and {launches[1]} NSE "
          f"launches", flush=True)
    print(json.dumps({"cloth_fem": {"drape_ms_per_frame": drape,
                                    "cloth_8k": rows8k,
                                    "cloth_128k": rows128k,
                                    "fem_33": fem_row}}), flush=True)
    return launches


# -- phases 32-35: the LBVH query family, mesh queries, surfacing, robust
# geometry

def _hit_keys(qid, hits, keep):
    """Sorted (query << 32 | prim) keys of the hits of rows whose query is
    marked in ``keep`` (per query)."""
    q = qid.long()[:, None].expand_as(hits)
    live = (hits >= 0) & keep[q]
    return torch.sort(q[live] * (1 << 32) + hits[live].long()).values


def _per_query(out, nq):
    """Per query (counts, certified) of join rows: counts add over a
    query's rows; certified when it has a row and every row is in band
    (a query whose cells an overflowing ``compact`` budget cut has none)."""
    qid, _, cnt, band = out
    q = qid.long()
    cnt_q = torch.zeros(nq, dtype=torch.int64, device=q.device).index_add_(
        0, q, cnt.long())
    band_q = torch.ones(nq, dtype=torch.int32, device=q.device)
    band_q = band_q.scatter_reduce(0, q, band.to(torch.int32), "amin") > 0
    rows = torch.zeros(nq, dtype=torch.bool, device=q.device)
    rows[q] = True
    return cnt_q, band_q & rows


def _dist(p, q):
    """Euclidean distance with one fixed summation order."""
    d = p - q
    return torch.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                      + d[..., 2] * d[..., 2])


def _join_extractions(bvh, qlo, qhi, card):
    """Every extraction, plain and decomposed c8, at bench_bvh's settings;
    each equal to peel.  Only peel and none are timed: bitpeel, topk and
    scan run peel's code.  Returns the c8 peel output at 16 hits and the
    times."""
    ms, c8 = {}, None
    for mode, kw in (("plain", {}), ("c8", dict(decompose=True, cells=8))):
        for mh in (16, 8):
            ref = None
            for ex in bvh_mod.EXTRACTS:
                out = bvh_mod.query_overlaps_sorted(
                    bvh, qlo, qhi, mh, tile=256, group=32, extract=ex, **kw)
                if ref is None:
                    ref = out
                    continue
                for name, a, b in zip(("qid", "hits", "counts", "in_band"),
                                      out, ref):
                    if name == "hits" and ex == "none":
                        if not bool((a == -1).all()):
                            raise AssertionError("extract none: hits")
                    elif not torch.equal(a, b):
                        raise AssertionError(f"{mode} {ex}-{mh}: {name} "
                                             f"differs from peel's")
            if mode == "c8" and mh == 16:
                c8 = ref
            if mode == "plain" and mh == 16:
                band = ref[3].float().mean().item()
        check(True, f"{mode}: bitpeel, topk, scan and none = peel at 16 and "
                    f"8 hits (qid, hits, counts, in_band; none: counts only)")
        for ex in ("peel", "none"):
            ms[f"{mode} {ex}"] = cuda_ms(
                lambda ex=ex: bvh_mod.query_overlaps_sorted(
                    bvh, qlo, qhi, 16, tile=256, group=32, extract=ex,
                    **kw), 5, warmup=1)
    n = qlo.shape[0]
    _, cert = _per_query(c8, n)
    print(f"  in-band fraction: plain {band:.6f}, c8 per query "
          f"{cert.float().mean().item():.6f}", flush=True)
    for key, t in ms.items():
        print(f"  {key}-16: {t:.4f} ms = {n / t / 1e3:.4f} Mq/s (mean of 5; "
              f"{card})", flush=True)
    return c8, ms


def _join_vs_brute(lo, hi, qlo, qhi, out, sample, what):
    """Counts and hit sets (count <= 16) of the sampled queries that
    ``out`` (decomposed rows) certifies, against brute force."""
    n = qlo.shape[0]
    cnt, cert = _per_query(out, n)
    s = sample[cert[sample]]
    bcnt, bpairs = _sample_brute(lo, hi, qlo[s], qhi[s])
    check(torch.equal(cnt[s], bcnt), f"{what}: counts of the {s.numel()} "
                                     f"certified sampled queries = brute "
                                     f"force")
    qmap = torch.full((n,), -1, dtype=torch.int64, device=lo.device)
    qmap[s] = torch.arange(s.numel(), device=lo.device)
    got = _row_pairs(out[0], out[1], qmap)
    got = got[bcnt[got >> 32] <= 16]
    small = bcnt[bpairs[:, 0]] <= 16
    want = torch.sort(bpairs[small, 0] * (1 << 32) + bpairs[small, 1]).values
    check(torch.equal(got, want), f"{what}: their hit sets (count <= 16) = "
                                  f"brute force")


def _compact(bvh, qlo, qhi, c8, card):
    """The decomposed c8 join with a live-cell budget: bench_bvh's 0.4 x nq
    x 8, then the live count rounded up to the tile; where not flagged,
    equal to the uncompacted join."""
    n = qlo.shape[0]
    live = int(bvh_mod._decompose(bvh, qlo, qhi, 8)[2].sum())
    cnt_u, cert_u = _per_query(c8, n)
    for label, budget in (("0.4 x nq x 8", int(0.4 * n * 8) // 256 * 256),
                          ("the live cells", -(-live // 256) * 256)):
        out = bvh_mod.query_overlaps_sorted(
            bvh, qlo, qhi, 16, tile=256, group=32, decompose=True, cells=8,
            compact=budget)
        cnt, cert = _per_query(out, n)
        flagged = not bool(out[3].any())
        print(f"  compact = {label} = {budget} entries for {live} live cells "
              f"({live / n:.4f} per query): "
              f"{'every row flagged (overflow)' if flagged else 'fits'}; "
              f"{cert.float().mean().item():.6f} of the queries certified",
              flush=True)
        check(flagged == (live > budget), f"compact {budget}: flagged iff "
                                          f"the live cells exceed it")
        both = cert & cert_u
        check(torch.equal(cnt[both], cnt_u[both]) and torch.equal(
            _hit_keys(out[0], out[1], both), _hit_keys(c8[0], c8[1], both)),
            f"compact {budget}: counts and hit sets = the uncompacted join's "
            f"on the {int(both.sum())} queries both certify")
        if not flagged:
            check(cert.float().mean() >= cert_u.float().mean() - 0.005,
                  "compacted: certified fraction within 0.005 of the "
                  "uncompacted join's")
            ms = cuda_ms(lambda: bvh_mod.query_overlaps_sorted(
                bvh, qlo, qhi, 16, tile=256, group=32, decompose=True,
                cells=8, compact=budget), 5, warmup=1)
            print(f"  compacted c8 peel-16: {ms:.4f} ms = "
                  f"{n / ms / 1e3:.4f} Mq/s (mean of 5; {card})", flush=True)


def _nearest(bvh, c, sample, card):
    """query_nearest_sorted at N_BVH queries c + 0.001 against the point
    primitives c, query_nearest on the out-of-band residue; the sampled
    queries against brute force (distances equal, ties accepted)."""
    q = c + 0.001

    def banded():
        return bvh_mod.query_nearest_sorted(bvh, q, c, tile=256, group=32)

    def walk(qs):
        return bvh_mod.query_nearest(
            bvh, qs, lambda i, p: _dist(p, c[i.long()]))

    qid, prim, d2, ok = banded()
    rest = torch.nonzero(~ok).flatten()
    qs = q[qid.long()]
    (ids, _), sec = _event_seconds(lambda: walk(qs[rest]))
    steps = bvh_mod.LAST_WALK_STEPS
    prim = prim.clone()
    prim[rest] = ids
    ms_b = cuda_ms(banded, 5, warmup=1)
    n = q.shape[0]
    print(f"  banded nearest: in-band {ok.float().mean().item():.6f} "
          f"({rest.numel()} residue queries); {ms_b:.4f} ms = "
          f"{n / ms_b / 1e3:.4f} Mq/s (mean of 5); the residue walk "
          f"{sec * 1e3:.4f} ms, {steps} steps (one call: launch-bound, "
          f"~35 launches a step; {card})", flush=True)
    ms_w = sec * 1e3
    best = torch.full((sample.numel(),), float("inf"), device=c.device)
    for s in range(0, n, 131_072):
        d = c[None, s:s + 131_072] - qs[sample, None]
        best = torch.minimum(best, ((d[..., 0] * d[..., 0]
                                     + d[..., 1] * d[..., 1])
                                    + d[..., 2] * d[..., 2]).amin(1))
    e = c[prim[sample].long()] - qs[sample]
    own = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]
    check(bool((prim[sample] >= 0).all()) and torch.equal(own, best),
          f"{sample.numel()} sampled queries: the nearest primitive's "
          f"squared distance = brute force's minimum, exactly (ties "
          f"accepted; {int((~ok[sample]).sum())} of them from the walk)")
    check(torch.equal(d2[sample][ok[sample]], best[ok[sample]]),
          "the banded distances of the certified ones = brute force's")
    return {"banded_ms": ms_b, "walk_ms": ms_w,
            "in_band": ok.float().mean().item()}


def _front(bvh, lo, hi, qlo, qhi, card):
    """BvttFront.rebuild at N_FRONT queries and refresh after a move,
    against brute force on a sample."""
    q0, q1 = qlo[:N_FRONT], qhi[:N_FRONT]
    before = scan_op.LAUNCHES
    with replayed("BvttFront.rebuild"):
        f = bvh_mod.BvttFront.rebuild(bvh, q0, q1, 16, N_FRONT * 16)
        torch.cuda.synchronize()
        scans = scan_op.LAUNCHES - before
    check(scans > 0, f"BvttFront.rebuild launched the scan kernel ({scans} "
                     f"times)")
    gen = torch.Generator().manual_seed(2)
    sample = torch.randperm(N_FRONT, generator=gen)[:N_SAMPLE].to(lo.device)
    bcnt, bpairs = _sample_brute(lo, hi, q0[sample], q1[sample])
    n = int(f.count)
    per_q = torch.bincount(f.qid[:n].long(), minlength=N_FRONT)
    check(torch.equal(per_q[sample], torch.clamp(bcnt, max=16)),
          f"front: pairs per sampled query = min(brute count, 16) ({n} "
          f"pairs for {N_FRONT} queries)")
    qmap = torch.full((N_FRONT,), -1, dtype=torch.int64, device=lo.device)
    qmap[sample] = torch.arange(N_SAMPLE, device=lo.device)
    slot = qmap[f.qid[:n].long()]
    keep = slot >= 0
    fk = slot[keep] * (1 << 32) + f.pid[:n][keep].long()  # sampled pairs
    got = torch.sort(fk).values
    small = bcnt[bpairs[:, 0]] <= 16
    want = torch.sort(bpairs[small, 0] * (1 << 32) + bpairs[small, 1]).values
    got = got[bcnt[got >> 32] <= 16]
    check(torch.equal(got, want), "front: the sampled queries' pairs = "
                                  "brute force's (count <= 16)")
    move = torch.tensor([0.003, 0.0, 0.0], device=lo.device)
    live = f.refresh(lo, hi, q0 + move, q1 + move)
    _, moved = _sample_brute(lo, hi, q0[sample] + move, q1[sample] + move)
    mk = set((moved[:, 0] * (1 << 32) + moved[:, 1]).tolist())
    lk = fk[live[:n][keep]]
    check(set(lk.tolist()) == set(fk.tolist()) & mk,
          f"refresh after a move of 0.003: the sampled live pairs = the "
          f"front's pairs that still overlap by brute force "
          f"({int(live.sum())} of {n} live)")
    check(not bool(f.refresh(lo, hi, q0 + 10.0, q1 + 10.0).any()),
          "refresh after a move of 10: no pair live")
    ms_r = cuda_ms(lambda: bvh_mod.BvttFront.rebuild(
        bvh, q0, q1, 16, N_FRONT * 16), 5, warmup=1)
    ms_f = cuda_ms(lambda: f.refresh(lo, hi, q0 + move, q1 + move), 5,
                   warmup=1)
    print(f"  BvttFront: rebuild of {N_FRONT} queries {ms_r:.4f} ms "
          f"({bvh_mod.LAST_WALK_STEPS} walk steps), refresh {ms_f:.4f} ms "
          f"(mean of 5; {card})", flush=True)
    return scans, {"rebuild_ms": ms_r, "refresh_ms": ms_f}


def _bvs(dev, card):
    """build_bvs / bvs_query on N_BVS boxes of the scene with its grown
    boxes as queries, the window sized so that no query truncates; counts
    equal the exact LBVH query's, sampled hit sets brute force's."""
    lo, hi, c = scenes.lbvh_boxes(N_BVS, dev)
    qlo, qhi = lo - 0.004, hi + 0.004
    b = bvs_mod.build_bvs(lo, hi)
    span = bvs_mod.bvs_candidates(b, qlo, qhi)
    mc = int(span.max())
    ids, mask = bvs_mod.bvs_query(b, qlo, qhi, mc)
    trunc = int((span > mc).sum())
    print(f"  Bvs: {N_BVS} boxes and queries, window {mc} candidates (the "
          f"widest sweep range), {trunc} queries truncated", flush=True)
    check(trunc == 0, "Bvs: no query truncated")
    before = nse_op.LAUNCHES
    with replayed(f"the Bvs check's build_lbvh ({N_BVS} boxes)"):
        tree = bvh_mod.build_lbvh(lo, hi)
        torch.cuda.synchronize()
        nses = nse_op.LAUNCHES - before
    _, _, cnt, ovf = bvh_mod.query_overlaps_exact(
        tree, qlo, qhi, 16, cells=8, residue_budget=N_BVS)
    check(not bool(ovf) and torch.equal(mask.sum(1).to(torch.int32), cnt),
          "Bvs: every query's count = the exact LBVH query's")
    gen = torch.Generator().manual_seed(3)
    s = torch.randperm(N_BVS, generator=gen)[:N_SAMPLE].to(dev)
    _, bp = _sample_brute(lo, hi, qlo[s], qhi[s])
    i, j = torch.nonzero(mask[s], as_tuple=True)
    got = torch.sort(i * (1 << 32) + ids[s][i, j].long()).values
    check(torch.equal(got, torch.sort(bp[:, 0] * (1 << 32) + bp[:, 1])
                      .values), f"Bvs: {N_SAMPLE} sampled hit sets = brute "
                                f"force")
    ms_b = cuda_ms(lambda: bvs_mod.build_bvs(lo, hi), 5, warmup=1)
    ms_q = cuda_ms(lambda: bvs_mod.bvs_query(b, qlo, qhi, mc), 5, warmup=1)
    print(f"  Bvs: build {ms_b:.4f} ms, query {ms_q:.4f} ms = "
          f"{N_BVS / ms_q / 1e3:.4f} Mq/s (mean of 5; {card})", flush=True)
    return nses, {"window": mc, "build_ms": ms_b, "query_ms": ms_q}


def lbvh_queries(dev, card, bvh, lo, hi, c):
    phase("32 LBVH query family on config 4's tree")
    qlo, qhi = lo - 0.004, hi + 0.004            # bench_bvh's query boxes
    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    c8, ms = _join_extractions(bvh, qlo, qhi, card)
    gen = torch.Generator().manual_seed(1)
    sample = torch.randperm(N_BVH, generator=gen)[:N_SAMPLE].to(dev)
    _join_vs_brute(lo, hi, qlo, qhi, c8, sample, "c8 peel-16")
    _compact(bvh, qlo, qhi, c8, card)
    near = _nearest(bvh, c, sample, card)
    scans, front = _front(bvh, lo, hi, qlo, qhi, card)
    nses, bvs_row = _bvs(dev, card)
    launches = (scans, nses)
    print(f"  phase 32, before its timed calls: {scans} scan launches "
          f"(BvttFront.rebuild), {nses} NSE (the Bvs check's tree)",
          flush=True)
    return launches, {"join_ms": ms, "nearest": near, "front": front,
                      "bvs": bvs_row}


def mesh_queries(dev, card):
    phase("33 mesh queries on config 5's large heightfield")
    tm = scenes.terrain_trimesh(TERRAIN_RES[1], dev)
    tri = tm.vertices[tm.faces.long()]
    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    with replayed(f"build_lbvh over {tm.num_faces} triangle boxes"):
        b = bvh_mod.build_lbvh(*mesh_mod.mesh_aabbs(tm))
        torch.cuda.synchronize()
        launches = (scan_op.LAUNCHES, nse_op.LAUNCHES)
    check(launches[1] == 2, f"build_lbvh over the {tm.num_faces} triangles' "
                            f"boxes launched the NSE kernel twice")
    ms_build = cuda_ms(lambda: bvh_mod.build_lbvh(
        *mesh_mod.mesh_aabbs(tm)), 5, warmup=1)
    gen = torch.Generator(device=dev).manual_seed(33)
    o = torch.rand((N_RAYS, 3), generator=gen, device=dev)
    o[:, 1] = 1.0
    d = torch.zeros_like(o)
    d[:, 1] = -1.0
    p = torch.rand((N_RAYS, 3), generator=gen, device=dev)
    p[:, 1] = 0.5 + 0.12 * p[:, 1]

    def hit(i, oo, dd):
        t3 = tri[i.long()]
        h, t = cells_mod.ray_triangle_intersection(oo, dd, t3[:, 0],
                                                   t3[:, 1], t3[:, 2])
        return torch.where(h, t, float("inf"))

    def dist(i, q):
        t3 = tri[i.long()]
        return torch.sqrt(distance.point_triangle_dist2(
            q, t3[:, 0], t3[:, 1], t3[:, 2]))

    ids, t = bvh_mod.query_ray(b, o, d, hit)
    ray_steps = bvh_mod.LAST_WALK_STEPS
    (nid, nd), sec = _event_seconds(lambda: bvh_mod.query_nearest(
        b, p, dist))
    near_steps = bvh_mod.LAST_WALK_STEPS
    check(bool((ids >= 0).all()) and bool((nid >= 0).all()),
          f"every one of the {N_RAYS} rays hits the heightfield and every "
          f"point finds a triangle")
    s = torch.randperm(N_RAYS, generator=torch.Generator().manual_seed(4)
                       )[:N_SAMPLE].to(dev)
    bt = torch.full((N_SAMPLE,), float("inf"), device=dev)
    bd = torch.full((N_SAMPLE,), float("inf"), device=dev)
    for k in range(0, tri.shape[0], 16_384):
        t3 = tri[None, k:k + 16_384]
        h, tt = cells_mod.ray_triangle_intersection(
            o[s, None], d[s, None], t3[..., 0, :], t3[..., 1, :],
            t3[..., 2, :])
        bt = torch.minimum(bt, torch.where(h, tt, float("inf")).amin(1))
        bd = torch.minimum(bd, torch.sqrt(distance.point_triangle_dist2(
            p[s, None], t3[..., 0, :], t3[..., 1, :], t3[..., 2, :])
        ).amin(1))
    own_t = hit(ids[s], o[s], d[s])
    own_d = dist(nid[s], p[s])
    ok_t = ((t[s] - bt).abs() <= 1e-5 * bt) & ((own_t - bt).abs()
                                                <= 1e-5 * bt)
    ok_d = ((nd[s] - bd).abs() <= 1e-5 * bd + 1e-7) & (
        (own_d - bd).abs() <= 1e-5 * bd + 1e-7)
    check(bool(ok_t.all()), f"{N_SAMPLE} sampled rays: t within 1e-5 of "
                            f"brute force over every triangle (at a shared "
                            f"edge either triangle)")
    check(bool(ok_d.all()), f"{N_SAMPLE} sampled points: distance within "
                            f"1e-5 (+1e-7) of brute force (ties accepted)")
    ms_ray = cuda_ms(lambda: bvh_mod.query_ray(b, o, d, hit), 5, warmup=1)
    ms_near = sec * 1e3
    print(f"  {tm.num_faces} triangles: build_lbvh {ms_build:.4f} ms, "
          f"query_ray of {N_RAYS} {ms_ray:.4f} ms = "
          f"{N_RAYS / ms_ray / 1e3:.4f} Mq/s, {ray_steps} walk steps (mean "
          f"of 5); query_nearest {ms_near:.4f} ms = "
          f"{N_RAYS / ms_near / 1e3:.4f} Mq/s, {near_steps} walk steps (one "
          f"call: launch-bound, ~175 launches a step; {card})", flush=True)
    sim, x0, _ = scenes.tet_box_hanging(N_FEM, dev)
    tets = mesh_mod.TetMesh(x0, sim.tets)
    surf, sec = _event_seconds(lambda: mesh_mod.tet_surface(tets))
    vol = mesh_mod.tet_volumes(tets).double().sum().item()
    nf = 6 * 2 * (N_FEM - 1) ** 2
    check(surf.num_faces == nf, f"tet_surface of the {N_FEM}^3 FEM mesh: "
                                f"{surf.num_faces} faces = 6 x 2 x "
                                f"{N_FEM - 1}^2 ({sec * 1e3:.3f} ms)")
    check(abs(vol - 1e-3) <= 1e-5 * 1e-3, f"tet_volumes sum to the box's "
                                          f"0.1^3 ({vol:.9g})")
    print(f"  phase 33, before its timed calls: {launches[0]} scan and "
          f"{launches[1]} NSE launches", flush=True)
    return launches, {"build_ms": ms_build, "ray_ms": ms_ray,
                      "ray_steps": ray_steps, "nearest_ms": ms_near,
                      "nearest_steps": near_steps}


def _surface_blocks(x, dx, band=2):
    """The blocks levelset_from_points activates for ``x`` (its candidates
    and their one-block dilation), counted on the host."""
    offs = torch.as_tensor(np.unique(np.floor_divide(
        neighbor_offsets(3, -band, band), 4), axis=0),
        device=x.device)
    cells = torch.div(torch.floor(x / dx).to(torch.int32), 4,
                      rounding_mode="floor")
    blk = torch.unique((cells[:, None] + offs[None]).reshape(-1, 3), dim=0)
    dil = torch.as_tensor(neighbor_offsets(3, 0, 1),
                          device=x.device)
    return torch.unique((blk[:, None] + dil[None]).reshape(-1, 3),
                        dim=0).shape[0]


def _surface(x, dx):
    """examples/dam_break.py's surfacing with the table and the soup sized
    from the host counts: (level set, soup, seconds per stage)."""
    cap = _surface_blocks(x, dx)
    secs = {}
    t0 = time.perf_counter()
    ls = sls_mod.levelset_from_points(x, dx=dx, radius=1.5 * dx,
                                      block_capacity=cap)
    _sync(x)
    secs["levelset_from_points"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ls = sls_mod.flood_fill(ls)
    _sync(x)
    secs["flood_fill"] = time.perf_counter() - t0
    need = int(marching.surface_from_levelset(ls, iso=1.2 * dx,
                                              capacity=1).count)
    t0 = time.perf_counter()
    soup = marching.surface_from_levelset(ls, iso=1.2 * dx, capacity=need)
    _sync(x)
    secs["surface_from_levelset"] = time.perf_counter() - t0
    return ls, soup, secs, cap


def _sync(x):
    if x.is_cuda:
        torch.cuda.synchronize()


def surface_cpu_reference(x_sub):
    """Phase 34's CPU side (the 1/8 subsample), in a worker process beside
    phases 22-23: the table keys, SDF and soup."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    ls, soup, secs, _ = _surface(torch.from_numpy(x_sub), DX_MAIN)
    return (ls.grid.table.keys, ls.grid.data["sdf"], soup.verts, soup.count,
            secs)


def surface_path(dev, card, x, cpu_ref, tmp):
    phase("34 surfacing the dam break")
    dx = DX_MAIN
    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    with replayed("the surfacing"):
        ls, soup, secs, cap = _surface(x, dx)
        launches = (scan_op.LAUNCHES, nse_op.LAUNCHES)
    n = int(soup.count)
    print(f"  {x.shape[0]} particles of phase 10's final state, dx = 1/128: "
          f"{cap} blocks, {n} triangles; "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in secs.items())
          + f" ({card})", flush=True)
    check(int(ls.grid.table.count) == cap and not bool(
        block_table.build_overflowed(ls.grid.table)),
        f"levelset_from_points: {cap} blocks in a table of {cap} (sized "
        f"from the host count), no overflow")
    check(not bool(soup.overflow) and n == soup.verts.shape[0],
          f"surface_from_levelset: {n} triangles in a soup of {n}, no "
          f"overflow")
    check(launches[0] > 0, f"the block activation launched the scan kernel "
                           f"({launches[0]} times)")
    tris = soup.verts[:n]
    t0 = time.perf_counter()
    v, f = marching.weld(tris, 1e-4 * dx)
    e = torch.cat([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    cnt = torch.unique(torch.sort(e, 1).values, dim=0, return_counts=True)[1]
    weld_s = time.perf_counter() - t0
    check(bool((cnt == 2).all()), f"watertight: after welding corners "
                                  f"within 1e-4 dx ({v.shape[0]} vertices, "
                                  f"{n - f.shape[0]} collapsed slivers "
                                  f"dropped, {weld_s:.3f} s) every one of "
                                  f"{cnt.numel()} edges is shared by exactly "
                                  f"two triangles")
    nrm = torch.linalg.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0],
                             dim=-1)
    length = torch.linalg.vector_norm(nrm, dim=-1)
    keep = length > 1e-12
    u = nrm[keep] / length[keep, None]
    cen = tris[keep].mean(1)
    out = ls.sdf(cen + dx * u) > ls.sdf(cen - dx * u)
    check(bool(out.all()), f"normals point out of the fluid: sdf(c + dx n) "
                           f"> sdf(c - dx n) at all {int(keep.sum())} "
                           f"triangles of nonzero area")
    path = os.path.join(tmp, "dam_break_surface.obj")
    verts = tris.reshape(-1, 3).cpu().numpy()
    faces = np.arange(verts.shape[0]).reshape(-1, 3)
    t0 = time.perf_counter()
    io_mod.write_obj(path, verts, faces)
    v2, f2 = io_mod.read_obj(path)
    obj_s = time.perf_counter() - t0
    check(np.array_equal(v2, verts) and np.array_equal(f2, faces),
          f"write_obj then read_obj: {verts.shape[0]} vertices and "
          f"{faces.shape[0]} faces back exactly ({obj_s:.3f} s)")
    keys, sdf, sv, sc, cpu_secs = cpu_ref.result()
    lsg, soupg, _, _ = _surface(x[::8].contiguous(), dx)
    _same(lsg.grid.table.keys, keys, "1/8 subsample: table keys")
    _same(lsg.grid.data["sdf"], sdf, "1/8 subsample: SDF")
    _same(soupg.count, sc, "1/8 subsample: triangle count")
    _same(soupg.verts, sv, "1/8 subsample: soup")
    check(True, f"1/8 subsample ({x[::8].shape[0]} particles, "
                f"{int(sc)} triangles): table, SDF and soup on the card = "
                f"the CPU port's bit for bit (the CPU took "
                + ", ".join(f"{k} {v:.2f} s" for k, v in cpu_secs.items())
                + ")")
    print(f"  phase 34, before its card-against-CPU run: {launches[0]} scan "
          f"and {launches[1]} NSE launches", flush=True)
    return launches, {"blocks": cap, "triangles": n,
                      **{f"{k}_ms": v * 1e3 for k, v in secs.items()}}


def _fr(a):
    from fractions import Fraction
    return Fraction(float(a))


def _exact_det(rows):
    """The exact 3x3 determinant of fraction rows, and its permanent."""
    m = rows
    det = (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
           - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
           + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))
    a = [[abs(float(v)) for v in r] for r in m]
    perm = (a[0][0] * (a[1][1] * a[2][2] + a[1][2] * a[2][1])
            + a[0][1] * (a[1][0] * a[2][2] + a[1][2] * a[2][0])
            + a[0][2] * (a[1][0] * a[2][1] + a[1][1] * a[2][0]))
    return det, perm


def _exact_pred(name, pts):
    """Exact value and permanent of a predicate at float32 points."""
    *ps, q = pts
    if name == "orient2d":
        a, b, c = pts
        x0, y0 = _fr(a[0]) - _fr(c[0]), _fr(a[1]) - _fr(c[1])
        x1, y1 = _fr(b[0]) - _fr(c[0]), _fr(b[1]) - _fr(c[1])
        return x0 * y1 - y0 * x1, abs(float(x0 * y1)) + abs(float(y0 * x1))
    rows = [[_fr(p[j]) - _fr(q[j]) for j in range(len(q))] for p in ps]
    if name == "orient3d":
        return _exact_det(rows)
    for r in rows:
        r.append(sum(v * v for v in r))
    if name == "incircle":
        return _exact_det(rows)
    det, perm = 0, 0.0
    for i in range(4):
        d, pm = _exact_det([rows[k][:3] for k in range(4) if k != i])
        det += (1 if (i + 3) % 2 == 0 else -1) * rows[i][3] * d
        perm += abs(float(rows[i][3])) * pm
    return det, perm


_PREDS = {"orient2d": (3, 2), "orient3d": (4, 3), "incircle": (4, 2),
          "insphere": (5, 3)}


def _near_degenerate(name, n, rng):
    """Degenerate configurations on a lattice away from 0 (colinear,
    coplanar, cocircular, cospherical: integer points at distance 5 from
    8), one coordinate of one point moved by one ulp in half of them."""
    k, dim = _PREDS[name]
    if name in ("orient2d", "orient3d"):
        base = rng.integers(8, 24, (n, k - 1, dim)).astype(np.float32) / 8
        w = rng.integers(1, 4, (n, k - 1, 1)).astype(np.float32) / 4
        last = base[:, 0] + ((base[:, 1:] - base[:, :1]) * w[:, 1:]).sum(1)
        pts = np.concatenate([base, last[:, None]], 1)
    else:
        on = (np.asarray([[3, 4, 0], [4, 3, 0], [0, 3, 4], [5, 0, 0],
                          [0, 0, 5], [0, 5, 0], [4, 0, 3]], np.float32)
              if dim == 3 else
              np.asarray([[3, 4], [4, 3], [5, 0], [0, 5]], np.float32))
        sgn = rng.choice([-1.0, 1.0], (n, k, dim)).astype(np.float32)
        pts = on[rng.integers(0, len(on), (n, k))] * sgn + 8.0
    i = np.arange(n)
    p, d = rng.integers(0, k, n), rng.integers(0, dim, n)
    up = rng.uniform(size=n) < 0.5
    v = pts[i, p, d]
    pts[i, p, d] = np.where(rng.uniform(size=n) < 0.5, np.nextafter(
        v, np.where(up, np.float32(np.inf), np.float32(-np.inf))), v)
    return pts.astype(np.float32)


def robust_geometry(dev, card):
    phase("35 robust geometry, card against CPU")
    cpu = torch.device("cpu")
    rng = np.random.default_rng(35)
    for name, (k, _) in _PREDS.items():
        pts = _near_degenerate(name, N_PRED, rng)
        args = [torch.from_numpy(pts[:, i]) for i in range(k)]
        ref = getattr(predicates, name)(*args)
        got, sec = _event_seconds(lambda: getattr(predicates, name)(
            *[a.to(dev) for a in args]))
        _same(got.view(torch.int32), ref.view(torch.int32),
              f"{name} values")
        ex = [_exact_pred(name, pts[r]) for r in range(N_EXACT)]
        exact = np.asarray([float(e) for e, _ in ex])
        perm = np.asarray([pm for _, pm in ex])
        val = got[:N_EXACT].cpu().numpy().astype(np.float64)
        sure = np.abs(exact) > 2.0 ** -40 * perm
        within = np.abs(val - exact) <= (2.0 ** -40 * perm
                                         + 2.0 ** -24 * np.abs(exact))
        check(np.array_equal(np.sign(val[sure]), np.sign(exact[sure]))
              and bool(within.all()),
              f"{name}: {N_PRED} near-degenerate cases (lattice, 1-ulp "
              f"moves) on the card = the CPU's bit for bit ({sec * 1e3:.3f} "
              f"ms); of the first {N_EXACT}, every value within 2^-40 of "
              f"its permanent (plus the float32 result's rounding) of the "
              f"exact one, and the sign exact at all {int(sure.sum())} "
              f"past that bound "
              f"({int((exact == 0).sum())} exactly degenerate; below the "
              f"bound {int((val[~sure] == 0).sum())} read 0 and "
              f"{int((val * exact < 0).sum())} the opposite sign)")
    vals = [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, (2, N_BIG),
                                         dtype=np.int64).reshape(-1)]
    a, b = vals[:N_BIG], vals[N_BIG:]
    outs = []
    for where in (cpu, dev):
        x, y = (bigint_mod.bigint(v, device=where) for v in (a, b))
        g = bigint_mod.bigint_gcd(x, y)
        r = bigint_mod.rational_w(x, bigint_mod.bigint(
            [abs(v) + 1 for v in b], device=where))
        s = r + r * r
        outs.append([x + y, x - y, x * y, g,
                     bigint_mod._bigint_div_exact(x * y, y), s.num, s.den,
                     r.normalized().den])
    for i, (c_, g_) in enumerate(zip(*outs)):
        _same(g_.sign, c_.sign, f"BigInt op {i} sign")
        _same(g_.mag, c_.mag, f"BigInt op {i} limbs")
    check(outs[0][2].to_pyints() == [p * q for p, q in zip(a, b)],
          "BigInt products = Python's")
    check(outs[1][4].to_pyints() == a, "exact division recovers x")
    check(True, f"BigInt add, sub, mul, gcd, exact division and RationalW "
                f"add, mul, normalize on {N_BIG} 62-bit values: the card's "
                f"limbs = the CPU's")
    rc = np.random.default_rng(5)
    lat = (rc.integers(-2, 3, (N_PRED, 5, 3)) / 2.0).astype(np.float32)
    lat[:, :, 2] = 0.0
    rnd = rc.uniform(-1, 1, (N_PRED, 5, 3)).astype(np.float32)
    for what, pts in (("lattice", lat), ("random", rnd)):
        res = []
        for where in (cpu, dev):
            p = [torch.from_numpy(pts[:, i]).to(where) for i in range(5)]
            h, t = cells_mod.ray_triangle_intersection(
                p[0], p[4] - p[0], p[1], p[2], p[3])
            res.append([cells_mod.segment_segment_intersection(*p[:4]),
                        cells_mod.ray_segment_intersection(
                            p[0], p[1], p[1] - p[0], p[2], p[3]),
                        cells_mod.point_on_segment(*p[:3]),
                        cells_mod.is_triangle_degenerated(*p[:3]),
                        cells_mod.make_bilinear(*p[:4]).facets, h,
                        t.view(torch.int32)])
        for i, (c_, g_) in enumerate(zip(*res)):
            _same(g_, c_, f"cells {what} output {i}")
        check(True, f"cells on {N_PRED} {what} configurations: segment and "
                    f"ray tests, point on segment, degeneracy, bilinear "
                    f"facets, ray-triangle hit and t on the card = the "
                    f"CPU's bit for bit")


# -- phases 36-38: the adaptive grid, I/O and tooling, the multi-device
# steps at world size 1

def _adaptive_queries(g, x):
    """probe, sample, sample_gradient and sample_staggered of ``g`` at
    ``x``, with their seconds (between CUDA events on the card)."""
    out, secs = {}, {}
    for name in ("probe", "sample", "sample_gradient", "sample_staggered"):
        fn = getattr(g, name)
        out[name], secs[name] = _event_seconds(lambda: fn(x))
    return out, secs


def _same_adaptive(got, ref, what):
    """Two AdaptiveGrids with the same levels, bit for bit."""
    for l, (a, b) in enumerate(zip(got.levels, ref.levels, strict=True)):
        for name, u, v in (("keys", a.table.keys, b.table.keys),
                           ("count", a.table.count, b.table.count),
                           ("value", a.value, b.value),
                           ("child", a.child, b.child)):
            _same(u, v.cpu(), f"{what}: level {l} {name}")


def _close_abs(g, c, tol, what):
    err = (g.cpu() - c).abs().max().item()
    check(err <= tol, f"{what}: max abs diff {err:.3g} <= {tol:.3g}")


def adaptive_card_vs_cpu(dev, card):
    """Phase 36a: the adaptive grid's build, queries, writes and
    activation on the card against the CPU port."""
    rng = np.random.default_rng(36)
    cells = np.unique(rng.integers(-AG_HALF, AG_HALF, (AG_CELLS * 9 // 8, 3)
                                   ).astype(np.int32), axis=0)
    cells = cells[rng.permutation(len(cells))[:AG_CELLS]]
    vals = rng.standard_normal(AG_CELLS).astype(np.float32)
    x = np.concatenate([
        (cells[rng.integers(0, AG_CELLS, AG_QUERIES // 2)] + 0.5) * AG_DX,
        rng.uniform(-AG_HALF * AG_DX, AG_HALF * AG_DX,
                    (AG_QUERIES // 2, 3))]).astype(np.float32)
    far = rng.integers(AG_HALF + 64, AG_HALF + 160, (4_096, 3)).astype(
        np.int32)
    crowd = rng.integers(-4 * AG_HALF, 4 * AG_HALF, (16_384, 3)).astype(
        np.int32)
    kw = dict(dx=AG_DX, capacities=AG_CAPS, background=-1.0)
    res = []
    for where in (torch.device("cpu"), dev):
        t = {k: torch.from_numpy(v).to(where) for k, v in
             (("cells", cells), ("vals", vals), ("x", x), ("far", far),
              ("crowd", crowd))}
        g, sec = _event_seconds(lambda: ag_mod.adaptive_grid_from_leaves(
            t["cells"], t["vals"], **kw))
        q, qsec = _adaptive_queries(g, t["x"])
        upd, ovf = g.update_leaf_values(t["cells"], 2.0 * t["vals"] + 1.0)
        _, miss = g.update_leaf_values(t["far"][:1], t["vals"][:1])
        act, aovf = g.activate_leaves(t["far"])
        _, cap_ovf = g.activate_leaves(t["crowd"])
        res.append(dict(g=g, q=q, upd=upd, act=act, sec=sec, qsec=qsec,
                        flags=[bool(ovf), bool(miss), bool(aovf),
                               bool(cap_ovf)]))
    c, d = res
    counts = [int(lev.table.count) for lev in d["g"].levels]
    print(f"  {AG_CELLS} unique leaf cells in [-{AG_HALF}, {AG_HALF})^3 "
          f"(dx {AG_DX}): blocks per level {counts} of {AG_CAPS}; build "
          f"{d['sec'] * 1e3:.4f} ms, at {AG_QUERIES} points probe "
          f"{d['qsec']['probe'] * 1e3:.4f} ms, sample "
          f"{d['qsec']['sample'] * 1e3:.4f} ms, sample_gradient "
          f"{d['qsec']['sample_gradient'] * 1e3:.4f} ms, sample_staggered "
          f"{d['qsec']['sample_staggered'] * 1e3:.4f} ms ({card})",
          flush=True)
    _same_adaptive(d["g"], c["g"], "build")
    check(True, "the three levels' keys, counts, payloads and child masks "
                "on the card = the CPU's (negative cells: floor division)")
    _same(d["q"]["probe"], c["q"]["probe"], "probe")
    check(True, f"probe at {AG_QUERIES} points on the card = the CPU's bit "
                f"for bit")
    scale = float(np.abs(vals).max())
    _close_abs(d["q"]["sample"], c["q"]["sample"], AG_TOL * scale,
               f"sample (tolerance {AG_TOL} of max |value| {scale:.4f})")
    _close_abs(d["q"]["sample_staggered"], c["q"]["sample_staggered"],
               AG_TOL * scale, "sample_staggered")
    gscale = c["q"]["sample_gradient"].abs().max().item()
    _close_abs(d["q"]["sample_gradient"], c["q"]["sample_gradient"],
               AG_TOL * gscale, f"sample_gradient (tolerance {AG_TOL} of "
                                f"max |gradient| {gscale:.4f})")
    check(d["flags"] == c["flags"] == [False, True, False, True],
          f"flags (update, write to an inactive cell, activation of 4,096 "
          f"far cells, of 16,384 beyond the capacity) {d['flags']} = the "
          f"CPU's")
    _same_adaptive(d["upd"], c["upd"], "update_leaf_values")
    _same_adaptive(d["act"], c["act"], "activate_leaves")
    check(True, "update_leaf_values and activate_leaves on the card = the "
                "CPU's, level for level")


def adaptive_grid_path(dev, card):
    """Phase 36a; returns its scan launches on the card."""
    phase("36a the adaptive grid, card against CPU")
    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    with recorded_scans() as calls:
        adaptive_card_vs_cpu(dev, card)
    check(len(calls) == scan_op.LAUNCHES == 9,
          f"36a: {scan_op.LAUNCHES} scans recorded on the card (3 levels "
          f"each of the build and the two activations)")
    replay_scans(calls)
    check(True, "36a: every scan = plain on the same input")
    return len(calls)


def adaptive_ground_path(dev, card, rsim, rst, rdt, analytic, analytic_ms):
    """Phase 36b, run beside phase 23's CPU worker (the card would wait on
    it otherwise): the adaptive ground and the reversed analytic run are
    timed in the same window.  Returns the scan launches of the path and
    the adaptive ground (for phase 37's round trip)."""
    phase("36b the README scene on an adaptive ground (beside phase 23's "
          "CPU worker)")
    n = rst.particles.size
    ground = rsim.colliders[0]
    check(len(rsim.colliders) == 1 and
          isinstance(ground.levelset, levelset.HalfSpace),
          "the README scene's one collider is the analytic ground")
    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    with recorded_scans() as calls:
        ag, sec = _event_seconds(lambda: ag_mod.adaptive_from_sdf(
            ground.levelset, dx=DX_README, lo=(0, 0, 0), hi=(1, 1, 1),
            band=AG_BAND, device=dev))
        asim = dataclasses.replace(rsim, colliders=(dataclasses.replace(
            ground, levelset=ag_mod.AdaptiveGridLevelSet(ag)),))
        out, a_sec = _event_seconds(lambda: runner.simulate(
            asim, rst, dt=rdt, steps=README_STEPS, path="binned2"))
    launches = scan_op.LAUNCHES
    check(nse_op.LAUNCHES == 0, "the adaptive path launched no NSE kernel")
    lev0 = ag.levels[0]
    print(f"  adaptive_from_sdf(ground, dx=1/128, [0, 1]^3, band {AG_BAND}) "
          f"on the card: {int(lev0.table.count)} leaf blocks of "
          f"{lev0.capacity}, blocks per level "
          f"{[int(lv.table.count) for lv in ag.levels]}; "
          f"{sec * 1e3:.4f} ms ({card})", flush=True)
    check(len(calls) == launches, f"36b: {launches} scans recorded")
    replay_scans(calls)
    check(True, "36b: every scan of the adaptive build and the runner = "
                "plain on the same input")
    a_ms = a_sec * 1e3 / README_STEPS
    print(f"  simulate {README_STEPS} steps over the adaptive ground (its "
          f"{launches} scans recorded): {a_ms:.4f} ms/step = "
          f"{n / a_ms / 1e3:.4f} M particle-steps/s, beside the analytic "
          f"ground's {analytic_ms:.4f} ms/step (phase 21, without the CPU "
          f"worker; {card})", flush=True)
    m0 = rst.particles["m"][:n].double().sum().item()
    _state_gates(out, m0, n, 0.05 - DX_README, "adaptive ground")
    fsim, fst = _flipped(rsim, rst)
    rev, r_sec = _event_seconds(lambda: runner.simulate(
        fsim, fst, dt=rdt, steps=README_STEPS, path="binned2"))
    print(f"  the analytic ground again, particles reversed, in the same "
          f"window: {r_sec * 1e3 / README_STEPS:.4f} ms/step ({card})",
          flush=True)
    rev = {k: v.cpu() for k, v in _unflip(rev.particles.channels, n).items()}
    got = {k: out.particles[k][:n].cpu() for k in TOL}
    _within(analytic, got, {k: rev[k][:n] for k in TOL}, TOL,
            f"adaptive ground against phase 21's analytic ground, "
            f"{README_STEPS} steps through the impact",
            spread_of="the card's")
    return launches, ag


def io_path(dev, card, ag, tmp):
    """Phase 37: examples/mpm_block.py's path timed with the port's
    profile, traced, exported to .vdb and read back; the adaptive ground's
    .vdb round trip; the host ops; a log file."""
    phase("37 I/O and tooling on examples/mpm_block.py's path")
    sim, st, dt = scenes.mpm_block(N_MAIN, DX_MAIN, dev)
    n = st.particles.size

    def step(s):
        return mpm_mod.explicit_step(sim, s, dt)

    def steps(s, k):
        for _ in range(k):
            s = step(s)
        return s
    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
    with recorded_scans() as calls:
        first = prof_mod.Timer("first step").tick()
        first_ms = first.tock(step(st), echo=False)
        s = steps(st, IO_STEPS)
        with prof_mod.trace(os.path.join(tmp, "trace")):
            steps(s, 3)
    launches = scan_op.LAUNCHES
    check(nse_op.LAUNCHES == 0, "explicit_step launched no NSE kernel")
    check(len(calls) == launches, f"{launches} scans recorded")
    replay_scans(calls)
    check(True, "every scan of the path = plain on the same input")
    # timed apart from the recorded run (its clones hold device memory)
    ms = prof_mod.bench(step, st, warmup=2, iters=10)
    timer = prof_mod.Timer(f"{IO_STEPS} steps").tick()
    total = timer.tock(steps(st, IO_STEPS), echo=False)
    print(f"  explicit_step at {n} particles: first step {first_ms:.4f} ms, "
          f"bench median {ms:.4f} ms/step (a sync after each step), "
          f"{IO_STEPS} steps queued {total:.4f} ms = "
          f"{total / IO_STEPS:.4f} ms/step, "
          f"{n * IO_STEPS / total / 1e3:.4f} M particle-steps/s (Timer; "
          f"{card})", flush=True)
    with open(os.path.join(tmp, "trace", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    check(len(kern) > 0, f"the trace of 3 steps holds {len(kern)} CUDA "
                         f"kernel events")
    mem = prof_mod.memory_stats()
    check(mem["bytes_in_use"] > 0 and mem["peak_bytes_in_use"] >=
          mem["bytes_in_use"] and mem["bytes_limit"] ==
          torch.cuda.get_device_properties(dev).total_memory,
          f"memory_stats: {mem['bytes_in_use']} bytes in use, peak "
          f"{mem['peak_bytes_in_use']}, limit {mem['bytes_limit']}")
    # the grid to .vdb as the example does, read back on the card
    path = os.path.join(tmp, "grid.vdb")
    vdb_bridge.save_vdb(path, s.grid, ["m", "v"], grid_class="fog volume")
    back = vdb_bridge.load_vdb_grids(path, device=dev)
    check(sorted(back) == ["m", "v.0", "v.1", "v.2"],
          f"{os.path.getsize(path)} bytes, grids {sorted(back)}")
    count = int(s.grid.table.count)
    cells = (s.grid.table.active_coords[:count, None, :] * 4 +
             torch.as_tensor(neighbor_offsets(3, 0, 3), device=dev)[None])
    for name, prop_name, ref in (
            ("m", "m", s.grid.data["m"][:count]),
            *[(f"v.{c}", "v", s.grid.data["v"][:count, :, c])
              for c in range(3)]):
        got = back[name].value_or(prop_name, cells)
        _same(got, ref.cpu(), f"{name} read back")
    check(True, f"m and v of the {count} active blocks read back from the "
                f".vdb = the grid on the card, bit for bit")
    # the adaptive ground through .vdb
    apath = os.path.join(tmp, "ground.vdb")
    vdb_mod.write_vdb(apath, [vdb_bridge.adaptive_to_vdb_grid(
        ag, name="sdf", grid_class="level set")])
    ag2 = vdb_bridge.vdb_grid_to_adaptive(vdb_mod.read_vdb(apath)[0],
                                          device=dev)
    g = torch.Generator(device=dev).manual_seed(37)
    q = torch.rand((AG_QUERIES, 3), generator=g, device=dev)
    q[:, 1] *= 0.25
    _same(ag2.probe(q), ag.probe(q).cpu(), "adaptive ground probes")
    check(True, f"the adaptive ground -> .vdb ({os.path.getsize(apath)} "
                f"bytes) -> AdaptiveGrid: {AG_QUERIES} probes equal")
    # the host ops
    check(native.available(), "the host ops built with g++ into "
                              "zpc_tpu_torch/_build/")
    pc = torch.floor(s.particles["x"][:n] / DX_MAIN).to(torch.int32)
    host = native.morton3d_host(pc.cpu().numpy())
    _same(bits.morton3d(pc), torch.from_numpy(host), "morton3d")
    check(True, f"morton3d_host of {n} particle cells = math.bits.morton3d "
                f"on the card")
    logp = os.path.join(tmp, "phase37.log")
    h = log_mod.enable_file_logging(logp)
    try:
        log_mod.log("phase 37: %d particles, %.4f ms/step", n, ms)
    finally:
        log_mod.get_logger().removeHandler(h)
        h.close()
    with open(logp) as f:
        check(f"phase 37: {n} particles" in f.read(),
              "the logger wrote its file")
    return launches, sim, st, dt, s


def multi_device_path(dev, card, sim, st, dt, ref, tmp):
    """Phase 38: the sharded and domain-decomposed steps at world size 1
    (NCCL) over phase 37's scene, against its explicit_step run; then the
    three steps timed in turns, 50 steps queued each."""
    phase("38 the multi-device steps at world size 1 (NCCL)")
    n = st.particles.size
    pmesh.initialize_distributed(
        f"file://{os.path.join(tmp, 'rendezvous')}", 1, 0, device=dev,
        timeout=datetime.timedelta(seconds=120))
    try:
        mesh = pmesh.make_mesh(1)
        check(dist.get_backend() == "nccl" and mesh.size() == 1,
              "one NCCL rank on the card")
        fsim, fst = _flipped(sim, st)
        rev = fst
        for _ in range(IO_STEPS):
            rev = mpm_mod.explicit_step(fsim, rev, dt)
        rev = {k: v.cpu() for k, v in _unflip(rev.particles.channels,
                                                n).items()}
        ref = {k: ref.particles[k][:n].cpu() for k in TOL}
        def sharded():
            s = dist_mod.shard_state(st, mesh)
            for _ in range(IO_STEPS):
                s = dist_mod.explicit_step_sharded(sim, s, dt, mesh)
            return s.particles, torch.zeros((), dtype=torch.bool)

        def decomposed():
            d = dd_mod.make_dd_state(st, mesh)
            ovf = torch.zeros((), dtype=torch.bool, device=dev)
            for _ in range(IO_STEPS):
                d, o = dd_mod.explicit_step_dd(
                    sim, d, dt, mesh, grid_template=st.grid,
                    nb_local=st.grid.block_capacity)
                ovf = ovf | o
            return d, ovf

        def explicit():
            s = st
            for _ in range(IO_STEPS):
                s = mpm_mod.explicit_step(sim, s, dt)
            return s.particles, torch.zeros((), dtype=torch.bool)
        runs = {"sharded": sharded, "domain-decomposed": decomposed}
        launches = {}
        for label, run in runs.items():
            scan_op.LAUNCHES = nse_op.LAUNCHES = 0
            with recorded_scans() as calls:
                out, ovf = run()
                if label == "sharded":
                    got = {k: out[k][:n].cpu() for k in TOL}
                else:
                    got = {k: torch.from_numpy(v) for k, v in
                           dd_mod.gather_dd_particles(out, n, mesh).items()
                           if k in TOL}
            launches[label] = scan_op.LAUNCHES
            check(nse_op.LAUNCHES == 0 and not bool(ovf),
                  f"{label}: no NSE launch, no overflow")
            check(len(calls) == launches[label],
                  f"{label}: {launches[label]} scans recorded")
            replay_scans(calls)
            _within(ref, got, {k: rev[k][:n] for k in TOL}, TOL,
                    f"{label} against explicit_step, {IO_STEPS} steps",
                    spread_of="the card's")
        runs["explicit"] = explicit
        ms = {k: [] for k in runs}
        for label in ("explicit", "sharded", "domain-decomposed",
                      "domain-decomposed", "sharded", "explicit"):
            _, sec = _event_seconds(runs[label])
            ms[label].append(sec * 1e3 / IO_STEPS)
        print(f"  ms/step at world size 1, {IO_STEPS} steps queued, timed "
              f"in turns (explicit, sharded, DD, DD, sharded, explicit): "
              f"{ {k: [round(t, 4) for t in v] for k, v in ms.items()} } "
              f"({card})", flush=True)
    finally:
        dist.destroy_process_group()
    return launches


def main():
    card = environment()
    dev = zpc_tpu_torch.cuda_device(0)
    build()
    max_err, times = kernel_vs_plain(dev, card)
    nse_err, nse_t = nse_vs_plain(dev, card)
    sim, st, bst, dt, launches = main_path(dev)
    card_vs_cpu(dev)
    throughput(sim, st, bst, dt, card)
    bvh, lo, hi, c, nse_launches = lbvh_path(dev, card)
    lbvh_card_vs_cpu(dev)
    lbvh_numbers(bvh, lo, hi, c, card)
    fluid_launches, fluid = dam_break_path(dev, card)
    fluid_card_vs_cpu(dev)
    mat_launches = materials_path(dev, card)
    imp_launches, apply_13, imp_ms = implicit_path(dev, card)
    apply_14 = implicit_card_vs_cpu(dev)
    poisson(dev, card)
    _barrier_launches(0, "phases 3-15 (no mesh contact)")
    contact_launches, barrier_16, apply_16 = contact_path(dev, card, imp_ms)
    barrier_17, apply_17, barrier_t = config5_rows(dev, card)
    apply_17b, apply_t = implicit_apply_path(dev, card)
    barrier_18, apply_18 = contact_card_vs_cpu(dev)
    config1_launches, _ = config1(dev, card)
    container_launches = containers_path(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        rsim, rst, rdt, readme_launches, readme_out, readme_ms = \
            readme_path(dev, card, tmp)
    # the CPU references of phases 23, 27 and 34 run in worker processes
    # beside the untimed phases 22, 25, 35 and 23 and phase 36b (after
    # every timed phase before them): phase 23's, the longest, would leave
    # the card idle
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        discs_ref = pool.submit(discs_cpu_reference, DISCS_BINNED)
        geometry_ref = pool.submit(geometry_cpu_reference)
        surface_ref = pool.submit(surface_cpu_reference,
                                  fluid["x"][::8].cpu().numpy())
        readme_card_vs_cpu(dev)
        rest_card_vs_cpu(dev)
        robust_geometry(dev, card)
        ag_launches, ag = adaptive_ground_path(dev, card, rsim, rst, rdt,
                                               readme_out, readme_ms)
        discs_card_vs_cpu(dev, discs_ref)
    discs_launches, _ = discs_at_scale(dev, card)
    migrate_launches, _ = incremental_rebin(rsim, rst, rdt, card)
    cloth_launches, cloth_nse = cloth_and_fem(dev, card, geometry_ref)
    query_launches, _ = lbvh_queries(dev, card, bvh, lo, hi, c)
    mesh_launches, _ = mesh_queries(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        surface_launches, _ = surface_path(dev, card, fluid["x"],
                                           surface_ref, tmp)
    ag_launches_a = adaptive_grid_path(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        io_launches, bsim, bst, bdt, bout = io_path(dev, card, ag, tmp)
        md_launches = multi_device_path(dev, card, bsim, bst, bdt, bout, tmp)
    new = {"LBVH query family (phase 32)": query_launches,
           "mesh queries (phase 33)": mesh_launches,
           "dam-break surface (phase 34)": surface_launches}
    print(f"  phases 32-34, (scan, NSE) launches: {new}", flush=True)
    later = {"adaptive grid card against CPU (phase 36a)": ag_launches_a,
             "README scene on the adaptive ground (phase 36b)": ag_launches,
             "examples/mpm_block.py with I/O (phase 37)": io_launches,
             **{f"{k} step at world size 1 (phase 38)": v
                for k, v in md_launches.items()}}
    print(f"  phases 36-38, scan launches (no NSE): {later}", flush=True)
    per_path = {"elastic block (phase 4)": launches,
                "dam break (phase 10)": fluid_launches,
                "materials (phase 12)": mat_launches,
                "implicit block (phase 13)": imp_launches,
                "mesh contact (phase 16)": contact_launches,
                "config 1 (phase 19)": config1_launches,
                "containers, CSR, graphs (phase 20)": container_launches,
                "README scene through simulate (phase 21)": readme_launches,
                "2-D discs at scale (phase 24)": discs_launches,
                "incremental rebin (phase 26)": migrate_launches,
                "cloth and FEM (phases 27-31)": cloth_launches,
                **{k: v[0] for k, v in new.items()}, **later}
    print(f"  scan launches per path: {per_path}; total "
          f"{sum(per_path.values())}", flush=True)
    launches = sum(per_path.values())
    _barrier_launches(barrier_18, "phases 19-38 (no mesh contact) launched "
                                  "none: phase 18's card steps")
    barrier_paths = {"mesh contact (phase 16)": barrier_16,
                     **{f"config 5, terrain res {r} (phase 17)": n
                        for r, n in barrier_17.items()},
                     "contact card against CPU (phase 18)": barrier_18}
    print(f"  mesh barrier launches per path (one a narrow phase): "
          f"{barrier_paths}; total {sum(barrier_paths.values())}",
          flush=True)
    check(apply_op.LAUNCHES == apply_18,
          f"phases 19-38 launched no operator kernel (no 3-D implicit "
          f"step): {apply_op.LAUNCHES} launches since phase 18's "
          f"{apply_18}")
    apply_paths = {"implicit block (phase 13)": apply_13,
                   "implicit card against CPU (phase 14)": apply_14,
                   "mesh contact (phase 16)": apply_16,
                   **{f"config 5, terrain res {r} (phase 17)": n
                      for r, n in apply_17.items()},
                   "three steps over the terrain (phase 17b)": apply_17b,
                   "contact card against CPU (phase 18)": apply_18}
    print(f"  operator kernel launches per path (one an application, CG "
          f"iterations + 1 a step; none on the CPU): {apply_paths}; total "
          f"{sum(apply_paths.values())}", flush=True)
    scan_t, lib_t = times[327_680], times["library"]
    # ms: back-to-back time per call; device_ms: the profiler's device time
    # per call.  bound: each input read once and each output written once,
    # 4 + 4 bytes per element, over the HBM rate
    print(json.dumps({"kernels": [{
        "name": "scan", "route": "cuda",
        "source": "zpc_tpu_torch/csrc/scan.cu",
        "replaces": "zpc_tpu/ops/scan_pallas.py:124",
        "launches": launches, "max_abs_err": max_err,
        "ms": scan_t["ms"], "device_ms": scan_t["device_ms"],
        "kernels_per_call": scan_t["kernels_per_call"],
        "plain_ms": scan_t["plain_ms"],
        "bound_ms": 8 * 327_680 / HBM_BYTES_PER_MS, "bound_by": "bytes",
        "library_ms": lib_t["ms"], "library_device_ms": lib_t["device_ms"]}, {
        "name": "nse", "route": "cuda",
        "source": "zpc_tpu_torch/csrc/nse.cu",
        "replaces": "zpc_tpu/ops/nse_pallas.py:92",
        "launches": nse_launches + cloth_nse + sum(
            v[1] for v in new.values()), "max_abs_err": nse_err,
        "ms": nse_t["ms"], "device_ms": nse_t["device_ms"],
        "kernels_per_call": nse_t["kernels_per_call"],
        "plain_ms": nse_t["plain_ms"],
        "bound_ms": 8 * (N_BVH - 1) / HBM_BYTES_PER_MS, "bound_by": "bytes",
        "library_ms": None}, {
        # at the 100,352-triangle terrain's contact set (phase 17); the
        # bound counts the benchmark's contact_narrow_roofline way
        "name": "mesh_barrier", "route": "cuda",
        "source": "zpc_tpu_torch/csrc/mesh_barrier.cu",
        "replaces": "zpc_tpu/sim/contact_implicit.py:123 (dense XLA)",
        "launches": sum(barrier_paths.values()),
        "worst_of_bound": barrier_t["worst_of_bound"],
        "ms": barrier_t["ms"], "device_ms": barrier_t["device_ms"],
        "kernels_per_call": barrier_t["kernels_per_call"],
        "plain_ms": barrier_t["plain_ms"],
        "bound_ms": barrier_t["bound_ms"],
        "bound_by": barrier_t["bound_by"], "library_ms": None}, {
        # the launches of the steps of phases 13-18; the times at the
        # cells' shape (phase 17b), without and with the barrier's Hessian
        "name": "implicit_apply", "route": "cuda",
        "source": "zpc_tpu_torch/csrc/implicit_apply.cu",
        "replaces": "zpc_tpu/sim/implicit_binned2.py (XLA operator)",
        "launches": sum(apply_paths.values()), "library_ms": None,
        "shapes": {label: {
            "gap": t["gaps"]["kernel"], "ms": t["ms"],
            "device_ms": t["device_ms"],
            "kernels_per_call": t["kernels_per_call"],
            "plain_ms": t["plain_ms"], "composition_ms": t["composition_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"]}
            for label, t in apply_t.items()}}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
