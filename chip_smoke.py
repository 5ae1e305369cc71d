"""Smoke run of the PyTorch/CUDA port (zpc_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Five paths run at full width: the explicit-MPM elastic block, the LBVH
broad phase, the weakly compressible dam break, the implicit-MPM block
(BASELINE config 5 without contact) and the same block over a mesh with
IPC contact (config 5 as specified, over a two-triangle floor and over
the bench's two heightfields); the four materials of
examples/materials.py run at their own size, and the CG Poisson solve of
BASELINE config 2 at its bench size.  Phases (each prints its
results; a failed check raises and the script exits non-zero; nothing is
caught):

1. environment: torch and CUDA versions, the card's name and power limit;
   fails when no CUDA device is visible;
2. build: compiles the CUDA kernels from csrc/ with nvcc (sm_90a), one
   nvcc per source, all started together, and prints each kernel's
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
   1e-4, mean v_y within 1% of free fall; then the chain best of 3
   (ms/step, particle-steps/s, CG iterations per step);
14. implicit card against CPU: phase 5's small scene for 20 implicit
   steps on CUDA and on the CPU (CG iterations per step equal within 1;
   x, v, F within 1e-6, 5e-4, 1e-5 plus the CPU's own spread over
   summation order);
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
   contact-free step's, no particle below the floor; then the chain best
   of 3 beside phase 13's;
17. BASELINE config 5's contact rows as specified: the bench's
   heightfields of 2,048 and 100,352 triangles under the same block,
   each with its overflow flag (printed, not gated; equal to the CPU
   port's on the same bin state), its live bins truncated and out of
   band, CG iterations and ms/step best of 3 of a 10-step chain; gated on
   finite columns and mass;
18. contact card against CPU: tests/test_contact_implicit.py's 100-step
   scene (512 particles, dx 0.05, 96 bins, floor at 0.2, dhat 0.02, kappa
   2e4, max_tris 4, use_ccd, dt 2e-3) for 20 steps, then one
   contact_precond step, on CUDA and on the CPU (CG iterations equal
   within 1; x, v, F within phase 14's tolerances plus the CPU's own
   spread over summation order; no particle below floor - dhat).

The scan's launches in the kernel record are those of phases 4, 10, 12,
13 and 16 (a line before gives them per path).  The last two lines are the
kernel record and the contract line ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import (  # noqa: E402
    ProfilerActivity, profile, record_function)

import zpc_tpu_torch  # noqa: E402
from zpc_tpu_torch import _kernels, scenes  # noqa: E402
from zpc_tpu_torch.containers import bvh as bvh_mod  # noqa: E402
from zpc_tpu_torch.ops import nse as nse_op  # noqa: E402
from zpc_tpu_torch.ops import scan as scan_op  # noqa: E402
from zpc_tpu_torch.math import solvers  # noqa: E402
from zpc_tpu_torch.models.constitutive import FixedCorotated  # noqa: E402
from zpc_tpu_torch.parallel import primitives  # noqa: E402
from zpc_tpu_torch.sim import contact_implicit as ci  # noqa: E402
from zpc_tpu_torch.sim import fluid as fl  # noqa: E402
from zpc_tpu_torch.sim import fluid_binned2 as fb  # noqa: E402
from zpc_tpu_torch.sim import implicit_binned2 as ib2  # noqa: E402
from zpc_tpu_torch.sim import mpm as mpm_mod  # noqa: E402
from zpc_tpu_torch.sim import mpm_binned2 as b2  # noqa: E402

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
N_CSMALL, CSMALL_STEPS, CSMALL_FLOOR, CSMALL_DHAT = 512, 20, 0.2, 0.02
HBM_BYTES_PER_MS = 3.35e12 / 1e3     # H100 SXM HBM3 rate (data sheet)
_WINDOW = "timed calls"               # the profiler window of device_split


def phase(name):
    print(f"== {name}", flush=True)


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


def device_split(fn, reps=100):
    """(device ms per call, device activities per call, their names) of
    ``fn`` from torch.profiler.  The activities per call are the host's
    launch, memset and copy calls inside a window of ``reps`` calls (the
    host's clock, exact); the device time per call is the mean duration of
    the device events times that count, so an event the profiler failed to
    record (it drops a few) does not count as a missing launch."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
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
    launches = [e for e in events if e.device_type == DeviceType.CPU
                and e.name.startswith(_LAUNCHES)
                and win[0].start <= e.time_range.start <= win[0].end]
    ev = [e for e in events
          if e.device_type == DeviceType.CUDA and e.name != _WINDOW]
    if not ev:
        raise RuntimeError("the profiler saw no device time")
    per_call = len(launches) / reps
    mean_ms = sum(e.time_range.elapsed_us() for e in ev) / len(ev) / 1e3
    return mean_ms * per_call, per_call, sorted({e.name for e in ev})


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
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        secs = dict(zip(("scan", "nse"), pool.map(timed, (scan_op, nse_op))))
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
        calls.append((x.clone(), op, exclusive, out.clone()))
        return out
    primitives.scan = record
    try:
        yield calls
    finally:
        primitives.scan = inner


def replay_scans(calls):
    """Each recorded scan against scan_reference on the same tensor: ints
    exact (the main path scans int32 only)."""
    for x, op, excl, out in calls:
        if x.dtype != torch.int32:
            raise AssertionError(f"main-path scan of {x.dtype}")
        ref = scan_op.scan_reference(x, op, excl)
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
    lay = fb._LAY
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
                      "rebin_ms": reb_ms, "launches_bin": launches_bin}


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

    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
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
    return launches, ms


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
    g, gb, gi = _implicit_small(dev)
    c, cb, ci = _implicit_small(torch.device("cpu"))
    c_rev, _, ri = _implicit_small(torch.device("cpu"), reverse=True)
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
                               max_tris=mc.max_tris)
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

    scan_op.LAUNCHES = nse_op.LAUNCHES = 0
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
    free, _ = ib2.implicit_step_binned2(sim, bst, dt, cfg, cg_iters=CG_ITERS,
                                        cg_tol=CG_TOL, rebin=False,
                                        with_stats=True)
    peak_free = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
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
    ms = min(times)
    print(f"  {IMP_CHAIN}-step chain best of 3: {ms:.4f} ms/step = "
          f"{N_IMP / ms / 1e3:.4f} M particle-steps/s (chains "
          f"{', '.join(f'{t:.4f}' for t in times)} ms/step; CG iterations "
          f"per step {iters[-IMP_CHAIN:]}); phase 13 without contact "
          f"{free_ms:.4f} ms/step: contact costs {ms - free_ms:.4f} ms a "
          f"step ({card})", flush=True)
    return launches


def config5_rows(dev, card):
    phase("17 config 5's contact rows as specified")
    for res in TERRAIN_RES:
        tri = scenes.terrain_mesh(res, dev)
        sim, st, dt, cfg, mc = scenes.contact_block(N_IMP, tri, dev)
        m0 = st.particles["m"].double().sum().item()
        bst = b2.bin_state(sim, st, cfg)
        counts = _query_counts(mc, _bin_query(mc, bst, cfg))
        counts_c = _query_counts(mc, _bin_query_cpu(tri, mc, bst, cfg))
        flag = counts[5]
        check(flag == counts_c[5],
              f"{tri.shape[0]} triangles: the overflow flag on the card "
              f"({flag}) = the CPU port's on the same bin state; live bins "
              f"{counts[0]}, {counts[1]} with a triangle in reach, "
              f"{counts[2]} truncated (> {mc.max_tris} candidates), "
              f"{counts[3]} out of band, at most {counts[4]} candidates "
              f"(CPU: {counts_c[:5]})")
        iters = []

        def step(s):
            out, it = ib2.implicit_step_binned2(
                sim, s, dt, cfg, cg_iters=CG_ITERS, cg_tol=CG_TOL,
                contact=mc, rebin=False, with_stats=True)
            iters.append(it)
            return out
        one = step(bst)
        print(f"  one step: overflow flag {bool(one.overflow)} (printed, "
              f"not gated), {iters[0]} CG iterations", flush=True)
        _mass_gates(one, m0, N_IMP, f"{tri.shape[0]} triangles, one step")
        times, outs = _timed_chains(
            step, lambda s: b2.rebin_adaptive(sim, s, cfg), bst)
        check(all(bool(torch.isfinite(o.cols).all()) for o in outs),
              f"{tri.shape[0]} triangles: the chains' columns finite")
        ms = min(times)
        print(f"  config 5 + LBVH contact, {tri.shape[0]} triangles: "
              f"{ms:.4f} ms/step best of 3 = {N_IMP / ms / 1e3:.4f} M "
              f"particle-steps/s (chains "
              f"{', '.join(f'{t:.4f}' for t in times)} ms/step; CG "
              f"iterations per step {iters[-IMP_CHAIN:]}; overflow "
              f"{flag}; {card})", flush=True)


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
    g, gp, g_it, gy = _contact_small(dev)
    c, cp, c_it, cy = _contact_small(torch.device("cpu"))
    r, rp, r_it, _ = _contact_small(torch.device("cpu"), reverse=True)
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
    fluid_launches, _ = dam_break_path(dev, card)
    fluid_card_vs_cpu(dev)
    mat_launches = materials_path(dev, card)
    imp_launches, imp_ms = implicit_path(dev, card)
    implicit_card_vs_cpu(dev)
    poisson(dev, card)
    contact_launches = contact_path(dev, card, imp_ms)
    config5_rows(dev, card)
    contact_card_vs_cpu(dev)
    per_path = {"elastic block (phase 4)": launches,
                "dam break (phase 10)": fluid_launches,
                "materials (phase 12)": mat_launches,
                "implicit block (phase 13)": imp_launches,
                "mesh contact (phase 16)": contact_launches}
    print(f"  scan launches per path: {per_path}; total "
          f"{sum(per_path.values())}", flush=True)
    launches = sum(per_path.values())
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
        "launches": nse_launches, "max_abs_err": nse_err,
        "ms": nse_t["ms"], "device_ms": nse_t["device_ms"],
        "kernels_per_call": nse_t["kernels_per_call"],
        "plain_ms": nse_t["plain_ms"],
        "bound_ms": 8 * (N_BVH - 1) / HBM_BYTES_PER_MS, "bound_by": "bytes",
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
