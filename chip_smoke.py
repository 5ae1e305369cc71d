"""Smoke run of the PyTorch/CUDA port (zpc_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its results; a failed check raises and the script
exits non-zero; nothing is caught):

1. environment: torch and CUDA versions, the card's name and power limit;
   fails when no CUDA device is visible;
2. build: compiles the CUDA kernels from csrc/ with nvcc (sm_90a);
3. kernel against plain: the scan kernel against its plain PyTorch version
   on the card, every dtype and op, n from 1 to 16M + 7 (the main path's
   sizes included), and their times;
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
   one rebin and one bin_state.

The last two lines are the kernel record and the contract line
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import zpc_tpu_torch  # noqa: E402
from zpc_tpu_torch import scenes  # noqa: E402
from zpc_tpu_torch.ops import scan as scan_op  # noqa: E402
from zpc_tpu_torch.parallel import primitives  # noqa: E402
from zpc_tpu_torch.sim import mpm_binned2 as b2  # noqa: E402

N_MAIN, DX_MAIN, CHAIN = 262_144, 1.0 / 128, 720
CFG_MAIN = b2.BinnedConfig2(bins_capacity=2560, block_capacity=2048)
# 2,560 (the pad sums), 20,480 (the table rank), 65,536 (the dummy keys),
# 262,144 and 327,680 (the lane ranks) are the main path's scan sizes
SCAN_SIZES = (1, 1000, 2_560, 20_480, 65_536, 131_072, 262_144, 327_680,
              16_777_216 + 7)
TOL = dict(x=1e-5, v=2e-4, F=1e-5)


def phase(name):
    print(f"== {name}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(5):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


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
    t0 = time.perf_counter()
    scan_op.build()
    print(f"  scan.cu built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)


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
    times = {}
    for n in (327_680, 16_777_216 + 7):
        x = torch.randint(0, 2, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        k = cuda_ms(lambda: scan_op.scan(x), 200)
        p = cuda_ms(lambda: scan_op.scan_reference(x), 200)
        times[n] = (k, p)
        print(f"  int32 add n={n}: kernel {k:.4f} ms, plain "
              f"{p:.4f} ms ({card})", flush=True)
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

    scan_op.LAUNCHES = 0
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


def main():
    card = environment()
    dev = zpc_tpu_torch.cuda_device(0)
    build()
    max_err, times = kernel_vs_plain(dev, card)
    sim, st, bst, dt, launches = main_path(dev)
    card_vs_cpu(dev)
    throughput(sim, st, bst, dt, card)
    k_ms, p_ms = times[327_680]
    print(json.dumps({"kernels": [{
        "name": "scan", "route": "cuda",
        "source": "zpc_tpu_torch/csrc/scan.cu",
        "replaces": "zpc_tpu/ops/scan_pallas.py:124",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
