"""The port's elastic MPM step against an earlier tree's, on one card in one
process, in turns (old, new, new, old).

Run from the repository root, with the earlier tree unpacked into a
directory that .gitignore lists:

    mkdir -p _scratch/parent
    git archive <commit> | tar -x -C _scratch/parent
    python3 tools/step_ab.py _scratch/parent

The earlier tree's ``zpc_tpu_torch`` is loaded under another name, so its
step runs as it was.  Both build chip_smoke's main path (the 262,144-
particle elastic block, dx = 1/128, BinnedConfig2(bins_capacity=2560,
block_capacity=2048)) and bin it; one step of each from the same binned
state must agree (x 1e-5, v 2e-4, F 1e-5).  Then, per turn: the 720-step
adaptive_chain between CUDA events (particle-steps/s, as chip_smoke phase
6 reads it), and one step's device time and device activities from
torch.profiler.  Prints the card's name and power limit and one line per
turn, and writes everything to chiprun_out/step_ab.json.
"""

import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from zpc_tpu_torch import scenes as scenes_new  # noqa: E402
from zpc_tpu_torch.sim import mpm_binned2 as b2_new  # noqa: E402
from kernel_ab import load_parent  # noqa: E402

ALIAS = "parent_zpc_tpu_torch"


def version(scenes, b2, dev):
    """(one step, the 720-step chain, binned state) of one tree."""
    cfg = b2.BinnedConfig2(bins_capacity=2560, block_capacity=2048)
    sim, st, dt = scenes.mpm_block(chip_smoke.N_MAIN, chip_smoke.DX_MAIN,
                                   dev)
    bst = b2.bin_state(sim, st, cfg)

    def step(s):
        return b2.explicit_step_binned2(sim, s, dt, cfg, rebin=False)

    def chain(s):
        return b2.adaptive_chain(step, lambda t: b2.rebin_adaptive(
            sim, t, cfg), s, chip_smoke.CHAIN)
    return step, chain, bst


def main():
    if len(sys.argv) != 2:
        raise SystemExit("usage: python3 tools/step_ab.py <earlier tree>")
    card = chip_smoke.environment()
    dev = torch.device("cuda", 0)
    load_parent(sys.argv[1])
    old = version(importlib.import_module(f"{ALIAS}.scenes"),
                  importlib.import_module(f"{ALIAS}.sim.mpm_binned2"), dev)
    new = version(scenes_new, b2_new, dev)
    a, b = old[0](old[2]), new[0](new[2])
    record = {"card": card, "agreement": {}, "turns": []}
    for name, sl, tol in (("x", slice(0, 3), 1e-5), ("v", slice(3, 6), 2e-4),
                          ("F", slice(6, 15), 1e-5)):
        err = (a.cols[:, sl] - b.cols[:, sl]).abs().max().item()
        record["agreement"][name] = err
        chip_smoke.check(err <= tol, f"one step, old against new: {name} "
                                     f"max abs diff {err:.3g} <= {tol}")
    versions = {"old": old, "new": new}
    for who in ("old", "new", "new", "old"):
        step, chain, bst = versions[who]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = chain(bst)
        e1.record()
        torch.cuda.synchronize()
        chip_smoke.check(not bool(out.overflow), f"{who}: no overflow")
        sec = e0.elapsed_time(e1) / 1e3
        pps = chip_smoke.N_MAIN * chip_smoke.CHAIN / sec
        dev_ms, per_step, _ = chip_smoke.device_split(lambda: step(bst),
                                                      reps=20)
        record["turns"].append({"version": who, "chain_s": sec, "pps": pps,
                                "step_device_ms": dev_ms,
                                "device_activities_per_step": per_step})
        print(f"  {who}: {chip_smoke.CHAIN}-step chain {sec:.4f} s = "
              f"{pps / 1e6:.4f} M particle-steps/s; one step: device "
              f"{dev_ms:.4f} ms, {per_step:g} device activities ({card})",
              flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "step_ab.json"), "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
