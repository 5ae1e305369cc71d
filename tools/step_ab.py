"""The port's explicit MPM steps (elastic and fluid) against an earlier
tree's, on one card in one process, in turns (old, new, new, old).

Run from the repository root, with the earlier tree unpacked into a
directory that .gitignore lists:

    mkdir -p _scratch/parent
    git archive <commit> | tar -x -C _scratch/parent
    python3 tools/step_ab.py _scratch/parent

The earlier tree's ``zpc_tpu_torch`` is loaded under another name, so its
steps run as they were.  Two scenes: chip_smoke's main path (the 262,144-
particle elastic block, dx = 1/128, BinnedConfig2(bins_capacity=2560,
block_capacity=2048)) and the 262,144-particle dam break of bench_fluid
(bins derived from n).  Each tree builds and bins both; one step of each
from the same binned state must give the same columns, bit for bit (max
abs diff 0, or no more than the new step differs from itself when run
twice: the scatter's atomics add in no fixed order).  Then, per turn: the
elastic block's 720-step adaptive_chain between CUDA events
(particle-steps/s, as chip_smoke phase 6 reads it), and one step's device
time and device activities from torch.profiler for each scene.  Prints the card's name and power limit and one line per
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
from zpc_tpu_torch.sim import fluid_binned2 as fb_new  # noqa: E402
from zpc_tpu_torch.sim import mpm_binned2 as b2_new  # noqa: E402
from kernel_ab import load_parent  # noqa: E402

ALIAS = "parent_zpc_tpu_torch"


def version(scenes, b2, fb, dev):
    """{scene: (one step, binned state)} and the elastic chain of one
    tree."""
    cfg = b2.BinnedConfig2(bins_capacity=2560, block_capacity=2048)
    sim, st, dt = scenes.mpm_block(chip_smoke.N_MAIN, chip_smoke.DX_MAIN,
                                   dev)

    def step(s):
        return b2.explicit_step_binned2(sim, s, dt, cfg, rebin=False)

    def chain(s):
        return b2.adaptive_chain(step, lambda t: b2.rebin_adaptive(
            sim, t, cfg), s, chip_smoke.CHAIN)
    fsim, fst, fdt, fcfg = scenes.dam_break(chip_smoke.N_FLUID, dev)
    return {"elastic": (step, b2.bin_state(sim, st, cfg)),
            "fluid": (lambda s: fb.explicit_fluid_step_binned2(
                fsim, s, fdt, fcfg, rebin=False),
                fb.bin_fluid_state(fsim, fst, fcfg))}, chain


def main():
    if len(sys.argv) != 2:
        raise SystemExit("usage: python3 tools/step_ab.py <earlier tree>")
    card = chip_smoke.environment()
    dev = torch.device("cuda", 0)
    load_parent(sys.argv[1])
    old = version(importlib.import_module(f"{ALIAS}.scenes"),
                  importlib.import_module(f"{ALIAS}.sim.mpm_binned2"),
                  importlib.import_module(f"{ALIAS}.sim.fluid_binned2"), dev)
    new = version(scenes_new, b2_new, fb_new, dev)
    record = {"card": card, "agreement": {}, "turns": []}
    for scene in ("elastic", "fluid"):
        (so, bo), (sn, bn) = old[0][scene], new[0][scene]
        chip_smoke.check(torch.equal(bo.cols, bn.cols),
                         f"{scene}: the same binned state")
        a, b = so(bo), sn(bn)
        err = (a.cols - b.cols).abs().max().item()
        # the same tree twice: what the scatter's atomics leave unordered
        rep = (sn(bn).cols - b.cols).abs().max().item()
        record["agreement"][scene] = {"old_new": err, "new_new": rep}
        chip_smoke.check(err <= rep and torch.equal(a.pid, b.pid),
                         f"{scene}: one step, old against new: every column "
                         f"max abs diff {err:.3g} (the new step against "
                         f"itself: {rep:.3g})")
    versions = {"old": old, "new": new}
    for who in ("old", "new", "new", "old"):
        steps, chain = versions[who]
        step, bst = steps["elastic"]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = chain(bst)
        e1.record()
        torch.cuda.synchronize()
        chip_smoke.check(not bool(out.overflow), f"{who}: no overflow")
        sec = e0.elapsed_time(e1) / 1e3
        pps = chip_smoke.N_MAIN * chip_smoke.CHAIN / sec
        turn = {"version": who, "chain_s": sec, "pps": pps}
        for scene, (step, bst) in steps.items():
            dev_ms, per_step, _ = chip_smoke.device_split(
                lambda: step(bst), reps=20)
            turn[scene] = {"step_device_ms": dev_ms,
                           "device_activities_per_step": per_step}
        record["turns"].append(turn)
        print(f"  {who}: {chip_smoke.CHAIN}-step elastic chain {sec:.4f} s "
              f"= {pps / 1e6:.4f} M particle-steps/s; one elastic step: "
              f"device {turn['elastic']['step_device_ms']:.4f} ms, "
              f"{turn['elastic']['device_activities_per_step']:g} device "
              f"activities; one fluid step: device "
              f"{turn['fluid']['step_device_ms']:.4f} ms, "
              f"{turn['fluid']['device_activities_per_step']:g} device "
              f"activities ({card})", flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "step_ab.json"), "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
