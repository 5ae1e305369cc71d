"""The port's two hand kernels against an earlier tree's, on one card in one
process, in turns (old, new, new, old).

Run from the repository root, with the earlier tree unpacked into a
directory that .gitignore lists:

    mkdir -p _scratch/parent
    git archive <commit> | tar -x -C _scratch/parent
    python3 tools/kernel_ab.py _scratch/parent

The earlier tree's ``zpc_tpu_torch`` is loaded under another name, so its
wrappers and kernels run as they were (built from its own ``csrc/`` into its
own ``_build/``).  For the scan (int32 add at 327,680 and 16,777,223) and
the NSE sweep (random d at g = 1,048,575) each version is first checked
against the plain version on the same input, then timed four times in
turns: device time per call and device activities per call from
torch.profiler, and back-to-back time per call between CUDA events.  Prints
the card's name and power limit, one line per turn, and writes everything
to chiprun_out/kernel_ab.json.
"""

import importlib
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from zpc_tpu_torch.ops import nse as nse_new  # noqa: E402
from zpc_tpu_torch.ops import scan as scan_new  # noqa: E402

ALIAS = "parent_zpc_tpu_torch"


def load_parent(tree):
    """The earlier tree's scan and nse modules, imported as ``ALIAS``."""
    pkg = os.path.join(os.path.abspath(tree), "zpc_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        ALIAS, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[ALIAS] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{ALIAS}.ops.scan"),
            importlib.import_module(f"{ALIAS}.ops.nse"))


def main():
    if len(sys.argv) != 2:
        raise SystemExit("usage: python3 tools/kernel_ab.py <earlier tree>")
    card = chip_smoke.environment()
    dev = torch.device("cuda", 0)
    scan_old, nse_old = load_parent(sys.argv[1])
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for n in (327_680, 16_777_216 + 7):
        x = torch.randint(0, 2, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        cases.append((f"scan int32 add n={n}", scan_new.scan_reference(x),
                      {"old": lambda x=x: scan_old.scan(x),
                       "new": lambda x=x: scan_new.scan(x)}))
    d = torch.randint(1, 64, (1_048_575,), generator=gen, device=dev,
                      dtype=torch.int32)
    cases.append(("nse g=1048575 random", nse_new.nse_reference(d),
                  {"old": lambda: nse_old.nse(d),
                   "new": lambda: nse_new.nse(d)}))
    record = {"card": card, "cases": {}}
    for label, want, fns in cases:
        for who, fn in fns.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{label}: the {who} kernel differs "
                                     f"from the plain version")
        turns = []
        for who in ("old", "new", "new", "old"):
            dev_ms, per_call, names = chip_smoke.device_split(fns[who])
            ms = chip_smoke.cuda_ms(fns[who], 200)
            turns.append({"version": who, "device_ms": dev_ms, "ms": ms,
                          "kernels_per_call": per_call, "kernels": names})
            print(f"  {label} {who}: device {dev_ms:.6f} ms, per call "
                  f"{ms:.6f} ms, {per_call:g} kernels per call {names} "
                  f"({card})", flush=True)
        record["cases"][label] = turns
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "kernel_ab.json"), "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
