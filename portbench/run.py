"""Run one cell of the benchmark of ``zpc_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  The cell
is a ``workloads`` entry of ``BENCHMARK.json``; its configuration,
traffic mix, limits and per-layer metrics are files under ``portbench/``
found by name (``portbench/README.md``).  The last line of standard
output is the result as one JSON object; the last lines of standard error
are the numbers compared with the plain reference, each beside its limit.
A run that has loaded JAX or the JAX package by the time it ends prints
no result.

Every cache a run writes is under ``.portbench_cache/`` in the checkout,
and the port's nvcc builds are in ``zpc_tpu_torch/_build/``.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CACHE, _sub)
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else \
        "nvidia-smi printed nothing"


FORBIDDEN = ("jax", "jaxlib", "flax", "zpc_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (the part before the first dot)
    is one of :data:`FORBIDDEN`, compared whole: ``zpc_tpu_torch`` is
    not ``zpc_tpu``."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def report(cell, seed: int, seconds: float, trace: bool, dev, card: str,
           t0: float) -> int:
    """Run ``cell`` once and print its result line; the exit code.  Once
    the run is over (the window, the reference, the readers), a loaded
    module of :data:`FORBIDDEN` voids it: no result, exit code 3."""
    from portbench.harness.cell import run_cell
    res = run_cell(cell, seed, seconds, trace, dev, t0, card, log=_log)
    bad = forbidden_modules()
    if bad:
        _log(f"no result: the run loaded {', '.join(bad)}")
        return 3
    _log(f"{cell.name} seed {seed}: {card_line()}")
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": res["device"]}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["check"] = res["check"]
    _log(f"correct {res['correct']}, {res['failed']} of "
         f"{res['attempted']} segments failed")
    for name, c in res["check"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness.spec import load_cell
    cell = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        _log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _log(f"the cell asks for {cell.chips} GPUs, "
             f"{torch.cuda.device_count()} present")
        return 2
    dev = torch.device("cuda", 0)
    return report(cell, args.seed, args.seconds, bool(args.trace), dev,
                  torch.cuda.get_device_name(dev), T0)


if __name__ == "__main__":
    sys.exit(main())
