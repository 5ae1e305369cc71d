"""The readings that the limits of ``correct`` are set from, for one cell,
in one process (the set-up, the CUDA context and the kernels paid once).

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--fault-seeds 7,8,9] [--device cuda]

For each of ``--seeds``: the cell's set-up, two segments of the window
through the program, and the plain reference (float64) after the same
steps from the same inputs; prints the three gaps as a run of two
segments compares them (the lower readings).
For each of ``--control-seeds``: the reference computed in bfloat16, the
precision below the configuration's float32, in the program's place;
prints its gaps to the float64 reference (the upper readings).
For each of ``--fault-seeds`` and each fault of ``--faults``: a program
reading with the fault planted in the implicit step (``dP_zero``: the
force differential returns 0; ``cg_start``: the CG solve returns its
start vector, the predictor; ``contact_off``, in a cell with contact:
the barrier's force and Hessian are 0).  Program and fault readings also say
whether the cell's current limits pass them (``correct_now``).  One JSON
object a line, on standard output.  The benchmark's own runs never run
the control nor a fault.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CACHE, _sub)
sys.path.insert(0, ROOT)

import argparse  # noqa: E402

import torch  # noqa: E402

from portbench.harness import check, inputs  # noqa: E402
from portbench.harness.cell import prepare  # noqa: E402
from portbench.harness.spec import BENCH, load_cell, load_module  # noqa: E402
from zpc_tpu_torch.math import solvers  # noqa: E402
from zpc_tpu_torch.sim import contact_implicit as ci  # noqa: E402
from zpc_tpu_torch.sim import implicit_binned2 as ib2  # noqa: E402


def _ints(s: str):
    return [int(v) for v in s.split(",") if v]


def program_reading(cell, seed: int, dev, ref_mod, kind="program") -> dict:
    """Two segments of the cell's window against the float64 reference."""
    cfg, tr = cell.config, cell.traffic
    prog, start, inp = prepare(cell, seed, dev)
    tracker = check.Tracker()
    failed = False
    t = time.perf_counter()
    for _ in range(2):
        out, bad = prog.segment(start, tr["segment_steps"])
        tracker.add(prog.particles(out))
        failed |= bad
    seg_s = (time.perf_counter() - t) / 2
    counts = dict(rebins=prog.counters.rebins,
                  cg_iters=prog.counters.cg_iters[-tr["segment_steps"]:])
    del prog, start, out
    t = time.perf_counter()
    ref = ref_mod.run(cfg, inp.x0, inp.v0, inp.tri, inp.dt,
                      tr["snapshot_steps"] + tr["segment_steps"],
                      torch.float64)
    ref_s = time.perf_counter() - t
    gaps = check.gaps(tracker.first, ref, cfg["dx"], tracker.delta)
    ok, _ = check.judge(gaps, cell.limits)
    return dict(kind=kind, seed=seed, failed=failed,
                correct_now=bool(ok and not failed), segment_s=seg_s,
                reference_s=ref_s, **counts, **gaps)


def control_reading(cell, seed: int, dev, ref_mod) -> dict:
    """The reference in bfloat16 against the reference in float64."""
    cfg, tr = cell.config, cell.traffic
    inp = inputs.make(cfg, tr, seed, dev)
    steps = tr["snapshot_steps"] + tr["segment_steps"]
    ref = ref_mod.run(cfg, inp.x0, inp.v0, inp.tri, inp.dt, steps,
                      torch.float64)
    t = time.perf_counter()
    low = ref_mod.run(cfg, inp.x0, inp.v0, inp.tri, inp.dt, steps,
                      torch.bfloat16)
    return dict(kind="control", seed=seed, control_s=time.perf_counter() - t,
                **check.gaps(low, ref, cfg["dx"]))


class _NoForceDifferential:
    """A material model whose force differential dP(F)[dF] is 0."""

    def __init__(self, model):
        self.model = model

    def kirchhoff(self, F):
        return self.model.kirchhoff(F)

    def linearize(self, F):
        return torch.zeros_like


def _dP_zero(orig):
    return lambda *a, **kw: _NoForceDifferential(orig(*a, **kw))


def _cg_start(orig):
    def cg(A, b, x0=None, **kw):
        return solvers.SolveResult(x0, 0, torch.zeros(()), torch.ones(
            (), dtype=torch.bool))
    return cg


def _contact_off(orig):
    def forces_and_hessians(self, cset, xb, lane_alive):
        fc, Hc = orig(self, cset, xb, lane_alive)
        return torch.zeros_like(fc), torch.zeros_like(Hc)
    return forces_and_hessians


# faults planted in the implicit step at the cell's size: (owner,
# attribute, wrapper of the original, needs contact)
FAULTS = {"dP_zero": (ib2, "_lane_model", _dP_zero, False),
          "cg_start": (ib2, "cg", _cg_start, False),
          "contact_off": (ci.MeshContact, "forces_and_hessians",
                          _contact_off, True)}


def fault_applies(cell, fault: str) -> bool:
    return cell.config["integrator"]["kind"] == "implicit" and \
        (not FAULTS[fault][3] or bool(cell.traffic["contact"]))


def fault_reading(cell, fault: str, seed: int, dev, ref_mod) -> dict:
    """A program reading with ``fault`` planted in the implicit step."""
    owner, attr, wrap, _ = FAULTS[fault]
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        return program_reading(cell, seed, dev, ref_mod, kind=fault)
    finally:
        setattr(owner, attr, orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    ref_mod = load_module(
        BENCH / "reference" / f"{cell.config['reference']}.py")
    for seed in args.seeds:
        print(json.dumps(program_reading(cell, seed, dev, ref_mod)),
              flush=True)
    for seed in args.control_seeds:
        print(json.dumps(control_reading(cell, seed, dev, ref_mod)),
              flush=True)
    for fault in [f for f in args.faults.split(",")
                  if f and fault_applies(cell, f)]:
        for seed in args.fault_seeds:
            print(json.dumps(fault_reading(cell, fault, seed, dev, ref_mod)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
