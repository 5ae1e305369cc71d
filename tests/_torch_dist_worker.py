"""One rank of the port's multi-process runs (spawned by
tests/test_torch_distributed.py): gloo on the CPU, a ``file://``
rendezvous, no JAX.

    python tests/_torch_dist_worker.py <job dir> <world size> <rank>

The job directory holds ``job.json`` (a list of cases) and ``in_<i>.npz``
(each case's positions and velocities).  Every rank runs every case; rank
0 writes ``out_<i>.npz``.  Cases:

* ``mesh``: the mesh helpers (``shard_leading``, ``global_array``,
  ``local_to_global_index`` with unequal shares, ``process_info``);
* ``sharded``: ``shard_state`` + ``explicit_step_sharded`` for ``steps``
  steps; the particles gathered, the table count, the grid mass;
* ``dd``: ``make_dd_state`` + ``explicit_step_dd`` for ``steps`` steps;
  a step that overflows is run again from the same input with the
  ``retry`` capacities when given (the host's recovery contract); the
  overflow flags, the stats, the slot layouts and the particles gathered.
"""

import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from zpc_tpu_torch.models.constitutive import FixedCorotated  # noqa: E402
from zpc_tpu_torch.parallel import mesh as M  # noqa: E402
from zpc_tpu_torch.sim import distributed as S  # noqa: E402
from zpc_tpu_torch.sim import domain_decomp as DD  # noqa: E402
from zpc_tpu_torch.sim.mpm import MPMSim, make_mpm_state  # noqa: E402

CPU = torch.device("cpu")


def _scene(arrays, case):
    st = make_mpm_state(arrays["x"], dx=case["dx"], device=CPU,
                        block_capacity=case["block_capacity"],
                        velocity=arrays["v"] if "v" in arrays else None)
    sim = MPMSim(FixedCorotated.from_young_poisson(1e4, 0.3, device=CPU),
                 torch.tensor([0.0, -9.8, 0.0]))
    return sim, st


def run_mesh(mesh, me, world):
    full = torch.arange(4 * world * 3, dtype=torch.float32).reshape(-1, 3)
    mine = M.shard_leading(mesh, full)
    n_local = me + 1                                   # unequal shares
    return {"gathered": M.global_array(mesh, mine).numpy(),
            "replicated": M.replicated(mesh, full).numpy(),
            "global_index": M.global_array(
                mesh, torch.nn.functional.pad(
                    M.local_to_global_index(mesh, n_local),
                    (0, world - n_local), value=-1)).numpy(),
            "info": np.asarray(M.process_info())}


def run_sharded(mesh, case, arrays):
    sim, st = _scene(arrays, case)
    s = S.shard_state(st, mesh)
    for _ in range(case["steps"]):
        s = S.explicit_step_sharded(sim, s, case["dt"], mesh)
    return {"x": M.global_array(mesh, s.particles["x"]).numpy(),
            "v": M.global_array(mesh, s.particles["v"]).numpy(),
            "table_count": s.grid.table.count.numpy(),
            "mass": s.grid.data["m"].double().sum().numpy()}


def run_dd(mesh, case, arrays):
    sim, st = _scene(arrays, case)
    n = st.particles.size
    dds = DD.make_dd_state(st, mesh)
    layout0 = (M.global_array(mesh, dds.pid).numpy(),
               M.global_array(mesh, dds.alive.to(torch.uint8)).numpy())

    def step(s, nb, mig):
        return DD.explicit_step_dd(sim, s, case["dt"], mesh,
                                   grid_template=st.grid, nb_local=nb,
                                   mig_cap=mig, with_stats=True)

    retry = case.get("retry")
    first, flags, recovered = [], [], 0
    rows = {"fwd_rows": [], "ret_rows": [], "mig_rows": [],
            "wire_fwd": [], "wire_ret": [], "wire_mig": []}
    stats = None
    for _ in range(case["steps"]):
        nxt, ov, stats = step(dds, case["nb_local"], case["mig_cap"])
        first.append(bool(ov))
        if bool(ov) and retry is not None:
            recovered += 1
            nxt, ov, stats = step(dds, retry["nb_local"], retry["mig_cap"])
        flags.append(bool(ov))
        dds = nxt
        for k in ("fwd_rows", "ret_rows", "mig_rows"):
            rows[k].append(stats[k].numpy())
        for k, v in stats["hop_wire_bytes"].items():
            rows[f"wire_{k}"].append(v)
    got = DD.gather_dd_particles(dds, n, mesh)
    out = {"first_overflow": np.asarray(first),
           "overflow": np.asarray(flags), "recovered": np.asarray(recovered),
           "pid0": layout0[0], "alive0": layout0[1],
           "pid1": M.global_array(mesh, dds.pid).numpy(),
           "alive1": M.global_array(mesh,
                                    dds.alive.to(torch.uint8)).numpy(),
           **{k: np.stack(v) for k, v in rows.items()},
           **{f"p_{k}": v for k, v in got.items()}}
    for k in ("fwd_row_bytes", "ret_row_bytes", "mig_row_bytes"):
        out[k] = np.asarray(stats[k])
    return out


def main():
    job, world, me = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    with open(os.path.join(job, "job.json")) as f:
        cases = json.load(f)
    M.initialize_distributed(
        "file://" + os.path.join(job, "rendezvous"), world, me, device=CPU,
        timeout=datetime.timedelta(seconds=120))
    try:
        mesh = M.make_mesh(world)
        for i, case in enumerate(cases):
            path = os.path.join(job, f"in_{i}.npz")
            arrays = dict(np.load(path)) if os.path.exists(path) else {}
            if case["kind"] == "mesh":
                out = run_mesh(mesh, me, world)
            elif case["kind"] == "sharded":
                out = run_sharded(mesh, case, arrays)
            else:
                out = run_dd(mesh, case, arrays)
            if me == 0:
                np.savez(os.path.join(job, f"out_{i}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
