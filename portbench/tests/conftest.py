"""Shared pieces of the benchmark's own tests: each cell of
``BENCHMARK.json`` loaded by name and cut to a size the CPU holds (4,096
particles at dx = 1/32, 64 bins), with shorter segments; the physics,
the traffic's shape and the limits are the cell's."""

import copy
import dataclasses
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness.spec import load_cell  # noqa: E402

def cell_names():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def tiny(name: str, segment_steps=None):
    """The cell at 4,096 particles and dx = 1/32.  A CFL time step is then
    four times the full size's, so the snapshot and the segment take a
    quarter of the steps and cover the same simulated time (the impact
    mix still meets the ground inside its segment); a stated time step
    keeps it, and the segment is cut to 4 steps.  An obstacle's candidate
    lists grow to what a bin's window (side 7 dx + 2 dhat) can meet of
    the terrain: (side / cell + 2)^2 cells of two triangles.
    ``segment_steps`` overrides the segment's length."""
    cell = load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(particles=4096, dx=1.0 / 32, state_block_capacity=256,
               bins={"bins_capacity": 64, "block_capacity": 256})
    if "obstacle" in cfg:
        ob = cfg["obstacle"]
        side = 7 * cfg["dx"] + 2 * ob["dhat"]
        ob["max_tris"] = 2 * (int(side * ob["res"] / (ob["hi"] - ob["lo"]))
                              + 2) ** 2
    tr = copy.deepcopy(cell.traffic)
    if "cfl" in cfg["dt"]:
        for k in ("snapshot_steps", "segment_steps", "trace_from_step",
                  "trace_steps"):
            tr[k] //= 4
    else:
        tr["segment_steps"] = min(tr["segment_steps"], 4)
    if segment_steps is not None:
        tr["segment_steps"] = segment_steps
    tr["warmup_steps"] = min(tr["warmup_steps"], 1)
    return dataclasses.replace(cell, config=cfg, traffic=tr)


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda", 0)
