"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json`` (the limits of the
comparison that decides ``correct``) and, for each per-layer metric,
``metrics/<metric>.py``.  Every cell reports every end-to-end metric;
a per-layer metric lists the cells that report it under ``workloads``.
A configuration names its plain reference under
``"reference"``: ``reference/<name>.py``.  Adding a cell, a mix or a
metric adds files here and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parent.parent       # portbench/
ROOT = BENCH.parent                                  # the checkout

__all__ = ["BENCH", "ROOT", "Cell", "load_cell", "load_module"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]          # the per-layer metrics it reports
    readers: Dict[str, object]     # per-layer metric name -> module


def load_module(path: Path):
    """Import one file of the benchmark by path."""
    name = "portbench_" + "_".join(path.relative_to(BENCH).with_suffix(
        "").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Cell:
    spec = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = _json(ROOT / cfg_entry["file"])
    traffic = _json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = _json(BENCH / "limits" / f"{name}.json")
    e2e = spec["end_to_end"]
    per_layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    readers = {m["name"]: load_module(BENCH / "metrics" / f"{m['name']}.py")
               for m in per_layer}
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer, readers)
