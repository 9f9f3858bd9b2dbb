"""A cell of ``BENCHMARK.json``, resolved by name to the files that hold it:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``driver``
names ``drivers/<driver>.py``), ``limits/<cell>.json`` (the limits of the
comparison that decides ``correct``), the reference module the
configuration names under ``reference/``, and ``metrics/<metric>.py`` for
every metric the cell reports. Adding a cell, a configuration, a traffic
mix or a metric adds files and entries; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str, bench: str = BENCH):
    """``read(record)`` of ``metrics/<name>.py``."""
    path = os.path.join(bench, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Cell:
    name: str
    entry: Dict
    conf: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[str] = field(default_factory=list)
    per_layer: List[str] = field(default_factory=list)
    units: Dict[str, str] = field(default_factory=dict)
    bench: str = BENCH

    @property
    def mix_dir(self) -> str:
        return os.path.join(self.bench, "traffic")

    def driver(self):
        return importlib.import_module("drivers." + self.mix["driver"])

    def reference(self):
        return importlib.import_module("reference." + self.conf["reference"])


def load(workload: str, root: str = ROOT, bench: Optional[str] = None) -> Cell:
    """The cell named ``workload`` in ``<root>/BENCHMARK.json``."""
    bench = bench or os.path.join(root, "bench_h100")
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    limits_path = os.path.join(bench, "limits", workload + ".json")
    return Cell(
        name=workload, entry=entry,
        conf=_json(os.path.join(bench, "configs", entry["config"] + ".json")),
        mix=_json(os.path.join(bench, "traffic", entry["traffic"] + ".json")),
        limits=_json(limits_path)["limits"] if os.path.exists(limits_path) else {},
        end_to_end=[m["name"] for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m["name"] for m in spec["per_layer"] if _reports(m, workload)],
        units={m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]},
        bench=bench,
    )
