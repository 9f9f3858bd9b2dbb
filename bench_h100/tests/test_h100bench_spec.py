"""``BENCHMARK.json`` keeps to the benchmark's contract, every cell resolves
to its files by name, and a new cell needs only new files and entries."""
import json
import os
import re
import shutil

import pytest

from harness import cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_names_and_units():
    names = [m["name"] for m in _metrics()] + [w["name"] for w in SPEC["workloads"]] + [
        c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]] + [
            k for c in SPEC["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in _metrics():
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in SPEC["workloads"]] + [c["why"] for c in SPEC["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_run_length():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, cells // 4)


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e, m
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"], (m["name"], w)
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all("\n" not in layer for layer in layers)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(workload):
    c = cell.load(workload)
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer
    assert c.driver().Driver and c.reference().param_specs
    assert c.limits, "limits/<cell>.json holds the comparison's limits"
    for name in c.end_to_end + c.per_layer:
        assert callable(cell.metric_reader(name))
    conf = next(x for x in SPEC["configs"] if x["name"] == c.entry["config"])
    assert conf["file"].startswith("bench_h100/configs/") and conf["reduced"] == c.conf["reduced"]


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench_h100")
    spec = json.loads(json.dumps(SPEC))
    mix = json.load(open(root / "bench_h100" / "traffic" / "heap-q16.json"))
    mix["queries_per_call"] = 1
    json.dump(mix, open(root / "bench_h100" / "traffic" / "heap-q1.json", "w"))
    spec["workloads"].append({"name": "t5xl-w8a8.heap-q1", "config": "flan-t5-xl.w8a8",
                              "traffic": "heap-q1", "chips": 1, "why": "one query a call"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "t5xl-w8a8.heap-q16" in m.get("workloads", []):
            m["workloads"].append("t5xl-w8a8.heap-q1")
    json.dump(spec, open(root / "BENCHMARK.json", "w"))
    c = cell.load("t5xl-w8a8.heap-q1", root=str(root))
    assert c.mix["queries_per_call"] == 1 and c.conf["d_model"] == 2048
    assert c.driver().__name__ == "drivers.setwise_likelihood"
    assert "docs_per_s" in c.end_to_end and "score.mfu" in c.per_layer
    assert cell.metric_reader("score.mfu", c.bench)
    # The existing files are untouched.
    for sub in ("configs", "traffic", "drivers", "harness", "metrics", "reference"):
        for f in os.listdir(os.path.join(BENCH, sub)):
            if f.endswith((".py", ".json", ".toml")):
                assert open(os.path.join(BENCH, sub, f), "rb").read() == open(
                    root / "bench_h100" / sub / f, "rb").read()
