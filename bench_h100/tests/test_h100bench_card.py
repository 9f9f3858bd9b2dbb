"""One short run of each cell on the card, through the command the driver
runs, and the keys of its last line. Skips without a CUDA card (run on the
card: ``python3 -m pytest bench_h100/tests -m card``)."""
import json
import os
import subprocess
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_prints_the_result_line(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = [sys.executable, *SPEC["command"][1:], "--workload", workload,
           "--seed", str(2**31 + 101), "--seconds", "1", "--trace", str(trace)]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    spec = {m["name"]: m for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for name, m in out["metrics"].items():
        assert m["unit"] == spec[name]["unit"]
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in out["metrics"]
    assert res.stderr.strip().splitlines()[-1].startswith("check ")


def test_no_card_no_result():
    """Without a card (or with fewer than the cell asks for) the command
    exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cmd = [sys.executable, *SPEC["command"][1:], "--workload", SPEC["workloads"][0]["name"],
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.card
def test_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files (no program) the command exits non-zero and prints no result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in SPEC["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cmd = [sys.executable, *SPEC["command"][1:], "--workload", SPEC["workloads"][0]["name"],
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    res = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
