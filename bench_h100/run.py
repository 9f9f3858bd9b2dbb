#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``; its
configuration, traffic mix, driver, limits and metric readers are files under
``bench_h100/`` found by name (``harness/cell.py``). Set-up builds the port
with weights made on the card from the seed and warms up the cell's shapes;
the window then runs back-to-back ``rerank_many`` calls, each over a fresh
batch drawn from the seed, until ``--seconds`` have passed (the call in
flight runs to its end and counts). After the window the program is freed
and the plain reference judges what the program produced. With ``--trace 1``
the window runs under a device-only profiler session and the per-layer
metrics are reported instead of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (queries), ``metrics``, ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each number compared
with its limit (also the last lines of standard error). Before ``checks``,
for a reader of the run: ``calls`` (each call's wall and CPU seconds),
``host`` (torch's threads, garbage collections in the window) and
``numbers`` (every number the comparison read). Without a CUDA card,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded after the window, it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Every cache the program or a library may write stays in the checkout, at a
# fixed path, and no library loads JAX on the port's behalf.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_h100", sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [HERE, ROOT]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 1):
    print(f"bench_h100: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    args = parse_args(argv)
    from harness import cell as cell_mod

    cell = cell_mod.load(args.workload)
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present", 2)
    out = run(cell, args.seed, args.seconds, bool(args.trace))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)


def run(cell, seed: int, seconds: float, trace: bool = False, device: str = "cuda",
        control: str = None) -> dict:
    """One run of ``cell``: set-up, the window, the comparison; the result
    line as a dict. ``control`` names one of the configuration's
    ``controls``, run in the program's place (``readings.py``)."""
    import torch

    from harness import cell as cell_mod
    from harness.guard import forbidden
    from harness.record import Record
    from harness.trace import DeviceTrace

    cuda = device == "cuda"
    spec = cell.conf["controls"][control] if control else None
    drv = cell.driver().Driver(cell, seed, device=device, control=spec)
    drv.build()
    drv.warm_up()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    tracer = DeviceTrace() if trace else None
    before = drv.counters()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if tracer:
        tracer.start()
    gc_before = sum(g["collections"] for g in gc.get_stats())
    drv.recording = True
    calls = []
    deadline = time.perf_counter() + seconds
    while True:
        calls.append(drv.call(len(calls)))
        if time.perf_counter() >= deadline:
            break
    drv.recording = False
    if cuda:
        torch.cuda.synchronize()
    gc_window = sum(g["collections"] for g in gc.get_stats()) - gc_before
    if tracer:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    after = drv.counters()
    counters = {k: after[k] - before.get(k, 0) for k in after}
    counters["window_peak_bytes"] = peak
    found = forbidden()
    if found:
        fail(f"modules loaded that the port may not use: {found}")

    numbers = drv.check()
    # The numbers compared are those the cell's limits name (all of them,
    # with no limit, before the cell has limits).
    checks = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()
              if k in cell.limits or not cell.limits}
    rec = Record(cell.conf, cell.mix, setup_s, calls, counters, drv.work, tracer)
    metrics = {}
    for name in (cell.per_layer if trace else cell.end_to_end):
        value = cell_mod.metric_reader(name, cell.bench)(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": cell.units[name]}
    attempted, failed = rec.total("queries"), rec.total("failed")
    correct = (failed == 0 and bool(checks) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": cell.entry["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev,
           "calls": [{"s": c["end"] - c["start"], "cpu_s": c["cpu_s"],
                      "comparisons": c["comparisons"],
                      "completion_tokens": c["completion_tokens"]} for c in calls],
           "host": {"threads": torch.get_num_threads(), "gc_collections": gc_window}}
    if tracer:
        busy, _ = tracer.busy()
        dev.update(busy_s=busy, window_s=tracer.window_s)
        print(f"trace: {len(tracer.ops)} device operations; seconds to stop the profiler "
              f"{tracer.cost_s['profiler_stop']:.1f}, to read its events "
              f"{tracer.cost_s['read']:.1f}", file=sys.stderr)
        out["breakdown"] = tracer.breakdown(drv.spans)
    out["numbers"] = numbers  # every number the check read, compared or not
    out["checks"] = checks
    found = forbidden()
    if found:
        fail(f"modules loaded that the port may not use: {found}")
    return out


if __name__ == "__main__":
    main()
