#!/usr/bin/env python3
"""Read the numbers that decide a cell's ``correct`` over many seeds, for
the program and for each of its controls, on the card: what the cell's
limits in ``limits/<cell>.json`` are set from. Not part of a benchmark run.

    python3 bench_h100/readings.py --workload <cell> --seeds 12 --first 1000 [--control NAME]

For each seed it makes the benchmark's own run (``run.run``) with a window
of one call, the cell's own load with its longest requests, and prints the
numbers compared and the call's time as one JSON line. ``--control`` names
one of the configuration's ``controls``, run in the program's place.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import run  # noqa: E402  (sets the environment the program runs in)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=1000, help="the first seed")
    p.add_argument("--control", default=None)
    args = p.parse_args()
    from harness import cell as cell_mod

    cell = cell_mod.load(args.workload)
    for seed in range(args.first, args.first + args.seeds):
        out = run.run(cell, seed, 0.0, control=args.control)
        print(json.dumps({"seed": seed, "control": args.control, "correct": out["correct"],
                          "numbers": out["numbers"], "calls": out["calls"]}), flush=True)


if __name__ == "__main__":
    main()
