"""The benchmark's own tests (run with ``python -m pytest bench_h100/tests``
from the root of a checkout). Tests marked ``card`` need a CUDA card; each
decides inside the test whether one is there, and skips here without."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
