"""Nothing the benchmark runs loads JAX or the JAX package (top-level module
names compared whole), and the reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

from harness.guard import FORBIDDEN, forbidden

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
PORT = "llmrankers_tpu_torch"


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_guard_compares_whole_top_level_names():
    assert forbidden(["llmrankers_tpu_torch.models.t5", "torch", "jaxtyping"]) == []
    assert forbidden(["llmrankers_tpu.ops", "jax.numpy", "flax"]) == [
        "flax", "jax", "llmrankers_tpu"]


def test_no_source_imports_jax():
    for path in _sources():
        bad = {m.split(".")[0] for m in _imported(path)} & FORBIDDEN
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        tops = {m.split(".")[0] for m in _imported(path)}
        assert PORT not in tops and not tops & FORBIDDEN, (path, tops)


def test_importing_every_module_loads_no_jax():
    metrics = sorted(f[:-3] for f in os.listdir(os.path.join(BENCH, "metrics"))
                     if f.endswith(".py"))
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
        "import run\n"
        "from harness import cell, driver, port, record, trace, traffic, weights, yardstick\n"
        "from drivers import setwise_likelihood, rankr1_generation\n"
        "from reference import quant, t5, qwen2\n"
        f"for m in {metrics!r}: cell.metric_reader(m)\n"
        "from harness.guard import forbidden\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n"
        "sys.exit(3 if forbidden() else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert PORT in res.stdout
