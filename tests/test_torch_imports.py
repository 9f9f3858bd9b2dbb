"""The port stands without JAX and without the JAX package; its copies of
the JAX package's host modules match their originals.

A subprocess imports every module of ``llmrankers_tpu_torch`` (the CLI
included) and must find neither ``jax`` nor ``llmrankers_tpu`` in
``sys.modules``; an ``ast`` scan finds no import of ``llmrankers_tpu`` in the
port's files, ``chip_smoke.py`` or ``chip_profile.py``. The copied host
modules equal their originals byte for byte (their imports are relative), and
what they compute agrees: config presets, ``parse_args``, prefix grouping.
``chip_smoke.py`` must fail, printing no result, where there is no GPU and
where it stands alone; so must ``chip_profile.py`` where there is no GPU. The
byte tokenizer and the setwise prompt must equal the JAX package's, and the
port's copies of the Rank-R1 prompt packs their originals byte for byte.
"""
import argparse
import ast
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from llmrankers_tpu.cli import run as jrun
from llmrankers_tpu.engine import prefix as jprefix
from llmrankers_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmrankers_tpu.models import config as jconfig
from llmrankers_tpu.rankers import prompts as jprompts
from llmrankers_tpu_torch.cli import run as trun
from llmrankers_tpu_torch.engine import prefix as tprefix
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import config as tconfig
from llmrankers_tpu_torch.rankers import prompts as tprompts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "llmrankers_tpu_torch")
PORT_MODULES = [
    "llmrankers_tpu_torch", "llmrankers_tpu_torch.types",
    "llmrankers_tpu_torch.algos.scheduler", "llmrankers_tpu_torch.algos.setwise_sort",
    "llmrankers_tpu_torch.data.docstore", "llmrankers_tpu_torch.data.trec",
    "llmrankers_tpu_torch.utils.metering", "llmrankers_tpu_torch.utils.native",
    "llmrankers_tpu_torch.utils.device", "llmrankers_tpu_torch.utils.profiling",
    "llmrankers_tpu_torch.ops._build",
    "llmrankers_tpu_torch.ops.attention", "llmrankers_tpu_torch.ops.flash",
    "llmrankers_tpu_torch.ops.int8_matmul", "llmrankers_tpu_torch.ops.int4_matmul",
    "llmrankers_tpu_torch.ops.kvq_attention",
    "llmrankers_tpu_torch.models.config",
    "llmrankers_tpu_torch.models.decoder", "llmrankers_tpu_torch.models.moe",
    "llmrankers_tpu_torch.models.quant",
    "llmrankers_tpu_torch.models.t5", "llmrankers_tpu_torch.engine.engine",
    "llmrankers_tpu_torch.engine.generate", "llmrankers_tpu_torch.engine.parity",
    "llmrankers_tpu_torch.engine.prefix",
    "llmrankers_tpu_torch.engine.tokenizer", "llmrankers_tpu_torch.rankers.base",
    "llmrankers_tpu_torch.rankers.prompts", "llmrankers_tpu_torch.rankers.setwise",
    "llmrankers_tpu_torch.rankers.rank_r1",
    "llmrankers_tpu_torch.cli.run",
]
# The JAX package's prompt packs, copied into the port under the same path.
PROMPT_PACKS = sorted(n for n in os.listdir(os.path.join(ROOT, "llmrankers_tpu", "prompts"))
                      if n.endswith(".toml"))
# The JAX package's host modules, copied into the port under the same path.
COPIES = ["types.py", "algos/scheduler.py", "algos/setwise_sort.py",
          "data/docstore.py", "data/trec.py", "engine/prefix.py",
          "models/config.py", "utils/metering.py", "utils/native.py"]
# Copies the port extends: the original, then the port's own section, which
# begins with this line.
EXTENDED = {"utils/metering.py": "# Host spans (the port's own; everything above is the JAX "
                                 "package's module)\n",
            "models/config.py": "# Layer types, per-type RoPE and routed experts (the port's "
                                "own; everything\n"}


def _port_files():
    for d, _, names in os.walk(PKG):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(d, name)


def test_port_modules_lists_every_module():
    files = {os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
             for p in _port_files() if not p.endswith("__init__.py")}
    assert files <= set(PORT_MODULES)


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'llmrankers_tpu' or m.startswith('llmrankers_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", ["chip_smoke.py", "chip_profile.py", "chip_flash_ab.py",
                                  "chip_kvq_trace.py", "llmrankers_tpu_torch"])
def test_no_import_of_the_jax_package(path):
    full = os.path.join(ROOT, path)
    files = [full] if path.endswith(".py") else list(_port_files())
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imports(f)
           if m == "llmrankers_tpu" or m.startswith("llmrankers_tpu.")
           or m == "jax" or m.startswith("jax.")]
    assert not bad


@pytest.mark.parametrize("rel", COPIES)
def test_copies_equal_their_originals(rel):
    """Verbatim copies (their imports are relative, so unchanged): a fix in
    the reference must be carried into the port. An extended copy holds the
    original verbatim up to the port's section, which follows its last line
    after a comment rule."""
    with open(os.path.join(ROOT, "llmrankers_tpu", rel)) as a, \
            open(os.path.join(PKG, rel)) as b:
        original, port = a.read(), b.read()
    if rel in EXTENDED:
        head, sep, _ = port.partition("\n\n\n# " + "-" * 75 + "\n" + EXTENDED[rel])
        assert sep, "the port's section is missing"
        port = head + "\n"
    assert port == original


@pytest.mark.parametrize("name", PROMPT_PACKS)
def test_prompt_packs_equal_their_originals(name):
    """The Rank-R1 packs are model artifacts: the port's copies match the
    JAX package's byte for byte."""
    with open(os.path.join(ROOT, "llmrankers_tpu", "prompts", name), "rb") as a, \
            open(os.path.join(PKG, "prompts", name), "rb") as b:
        assert a.read() == b.read()


def test_package_data_covers_the_port_files():
    """Every kernel source and header and every prompt pack ships with the
    package (the shared header ``csrc/int8_quantize.cuh`` was once left out,
    so an installed port could not build its int8 kernels)."""
    import fnmatch
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["llmrankers_tpu_torch"]
    for sub in ("csrc", "prompts"):
        for name in os.listdir(os.path.join(PKG, sub)):
            assert any(fnmatch.fnmatch(f"{sub}/{name}", g) for g in globs), name


PRESETS = [("T5Config", "tiny"), ("T5Config", "flan_t5_large"),
           ("T5Config", "flan_t5_xl"), ("DecoderConfig", "tiny"),
           ("DecoderConfig", "qwen25_3b")]


@pytest.mark.parametrize("cls,preset", PRESETS)
def test_config_presets_match_jax(cls, preset):
    got = getattr(getattr(tconfig, cls), preset)()
    want = getattr(getattr(jconfig, cls), preset)()
    # The port's DecoderConfig adds fields (layer types, per-type RoPE,
    # experts): the JAX fields match, and the added ones keep their defaults.
    got_d, want_d = dataclasses.asdict(got), dataclasses.asdict(want)
    assert {k: got_d[k] for k in want_d} == want_d
    defaults = {f.name: f.default for f in dataclasses.fields(got)}
    assert {k: v for k, v in got_d.items() if k not in want_d} == {
        k: v for k, v in defaults.items() if k not in want_d}
    assert type(got) is getattr(tconfig, cls)


ARGVS = [
    ["run", "--model_name_or_path", "random:dec-tiny", "--prefix_cache_mb", "0",
     "--len_buckets", "640,128", "setwise", "--k", "3", "--num_child", "2"],
    ["run", "--run_path", "r.txt", "--scoring", "likelihood", "--max_batch_tokens",
     "4096", "--len_buckets", "auto:4", "pairwise", "--method", "heapsort"],
    ["run", "--quantize", "int8", "--dtype", "float32", "listwise", "--window_size", "5"],
    ["pointwise", "--method", "qlm"],
    ["run", "--model_name_or_path", "random:dec-tiny", "--kv_quantize", "int4",
     "--prompt_file", "p.toml", "--spec_lookup", "4", "setwise", "--num_child", "19",
     "--max_completion_tokens", "128", "--prompt_file", "q.toml"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_matches_jax(argv):
    def tree(ns):
        return {k: tree(v) if isinstance(v, argparse.Namespace) else v
                for k, v in vars(ns).items()}

    assert tree(trun.parse_args(argv)) == tree(jrun.parse_args(argv))


@pytest.mark.parametrize("seed", range(3))
def test_group_shared_prefixes_copy_matches_jax(seed):
    rng = np.random.RandomState(100 + seed)
    heads = [list(rng.randint(2, 6, size=rng.randint(20, 60))) for _ in range(3)]
    rows = [heads[rng.randint(3)] + list(rng.randint(2, 6, size=rng.randint(1, 9)))
            for _ in range(rng.randint(2, 25))]
    assert tprefix.group_shared_prefixes(rows) == jprefix.group_shared_prefixes(rows)


def _no_result(res):
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    _no_result(res)
    assert "needs a CUDA GPU" in res.stderr


def test_chip_profile_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, "chip_profile.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "needs a CUDA GPU" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    path = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
            if p and os.path.abspath(p) != ROOT]  # the repo must not be importable
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(path)})
    _no_result(res)


@pytest.mark.parametrize("text", [
    "<pad> Passage A", "<pad><pad>x", "plain ascii", "ünïcödé ✓", "",
])
def test_byte_tokenizer_matches_jax(text):
    t, j = ByteTokenizer(512), JaxByteTokenizer(512)
    for special in (True, False):
        assert t.encode(text, special) == j.encode(text, special)
    ids = j.encode(text)
    for skip in (True, False):
        assert t.decode(ids, skip) == j.decode(ids, skip)
    assert t.truncate(text, 5) == j.truncate(text, 5)


def test_setwise_prompt_matches_jax():
    assert tprompts.CHARACTERS == jprompts.CHARACTERS
    docs = ["first doc", 'second "quoted" doc', "third"]
    assert tprompts.setwise_prompt("q?", docs) == jprompts.setwise_prompt("q?", docs)
    assert (tprompts.setwise_prompt("q?", docs, ["C", "A", "B"])
            == jprompts.setwise_prompt("q?", docs, ["C", "A", "B"]))
