"""The port stands without JAX; its host pieces match the JAX package's.

A subprocess imports every module of ``llmrankers_tpu_torch`` (the CLI
included) and must find no ``jax`` in ``sys.modules``. ``chip_smoke.py``
must fail, printing no result, where there is no GPU and where it stands
alone; so must ``chip_profile.py`` where there is no GPU. The byte tokenizer and the setwise prompt must equal the JAX
package's.
"""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from llmrankers_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmrankers_tpu.rankers import prompts as jprompts
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.rankers import prompts as tprompts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "llmrankers_tpu_torch", "llmrankers_tpu_torch.ops._build",
    "llmrankers_tpu_torch.ops.attention", "llmrankers_tpu_torch.ops.flash",
    "llmrankers_tpu_torch.ops.int8_matmul", "llmrankers_tpu_torch.models.quant",
    "llmrankers_tpu_torch.models.t5", "llmrankers_tpu_torch.engine.engine",
    "llmrankers_tpu_torch.engine.parity",
    "llmrankers_tpu_torch.engine.tokenizer", "llmrankers_tpu_torch.rankers.base",
    "llmrankers_tpu_torch.rankers.prompts", "llmrankers_tpu_torch.rankers.setwise",
    "llmrankers_tpu_torch.cli.run",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


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
