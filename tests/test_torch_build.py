"""The port's kernel build (``llmrankers_tpu_torch/ops/_build.py``) on a
machine without nvcc or a GPU: a failed build raises with the compiler's
output, and the build key follows the sources and flags."""
import os
import stat

import pytest

from llmrankers_tpu_torch.ops import _build


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded in this process."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build, "_loaded", {})
    return tmp_path


def test_missing_nvcc_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_blhd")


def test_failed_build_raises_with_compiler_output(fresh_build, monkeypatch):
    fake = fresh_build / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match=r"(?s)exit 3.*no sm_90a here"):
        _build.load("flash_blhd")
    assert not any(n.endswith(".so") for n in os.listdir(_build.BUILD_DIR))


def test_build_key_follows_sources_and_flags(monkeypatch):
    key = _build._digest()
    assert key == _build._digest()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._digest() != key
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert os.path.exists(os.path.join(_build.CSRC_DIR, "flash_blhd.cu"))


def test_int8_source_has_its_entry_points():
    """The W8A8 kernels are one hand-written source with two C entry points
    on int8 tensor-core tiles."""
    with open(os.path.join(_build.CSRC_DIR, "int8_fusedq.cu")) as f:
        src = f.read()
    for entry in ("quantized_matmul_bf16", "gated_matmul_bf16"):
        assert f'extern "C" int {entry}(' in src
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    assert "cublas" not in src.lower()


def test_load_all_builds_each_source_and_raises(fresh_build, monkeypatch):
    """load_all starts one nvcc per source and raises a failed build."""
    log = fresh_build / "calls"
    fake = fresh_build / "nvcc"
    fake.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\necho 'error: no GPU' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no GPU"):
        _build.load_all(["flash_blhd", "int8_fusedq"])
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    assert {c.split()[-1].rsplit("/", 1)[1] for c in calls} == {
        "flash_blhd.cu", "int8_fusedq.cu"}


def test_flash_source_serves_the_three_layouts():
    """One hand-written flash source serves B1, B2 and B5: one C entry with
    batch, head and row strides per tensor, a GQA group and a window."""
    with open(os.path.join(_build.CSRC_DIR, "flash_blhd.cu")) as f:
        src = f.read()
    assert 'extern "C" int flash_attn_bf16(' in src
    for field in ("q_hs", "k_hs", "v_hs", "o_hs", "int group;", "int window;"):
        assert field in src
    assert "h / p.group" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "cublas" not in src.lower() and "cudnn" not in src.lower()
