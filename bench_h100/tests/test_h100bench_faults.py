"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have, and a sound run of the same size comes out
correct; each of the configuration's controls (a next precision down)
fails the cell's limits too. At the size of ``tiny_cells``, on the CPU: the run is
the benchmark's own (``run.run``) but for the look for a card."""
import pytest
import torch

import run
from llmrankers_tpu_torch.engine import generate as gen
from llmrankers_tpu_torch.models import t5 as port_t5
from tiny_cells import tiny

T5_CELL, GEN_CELL = "t5xl-w8a8.heap-q16", "qwen3b-kv8.r1-gen-q48"
SEED = 2**31 + 11


def _run(workload, **kw):
    return run.run(tiny(workload), SEED, 0.0, device="cpu", **kw)


def _answer_altered(monkeypatch):
    inner = port_t5.T5.label_logits

    def altered(self, hidden, label_ids):
        out = inner(self, hidden, label_ids).clone()
        out[:, [0, 1]] = out[:, [1, 0]]  # the first two labels' logits swapped
        return out

    monkeypatch.setattr(port_t5.T5, "label_logits", altered)


def _half_batch(monkeypatch):
    inner = port_t5.T5.encode

    def half(self, ids, mask):
        out = inner(self, ids, mask).clone()
        real = int((mask.sum(1) > 0).sum())
        keep = max(1, real // 2)
        out[keep:real] = out[:keep].mean(0)  # the rest of the rows left out
        return out

    monkeypatch.setattr(port_t5.T5, "encode", half)


def _token_altered(monkeypatch):
    monkeypatch.setattr(gen, "_pick", lambda logits, t, k: torch.argmin(logits, dim=-1))


def _state_unchanged(monkeypatch):
    inner = gen._cache_put

    def put(c, x, start, layer=None):
        if x.shape[-2] != 1:  # a decode step's write is lost
            inner(c, x, start, layer)

    monkeypatch.setattr(gen, "_cache_put", put)


def _half_rows(monkeypatch):
    inner = gen._decode_token_forward

    def half(model, tok, *args):
        logits, k, v = inner(model, tok, *args)
        logits = logits.clone()
        logits[1::2] = logits[0::2].mean(0)  # every other row left out
        return logits, k, v

    monkeypatch.setattr(gen, "_decode_token_forward", half)


@pytest.mark.parametrize("workload", [T5_CELL, GEN_CELL])
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload,fault", [
    (T5_CELL, _answer_altered), (T5_CELL, _half_batch),
    (GEN_CELL, _token_altered), (GEN_CELL, _state_unchanged), (GEN_CELL, _half_rows)])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload,control", [
    (T5_CELL, "int4_weights"), (GEN_CELL, "int8_weights"), (GEN_CELL, "int4_kv")])
def test_control_fails_the_limits(workload, control):
    out = _run(workload, control=control)
    assert not out["correct"], out["checks"]
