"""The benchmark's setwise likelihood cell on a chat decoder
(``qwen3b-kv8.heap-q16``, ``bench_h100/drivers/setwise_likelihood_decoder.py``)
at a size the CPU holds: the configuration cut to four 512-wide layers, the
traffic to three queries of ten passages.

- The planted ranker: on the float32 reference, the label of the passage of
  highest grade leads by about ``label_lead`` logits, whatever the passages'
  order and lengths.
- The benchmark's own run (``run.run``) is correct when sound, and not
  correct with a fault in the program or with the configuration's
  ``int8_weights`` control in its place. The limit at this size, read on
  the CPU: ``label_rel`` 0.0064-0.0070 sound (seeds 2**31 + 11, 7, 9), 0.049
  under ``int8_weights`` at this test's seed (0.0066 at seed 7: at this
  width few sites take int8); 0.02 lies between.
"""
import copy
import os
import random
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "bench_h100"))

import run  # noqa: E402
from drivers import setwise_likelihood_decoder as sld  # noqa: E402
from harness import cell, guard, weights  # noqa: E402
from reference import qwen2  # noqa: E402

from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmrankers_tpu_torch.models import decoder as dec  # noqa: E402
from llmrankers_tpu_torch.rankers.prompts import setwise_prompt  # noqa: E402

CELL = "qwen3b-kv8.heap-q16"
SIZE = dict(hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=512, num_hidden_layers=4, vocab_size=512, eos_token_id=511)
SEED = 2**31 + 11


def tiny():
    c = cell.load(CELL)
    c.conf = copy.deepcopy(c.conf)
    c.conf.update(SIZE)
    c.limits = {"label_rel": 0.02, "winner_flips": 0}
    c.mix = dict(c.mix, queries_per_call=3, docs_per_query=10)
    return c


def test_planted_ranker_picks_the_best_grade():
    c = tiny()
    w = weights.make(qwen2.param_specs(c.conf), 11, "cpu", torch.float32)
    sld.plant_relevance(w, c.conf, c.mix, 11)
    get, tok = weights.getter(w), ByteTokenizer(512)
    marks, lead = c.mix["relevance"]["markers"], c.mix["planted"]["label_lead"]
    labels = [tok.encode(f"Passage {x}", add_special_tokens=False)[-1] for x in "ABC"]
    rng = random.Random(0)
    for _ in range(4):
        grades = rng.sample(range(len(marks)), 3)
        docs = [marks[g] + "".join(rng.choice("abcdefgh ") for _ in range(rng.randrange(30, 120)))
                for g in grades]
        text = tok.apply_chat_template(
            [{"role": "user", "content": setwise_prompt("q1x0 some words", docs)}]) + " Passage:"
        ids = tok.encode(text, add_special_tokens=True)
        logits = qwen2.served_logits(get, c.conf, ids, len(ids))[0, labels]
        top = logits.topk(2)
        assert int(top.indices[0]) == grades.index(max(grades))
        assert float(top.values[0] - top.values[1]) > 0.8 * lead


def _labels_swapped(monkeypatch):
    inner = dec.Decoder.label_logits

    def swapped(self, hidden, label_ids):
        out = inner(self, hidden, label_ids).clone()
        out[:, [0, 1]] = out[:, [1, 0]]
        return out

    monkeypatch.setattr(dec.Decoder, "label_logits", swapped)


def _half_hidden(monkeypatch):
    inner = dec.Decoder.label_logits

    def half(self, hidden, label_ids):
        hidden = hidden.clone()
        hidden[1::2] = hidden[0::2].mean(0)  # every other row left out
        return inner(self, hidden, label_ids)

    monkeypatch.setattr(dec.Decoder, "label_logits", half)


@pytest.mark.parametrize("fault,control", [(None, None), (_labels_swapped, None),
                                           (_half_hidden, None), (None, "int8_weights")])
def test_run_is_correct_only_when_sound(monkeypatch, fault, control):
    # This test process has JAX loaded (tests/conftest.py), which a run's
    # guard refuses; the guard is the benchmark's, not what is tested here.
    monkeypatch.setattr(guard, "forbidden", lambda names=None: [])
    if fault is not None:
        fault(monkeypatch)
    out = run.run(tiny(), SEED, 0.0, device="cpu", control=control)
    sound = fault is None and control is None
    assert out["correct"] == sound, out["checks"]
    assert out["attempted"] == 3 and out["failed"] == 0
    assert out["numbers"]["decided_share"] > 0.5


def test_shared_work_counts_each_head_once():
    """The metrics' work: every distinct prompt head (prefix) once, a
    position at depth d attending to d + 1 keys, against counting the set of
    prefixes directly."""
    rng = random.Random(3)
    heads = [[rng.randrange(5) for _ in range(rng.randrange(1, 9))] for _ in range(3)]
    calls = [{"tokens": [rng.choice(heads) + [rng.randrange(5) for _ in range(rng.randrange(6))]
                         for _ in range(7)]} for _ in range(3)]
    calls[1]["tokens"].append(list(calls[0]["tokens"][0]))  # a row sent again
    prefixes = {tuple(r[:i]) for w in calls for r in w["tokens"] for i in range(1, len(r) + 1)}
    assert sld.shared_work(calls) == (len(prefixes), sum(len(p) for p in prefixes))
