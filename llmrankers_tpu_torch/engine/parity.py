"""Decision parity of the int8 path: label winners of W8A8 against the
model's own dtype.

Counterpart of ``bench.py::t5_int8_decision_parity``, with the same battery:
64 setwise prompts over three passages of 25 random words ``w000``-``w999``
and a 4-word query, drawn from ``RandomState(929)``, byte-tokenized, scored
on the length ladder (512, 640, 1024) by one engine in the model's dtype and
one with ``quantize="int8"``, both from the same weights.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..rankers import prompts
from .engine import ScoringEngine
from .tokenizer import ByteTokenizer


def battery_rows(tok, n_prompts: int = 64):
    """The battery's token rows, in ``bench.py``'s draw order."""
    rng = np.random.RandomState(929)
    words = ["w%03d" % i for i in range(1000)]
    rows = []
    for _ in range(n_prompts):
        docs = [" ".join(rng.choice(words, 25)) for _ in range(3)]
        text = prompts.setwise_prompt(" ".join(rng.choice(words, 4)), docs)
        rows.append(tok.encode(text))
    return rows


def t5_int8_decision_parity(model, n_prompts: int = 64,
                            len_buckets: Sequence[int] = (512, 640, 1024)
                            ) -> Dict[str, float]:
    """Label-winner agreement between ``model`` (a float ``T5``) and its
    int8 quantization, overall and on the rows whose float margin between
    the best and second label logit is above the median."""
    cfg = model.cfg
    tok = ByteTokenizer(cfg.vocab_size)
    rows = battery_rows(tok, n_prompts)
    prefix = tok.encode("<pad> Passage", add_special_tokens=False)
    labels = [tok.encode(f"<pad> Passage {c}", add_special_tokens=False)[-1]
              for c in ("A", "B", "C")]
    logits = {}
    for mode in (None, "int8"):
        eng = ScoringEngine("t5", cfg, model, tok, quantize=mode,
                            len_buckets=len_buckets)
        logits[mode] = eng.score_labels(rows, labels, prefix)
        del eng
    part = np.partition(logits[None], -2, axis=-1)
    margins = part[:, -1] - part[:, -2]
    agree = logits[None].argmax(-1) == logits["int8"].argmax(-1)
    clear = margins > np.median(margins)
    return {
        "prompts": n_prompts,
        "winner_agreement": float(agree.mean()),
        "winner_agreement_clear_margin": float(agree[clear].mean()),
    }
