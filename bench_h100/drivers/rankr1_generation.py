"""Rank-R1 setwise reranking by greedy generation
(``RankR1SetwiseLlmRanker`` with the traffic's prompt pack): each
comparison is one prompt row that decodes up to the completion budget, and
each wave is one ``engine.generate`` call.

Kept from the window, per ``generate`` call: its prompt rows and the tokens
the program served each row, read from the tokenizer the engine decodes
them with. After the window the reference runs a sample of rows drawn from
the seed, with the row of most prompt and served tokens among them, as one
forward over the prompt and its served tokens. At each served token's
position the gap is how far its logit lies below the reference's best
there, and the comparison reads:

- ``token_gap``: the widest gap;
- ``gap_mean``: the mean gap over all the sampled rows' served tokens;
- ``flip_share``: the share of those tokens whose gap is above 0 (the
  reference would have served another);
- ``distinct_tokens``: how many different tokens those rows were served
  (a random model that repeats a few tokens makes every gap 0).

The cell's limits name the numbers compared (``token_gap``); the others are
read for the limits' readings.
"""
from __future__ import annotations

import os
import random
from typing import Dict, List

import torch

from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.rankers.rank_r1 import RankR1SetwiseLlmRanker

from harness import driver, weights

SAMPLE_ROWS = 7  # besides the longest, drawn from the first call's rows


class ServedTokenizer(ByteTokenizer):
    """The byte tokenizer, keeping the ids of every ``decode`` while
    ``served`` is a list: the engine decodes each row's served tokens once,
    in row order."""

    served = None

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        if self.served is not None:
            self.served.append([int(i) for i in ids])
        return super().decode(ids, skip_special_tokens)


class Driver(driver.Driver):
    def tokenizer(self):
        from llmrankers_tpu_torch.models.config import DecoderConfig

        self.tok = ServedTokenizer(DecoderConfig.from_hf_config(self.cell.conf).vocab_size)
        return self.tok

    def make_ranker(self):
        mix = self.cell.mix
        return RankR1SetwiseLlmRanker(
            self.engine, prompt_file=os.path.join(self.cell.mix_dir, mix["prompt_file"]),
            **mix["ranker"])

    def instrument(self) -> None:
        eng = self.engine
        inner = eng.generate

        def generate(rows, max_new_tokens, *args, **kw):
            if not self.recording:
                return inner(rows, max_new_tokens, *args, **kw)
            self.tok.served = []
            with self.spans.span("engine.generate"):
                texts, ntoks = inner(rows, max_new_tokens, *args, **kw)
            # The engine decodes each row's served tokens last, in row order.
            served, self.tok.served = self.tok.served[-len(rows):], None
            if len(served) != len(rows) or any(
                    len(s) != n for s, n in zip(served, ntoks)):
                raise RuntimeError("the served tokens read from the tokenizer do not "
                                   "match the engine's counts")
            self.work.append({"op": "generate", "rows": [list(r) for r in rows],
                              "served": served, "budget": max_new_tokens})
            return texts, ntoks

        eng.generate = generate

    def warm_up(self) -> None:
        """A call of the mix's own shapes (from the warm-up stream) with a
        budget of two tokens: every prefill shape, the prefix-KV cache
        filled with the prompt pack's shared head as the window finds it,
        and decode steps on the cache."""
        budget = self.ranker.max_completion_tokens
        self.ranker.max_completion_tokens = 2
        try:
            self.call(0, stream=driver.WARM_STREAM)
        finally:
            self.ranker.max_completion_tokens = budget
        if self.device == "cuda":
            torch.cuda.synchronize()

    # -- the comparison -----------------------------------------------------
    def sample(self) -> List[tuple]:
        rows = [(r, s) for w in self.work for r, s in zip(w["rows"], w["served"])]
        if not rows:
            return []
        longest = max(range(len(rows)), key=lambda i: len(rows[i][0]) + len(rows[i][1]))
        first = len(self.work[0]["rows"])
        rng = random.Random(self.seed)
        pick = {longest} | set(rng.sample(range(first), min(SAMPLE_ROWS, first)))
        return [rows[i] for i in sorted(pick)]

    def check(self) -> Dict[str, float]:
        self.release()
        ref, conf = self.cell.reference(), self.cell.conf
        picked = self.sample()
        w = self.reference_weights()
        get = weights.getter(w)
        gaps = []
        with torch.inference_mode():
            for row, served in picked:
                if not served:
                    continue
                logits = ref.served_logits(get, conf, row + served[:-1], len(row))
                gaps.append(ref.gaps(logits, served).float().cpu())
                del logits
                driver.free()
        del w
        driver.free()
        g = torch.cat(gaps)
        return {"token_gap": float(g.max()), "gap_mean": float(g.mean()),
                "flip_share": float((g > 0).float().mean()),
                "distinct_tokens": float(len({t for _, s in picked for t in s}))}
