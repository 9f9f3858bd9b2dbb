"""Setwise reranker: counterpart of ``llmrankers_tpu/rankers/setwise.py``.

The sorts are the ``algos/setwise_sort.py`` coroutines (the port's copy);
every ``compare`` is a request into the wave batcher. Likelihood scoring (one
forward, label-token logits) runs on the port's engine, for T5 (the forced
``"<pad> Passage"`` decoder prefix) and for decoder-only models (the prompt
in the tokenizer's chat template, followed by ``" Passage:"``). Generation
scoring (a one-token greedy decode, parsed as the reference parses it, with
permutation self-consistency voting when ``num_permutation`` > 1) runs on
decoder-only models; on T5 it raises ``NotImplementedError``, as T5
generation is not ported (ROADMAP A6).
"""
from __future__ import annotations

import random
import sys
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from ..algos import setwise_sort
from ..engine.engine import ScoringEngine
from ..types import SearchResult, toppassage_results
from ..utils.metering import span
from . import prompts
from .base import EngineRanker


@dataclass
class _SetRequest:
    qidx: int
    query: str
    docs: List[SearchResult] = field(default_factory=list)


class SetwiseLlmRanker(EngineRanker):
    CHARACTERS = prompts.CHARACTERS

    def __init__(
        self,
        engine: ScoringEngine,
        num_child: int = 3,
        k: int = 10,
        scoring: str = "generation",
        method: str = "heapsort",
        num_permutation: int = 1,  # with seed: generation voting
        seed: int = 929,
        max_wave_size: Optional[int] = None,
        spec_depth: int = 1,  # >1: speculative heap pops (latency knob)
        cache_comparisons: bool = False,
    ):
        super().__init__(engine, max_wave_size)
        if cache_comparisons:
            if num_permutation > 1:
                # Permutation voting draws from a shared RNG stream; skipping
                # repeats would shift it and change later shuffles.
                raise ValueError("cache_comparisons requires num_permutation == 1")
            self._cache_key_fn = self._docid_cache_key
        if scoring != "likelihood" and engine.kind == "t5":
            raise NotImplementedError(
                "setwise generation scoring on T5 is not ported yet (ROADMAP A6)")
        if spec_depth > 1 and num_permutation > 1 and scoring == "generation":
            # Discarded speculative comparisons would advance the shared
            # permutation RNG stream and change every later shuffle.
            raise ValueError(
                "spec_depth > 1 is incompatible with num_permutation > 1 "
                "generation scoring (speculative comparisons would shift "
                "the permutation RNG stream)"
            )
        self.spec_depth = spec_depth
        self.num_child = num_child
        self.k = k
        self.scoring = scoring
        self.method = method
        self.num_permutation = num_permutation
        self.rng = random.Random(seed)
        tk = engine.tokenizer
        if engine.kind == "t5":
            # "<pad> Passage" forced decoder prefix (reference setwise.py:51-54).
            self.decoder_prefix = tk.encode("<pad> Passage", add_special_tokens=False)
            self.label_ids = self._label_token_ids(self.CHARACTERS, "<pad> Passage")
        else:
            self.decoder_prefix = []
            self.label_ids = self._label_token_ids(self.CHARACTERS, "Passage")

    async def _rerank_one(self, runner, qidx, query, ranking):
        original = list(ranking)

        async def compare(docs: List[SearchResult]) -> int:
            return await runner.compare(_SetRequest(qidx, query, docs))

        if self.method == "heapsort":
            ordered = await setwise_sort.heapsort(
                runner, list(ranking), self.k, self.num_child, compare,
                spec_depth=self.spec_depth,
            )
        elif self.method == "bubblesort":
            ordered = await setwise_sort.bubblesort(
                runner, list(ranking), self.k, self.num_child, compare
            )
        elif self.method == "insertion":
            ordered = await setwise_sort.insertion(
                runner, list(ranking), self.k, self.num_child, compare
            )
        else:
            raise NotImplementedError(f"Method {self.method} is not implemented.")
        return toppassage_results(ordered, original, self.k)

    # ------------------------------------------------------------------
    # Batch executor
    # ------------------------------------------------------------------
    def _compare_batch(self, requests: List[_SetRequest]) -> List[int]:
        with span("ranker.batch", opens="wave"):
            if self.scoring == "likelihood":
                return self._likelihood_batch(requests)
            return self._generation_batch(requests)

    def _likelihood_batch(self, requests: List[_SetRequest]) -> List[int]:
        tk = self.engine.tokenizer
        rows, max_docs = [], 0
        with span("ranker.prompts"):
            for r in requests:
                self._query_stats[r.qidx].comparisons += 1
                text = prompts.setwise_prompt(r.query, [d.text for d in r.docs])
                if self.engine.kind == "decoder":
                    text = tk.apply_chat_template(
                        [{"role": "user", "content": text}]) + " Passage:"
                ids = self._encode_prompt(text)
                self._query_stats[r.qidx].prompt_tokens += len(ids) + len(self.decoder_prefix)
                rows.append(ids)
                max_docs = max(max_docs, len(r.docs))
        logits = self.engine.score_labels(rows, self.label_ids[:max_docs],
                                          self.decoder_prefix)
        with span("ranker.outcomes"):
            return [int(np.argmax(logits[i, : len(r.docs)]))
                    for i, r in enumerate(requests)]

    def _generation_batch(self, requests: List[_SetRequest]) -> List[int]:
        """One-token greedy decode per prompt (the reference's setwise.py:
        87-177 on a decoder-only model); with num_permutation > 1, shuffled
        copies of each comparison ride the same batch and vote."""
        tk = self.engine.tokenizer
        rows: List[List[int]] = []
        # Per request: (row index, doc permutation, label assignment) per copy.
        plans: List[List[Any]] = []
        with span("ranker.prompts"):
            for r in requests:
                self._query_stats[r.qidx].comparisons += max(1, self.num_permutation)
                n = len(r.docs)
                base_labels = self.CHARACTERS[:n]
                if self.num_permutation == 1:
                    variants = [(list(range(n)), base_labels)]
                else:
                    variants = []
                    idx = list(range(n))
                    for _ in range(self.num_permutation):
                        perm = self.rng.sample(idx, n)
                        labs = self.rng.sample(base_labels, n)
                        variants.append((perm, labs))
                plan = []
                for perm, labs in variants:
                    text = prompts.setwise_prompt(r.query, [r.docs[j].text for j in perm], labs)
                    text = tk.apply_chat_template([{"role": "user", "content": text}]) + " Passage:"
                    ids = self._encode_prompt(text)
                    self._query_stats[r.qidx].prompt_tokens += len(ids)
                    plan.append((len(rows), perm, labs))
                    rows.append(ids)
                plans.append(plan)

        texts, ntoks = self.engine.generate(rows, 1, self.decoder_prefix,
                                            adapter=self.adapter)
        with span("ranker.outcomes"):
            out: List[int] = []
            for r, plan in zip(requests, plans):
                for row_i, _, _ in plan:
                    self._query_stats[r.qidx].completion_tokens += ntoks[row_i]
                if len(plan) == 1:
                    row_i, perm, labs = plan[0]
                    label = texts[row_i].strip().upper()  # setwise.py:174-177
                    if label in labs:
                        out.append(perm[labs.index(label)])
                    else:
                        print(f"Unexpected output: {texts[row_i]!r}", file=sys.stderr)
                        # A valid label beyond the doc count keeps its index, so
                        # the sort's out-of-range fallback fires upstream.
                        out.append(self.CHARACTERS.index(label) if label in self.CHARACTERS
                                   else 0)
                    continue
                # Self-consistency vote (setwise.py:137-157): the whole stripped
                # decode uppercased, exactly one character.
                candidates = []
                for row_i, perm, labs in plan:
                    s = texts[row_i].strip().upper()
                    label = s if len(s) == 1 else ""
                    if label not in labs:
                        print(f"Unexpected output: {texts[row_i]!r}", file=sys.stderr)
                        continue
                    candidates.append(perm[labs.index(label)])
                if not candidates:
                    print("Unexpected voting.", file=sys.stderr)
                    out.append(0)
                    continue
                counts: dict = {}
                for c in candidates:
                    counts[c] = counts.get(c, 0) + 1
                top = max(counts.values())
                best = [c for c, v in counts.items() if v == top]
                out.append(best[0] if len(best) == 1 else self.rng.choice(best))
        return out
