"""Setwise reranker: counterpart of ``llmrankers_tpu/rankers/setwise.py``.

The sorts are the ``algos/setwise_sort.py`` coroutines (the port's copy);
every ``compare`` is a request into the wave batcher. Likelihood scoring (one
forward, label-token logits) runs on the port's engine, for T5 (the forced
``"<pad> Passage"`` decoder prefix) and for decoder-only models (the prompt
in the tokenizer's chat template, followed by ``" Passage:"``). Generation
scoring raises ``NotImplementedError``: it comes with the engine's
``generate`` (ROADMAP A6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..algos import setwise_sort
from ..engine.engine import ScoringEngine
from ..types import SearchResult, toppassage_results
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
        num_permutation: int = 1,  # with seed: generation voting (A6)
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
        if scoring != "likelihood":
            raise NotImplementedError(
                f"setwise {scoring} scoring is not ported yet (ROADMAP A6)")
        self.spec_depth = spec_depth
        self.num_child = num_child
        self.k = k
        self.scoring = scoring
        self.method = method
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
        tk = self.engine.tokenizer
        rows, max_docs = [], 0
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
        return [int(np.argmax(logits[i, : len(r.docs)]))
                for i, r in enumerate(requests)]
