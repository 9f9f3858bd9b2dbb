"""Rank-R1 setwise reranker: counterpart of ``llmrankers_tpu/rankers/rank_r1.py``.

A decoder-only chat model reasons inside <think></think> and answers
<answer>[i]</answer>; the winner is extracted by the prompt pack's regex over
the lowercased completion. Labels are numeric "[1]".."[20]". Prompt packs are
TOML files with the keys prompt_system / prompt_user / pattern / doc_prefix /
doc_separator; the port keeps its copies of the JAX package's packs in
``llmrankers_tpu_torch/prompts/``. Completions run on the engine's chunked
decode with the stop string "</answer>"; permutation self-consistency copies
ride the same batch.

``RankR1ListwiseLlmRanker`` needs the listwise window sort, which comes with
the other rankers (ROADMAP A6), and raises.
"""
from __future__ import annotations

import random
import re
import sys
import tomllib
from typing import Any, List, Optional

from ..algos import setwise_sort
from ..engine.engine import ScoringEngine
from ..types import SearchResult, toppassage_results
from ..utils.metering import span
from .base import EngineRanker
from .setwise import _SetRequest


class RankR1SetwiseLlmRanker(EngineRanker):
    CHARACTERS = [f"[{i + 1}]" for i in range(20)]

    def __init__(
        self,
        engine: ScoringEngine,
        prompt_file: str,
        num_child: int = 19,
        k: int = 10,
        scoring: str = "generation",
        method: str = "heapsort",
        num_permutation: int = 1,
        max_completion_tokens: int = 2048,  # SamplingParams(max_tokens=2048)
        seed: int = 929,
        verbose: bool = False,
        max_wave_size: Optional[int] = None,
        adapter: Optional[str] = None,  # LoRA adapter name (ROADMAP A10)
        spec_depth: int = 1,  # >1: speculative heap pops (latency knob)
        cache_comparisons: bool = False,
        temperature: float = 0.0,  # sampled completions, keyed by ``seed``
        chunk_tokens: Optional[int] = None,  # stop-string check granularity;
        # None: the engine's default (256 for budgets >= 512)
    ):
        super().__init__(engine, max_wave_size)
        if adapter is not None:
            raise NotImplementedError("LoRA adapters are not ported yet (ROADMAP A10)")
        if temperature and temperature > 0.0:
            if cache_comparisons:
                raise ValueError(
                    "cache_comparisons requires deterministic outcomes; "
                    "incompatible with temperature sampling")
            if spec_depth > 1:
                raise ValueError(
                    "spec_depth > 1 is greedy-only (speculative acceptance); "
                    "incompatible with temperature sampling")
        self.temperature = float(temperature)
        if cache_comparisons:
            if num_permutation > 1:
                raise ValueError("cache_comparisons requires num_permutation == 1")
            self._cache_key_fn = self._docid_cache_key
        if scoring != "generation":
            raise NotImplementedError(
                "RankR1SetwiseLlmRanker only supports 'generation' scoring")
        if spec_depth > 1 and num_permutation > 1:
            # Discarded speculative comparisons would advance the shared
            # permutation RNG stream and change later shuffles.
            raise ValueError(
                "spec_depth > 1 is incompatible with num_permutation > 1 "
                "(speculative comparisons would shift the permutation RNG stream)")
        self.spec_depth = spec_depth
        if engine.kind != "decoder":
            raise ValueError("Rank-R1 rankers run on decoder-only chat models")
        with open(prompt_file, "rb") as f:
            self.prompt = tomllib.load(f)
        self.num_child = num_child
        self.k = k
        self.method = method
        self.num_permutation = num_permutation
        self.max_completion_tokens = max_completion_tokens
        self.chunk_tokens = chunk_tokens
        self.rng = random.Random(seed)
        self.seed = int(seed)
        self.verbose = verbose

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

    def _render(self, query: str, docs: List[SearchResult], perm: List[int]) -> str:
        doc_prefix = self.prompt.get("doc_prefix", "[{num}] ")
        doc_sep = self.prompt.get("doc_separator", "\n")
        lines = [f"{doc_prefix.format(num=i + 1)}{docs[j].text}" for i, j in enumerate(perm)]
        messages = [
            {"role": "system", "content": self.prompt["prompt_system"]},
            {"role": "user", "content": self.prompt["prompt_user"].format(
                query=query, docs=doc_sep.join(lines))},
        ]
        return self.engine.tokenizer.apply_chat_template(messages)

    def _compare_batch(self, requests: List[_SetRequest]) -> List[int]:
        with span("ranker.batch", opens="wave"):
            rows: List[List[int]] = []
            row_qidx: List[int] = []
            plans: List[List[Any]] = []
            with span("ranker.prompts"):
                for r in requests:
                    self._query_stats[r.qidx].comparisons += max(1, self.num_permutation)
                    n = len(r.docs)
                    # Rank-R1 shuffles the docs but keeps the labels in order.
                    variants = ([list(range(n))] if self.num_permutation == 1
                                else [self.rng.sample(list(range(n)), n)
                                      for _ in range(self.num_permutation)])
                    plan = []
                    for perm in variants:
                        ids = self._encode_prompt(self._render(r.query, r.docs, perm))
                        self._query_stats[r.qidx].prompt_tokens += len(ids)
                        plan.append((len(rows), perm))
                        rows.append(ids)
                        row_qidx.append(r.qidx)
                    plans.append(plan)

            pattern = rf"{self.prompt['pattern']}"
            row_adapters = self._row_adapters_for(row_qidx)
            texts, ntoks = self.engine.generate(
                rows, self.max_completion_tokens, stop_strings=("</answer>",),
                chunk_tokens=self.chunk_tokens,
                **({"temperature": self.temperature, "seed": self.seed}
                   if self.temperature > 0.0 else {}),
                **({"row_adapters": row_adapters} if row_adapters is not None
                   else {"adapter": self.adapter}),
            )

            with span("ranker.outcomes"):
                out: List[int] = []
                for r, plan in zip(requests, plans):
                    candidates = []
                    labels = self.CHARACTERS[: len(r.docs)]
                    for row_i, perm in plan:
                        self._query_stats[r.qidx].completion_tokens += ntoks[row_i]
                        completion = texts[row_i]
                        if self.verbose:
                            print(f"--- completion for q={r.query!r}:\n{completion}\n---")
                        m = re.search(pattern, completion.lower(), re.DOTALL)
                        result = m.group(1).strip() if m else ""
                        if result not in labels:
                            if self.verbose:
                                print(f"Unexpected output: {result!r}", file=sys.stderr)
                            continue
                        candidates.append(perm[labels.index(result)])
                    if not candidates:
                        out.append(0)  # fall back to the first, as the sort's ValueError path
                        continue
                    counts: dict = {}
                    for c in candidates:
                        counts[c] = counts.get(c, 0) + 1
                    top = max(counts.values())
                    best = [c for c, v in counts.items() if v == top]
                    out.append(best[0] if len(best) == 1 else self.rng.choice(best))
            return out


class RankR1ListwiseLlmRanker(EngineRanker):
    """Not ported yet: it needs the listwise window sort (ROADMAP A6)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "RankR1ListwiseLlmRanker is not ported yet (ROADMAP A6)")
