"""Shared ranker machinery: counterpart of ``llmrankers_tpu/rankers/base.py``.

The comparator plumbing is the JAX package's, on the port's engine: every
query's sort coroutine runs under one ``WaveRunner`` (the port's copy of
``algos/scheduler.py``), so comparisons from all queries share device
batches. A call is the span ``ranker.rerank_many``; the runner's time between
flushes, the sorts advancing to their next wave, is ``sched.sort``.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, List, Optional, Sequence

from ..algos.scheduler import WaveRunner
from ..engine.engine import ScoringEngine
from ..types import LlmRanker, RerankStats, SearchResult
from ..utils.metering import span


class _SpannedRunner(WaveRunner):
    """The copied ``WaveRunner`` with its time outside flushes (the wait for
    the wave event and the drain: the sort coroutines advancing) in spans
    ``sched.sort``, one before each wave and one after the last."""

    def run(self, coros):
        self._sort = span("sched.sort").__enter__()
        try:
            return super().run(coros)
        finally:
            self._sort.__exit__(None, None, None)

    def _flush(self) -> None:
        self._sort.__exit__(None, None, None)
        try:
            super()._flush()
        finally:
            self._sort = span("sched.sort").__enter__()


class EngineRanker(LlmRanker):
    """Base for rankers driven by a :class:`ScoringEngine`.

    ``rerank_many`` is the native entry point; ``rerank`` (the reference's
    per-query API) is its single-query case.
    """

    def __init__(self, engine: ScoringEngine, max_wave_size: Optional[int] = None):
        super().__init__()
        self.engine = engine
        self.max_wave_size = max_wave_size
        # Named engine adapter for this ranker's calls; LoRA is not ported
        # (ROADMAP A10), so it stays None.
        self.adapter: Optional[str] = None
        # Comparison-memoization key function, set by subclasses when
        # caching is requested and scoring is deterministic.
        self._cache_key_fn: Optional[Callable[[Any], Any]] = None
        self._query_stats: List[RerankStats] = []

    def _row_adapters_for(self, qidxs: Sequence[int]):
        """Per-row adapters of a wave (row i belongs to query qidxs[i]), or
        None when the call has no per-query adapters. Per-query adapters
        come with LoRA serving (ROADMAP A10): always None here."""
        return None

    @staticmethod
    def _docid_cache_key(r: Any) -> Any:
        """Memoization key for set requests: query index + docid tuple in
        order (order changes the prompt, hence the output)."""
        return (r.qidx, tuple(d.docid for d in r.docs))

    # Subclasses implement one query's ranking coroutine + a batch executor.
    async def _rerank_one(self, runner: WaveRunner, qidx: int, query: str,
                          ranking: List[SearchResult]) -> List[SearchResult]:
        raise NotImplementedError

    def _compare_batch(self, requests: List[Any]) -> List[Any]:
        raise NotImplementedError

    def rerank_many(
        self,
        queries: Sequence[str],
        rankings: Sequence[List[SearchResult]],
        on_result: Optional[Callable[[int, List[SearchResult]], None]] = None,
    ) -> List[List[SearchResult]]:
        """``on_result(i, reranked)`` fires as soon as query i finishes, so a
        caller can stream results to disk at query granularity."""
        with span("ranker.rerank_many", opens="call"):
            self._query_stats = [RerankStats() for _ in queries]
            runner = _SpannedRunner(self._compare_batch, self.max_wave_size,
                                    cache_key=self._cache_key_fn)

            async def one(i, q, r):
                res = await self._rerank_one(runner, i, q, r)
                if on_result is not None:
                    on_result(i, res)
                return res

            results = runner.run(
                [one(i, q, copy.deepcopy(list(r)))
                 for i, (q, r) in enumerate(zip(queries, rankings))]
            )
            total = RerankStats()
            for s in self._query_stats:
                total.add(s)
            self.stats = total
            self.wave_stats["waves"] += runner.num_waves
            self.wave_stats["submaximal_waves"] += runner.num_submaximal_waves
            self.wave_stats["cache_hits"] += runner.num_cache_hits
            return results

    def rerank(self, query: str, ranking: List[SearchResult]) -> List[SearchResult]:
        return self.rerank_many([query], [ranking])[0]

    @property
    def per_query_stats(self) -> List[RerankStats]:
        return self._query_stats

    def truncate(self, text: str, length: int) -> str:
        return self.engine.tokenizer.truncate(text, length)

    def _encode_prompt(self, text: str) -> List[int]:
        return self.engine.tokenizer.encode(text, add_special_tokens=True)

    def _label_token_ids(self, labels: Sequence[str], prefix: str) -> List[int]:
        """Last-token id of f'{prefix} {label}' for each label (the
        reference's target_token_ids construction)."""
        tk = self.engine.tokenizer
        return [tk.encode(f"{prefix} {c}", add_special_tokens=False)[-1]
                for c in labels]
