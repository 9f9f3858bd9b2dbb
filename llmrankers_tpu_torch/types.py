"""Core data types shared across the framework.

Parity surface: mirrors the reference's base abstractions
(/root/reference/llmrankers/rankers.py:5-17) — ``SearchResult`` and the
``LlmRanker`` contract — extended with a first-class ``RerankStats`` meter
(the reference keeps three ad-hoc counters on each ranker,
setwise.py:75-77).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass
class SearchResult:
    """One candidate document in a ranking.

    Same fields as the reference dataclass (rankers.py:6-9). ``text`` may be
    ``None`` after reranking (the reference emits text-less results,
    setwise.py:300-313).
    """

    docid: str
    score: float
    text: Optional[str] = None


@dataclass
class RerankStats:
    """Per-query efficiency meters.

    The reference maintains ``total_compare`` / ``total_prompt_tokens`` /
    ``total_completion_tokens`` on every ranker and resets them per query
    (setwise.py:236-238); we keep them in one value object so engines and
    rankers can aggregate without shared mutable state.
    """

    comparisons: int = 0
    prompt_tokens: int = 0
    completion_tokens: int = 0

    def add(self, other: "RerankStats") -> None:
        self.comparisons += other.comparisons
        self.prompt_tokens += other.prompt_tokens
        self.completion_tokens += other.completion_tokens

    def reset(self) -> None:
        self.comparisons = 0
        self.prompt_tokens = 0
        self.completion_tokens = 0


class LlmRanker:
    """Base ranker interface (reference rankers.py:12-17).

    Subclasses must implement :meth:`rerank`; :meth:`rerank_many` has a
    default sequential implementation that batched rankers override to
    exploit cross-query batching (the key TPU-native inversion: the
    reference reranks one query at a time, run.py:184-195).
    """

    # Reference-compatible meter attributes, backed by `stats`.
    stats: RerankStats

    def __init__(self) -> None:
        self.stats = RerankStats()
        # Scheduler observability, cumulative across rerank_many calls;
        # surfaced in serve /stats. submaximal_waves is the regression
        # guard on wave maximality (algos/scheduler.WaveRunner docs).
        self.wave_stats: Dict[str, int] = {
            "waves": 0, "submaximal_waves": 0, "cache_hits": 0,
        }

    # -- reference-compatible counter aliases ------------------------------
    @property
    def total_compare(self) -> int:
        return self.stats.comparisons

    @property
    def total_prompt_tokens(self) -> int:
        return self.stats.prompt_tokens

    @property
    def total_completion_tokens(self) -> int:
        return self.stats.completion_tokens

    # -- API ---------------------------------------------------------------
    def rerank(self, query: str, ranking: List[SearchResult]) -> List[SearchResult]:
        raise NotImplementedError

    def rerank_many(
        self,
        queries: Sequence[str],
        rankings: Sequence[List[SearchResult]],
        on_result=None,
    ) -> List[List[SearchResult]]:
        """Rerank a batch of queries. Default: loop (override for batching).
        ``on_result(i, reranked)`` streams completions for crash-safe
        drivers."""
        out = []
        agg = RerankStats()
        for i, (q, r) in enumerate(zip(queries, rankings)):
            res = self.rerank(q, r)
            out.append(res)
            agg.add(self.stats)
            if on_result is not None:
                on_result(i, res)
        self.stats = agg
        return out

    def truncate(self, text: str, length: int) -> str:
        raise NotImplementedError


def toppassage_results(
    reranked: Sequence[SearchResult],
    original: Sequence[SearchResult],
    k: int,
) -> List[SearchResult]:
    """Emit top-k with score=-rank and pass the tail through in original order.

    Matches the reference's result assembly (setwise.py:296-313,
    pairwise.py:279-290): the k reranked heads get scores -1..-k, every
    other original doc follows with decreasing scores, text dropped.
    """
    results: List[SearchResult] = []
    top_ids = set()
    rank = 1
    for doc in list(reranked)[:k]:
        top_ids.add(doc.docid)
        results.append(SearchResult(docid=doc.docid, score=-rank, text=None))
        rank += 1
    for doc in original:
        if doc.docid not in top_ids:
            results.append(SearchResult(docid=doc.docid, score=-rank, text=None))
            rank += 1
    return results
