"""TREC run-file I/O with qid-level resume.

Parity surface: the 6-column TREC interchange format the reference reads
(run.py:151-176) and writes (run.py:41-49), plus Rank-R1's
resume-from-partial-run behavior (run_setwise.py:79-87, 284-301: already
ranked qids are skipped and the writer appends).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..types import SearchResult


def read_run(path: str, hits: Optional[int] = None) -> List[Tuple[str, List[Tuple[str, float]]]]:
    """Parse a TREC run grouped by qid in file order, cut at ``hits``.

    Uses the native single-pass parser (native/hostops.cpp) when built;
    falls back to pure Python."""
    from ..utils import native

    cols = native.trec_parse(path) if native.available() else None
    groups: List[Tuple[str, List[Tuple[str, float]]]] = []
    current_qid: Optional[str] = None
    current: List[Tuple[str, float]] = []

    def feed(qid: str, docid: str, score: float) -> None:
        nonlocal current_qid, current
        if qid != current_qid:
            if current_qid is not None:
                groups.append((current_qid, current))
            current_qid, current = qid, []
        if hits is not None and len(current) >= hits:
            return
        current.append((docid, score))

    if cols is not None:
        qids, docids, _ranks, scores = cols
        for qid, docid, score in zip(qids, docids, scores):
            feed(qid, docid, float(score))
    else:
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 6:
                    continue
                feed(parts[0], parts[2], float(parts[4]))
    if current_qid is not None:
        groups.append((current_qid, current))
    return groups


def read_done_qids(path: str) -> Set[str]:
    """qids already present in a partial save file (resume support)."""
    done: Set[str] = set()
    if not os.path.exists(path):
        return done
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                done.add(parts[0])
    return done


class RunWriter:
    """Idempotent append-mode TREC writer.

    ``qid Q0 docid rank score tag`` rows, one flush per query so a killed
    run resumes at query granularity (run_setwise.py:300-301).
    """

    def __init__(self, path: str, tag: str = "LLMRankers", append: bool = False):
        self.path = path
        self.tag = tag
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a" if append else "w")

    def write_query(self, qid: str, ranking: Sequence[SearchResult]) -> None:
        for rank, doc in enumerate(ranking, start=1):
            self._f.write(f"{qid}\tQ0\t{doc.docid}\t{rank}\t{doc.score}\t{self.tag}\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_run(path: str, results, tag: str = "LLMRankers") -> None:
    """results: iterable of (qid, ranking)."""
    with RunWriter(path, tag) as w:
        for qid, ranking in results:
            w.write_query(qid, ranking)


def split_into_shards(items: List, num_shards: int, shard_index: int) -> List:
    """Contiguous query-set sharding for embarrassingly parallel runs
    (run_setwise.py:90-92 semantics: ceil-sized contiguous chunks)."""
    if num_shards <= 1:
        return items
    size = (len(items) + num_shards - 1) // num_shards
    return items[shard_index * size : (shard_index + 1) * size]
