"""Observability: rerank meters and a structured JSONL event log.

The reference prints four averages after the rerank loop (run.py:198-201)
and carries a commented-out per-query completion logger
(run_setwise.py:26-29). Both become first-class here: the same printed
summary for CLI parity, plus an always-available structured event stream
(SURVEY.md §5 plan).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, TextIO

from ..types import RerankStats


@dataclass
class MeterReport:
    n_queries: int = 0
    total: RerankStats = field(default_factory=RerankStats)
    wall_s: float = 0.0
    # rows whose real tokens were cut to the model context this run
    # (ScoringEngine.truncated_rows delta; 0 when no engine is in play)
    truncated_rows: int = 0

    def add_query(self, stats: RerankStats) -> None:
        self.n_queries += 1
        self.total.add(stats)

    def summary(self) -> Dict[str, float]:
        n = max(self.n_queries, 1)
        return {
            "avg_comparisons": self.total.comparisons / n,
            "avg_prompt_tokens": self.total.prompt_tokens / n,
            "avg_completion_tokens": self.total.completion_tokens / n,
            "avg_time_per_query_s": self.wall_s / n,
            "truncated_rows": self.truncated_rows,
        }

    def print_summary(self) -> None:
        s = self.summary()
        # Same four lines as the reference driver (run.py:198-201).
        print(f"Avg comparisons: {s['avg_comparisons']}")
        print(f"Avg prompt tokens: {s['avg_prompt_tokens']}")
        print(f"Avg completion tokens: {s['avg_completion_tokens']}")
        print(f"Avg time per query: {s['avg_time_per_query_s']}")
        # Extra line only when the context cap actually cut tokens, so
        # the reference-format four-line contract holds otherwise.
        if self.truncated_rows:
            print(f"Truncated rows: {self.truncated_rows}")


class EventLog:
    """Append-only JSONL event stream (per-query meters, completions)."""

    def __init__(self, path: Optional[str]):
        self._f: Optional[TextIO] = open(path, "a") if path else None

    def emit(self, event: str, **fields: Any) -> None:
        if self._f is None:
            return
        rec = {"ts": time.time(), "event": event, **fields}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
