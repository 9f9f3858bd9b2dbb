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


# ---------------------------------------------------------------------------
# Host spans (the port's own; everything above is the JAX package's module)
#
# One process-wide tracer, off by default. A span is ``(name, t0, t1,
# parent, call, wave)``: ``time.perf_counter`` seconds (the clock the
# benchmark's device trace maps device timestamps onto, so spans and device
# operations share one timeline), the index of the enclosing span (-1 at the
# top), and the ids that every span of one ``rerank_many`` call and of one
# flushed wave share (-1 outside one). A span inside one of the same name
# merges into it. Spans stay in memory until :func:`take`.
# ---------------------------------------------------------------------------


class _NullSpan:
    """The span while the tracer is off: reads no clock, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    def __init__(self):
        self.on = False
        # While set (``utils.profiling.trace``), each span also opens
        # ``ranges(name)``, so a profiler trace shows it above its kernels.
        self.ranges: Optional[Any] = None
        self.spans: List[list] = []
        self.stack: List[int] = []  # indices of the open spans
        self.calls = self.waves = 0


TRACER = Tracer()


class _Span:
    __slots__ = ("name", "opens", "index", "range")

    def __init__(self, name: str, opens: Optional[str]):
        self.name, self.opens, self.index, self.range = name, opens, None, None

    def __enter__(self):
        tr = TRACER
        parent = tr.stack[-1] if tr.stack else -1
        call = wave = -1
        if parent >= 0:
            outer = tr.spans[parent]
            if outer[0] == self.name:
                return self
            call, wave = outer[4], outer[5]
        if self.opens == "call":
            call, wave = tr.calls, -1
            tr.calls += 1
        elif self.opens == "wave":
            wave = tr.waves
            tr.waves += 1
        if tr.ranges is not None:
            self.range = tr.ranges(self.name)
            self.range.__enter__()
        self.index = len(tr.spans)
        tr.stack.append(self.index)
        tr.spans.append([self.name, time.perf_counter(), None, parent, call, wave])
        return self

    def __exit__(self, *exc) -> bool:
        if self.index is None:
            return False
        t1 = time.perf_counter()
        tr = TRACER
        tr.spans[self.index][2] = t1
        tr.stack.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


def span(name: str, opens: Optional[str] = None):
    """Context manager: its block is the span ``name``; ``opens`` "call" or
    "wave" gives the spans inside a new call or wave id. While the tracer is
    off, one shared object that does nothing."""
    if not TRACER.on:
        return _NULL_SPAN
    return _Span(name, opens)


def enable() -> None:
    TRACER.on = True


def disable() -> None:
    TRACER.on = False


def take() -> List[tuple]:
    """Hand over the spans recorded so far and clear them; none may be open."""
    if TRACER.stack:
        raise RuntimeError(f"{len(TRACER.stack)} spans still open")
    out = [tuple(s) for s in TRACER.spans]
    TRACER.spans = []
    return out
