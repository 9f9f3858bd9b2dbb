"""Cooperative wave-batching scheduler.

This is the core TPU-native inversion of the reference's control flow. The
reference drives its sort algorithms with synchronous, batch-1
``compare()`` calls (one ``llm.generate`` per heap operation,
/root/reference/llmrankers/setwise.py:200-232) — fatal on TPU, where a
batch-1 dispatch wastes the MXU and dynamic shapes force recompiles.

Here, ranking algorithms are written as ``async`` coroutines that ``await
engine.compare(request)``. The :class:`WaveRunner` runs many coroutines at
once — one per query, plus intra-query subtasks for independent heap
subtrees — and flushes a batch exactly when every live task is blocked on a
comparison (or the batch budget is hit). Each flush is one fixed-shape
forward on device. Algorithm *semantics* are untouched: each coroutine
performs the same comparisons in the same per-query order as the
reference, so outcomes (and NDCG) are identical; only the device schedule
changes.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Coroutine, Generic, List, Optional, Sequence, TypeVar

R = TypeVar("R")  # request type
O = TypeVar("O")  # outcome type

# A batch executor: takes the pending requests, returns one outcome each.
BatchFn = Callable[[List[Any]], List[Any]]


@dataclass(order=True)
class _Pending:
    """One blocked comparison, ordered deterministically."""

    seq: int
    request: Any = field(compare=False)
    future: asyncio.Future = field(compare=False)
    key: Any = field(compare=False, default=None)


class WaveRunner:
    """Runs ranking coroutines, batching their compare() calls into waves.

    The flush condition is "all live tasks are blocked": at that moment the
    pending set is a maximal wave of mutually independent comparisons.
    Results for each request depend only on that request (each row of the
    batch is an independent forward), so batch composition cannot change
    outcomes — determinism is preserved no matter how queries interleave.

    ``max_batch_size`` optionally splits oversized waves so device memory
    stays bounded; the backend may further bucket by sequence length.

    ``cache_key`` enables comparison memoization (arXiv:2505.24643): a
    repeated request (same key) returns the recorded outcome without a
    device dispatch. Only sound when outcomes are deterministic functions
    of the request — greedy decoding / likelihood scoring without shared
    RNG state; rankers gate it accordingly. Cache hits are counted in
    ``num_cache_hits`` (they do not bump the rankers' comparison meters —
    the meters report LLM calls actually issued, which is the point).
    """

    def __init__(
        self,
        batch_fn: BatchFn,
        max_batch_size: Optional[int] = None,
        cache_key: Optional[Callable[[Any], Any]] = None,
    ):
        self._batch_fn = batch_fn
        self._max_batch = max_batch_size
        self._cache_key = cache_key
        self._cache: dict = {}
        self._inflight: dict = {}  # key -> future of the wave's primary request
        self._pending: List[_Pending] = []
        self._live = 0  # tasks that may still submit requests
        self._seq = 0
        self._progress = 0  # monotone counter: bumps on every task event
        self._wave_event: Optional[asyncio.Event] = None
        self.num_waves = 0  # device dispatches issued (observability)
        self.num_cache_hits = 0
        # Waves flushed while some live task was NOT yet blocked on a
        # compare (the drain's no-progress heuristic gave up): outcomes
        # are unchanged, but batching silently degrades — this counter is
        # the regression guard on the scheduler's core invariant. Budget
        # hits and the live==0 tail flush are intended and not counted.
        self.num_submaximal_waves = 0

    # ------------------------------------------------------------------
    # API used by algorithm coroutines
    # ------------------------------------------------------------------
    async def compare(self, request: Any) -> Any:
        """Submit one comparison and suspend until its outcome is ready."""
        key = None
        if self._cache_key is not None:
            key = self._cache_key(request)
            if key is not None and key in self._cache:
                self.num_cache_hits += 1
                return self._cache[key]
            inflight = self._inflight.get(key) if key is not None else None
            if inflight is not None and not inflight.done():
                # A request with the same key is already pending in this
                # wave (e.g. parallel topdown windows sharing a pivot, or
                # racing cohort tasks): await its outcome instead of
                # dispatching a second device row. While blocked on a
                # future another task owns we are not live (mirrors
                # gather()), else the runner would deadlock waiting for us.
                self.num_cache_hits += 1
                self._live -= 1
                self._progress += 1
                self._maybe_signal()
                try:
                    return await inflight
                finally:
                    self._live += 1
                    self._progress += 1
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        if key is not None:
            self._inflight[key] = fut
        self._pending.append(_Pending(self._seq, request, fut, key))
        self._seq += 1
        self._progress += 1
        self._maybe_signal()
        return await fut

    async def gather(self, coros: Sequence[Coroutine]) -> List[Any]:
        """Run subtasks concurrently (e.g. sibling heapify chains).

        Keeps the live-task count accurate so the flush condition still
        means "every runnable task is blocked".
        """
        if not coros:
            return []
        self._live += len(coros)
        # The parent counts as live again the moment its LAST child ends —
        # in the child's own completion hop, not the parent's resume hop.
        # Otherwise live dips while the wakeup is in flight and the runner
        # flushes a sub-maximal wave (the parent's next compare would miss
        # the batch it belongs in).
        state = {"remaining": len(coros), "restored": False}

        def child_done():
            state["remaining"] -= 1
            if state["remaining"] == 0 and not state["restored"]:
                state["restored"] = True
                self._live += 1

        tasks = [
            asyncio.ensure_future(self._tracked(c, child_done)) for c in coros
        ]
        # The awaiting parent is blocked but not on a compare -> it must not
        # count as live, else the runner would deadlock waiting for it.
        self._live -= 1
        self._progress += 1
        try:
            return await asyncio.gather(*tasks)
        finally:
            if not state["restored"]:  # resumed early (child exception)
                state["restored"] = True
                self._live += 1
            self._progress += 1

    async def _tracked(
        self, coro: Coroutine, on_done: Optional[Callable[[], None]] = None
    ) -> Any:
        try:
            return await coro
        finally:
            self._live -= 1
            self._progress += 1
            if on_done is not None:
                on_done()
            self._maybe_signal()

    # ------------------------------------------------------------------
    # Driver
    # ------------------------------------------------------------------
    def run(self, coros: Sequence[Coroutine]) -> List[Any]:
        """Run top-level coroutines to completion; returns their results."""
        return asyncio.run(self._main(coros))

    async def _main(self, coros: Sequence[Coroutine]) -> List[Any]:
        self._live = len(coros)
        self._wave_event = asyncio.Event()
        tasks = [asyncio.ensure_future(self._tracked(c)) for c in coros]
        try:
            while any(not t.done() for t in tasks):
                await self._wave_event.wait()
                self._wave_event.clear()
                # Yield until every live task is provably blocked on a
                # compare (len(pending) == live), so the wave is maximal.
                await self._drain_until_quiescent()
                if self._pending:
                    self._flush()
                elif all(t.done() for t in tasks):
                    break
            return [t.result() for t in tasks]
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()

    def _quiescent(self) -> bool:
        if self._live == 0:
            return True
        if self._max_batch is not None and len(self._pending) >= self._max_batch:
            return True  # budget hit: flush now, stragglers join later waves
        return len(self._pending) >= self._live

    async def _drain_until_quiescent(self) -> None:
        """Yield to the event loop until every live task is blocked on an
        unresolved compare — the pending set is then a provably maximal
        wave (len(pending) == live) — or until several consecutive yields
        make no progress (a task is awaiting something external; its
        compare simply lands in a later wave, which cannot change
        outcomes).

        Progress is a monotone event counter, so arbitrarily deep await
        chains (e.g. insertion's nested binary_insert gathers) keep the
        drain alive; the idle window only needs to cover asyncio's
        uninstrumented internal hops (done-callback -> gather future ->
        task wakeup), which span < 3 loop iterations.
        """
        idle = 0
        prev = self._progress
        while not self._quiescent() and idle < 3:
            await asyncio.sleep(0)
            if self._progress == prev:
                idle += 1
            else:
                idle = 0
                prev = self._progress

    def _maybe_signal(self) -> None:
        if self._wave_event is None:
            return
        batch_full = self._max_batch is not None and len(self._pending) >= self._max_batch
        all_blocked = self._live > 0 and len(self._pending) >= self._live
        done = self._live == 0
        if batch_full or all_blocked or done:
            self._wave_event.set()

    def _flush(self) -> None:
        budget_hit = (
            self._max_batch is not None
            and len(self._pending) >= self._max_batch
        )
        if self._live > 0 and len(self._pending) < self._live and not budget_hit:
            self.num_submaximal_waves += 1
        self._pending.sort()  # deterministic submission order
        wave = self._pending
        self._pending = []
        limit = self._max_batch or len(wave)
        for i in range(0, len(wave), limit):
            chunk = wave[i : i + limit]
            outcomes = self._batch_fn([p.request for p in chunk])
            self.num_waves += 1
            if len(outcomes) != len(chunk):
                raise RuntimeError(
                    f"batch_fn returned {len(outcomes)} outcomes for {len(chunk)} requests"
                )
            for p, out in zip(chunk, outcomes):
                if p.key is not None:
                    self._cache[p.key] = out
                    self._inflight.pop(p.key, None)
                if not p.future.done():
                    p.future.set_result(out)


def run_sync(
    batch_fn: BatchFn,
    coros: Sequence[Coroutine],
    max_batch_size: Optional[int] = None,
) -> List[Any]:
    """Convenience: run coroutines under a fresh WaveRunner."""
    return WaveRunner(batch_fn, max_batch_size).run(coros)
