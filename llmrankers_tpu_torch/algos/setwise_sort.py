"""Setwise ranking algorithms: multi-child heapsort and bubblesort.

Behavioral parity with /root/reference/llmrankers/setwise.py:200-293:
  * heapify picks the winner among a node and its ``num_child`` children via
    one setwise comparison; out-of-range model answers fall back to the
    root (setwise.py:206-213 handles ValueError->0 / IndexError->i).
  * heapSort builds a max-heap bottom-up then pops k times.
  * bubblesort slides a (num_child+1)-window from the bottom with the
    "skip unchanged bottom" optimization (setwise.py:243-273).

TPU-native difference: these are ``async`` coroutines driven by
:class:`~llmrankers_tpu.algos.scheduler.WaveRunner`. The heap build phase
exposes its natural parallelism — all heapify chains at one tree depth act
on disjoint subtrees — as concurrent subtasks, and the sequential pop
phase still batches across queries. Comparison outcomes are identical to
the reference's sequential order because same-depth chains are
independent.

The ``compare`` callable receives ``(root_doc, *child_docs)`` index lists
and resolves to the *raw* best index the model produced (it may be out of
range; fallback handling mirrors the reference).
"""
from __future__ import annotations

from typing import Any, Awaitable, Callable, List, Sequence

from .scheduler import WaveRunner

# compare(docs: List[Any]) -> int  (index into docs of the winner; may be
# out of range when the model emits an unexpected label)
SetCompare = Callable[[List[Any]], Awaitable[int]]


async def _heapify_chain(
    arr: List[Any], n: int, i: int, num_child: int, compare: SetCompare
) -> None:
    """Sift node ``i`` down its subtree (iterative form of setwise.py:200-217)."""
    while num_child * i + 1 < n:
        lo = num_child * i + 1
        hi = min(num_child * (i + 1) + 1, n)
        docs = [arr[i]] + arr[lo:hi]
        inds = [i] + list(range(lo, hi))
        best = await compare(docs)
        # Fallbacks: unparseable label -> 0 handled by comparator;
        # parseable-but-out-of-range label -> keep root (IndexError -> i).
        largest = inds[best] if 0 <= best < len(inds) else i
        if largest == i:
            return
        arr[i], arr[largest] = arr[largest], arr[i]
        i = largest


def _levels(n: int, num_child: int) -> List[List[int]]:
    """Group the build indices range(n//num_child, -1, -1) by tree depth,
    deepest first, preserving descending order within a depth."""
    if n <= 0:
        return []
    depth_of = [0] * (n // num_child + 1)
    for i in range(1, len(depth_of)):
        depth_of[i] = depth_of[(i - 1) // num_child] + 1
    buckets: dict[int, List[int]] = {}
    for i in range(n // num_child, -1, -1):
        buckets.setdefault(depth_of[i], []).append(i)
    return [buckets[d] for d in sorted(buckets, reverse=True)]


async def _spec_sift_down(
    runner: WaveRunner,
    arr: List[Any],
    n: int,
    i: int,
    num_child: int,
    compare: SetCompare,
    depth: int,
) -> None:
    """Sift-down with ``depth``-level speculation.

    The value ``v`` descending from node ``i`` is invariant along the
    path, and nodes below the path are untouched until the path reaches
    them — so the comparison at ANY node m of the descent subtree is
    ``[v] + arr[children(m)]``, fully known before any outcome. Each
    round issues the comparisons of up to ``depth`` subtree levels as one
    concurrent gather (one wave), then walks the outcomes host-side,
    discarding the branches not taken. Outcomes on the taken path are
    bit-identical to the sequential sift (setwise.py:200-217); only the
    device schedule (and the number of issued comparisons) changes.

    Latency: a pop completes in ceil(path_len / depth) waves instead of
    path_len. Cost: ~num_child^depth speculative comparisons per round —
    the throughput/latency knob for isolated queries.
    """
    while num_child * i + 1 < n:
        nodes: List[int] = []
        frontier = [i]
        for _ in range(max(depth, 1)):
            nxt: List[int] = []
            for m in frontier:
                if num_child * m + 1 < n:
                    nodes.append(m)
                    nxt.extend(
                        range(num_child * m + 1, min(num_child * (m + 1) + 1, n))
                    )
            frontier = nxt
        outs = await runner.gather(
            [
                compare(
                    [arr[i]]
                    + arr[num_child * m + 1 : min(num_child * (m + 1) + 1, n)]
                )
                for m in nodes
            ]
        )
        out_by_node = dict(zip(nodes, outs))
        cur = i
        while cur in out_by_node:
            lo = num_child * cur + 1
            hi = min(num_child * (cur + 1) + 1, n)
            inds = [cur] + list(range(lo, hi))
            best = out_by_node[cur]
            largest = inds[best] if 0 <= best < len(inds) else cur
            if largest == cur:
                return
            arr[cur], arr[largest] = arr[largest], arr[cur]
            cur = largest
        i = cur  # path outran the speculated depth: next round


async def heapsort(
    runner: WaveRunner,
    arr: List[Any],
    k: int,
    num_child: int,
    compare: SetCompare,
    spec_depth: int = 1,
) -> List[Any]:
    """Partial multi-child max-heapsort; top-k land at the array tail
    (reference heapSort, setwise.py:219-232). Returns ``arr`` reversed so
    the best element is first, as rerank() consumes it (setwise.py:240).

    ``spec_depth`` > 1 enables speculative pops (see _spec_sift_down):
    identical results when comparisons are stateless (likelihood scoring,
    or generation without permutation self-consistency — the ranker
    enforces this), ~spec_depth x fewer sequential waves per pop, at the
    cost of extra (discarded) comparisons — worth it for isolated
    low-latency queries where waves are far from full."""
    n = len(arr)

    def sift(i: int, size: int):
        if spec_depth > 1:
            return _spec_sift_down(
                runner, arr, size, i, num_child, compare, spec_depth
            )
        return _heapify_chain(arr, size, i, num_child, compare)

    # Build phase: one wave of independent sift-down chains per tree depth
    # (speculation additionally collapses each chain's descent rounds).
    for level in _levels(n, num_child):
        if len(level) == 1:
            await sift(level[0], n)
        else:
            await runner.gather([sift(i, n) for i in level])
    # Pop phase: inherently sequential per query; batches across queries
    # (and across speculated levels when spec_depth > 1).
    ranked = 0
    for i in range(n - 1, 0, -1):
        arr[i], arr[0] = arr[0], arr[i]
        ranked += 1
        if ranked == k:
            break
        await sift(0, i)
    return list(reversed(arr))


async def bubblesort(
    runner: WaveRunner,
    arr: List[Any],
    k: int,
    num_child: int,
    compare: SetCompare,
) -> List[Any]:
    """Top-k multi-doc bubblesort with window caching (setwise.py:243-273).

    A (num_child+1)-wide window walks bottom-up by num_child per step; the
    winner is swapped to the window head. If a full upward pass makes no
    swap below the frontier, the stale bottom region is skipped on later
    passes (``last_start`` bookkeeping identical to the reference).
    """
    ranking = arr
    last_start = len(ranking) - (num_child + 1)
    for i in range(k):
        start_ind = last_start
        end_ind = last_start + (num_child + 1)
        is_change = False
        while True:
            if start_ind < i:
                start_ind = i
            window = ranking[start_ind:end_ind]
            best = await compare(window)
            # DOCUMENTED DIVERGENCE from the reference: setwise.py:255-256
            # indexes `ranking[start_ind + best_ind]` for ANY known label,
            # so a model answer beyond the window (e.g. 'E' for a 4-doc
            # window) swaps in a document the model never saw — or
            # IndexErrors at the list edge. Such answers are clamped to
            # "no swap" here (the rankers' parse fallbacks make them land
            # as 0 anyway); everything in-window is decision-identical.
            best_ind = best if 0 <= best < len(window) else 0
            if best_ind != 0:
                ranking[start_ind], ranking[start_ind + best_ind] = (
                    ranking[start_ind + best_ind],
                    ranking[start_ind],
                )
                if not is_change:
                    is_change = True
                    if (
                        last_start != len(ranking) - (num_child + 1)
                        and best_ind == len(window) - 1
                    ):
                        last_start += len(window) - 1
            if start_ind == i:
                break
            if not is_change:
                last_start -= num_child
            start_ind -= num_child
            end_ind -= num_child
    return ranking


async def insertion(
    runner: WaveRunner,
    arr: List[Any],
    k: int,
    num_child: int,
    compare: SetCompare,
    presort: bool = True,
) -> List[Any]:
    """Setwise insertion: exploit the first-stage order as a prior
    (efficiency method beyond the reference, after "Beyond
    Reproducibility: ... Setwise Insertion", arXiv:2504.10509).

    The provisional top-k is the head of the initial ranking (optionally
    exact-sorted first). Remaining candidates are screened in groups of
    ``num_child`` against the current k-th item with ONE setwise
    comparison: if the k-th item wins, the whole group is pruned; when a
    candidate wins, it is placed by binary insertion (2-doc setwise
    comparisons) and the displaced k-th item drops out.

    With a perfect comparator and presort=True this returns the exact
    top-k in ~k*log(k)/log(c) + (n-k)/c + inserts*log2(k) comparisons —
    typically 2-3x fewer than heapsort's. presort=False trusts the prior
    head order entirely (the paper's cheaper variant).
    """
    n = len(arr)
    if k <= 0:
        return list(arr)
    if n <= k:
        return await heapsort(runner, list(arr), k, num_child, compare)
    top = list(arr[:k])
    if presort:
        top = await heapsort(runner, top, k, num_child, compare)
    rest = list(arr[k:])

    async def binary_insert(doc: Any) -> None:
        lo, hi = 0, len(top) - 1  # doc already beat top[-1]
        while lo < hi:
            mid = (lo + hi) // 2
            best = await compare([doc, top[mid]])
            if best == 0:
                hi = mid
            else:
                lo = mid + 1
        top.insert(lo, doc)
        top.pop()

    i = 0
    while i < len(rest):
        group = rest[i : i + num_child]
        i += len(group)
        while group:
            best = await compare([top[-1]] + group)
            if best <= 0 or best > len(group):
                break  # current k-th wins (or unparseable): prune group
            winner = group.pop(best - 1)
            await binary_insert(winner)
    top_ids = {id(d) for d in top}  # identity set: O(n + k), docs need not be hashable
    return top + [d for d in arr if id(d) not in top_ids]
