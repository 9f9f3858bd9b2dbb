"""Host-side shared-prefix detection for decoder prompts.

Setwise/Rank-R1 comparison prompts share their (system + instruction +
query) head across the rows of a wave — across the comparisons of one
query and across ``num_permutation`` shuffled copies. The reference gets
this for free from vLLM's PagedAttention prefix caching
(llmrankers/setwise.py:450-454); here the engine detects shared prefixes
per chunk, prefills each unique prefix once, and rows gather their
group's K/V (engine/generate.py::decoder_prefix_kv).

Pure host code: token-list LCP grouping over a sorted view; row order is
never changed (rows keep their original indices via ``group_idx``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple


def _lcp(a: List[int], b: List[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def group_shared_prefixes(
    rows: List[List[int]],
    min_prefix: int = 32,
    min_saving: int = 256,
) -> Optional[Tuple[List[List[int]], List[int], List[List[int]]]]:
    """Partition rows into shared-prefix groups.

    Returns ``(prefixes, group_idx, suffixes)`` — one prefix per group,
    ``suffixes[i] = rows[i][len(prefix of its group):]`` in ORIGINAL row
    order — or ``None`` when sharing would save fewer than ``min_saving``
    prefix tokens (the grouped program then isn't worth its extra
    compile/gather cost and the caller uses the plain path).

    Every suffix is kept non-empty (the last real token carries the label
    logits), so a group's prefix is capped at ``len(row) - 1`` for all
    members.
    """
    n = len(rows)
    if n < 2:
        return None
    order = sorted(range(n), key=lambda i: rows[i])
    groups: List[Tuple[int, List[int]]] = []  # (prefix_len, member_indices)
    cur_members = [order[0]]
    cur_p = len(rows[order[0]]) - 1
    for prev, i in zip(order, order[1:]):
        p = min(cur_p, _lcp(rows[prev], rows[i]), len(rows[i]) - 1)
        if p >= min_prefix:
            cur_members.append(i)
            cur_p = p
        else:
            groups.append((max(cur_p, 0), cur_members))
            cur_members = [i]
            cur_p = len(rows[i]) - 1
    groups.append((max(cur_p, 0), cur_members))

    saving = sum(p * (len(m) - 1) for p, m in groups)
    if saving < min_saving:
        return None

    prefixes: List[List[int]] = []
    group_idx = [0] * n
    suffixes: List[List[int]] = [[] for _ in range(n)]
    for g, (p, members) in enumerate(groups):
        # Singleton groups get an EMPTY prefix (fully masked, zero length
        # offset) so their rows run exactly like the plain path — a stub
        # token would be attended as a real key and change results.
        plen = p if len(members) > 1 else 0
        prefixes.append(rows[members[0]][:plen])
        for i in members:
            group_idx[i] = g
            suffixes[i] = rows[i][plen:]
    return prefixes, group_idx, suffixes
