"""Seeded generation of a traffic mix's inputs: queries and first-stage
rankings of synthetic passages.

Every call of a run draws from its own stream (the run's seed and the call's
index), and every seed gives the same multiset of query and passage lengths,
in another order: the lengths are the quantiles of the mix's length
distribution. Passage lengths are dealt in strata: sorted, cut into as many
strata as a query has passages, and each query gets one length from each
stratum (which one, and in which first-stage position, by the seed). So
every query, and every prompt made of all its passages, is about as long
whatever the seed: seeds change which passage is long, never how much work a
call holds or which length bucket its prompts fall in. Texts are lowercase
words and spaces, one byte (one token of the byte tokenizer) per character.

A mix with ``relevance`` gives every passage a grade, written as its first
character: one of the ``markers`` (grade 0 first), a character that no
prompt holds elsewhere. A query's passages hold the grades of
``relevance_grades`` (each grade about as often), so every seed gets the
same grades in another order; ``bm25_weight`` sets how far the first-stage
order follows them (1: best first, 0: at random). The configuration's model
reads the marker (``drivers/setwise_likelihood.py``), so the sort's work
follows from the grades as a trained ranker's follows from relevance.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)


def length_quantiles(spec: Dict, n: int) -> np.ndarray:
    """``n`` lengths: the quantiles (i + 0.5) / n of a normal distribution
    with the spec's ``median`` and ``spread`` (its standard deviation),
    rounded and clipped to [``min``, ``max``]."""
    dist = NormalDist(spec["median"], spec["spread"])
    q = [dist.inv_cdf((i + 0.5) / n) for i in range(n)]
    return np.clip(np.rint(q), spec["min"], spec["max"]).astype(np.int64)


def text(rng: np.random.Generator, n: int) -> str:
    """``n`` bytes of words: letters with a space after every 2 to 9."""
    out = _LETTERS[rng.integers(0, 26, size=n)]
    gap = np.cumsum(rng.integers(3, 11, size=n // 3 + 2))
    gap = gap[gap < n - 1]
    out[gap] = ord(" ")
    return out.tobytes().decode("ascii")


def relevance_grades(rel: Dict, nd: int, rng: np.random.Generator) -> np.ndarray:
    """The grade of each of ``nd`` first-stage positions: the same multiset
    of grades whatever the seed, dealt by a key that mixes the position with
    a draw: ``w * position / nd + (1 - w) * uniform``, the smallest key
    getting the highest grade."""
    levels = len(rel["markers"])
    grades = (np.arange(nd) * levels) // nd
    w = float(rel["bm25_weight"])
    key = w * np.arange(nd) / nd + (1.0 - w) * rng.random(nd)
    out = np.empty(nd, dtype=np.int64)
    out[np.argsort(key, kind="stable")] = grades[::-1]
    return out


def call_inputs(mix: Dict, seed: int, index: int, stream: int = 0
                ) -> Tuple[List[str], List[List[Tuple[str, str]]]]:
    """The queries and first-stage rankings of call ``index``: one list of
    (docid, text) per query, in first-stage order. ``stream`` separates
    inputs drawn for other uses (warm-up) from the window's."""
    rng = np.random.default_rng([int(seed), stream, int(index)])
    nq, nd = mix["queries_per_call"], mix["docs_per_query"]
    q_len = rng.permutation(length_quantiles(mix["query_tokens"], nq))
    strata = np.sort(length_quantiles(mix["passage_tokens"], nq * nd)).reshape(nd, nq)
    dealt = np.stack([rng.permutation(row) for row in strata], axis=1)  # [nq, nd]
    queries, rankings = [], []
    for qi in range(nq):
        # A distinct first word per query, as real queries of one batch have.
        queries.append(f"q{index}x{qi} " + text(rng, int(q_len[qi])))
        d_len = rng.permutation(dealt[qi])
        docs = [text(rng, int(d_len[d])) for d in range(nd)]
        if "relevance" in mix:
            marks = mix["relevance"]["markers"]
            grade = relevance_grades(mix["relevance"], nd, rng)
            docs = [marks[g] + t[1:] for g, t in zip(grade, docs)]
        rankings.append([(f"c{index}q{qi}d{d}", t) for d, t in enumerate(docs)])
    return queries, rankings
