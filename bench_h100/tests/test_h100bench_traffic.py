"""The seeded traffic generator: the same seed gives the same inputs,
another seed other inputs with the same multiset of lengths and grades."""
from collections import Counter

import numpy as np
import pytest

from harness import traffic

MIX = {"queries_per_call": 4, "docs_per_query": 25,
       "query_tokens": {"min": 8, "max": 32, "median": 18, "spread": 6},
       "passage_tokens": {"min": 32, "max": 128, "median": 80, "spread": 24}}
BIG = 2**31 + 17


def _lengths(call):
    queries, rankings = call
    return (Counter(len(q.split(" ", 1)[1]) for q in queries),
            Counter(len(t) for docs in rankings for _, t in docs))


def test_same_seed_same_inputs():
    assert traffic.call_inputs(MIX, BIG, 3) == traffic.call_inputs(MIX, BIG, 3)


def test_other_seed_other_inputs_same_sizes():
    a, b = traffic.call_inputs(MIX, BIG, 0), traffic.call_inputs(MIX, BIG + 1, 0)
    assert a != b
    assert _lengths(a) == _lengths(b)


def test_calls_and_streams_differ():
    base = traffic.call_inputs(MIX, BIG, 0)
    assert traffic.call_inputs(MIX, BIG, 1) != base
    assert traffic.call_inputs(MIX, BIG, 0, stream=1) != base


def test_lengths_follow_the_mix():
    lens = traffic.length_quantiles(MIX["passage_tokens"], 1000)
    assert lens.min() >= 32 and lens.max() <= 128
    assert abs(sorted(lens)[500] - 80) <= 1
    _, rankings = traffic.call_inputs(MIX, 5, 0)
    for docs in rankings:
        for docid, text in docs:
            assert set(text) <= set("abcdefghijklmnopqrstuvwxyz ")


MARKS = "#$%&*+;<=>@^DEFHIJKLMNQRSTUVWXYZ"


def _graded(weight):
    return dict(MIX, relevance={"markers": MARKS, "bm25_weight": weight})


def test_grades_lead_each_passage_and_keep_their_multiset():
    a, b = traffic.call_inputs(_graded(0.45), BIG, 0), traffic.call_inputs(_graded(0.45), BIG + 1, 0)
    assert _lengths(a) == _lengths(b)
    for (_, ra), (_, rb) in ((a, b),):
        for da, db in zip(ra, rb):
            ga = sorted(MARKS.index(t[0]) for _, t in da)
            assert ga == sorted(MARKS.index(t[0]) for _, t in db)
            assert ga == [(i * len(MARKS)) // len(da) for i in range(len(da))]
            assert all(set(t[1:]) <= set("abcdefghijklmnopqrstuvwxyz ") for _, t in da)


@pytest.mark.parametrize("weight,order", [(1.0, "best first"), (0.0, "at random")])
def test_bm25_weight_sets_how_far_the_first_stage_follows_the_grades(weight, order):
    rng = np.random.default_rng(3)
    g = traffic.relevance_grades({"markers": MARKS, "bm25_weight": weight}, 100, rng)
    rho = np.corrcoef(g, -np.arange(100))[0, 1]
    assert (rho > 0.99) if order == "best first" else (abs(rho) < 0.4)
