"""The port's host spans and padding counters (``utils.metering``'s tracer,
``ScoringEngine.pad_stats``) and their exports (``utils.profiling.trace``,
the CLI's ``run_done`` event).

Off, the tracer records nothing and reads no clock. On, a t5-tiny setwise
heapsort and a dec-tiny Rank-R1 rerank (one-go decode, chunks with a stop
string, a slot-refill session, speculative rounds) leave spans that nest
ranker -> wave -> engine call -> engine phases, one ``decode.step`` per step
each decode loop ran; tokens, logits and orders are those of the tracer off.
"""
import collections
import json
import os

import numpy as np
import pytest
import torch

from llmrankers_tpu_torch.cli import run as trun
from llmrankers_tpu_torch.engine import generate as gen_mod
from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import decoder as tdec
from llmrankers_tpu_torch.models import t5 as tt5
from llmrankers_tpu_torch.models.config import DecoderConfig, T5Config
from llmrankers_tpu_torch.rankers.rank_r1 import RankR1SetwiseLlmRanker
from llmrankers_tpu_torch.rankers.setwise import SetwiseLlmRanker
from llmrankers_tpu_torch.types import SearchResult
from llmrankers_tpu_torch.utils import metering, profiling

PROMPT_PACK = '''prompt_system = "Think, then answer."
prompt_user = """Query: "{query}"
{docs}
Answer in <answer></answer>."""
pattern = '<think>.*?</think>\\\\s*<answer>(.*?)</answer>'
'''


@pytest.fixture(autouse=True)
def _tracer_off(monkeypatch):
    monkeypatch.delenv("LLMRANKERS_NO_REFILL", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    metering.disable()
    metering.TRACER.spans, metering.TRACER.stack = [], []
    yield
    metering.disable()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def t5_model():
    cfg = T5Config.tiny()
    return cfg, tt5.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")


@pytest.fixture(scope="module")
def dec_model():
    cfg = DecoderConfig.tiny()
    return cfg, tdec.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")


def _t5_engine(t5_model):
    cfg, model = t5_model
    return ScoringEngine("t5", cfg, model, ByteTokenizer(cfg.vocab_size),
                         len_buckets=(128, 256, 512), batch_buckets=(4, 16))


def _rankings(n_queries=3, n_docs=12, words=4):
    queries = [f"what about topic {q}" for q in range(n_queries)]
    return queries, [
        [SearchResult(docid=f"q{q}d{i}", score=float(-i),
                      text=" ".join(f"topic{(i * 5 + q + w) % 13}" for w in range(words)))
         for i in range(n_docs)]
        for q in range(n_queries)]


def _traced(fn):
    metering.enable()
    try:
        out = fn()
    finally:
        metering.disable()
    return out, metering.take()


def _children(spans):
    kids = collections.defaultdict(list)
    for i, s in enumerate(spans):
        kids[s[3]].append(i)
    return kids


def _ancestors(spans, i):
    while spans[i][3] >= 0:
        i = spans[i][3]
        yield spans[i]


def _check_tree(spans):
    """Every span lies in its parent, one root per call, spans of one wave
    share its id, and every engine span sits under an ``engine.call``
    inside a ``ranker.batch``."""
    roots = [s for s in spans if s[3] < 0]
    assert roots and all(s[0] == "ranker.rerank_many" for s in roots)
    assert len({s[4] for s in roots}) == len(roots)
    waves = [i for i, s in enumerate(spans) if s[0] == "ranker.batch"]
    assert len({spans[i][5] for i in waves}) == len(waves)
    for i, (name, t0, t1, parent, call, wave) in enumerate(spans):
        assert t0 <= t1
        if parent >= 0:
            p = spans[parent]
            assert p[1] <= t0 and t1 <= p[2]
            assert name != p[0]  # a span inside one of its name merges into it
            assert call == p[4]
            if name != "ranker.batch":
                assert wave == p[5]
        if name.startswith("engine."):
            names = [a[0] for a in _ancestors(spans, i)]
            if name != "engine.call":
                assert "engine.call" in names
            assert "ranker.batch" in names
        if name in ("sched.sort", "ranker.batch"):
            assert spans[parent][0] == "ranker.rerank_many"
            assert (wave < 0) == (name == "sched.sort")
    return waves


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------
def test_span_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(metering.time, "perf_counter", no_clock)
    a, b = metering.span("a"), metering.span("b", opens="wave")
    assert a is b
    with a, metering.span("c"):
        pass
    assert metering.take() == []


def test_span_on_nests_merges_and_takes():
    metering.enable()
    with metering.span("r", opens="call"):
        with metering.span("w", opens="wave"):
            with metering.span("p"), metering.span("p"):
                pass
        with metering.span("w", opens="wave"):
            with pytest.raises(RuntimeError):
                metering.take()
    metering.disable()
    spans = metering.take()
    assert [s[0] for s in spans] == ["r", "w", "p", "w"]
    assert [s[3:] for s in spans] == [(-1, 0, -1), (0, 0, 0), (1, 0, 0), (0, 0, 1)]
    assert metering.take() == []
    with metering.span("x"):
        pass
    assert metering.take() == []


# ---------------------------------------------------------------------------
# Spans of a rerank
# ---------------------------------------------------------------------------
def test_t5_heapsort_spans(t5_model):
    queries, rankings = _rankings()
    plain = SetwiseLlmRanker(_t5_engine(t5_model), num_child=2, k=4, scoring="likelihood")
    want = plain.rerank_many(queries, rankings)
    eng = _t5_engine(t5_model)
    ranker = SetwiseLlmRanker(eng, num_child=2, k=4, scoring="likelihood")
    got, spans = _traced(lambda: ranker.rerank_many(queries, rankings))
    assert [[d.docid for d in r] for r in got] == [[d.docid for d in r] for r in want]
    waves = _check_tree(spans)
    names = collections.Counter(s[0] for s in spans)
    assert len(waves) == ranker.wave_stats["waves"]
    # One sort span before each wave and one after the last.
    assert names["sched.sort"] == len(waves) + 1
    assert names["engine.launch"] == eng.programs["t5_labels"]
    kids = _children(spans)
    for w in waves:
        assert [spans[k][0] for k in kids[w]] == ["ranker.prompts", "engine.call",
                                                  "ranker.outcomes"]
    rows = [[2 + (i * 7 + j) % 250 for j in range(30 + 9 * i)] for i in range(5)]
    labels = ranker.label_ids[:3]
    off = eng.score_labels(rows, labels, ranker.decoder_prefix)
    on, _ = _traced(lambda: eng.score_labels(rows, labels, ranker.decoder_prefix))
    np.testing.assert_array_equal(on, off)


def _r1_ranker(dec_model, tmp_path, route):
    cfg, model = dec_model
    kw = {"spec_lookup": 2} if route == "spec" else {}
    eng = ScoringEngine("decoder", cfg, model, ByteTokenizer(cfg.vocab_size),
                        len_buckets=(256, 512), batch_buckets=(4, 8), **kw)
    if route in ("refill", "spec"):
        eng._gen_row_limit = lambda rows, max_new: 1
    pack = tmp_path / "pack.toml"
    pack.write_text(PROMPT_PACK)
    chunk = None if route == "plain" else 4
    return eng, RankR1SetwiseLlmRanker(eng, str(pack), num_child=3, k=1,
                                       max_completion_tokens=8, chunk_tokens=chunk)


class _StepCount:
    """The steps each decode loop ran, from the loops' own arguments."""

    def __init__(self, monkeypatch):
        self.steps = 0
        for name, arg, pos in (("decoder_decode_chunk", "steps", 5),
                               ("decoder_decode_chunk_rr", "steps", 6),
                               ("decoder_spec_decode_chunk", "rounds", 7)):
            monkeypatch.setattr(gen_mod, name, self._wrap(getattr(gen_mod, name), arg, pos))

    def _wrap(self, fn, arg, pos):
        def counted(*args, **kw):
            self.steps += kw[arg] if arg in kw else args[pos]
            return fn(*args, **kw)
        return counted


@pytest.mark.parametrize("route", ["plain", "chunked", "refill", "spec"])
def test_rank_r1_generate_spans(dec_model, tmp_path, monkeypatch, route):
    if route == "chunked":
        monkeypatch.setenv("LLMRANKERS_NO_REFILL", "1")
    queries, rankings = _rankings(n_queries=2, n_docs=7, words=3)
    eng0, plain = _r1_ranker(dec_model, tmp_path, route)
    want = plain.rerank_many(queries, rankings)
    eng, ranker = _r1_ranker(dec_model, tmp_path, route)
    count = _StepCount(monkeypatch)
    got, spans = _traced(lambda: ranker.rerank_many(queries, rankings))
    assert [[d.docid for d in r] for r in got] == [[d.docid for d in r] for r in want]
    assert eng.programs == eng0.programs
    _check_tree(spans)
    names = collections.Counter(s[0] for s in spans)
    assert names["decode.step"] == count.steps > 0
    assert names["engine.emit"] > 0 and names["engine.readback"] > 0
    for i, s in enumerate(spans):
        if s[0] == "decode.step":
            assert "engine.call" in [a[0] for a in _ancestors(spans, i)]
    programs = {"plain": "dec_gen", "chunked": "dec_chunk", "refill": "dec_chunk_rr",
                "spec": "dec_spec_chunk"}
    assert any(p.startswith(programs[route]) for p in eng.programs)
    if route == "refill":
        assert eng.refill_stats["refills"] > 0
    rows = [[2 + (i * 11 + j) % 250 for j in range(20 + 5 * i)] for i in range(3)]
    off = eng.generate(rows, 6, stop_strings=("</answer>",), chunk_tokens=3)
    on, _ = _traced(lambda: eng.generate(rows, 6, stop_strings=("</answer>",),
                                         chunk_tokens=3))
    assert on == off


# ---------------------------------------------------------------------------
# Padding counters
# ---------------------------------------------------------------------------
def test_pad_stats_hand_counted(t5_model, dec_model):
    eng = _t5_engine(t5_model)
    eng.len_buckets, eng.batch_buckets = (8, 16), (4, 8)
    eng._pad_batch([[5] * 3, [5] * 5, [5] * 7])  # 4 x 8
    assert eng.pad_stats == {"real_tokens": 15, "slot_tokens": 32}
    eng._pad_batch([[5] * 10, [5] * 3], l_force=8)  # 4 x 8, the long row cut
    assert eng.pad_stats == {"real_tokens": 15 + 11, "slot_tokens": 64}
    eng._pad_batch([[5] * 6, [5] * 2, [1], [1], [1]], b_cap=5, n_real=2)  # 5 x 8
    assert eng.pad_stats == {"real_tokens": 26 + 8, "slot_tokens": 104}
    # One score_labels call: a 16-row bucket at the 128 rung.
    eng = _t5_engine(t5_model)
    rows = [[2 + j % 200 for j in range(40 + 3 * i)] for i in range(6)]
    eng.score_labels(rows, [3, 4])
    assert eng.pad_stats == {"real_tokens": sum(len(r) for r in rows),
                             "slot_tokens": 16 * 128}
    # A refill session: every row prefilled once, the session's B x P slots
    # and each refill batch's Br x P, its padding rows slots only.
    cfg, model = dec_model
    eng = ScoringEngine("decoder", cfg, model, ByteTokenizer(cfg.vocab_size),
                        len_buckets=(64,), batch_buckets=(4, 8))
    eng._gen_row_limit = lambda rows, max_new: 4
    rows = [[2 + (i * 37 + j * 11) % 250 for j in range(20 + 3 * i)] for i in range(7)]
    eng.generate(rows, 6, stop_strings=("</answer>",), chunk_tokens=2)
    assert eng.programs["dec_chunk_rr"] > 0 and eng.refill_stats["refills"] == 3
    assert eng.pad_stats == {"real_tokens": sum(len(r) for r in rows),
                             "slot_tokens": 4 * 64 + 3 * 1 * 64}


# ---------------------------------------------------------------------------
# Exports
# ---------------------------------------------------------------------------
def test_profiling_trace_shows_spans(t5_model, tmp_path):
    queries, rankings = _rankings(n_queries=1, n_docs=6)
    ranker = SetwiseLlmRanker(_t5_engine(t5_model), num_child=2, k=2, scoring="likelihood")
    assert not metering.TRACER.on
    with profiling.trace(str(tmp_path / "prof")) as path:
        with pytest.raises(RuntimeError):
            with profiling.trace(str(tmp_path / "again")):
                pass
        ranker.rerank_many(queries, rankings)
    assert not metering.TRACER.on and metering.TRACER.ranges is None
    assert metering.take() == []  # the session's spans are in the trace
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = collections.Counter(e["name"] for e in events
                                 if e.get("cat") == "user_annotation")
    assert ranges["ranker.rerank_many"] == 1
    assert ranges["engine.launch"] == ranges["ranker.batch"] > 0
    with profiling.trace(None) as none:
        assert none is None


def test_cli_event_log_carries_spans_and_pad_stats(tmp_path):
    queries, rankings = _rankings(n_queries=2, n_docs=6)
    (tmp_path / "q.tsv").write_text("".join(f"q{i}\t{q}\n" for i, q in enumerate(queries)))
    with open(tmp_path / "c.jsonl", "w") as f:
        for d in rankings[0] + rankings[1]:
            f.write(json.dumps({"docid": d.docid, "text": d.text}) + "\n")
    with open(tmp_path / "run.txt", "w") as f:
        for i, ranking in enumerate(rankings):
            for rank, d in enumerate(ranking):
                f.write(f"q{i} Q0 {d.docid} {rank + 1} {d.score} bm25\n")
    log, prof = tmp_path / "events.jsonl", tmp_path / "prof"
    args = trun.parse_args([
        "run", "--model_name_or_path", "random:t5-tiny", "--device", "cpu",
        "--dtype", "float32", "--run_path", str(tmp_path / "run.txt"),
        "--query_file", str(tmp_path / "q.tsv"), "--corpus_file", str(tmp_path / "c.jsonl"),
        "--save_path", str(tmp_path / "out.txt"), "--scoring", "likelihood",
        "--event_log", str(log), "--profile_dir", str(prof),
        "setwise", "--num_child", "2", "--method", "heapsort", "--k", "2"])
    trun.main(args)
    done = [json.loads(line) for line in open(log)][-1]
    assert done["event"] == "run_done"
    spans = done["spans"]
    assert spans["ranker.rerank_many"]["count"] == 1
    assert spans["engine.launch"]["count"] == spans["ranker.batch"]["count"] > 0
    assert all(v["seconds"] >= 0 for v in spans.values())
    pad = done["pad_stats"]
    assert 0 < pad["real_tokens"] < pad["slot_tokens"]
    assert done["graph_stats"] == {"captures": 0, "replays": 0, "eager_steps": 0}
    assert done["wave_stats"] == {"decodes": 0, "pieces": 0, "rows": 0, "slots": 0}
    assert os.listdir(prof) and not metering.TRACER.on
