"""Port parity of the Rank-R1 setwise ranker and of setwise generation
scoring on decoder-only models.

- ``RankR1SetwiseLlmRanker`` (the port's ``rankers/rank_r1.py``) against the
  JAX ranker on the same parameter tree (fp32, tiny decoder): the final
  orders docid for docid and the token meters, on both setwise-R1 prompt
  packs (the port's copies), on the left-padded and the prefix-cache paths,
  with a quantized KV cache. Both engines run off their slot-refill
  sessions (``LLMRANKERS_NO_REFILL=1``; ``tests/test_torch_refill.py``
  checks those).
- The completion parsing and vote with scripted completions (the cases of
  ``tests/test_reference_parity_r1.py``): the port's decision equals the JAX
  ranker's on each.
- ``SetwiseLlmRanker(scoring="generation")`` on a decoder, with one
  permutation and with permutation voting: orders and meters equal.
- The CLI's ``--prompt_file`` with ``--kv_quantize int4`` on ``random:dec-tiny``
  writes the JAX CLI's file, also with ``--spec_lookup 4``; what is not
  ported raises (Rank-R1 listwise: A6; adapters: A10).
"""
import dataclasses
import json
import os
import random

import numpy as np
import pytest
import torch

import jax

from llmrankers_tpu.engine.engine import ScoringEngine as JaxEngine
from llmrankers_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmrankers_tpu.models import decoder as jdec
from llmrankers_tpu.models.config import DecoderConfig as JaxDecoderConfig
from llmrankers_tpu.rankers import SetwiseLlmRanker as JaxSetwise
from llmrankers_tpu.rankers.rank_r1 import RankR1SetwiseLlmRanker as JaxR1
from llmrankers_tpu.types import RerankStats as JaxStats
from llmrankers_tpu.types import SearchResult as JaxResult
from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import decoder as tdec
from llmrankers_tpu_torch.models.config import DecoderConfig
from llmrankers_tpu_torch.rankers import rank_r1 as tr1
from llmrankers_tpu_torch.rankers.setwise import SetwiseLlmRanker, _SetRequest
from llmrankers_tpu_torch.types import RerankStats, SearchResult

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKS = os.path.join(ROOT, "llmrankers_tpu_torch", "prompts")


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setenv("LLMRANKERS_NO_REFILL", "1")


@pytest.fixture(scope="module")
def tree():
    jcfg = JaxDecoderConfig.tiny(attention_bias=True)
    tree = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.RandomState(3)
    for key in ("bq", "bk", "bv"):
        tree["layers"][key] = (0.3 * rng.randn(*tree["layers"][key].shape)).astype(np.float32)
    return tree


def _engines(tree, **kw):
    jcfg = JaxDecoderConfig.tiny(attention_bias=True)
    tcfg = DecoderConfig.tiny(attention_bias=True)
    jeng = JaxEngine("decoder", jcfg, jax.tree.map(jax.numpy.asarray, tree),
                     JaxByteTokenizer(jcfg.vocab_size), **kw)
    teng = ScoringEngine("decoder", tcfg, tdec.params_from_jax(tree, tcfg, device="cpu"),
                         ByteTokenizer(tcfg.vocab_size), **kw)
    return jeng, teng


def _workload(n_queries=2, n_docs=9, seed=13):
    rng = np.random.RandomState(seed)
    words = ["w%02d" % i for i in range(60)]
    queries = [" ".join(rng.choice(words, 4)) for _ in range(n_queries)]
    docs = [[(f"d{i}", " ".join(rng.choice(words, 8))) for i in range(n_docs)]
            for _ in range(n_queries)]
    return queries, docs


def _rerank(ranker, result_cls, queries, docs):
    out = ranker.rerank_many(queries, [[result_cls(d, 0.0, t) for d, t in ds] for ds in docs])
    stats = ranker.stats
    return ([[(d.docid, d.score) for d in r] for r in out],
            (stats.comparisons, stats.prompt_tokens, stats.completion_tokens))


@pytest.mark.parametrize("pack,engine_kw", [
    ("prompt_setwise-R1.toml", dict(prefix_share=False)),
    ("prompt_setwise-R1-v0.2.toml", dict(kv_quantize="int8")),
])
def test_rank_r1_setwise_matches_jax(tree, pack, engine_kw):
    jeng, teng = _engines(tree, **engine_kw)
    queries, docs = _workload()
    kw = dict(num_child=3, k=4, max_completion_tokens=24)
    want = _rerank(JaxR1(jeng, os.path.join(ROOT, "llmrankers_tpu", "prompts", pack), **kw),
                   JaxResult, queries, docs)
    got = _rerank(tr1.RankR1SetwiseLlmRanker(teng, os.path.join(PACKS, pack), **kw),
                  SearchResult, queries, docs)
    assert got == want
    assert set(teng.programs) == {key[0] for key in jeng._jit_cache}


SCRIPTED = [
    (["<THINK>because</THINK> <ANSWER>[2]</ANSWER>"], [[0, 1, 2, 3]], 4),
    (["<think>x</think><answer>[1]</answer>"], [[2, 0, 1]], 3),
    (["<think>x</think><answer>[9]</answer>"], [[0, 1, 2, 3]], 4),
    (["no tags at all"], [[0, 1, 2]], 3),
    (["<answer>[2]</answer>"], [[0, 1, 2]], 3),
    (["<think>a</think><answer>[1]</answer>", "<think>b</think><answer>[3]</answer>",
      "<think>c</think><answer>[1]</answer>"], [[2, 0, 1], [0, 1, 2], [1, 2, 0]], 3),
    (["<think>a</think><answer>[1]</answer>", "<think>b</think><answer>[2]</answer>"],
     [[0, 1, 2], [0, 1, 2]], 3),  # a tie: the seeded rng breaks it
]


def _scripted(cls, stats_cls, result_cls, request_cls, completions, perms, n_docs, pack):
    """One comparison through ``_compare_batch`` with the engine's generate
    stubbed to return the scripted completions."""
    class _Engine:
        kind = "decoder"

        class tokenizer:  # noqa: N801
            @staticmethod
            def apply_chat_template(messages, add_generation_prompt=True):
                return " ".join(m["content"] for m in messages)

            @staticmethod
            def encode(text, add_special_tokens=True):
                return [1, 2, 3]

        def generate(self, rows, max_new_tokens, stop_strings=(), adapter=None,
                     chunk_tokens=None):
            assert stop_strings == ("</answer>",) and len(rows) == len(completions)
            return list(completions), [len(c) for c in completions]

    r = cls.__new__(cls)
    r.engine, r.adapter, r.verbose = _Engine(), None, False
    r.temperature, r.chunk_tokens = 0.0, None
    with open(pack, "rb") as f:
        import tomllib
        r.prompt = tomllib.load(f)
    r.num_permutation, r.max_completion_tokens = len(completions), 64
    r.rng = random.Random(929)
    draws = iter([list(p) for p in perms])
    if len(completions) > 1:
        r.rng.sample = lambda pop, k: next(draws)
    r._query_stats = {0: stats_cls()}
    r._query_adapters = None
    docs = [result_cls(f"d{i}", 0.0, f"text {i}") for i in range(n_docs)]
    if len(completions) == 1:
        docs = [docs[j] for j in perms[0]]
    return r._compare_batch([request_cls(0, "q", docs)])[0]


@pytest.mark.parametrize("completions,perms,n_docs", SCRIPTED)
def test_r1_scripted_decisions_match_jax(completions, perms, n_docs):
    from llmrankers_tpu.rankers.setwise import _SetRequest as JaxRequest

    pack = os.path.join(PACKS, "prompt_setwise-R1.toml")
    want = _scripted(JaxR1, JaxStats, JaxResult, JaxRequest, completions, perms, n_docs, pack)
    got = _scripted(tr1.RankR1SetwiseLlmRanker, RerankStats, SearchResult, _SetRequest,
                    completions, perms, n_docs, pack)
    assert got == want


@pytest.mark.parametrize("num_permutation", [1, 3])
def test_setwise_generation_on_decoder_matches_jax(tree, num_permutation):
    """Setwise generation scoring (one greedy token per prompt in the chat
    template) on a decoder: orders and meters equal, the permutation copies
    drawn from the same seeded stream."""
    jeng, teng = _engines(tree, kv_quantize="int4")
    queries, docs = _workload(n_docs=7, seed=5)
    kw = dict(num_child=2, k=3, scoring="generation", num_permutation=num_permutation)
    want = _rerank(JaxSetwise(jeng, **kw), JaxResult, queries, docs)
    got = _rerank(SetwiseLlmRanker(teng, **kw), SearchResult, queries, docs)
    assert got == want
    assert set(teng.programs) == {key[0] for key in jeng._jit_cache}


def test_cli_rank_r1_matches_jax(tmp_path, monkeypatch):
    """The port's CLI with --prompt_file and --kv_quantize int4 on
    random:dec-tiny against the JAX CLI, same argv, same JAX draw of
    weights."""
    _cli_matches_jax(tmp_path, monkeypatch)


def _cli_matches_jax(tmp_path, monkeypatch, *run_flags):
    """The Rank-R1 setwise CLI of both packages with the same argv (plus
    ``run_flags``) and the JAX draw of weights: the same output file."""
    from llmrankers_tpu.cli import run as jrun
    from llmrankers_tpu_torch.cli import run as trun

    (tmp_path / "q.tsv").write_text("".join(f"q{i}\tquery about topic {i}\n" for i in range(2)))
    (tmp_path / "c.jsonl").write_text("".join(
        json.dumps({"id": f"d{d}", "text": f"this passage talks about topic {d}"}) + "\n"
        for d in range(8)))
    (tmp_path / "run.txt").write_text("".join(
        f"q{i} Q0 d{d} {d + 1} {100 - d} bm25\n" for i in range(2) for d in range(8)))

    def argv(pkg):
        return ["run", "--model_name_or_path", "random:dec-tiny",
                "--run_path", str(tmp_path / "run.txt"), "--query_file", str(tmp_path / "q.tsv"),
                "--corpus_file", str(tmp_path / "c.jsonl"),
                "--save_path", str(tmp_path / "out.txt"), "--device", "cpu",
                "--dtype", "float32", "--kv_quantize", "int4", *run_flags,
                "--prompt_file", os.path.join(ROOT, pkg, "prompts", "prompt_setwise-R1.toml"),
                "setwise", "--num_child", "7", "--k", "2", "--max_completion_tokens", "16"]

    def jax_init(cfg, gen, dtype, device):
        jcfg = JaxDecoderConfig(**{f.name: getattr(cfg, f.name)
                                   for f in dataclasses.fields(JaxDecoderConfig)})
        t = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.PRNGKey(929)))
        return tdec.params_from_jax(t, cfg, dtype=dtype, device=device)

    monkeypatch.setattr(tdec, "init_params", jax_init)
    jrun.main(jrun.parse_args(argv("llmrankers_tpu")))
    want = (tmp_path / "out.txt").read_text()
    (tmp_path / "out.txt").unlink()
    report = trun.main(trun.parse_args(argv("llmrankers_tpu_torch")))
    assert (tmp_path / "out.txt").read_text() == want
    assert report.total.completion_tokens > 0


def test_unported_rank_r1_paths_raise(tree, tmp_path, monkeypatch):
    from llmrankers_tpu_torch.cli import run as trun

    _, teng = _engines(tree)
    pack = os.path.join(PACKS, "prompt_setwise-R1.toml")
    with pytest.raises(NotImplementedError, match="A6"):
        tr1.RankR1ListwiseLlmRanker(teng, pack)
    with pytest.raises(NotImplementedError, match="A10"):
        tr1.RankR1SetwiseLlmRanker(teng, pack, adapter="lora")
    args = trun.parse_args(["run", "--model_name_or_path", "random:dec-tiny", "--device",
                            "cpu", "--prompt_file", pack, "listwise"])
    with pytest.raises(NotImplementedError, match="A6"):
        trun.main(args)
    # Speculative decoding is ported: the CLI with --spec_lookup 4 ranks as
    # the JAX CLI does, docid for docid. Its thousands of small ops run on
    # one intra-op thread, so as not to oversubscribe the cores beside other
    # test processes.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _cli_matches_jax(tmp_path, monkeypatch, "--spec_lookup", "4")
    finally:
        torch.set_num_threads(threads)
