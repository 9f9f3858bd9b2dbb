"""Port parity, end to end: setwise likelihood reranking on t5-tiny and on
the tiny decoder-only presets.

The JAX ranker on the JAX engine and the port's ranker on the port's engine,
with the same weights, must return the same final orders, docid for docid.
Then the port's CLI runs on a synthetic TREC run and docstore: with the byte
tokenizer, with ``--quantize int8``, and with a local HF tokenizer directory;
on ``random:dec-tiny`` and ``random:mistral-tiny`` its output file must equal
the JAX CLI's, given the JAX CLI's random weights.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from llmrankers_tpu.engine.engine import ScoringEngine as JaxEngine
from llmrankers_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmrankers_tpu.engine.tokenizer import HFTokenizer as JaxHFTokenizer
from llmrankers_tpu.models import decoder as jdec
from llmrankers_tpu.models import t5 as jt5
from llmrankers_tpu.models.config import DecoderConfig as JaxDecoderConfig
from llmrankers_tpu.models.config import T5Config
from llmrankers_tpu.rankers import SetwiseLlmRanker as JaxSetwise
from llmrankers_tpu.types import SearchResult
from llmrankers_tpu_torch.cli import run as trun
from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer, HFTokenizer
from llmrankers_tpu_torch.models import decoder as tdec
from llmrankers_tpu_torch.models import t5 as tt5
from llmrankers_tpu_torch.models.config import DecoderConfig as TorchDecoderConfig
from llmrankers_tpu_torch.models.config import T5Config as TorchT5Config
from llmrankers_tpu_torch.rankers.prompts import CHARACTERS
from llmrankers_tpu_torch.rankers.setwise import SetwiseLlmRanker

LADDERS = dict(len_buckets=(128, 256, 512), batch_buckets=(4, 16))


def _torch_cfg(cfg):
    """The port's own T5Config with the fields of a JAX one."""
    return TorchT5Config(**dataclasses.asdict(cfg))


@pytest.fixture(autouse=True)
def _fp32_reference(monkeypatch):
    # fp32 reference numerics: no TF32 in any matmul.
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.fixture(scope="module")
def engines():
    cfg = T5Config.tiny()
    tree = jax.tree.map(np.asarray, jt5.init_params(cfg, jax.random.PRNGKey(3)))
    jeng = JaxEngine("t5", cfg, jax.tree.map(jax.numpy.asarray, tree),
                     JaxByteTokenizer(cfg.vocab_size), **LADDERS)
    tcfg = _torch_cfg(cfg)
    teng = ScoringEngine("t5", tcfg, tt5.params_from_jax(tree, tcfg, device="cpu"),
                         ByteTokenizer(cfg.vocab_size), **LADDERS)
    return jeng, teng


def _queries(n_docs=16):
    queries = ["what about topic 3", "tell me of topic 11", "topic 7 please"]
    rankings = [
        [SearchResult(docid=f"q{qi}d{i}", score=float(-i),
                      text=f"this passage talks about topic {(i * 5 + qi) % n_docs}")
         for i in range(n_docs)]
        for qi in range(len(queries))
    ]
    return queries, rankings


@pytest.mark.parametrize("method,num_child,k", [("heapsort", 2, 10),
                                                ("heapsort", 3, 4),
                                                ("bubblesort", 3, 2),
                                                ("insertion", 2, 5)])
def test_setwise_orders_match_jax(engines, method, num_child, k):
    jeng, teng = engines
    queries, rankings = _queries()
    kw = dict(num_child=num_child, k=k, scoring="likelihood", method=method)
    jr, tr = JaxSetwise(jeng, **kw), SetwiseLlmRanker(teng, **kw)
    want = jr.rerank_many(queries, rankings)
    got = tr.rerank_many(queries, rankings)
    assert [[d.docid for d in r] for r in got] == [[d.docid for d in r] for r in want]
    assert [d.score for d in got[0]] == [d.score for d in want[0]]
    assert tr.stats.comparisons == jr.stats.comparisons > 0
    assert tr.stats.prompt_tokens == jr.stats.prompt_tokens
    assert tr.wave_stats == jr.wave_stats


def test_setwise_label_ids_and_prefix_match_jax(engines):
    jeng, teng = engines
    jr = JaxSetwise(jeng, scoring="likelihood")
    tr = SetwiseLlmRanker(teng, scoring="likelihood")
    assert tr.decoder_prefix == jr.decoder_prefix
    assert tr.label_ids == jr.label_ids


def test_generation_scoring_reaches_unported_generate(engines):
    _, teng = engines
    with pytest.raises(NotImplementedError, match="A6"):
        SetwiseLlmRanker(teng, num_child=2, k=2, scoring="generation")


def _write_inputs(tmp_path, n_q=2, n_docs=10):
    (tmp_path / "q.tsv").write_text(
        "".join(f"q{i}\tquery about topic {i}\n" for i in range(n_q)))
    with open(tmp_path / "c.jsonl", "w") as f:
        for d in range(n_docs):
            f.write(json.dumps({"id": f"d{d}",
                                "text": f"this passage talks about topic {d}"}) + "\n")
    (tmp_path / "run.txt").write_text("".join(
        f"q{i} Q0 d{d} {d + 1} {100 - d} bm25\n"
        for i in range(n_q) for d in range(n_docs)))


def _argv(tmp_path, *extra, model="random:t5-tiny"):
    return ["run", "--model_name_or_path", model,
            "--run_path", str(tmp_path / "run.txt"),
            "--query_file", str(tmp_path / "q.tsv"),
            "--corpus_file", str(tmp_path / "c.jsonl"),
            "--save_path", str(tmp_path / "out.txt"),
            "--scoring", "likelihood", *extra,
            "setwise", "--num_child", "2", "--method", "heapsort", "--k", "3"]


def test_cli_reranks_trec_run(tmp_path, capsys):
    _write_inputs(tmp_path)
    args = trun.parse_args(_argv(tmp_path, "--device", "cpu", "--dtype", "float32"))
    report = trun.main(args)
    lines = (tmp_path / "out.txt").read_text().splitlines()
    assert len(lines) == 20
    for qi in range(2):
        rows = [ln.split() for ln in lines if ln.startswith(f"q{qi}\t")]
        assert sorted(r[2] for r in rows) == sorted(f"d{d}" for d in range(10))
        assert [int(r[3]) for r in rows] == list(range(1, 11))
        assert all(r[5] == "LLMRankers" for r in rows)
    assert report.n_queries == 2 and report.total.comparisons > 0
    assert "Avg comparisons:" in capsys.readouterr().out


def test_cli_raises_on_unported_flags(tmp_path):
    """A flag whose feature is not ported raises with its ROADMAP item;
    ``--spec_lookup`` is ported and, on T5, raises the JAX CLI's error."""
    from llmrankers_tpu.cli import run as jrun

    _write_inputs(tmp_path)
    args = trun.parse_args(_argv(tmp_path, "--device", "cpu", "--cohorts", "2"))
    with pytest.raises(NotImplementedError, match="A15"):
        trun.main(args)
    argv = _argv(tmp_path, "--device", "cpu", "--spec_lookup", "4")
    with pytest.raises(ValueError, match="spec_lookup targets decoder generation"):
        jrun.main(jrun.parse_args(argv))
    with pytest.raises(ValueError, match="spec_lookup targets decoder generation"):
        trun.main(trun.parse_args(argv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_reranks_int8(tmp_path, dtype):
    _write_inputs(tmp_path)
    args = trun.parse_args(_argv(tmp_path, "--device", "cpu", "--dtype", dtype,
                                 "--quantize", "int8"))
    engine = trun.make_engine(args.run)
    assert engine.model.quantized and "qkv" in engine.model.encoder.layers[0]
    report = trun.main(args)
    rows = [ln.split() for ln in (tmp_path / "out.txt").read_text().splitlines()]
    assert len(rows) == 20
    for qi in range(2):
        got = [r for r in rows if r[0] == f"q{qi}"]
        assert sorted(r[2] for r in got) == sorted(f"d{d}" for d in range(10))
        assert [int(r[3]) for r in got] == list(range(1, 11))
    assert report.total.comparisons > 0


def test_cli_int4_on_t5_raises(tmp_path):
    _write_inputs(tmp_path)
    args = trun.parse_args(_argv(tmp_path, "--device", "cpu", "--quantize", "int4"))
    with pytest.raises(ValueError, match="int4.*decoder models"):
        trun.main(args)


def test_cli_default_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _write_inputs(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(trun.parse_args(_argv(tmp_path)))


def _hf_tokenizer_dir(path, extra_words=0):
    """A word-level HF tokenizer saved to ``path``: the setwise prompt's
    words, the labels and the docstore's words, anything else <unk>."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["<pad>", "</s>", "<unk>", "Passage", *CHARACTERS, "this",
             "passage", "talks", "about", "topic", "query", *map(str, range(20)),
             *(f"w{i}" for i in range(extra_words))]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(path)
    return str(path)


def test_hf_tokenizer_matches_jax(tmp_path):
    path = _hf_tokenizer_dir(tmp_path / "tok")
    t, j = HFTokenizer(path), JaxHFTokenizer(path)
    assert (t.pad_id, t.eos_id, t.vocab_size) == (j.pad_id, j.eos_id, j.vocab_size)
    for text in ("<pad> Passage B", "this passage talks about topic 7", "odd words"):
        for special in (True, False):
            assert t.encode(text, special) == j.encode(text, special)
        ids = j.encode(text)
        assert t.decode(ids) == j.decode(ids)
        assert t.truncate(text, 3) == j.truncate(text, 3)


def test_cli_reranks_with_hf_tokenizer(tmp_path):
    _write_inputs(tmp_path)
    path = _hf_tokenizer_dir(tmp_path / "tok")
    args = trun.parse_args(_argv(tmp_path, "--device", "cpu", "--dtype", "float32",
                                 "--tokenizer_name_or_path", path))
    engine = trun.make_engine(args.run)
    assert isinstance(engine.tokenizer, HFTokenizer)
    report = trun.main(args)
    rows = [ln.split() for ln in (tmp_path / "out.txt").read_text().splitlines()]
    assert sorted(r[2] for r in rows if r[0] == "q0") == sorted(f"d{d}" for d in range(10))
    assert report.total.comparisons > 0
    # A tokenizer larger than the preset's vocabulary cannot index its embedding.
    big = _hf_tokenizer_dir(tmp_path / "big", extra_words=T5Config.tiny().vocab_size)
    args = trun.parse_args(_argv(tmp_path, "--device", "cpu",
                                 "--tokenizer_name_or_path", big))
    with pytest.raises(ValueError, match="vocabulary"):
        trun.make_engine(args.run)


# ---------------------------------------------------------------------------
# Decoder-only setwise
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dec_engines():
    jcfg, tcfg = JaxDecoderConfig.tiny(), TorchDecoderConfig.tiny()
    tree = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.PRNGKey(5)))
    jeng = JaxEngine("decoder", jcfg, jax.tree.map(jax.numpy.asarray, tree),
                     JaxByteTokenizer(jcfg.vocab_size), **LADDERS)
    teng = ScoringEngine("decoder", tcfg, tdec.params_from_jax(tree, tcfg, device="cpu"),
                         ByteTokenizer(tcfg.vocab_size), **LADDERS)
    return jeng, teng


@pytest.mark.parametrize("method,num_child,k", [("heapsort", 2, 10),
                                                ("heapsort", 3, 4),
                                                ("insertion", 2, 5)])
def test_decoder_setwise_orders_match_jax(dec_engines, method, num_child, k):
    jeng, teng = dec_engines
    queries, rankings = _queries()
    kw = dict(num_child=num_child, k=k, scoring="likelihood", method=method)
    jr, tr = JaxSetwise(jeng, **kw), SetwiseLlmRanker(teng, **kw)
    assert tr.decoder_prefix == jr.decoder_prefix == []
    assert tr.label_ids == jr.label_ids
    want = jr.rerank_many(queries, rankings)
    got = tr.rerank_many(queries, rankings)
    assert [[d.docid for d in r] for r in got] == [[d.docid for d in r] for r in want]
    assert tr.stats.comparisons == jr.stats.comparisons > 0
    assert tr.stats.prompt_tokens == jr.stats.prompt_tokens
    assert tr.wave_stats == jr.wave_stats
    assert teng.pkv_stats == jeng.pkv_stats


@pytest.mark.parametrize("preset", ["dec-tiny", "mistral-tiny"])
def test_cli_decoder_orders_match_jax(tmp_path, monkeypatch, preset):
    """The port's CLI against the JAX CLI on the same argv. The JAX CLI
    draws its random weights with jax.random, so the port's init is pointed
    at the same JAX draw, carried across with params_from_jax."""
    from llmrankers_tpu.cli import run as jrun

    _write_inputs(tmp_path, n_q=2, n_docs=12)
    argv = _argv(tmp_path, "--device", "cpu", "--dtype", "float32", model=f"random:{preset}")

    def jax_init(cfg, gen, dtype, device):
        jcfg = JaxDecoderConfig(**dataclasses.asdict(cfg))
        tree = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.PRNGKey(929)))
        return tdec.params_from_jax(tree, cfg, dtype=dtype, device=device)

    monkeypatch.setattr(tdec, "init_params", jax_init)
    jrun.main(jrun.parse_args(argv))
    want = (tmp_path / "out.txt").read_text()
    (tmp_path / "out.txt").unlink()
    report = trun.main(trun.parse_args(argv))
    got = (tmp_path / "out.txt").read_text()
    assert len(got.splitlines()) == 24 and got == want
    assert report.total.comparisons > 0


def test_chat_templates_match_jax(tmp_path):
    msgs = [{"role": "user", "content": "Given a query, which passage?"}]
    for add in (True, False):
        assert (ByteTokenizer(512).apply_chat_template(msgs, add)
                == JaxByteTokenizer(512).apply_chat_template(msgs, add))
    from llmrankers_tpu.engine.tokenizer import VICUNA_CHAT_TEMPLATE as JAX_VICUNA

    from llmrankers_tpu_torch.engine.tokenizer import VICUNA_CHAT_TEMPLATE

    assert VICUNA_CHAT_TEMPLATE == JAX_VICUNA
    path = _hf_tokenizer_dir(tmp_path / "vicuna-7b-v1.5")
    t, j = HFTokenizer(path), JaxHFTokenizer(path)
    assert t.tk.chat_template == j.tk.chat_template == VICUNA_CHAT_TEMPLATE
    msgs = [{"role": "system", "content": "Be brief."}] + msgs
    for add in (True, False):
        assert t.apply_chat_template(msgs, add) == j.apply_chat_template(msgs, add)
