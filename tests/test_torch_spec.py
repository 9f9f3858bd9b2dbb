"""Port parity of prompt-lookup speculative decoding: the port's
``decoder_spec_decode_chunk`` and ``ScoringEngine(spec_lookup=K)`` against
the JAX package.

- ``decoder_spec_decode_chunk`` against JAX's on the same cache and history
  (tiny decoder, f32, ``params_from_jax``, repetitive rows from a numpy
  seed, so drafts hit): tokens, counts, write positions, key mask, history
  and caches equal, over a cache in f32, int8 and int4 and with a window.
- End to end, the cases of ``tests/test_spec.py`` on the dispatch route
  (``LLMRANKERS_NO_REFILL=1`` for both engines): distinct rows, a shared
  prefix, int8/int4 KV, a zero-weight model that accepts more than one
  token a round, EOS and stop strings: texts, counts, ``spec_stats`` and the
  programs equal the JAX engine's, and the texts equal greedy decoding's.
- Rank-R1 setwise with ``spec_lookup=4`` orders as the JAX ranker does;
  with no stop strings and the tokenizer's EOS the model's, the pipelined
  loop gives greedy decoding's tokens; sampling with ``spec_lookup`` and
  ``spec_lookup`` on T5 raise as in JAX.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmrankers_tpu.engine import generate as jgen
from llmrankers_tpu.engine.engine import ScoringEngine as JaxEngine
from llmrankers_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmrankers_tpu.models import decoder as jdec
from llmrankers_tpu.models.config import DecoderConfig as JaxDecoderConfig
from llmrankers_tpu.rankers.rank_r1 import RankR1SetwiseLlmRanker as JaxR1
from llmrankers_tpu.types import SearchResult as JaxResult
from llmrankers_tpu_torch.engine import generate as tgen
from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import decoder as tdec
from llmrankers_tpu_torch.models import t5 as tt5
from llmrankers_tpu_torch.models.config import DecoderConfig, T5Config
from llmrankers_tpu_torch.rankers import rank_r1 as tr1
from llmrankers_tpu_torch.types import SearchResult

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setenv("LLMRANKERS_NO_REFILL", "1")
    # The tiny model runs thousands of small ops: one intra-op thread keeps
    # the test from oversubscribing the cores beside other test processes.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees():
    out = {}
    for window in (None, 24):
        jcfg = dataclasses.replace(JaxDecoderConfig.tiny(), sliding_window=window)
        out[window] = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.PRNGKey(0)))
    return out


def _pair(tree, window=None, eos=None, **kw):
    jcfg = dataclasses.replace(JaxDecoderConfig.tiny(), sliding_window=window)
    tcfg = dataclasses.replace(DecoderConfig.tiny(), sliding_window=window)
    if eos is not None:
        jcfg = dataclasses.replace(jcfg, eos_token_id=eos)
        tcfg = dataclasses.replace(tcfg, eos_token_id=eos)
    jeng = JaxEngine("decoder", jcfg, jax.tree.map(jnp.asarray, tree),
                     JaxByteTokenizer(jcfg.vocab_size), **kw)
    teng = ScoringEngine("decoder", tcfg, tdec.params_from_jax(tree, tcfg, device="cpu"),
                         ByteTokenizer(tcfg.vocab_size), **kw)
    return jeng, teng


def _same(trees, rows, window=None, engine_kw=None, **gkw):
    """The spec engines of both packages and the port's greedy engine on
    ``rows``: texts and counts equal, stats and programs equal."""
    engine_kw = engine_kw or {}
    jeng, teng = _pair(trees[window], window, spec_lookup=4, **engine_kw)
    want = jeng.generate(rows, **gkw)
    got = teng.generate(rows, **gkw)
    assert got == want
    assert teng.spec_stats == jeng.spec_stats and teng.spec_stats["rounds"] > 0
    assert set(teng.programs) == {key[0] for key in jeng._jit_cache}
    assert "dec_spec_chunk" in teng.programs
    _, greedy = _pair(trees[window], window, **engine_kw)
    assert greedy.generate(rows, **gkw) == got
    return teng


def _repetitive(n, seed=8, lo=30):
    rng = np.random.RandomState(seed)
    return [([int(t) for t in rng.randint(2, 258, 8)] * 8)[: lo + 3 * i] for i in range(n)]


@pytest.mark.parametrize("kvq,window", [(None, None), ("int8", None), ("int4", None),
                                        ("int8", 24)])
def test_spec_chunk_matches_jax(trees, kvq, window):
    """Two calls of six rounds, K 3, budget 10 with 2(K+1) slots of slack:
    rows run past their budget, and frozen rows' blocks clamp at the end."""
    K, max_new, rounds = 3, 10, 6
    jcfg = dataclasses.replace(JaxDecoderConfig.tiny(), sliding_window=window, kv_quant=kvq)
    tcfg = dataclasses.replace(DecoderConfig.tiny(), sliding_window=window)
    tree = trees[window]
    jp = jax.tree.map(jnp.asarray, tree)
    model = tdec.params_from_jax(tree, tcfg, device="cpu")
    rows = _repetitive(3, lo=26)
    L = 40
    ids = np.zeros((3, L), np.int32)
    mask = np.zeros((3, L), np.int32)
    for i, r in enumerate(rows):
        ids[i, L - len(r):], mask[i, L - len(r):] = r, 1
    pad = max_new + 2 * (K + 1)
    jl, jc = jgen.decoder_prefill(jp, jcfg, ids, mask, pad)
    tl, tc = tgen.decoder_prefill(model, torch.from_numpy(ids).long(),
                                  torch.from_numpy(mask).long(), pad, kv_quant=kvq)
    hist = np.zeros((3, L + pad), np.int32)
    hist[:, :L] = ids
    jstate = (jnp.argmax(jl, -1).astype(jnp.int32), jc, jnp.asarray(hist),
              jnp.full((3,), L, jnp.int32), jnp.zeros((3,), bool))
    tstate = (torch.argmax(tl, -1), tc, torch.from_numpy(hist).long(), torch.full((3,), L),
              torch.zeros((3,), dtype=torch.bool))
    accepted = 0
    for _ in range(2):
        jo, jn, jstate = jgen.decoder_spec_decode_chunk(
            jp, jcfg, jstate[0], jstate[1], jstate[2], jstate[3], L, max_new, rounds, K,
            jcfg.eos_token_id, done=jstate[4])
        to, tn, tstate = tgen.decoder_spec_decode_chunk(
            model, tstate[0], tstate[1], tstate[2], tstate[3], L, max_new, rounds, K,
            tcfg.eos_token_id, done=tstate[4])
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        accepted = max(accepted, int(tn.max()))
        (tt, (tk, tv, tm, tpos), th, tw, td) = tstate
        (wt, (wk, wv, wm, wpos), wh, ww, wd) = jstate
        for g, w in ((tt, wt), (tm, wm), (tpos, wpos), (th, wh), (tw, ww), (td, wd)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in ((tk, wk), (tv, wv)):
            if kvq is None:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
            else:
                diff = np.abs(g[0].numpy().astype(np.int32) - np.asarray(w[0]).astype(np.int32))
                assert diff.max() <= 1 and (diff == 0).mean() > 0.999
                np.testing.assert_allclose(g[1].numpy(), np.asarray(w[1]), rtol=1e-5)
    assert (tstate[3] >= L + max_new).all()  # every row ran past its budget
    if window is None:
        assert accepted > 1  # drafts were accepted on this tree's rows


def test_spec_matches_jax_distinct_rows(trees):
    rows = [list(range(2 + 11 * i, 60 + 13 * i)) for i in range(3)]
    _same(trees, rows, max_new_tokens=24, chunk_tokens=8)


def test_spec_matches_jax_shared_prefix(trees):
    prefix = list(range(2, 130))
    rows = [prefix + list(range(140, 150 + 4 * i)) for i in range(4)]
    teng = _same(trees, rows, max_new_tokens=16, chunk_tokens=8)
    assert "dec_prefill_pre" in teng.programs


@pytest.mark.parametrize("kvq", ["int8", "int4"])
def test_spec_matches_jax_quantized_kv(trees, kvq):
    rows = [list(range(2 + 7 * i, 64 + 5 * i)) for i in range(3)]
    _same(trees, rows, engine_kw=dict(kv_quantize=kvq), max_new_tokens=16, chunk_tokens=8)


def test_spec_window_matches_jax(trees):
    _same(trees, _repetitive(3, lo=30), window=24, engine_kw=dict(prefix_share=False),
          max_new_tokens=16, chunk_tokens=10)


def test_spec_accept_rate_matches_jax(trees):
    """Zero weights give a constant argmax, which the bigram lookup drafts:
    rounds accept more than one token, as in JAX."""
    zero = jax.tree.map(lambda x: x * 0.0, trees[None])
    jeng, teng = _pair(zero, spec_lookup=4)
    rows = [list(range(2, 40))]
    assert teng.generate(rows, max_new_tokens=48, chunk_tokens=16) == jeng.generate(
        rows, max_new_tokens=48, chunk_tokens=16)
    assert teng.spec_stats == jeng.spec_stats
    assert teng.spec_stats["tokens"] / teng.spec_stats["rounds"] > 1.5


def test_spec_stop_strings_match_jax(trees):
    """A stop string taken from a greedy completion freezes rows on the host
    between chunks."""
    rows = [list(range(2, 70)), list(range(5, 90))]
    _, greedy = _pair(trees[None])
    ref, _ = greedy.generate(rows, max_new_tokens=32, chunk_tokens=8)
    stop = max(ref, key=len)[:2]
    assert stop
    texts, counts = _same(trees, rows, max_new_tokens=32, chunk_tokens=8,
                          stop_strings=(stop,)).generate(rows, max_new_tokens=32,
                                                         chunk_tokens=8, stop_strings=(stop,))
    assert any(t.endswith(stop) for t in texts) and min(counts) < 32


def test_spec_pipelined_eos_matches_greedy(trees):
    """The tokenizer's EOS the model's and no stop strings: chunk i+1 is
    enqueued before chunk i is read back, and the loop ends once every row
    is done or past its budget. The tokens are the JAX engine's greedy
    ones."""
    jeng, _ = _pair(trees[None], eos=1)
    _, teng = _pair(trees[None], eos=1, spec_lookup=4)
    rows = _repetitive(3)
    assert teng.generate(rows, max_new_tokens=20, chunk_tokens=10) == jeng.generate(
        rows, max_new_tokens=20, chunk_tokens=10)
    assert teng.programs["dec_spec_chunk"] >= 2


def _r1_workload(seed=13):
    rng = np.random.RandomState(seed)
    words = ["w%02d" % i for i in range(60)]
    queries = [" ".join(rng.choice(words, 4)) for _ in range(2)]
    docs = [[(f"d{i}", " ".join(rng.choice(words, 8))) for i in range(7)] for _ in range(2)]
    return queries, docs


def test_rank_r1_setwise_spec_matches_jax(trees):
    """Rank-R1 setwise on engines with ``spec_lookup=4``: orders and meters
    equal the JAX ranker's."""
    jeng, teng = _pair(trees[None], spec_lookup=4, kv_quantize="int8")
    queries, docs = _r1_workload()
    kw = dict(num_child=3, k=1, max_completion_tokens=16)
    pack = "prompt_setwise-R1.toml"

    def rerank(ranker, cls):
        out = ranker.rerank_many(queries, [[cls(d, 0.0, t) for d, t in ds] for ds in docs])
        st = ranker.stats
        return ([[(d.docid, d.score) for d in r] for r in out],
                (st.comparisons, st.prompt_tokens, st.completion_tokens))

    want = rerank(JaxR1(jeng, os.path.join(ROOT, "llmrankers_tpu", "prompts", pack), **kw),
                  JaxResult)
    got = rerank(tr1.RankR1SetwiseLlmRanker(
        teng, os.path.join(ROOT, "llmrankers_tpu_torch", "prompts", pack), **kw), SearchResult)
    assert got == want
    assert teng.spec_stats == jeng.spec_stats and teng.spec_stats["rounds"] > 0


def test_spec_raises_as_jax(trees):
    """Sampling is greedy-incompatible; T5 has no speculative decode."""
    _, teng = _pair(trees[None], spec_lookup=4)
    with pytest.raises(ValueError, match="incompatible with spec_lookup"):
        teng.generate([[5, 6, 7]], max_new_tokens=4, temperature=1.0, seed=1)
    cfg = T5Config.tiny()
    model = tt5.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="decoder generation"):
        ScoringEngine("t5", cfg, model, ByteTokenizer(cfg.vocab_size), spec_lookup=4)
