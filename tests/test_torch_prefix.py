"""Port parity: the decoder engine's prefix sharing and prefix-KV cache.

The port's ``ScoringEngine(kind="decoder")`` against the JAX engine, with the
same parameter tree and token rows, on each of the JAX engine's scoring
programs: ``dec_labels`` (left-padded rows), ``dec_labels_shared`` (unique
prefixes run once, rows gather their group's K/V) and ``dec_labels_pre``
(prefix K/V from the cross-wave cache, missing prefixes in one
``prefix_kv`` dispatch). Both engines must run the same programs (the JAX
``_jit_cache`` names against the port's ``programs``), group the rows the
same way (``_group``), keep the same cache statistics (``pkv_stats``,
evictions included) and give label logits within 2e-4 in fp32.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from llmrankers_tpu.engine import prefix as jprefix
from llmrankers_tpu.engine.engine import ScoringEngine as JaxEngine
from llmrankers_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmrankers_tpu.models import decoder as jdec
from llmrankers_tpu.models.config import DecoderConfig as JaxDecoderConfig
from llmrankers_tpu_torch.engine import prefix as tprefix
from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import decoder as tdec
from llmrankers_tpu_torch.models.config import DecoderConfig

TOL = 2e-4
LADDERS = dict(len_buckets=(32, 64, 128, 256), batch_buckets=(4, 8, 16),
               max_batch_tokens=4096)
LABELS = [67, 68, 69]


@pytest.fixture(autouse=True)
def _fp32_reference(monkeypatch):
    # fp32 reference numerics: no TF32 in any matmul.
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.fixture(scope="module")
def trees():
    out = {}
    for window in (None, 64):
        jcfg = dataclasses.replace(JaxDecoderConfig.tiny(attention_bias=True),
                                   sliding_window=window)
        tree = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.PRNGKey(1)))
        rng = np.random.RandomState(1)
        for key in ("bq", "bk", "bv"):  # the random init's biases are zeros
            tree["layers"][key] = (0.3 * rng.randn(*tree["layers"][key].shape)
                                   ).astype(np.float32)
        out[window] = tree
    return out


def _engines(trees, window=None, **kw):
    jcfg = dataclasses.replace(JaxDecoderConfig.tiny(attention_bias=True),
                               sliding_window=window)
    tcfg = dataclasses.replace(DecoderConfig.tiny(attention_bias=True),
                               sliding_window=window)
    tree = trees[window]
    jeng = JaxEngine("decoder", jcfg, jax.tree.map(jax.numpy.asarray, tree),
                     JaxByteTokenizer(jcfg.vocab_size), **LADDERS, **kw)
    teng = ScoringEngine("decoder", tcfg, tdec.params_from_jax(tree, tcfg, device="cpu"),
                         ByteTokenizer(tcfg.vocab_size), **LADDERS, **kw)
    return jeng, teng


def _wave(seed, n_rows=10, prefixes=(70, 45), suffix=(3, 40)):
    """Rows of a setwise wave: a few shared heads (query and instruction)
    followed by different passages."""
    rng = np.random.RandomState(seed)
    heads = [list(rng.randint(2, 258, size=n)) for n in prefixes]
    return [heads[i % len(heads)] + list(rng.randint(2, 258, size=rng.randint(*suffix)))
            for i in range(n_rows)]


def _programs(jeng):
    return {key[0] for key in jeng._jit_cache}


def _check(jeng, teng, rows):
    want = jeng.score_labels(rows, LABELS)
    got = teng.score_labels(rows, LABELS)
    assert got.dtype == np.float32 and got.shape == (len(rows), len(LABELS))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert set(teng.programs) == _programs(jeng)
    assert teng.pkv_stats == jeng.pkv_stats
    return got


@pytest.mark.parametrize("window", [None, 64])
def test_plain_path_matches_jax(trees, window):
    """prefix_share=False: every chunk is one left-padded dec_labels batch
    (with window 64, the kernel's index-space window on the flash path)."""
    jeng, teng = _engines(trees, window, prefix_share=False)
    _check(jeng, teng, _wave(0) + [[5, 6, 7]])
    assert set(teng.programs) == {"dec_labels"}


@pytest.mark.parametrize("window", [None, 64])
def test_shared_path_matches_jax(trees, window):
    """Sharing with the cache off: dec_labels_shared; a one-row wave takes
    dec_labels. With window 64 the prefix meets the window: the dense
    positional mask."""
    jeng, teng = _engines(trees, window, prefix_cache_mb=0)
    _check(jeng, teng, _wave(1))
    assert set(teng.programs) == {"dec_labels_shared"}
    _check(jeng, teng, _wave(2)[:1])
    assert set(teng.programs) == {"dec_labels_shared", "dec_labels"}


@pytest.mark.parametrize("window", [None, 64])
def test_cached_path_matches_jax(trees, window):
    """Sharing with the cross-wave cache over waves: the first wave misses
    and fills it through prefix_kv, the second hits every prefix; a third
    wave with a new head hits the cached groups and misses the new one."""
    jeng, teng = _engines(trees, window)
    rows = _wave(3)
    _check(jeng, teng, rows)
    assert teng.pkv_stats == {"hits": 0, "misses": 2, "evictions": 0}
    _check(jeng, teng, rows[::-1])
    assert teng.pkv_stats == {"hits": 2, "misses": 2, "evictions": 0}
    new = _wave(4, prefixes=(50,))
    _check(jeng, teng, rows[:4] + new[:6])
    assert teng.pkv_stats["hits"] > 2 and teng.pkv_stats["misses"] == 3
    assert set(teng.programs) == {"prefix_kv", "dec_labels_pre"}
    assert teng._pkv_bytes == jeng._pkv_bytes > 0
    assert [k for k in teng._pkv] == [k[1] for k in jeng._pkv]


def test_cache_eviction_matches_jax(trees):
    """A byte budget of about one entry: both engines evict the same
    entries in the same LRU order."""
    jeng, teng = _engines(trees)
    one = 2 * 2 * 70 * 16 * 4 * 2  # Ld * KV * len * Dh * fp32 bytes, K and V
    jeng._pkv_budget = teng._pkv_budget = one + 1
    for seed in (5, 6, 5):
        _check(jeng, teng, _wave(seed))
    assert teng.pkv_stats["evictions"] > 0
    assert [k for k in teng._pkv] == [k[1] for k in jeng._pkv]


@pytest.mark.parametrize("seed", [7, 8])
def test_group_matches_jax(trees, seed):
    jeng, teng = _engines(trees)
    rows = _wave(seed, n_rows=13, prefixes=(70, 45, 33))
    jn, jargs, jhost = jeng._group(rows, want_host=True)
    tn, targs, thost = teng._group(rows)
    assert tn == jn
    for t, j in zip(targs, jargs):  # pids, pmask, gidx, sids, smask
        np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))
    # (prefix token lists, padded prefix length, suffix length)
    assert thost == (jhost[0], jhost[2], jhost[3])
    assert teng._group(rows[:1]) is None and jeng._group(rows[:1]) is None


def test_context_cap_truncates_like_jax(trees):
    """Rows past max_position_embeddings are cut (the tail kept) and
    counted, and never take the shared path."""
    jeng, teng = _engines(trees)
    for eng in (jeng, teng):
        eng.cfg = dataclasses.replace(eng.cfg, max_position_embeddings=96)
    rows = _wave(9, n_rows=6, prefixes=(70,), suffix=(30, 60))
    for e in (jeng, teng):
        e._warned_ctx = True  # keep the one-time warning off the test output
    np.testing.assert_allclose(teng.score_labels(rows, LABELS),
                               jeng.score_labels(rows, LABELS), rtol=0, atol=TOL)
    assert teng.truncated_rows == jeng.truncated_rows > 0
    assert set(teng.programs) == _programs(jeng) == {"dec_labels"}


@pytest.mark.parametrize("seed", range(4))
def test_group_shared_prefixes_matches_jax(seed):
    rng = np.random.RandomState(seed)
    heads = [list(rng.randint(2, 9, size=rng.randint(0, 80))) for _ in range(4)]
    rows = [heads[rng.randint(4)] + list(rng.randint(2, 9, size=rng.randint(1, 30)))
            for _ in range(rng.randint(1, 20))]
    for kw in ({}, dict(min_prefix=4, min_saving=8)):
        assert tprefix.group_shared_prefixes(rows, **kw) == \
            jprefix.group_shared_prefixes(rows, **kw)


def test_decoder_engine_unported_options_raise(trees):
    tcfg = DecoderConfig.tiny(attention_bias=True)
    model = tdec.params_from_jax(trees[None], tcfg, device="cpu")
    tok = ByteTokenizer(tcfg.vocab_size)
    for kw, item in ((dict(quantize="int8", awq_calib=["p"]), "A9 \\(AWQ\\)"),
                     (dict(quantize="int4", awq_calib=["p"]), "A9 \\(AWQ\\)")):
        with pytest.raises(NotImplementedError, match=item):
            ScoringEngine("decoder", tcfg, model, tok, **kw)
    # Speculative decoding is ported: the engine takes it, with empty stats.
    spec = ScoringEngine("decoder", tcfg, model, tok, spec_lookup=4)
    assert spec.spec_lookup == 4 and spec.spec_stats == {"tokens": 0, "rounds": 0}
    assert spec.refill_stats == {"sessions": 0, "refills": 0, "prefix_kv_hits": 0}
    eng = ScoringEngine("decoder", tcfg, model, tok)
    assert not eng.model.use_flash  # flash is on only on a CUDA device
    with pytest.raises(NotImplementedError, match="A10"):
        eng.score_labels([[5, 6]], LABELS, adapter="lora")
    with pytest.raises(NotImplementedError, match="A10"):
        eng.score_labels([[5, 6]], LABELS, row_adapters=["lora"])
    with pytest.raises(TypeError, match="DecoderConfig"):
        ScoringEngine("t5", tcfg, model, tok)
