"""Port parity: the torch ``ScoringEngine`` against the JAX engine.

Both engines get the same parameter tree (JAX init, loaded into the port with
``params_from_jax``) and the same token rows. The host half must match
exactly (the same padded batches and chunk boundaries) and ``score_labels``
within 2e-4 in fp32.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from llmrankers_tpu.engine.engine import ScoringEngine as JaxEngine
from llmrankers_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmrankers_tpu.models import t5 as jt5
from llmrankers_tpu.models.config import T5Config
from llmrankers_tpu_torch.engine import engine as teng
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import decoder as tdec
from llmrankers_tpu_torch.models import t5 as tt5
from llmrankers_tpu_torch.models.config import DecoderConfig as TorchDecoderConfig
from llmrankers_tpu_torch.models.config import T5Config as TorchT5Config

TOL = 2e-4
LADDERS = dict(len_buckets=(64, 128, 256), batch_buckets=(4, 8, 16),
               max_batch_tokens=1024)


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
    tree = jax.tree.map(np.asarray, jt5.init_params(cfg, jax.random.PRNGKey(0)))
    jeng = JaxEngine("t5", cfg, jax.tree.map(jax.numpy.asarray, tree),
                     JaxByteTokenizer(cfg.vocab_size), **LADDERS)
    tcfg = _torch_cfg(cfg)
    teng_ = teng.ScoringEngine("t5", tcfg, tt5.params_from_jax(tree, tcfg, device="cpu"),
                               ByteTokenizer(cfg.vocab_size), **LADDERS)
    return jeng, teng_


def _rows(n, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(2, 258, size=rng.randint(5, 120))) for _ in range(n)]


def test_buckets_and_ladders_match_jax():
    from llmrankers_tpu.engine import engine as jeng_mod

    assert teng.DEFAULT_LEN_BUCKETS == jeng_mod.DEFAULT_LEN_BUCKETS
    assert teng.DEFAULT_BATCH_BUCKETS == jeng_mod.DEFAULT_BATCH_BUCKETS
    for n in (1, 63, 64, 65, 640, 641, 4096, 4097, 11000):
        assert teng._bucket(n, teng.DEFAULT_LEN_BUCKETS) == jeng_mod._bucket(
            n, jeng_mod.DEFAULT_LEN_BUCKETS)


@pytest.mark.parametrize("n", [1, 3, 9, 21])
def test_pad_batch_and_chunks_match_jax(engines, n):
    jeng, teng_ = engines
    rows = _rows(n, seed=n)
    assert [(o, len(c)) for o, c in teng_._chunks(rows)] == [
        (o, len(c)) for o, c in jeng._chunks(rows)]
    for (_, tc), (_, jc) in zip(teng_._chunks(rows), jeng._chunks(rows)):
        t_ids, t_mask, t_n, t_B = teng_._pad_batch(tc)
        j_ids, j_mask, j_n, j_B = jeng._pad_batch(jc)
        assert (t_n, t_B) == (j_n, j_B)
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_mask, j_mask)


@pytest.mark.parametrize("prefix", [(), (0, 82, 99)])
def test_score_labels_matches_jax(engines, prefix):
    jeng, teng_ = engines
    rows = _rows(21, seed=7)  # 3 chunks under the 1024-token budget
    labels = [67, 68, 69]
    want = jeng.score_labels(rows, labels, prefix)
    got = teng_.score_labels(rows, labels, prefix)
    assert got.dtype == np.float32 and got.shape == (21, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_unported_paths_raise(engines):
    _, teng_ = engines
    with pytest.raises(NotImplementedError, match="A6"):
        teng_.generate([[5, 6]], 2)
    with pytest.raises(NotImplementedError, match="A6"):
        teng_.sequence_nll([[5, 6]], [[7]])
    with pytest.raises(NotImplementedError, match="A10"):
        teng_.score_labels([[5, 6]], [67], adapter="lora")
    # The decoder kind and its int8/int4 weights are ported; AWQ is not.
    dcfg = TorchDecoderConfig.tiny()
    dec = tdec.init_params(dcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="A9 \\(AWQ\\)"):
        teng.ScoringEngine("decoder", dcfg, dec, teng_.tokenizer, quantize="int8",
                           awq_calib=["a prompt"])
    assert teng.ScoringEngine("decoder", dcfg, dec, teng_.tokenizer,
                              quantize="int8").cfg.int8_kernel
    with pytest.raises(TypeError, match="T5Config"):
        teng.ScoringEngine("t5", dcfg, dec, teng_.tokenizer)
