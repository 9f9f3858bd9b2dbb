"""Port parity of the int8 flan-t5 path against the JAX package.

- ``quantize_t5_params(pack=True)``: int8 leaves and f32 scales equal to the
  JAX function's, leaf for leaf, and ``params_from_jax`` on the quantized
  JAX tree gives the same module.
- The int8 forward on the 128-wide config of ``tests/test_int8_matmul.py``
  (64 x 16 ids, so M = B*L = 1024 reaches the kernels): the port on the CPU
  (the kernels' plain versions) against the JAX forward with
  ``int8_kernel=True`` (Pallas in interpret mode). Label winners equal;
  the median logit within 1e-5 and every logit within 0.05 (max |logit| is
  about 4). The inputs of the first quantization already differ by an f32
  ulp (XLA's and PyTorch's rms_norm sum in other orders), which flips a few
  int8 values at round-half boundaries; each flip moves its row by a few
  thousandths, which flips more values of that row at the next site, so
  about 6% of the logits end up to 0.03 apart. Off the kernel path (32 x 16
  ids, M = 512), where nothing is rounded to int8 at run time, within 2e-4.
- The slice end to end: setwise heapsort on the port's engine with
  ``quantize="int8"`` against the JAX stack with ``quantize="int8"`` and
  ``LLMRANKERS_FORCE_QKERNELS=1``, the same final orders docid for docid.
- The decision-parity battery (``--quantize`` in the CLI:
  ``tests/test_torch_setwise.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llmrankers_tpu.engine.engine import ScoringEngine as JaxEngine
from llmrankers_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmrankers_tpu.models import quant as jquant
from llmrankers_tpu.models import t5 as jt5
from llmrankers_tpu.models.config import T5Config
from llmrankers_tpu.rankers import SetwiseLlmRanker as JaxSetwise
from llmrankers_tpu.types import SearchResult
from llmrankers_tpu_torch.engine import parity
from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import quant as tquant
from llmrankers_tpu_torch.models import t5 as tt5
from llmrankers_tpu_torch.models.config import T5Config as TorchT5Config
from llmrankers_tpu_torch.rankers.setwise import SetwiseLlmRanker

KERNEL_TOL = 0.05  # int8 forward, kernel path: cascading round-half flips
KERNEL_MEDIAN_TOL = 1e-5
DEQUANT_TOL = 2e-4  # int8 forward, dequant path: fp32 rounding only

CFG128 = T5Config(vocab_size=512, d_model=128, d_kv=32, d_ff=256,
                  num_layers=2, num_decoder_layers=2, num_heads=4)


def _torch_cfg(cfg):
    """The port's own T5Config with the fields of a JAX one."""
    return TorchT5Config(**dataclasses.asdict(cfg))


@pytest.fixture(autouse=True)
def _fp32_reference(monkeypatch):
    # fp32 reference numerics: no TF32 in any matmul.
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _tree(cfg, seed=0, dtype=jnp.float32):
    return jax.tree.map(np.asarray, jt5.init_params(cfg, jax.random.PRNGKey(seed), dtype))


@pytest.mark.parametrize("variant", ["flan", "relu", "bf16"])
def test_quantize_t5_params_matches_jax(variant):
    cfg = CFG128
    jdt, tdt = jnp.float32, torch.float32
    if variant == "relu":  # t5-v1.0 layout: no wi_g pack, per-site int8 wi
        cfg = dataclasses.replace(cfg, feed_forward_proj="relu")
    if variant == "bf16":
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    tree = _tree(cfg, dtype=jdt)
    want = jax.tree.map(np.asarray, jquant.quantize_t5_params(
        jax.tree.map(jnp.asarray, tree), pack=True))
    model = tt5.params_from_jax(tree, _torch_cfg(cfg), dtype=tdt, device="cpu")
    got = tquant.quantize_t5_params(model, pack=True)
    assert got.quantized and not model.quantized
    for block in ("encoder", "decoder"):
        leaves = want[block]["layers"]
        stack = getattr(got, block)
        assert set(stack.layers[0].keys()) == set(leaves)
        for key, leaf in leaves.items():
            for i, lp in enumerate(stack.layers):
                p = lp[key]
                assert not p.requires_grad
                if key in jquant.T5_TARGETS or key in ("qkv", "ckv", "wi_g"):
                    assert p.dtype == torch.int8
                    np.testing.assert_array_equal(p.numpy(), leaf[i])
                elif key.endswith(tquant.SCALE_SUFFIX):
                    assert p.dtype == torch.float32 and p.shape == (1, leaf.shape[-1])
                    np.testing.assert_array_equal(p.numpy(), leaf[i])
                else:
                    assert p is getattr(model, block).layers[i][key]  # shared
    assert got.shared is model.shared and got.lm_head is model.lm_head
    if variant == "flan":
        assert "qkv" in got.encoder.layers[0] and "ckv" in got.decoder.layers[0]
        assert got.encoder.layers[0]["wi_g"].shape == (128, 512)  # [K, N] layout
    # the JAX tree itself loads into the same module
    loaded = tt5.params_from_jax(want, _torch_cfg(cfg), dtype=tdt, device="cpu")
    for a, b in zip(loaded.state_dict().values(), got.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("source", ["quantizer", "params_from_jax"])
@pytest.mark.parametrize("variant", ["flan", "relu"])
def test_b3_leaves_are_kmajor(variant, source):
    """Every int8 leaf that the W8A8 GEMM (B3) reads is held K-major (shape
    [K, N], stride (1, K)) with the JAX leaf's values bit for bit, whether it
    came from the quantizer or from the JAX tree; the gated kernel's wi_g
    stays contiguous [K, N]."""
    cfg = CFG128 if variant == "flan" else dataclasses.replace(
        CFG128, feed_forward_proj="relu")
    tree = _tree(cfg)
    want = jax.tree.map(np.asarray, jquant.quantize_t5_params(
        jax.tree.map(jnp.asarray, tree), pack=True))
    if source == "quantizer":
        got = tquant.quantize_t5_params(
            tt5.params_from_jax(tree, _torch_cfg(cfg), device="cpu"))
    else:
        got = tt5.params_from_jax(want, _torch_cfg(cfg), device="cpu")
    b3 = {"encoder": {"qkv", "o", "wo"}, "decoder": {"qkv", "o", "cq", "ckv", "co", "wo"}}
    for block in ("encoder", "decoder"):
        names = b3[block] | ({"wi"} if variant == "relu" else set())
        layers = getattr(got, block).layers
        assert tquant.kmajor_leaves({k: (tuple(p.shape), p.dtype)
                                     for k, p in layers[0].items()}) == names
        for key, leaf in want[block]["layers"].items():
            for i, lp in enumerate(layers):
                p = lp[key]
                K, N = leaf.shape[1:] if leaf.ndim == 3 else (None, None)
                if key in names:
                    assert p.stride() == (1, K) and p.shape == (K, N), (key, p.stride())
                else:
                    assert p.is_contiguous(), key
                np.testing.assert_array_equal(p.float().numpy(), leaf[i].astype(np.float32))
    if variant == "flan":
        assert got.encoder.layers[0]["wi_g"].is_contiguous()


def test_pack_false_is_not_ported():
    model = tt5.params_from_jax(_tree(CFG128), _torch_cfg(CFG128), device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        tquant.quantize_t5_params(model, pack=False)


def _batch(cfg):
    ids = np.array(jax.random.randint(jax.random.PRNGKey(1), (64, 16), 0, cfg.vocab_size),
                     np.int32)
    mask = np.ones_like(ids)
    mask[5, 9:] = 0  # right padding
    return ids, mask, np.zeros((64, 1), np.int32)


@pytest.mark.parametrize("kernel", [True, False])
def test_int8_forward_matches_jax(kernel):
    cfg = CFG128
    tree = _tree(cfg)
    qtree = jquant.quantize_t5_params(jax.tree.map(jnp.asarray, tree), pack=True)
    ids, mask, dec = (a if kernel else a[:32] for a in _batch(cfg))
    want = np.asarray(jt5.forward(qtree, dataclasses.replace(cfg, int8_kernel=kernel),
                                  jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(dec)))
    model = tquant.quantize_t5_params(tt5.params_from_jax(tree, _torch_cfg(cfg), device="cpu"))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, (ids, mask, dec))).numpy()
    assert (got[:, -1].argmax(-1) == want[:, -1].argmax(-1)).all()
    tol = KERNEL_TOL if kernel else DEQUANT_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert np.median(np.abs(got - want)) <= KERNEL_MEDIAN_TOL


def test_int8_forward_routes_large_m_to_the_kernels(monkeypatch):
    """Which sites take the kernels: the encoder's qkv, o, wi_g and wo and
    the decoder's ckv (M = B*L = 1024), never the 1-token decoder sites."""
    from llmrankers_tpu_torch.models import t5 as mod

    calls = []
    for name in ("quantized_matmul", "gated_matmul", "flash_mha_packed"):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append((_n, tuple(a[0].shape), tuple(a[1].shape)
                          if _n != "flash_mha_packed" else ())), _f(*a, **k))[1])
    model = tquant.quantize_t5_params(
        tt5.params_from_jax(_tree(CFG128), _torch_cfg(CFG128), device="cpu"))
    ids, mask, dec = _batch(CFG128)
    with torch.inference_mode():
        model(*map(torch.from_numpy, (ids, mask, dec)))
    per_layer = [("quantized_matmul", (64, 16, 128), (128, 384)),
                 ("flash_mha_packed", (64, 16, 384), ()),
                 ("quantized_matmul", (64, 16, 128), (128, 128)),
                 ("gated_matmul", (64, 16, 128), (128, 512)),
                 ("quantized_matmul", (64, 16, 256), (256, 128))]
    cross = [("quantized_matmul", (64, 16, 128), (128, 256))]
    assert calls == per_layer * 2 + cross * 2


# ---------------------------------------------------------------------------
# The slice end to end
# ---------------------------------------------------------------------------
LADDERS = dict(len_buckets=(128, 256, 512), batch_buckets=(8, 32))


def _queries(n_docs=12):
    queries = ["what about topic 3", "tell me of topic 11"]
    rankings = [
        [SearchResult(docid=f"q{qi}d{i}", score=float(-i),
                      text=f"this passage talks about topic {(i * 5 + qi) % n_docs}")
         for i in range(n_docs)]
        for qi in range(len(queries))
    ]
    return queries, rankings


def test_setwise_int8_orders_match_jax(monkeypatch):
    monkeypatch.setenv("LLMRANKERS_FORCE_QKERNELS", "1")
    cfg = CFG128
    tree = _tree(cfg, seed=3)
    jeng = JaxEngine("t5", cfg, jax.tree.map(jnp.asarray, tree),
                     JaxByteTokenizer(cfg.vocab_size), quantize="int8", **LADDERS)
    assert jeng.cfg.int8_kernel and "qkv" in jeng.params["encoder"]["layers"]
    tcfg = _torch_cfg(cfg)
    teng = ScoringEngine("t5", tcfg, tt5.params_from_jax(tree, tcfg, device="cpu"),
                         ByteTokenizer(cfg.vocab_size), quantize="int8", **LADDERS)
    assert teng.model.quantized
    kw = dict(num_child=2, k=4, scoring="likelihood", method="heapsort")
    jr, tr = JaxSetwise(jeng, **kw), SetwiseLlmRanker(teng, **kw)
    calls = []  # the waves are big enough to reach the kernels: B*L >= 1024
    fn = tt5.gated_matmul
    monkeypatch.setattr(tt5, "gated_matmul",
                        lambda *a, **k: (calls.append(a[0].shape), fn(*a, **k))[1])
    queries, rankings = _queries()
    want = jr.rerank_many(queries, rankings)
    got = tr.rerank_many(queries, rankings)
    assert [[d.docid for d in r] for r in got] == [[d.docid for d in r] for r in want]
    assert tr.stats.comparisons == jr.stats.comparisons > 0
    assert tr.wave_stats == jr.wave_stats
    assert calls


def test_engine_quantize_errors():
    cfg = T5Config.tiny()
    model = tt5.params_from_jax(_tree(cfg), _torch_cfg(cfg), device="cpu")
    tok = ByteTokenizer(cfg.vocab_size)
    with pytest.raises(ValueError, match="int4.*decoder models"):
        ScoringEngine("t5", _torch_cfg(cfg), model, tok, quantize="int4")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        ScoringEngine("t5", _torch_cfg(cfg), model, tok, quantize="fp8")


def test_decision_parity_battery():
    """The battery at a small size: the rows are ``bench.py``'s, and the
    int8 winners agree with fp32 on every clear-margin row."""
    tok = ByteTokenizer(CFG128.vocab_size)
    rows = parity.battery_rows(tok, 16)
    assert len(rows) == 16 and all(512 < len(r) <= 640 for r in rows)
    model = tt5.params_from_jax(_tree(CFG128), _torch_cfg(CFG128), device="cpu")
    res = parity.t5_int8_decision_parity(model, n_prompts=16)
    assert res["prompts"] == 16
    assert 0.0 <= res["winner_agreement"] <= 1.0
    assert res["winner_agreement_clear_margin"] == 1.0
