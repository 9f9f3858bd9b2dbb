"""Port parity of decoder quantization (int8, and mixed int4/int8) against
the JAX package.

- ``quantize_decoder_params`` and ``quantize_decoder_params_int4`` (the
  default cut-off and ``min_site_params=0``) give the JAX functions' leaves
  bit for bit, dtype for dtype, with tied and untied heads;
  ``params_from_jax`` loads the JAX quantized trees into the same modules.
- The forward on the 128-wide, 2-layer decoder of
  ``tests/test_int4_matmul.py`` (64 x 16 ids, so M = B*L = 1024 reaches the
  int8 kernels; int4 sites take theirs at any M): the port on the CPU (the
  kernels' plain versions) against the JAX forward with ``int8_kernel`` or
  ``int4_kernel`` set (Pallas in interpret mode). Untied, the activations
  stay f32: winners equal, the median logit within 1e-5, every logit within
  0.1. The inputs of the first quantization already differ by an f32 ulp
  (XLA's and PyTorch's rms_norm sum in other orders), which flips an int8
  value at a round-half boundary now and then, and a flip moves its row's
  logits by up to a few hundredths (int8: 0.0551 on 2 of 64 rows; max
  |logit| 4.1). The engine's rows are longer, so more of them hold a flip
  (4 of 16), but the median stays at f32 rounding.
  Tied, the int8 embedding makes the activations bf16 (as in JAX): every
  logit within 0.05, the median within two bf16 ulps of the largest logit
  (2^-7 max |logit|), winners equal where the margin exceeds 0.05. Off the kernel path (32 x 16 ids,
  M = 512, int8) within 2e-4.
- The engine's three programs with ``quantize="int8"`` and ``"int4"``
  against the JAX engine with ``LLMRANKERS_FORCE_QKERNELS=1``: the same
  programs, prefix groups and ``pkv_stats``, logits under the same gates;
  setwise heapsort orders docid for docid; the CLI's ``--quantize`` on
  ``random:dec-tiny`` writes the JAX CLI's file.
- The weight entry points run on the card by default and raise without one.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llmrankers_tpu.engine.engine import ScoringEngine as JaxEngine
from llmrankers_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmrankers_tpu.models import decoder as jdec
from llmrankers_tpu.models import quant as jquant
from llmrankers_tpu.models.config import DecoderConfig as JaxDecoderConfig
from llmrankers_tpu.rankers import SetwiseLlmRanker as JaxSetwise
from llmrankers_tpu.types import SearchResult
from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import decoder as tdec
from llmrankers_tpu_torch.models import quant as tquant
from llmrankers_tpu_torch.models import t5 as tt5
from llmrankers_tpu_torch.models.config import DecoderConfig, T5Config
from llmrankers_tpu_torch.rankers.setwise import SetwiseLlmRanker

KERNEL_TOL = 0.1  # f32 quantized forward, kernel path: a round-half flip's row
KERNEL_MEDIAN_TOL = 1e-5
BF16_TOL = 0.05  # bf16 activations (tied int8 head)
DEQUANT_TOL = 2e-4  # int8 forward off the kernel path: fp32 rounding only
CFG128 = JaxDecoderConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2)
MODES = {  # name -> (JAX quantize function, port quantize function)
    "int8": (jquant.quantize_decoder_params, tquant.quantize_decoder_params),
    "int4": (jquant.quantize_decoder_params_int4, tquant.quantize_decoder_params_int4),
    "int4_all": (functools.partial(jquant.quantize_decoder_params_int4, min_site_params=0),
                 functools.partial(tquant.quantize_decoder_params_int4, min_site_params=0)),
}


@pytest.fixture(autouse=True)
def _fp32_reference(monkeypatch):
    # fp32 reference numerics: no TF32 in any matmul.
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _cfgs(tied=False, **kw):
    jcfg = dataclasses.replace(CFG128, tie_word_embeddings=tied, **kw)
    return jcfg, DecoderConfig(**dataclasses.asdict(jcfg))


def _tree(jcfg, seed=0, dtype=jnp.float32):
    """A JAX tree as numpy, with the norms redrawn so that every leaf
    matters."""
    tree = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.PRNGKey(seed), dtype))
    rng = np.random.RandomState(seed)
    for key in ("ln1", "ln2"):
        leaf = tree["layers"][key]
        tree["layers"][key] = (1.0 + 0.3 * rng.randn(*leaf.shape)).astype(leaf.dtype)
    return tree


def _np32(a):
    return np.asarray(a).astype(np.float32)


def _assert_leaf(p: torch.Tensor, want, name):
    want = np.asarray(want)
    wdt = torch.bfloat16 if want.dtype.name == "bfloat16" else getattr(torch, want.dtype.name)
    assert p.dtype == wdt, (name, p.dtype, want.dtype)
    assert tuple(p.shape) == want.shape, (name, tuple(p.shape), want.shape)
    np.testing.assert_array_equal(p.float().numpy(), want.astype(np.float32), err_msg=name)


def _assert_module(model, tree):
    for name in ("embed", "embed_scale", "lm_head", "lm_head_scale"):
        if name in tree:
            _assert_leaf(getattr(model, name), tree[name], name)
        else:
            assert getattr(model, name, None) is None
    assert set(model.layers[0].keys()) == set(tree["layers"])
    for key, leaf in tree["layers"].items():
        for i, lp in enumerate(model.layers):
            _assert_leaf(lp[key], np.asarray(leaf)[i], f"{key}[{i}]")


# ---------------------------------------------------------------------------
# Quantize functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("mode", ["int8", "int4", "int4_all", "int8_bf16"])
def test_quantize_decoder_params_matches_jax(mode, tied):
    bf16 = mode.endswith("_bf16")
    jfn, tfn = MODES[mode.removesuffix("_bf16")]
    jcfg, tcfg = _cfgs(tied, attention_bias=True)
    tree = _tree(jcfg, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    want = jax.tree.map(np.asarray, jfn(jax.tree.map(jnp.asarray, tree)))
    model = tdec.params_from_jax(tree, tcfg, dtype=torch.bfloat16 if bf16 else torch.float32,
                                 device="cpu")
    got = tfn(model)
    assert tquant.is_quantized(got) and not tquant.is_quantized(model)
    _assert_module(got, want)
    lp = got.layers[0]
    if mode == "int4_all":
        assert all(k + tquant.SCALE4_SUFFIX in lp for k in tquant.QUANT_TARGETS)
    else:  # at 128 wide every site is under the default cut-off: int8
        assert all(k + tquant.SCALE_SUFFIX in lp for k in tquant.QUANT_TARGETS)
    # float leaves are shared with the float model
    assert got.final_ln is model.final_ln and lp["ln1"] is model.layers[0]["ln1"]
    assert (got.embed is model.embed) == (not tied)
    # the JAX quantized tree loads into the same module
    loaded = tdec.params_from_jax(want, tcfg, dtype=model.final_ln.dtype, device="cpu")
    _assert_module(loaded, want)
    assert loaded.state_dict().keys() == got.state_dict().keys()


@pytest.mark.parametrize("source", ["quantizer", "params_from_jax"])
@pytest.mark.parametrize("mode", ["int8", "int4_all", "int4_attn"])
def test_b3_leaves_are_kmajor(mode, source):
    """Every int8 site is held K-major (shape [K, N], stride (1, K)), bit for
    bit the JAX leaves, from the quantizer and from the JAX tree: the W8A8
    GEMM B3's (wq, wk, wv, wo, w_down) and the gated pair B6's (w_gate,
    w_up); the packed int4 leaves are K-major too (stride (1, K/2), B7's
    layout); the int8 head stays contiguous."""
    jcfg, tcfg = _cfgs(tied=mode == "int8")
    if mode == "int4_attn":  # int4 FFN, int8 attention, as at Qwen2.5-3B's widths
        jfn = functools.partial(jquant.quantize_decoder_params_int4,
                                min_site_params=128 * 256)
        tfn = functools.partial(tquant.quantize_decoder_params_int4,
                                min_site_params=128 * 256)
    else:
        jfn, tfn = MODES[mode]
    tree = _tree(jcfg)
    want = jax.tree.map(np.asarray, jfn(jax.tree.map(jnp.asarray, tree)))
    if source == "quantizer":
        got = tfn(tdec.params_from_jax(tree, tcfg, device="cpu"))
    else:
        got = tdec.params_from_jax(want, tcfg, device="cpu")
    lp0 = got.layers[0]
    int8 = {k for k in tquant.QUANT_TARGETS if k + tquant.SCALE_SUFFIX in lp0}
    assert int8 == {"int8": set(tquant.QUANT_TARGETS), "int4_all": set(),
                    "int4_attn": {"wq", "wk", "wv", "wo"}}[mode]
    for key, leaf in want["layers"].items():
        for i, lp in enumerate(got.layers):
            p = lp[key]
            if key in int8 or key + tquant.SCALE4_SUFFIX in lp0:
                K, N = leaf.shape[1:]  # packed int4: K/2 rows
                assert p.stride() == (1, K) and p.shape == (K, N), (key, p.stride())
            else:
                assert p.is_contiguous(), key
            _assert_leaf(p, np.asarray(leaf)[i], f"{key}[{i}]")
    for head in ("embed", "lm_head"):
        if getattr(got, head, None) is not None:
            assert getattr(got, head).is_contiguous(), head


@pytest.mark.parametrize("source", ["quantizer", "params_from_jax"])
@pytest.mark.parametrize("mode", ["int4_all", "int4_attn"])
def test_int4_leaves_are_kmajor(mode, source):
    """Every packed int4 leaf (the W4A8 GEMM B7's weight) is held K-major: an
    [N, K/2] buffer seen as [K/2, N], stride (1, K/2), bit for bit the JAX
    leaf, from the quantizer and from the JAX tree; its group scales stay
    contiguous. The kernel's check takes it and refuses its row-major copy."""
    from llmrankers_tpu_torch.ops import int4_matmul as tint4

    jcfg, tcfg = _cfgs()
    if mode == "int4_attn":  # int4 FFN only
        jfn = functools.partial(jquant.quantize_decoder_params_int4,
                                min_site_params=128 * 256)
        tfn = functools.partial(tquant.quantize_decoder_params_int4,
                                min_site_params=128 * 256)
    else:
        jfn, tfn = MODES[mode]
    tree = _tree(jcfg)
    want = jax.tree.map(np.asarray, jfn(jax.tree.map(jnp.asarray, tree)))
    if source == "quantizer":
        got = tfn(tdec.params_from_jax(tree, tcfg, device="cpu"))
    else:
        got = tdec.params_from_jax(want, tcfg, device="cpu")
    int4 = {k for k in tquant.QUANT_TARGETS if k + tquant.SCALE4_SUFFIX in got.layers[0]}
    assert int4 == {"int4_all": set(tquant.QUANT_TARGETS),
                    "int4_attn": {"w_gate", "w_up", "w_down"}}[mode]
    for key in int4:
        for i, lp in enumerate(got.layers):
            p4, s4 = lp[key], lp[key + tquant.SCALE4_SUFFIX]
            Kh, N = np.asarray(want["layers"][key]).shape[1:]
            assert p4.shape == (Kh, N) and p4.stride() == (1, Kh), (key, p4.stride())
            assert s4.is_contiguous(), key
            _assert_leaf(p4, np.asarray(want["layers"][key])[i], f"{key}[{i}]")
            _assert_leaf(s4, np.asarray(want["layers"][key + tquant.SCALE4_SUFFIX])[i], key)
            tint4.check_kmajor("p4", p4, Kh, N)
            with pytest.raises(ValueError, match="row-major"):
                tint4.check_kmajor("p4", p4.contiguous(), Kh, N)


def test_int4_cut_off_at_qwen_widths():
    """At Qwen2.5-3B's widths the default cut-off packs the FFN as int4 (down
    at group 256) and keeps the attention projections int8."""
    specs = tquant.decoder_quant_specs(
        DecoderConfig.qwen25_3b(), tdec._layer_shapes(DecoderConfig.qwen25_3b()), "int4")
    assert specs["w_gate"] == ((1024, 11008), torch.int8)
    assert specs["w_gate_scale4"] == ((4, 11008), torch.float32)
    assert specs["w_down_scale4"] == ((43, 2048), torch.float32)
    for name in ("wq", "wk", "wv", "wo"):
        assert specs[name + "_scale"][1] == torch.bfloat16 and name + "_scale4" not in specs
    assert specs["embed"] == ((151936, 2048), torch.int8)
    assert specs["embed_scale"] == ((151936, 1), torch.bfloat16)
    assert tquant.INT4_MIN_SITE_PARAMS == jquant.INT4_MIN_SITE_PARAMS


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _ids(B, L, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, 512, size=(B, L)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[5, :7] = 0  # left padding
    ids[5, :7] = 0
    return ids, mask


def _forwards(mode, tied, B):
    jcfg, tcfg = _cfgs(tied)
    tree = _tree(jcfg)
    jfn, tfn = MODES[mode]
    kernel = "int4_kernel" if mode.startswith("int4") else "int8_kernel"
    qtree = jfn(jax.tree.map(jnp.asarray, tree))
    ids, mask = _ids(B, 16)
    want = np.asarray(jdec.forward(qtree, dataclasses.replace(jcfg, **{kernel: True}),
                                   jnp.asarray(ids), jnp.asarray(mask)))[:, -1]
    model = tfn(tdec.params_from_jax(tree, tcfg, device="cpu"))
    model.cfg = dataclasses.replace(tcfg, **{kernel: True})
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))[:, -1].float().numpy()
    return got, want


def _assert_gates(got, want, bf16=False):
    """The kernel path's gates (module docstring), for f32 or bf16
    activations."""
    d = np.abs(got - want)
    if bf16:
        assert d.max() <= BF16_TOL, d.max()
        assert np.median(d) <= 2.0**-7 * np.abs(want).max(), np.median(d)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > BF16_TOL
        assert (got.argmax(-1) == want.argmax(-1))[clear].all()
        return
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert d.max() <= KERNEL_TOL, d.max()
    assert np.median(d) <= KERNEL_MEDIAN_TOL, np.median(d)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("mode", ["int8", "int4", "int4_all"])
def test_quantized_forward_matches_jax(mode, tied):
    got, want = _forwards(mode, tied, 64)
    _assert_gates(got, want, bf16=tied)


def test_int8_forward_off_the_kernel_path_matches_jax():
    got, want = _forwards("int8", False, 32)  # M = 512: every site dequantizes
    np.testing.assert_allclose(got, want, rtol=0, atol=DEQUANT_TOL)


def test_quantized_forward_routes_sites_like_jax(monkeypatch):
    """Which sites take which kernel: in int8 at M = 1024, wq, wo and w_down
    take B3 and the gate pair B6 (wk and wv, N = 64, dequantize); at M = 512
    no int8 site takes a kernel; with every site int4, all but wk and wv take
    B7 at any M."""
    from llmrankers_tpu_torch.models import quant as mod

    calls = []
    for name in ("quantized_matmul", "gated_matmul_pair", "quantized_matmul_int4"):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append((_n, tuple(a[1].shape))), _f(*a, **k))[1])
    jcfg, tcfg = _cfgs()
    tree = _tree(jcfg)
    for mode, B, want in (
            ("int8", 64, [("quantized_matmul", (128, 128))] * 2
             + [("gated_matmul_pair", (128, 256)), ("quantized_matmul", (256, 128))]),
            ("int8", 32, []),
            ("int4_all", 32, [("quantized_matmul_int4", (64, 128))] * 2
             + [("quantized_matmul_int4", (64, 256))] * 2
             + [("quantized_matmul_int4", (128, 128))])):
        calls.clear()
        model = MODES[mode][1](tdec.params_from_jax(tree, tcfg, device="cpu"))
        kernel = "int4_kernel" if mode.startswith("int4") else "int8_kernel"
        model.cfg = dataclasses.replace(tcfg, **{kernel: True})
        ids, mask = _ids(B, 16)
        with torch.inference_mode():
            model.forward_hidden(torch.from_numpy(ids), torch.from_numpy(mask))
        assert calls == want * 2, mode
    # plain_kernels: the same sites, on the plain versions
    calls.clear()
    model.plain_kernels = True
    with torch.inference_mode():
        model.forward_hidden(torch.from_numpy(ids), torch.from_numpy(mask))
    assert calls == []


# ---------------------------------------------------------------------------
# Engine, rankers, CLI
# ---------------------------------------------------------------------------
LADDERS = dict(len_buckets=(32, 64, 128, 256), batch_buckets=(4, 8, 16),
               max_batch_tokens=4096)
LABELS = [67, 68, 69]


def _engines(monkeypatch, quantize, tied=False, seed=2, **kw):
    """JAX and port engines on one tree; ``int4_all`` is ``quantize="int4"``
    with every site packed (``min_site_params=0``), so that the 128-wide
    sites reach the W4A8 kernel."""
    from llmrankers_tpu_torch.engine import engine as teng_mod

    monkeypatch.setenv("LLMRANKERS_FORCE_QKERNELS", "1")
    if quantize == "int4_all":
        quantize = "int4"
        monkeypatch.setattr(jquant, "quantize_decoder_params_int4", MODES["int4_all"][0])
        monkeypatch.setattr(teng_mod, "quantize_decoder_params_int4", MODES["int4_all"][1])
    jcfg, tcfg = _cfgs(tied)
    tree = _tree(jcfg, seed)
    jeng = JaxEngine("decoder", jcfg, jax.tree.map(jnp.asarray, tree),
                     JaxByteTokenizer(jcfg.vocab_size), quantize=quantize, **LADDERS, **kw)
    teng = ScoringEngine("decoder", tcfg, tdec.params_from_jax(tree, tcfg, device="cpu"),
                         ByteTokenizer(tcfg.vocab_size), quantize=quantize, **LADDERS, **kw)
    assert jeng.cfg.qkernels and teng.cfg == teng.model.cfg
    assert (teng.cfg.int8_kernel, teng.cfg.int4_kernel) == (jeng.cfg.int8_kernel,
                                                            jeng.cfg.int4_kernel)
    return jeng, teng


def _wave(seed, n_rows=16, prefixes=(70, 45), suffix=(40, 64)):
    rng = np.random.RandomState(seed)
    heads = [list(rng.randint(2, 258, size=n)) for n in prefixes]
    return [heads[i % len(heads)] + list(rng.randint(2, 258, size=rng.randint(*suffix)))
            for i in range(n_rows)]


def _check(jeng, teng, rows):
    want = jeng.score_labels(rows, LABELS)
    got = teng.score_labels(rows, LABELS)
    assert got.dtype == np.float32 and got.shape == (len(rows), len(LABELS))
    _assert_gates(got, want)
    assert set(teng.programs) == {key[0] for key in jeng._jit_cache}
    assert teng.pkv_stats == jeng.pkv_stats


@pytest.mark.parametrize("quantize", ["int8", "int4", "int4_all"])
@pytest.mark.parametrize("path", ["plain", "shared", "cached"])
def test_engine_programs_match_jax(monkeypatch, quantize, path):
    kw = {"plain": dict(prefix_share=False), "shared": dict(prefix_cache_mb=0),
          "cached": {}}[path]
    jeng, teng = _engines(monkeypatch, quantize, **kw)
    rows = _wave(3)
    if path == "shared":
        np.testing.assert_array_equal(teng._group(rows)[1][2].numpy(),
                                      np.asarray(jeng._group(rows)[1][2]))
    _check(jeng, teng, rows)
    if path == "cached":  # the second wave hits the cached prefixes
        _check(jeng, teng, rows[::-1])
        assert teng.pkv_stats == {"hits": 2, "misses": 2, "evictions": 0}
    assert set(teng.programs) == {"plain": {"dec_labels"}, "shared": {"dec_labels_shared"},
                                  "cached": {"prefix_kv", "dec_labels_pre"}}[path]


def _queries(n_docs=12):
    queries = ["what about topic 3", "tell me of topic 11"]
    rankings = [
        [SearchResult(docid=f"q{qi}d{i}", score=float(-i),
                      text=f"this passage talks about topic {(i * 5 + qi) % n_docs}")
         for i in range(n_docs)]
        for qi in range(len(queries))
    ]
    return queries, rankings


@pytest.mark.parametrize("quantize", ["int8", "int4_all"])
def test_setwise_quantized_orders_match_jax(monkeypatch, quantize):
    jeng, teng = _engines(monkeypatch, quantize, seed=3)
    kw = dict(num_child=2, k=4, scoring="likelihood", method="heapsort")
    jr, tr = JaxSetwise(jeng, **kw), SetwiseLlmRanker(teng, **kw)
    queries, rankings = _queries()
    want = jr.rerank_many(queries, rankings)
    got = tr.rerank_many(queries, rankings)
    assert [[d.docid for d in r] for r in got] == [[d.docid for d in r] for r in want]
    assert tr.stats.comparisons == jr.stats.comparisons > 0
    assert tr.wave_stats == jr.wave_stats
    assert teng.pkv_stats == jeng.pkv_stats


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_cli_quantized_decoder_matches_jax(tmp_path, monkeypatch, quantize):
    """The port's CLI with --quantize on random:dec-tiny against the JAX CLI
    on the same argv and the same JAX draw of weights. dec-tiny is 64 wide,
    so no site reaches a kernel: a test of the wiring."""
    from llmrankers_tpu.cli import run as jrun
    from llmrankers_tpu_torch.cli import run as trun

    monkeypatch.setenv("LLMRANKERS_FORCE_QKERNELS", "1")
    (tmp_path / "q.tsv").write_text("".join(f"q{i}\tquery about topic {i}\n" for i in range(2)))
    (tmp_path / "c.jsonl").write_text("".join(
        json.dumps({"id": f"d{d}", "text": f"this passage talks about topic {d}"}) + "\n"
        for d in range(12)))
    (tmp_path / "run.txt").write_text("".join(
        f"q{i} Q0 d{d} {d + 1} {100 - d} bm25\n" for i in range(2) for d in range(12)))
    argv = ["run", "--model_name_or_path", "random:dec-tiny",
            "--run_path", str(tmp_path / "run.txt"), "--query_file", str(tmp_path / "q.tsv"),
            "--corpus_file", str(tmp_path / "c.jsonl"), "--save_path", str(tmp_path / "out.txt"),
            "--scoring", "likelihood", "--device", "cpu", "--dtype", "float32",
            "--quantize", quantize,
            "setwise", "--num_child", "2", "--method", "heapsort", "--k", "3"]

    def jax_init(cfg, gen, dtype, device):
        jcfg = JaxDecoderConfig(**dataclasses.asdict(cfg))
        tree = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.PRNGKey(929)))
        return tdec.params_from_jax(tree, cfg, dtype=dtype, device=device)

    monkeypatch.setattr(tdec, "init_params", jax_init)
    jrun.main(jrun.parse_args(argv))
    want = (tmp_path / "out.txt").read_text()
    (tmp_path / "out.txt").unlink()
    report = trun.main(trun.parse_args(argv))
    assert (tmp_path / "out.txt").read_text() == want
    assert report.total.comparisons > 0


def test_awq_calib_is_not_ported(tmp_path):
    from llmrankers_tpu_torch.cli import run as trun

    args = trun.parse_args(["run", "--awq_calib_file", str(tmp_path / "p.txt"),
                            "--quantize", "int8", "setwise"])
    with pytest.raises(NotImplementedError, match="A9 \\(AWQ\\)"):
        trun.main(args)


# ---------------------------------------------------------------------------
# Default device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("entry", ["T5", "t5.init_params", "t5.params_from_jax", "Decoder",
                                   "decoder.init_params", "decoder.params_from_jax"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device=`` the weight entry points build on the card; with no
    GPU they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    t5cfg, dcfg = T5Config.tiny(), DecoderConfig.tiny()
    gen = torch.Generator()
    calls = {
        "T5": lambda: tt5.T5(t5cfg),
        "t5.init_params": lambda: tt5.init_params(t5cfg, gen),
        "t5.params_from_jax": lambda: tt5.params_from_jax({"encoder": {"layers": {}}}, t5cfg),
        "Decoder": lambda: tdec.Decoder(dcfg),
        "decoder.init_params": lambda: tdec.init_params(dcfg, gen),
        "decoder.params_from_jax": lambda: tdec.params_from_jax({"layers": {}}, dcfg),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
