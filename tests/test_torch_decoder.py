"""Port parity: the torch ``Decoder`` and its scoring prefill against JAX.

The same numpy parameter tree (JAX ``init_params`` with the norms, biases
and head norms redrawn at random, so that every leaf matters) goes into the
JAX functions and, through ``params_from_jax``, into the port's module; the
same numpy token rows go into both. Hidden states and logits are compared in
fp32 on the real positions of left-padded rows, within 2e-4 absolute (the
two frameworks sum in other orders; the values are O(1)). Padding positions
attend to no real key, so their values are not compared.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llmrankers_tpu.engine import generate as jgen
from llmrankers_tpu.models import decoder as jdec
from llmrankers_tpu.models.config import DecoderConfig as JaxDecoderConfig
from llmrankers_tpu.ops import attention as jattn
from llmrankers_tpu_torch.engine import generate as tgen
from llmrankers_tpu_torch.models import decoder as tdec
from llmrankers_tpu_torch.models.config import DecoderConfig
from llmrankers_tpu_torch.ops import attention as tattn

TOL = 2e-4
CONFIGS = {
    "tiny": {},
    "qk_norm": dict(qk_norm=True),
    "attention_bias": dict(attention_bias=True),
    "window64": dict(sliding_window=64),
    "tied": dict(tie_word_embeddings=True),
}


@pytest.fixture(autouse=True)
def _fp32_reference(monkeypatch):
    # fp32 reference numerics: no TF32 in any matmul.
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _configs(name):
    kw = dict(CONFIGS[name])
    tiny_kw = {k: kw.pop(k) for k in ("qk_norm", "attention_bias") if k in kw}
    return (dataclasses.replace(JaxDecoderConfig.tiny(**tiny_kw), **kw),
            dataclasses.replace(DecoderConfig.tiny(**tiny_kw), **kw))


def _tree(jcfg, seed=0):
    """A JAX parameter tree as numpy, with every norm and bias redrawn."""
    tree = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    for key, leaf in tree["layers"].items():
        if key.startswith(("ln", "b")) or key.endswith("_norm"):
            base = 1.0 if not key.startswith("b") else 0.0
            tree["layers"][key] = (base + 0.3 * rng.randn(*leaf.shape)).astype(np.float32)
    tree["final_ln"] = (1.0 + 0.3 * rng.randn(*tree["final_ln"].shape)).astype(np.float32)
    return tree


def _left_padded(B, L, seed, lens=None):
    rng = np.random.RandomState(seed)
    lens = lens if lens is not None else rng.randint(L // 3, L + 1, size=B)
    ids = np.zeros((B, L), np.int32)
    mask = np.zeros((B, L), np.int32)
    for b, n in enumerate(lens):
        ids[b, L - n:] = rng.randint(2, 258, size=n)
        mask[b, L - n:] = 1
    return ids, mask


def _models(name, seed=0):
    jcfg, tcfg = _configs(name)
    tree = _tree(jcfg, seed)
    return jcfg, tcfg, tree, tdec.params_from_jax(tree, tcfg, device="cpu")


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_hidden_matches_jax(name):
    jcfg, tcfg, tree, model = _models(name)
    # L 96 > the 64 window, so the window masks real keys.
    ids, mask = _left_padded(4, 96, seed=1, lens=[96, 90, 40, 7])
    want, want_pos = jdec.forward_hidden(_jtree(tree), jcfg, jnp.asarray(ids),
                                         jnp.asarray(mask))
    with torch.no_grad():
        got, pos = model.forward_hidden(torch.from_numpy(ids), torch.from_numpy(mask))
    real = mask.astype(bool)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], rtol=0, atol=TOL)


def test_window_changes_the_result():
    """Control: at L 96 the 64 window must matter, or the window case would
    test nothing."""
    _, _, _, windowed = _models("window64")
    _, _, _, full = _models("tiny")
    ids, mask = _left_padded(2, 96, seed=1, lens=[96, 90])
    with torch.no_grad():
        a, _ = windowed.forward_hidden(torch.from_numpy(ids), torch.from_numpy(mask))
        b, _ = full.forward_hidden(torch.from_numpy(ids), torch.from_numpy(mask))
    assert (a[:, -1] - b[:, -1]).abs().max() > 1e-2


@pytest.mark.parametrize("name", ["tiny", "tied"])
def test_logits_match_jax(name):
    jcfg, tcfg, tree, model = _models(name, seed=2)
    ids, mask = _left_padded(3, 40, seed=3)
    labels = np.array([67, 68, 69, 70], np.int32)
    jt = _jtree(tree)
    hidden, _ = jdec.forward_hidden(jt, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    want_lab = jdec.label_logits(jt, jcfg, hidden[:, -1, :], jnp.asarray(labels))
    want_all = jdec.forward(jt, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        h, _ = model.forward_hidden(torch.from_numpy(ids), torch.from_numpy(mask))
        got_lab = model.label_logits(h[:, -1, :], torch.from_numpy(labels).long())
        got_all = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert (model.lm_head is None) == (name == "tied")
    np.testing.assert_allclose(got_lab.numpy(), np.asarray(want_lab), rtol=0, atol=TOL)
    real = mask.astype(bool)
    np.testing.assert_allclose(got_all.numpy()[real], np.asarray(want_all)[real],
                               rtol=0, atol=TOL)
    # label_logits reads the label columns of the full projection.
    np.testing.assert_allclose(got_lab.numpy(), got_all[:, -1, labels].numpy(),
                               rtol=0, atol=1e-5)


def _prefix_inputs(B=5, G=2, Lp=80, Ls=48, seed=4):
    """Per-group right-padded prefixes, rows gathering a group, and
    right-padded suffixes: the shared path's layout, holes included."""
    rng = np.random.RandomState(seed)
    plen = [Lp - 9, 30][:G]
    pids = np.zeros((G, Lp), np.int32)
    pmask = np.zeros((G, Lp), np.int32)
    for g, n in enumerate(plen):
        pids[g, :n] = rng.randint(2, 258, size=n)
        pmask[g, :n] = 1
    gidx = np.array([0, 1, 0, 1, 0][:B], np.int32)
    slen = [Ls, 20, 1, 33, 48][:B]
    sids = np.zeros((B, Ls), np.int32)
    smask = np.zeros((B, Ls), np.int32)
    for b, n in enumerate(slen):
        sids[b, :n] = rng.randint(2, 258, size=n)
        smask[b, :n] = 1
    return pids, pmask, gidx, sids, smask


@pytest.mark.parametrize("name", ["tiny", "window64"])
def test_prefix_kv_and_shared_prefill_match_jax(name):
    """decoder_prefix_kv and decoder_shared_prefill (the causal offset at
    Lp with holes between prefix and suffix; with a 64 window the dense
    positional mask) against the JAX functions."""
    jcfg, tcfg, tree, model = _models(name, seed=5)
    pids, pmask, gidx, sids, smask = _prefix_inputs()
    jt = _jtree(tree)
    jks, jvs = jgen.decoder_prefix_kv(jt, jcfg, jnp.asarray(pids), jnp.asarray(pmask))
    jpre_k = jnp.take(jks, jnp.asarray(gidx), axis=1)
    jpre_v = jnp.take(jvs, jnp.asarray(gidx), axis=1)
    want, _ = jgen.decoder_shared_prefill(
        jt, jcfg, jpre_k, jpre_v, jnp.asarray(pmask[gidx]), jnp.asarray(sids),
        jnp.asarray(smask), None)
    with torch.no_grad():
        ks, vs = tgen.decoder_prefix_kv(model, torch.from_numpy(pids),
                                        torch.from_numpy(pmask))
        g = torch.from_numpy(gidx).long()
        got, cache = tgen.decoder_shared_prefill(
            model, ks.index_select(1, g), vs.index_select(1, g),
            torch.from_numpy(pmask[gidx]), torch.from_numpy(sids), torch.from_numpy(smask))
    assert cache is None
    real = pmask.astype(bool)  # [G, Lp]; ks [Ld, G, KV, Lp, Dh]
    for t, j in ((ks, jks), (vs, jvs)):
        np.testing.assert_allclose(t.numpy().transpose(1, 3, 0, 2, 4)[real],
                                   np.asarray(j).transpose(1, 3, 0, 2, 4)[real],
                                   rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_shared_prefill_equals_whole_prompt_forward():
    """The shared path scores a row as the plain path scores the row's whole
    prompt: prefix K/V plus suffix at the RoPE offset of the prefix length."""
    _, tcfg, _, model = _models("tiny", seed=6)
    pids, pmask, gidx, sids, smask = _prefix_inputs(seed=7)
    rows = [list(pids[g][pmask[g] == 1]) + list(sids[b][smask[b] == 1])
            for b, g in enumerate(gidx)]
    L = max(map(len, rows))
    ids = np.zeros((len(rows), L), np.int32)
    mask = np.zeros_like(ids)
    for b, r in enumerate(rows):
        ids[b, L - len(r):] = r
        mask[b, L - len(r):] = 1
    with torch.no_grad():
        ks, vs = tgen.decoder_prefix_kv(model, torch.from_numpy(pids), torch.from_numpy(pmask))
        g = torch.from_numpy(gidx).long()
        got, _ = tgen.decoder_shared_prefill(
            model, ks.index_select(1, g), vs.index_select(1, g),
            torch.from_numpy(pmask[gidx]), torch.from_numpy(sids), torch.from_numpy(smask))
        want, _ = model.forward_hidden(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want[:, -1].numpy(), rtol=0, atol=TOL)


def test_generation_cache_is_not_ported():
    """``max_new_tokens`` on the shared prefill now builds the generation
    cache: [prefix | suffix | free slots] along T, its key mask and next
    positions equal JAX's, and its K/V within the fp32 tolerance."""
    jcfg, _, tree, model = _models("tiny")
    pids, pmask, gidx, sids, smask = _prefix_inputs()
    jt = _jtree(tree)
    jks, jvs = jgen.decoder_prefix_kv(jt, jcfg, jnp.asarray(pids), jnp.asarray(pmask))
    _, (wk, wv, wmask, wpos) = jgen.decoder_shared_prefill(
        jt, jcfg, jnp.take(jks, jnp.asarray(gidx), axis=1),
        jnp.take(jvs, jnp.asarray(gidx), axis=1), jnp.asarray(pmask[gidx]),
        jnp.asarray(sids), jnp.asarray(smask), 4)
    with torch.no_grad():
        ks, vs = tgen.decoder_prefix_kv(model, torch.from_numpy(pids), torch.from_numpy(pmask))
        g = torch.from_numpy(gidx).long()
        _, (gk, gv, gmask, gpos) = tgen.decoder_shared_prefill(
            model, ks.index_select(1, g), vs.index_select(1, g),
            torch.from_numpy(pmask[gidx]), torch.from_numpy(sids), torch.from_numpy(smask),
            max_new_tokens=4)
    assert gk.shape == np.asarray(wk).shape == (2, 5, 2, 80 + 48 + 4, 16)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
    for got, want in ((gk, wk), (gv, wv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_rope_and_positions_match_jax():
    rng = np.random.RandomState(8)
    mask = (rng.rand(3, 50) > 0.3).astype(np.int32)
    np.testing.assert_array_equal(
        tdec.positions_from_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jdec.positions_from_mask(jnp.asarray(mask))))
    pos = rng.randint(0, 30000, size=(3, 50)).astype(np.int32)
    x = rng.randn(3, 4, 50, 128).astype(np.float32)
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-4),
                               (torch.bfloat16, jnp.bfloat16, 2e-2)):
        cos, sin = tattn.rope_cos_sin(torch.from_numpy(pos), 128, 1e6, dtype)
        jcos, jsin = jattn.rope_cos_sin(jnp.asarray(pos), 128, 1e6, jdtype)
        assert cos.dtype == dtype
        np.testing.assert_allclose(cos.float().numpy(), np.asarray(jcos, np.float32),
                                   rtol=0, atol=tol)
        got = tattn.apply_rope(torch.from_numpy(x).to(dtype), cos, sin)
        want = jattn.apply_rope(jnp.asarray(x, jdtype), jcos, jsin)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=0, atol=4 * tol)


def test_init_params_scales():
    cfg = dataclasses.replace(DecoderConfig.tiny(attention_bias=True, qk_norm=True),
                              hidden_size=256, intermediate_size=512)
    model = tdec.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lp = model.layers[0]
    assert torch.all(lp["ln1"] == 1) and torch.all(lp["q_norm"] == 1)
    assert torch.all(lp["bq"] == 0)
    for key, fan_in in (("wq", 256), ("wo", 256), ("w_down", 512)):
        assert abs(lp[key].std().item() - fan_in**-0.5) < 0.1 * fan_in**-0.5
    assert abs(model.embed.std().item() - 0.02) < 0.002
    assert model.lm_head is not None
