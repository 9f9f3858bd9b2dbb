"""Port parity: ``llmrankers_tpu_torch.models.t5`` against the JAX T5.

The JAX init draws one parameter tree; ``params_from_jax`` loads the same
numbers into the port's module. Encoder outputs, decoder hidden states, label
logits and full-vocabulary logits must agree within 2e-4 in fp32, the bar
``tests/test_models.py`` sets against HF. The port's encoder runs both with
the flash wrapper (its plain version on CPU) and with plain attention; every
row has at least one real token, where the two attention semantics agree.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llmrankers_tpu.models import t5 as jt5
from llmrankers_tpu.models.config import T5Config
from llmrankers_tpu_torch.models import t5 as tt5
from llmrankers_tpu_torch.models.config import T5Config as TorchT5Config

TOL = 2e-4


def _torch_cfg(cfg):
    """The port's own T5Config with the fields of a JAX one."""
    return TorchT5Config(**dataclasses.asdict(cfg))


@pytest.fixture(autouse=True)
def _fp32_reference(monkeypatch):
    # fp32 reference numerics: no TF32 in any matmul.
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _cfg(variant):
    cfg = T5Config.tiny()
    if variant == "tied_relu":  # t5-v1.0 layout: tied embeddings, relu FFN
        cfg = dataclasses.replace(cfg, tie_word_embeddings=True,
                                  feed_forward_proj="relu")
    return cfg


def _models(variant):
    cfg = _cfg(variant)
    tree = jax.tree.map(np.asarray, jt5.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, tree, tt5.params_from_jax(tree, _torch_cfg(cfg), device="cpu")


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    B, L, T = 3, 21, 4
    ids = rng.randint(2, cfg.vocab_size, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 15:] = 0
    mask[2, 4:] = 0
    ids[mask == 0] = 0
    dec = rng.randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    return ids, mask, dec


@pytest.mark.parametrize("variant", ["flan", "tied_relu"])
@pytest.mark.parametrize("use_flash", [True, False])
def test_t5_matches_jax(variant, use_flash):
    cfg, tree, model = _models(variant)
    model.use_flash = use_flash
    ids, mask, dec = _batch(cfg)
    jp = jax.tree.map(jnp.asarray, tree)
    want_enc = jt5.encode(jp, cfg, jnp.asarray(ids), jnp.asarray(mask))
    want_hid = jt5.decode_hidden(jp, cfg, jnp.asarray(dec), want_enc, jnp.asarray(mask))
    want_logits = jt5.forward(jp, cfg, jnp.asarray(ids), jnp.asarray(mask),
                              jnp.asarray(dec))
    labels = np.array([67, 68, 69, 3], np.int32)
    want_lab = jt5.label_logits(jp, cfg, want_hid[:, -1], jnp.asarray(labels))

    ids_t, mask_t, dec_t = map(torch.from_numpy, (ids, mask, dec))
    with torch.inference_mode():
        enc = model.encode(ids_t, mask_t)
        hid = model.decode_hidden(dec_t, enc, mask_t)
        lab = model.label_logits(hid[:, -1], torch.from_numpy(labels).long())
        logits = model(ids_t, mask_t, dec_t)
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), rtol=0, atol=TOL)
    np.testing.assert_allclose(hid.numpy(), np.asarray(want_hid), rtol=0, atol=TOL)
    np.testing.assert_allclose(lab.numpy(), np.asarray(want_lab), rtol=0, atol=TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=TOL)
    # label_logits is the gather of the full projection
    np.testing.assert_allclose(lab.numpy(), logits[:, -1][:, labels].numpy(),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_matches_jax(bidirectional):
    rel = np.arange(-3000, 3000, dtype=np.int32)
    want = jt5.relative_position_bucket(jnp.asarray(rel), bidirectional, 32, 128)
    got = tt5.relative_position_bucket(torch.from_numpy(rel), bidirectional, 32, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compute_bias_matches_jax():
    cfg, tree, model = _models("flan")
    want = jt5.compute_bias(jnp.asarray(tree["encoder"]["rel_bias"]), 9, 13, True, cfg)
    got = tt5.compute_bias(model.encoder.rel_bias, 9, 13, True, _torch_cfg(cfg))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_params_from_jax_rejects_wrong_shapes():
    cfg, tree, _ = _models("flan")
    tree["encoder"]["layers"]["q"] = tree["encoder"]["layers"]["q"][:, :, :8]
    with pytest.raises(ValueError, match="encoder.q"):
        tt5.params_from_jax(tree, _torch_cfg(cfg), device="cpu")


def test_init_params_layout_and_scales():
    """init_params gives the JAX tree's names and shapes, T5's fan-in
    scales, and the same weights from the same seed."""
    cfg, tree, _ = _models("flan")

    def make(seed):
        return tt5.init_params(_torch_cfg(cfg), torch.Generator().manual_seed(seed), device="cpu")

    a, b, c = make(0), make(0), make(1)
    lp = a.encoder.layers[0]
    assert set(lp.keys()) == set(tree["encoder"]["layers"])
    assert set(a.decoder.layers[0].keys()) == set(tree["decoder"]["layers"])
    for key, p in lp.items():
        assert tuple(p.shape) == tree["encoder"]["layers"][key].shape[1:]
    assert torch.equal(a.shared, b.shared) and not torch.equal(a.shared, c.shared)
    assert float(lp["ln1"].min()) == float(lp["ln1"].max()) == 1.0
    want = (cfg.d_model * cfg.d_kv) ** -0.5
    assert abs(float(a.decoder.layers[1]["cq"].std()) - want) < 0.1 * want
