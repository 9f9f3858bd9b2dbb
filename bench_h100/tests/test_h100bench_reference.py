"""The plain references against the port's plain path (every kernel site on
its plain version, on the CPU) at a tiny size in float32: the same weights
from the benchmark's generator, the same quantization worked out on each
side."""
import numpy as np
import pytest
import torch

from harness import port, weights
from llmrankers_tpu_torch.engine import generate as gen
from reference import qwen2, t5

T5_CONF = {"d_model": 128, "d_kv": 32, "num_heads": 4, "d_ff": 256, "num_layers": 2,
           "num_decoder_layers": 2, "vocab_size": 300, "feed_forward_proj": "gated-gelu",
           "layer_norm_epsilon": 1e-6, "relative_attention_num_buckets": 32,
           "relative_attention_max_distance": 128, "tie_word_embeddings": False,
           "port": {"kind": "t5", "engine": {"quantize": "int8"}}}
DEC_CONF = {"hidden_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2,
            "intermediate_size": 256, "num_hidden_layers": 2, "vocab_size": 300,
            "rms_norm_eps": 1e-6, "rope_theta": 1e6, "model_type": "qwen2",
            "tie_word_embeddings": True, "max_position_embeddings": 4096,
            "eos_token_id": 299, "port": {"kind": "decoder", "engine": {"kv_quantize": "int8"}}}


def _build(ref, conf, seed=2**31 + 3):
    w = weights.make(ref.param_specs(conf), seed, device="cpu", dtype=torch.float32)
    return w, weights.getter(w), port.engine(conf, w, device="cpu", dtype=torch.float32)


def test_t5_encoder_and_label_logits():
    w, get, eng = _build(t5, T5_CONF)
    rng = np.random.default_rng(0)
    rows = [rng.integers(2, 258, size=n).tolist() for n in (128, 100, 90, 75, 60, 128, 33, 120)]
    ids, mask, n, B = eng._pad_batch(rows)
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    M = ids.shape[0] * ids.shape[1]
    assert M >= 1024  # the encoder sites run W8A8
    with torch.inference_mode():
        got = eng.model.encode(ids_t, mask_t).float()
        want = t5.encode(get, T5_CONF, ids_t, mask_t, M)
        valid = mask_t.bool()
        rel = float((got[valid] - want[valid]).norm() / want[valid].norm())
        # Every site agrees to float32 rounding on the same inputs; a rounding
        # difference that moves an activation across a round-half boundary
        # flips its int8 value, and that difference carries to later sites.
        assert rel < 0.01
        prefix, labels = [0, 50, 99, 117], [67, 68, 69]
        got_l = eng.score_labels(rows, labels, prefix)
        want_l = t5.label_logits(get, T5_CONF, want, mask_t, M, B, prefix, labels)
        assert np.abs(got_l - want_l.numpy()).max() < 0.01
        # the control's weights (int4) move it by far more
        ctl = t5.encode(get, T5_CONF, ids_t, mask_t, M, bits=4)
        assert float((ctl[valid] - want[valid]).norm() / want[valid].norm()) > 10 * rel


def test_qwen2_forward_and_int8_cache():
    w, get, eng = _build(qwen2, DEC_CONF)
    model = eng.model
    rng = np.random.default_rng(1)
    prompt = rng.integers(2, 258, size=40).tolist()
    served = rng.integers(2, 300, size=6).tolist()
    ids = torch.tensor([prompt])
    mask = torch.ones_like(ids, dtype=torch.int32)
    got = []
    with torch.inference_mode():
        logits, (kc, vc, kmask, pos) = gen.decoder_prefill(model, ids, mask, len(served),
                                                           kv_quant="int8")
        got.append(logits[0])
        for t, tok in enumerate(served[:-1]):
            cos, sin = model.rope(pos[:, None], torch.float32)
            logits, k_new, v_new = gen._decode_token_forward(
                model, torch.tensor([tok]), kc, vc, kmask, cos, sin)
            gen._cache_put(kc, k_new[:, :, :, None, :], len(prompt) + t)
            gen._cache_put(vc, v_new[:, :, :, None, :], len(prompt) + t)
            kmask[:, len(prompt) + t] = True
            pos = pos + 1
            got.append(logits[0])
        got = torch.stack(got)
        want = qwen2.served_logits(get, DEC_CONF, prompt + served[:-1], len(prompt))
        err = float((got - want).abs().max())
        assert err < 1e-4
        # without the cache's quantization the reference reads otherwise
        plain = torch.stack([qwen2.served_logits(get, DEC_CONF, prompt + served[:t], len(prompt) + t)[0]
                             for t in range(len(served))])
        assert float((plain - want).abs().max()) > 10 * err
        gaps = qwen2.gaps(want, served)
        assert gaps.shape == (len(served),) and float(gaps.min()) >= 0
        assert float(qwen2.gaps(want, want.argmax(1).tolist()).max()) == 0.0


@pytest.mark.parametrize("shape", [(5, 128, 4), (3, 256, 2)])
def test_kblock_is_the_ports_rule(shape):
    from llmrankers_tpu_torch.ops.int8_matmul import kblock
    from reference import quant

    for K, N in ((2048, 6144), (2048, 2048), (5120, 2048), (2048, 5120), (2048, 4096),
                 (11008, 2048), (128, 384), (256, 128)):
        assert quant.kblock(K, N) == kblock(K, N)
        assert quant.kblock(K, N, gated=True) == kblock(K, N, gated=True)
    # the activation rows quantize as the port's plain version does
    from llmrankers_tpu_torch.ops.int8_matmul import quantize_blocks

    x = torch.randn(shape[0], shape[1] * shape[2])
    q, s = quantize_blocks(x, shape[1])
    assert torch.equal(quant.rows(x, shape[1]), (q * s[..., None]).reshape(x.shape))
