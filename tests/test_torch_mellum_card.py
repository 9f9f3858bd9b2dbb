"""Mellum 2's decode step and windowed prefill on the card: marked ``card``
and skipped without a GPU (run them there with ``python -m pytest
tests/test_torch_mellum_card.py -q -m card``; no JAX here).

- A small Mellum-shaped decoder (3 sliding : 1 full layer, YaRN on the full
  one, 8 routed experts of which each token takes 2) in bf16: through the
  engine every decode step of a dispatch replays one captured graph (0 eager
  steps), the replayed decode equals the eager decode bit for bit (tokens,
  cache bytes, key mask), and the routing counts it accumulates on the
  device, inside the graph, equal the eager decode's.
- B5 with a window on a right-padded prefix rolled against its suffix, at
  the cell's widths (32 heads over 4, head 128, window 1024, a prefix of
  441-480 tokens on a 512 area, suffixes up to 2176), equals plain attention
  under the dense positional mask: position p_k visible from p_q iff 0 <=
  p_q - p_k < 1024.
"""
import pytest
import torch

from llmrankers_tpu_torch.engine import generate as gen
from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import decoder as dec
from llmrankers_tpu_torch.models.config import DecoderConfig
from llmrankers_tpu_torch.ops.attention import mha

LAYERS = ("sliding_attention",) * 3 + ("full_attention",)
ROPE = (("full_attention", (("attention_factor", 1.2772588722239782), ("beta_fast", 32),
                            ("beta_slow", 1), ("factor", 16),
                            ("original_max_position_embeddings", 256),
                            ("rope_theta", 500000), ("rope_type", "yarn"))),
        ("sliding_attention", (("rope_theta", 500000), ("rope_type", "default"))))
CFG = DecoderConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
                    head_dim=64, sliding_window=32, layer_types=LAYERS,
                    mlp_layer_types=("sparse",) * 4, rope_parameters=ROPE, num_experts=8,
                    num_experts_per_tok=2, moe_intermediate_size=64, norm_topk_prob=True)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return dec.init_params(CFG, torch.Generator(device="cuda").manual_seed(5),
                           dtype=torch.bfloat16, device="cuda")


def _rows(n, seed=0, lo=60, hi=100):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(2, 258, (int(torch.randint(lo, hi, (1,), generator=g)),),
                          generator=g).tolist() for _ in range(n)]


@pytest.mark.card
def test_decode_replays_one_graph_and_equals_eager(model):
    eng = ScoringEngine("decoder", CFG, model, ByteTokenizer(512), kv_quantize="int8",
                        prefix_share=False, len_buckets=(128,), batch_buckets=(8,))
    rows = _rows(6)
    eng.generate(rows, max_new_tokens=24)
    assert eng.graph_stats == {"captures": 1, "replays": 24, "eager_steps": 0}
    # The replayed decode against the eager one, on the same prefill.
    ids = torch.randint(2, 258, (8, 96), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    mask = torch.ones_like(ids)
    mask[3, :30] = 0
    steps, eos, T = 40, 9, 96 + 40
    with torch.inference_mode():
        logits, cache = gen.decoder_prefill(model, ids, mask, steps, kv_quant="int8")
        model.moe_counts.zero_()
        want, (wtok, wcache, _) = gen.decoder_decode_chunk(
            model, logits.argmax(-1), cache, 96, 0, steps, eos)
        want_counts = model.moe_counts.clone()
        st = gen.DecodeState.alloc(model, 8, T, gen._act_dtype(model), "int8")
        st.capture(model, eos)
        logits, cache = gen.decoder_prefill(model, ids, mask, steps, kv_quant="int8",
                                            bufs=(st.kc, st.vc))
        model.moe_counts.zero_()
        got, (tok, gcache, _) = gen.decoder_decode_chunk(
            model, logits.argmax(-1), cache, 96, 0, steps, eos, state=st, replay=True)
        torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(tok, wtok)
    assert torch.equal(gcache[2], wcache[2])
    for a, b in zip(gcache[0] + gcache[1], wcache[0] + wcache[1]):
        assert torch.equal(a, b)
    assert torch.equal(model.moe_counts, want_counts)
    # layers x k x live rows x steps, rows leaving once they emit EOS
    assert 0 < int(want_counts[0]) <= 4 * 2 * 8 * steps


@pytest.mark.card
def test_b5_window_on_a_rolled_prefix_equals_the_positional_mask():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, H, KV, Dh, W, Lp, Ls = 2, 32, 4, 128, 1024, 512, 2176
    g = torch.Generator(device="cuda").manual_seed(3)
    pre_len, suf_len = torch.tensor([441, 480]), torch.tensor([2176, 1900])
    pre_mask = (torch.arange(Lp)[None] < pre_len[:, None]).int().cuda()
    suf_mask = (torch.arange(Ls)[None] < suf_len[:, None]).int().cuda()

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=torch.bfloat16)

    q, k, v = rnd(B, H, Ls, Dh), rnd(B, KV, Ls, Dh), rnd(B, KV, Ls, Dh)
    pk, pv = rnd(B, KV, Lp, Dh), rnd(B, KV, Lp, Dh)
    roll = gen._prefix_roll(pre_mask)
    idx = roll[:, None, :, None].expand(-1, KV, -1, Dh)
    kmask = torch.cat([pre_mask.gather(1, roll), suf_mask], dim=1).contiguous()
    got = mha(q, torch.cat([pk.gather(2, idx), k], 2), torch.cat([pv.gather(2, idx), v], 2),
              kv_mask=kmask, causal=True, scale=Dh ** -0.5, use_flash=True, window=W)
    # The plain path on the prefix as it lies, under the dense positional mask.
    pos_q = pre_len.cuda()[:, None] + torch.arange(Ls, device="cuda")[None]
    pos_k = torch.cat([torch.arange(Lp, device="cuda")[None].expand(B, -1), pos_q], 1)
    rel = pos_q[:, :, None] - pos_k[:, None, :]
    valid = torch.cat([pre_mask, suf_mask], 1).bool()
    dense = ((rel >= 0) & (rel < W) & valid[:, None, :])[:, None]
    want = mha(q.float(), torch.cat([pk, k], 2).float(), torch.cat([pv, v], 2).float(),
               mask=dense, scale=Dh ** -0.5)
    for b in range(B):
        n = int(suf_len[b])
        err = (got[b, :, :n].float() - want[b, :, :n]).abs().max()
        assert float(err) < 2e-2, (b, float(err))
