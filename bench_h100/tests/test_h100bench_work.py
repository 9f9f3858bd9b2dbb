"""Each metric's work function against a count made by hand at a tiny
shape (the least-time function is replaced by one that records what it is
given)."""
import pytest
import torch

from harness import cell, yardstick

T5 = {"d_model": 4, "num_heads": 1, "d_kv": 2, "d_ff": 3, "num_layers": 1,
      "num_decoder_layers": 1, "port": {"kind": "t5", "engine": {"quantize": "int8"}}}
DEC = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4,
       "intermediate_size": 3, "num_hidden_layers": 1, "vocab_size": 10,
       "port": {"kind": "decoder", "engine": {"kv_quantize": "int8"}}}


def _module(name):
    read = cell.metric_reader(name)
    return read.__globals__


@pytest.fixture
def recorded(monkeypatch):
    seen = []

    def patch(mod):
        monkeypatch.setitem(mod, "least_s", lambda *a: seen.append(a) or 0.0)
        return seen

    return patch


def test_t5_step_work():
    int8, bf16, nbytes = _module("score.mfu")["work"](T5, [2, 3], 1, 2)
    # I = 2; encoder sites 4*6 + 2*4 + 2*4*3 + 3*4 = 68 weights; cross K|V 16.
    assert int8 == 2 * 5 * (68 + 16)
    # decoder sites but cross K|V at B*T = 2 tokens: 24 + 8 + 8 + 8 + 24 + 12 = 84
    # weights; encoder attention 4*2*(4 + 9); decoder self 4*2*1*1*2, cross
    # 4*1*5*2; labels 2*2*4*2.
    assert bf16 == 2 * 2 * 84 + 4 * 2 * 13 + 4 * 2 * 1 * 2 + 4 * 1 * 5 * 2 + 2 * 2 * 4 * 2
    scales = 4 * ((6 + 4 + 6 + 4) + (6 + 8 + 2 + 4 + 6 + 4))
    assert nbytes == 68 + 100 + scales + 2 * 4 * (5 + 2) + 2 * 4 * 2 + 4 * 2 * 2


def test_flash_work():
    assert _module("score.flash_attn_roofline")["work"](T5, [2, 3]) == (4 * 2 * 13, 8 * 2 * 5)


def test_int8_gemm_work(recorded):
    mod = _module("score.int8_gemm_roofline")
    seen = recorded(mod)
    mod["work"](T5, 5)
    # (K, N, N out): qkv (4, 6, 6), o (2, 4, 4), wi (4, 6, 3), wo (3, 4, 4), ckv (4, 4, 4)
    want = [(2 * 5 * K * N, 0, K * N + 4 * N + 2 * 5 * (K + No))
            for K, N, No in ((4, 6, 6), (2, 4, 4), (4, 6, 3), (3, 4, 4), (4, 4, 4))]
    assert seen == want


def test_trie():
    trie = _module("gen.mfu")["trie"]
    # [1,2,3], [1,2,4,5], [7]: 3 + 2 + 1 positions; pairs 1+2+3, 3+4, 1
    assert trie([[1, 2, 4, 5], [7], [1, 2, 3]]) == (6, 14)


def test_generation_step_work(recorded):
    mod = _module("gen.mfu")
    seen = recorded(mod)
    mod["work"](DEC, [[1, 2]], [[5, 6]])
    layer_w = 8 * 4 * 4 + 8 * 8 + 3 * 8 * 3  # qkv, o, gate|up|down
    wbytes = 2 * (layer_w + 10 * 8)
    kvb = 1 * 2 * (4 + 4)  # one position: K and V int8 rows with f32 scales
    tok = 2 * layer_w
    assert seen[0] == (0, tok * 2 + 4 * 2 * 4 * 3 + 2 * 8 * 10, wbytes + kvb * 2)
    # one decode step: the second served token, 3 keys with its own
    assert seen[1] == (0, tok + 2 * 8 * 10 + 4 * 2 * 4 * 3, wbytes + kvb * 3)
    assert len(seen) == 2


def _kvq_args(valid, T, KV=1, G=2, Dh=4):
    B = len(valid)
    mask = torch.zeros(B, T, dtype=torch.bool)
    for b, n in enumerate(valid):
        mask[b, :n] = True
    cache = (torch.zeros(B, KV, T, Dh, dtype=torch.int8), torch.zeros(B, KV, T, 1))
    return (torch.zeros(B, KV, G, Dh, dtype=torch.bfloat16), cache, cache,
            torch.zeros(B, KV, Dh, dtype=torch.bfloat16),
            torch.zeros(B, KV, Dh, dtype=torch.bfloat16), mask)


def test_kvq_work_matches_the_frozen_count(recorded):
    mod = _module("gen.kvq_decode_roofline")
    seen = recorded(mod)
    # prompts of 2 and 4 tokens served 2 and 3 tokens: step 1 reads 2 and 4
    # cached keys, step 2 only the second row's 5.
    mod["work"](DEC, [[0] * 2, [0] * 4], [[1, 1], [1, 1, 1]])
    for (_, ops, nbytes), valid in zip(seen, ([2, 4], [5])):
        args = _kvq_args(valid, T=6)
        f_ops, f_bytes = yardstick.kvq_work(args)
        unneeded_mask = args[5].numel() - int(args[5].sum())
        assert (ops, nbytes) == (f_ops, f_bytes - unneeded_mask)


def test_least_time_is_the_larger_bound():
    assert yardstick.least_s(1979e12, 989e12, 0) == pytest.approx(2.0)
    assert yardstick.least_s(0, 0, 3.35e12) == pytest.approx(1.0)
    assert yardstick.bound(989e12, 0, yardstick.H100_BF16_FLOPS) == (1000.0, "operations")


def test_launches_per_step_counts_the_decode_steps_of_the_work():
    """Rows served 3 and 2 tokens in one generate call and 5 in another
    need 2 + 4 decode steps (each call's first token comes from prefill),
    whatever the program's own counters say."""
    from types import SimpleNamespace

    from harness.record import Record

    work = [{"op": "generate", "served": [[1, 2, 3], [4, 5]]},
            {"op": "generate", "served": [[1] * 5]}, {"op": "score_labels", "rows": [3]}]
    trace = SimpleNamespace(ops=[None] * 30)
    rec = Record({}, {}, 0.0, [], {"launches.kvq_decode_attention": 999}, work, trace)
    assert cell.metric_reader("gen.launches_per_step")(rec) == 5.0
    assert cell.metric_reader("gen.launches_per_step")(
        Record({}, {}, 0.0, [], {}, work, None)) is None
