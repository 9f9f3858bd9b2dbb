"""Mellum 2 on the port, against the benchmark's plain float32 reference
(``bench_h100/reference/mellum2.py``), at a tiny size on the CPU: 4 layers
(3 sliding : 1 full, window 8), 8 routed experts of which each token takes 2,
YaRN on the full layer, seeded random weights.

The port runs in float32 here, as the reference does, so the two differ by
the order of their sums alone: logits within 1e-4 (they read about 3 at
most; float32's rounding over these few layers stays near 1e-6), and the
routing is the same token for token, so the port's routing counts equal those
counted from the reference. Through the int8 KV cache the logits agree
within 5e-3: a cached value that float32's rounding puts on the other side
of an int8 rounding boundary lands one quantum away (up to 8e-4 in a logit
seen here). Each fault below (a part of the mathematics left out or done
another way) moves the logits by ten times that or more, or the counts, and
so reads not correct.
"""
import copy
import dataclasses
import json
import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "bench_h100"))

from harness import port, weights  # noqa: E402
from reference import mellum2 as ref  # noqa: E402

from llmrankers_tpu_torch.engine import generate as gen  # noqa: E402
from llmrankers_tpu_torch.models import config as tconfig  # noqa: E402
from llmrankers_tpu_torch.models import decoder as dec  # noqa: E402
from llmrankers_tpu_torch.models import moe  # noqa: E402
from llmrankers_tpu_torch.models.config import DecoderConfig  # noqa: E402
from llmrankers_tpu_torch.ops import attention  # noqa: E402

CONF_FILE = os.path.join(ROOT, "bench_h100", "configs", "mellum2-12b-a2.5b.bf16-kv8.json")
PUBLISHED = json.load(open(CONF_FILE))
TOL = 1e-4  # float32 against float32: the order of sums only
TOL_KV = 5e-3  # through the int8 cache: values near a rounding boundary
EOS = 511


def tiny_conf():
    c = copy.deepcopy(PUBLISHED)
    c.update(hidden_size=128, num_attention_heads=4, num_key_value_heads=2, head_dim=32,
             num_hidden_layers=4, vocab_size=512, num_experts=8, num_experts_per_tok=2,
             moe_intermediate_size=64, sliding_window=8, eos_token_id=EOS,
             layer_types=PUBLISHED["layer_types"][:4],
             mlp_layer_types=PUBLISHED["mlp_layer_types"][:4])
    # YaRN's correction range at this head size: a ramp over a few of its 16
    # frequencies, as the published one ramps over some of its 64.
    c["rope_parameters"]["full_attention"]["original_max_position_embeddings"] = 64
    return c


CONF = tiny_conf()


@pytest.fixture(scope="module")
def w():
    return weights.make(ref.param_specs(CONF), 20261018, "cpu", torch.float32)


def _engine(w, **kw):
    return port.engine(CONF, w, device="cpu", dtype=torch.float32, **kw)


def _rows(n, prefix=0, lo=20, hi=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    head = torch.randint(3, 250, (prefix,), generator=g).tolist()
    return [head + torch.randint(3, 250, (int(torch.randint(lo, hi, (1,), generator=g)),),
                                 generator=g).tolist() for _ in range(n)]


def _served(eng, rows, steps, monkeypatch):
    """Greedy generation through the engine: each row's served tokens, and
    the logits each decode step picked from, [B, steps - 1, V] (the first
    token is the prefill's; the last step's pick is not served)."""
    picks = []
    inner = gen._pick

    def pick(logits, t, k):
        picks.append(logits.detach().clone())
        return inner(logits, t, k)

    monkeypatch.setattr(gen, "_pick", pick)
    with torch.inference_mode():
        toks = eng._generate_dispatch(rows, steps, (), None, None)
    monkeypatch.setattr(gen, "_pick", inner)
    logits = torch.stack(picks[:steps - 1], dim=1)
    return [[int(t) for t in row] for row in toks], logits


def _want(w, rows, served):
    get = weights.getter(w)
    return [ref.served_logits(get, CONF, r + s[:-1], len(r)) for r, s in zip(rows, served)]


def _worst(served, got, want):
    """The largest |port - reference| of a decode step's logits, up to a
    row's EOS (a done row's later steps decode pad)."""
    out = 0.0
    for i, (s, wl) in enumerate(zip(served, want)):
        n = s.index(EOS) if EOS in s else len(s) - 1
        out = max(out, float((got[i, :n] - wl[1:n + 1]).abs().max()))
    return out


def _reference_counts(w, rows, served):
    """The routing counts of the plain route (no prefix sharing), counted on
    the reference's routing: assignments and pad positions of the prefill
    and of each decode step."""
    routes = []
    inner = ref.route

    def route(h, router, conf):
        out = inner(h, router, conf)
        routes.append(out[1])
        return out

    ref.route = route
    try:
        get = weights.getter(w)
        per_row = []
        for r, s in zip(rows, served):
            routes.clear()
            ref.served_logits(get, CONF, r + s, len(r))
            per_row.append(torch.stack(routes))  # [layers, tokens, k]
    finally:
        ref.route = inner
    Ld, k = CONF["num_hidden_layers"], CONF["num_experts_per_tok"]
    B = 4 if len(rows) <= 4 else 8  # the engine's batch bucket
    L = max(len(r) for r in rows)
    L = min(b for b in (64, 128, 256, 512) if b >= L)
    steps = len(served[0])
    real = sum(len(r) for r in rows)
    return {"assignments": Ld * k * (real + len(rows) * steps),
            "pad_skipped": Ld * (B * L - real)}


LADDERS = dict(len_buckets=(64, 128, 256, 512), batch_buckets=(4, 8))
PREFIX = 140  # a shared prefix the engine groups (saving 256 tokens or more)


def _judge(w, monkeypatch, prefix_share: bool, **kw):
    """(worst logit deviation, the port's counts, the reference's counts)."""
    eng = _engine(w, kv_quantize="int8", prefix_share=prefix_share, prefix_cache_mb=0,
                  **LADDERS)
    rows = _rows(3, prefix=PREFIX if prefix_share else 0, **kw)
    served, got = _served(eng, rows, 6, monkeypatch)
    worst = _worst(served, got, _want(w, rows, served))
    counts = None if prefix_share else _reference_counts(w, rows, served)
    return worst, eng, counts


# -- the configuration --------------------------------------------------------
def test_from_hf_config_reads_the_published_keys():
    c = DecoderConfig.from_hf_config(PUBLISHED)
    assert (c.hidden_size, c.num_hidden_layers, c.num_attention_heads, c.num_key_value_heads,
            c.head_dim, c.vocab_size) == (2304, 28, 32, 4, 128, 98304)
    assert (c.num_experts, c.num_experts_per_tok, c.moe_intermediate_size,
            c.norm_topk_prob) == (64, 8, 896, True)
    assert [c.layer_window(i) for i in range(8)] == [1024, 1024, 1024, None] * 2
    assert all(c.sparse(i) for i in range(28)) and c.has_experts
    assert c.rope_for("sliding_attention") == {"rope_type": "default", "rope_theta": 500000}
    yarn = c.rope_for("full_attention")
    assert yarn["rope_type"] == "yarn" and yarn["factor"] == 16
    assert yarn["original_max_position_embeddings"] == 8192
    assert not c.tie_word_embeddings and hash(c)
    # Every other model is read as before: one window for every layer, no experts.
    q = DecoderConfig.from_hf_config(json.load(open(os.path.join(
        ROOT, "bench_h100", "configs", "qwen2.5-3b.bf16-kv8.json"))))
    assert q == dataclasses.replace(q, layer_types=None, mlp_layer_types=None,
                                    rope_parameters=None, num_experts=0)
    assert not q.has_experts and q.rope_for("full_attention")["rope_theta"] == 1e6
    m = DecoderConfig(sliding_window=64)
    assert [m.layer_window(i) for i in range(3)] == [64, 64, 64]
    assert tconfig.SLIDING == "sliding_attention"


@pytest.mark.parametrize("head_dim", [32, 128])
def test_yarn_frequencies_match_transformers(head_dim):
    """The port's and the reference's YaRN against transformers' own
    ``_compute_yarn_parameters`` on the published keys."""
    from transformers.modeling_rope_utils import _compute_yarn_parameters

    p = dict(PUBLISHED["rope_parameters"]["full_attention"])
    hf = types.SimpleNamespace(rope_theta=p["rope_theta"], head_dim=head_dim,
                               hidden_size=2304, num_attention_heads=32,
                               max_position_embeddings=131072, rope_scaling=p)
    want, want_scale = _compute_yarn_parameters(hf, "cpu")
    for got, scale in (attention.rope_inv_freq(p, head_dim), ref.inv_freq(p, head_dim, "cpu")):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        assert scale == pytest.approx(want_scale)
    default = dict(PUBLISHED["rope_parameters"]["sliding_attention"])
    got, scale = attention.rope_inv_freq(default, head_dim)
    assert scale == 1.0
    torch.testing.assert_close(got, 1.0 / 500000 ** (torch.arange(0, head_dim, 2) / head_dim))


# -- the block ----------------------------------------------------------------
@pytest.mark.parametrize("n", [6, 30])
def test_forward_matches_reference(w, n):
    """The whole forward (n beyond the window at 30) at its last position."""
    m = dec.Decoder(DecoderConfig.from_hf_config(CONF), dtype=torch.float32, device="cpu")
    m.load_state_dict(w, strict=True)
    ids = torch.tensor(_rows(1, lo=n, hi=n + 1)[0])[None]
    with torch.no_grad():
        got = m(ids, torch.ones_like(ids))[0, -1]
    want = ref.served_logits(weights.getter(w), CONF, ids[0].tolist(), n)[0]
    assert float((got - want).abs().max()) < TOL


@pytest.mark.parametrize("prefix_share", [False, True])
def test_generate_matches_reference(w, monkeypatch, prefix_share):
    """Prefill (left-padded, or on a shared prefix of 140 tokens, padded to
    256, past the window) and greedy decode through the int8 cache: every served token's
    logits against the reference's ``served_logits``, which works the int8
    cache out as the port keeps it."""
    worst, eng, _ = _judge(w, monkeypatch, prefix_share)
    assert worst < TOL_KV
    want = {"dec_gen_shared": 1} if prefix_share else {"dec_gen": 1}
    assert dict(eng.programs) == want


def test_shared_prefill_matches_plain(w):
    """The prefix-shared prefill, its prefix rolled for the window, against
    the plain prefill of the same rows (prompts of 160-180 tokens, window 8)."""
    eng = _engine(w, **LADDERS)
    rows = _rows(3, prefix=PREFIX)
    m = eng.model
    with torch.inference_mode():
        n, (pids, pmask, gidx, sids, smask), _ = eng._group(rows)
        ks, vs = gen.decoder_prefix_kv(m, pids, pmask)
        last_h, _ = gen.decoder_shared_prefill(m, ks.index_select(1, gidx),
                                               vs.index_select(1, gidx),
                                               pmask.index_select(0, gidx), sids, smask)
        shared = m.lm_logits(last_h)[:n]
        ids, mask, _, _ = eng._pad_batch(rows, left=True)
        plain, _ = gen.decoder_prefill(m, *eng._to_device(ids, mask), 1)
    assert float((shared - plain[:n]).abs().max()) < TOL


def test_moe_stats_match_reference_routing(w, monkeypatch):
    """``moe_stats`` after a generate on the plain route: assignments (of
    the prefill and of the decode steps' live rows) and pad positions
    skipped equal those counted from the reference's routing."""
    worst, eng, want = _judge(w, monkeypatch, False)
    assert worst < TOL_KV
    assert eng.moe_stats == want


def test_no_quantized_experts(w):
    with pytest.raises(NotImplementedError, match="routed-expert"):
        _engine(w, quantize="int8")


# -- faults -------------------------------------------------------------------
def _window_ignored(monkeypatch):
    monkeypatch.setattr(tconfig.DecoderConfig, "layer_window", lambda self, i: None)


def _window_in_indices(monkeypatch):
    monkeypatch.setattr(gen, "_prefix_roll", lambda pre_mask: torch.arange(
        pre_mask.shape[1])[None].expand(pre_mask.shape[0], -1))


def _moe_altered(**change):
    def fault(monkeypatch):
        inner = dec.moe_ffn

        def altered(lp, x, cfg, routing=None):
            new = {k: f(getattr(cfg, k)) for k, f in change.items()}
            return inner(lp, x, dataclasses.replace(cfg, **new), routing)

        monkeypatch.setattr(dec, "moe_ffn", altered)
    return fault


def _default_rope_everywhere(monkeypatch):
    inner = dec.rope_inv_freq
    monkeypatch.setattr(dec, "rope_inv_freq",
                        lambda p, dh, device=None: inner({**p, "rope_type": "default"}, dh,
                                                         device))


def _pads_routed(monkeypatch):
    def prefill(cls, attn_mask):
        return cls(real=torch.arange(attn_mask.numel()))

    monkeypatch.setattr(moe.Routing, "prefill", classmethod(prefill))


@pytest.mark.parametrize("fault,prefix_share", [
    (_window_ignored, False), (_window_in_indices, True),
    (_moe_altered(num_experts_per_tok=lambda k: k - 1), False),
    (_moe_altered(norm_topk_prob=lambda b: not b), False),
    (_default_rope_everywhere, False), (_pads_routed, False)])
def test_fault_is_not_correct(w, monkeypatch, fault, prefix_share):
    """Each fault reads not correct: its logits leave the tolerance, or its
    routing counts differ from the reference's."""
    fault(monkeypatch)
    worst, eng, want = _judge(w, monkeypatch, prefix_share, lo=30, hi=50)
    assert worst > 10 * TOL_KV or (want is not None and eng.moe_stats != want)
