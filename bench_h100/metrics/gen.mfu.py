"""gen.mfu: the decoder's generation step's share of the chip's peak: the
least time the chip could take for the work of every ``generate`` call in
the traced window, over the window, in percent.

The work of a call is the model's on the rows the ranker sent, real tokens
only. Prefill: every distinct prompt prefix once (the positions of the
prompts' trie; a causal prefix can be reused), its attention over the keys
before it, and the logits of each row's last position. Decode: each token a
row was served after its first, with attention over the row's keys so far;
each step reads every weight once and each live row's cached keys and
values. A step's least time is the larger of its operations at the bf16 peak
and its bytes at the memory rate.
"""
from harness.yardstick import least_s

KV_BYTES = {None: lambda dh: 4 * dh, "int8": lambda dh: 2 * (dh + 4),
            "int4": lambda dh: 2 * (dh // 2 + 8)}  # one key's K and V, one KV head
WEIGHT_BYTES = {None: 2, "int8": 1, "int4": 0.5}


def dims(conf):
    D, H, KV = conf["hidden_size"], conf["num_attention_heads"], conf["num_key_value_heads"]
    return D, H, KV, conf.get("head_dim") or D // H, conf["intermediate_size"]


def trie(rows):
    """(distinct prefix positions, causal attention pairs among them)."""
    rows = sorted(rows)
    positions = pairs = 0
    prev = []
    for r in rows:
        lcp = 0
        while lcp < min(len(r), len(prev)) and r[lcp] == prev[lcp]:
            lcp += 1
        positions += len(r) - lcp
        pairs += (len(r) * (len(r) + 1) - lcp * (lcp + 1)) // 2
        prev = r
    return positions, pairs


def work(conf, rows, served):
    """Least seconds of one generate call."""
    D, H, KV, Dh, F = dims(conf)
    Ld, V = conf["num_hidden_layers"], conf["vocab_size"]
    eng = conf["port"].get("engine", {})
    kvb = Ld * KV * KV_BYTES[eng.get("kv_quantize")](Dh)  # one position, all layers
    layer_w = D * (H + 2 * KV) * Dh + H * Dh * D + 3 * D * F
    weight_bytes = WEIGHT_BYTES[eng.get("quantize")] * (Ld * layer_w + V * D)
    tok_flops = 2 * Ld * layer_w
    positions, pairs = trie(rows)
    pre_flops = tok_flops * positions + 4 * Ld * H * Dh * pairs + 2 * D * V * len(rows)
    total = least_s(0, pre_flops, weight_bytes + kvb * positions)
    lens = [(len(r), len(s)) for r, s in zip(rows, served)]
    for t in range(1, max(n for _, n in lens)):
        live = [p + t for p, n in lens if n > t]  # keys with its own
        flops = len(live) * (tok_flops + 2 * D * V) + 4 * Ld * H * Dh * sum(live)
        total += least_s(0, flops, weight_bytes + kvb * sum(live))
    return total


def read(rec):
    if rec.trace is None:
        return None
    calls = [w for w in rec.work if w["op"] == "generate"]
    if not calls:
        return None
    least = sum(work(rec.conf, w["rows"], w["served"]) for w in calls)
    return 100.0 * least / rec.trace.window_s
