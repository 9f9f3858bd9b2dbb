"""moe.mfu: the generation step's share of the chip's peak on a decoder
with routed experts and sliding-window layers: the least time the chip could
take for the work of every ``generate`` call in the traced window, over the
window, in percent. As ``gen.mfu`` counts a dense decoder's, with this
block's work:

- a token's operations: q, k, v, o, the router, and ``num_experts_per_tok``
  experts (3 D F weights each) in every layer; the logits of each row's last
  prompt position and of each decode step;
- attention: a full layer over every key before a position, a sliding
  layer over at most ``sliding_window`` of them (its own included);
- prefill: every distinct prompt prefix once (the prompts' trie), every
  weight read once, each position's K and V written;
- decode: each step t, one step for all of the call's rows live at t; it
  reads the weights outside the experts (the head included), k experts' (the
  fewest its rows can route to: the record holds no routing, so this counts
  the least), and each live row's cached keys and values, a sliding layer's
  within its window.

A piece's least time is the larger of its operations at the bf16 peak and
its bytes at the memory rate."""
from harness.yardstick import least_s

KV_BYTES = {None: lambda dh: 4 * dh, "int8": lambda dh: 2 * (dh + 4),
            "int4": lambda dh: 2 * (dh // 2 + 8)}  # one key's K and V, one KV head


def trie(rows, window):
    """(distinct prefix positions, causal attention pairs among them on a
    full layer, on a layer of ``window``)."""
    rows = sorted(rows)
    positions = full = win = 0
    prev = []
    for r in rows:
        lcp = 0
        while lcp < min(len(r), len(prev)) and r[lcp] == prev[lcp]:
            lcp += 1
        positions += len(r) - lcp
        full += (len(r) * (len(r) + 1) - lcp * (lcp + 1)) // 2
        win += sum(min(j + 1, window) for j in range(lcp, len(r)))
        prev = r
    return positions, full, win


def work(conf, rows, served):
    """Least seconds of one generate call."""
    D, H, KV = conf["hidden_size"], conf["num_attention_heads"], conf["num_key_value_heads"]
    Dh, V = conf.get("head_dim") or D // H, conf["vocab_size"]
    E, k, F = conf["num_experts"], conf["num_experts_per_tok"], conf["moe_intermediate_size"]
    W = conf["sliding_window"]
    types = conf["layer_types"]
    Ld, n_win = len(types), sum(t == "sliding_attention" for t in types)
    n_full = Ld - n_win
    kvb = KV * KV_BYTES[conf["port"].get("engine", {}).get("kv_quantize")](Dh)  # a key, a layer
    attn_w = D * (H + 2 * KV) * Dh + H * Dh * D
    tok_flops = 2 * Ld * (attn_w + D * E + k * 3 * D * F)
    dense_bytes = 2 * (Ld * (attn_w + D * E) + D * V)  # the head read, embedding rows aside
    expert_bytes = 2 * Ld * 3 * D * F  # one expert in every layer
    positions, pairs_full, pairs_win = trie(rows, W)
    pre_flops = (tok_flops * positions + 4 * H * Dh * (n_full * pairs_full + n_win * pairs_win)
                 + 2 * D * V * len(rows))
    total = least_s(0, pre_flops, dense_bytes + E * expert_bytes + Ld * kvb * positions)
    lens = [(len(r), len(s)) for r, s in zip(rows, served)]
    for t in range(1, max(n for _, n in lens)):
        live = [p + t for p, n in lens if n > t]  # keys with its own
        keys = n_full * sum(live) + n_win * sum(min(x, W) for x in live)
        b = len(live)
        flops = b * (tok_flops + 2 * D * V) + 4 * H * Dh * keys
        total += least_s(0, flops, dense_bytes + k * expert_bytes + kvb * keys)
    return total


def read(rec):
    if rec.trace is None or "num_experts" not in rec.conf:
        return None
    calls = [w for w in rec.work if w["op"] == "generate" and w["served"]]
    if not calls:
        return None
    least = sum(work(rec.conf, w["rows"], w["served"]) for w in calls)
    return 100.0 * least / rec.trace.window_s
