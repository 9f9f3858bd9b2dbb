"""moe.kvq_decode_roofline: B8's share of its roofline on a model whose
layers differ in attention type: as ``gen.kvq_decode_roofline`` counts it
(the least time of each decode step's attention over the quantized cache,
live rows only, over the device time of B8's kernel family, in percent),
with each layer's keys its own: a full layer's cached keys are the row's
prompt and the tokens it was served before this one, a sliding layer's at
most ``sliding_window`` - 1 of them (the window's keys besides the current
token's own)."""
from harness.yardstick import least_s

ROW = {"int8": lambda dh: dh + 4, "int4": lambda dh: dh // 2 + 8}  # one key, K or V


def work(conf, rows, served):
    """Least seconds of B8's work in one generate call."""
    D, H, KV = conf["hidden_size"], conf["num_attention_heads"], conf["num_key_value_heads"]
    Dh = conf.get("head_dim") or D // H
    row = ROW[conf["port"]["engine"]["kv_quantize"]](Dh)
    W = conf.get("sliding_window")
    windows = [W if t == "sliding_attention" else None for t in conf["layer_types"]]
    lens = [(len(r), len(s)) for r, s in zip(rows, served)]
    total = 0.0
    for t in range(1, max(n for _, n in lens)):
        for win in windows:
            cached = [p + t - 1 if win is None else min(p + t - 1, win - 1)
                      for p, n in lens if n > t]
            b = len(cached)
            nbytes = (KV * sum(cached) * 2 * row + sum(cached)  # cache rows, mask
                      + b * (H * Dh * 2 + 2 * KV * Dh * 2 + H * Dh * 4))  # q, self k/v, out
            total += least_s(0, 4 * H * Dh * (sum(cached) + b), nbytes)
    return total


def read(rec):
    if (rec.trace is None or "layer_types" not in rec.conf
            or rec.conf["port"].get("engine", {}).get("kv_quantize") is None):
        return None
    dev = rec.family_s("kvq decode (B8)")
    calls = [w for w in rec.work if w["op"] == "generate" and w["served"]]
    if not calls or dev <= 0:
        return None
    return 100.0 * sum(work(rec.conf, w["rows"], w["served"]) for w in calls) / dev
