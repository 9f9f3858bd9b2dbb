"""gen.kvq_decode_roofline: B8's share of its roofline (decode attention
over the quantized KV cache): the least time of what each decode step's
attention needs, over the device time of B8's kernel family, in percent.

A step, per layer, needs (as ``yardstick.kvq_work`` counts an operand set,
for the live rows only): the K and V payload and scale rows of each row's
cached keys (its prompt and the tokens it was served before this one), a
mask byte per such key, q, the step's own k and v (the self term), and the
f32 output; and q.k and p.v over those keys and the self term. Its least
time is the larger of the operations at the bf16 peak and the bytes at the
memory rate."""
from harness.yardstick import least_s

ROW = {"int8": lambda dh: dh + 4, "int4": lambda dh: dh // 2 + 8}  # one key, K or V


def work(conf, rows, served):
    """Least seconds of B8's work in one generate call."""
    D, H, KV = conf["hidden_size"], conf["num_attention_heads"], conf["num_key_value_heads"]
    Dh, Ld = conf.get("head_dim") or D // H, conf["num_hidden_layers"]
    row = ROW[conf["port"]["engine"]["kv_quantize"]](Dh)
    lens = [(len(r), len(s)) for r, s in zip(rows, served)]
    total = 0.0
    for t in range(1, max(n for _, n in lens)):
        cached = [p + t - 1 for p, n in lens if n > t]
        b = len(cached)
        nbytes = (KV * sum(cached) * 2 * row + sum(cached)  # cache rows, mask
                  + b * (H * Dh * 2 + 2 * KV * Dh * 2 + H * Dh * 4))  # q, self k/v, out
        total += Ld * least_s(0, 4 * H * Dh * (sum(cached) + b), nbytes)
    return total


def read(rec):
    if rec.trace is None or rec.conf["port"].get("engine", {}).get("kv_quantize") is None:
        return None
    dev = rec.family_s("kvq decode (B8)")
    calls = [w for w in rec.work if w["op"] == "generate"]
    if not calls or dev <= 0:
        return None
    return 100.0 * sum(work(rec.conf, w["rows"], w["served"]) for w in calls) / dev
