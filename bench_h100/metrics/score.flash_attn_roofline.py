"""score.flash_attn_roofline: the flash kernel's share of its roofline on
the T5 encoder's self-attention: the least time of the attention those rows
need (real tokens only: q.k and p.v over each prompt's own positions, q, k,
v read once and the output written once, bf16) over the device time of the
flash kernel family, in percent. The decoder's attention over the forced
prefix runs outside the flash kernel and is not counted."""
from harness.yardstick import least_s


def work(conf, rows):
    """(bf16 operations, bytes) of one call's encoder self-attention."""
    I, L = conf["num_heads"] * conf["d_kv"], conf["num_layers"]
    return (L * 4 * I * sum(r * r for r in rows), L * 2 * 4 * I * sum(rows))


def read(rec):
    if rec.trace is None or rec.conf["port"]["kind"] != "t5":
        return None
    dev = rec.family_s("flash")
    calls = [w for w in rec.work if w["op"] == "score_labels"]
    if not calls or dev <= 0:
        return None
    layers = rec.conf["num_layers"]
    least = 0.0
    for w in calls:
        ops, nbytes = work(rec.conf, w["rows"])
        least += layers * least_s(0, ops / layers, nbytes / layers)
    return 100.0 * least / dev
