"""score.flash_mha_roofline: B5's share of its roofline on a decoder's
scoring prefills: the least time of the causal self-attention the window's
rows need (``shared_work``: each distinct prompt position once, attending
to its own row's earlier positions; q.k and p.v over those pairs; q, k, v
read once and the output written once per position and layer, bf16, K and
V at the KV heads' width) over the device time of the flash kernel family,
in percent."""
from drivers.setwise_likelihood_decoder import shared_work
from harness.yardstick import least_s


def work(conf, calls):
    """(bf16 operations, bytes) of the window's attention."""
    D, H, KV = conf["hidden_size"], conf["num_attention_heads"], conf["num_key_value_heads"]
    Dh, Ld = conf.get("head_dim") or D // H, conf["num_hidden_layers"]
    positions, pairs = shared_work(calls)
    return 4 * Ld * H * Dh * pairs, Ld * 2 * (2 * H + 2 * KV) * Dh * positions


def read(rec):
    if (rec.trace is None or rec.conf["port"]["kind"] != "decoder"
            or "layer_types" in rec.conf):
        return None
    dev = rec.family_s("flash")
    calls = [w for w in rec.work if w["op"] == "score_labels" and "tokens" in w]
    if not calls or dev <= 0:
        return None
    return 100.0 * least_s(0, *work(rec.conf, calls)) / dev
