"""score.decoder_mfu: a decoder scoring step's share of the chip's peak:
the least time the chip could take for the work of every ``score_labels``
call in the traced window, over the window, in percent.

The work is the model's at the distinct prompt positions of the window's
rows (``shared_work``: no padding, and a head that rows share, within a
call or across calls, computed once): every projection and the gated MLP
at each position, causal attention over its own row's earlier positions,
and the label logits of each row. Its least time is the larger of the
compute time (bf16 operations at the bf16 peak) and the bytes it must move
(every weight once a call, each position's embedding row, the label rows
of the head and the logits) at the memory rate. A model with routed experts
or sliding windows is not counted here.
"""
from drivers.setwise_likelihood_decoder import shared_work
from harness.yardstick import least_s


def work(conf, calls):
    """(bf16 operations, bytes) of the window's ``score_labels`` calls."""
    D, H, KV = conf["hidden_size"], conf["num_attention_heads"], conf["num_key_value_heads"]
    Dh, F, Ld = conf.get("head_dim") or D // H, conf["intermediate_size"], conf["num_hidden_layers"]
    layer = D * (H + 2 * KV) * Dh + H * Dh * D + 3 * D * F  # qkv, o, gate|up, down
    positions, pairs = shared_work(calls)
    labels = sum(len(w["rows"]) * w["labels"] for w in calls)
    flops = 2 * Ld * layer * positions + 4 * Ld * H * Dh * pairs + 2 * D * labels
    weights = 2 * Ld * (layer + 2 * D) + 2 * D  # bf16, with the norms; biases left out
    nbytes = (len(calls) * weights + 2 * D * positions
              + sum(2 * D * w["labels"] for w in calls) + 4 * labels)
    return flops, nbytes


def read(rec):
    if (rec.trace is None or rec.conf["port"]["kind"] != "decoder"
            or "layer_types" in rec.conf or "num_experts" in rec.conf):
        return None
    calls = [w for w in rec.work if w["op"] == "score_labels" and "tokens" in w]
    if not calls:
        return None
    return 100.0 * least_s(0, *work(rec.conf, calls)) / rec.trace.window_s
