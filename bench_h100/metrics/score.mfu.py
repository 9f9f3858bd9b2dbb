"""score.mfu: the T5 scoring step's share of the chip's peak: the least
time the chip could take for the work of every ``score_labels`` call in the
traced window, over the window, in percent.

The work of a call is the model's at the real tokens of the rows the ranker
sent (no padding): the encoder over each prompt, the decoder over the forced
prefix with cross-attention to the prompt, and the label logits. Its least
time is the larger of the compute time (int8 operations at the int8 peak for
the sites the configuration runs W8A8, M >= 1024; bf16 operations at the
bf16 peak) and the bytes it must move (every weight once, the rows'
embeddings, the logits) at the memory rate.
"""
from harness.yardstick import least_s


def work(conf, rows, prefix, labels):
    """(int8 operations, bf16 operations, bytes) of one call."""
    D, H, dkv, F = conf["d_model"], conf["num_heads"], conf["d_kv"], conf["d_ff"]
    Le, Ld, I = conf["num_layers"], conf["num_decoder_layers"], conf["num_heads"] * conf["d_kv"]
    n, n2, B, T = sum(rows), sum(r * r for r in rows), len(rows), prefix
    enc_w = D * 3 * I + I * D + 2 * D * F + F * D  # qkv, o, wi_0|wi_1, wo
    dec_w = D * 3 * I + I * D + D * I + 2 * D * I + I * D + 2 * D * F + F * D
    int8 = 2 * n * (Le * enc_w + Ld * 2 * D * I)  # encoder sites and cross K|V
    dec_gemm = 2 * B * T * (dec_w - 2 * D * I)  # every decoder site but cross K|V
    bf16 = Le * 4 * I * n2 + Ld * (4 * B * T * T * I + 4 * T * n * I) + 2 * B * D * labels
    if B * T >= 1024:
        int8 += dec_gemm
    else:
        bf16 += dec_gemm
    scales = 4 * (Le * (3 * I + D + 2 * F + D) + Ld * (3 * I + 2 * D + I + 2 * I + 2 * F + D))
    nbytes = (Le * enc_w + Ld * dec_w + scales + 2 * D * (n + B * T) + 2 * D * labels
              + 4 * B * labels)
    return int8, bf16, nbytes


def read(rec):
    if rec.trace is None or rec.conf["port"]["kind"] != "t5":
        return None
    calls = [w for w in rec.work if w["op"] == "score_labels"]
    if not calls:
        return None
    least = sum(least_s(*work(rec.conf, w["rows"], w["prefix"], w["labels"])) for w in calls)
    return 100.0 * least / rec.trace.window_s
