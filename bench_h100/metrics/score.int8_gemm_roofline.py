"""score.int8_gemm_roofline: the W8A8 GEMM kernels' share of their
roofline on the T5 path: the least time of the int8 GEMMs of the encoder's
sites (qkv, o, the gated wi_0|wi_1, wo) and of the decoder's cross K|V over
the encoder output, at the real tokens of the rows the ranker sent, over
the device time of the int8 GEMM families (B3, the gated B4 and the
activation quantize pass), in percent. Each site's least time is the larger
of its operations at the int8 peak and its bytes (int8 weight and f32
scales once, bf16 activations in, bf16 output) at the memory rate; which
sites count is fixed by the model's shapes, not by the program's routing."""
from harness.yardstick import least_s


def sites(conf):
    """(K, N in, N out, layers) of each counted site."""
    D, I, F = conf["d_model"], conf["num_heads"] * conf["d_kv"], conf["d_ff"]
    Le, Ld = conf["num_layers"], conf["num_decoder_layers"]
    return ((D, 3 * I, 3 * I, Le), (I, D, D, Le), (D, 2 * F, F, Le), (F, D, D, Le),
            (D, 2 * I, 2 * I, Ld))


def work(conf, tokens):
    """Least seconds of one call's counted sites over ``tokens`` real tokens."""
    total = 0.0
    for K, N, N_out, layers in sites(conf):
        nbytes = K * N + 4 * N + 2 * tokens * (K + N_out)
        total += layers * least_s(2 * tokens * K * N, 0, nbytes)
    return total


FAMILIES = ("int8 gemm (B3)", "int8 gated gemm (B4/B6)", "int8 quantize")


def read(rec):
    if rec.trace is None or rec.conf["port"].get("engine", {}).get("quantize") != "int8" \
            or rec.conf["port"]["kind"] != "t5":
        return None
    dev = rec.family_s(*FAMILIES)
    calls = [w for w in rec.work if w["op"] == "score_labels"]
    if not calls or dev <= 0:
        return None
    return 100.0 * sum(work(rec.conf, sum(w["rows"])) for w in calls) / dev
