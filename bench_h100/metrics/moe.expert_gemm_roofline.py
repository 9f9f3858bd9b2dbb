"""moe.expert_gemm_roofline: the routed experts' grouped GEMMs' share of
their roofline: the least time of the expert GEMMs of every ``generate``
call in the traced window, over the device time of the grouped-GEMM
kernels, in percent.

The work of a call, per routed layer (``mlp_layer_types`` "sparse"), at
``num_experts_per_tok`` = k assignments a token and 6 D F operations an
assignment (gate|up [D, 2F], down [F, D]), bf16:

- prefill: each distinct prompt position once (the prompts' trie, as
  ``gen.mfu`` counts it); every expert's weights read once, and each
  assignment's rows in and out (x [D] in, gate|up [2F] out, [F] in, [D]
  out);
- decode: each step t, one step for all of the call's rows live at t (the
  least work, as ``gen.mfu`` counts it), their assignments in and out, and
  the weights of k experts, the fewest the step's rows can route to: the
  record holds no routing, so the share is a lower bound. On the cell's
  random weights the rows route alike, and a step of 32 rows touches about
  20 of the 64 experts (a probe), where a deployment's would touch about
  63.

Each piece's least time is the larger of its operations at the bf16 peak
and its bytes at the memory rate. The kernels are CUTLASS's grouped GEMM
(``GroupProblemShape`` in its name) and its argument set-up
(``prepare_grouped_gemm_data``), as ``torch._grouped_mm`` launches them on
the H100 (names from a trace)."""
from harness.yardstick import least_s

KERNELS = ("groupproblemshape", "prepare_grouped_gemm_data")


def trie_positions(rows):
    """Distinct prefix positions of the rows (a causal prefix is reused)."""
    rows, prev, n = sorted(rows), [], 0
    for r in rows:
        lcp = 0
        while lcp < min(len(r), len(prev)) and r[lcp] == prev[lcp]:
            lcp += 1
        n += len(r) - lcp
        prev = r
    return n


def work(conf, rows, served):
    """Least seconds of one generate call's expert GEMMs."""
    D, E, k = conf["hidden_size"], conf["num_experts"], conf["num_experts_per_tok"]
    F = conf["moe_intermediate_size"]
    layers = sum(t == "sparse" for t in conf["mlp_layer_types"])
    row_bytes = 2 * (2 * D + 3 * F)  # one assignment's rows in and out

    def piece(tokens, experts):
        return layers * least_s(0, 6 * D * F * k * tokens,
                                experts * 3 * D * F * 2 + k * tokens * row_bytes)

    total = piece(trie_positions(rows), E)
    lens = [len(s) for s in served]
    for t in range(1, max(lens)):
        total += piece(sum(n > t for n in lens), k)
    return total


def read(rec):
    if rec.trace is None or "num_experts" not in rec.conf:
        return None
    dev = sum(s for name, s in rec.trace.seconds_by(str.lower).items()
              if any(key in name for key in KERNELS))
    calls = [w for w in rec.work if w["op"] == "generate" and w["served"]]
    if not calls or dev <= 0:
        return None
    return 100.0 * sum(work(rec.conf, w["rows"], w["served"]) for w in calls) / dev
