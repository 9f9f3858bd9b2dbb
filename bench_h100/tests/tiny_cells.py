"""The benchmark's cells at a size a CPU test can hold: the same files,
configurations cut to two 128-wide layers (so every int8 site still takes
its kernel's route), traffic cut to a few short queries, and limits read
at that size."""
import copy
import os

from harness import cell

HERE = os.path.dirname(os.path.abspath(__file__))

T5_SIZE = dict(d_model=128, d_kv=32, num_heads=4, d_ff=256, num_layers=4,
               num_decoder_layers=4, vocab_size=512)
# The planted ranker's grades at that width: an RMS-normed output reads at
# most sqrt(128) along a direction, so the grades sit lower and closer, and
# the attention scores them more steeply.
T5_RELEVANCE = dict(grade_low=4.0, grade_step=0.1, score_scale=40.0)
# Limits at this size, set as the cells' are from the readings at it (the
# CPU, seeds 2**31 + 11 to 2**31 + 13): T5 enc_rel 0.0157-0.0187 sound,
# 0.165-0.218 under the int4 control; Qwen token_gap 0.021-0.029 and
# gap_mean 0.00022-0.00081 sound, 0.081-0.098 and 0.0024-0.0043 under
# int8_weights, 0.37-0.46 and 0.049-0.073 under int4_kv.
LIMITS = {"t5": {"enc_rel": 0.06, "winner_flips": 0},
          "decoder": {"token_gap": 0.1, "gap_mean": 0.0014}}
DEC_SIZE = dict(hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
                intermediate_size=512, num_hidden_layers=4, vocab_size=512, eos_token_id=511)


def tiny(workload: str):
    c = cell.load(workload)
    c.conf = copy.deepcopy(c.conf)
    c.limits = LIMITS[c.conf["port"]["kind"]]
    if c.conf["port"]["kind"] == "t5":
        c.conf.update(T5_SIZE)
        c.conf["relevance_head"] = dict(c.conf["relevance_head"], **T5_RELEVANCE)
        c.mix = dict(c.mix, queries_per_call=3, docs_per_query=10)
    else:
        # A short prompt pack and short passages, so the tokens a row is
        # served are a good part of what later steps attend to.
        c.conf.update(DEC_SIZE)
        c.mix = dict(c.mix, queries_per_call=3, docs_per_query=3,
                     passage_tokens=dict(min=8, max=16, median=12, spread=3),
                     prompt_file=os.path.join(HERE, "prompt_short.toml"),
                     ranker=dict(c.mix["ranker"], num_child=2, max_completion_tokens=32))
    return c
