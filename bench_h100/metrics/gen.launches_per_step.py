"""gen.launches_per_step: operations the device ran in the traced window
(kernels, copies and fills, prefills' included) over the decode steps the
window's work needs: for each ``generate`` call, its longest row's served
tokens less the one that prefill serves. The steps come from the tokens the
harness recorded, not from a count inside the program, so a program that
decodes the same work in fewer launches (one dispatch for a wave, CUDA
graphs) reads fewer launches a step."""


def read(rec):
    steps = sum(max(len(s) for s in w["served"]) - 1
                for w in rec.work if w["op"] == "generate" and w["served"])
    if rec.trace is None or steps <= 0:
        return None
    return len(rec.trace.ops) / steps
