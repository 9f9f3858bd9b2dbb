"""gen_tokens_per_s: completion tokens the ranker's calls generated (the
reference's completion-token meter, prefill included in the time) per
second, from the first call's start to the last call's end."""


def read(rec):
    return rec.total("completion_tokens") / rec.wall_s
