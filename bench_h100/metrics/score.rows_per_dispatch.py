"""score.rows_per_dispatch: comparisons the ranker made over the engine's
scoring dispatches (its own count of programs run) in the window."""


def read(rec):
    n = rec.counters.get("scoring_dispatches", 0)
    return rec.total("comparisons") / n if n else None
