"""docs_per_s: first-stage documents reranked per second, over every call
of the window, from the first call's start to the last call's end."""


def read(rec):
    return rec.total("docs") / rec.wall_s
