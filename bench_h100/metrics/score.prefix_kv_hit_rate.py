"""score.prefix_kv_hit_rate: the share of the window's lookups in the
engine's cross-wave prefix-KV cache that found the prefix's K/V there
(``pkv_stats``: hits over hits and misses), in percent."""


def read(rec):
    hits, misses = rec.counters.get("pkv.hits"), rec.counters.get("pkv.misses")
    if hits is None or misses is None or hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)
