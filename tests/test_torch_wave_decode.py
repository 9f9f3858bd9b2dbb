"""A greedy wave decoded as one dispatch, its prefill in pieces.

A wave of more rows than the token cap (``max_batch_tokens // L``) lets
through decodes as one dispatch: its rows are laid out once, prefilled piece
by piece into row slices of one kept decode state, and decoded once. Here a
cap of 1024 tokens at L 256 cuts 11 rows into pieces of 4, 4 and 3, where the
JAX engine runs three dispatches (both off their slot-refill sessions,
``LLMRANKERS_NO_REFILL=1``):

- the completions, counts and program names equal the JAX engine's on the
  left-padded, shared-prefix and prefix-cache routes, with the cache in the
  model's dtype, int8 and int4, and with a sliding window of 64 in chunks
  with a stop string; ``wave_stats`` reads one decode, 3 pieces, 11 rows and
  12 state rows (the row ladder's rung), the left-padded route's slots
  count the wave's rows only;
- on replayed steps (the ``replayed`` fixture of ``test_torch_generate``):
  one capture, and the steps replayed once for the wave, not per piece;
- a sampled and a speculative wave keep the per-dispatch split (3 decodes)
  and its tokens;
- a device OOM in the second piece halves the rows per decode, cuts the
  pieces again and gives the same tokens.

Each case takes a few seconds.
"""
import numpy as np
import pytest
import torch

from llmrankers_tpu_torch.engine import generate as tgen

from test_torch_generate import (PATHS, STOP, _engines, _fake_oom, _same,  # noqa: F401
                                 replayed, trees)

CAP = 1024  # tokens a prefill piece: 4 rows at L 256
WANT = {"decodes": 1, "pieces": 3, "rows": 11, "slots": 12}


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setenv("LLMRANKERS_NO_REFILL", "1")


def _rows(seed=0):
    """11 rows, 6 on a 150-token head and 5 on a 140-token one, with suffixes
    of 3-59 tokens: L 256. Each of the JAX engine's dispatches (rows 0-3,
    4-7, 8-10) shares prefixes too, so both engines run the same programs."""
    rng = np.random.RandomState(seed)
    heads = [list(rng.randint(2, 258, size=n)) for n in (150, 140)]
    return [heads[i > 5] + list(rng.randint(2, 258, size=rng.randint(3, 60)))
            for i in range(11)]


def _capped(trees, window=None, **kw):
    jeng, teng_ = _engines(trees, window=window, **kw)
    jeng.max_batch_tokens = teng_.max_batch_tokens = CAP
    return jeng, teng_


def _decodes(eng):
    return sum(v for k, v in eng.programs.items() if k.startswith(("dec_gen", "dec_prefill")))


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("kvq", [None, "int8", "int4"])
def test_wave_in_pieces_matches_jax(trees, kvq, path):
    jeng, teng_ = _capped(trees, kv_quantize=kvq, **PATHS[path])
    rows = _rows()
    assert [len(c) for _, c in jeng._chunks(rows, 10**6)] == [4, 4, 3]
    _same(jeng, teng_, rows, max_new_tokens=10)
    assert _decodes(teng_) == 1 and teng_.wave_stats == WANT
    assert teng_._dstate.key[0] == 12
    if path == "plain":
        assert teng_.pad_stats["slot_tokens"] == 11 * 256


def test_window_wave_in_chunks_matches_jax(trees):
    """A window of 64 on the prefix cache, decoded in chunks of 4 with a stop
    string: each piece rolls its own rows' prefixes, and the state's two rows
    past the wave start done."""
    jeng, teng_ = _capped(trees, window=64, kv_quantize="int8")
    rows = _rows(1)
    texts, _ = _same(jeng, teng_, rows, max_new_tokens=12, chunk_tokens=4, stop_strings=STOP)
    stop = max(texts, key=len)[:1]
    _, counts = _same(jeng, teng_, rows, max_new_tokens=12, chunk_tokens=4,
                      stop_strings=(stop,))
    assert stop and min(counts) < 12
    assert teng_.programs["dec_prefill_pre"] == 2 and teng_.programs["dec_chunk"] >= 2
    assert teng_.wave_stats == {k: 2 * v for k, v in WANT.items()}


def test_wave_in_pieces_replays_once(trees, replayed):
    """One capture serves the wave; its steps replay once, and a second call
    of the shape replays without capturing again."""
    jeng, teng_ = _capped(trees, kv_quantize="int8", prefix_cache_mb=0)
    rows = _rows(2)
    for calls in (1, 2):
        _same(jeng, teng_, rows, max_new_tokens=20)
        assert teng_.graph_stats == {"captures": 1, "replays": 20 * calls, "eager_steps": 0}
    assert teng_.programs["dec_gen_shared"] == 2


def test_sampled_and_speculative_waves_keep_their_split(trees, monkeypatch):
    """Sampled streams are keyed by a dispatch's row offset and speculation
    allocates its own cache: both keep the token cap's three dispatches, so
    the sampled tokens are those of three dispatches of 4, 4 and 3 rows set
    by the row limit, and the speculative ones the greedy tokens."""
    _, teng_ = _capped(trees, kv_quantize="int4", prefix_share=False)
    _, ref = _engines(trees, kv_quantize="int4", prefix_share=False)
    monkeypatch.setattr(ref, "_gen_row_limit", lambda rows, max_new: 4)
    rows = _rows(3)
    kw = dict(max_new_tokens=8, temperature=1.5, seed=3)
    assert teng_.generate(rows, **kw) == ref.generate(rows, **kw)
    assert teng_.programs == ref.programs and teng_.programs["dec_prefill"] == 3
    assert teng_.wave_stats == {"decodes": 3, "pieces": 3, "rows": 11, "slots": 12}
    jeng, spec = _capped(trees, kv_quantize="int8", spec_lookup=3)
    _same(jeng, spec, rows, max_new_tokens=10)
    assert spec.programs["dec_prefill_pre"] == 3 and spec.wave_stats["decodes"] == 3


def test_oom_in_second_piece_recuts(trees, monkeypatch):
    """Pieces of 2 rows (a cap of 512 tokens): a device OOM in the second
    piece's prefill halves the rows per decode to 4 (remembered), the three
    decodes prefill 2 + 2, 2 + 2 and 2 + 1 rows, and the tokens are those of
    the run without the OOM."""
    _, teng_ = _capped(trees, kv_quantize="int8", prefix_share=False)
    teng_.max_batch_tokens = 512
    rows = _rows(4)
    want = teng_.generate(rows, max_new_tokens=8)
    teng_.wave_stats.update(decodes=0, pieces=0, rows=0, slots=0)
    inner, calls = tgen.decoder_prefill, []

    def prefill(model, ids, *a, **kw):
        calls.append(ids.shape[0])
        if len(calls) == 2:
            raise _fake_oom()
        return inner(model, ids, *a, **kw)

    monkeypatch.setattr(tgen, "decoder_prefill", prefill)
    assert teng_.generate(rows, max_new_tokens=8) == want
    assert calls == [2, 2, 2, 2, 2, 2, 2, 1]
    assert list(teng_._learned_row_caps.values()) == [4]
    assert teng_.wave_stats == {"decodes": 3, "pieces": 6, "rows": 11, "slots": 12}
