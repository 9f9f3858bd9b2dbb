"""Port parity of slot refill (continuous batching): the port's
``engine/generate.py`` refill functions and ``ScoringEngine``'s refill
session against the JAX package.

- Each device function against its JAX counterpart on the same session
  state (tiny decoder, f32, ``params_from_jax``, rows from a numpy seed):
  ``decoder_decode_chunk_rr`` (tokens equal; equal to the scalar chunk when
  ``wp`` is uniform; rows that spend their budget write at wp == T, which
  clamps, and their mask bits change as in JAX), and the three
  ``decoder_refill_slots*`` with a padding row whose slot is out of range
  (caches equal: f32 within 1e-5, int8/int4 bytes within 1 and equal on
  99.9%, scales within 1e-5 relative).
- End to end, the cases of ``tests/test_refill.py``: the port's refill
  session against the JAX engine's (both on their refill route), plain,
  shared prefix (``rr_prefill_shared`` and ``dec_prefill_pre`` starts),
  prefix-KV reuse and fallback, int8/int4 KV, a sliding window, stop
  strings, speculation inside refill, a single chunk (not engaged): texts,
  token counts, ``refill_stats``, ``spec_stats`` and the programs equal.
- The port alone: a seed reproduces its sampled tokens on the refill route,
  a device OOM halves the rows per dispatch and runs the session again, and
  an engine on a CUDA device raises on a machine without a GPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmrankers_tpu.engine import generate as jgen
from llmrankers_tpu.engine.engine import ScoringEngine as JaxEngine
from llmrankers_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmrankers_tpu.models import decoder as jdec
from llmrankers_tpu.models.config import DecoderConfig as JaxDecoderConfig
from llmrankers_tpu_torch.engine import generate as tgen
from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import decoder as tdec
from llmrankers_tpu_torch.models.config import DecoderConfig


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.delenv("LLMRANKERS_NO_REFILL", raising=False)
    # The tiny model runs thousands of small ops: one intra-op thread keeps
    # the test from oversubscribing the cores beside other test processes.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees():
    out = {}
    for window in (None, 24):
        jcfg = dataclasses.replace(JaxDecoderConfig.tiny(), sliding_window=window)
        out[window] = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.PRNGKey(0)))
    return out


def _cfgs(window=None, kvq=None):
    jcfg = dataclasses.replace(JaxDecoderConfig.tiny(), sliding_window=window, kv_quant=kvq)
    return jcfg, dataclasses.replace(DecoderConfig.tiny(), sliding_window=window)


def _engines(trees, window=None, rows_per_dispatch=4, **kw):
    kw.setdefault("len_buckets", (64,))
    kw.setdefault("batch_buckets", (4, 8, 16))
    jcfg, tcfg = _cfgs(window)
    tree = trees[window]
    jeng = JaxEngine("decoder", jcfg, jax.tree.map(jnp.asarray, tree),
                     JaxByteTokenizer(jcfg.vocab_size), **kw)
    teng = ScoringEngine("decoder", tcfg, tdec.params_from_jax(tree, tcfg, device="cpu"),
                         ByteTokenizer(tcfg.vocab_size), **kw)
    for eng in (jeng, teng):
        eng._gen_row_limit = lambda rows, max_new: rows_per_dispatch
    return jeng, teng


def _rows(n, seed=0, lo=20, hi=56):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(2, 258, size=rng.randint(lo, hi))] for _ in range(n)]


def _prefixed_rows(pre_len=120, n=9, seed=7):
    pre = [int(t) for t in np.random.RandomState(seed).randint(2, 258, pre_len)]
    return [pre + [int(t) for t in np.random.RandomState(100 + i).randint(2, 258, 8 + i % 7)]
            for i in range(n)]


def _same(jeng, teng, rows, **gkw):
    want = jeng.generate(rows, **gkw)
    got = teng.generate(rows, **gkw)
    assert got == want
    assert teng.refill_stats == jeng.refill_stats
    assert teng.spec_stats == jeng.spec_stats
    assert set(teng.programs) == {key[0] for key in jeng._jit_cache}
    return got


# ---------------------------------------------------------------------------
# The device functions against JAX's
# ---------------------------------------------------------------------------
P, MAX_NEW, B = 40, 6, 4


def _left(rows, L):
    ids = np.zeros((len(rows), L), np.int32)
    mask = np.zeros((len(rows), L), np.int32)
    for i, r in enumerate(rows):
        ids[i, L - len(r):] = r
        mask[i, L - len(r):] = 1
    return ids, mask


def _right(rows, L):
    ids = np.zeros((len(rows), L), np.int32)
    mask = np.zeros((len(rows), L), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return ids, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)).long() for a in arrays)


def _leaves(c):
    return list(c) if isinstance(c, tuple) else [c]


def _assert_cache_equal(got, want):
    """A torch cache half against a JAX one: f32 within 1e-5; quantized
    bytes within 1 and equal on 99.9% (ROADMAP C's gate), scales within
    1e-5 relative."""
    got, want = _leaves(got), [np.asarray(w) for w in _leaves(want)]
    assert len(got) == len(want)
    if len(got) == 1:
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=1e-5)
        return
    diff = np.abs(got[0].numpy().astype(np.int32) - want[0].astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-5, atol=1e-12)


def _assert_state_equal(got, want):
    """(tok, cache, wp, done) of the port against JAX's."""
    (gt, (gk, gv, gm, gp), gw, gd), (wt, (wk, wv, wm, wpos), ww, wd) = got, want
    for g, w in ((gt, wt), (gm, wm), (gp, wpos), (gw, ww), (gd, wd)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _assert_cache_equal(gk, wk)
    _assert_cache_equal(gv, wv)


@pytest.fixture(scope="module")
def session():
    """Four left-padded rows of a session (P 40, 6 new tokens) and the
    refill rows: two sharing a 20-token prefix, laid out in a prefix area
    of 24 and a suffix area of 16."""
    rng = np.random.RandomState(3)
    start = [rng.randint(2, 258, size=n).tolist() for n in (30, 40, 25, 36)]
    head = rng.randint(2, 258, size=20).tolist()
    refill = [head + rng.randint(2, 258, size=n).tolist() for n in (9, 14)]
    return start, refill, head


def _start(trees, kvq, start, steps):
    """Prefill the session in JAX and the port, decode ``steps`` tokens with
    the per-row chunk; return both states."""
    jcfg, tcfg = _cfgs(kvq=kvq)
    tree = trees[None]
    jp = jax.tree.map(jnp.asarray, tree)
    model = tdec.params_from_jax(tree, tcfg, device="cpu")
    ids, mask = _left(start, P)
    jl, jc = jgen.decoder_prefill(jp, jcfg, ids, mask, MAX_NEW)
    tl, tc = tgen.decoder_prefill(model, *_t(ids, mask), MAX_NEW, kv_quant=kvq)
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl, dim=-1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    jw, jd = jnp.full((B,), P, jnp.int32), jnp.zeros((B,), bool)
    tw, td = torch.full((B,), P), torch.zeros((B,), dtype=torch.bool)
    jo, (jtok, jc, jw, jd) = jgen.decoder_decode_chunk_rr(jp, jcfg, jtok, jc, jw, P, MAX_NEW,
                                                          steps, jcfg.eos_token_id, jd)
    to, (ttok, tc, tw, td) = tgen.decoder_decode_chunk_rr(model, ttok, tc, tw, P, MAX_NEW,
                                                          steps, tcfg.eos_token_id, td)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    return (jp, jcfg, (jtok, jc, jw, jd)), (model, tcfg, (ttok, tc, tw, td))


@pytest.mark.parametrize("kvq", [None, "int4"])
def test_chunk_rr_matches_jax_and_scalar_chunk(trees, session, kvq):
    """A uniform wp: the per-row chunk equals the scalar chunk and JAX's;
    ten steps on a budget of six, so every row's wp reaches T and its
    writes clamp to T - 1, mask bits included."""
    start, _, _ = session
    jcfg, tcfg = _cfgs(kvq=kvq)
    tree = trees[None]
    model = tdec.params_from_jax(tree, tcfg, device="cpu")
    ids, mask = _t(*_left(start, P))
    logits, cache = tgen.decoder_prefill(model, ids, mask, MAX_NEW, kv_quant=kvq)
    want, _ = tgen.decoder_decode_chunk(model, torch.argmax(logits, -1), cache, P, 0, MAX_NEW,
                                        tcfg.eos_token_id)
    (jp, _, jstate), (_, _, tstate) = _start(trees, kvq, start, 0)
    jo, jstate = jgen.decoder_decode_chunk_rr(jp, jcfg, jstate[0], jstate[1], jstate[2], P,
                                              MAX_NEW, 10, jcfg.eos_token_id, jstate[3])
    to, tstate = tgen.decoder_decode_chunk_rr(model, tstate[0], tstate[1], tstate[2], P,
                                              MAX_NEW, 10, tcfg.eos_token_id, tstate[3])
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert torch.equal(to[:, :MAX_NEW], want)
    assert bool((to[:, MAX_NEW:] == tcfg.pad_token_id).all())
    assert (tstate[2] == P + MAX_NEW).all() and not bool(tstate[1][2][:, -1].any())
    _assert_state_equal(tstate, jstate)


@pytest.mark.parametrize("route", ["plain", "shared", "pre"])
@pytest.mark.parametrize("kvq", [None, "int8", "int4"])
def test_refill_slots_match_jax(trees, session, route, kvq):
    """Refill slots 1 and 3 after three steps, with a padding row whose
    slot (B) is out of range and dropped; then decode eight steps, past the
    budget of the rows that kept their slots: tokens, caches (with the
    previous occupants' bytes behind the refilled rows), masks, positions,
    wp and done equal JAX's at each stage."""
    start, refill, head = session
    (jp, jcfg, jstate), (model, tcfg, tstate) = _start(trees, kvq, start, 3)
    slots = np.array([1, 3, B], np.int32)
    rows = refill + [[0]]
    if route == "plain":
        ids, mask = _left(rows, P)
        jstate = jgen.decoder_refill_slots(jp, jcfg, jstate[1], jstate[0], jstate[2],
                                           jstate[3], ids, mask, slots)
        tstate = tgen.decoder_refill_slots(model, tstate[1], tstate[0], tstate[2], tstate[3],
                                           *_t(ids, mask), slots.tolist())
    else:
        pids, pmask = _right([head], 24)
        sids, smask = _right([r[20:] for r in refill] + [[0]], P - 24)
        gidx = np.zeros((3,), np.int32)
        if route == "shared":
            jstate = jgen.decoder_refill_slots_shared(
                jp, jcfg, jstate[1], jstate[0], jstate[2], jstate[3], pids, pmask, gidx, sids,
                smask, slots)
            tstate = tgen.decoder_refill_slots_shared(
                model, tstate[1], tstate[0], tstate[2], tstate[3], *_t(pids, pmask, gidx, sids,
                                                                      smask), slots.tolist())
        else:
            jks, jvs = jgen.decoder_prefix_kv(jp, jcfg, pids, pmask)
            tks, tvs = tgen.decoder_prefix_kv(model, *_t(pids, pmask))
            jstate = jgen.decoder_refill_slots_pre(
                jp, jcfg, jstate[1], jstate[0], jstate[2], jstate[3], jks, jvs, pmask, gidx,
                sids, smask, slots)
            tstate = tgen.decoder_refill_slots_pre(
                model, tstate[1], tstate[0], tstate[2], tstate[3], tks, tvs,
                *_t(pmask, gidx, sids, smask), slots.tolist())
    # JAX returns (tok, cache, wp, done), as the port.
    _assert_state_equal(tstate, jstate)
    assert tstate[2].tolist() == [P + 3, P, P + 3, P]
    jo, jstate = jgen.decoder_decode_chunk_rr(jp, jcfg, jstate[0], jstate[1], jstate[2], P,
                                              MAX_NEW, 8, jcfg.eos_token_id, jstate[3])
    to, tstate = tgen.decoder_decode_chunk_rr(model, tstate[0], tstate[1], tstate[2], P,
                                              MAX_NEW, 8, tcfg.eos_token_id, tstate[3])
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    _assert_state_equal(tstate, jstate)


# ---------------------------------------------------------------------------
# End to end: the refill session against JAX's
# ---------------------------------------------------------------------------
def test_refill_session_plain_matches_jax(trees):
    jeng, teng = _engines(trees, prefix_share=False)
    _same(jeng, teng, _rows(11, seed=2), max_new_tokens=16, chunk_tokens=4)
    assert teng.refill_stats["sessions"] == 1 and teng.refill_stats["refills"] >= 1
    assert {"dec_chunk_rr", "rr_refill"} <= set(teng.programs)


def test_refill_session_stop_strings_match_jax(trees):
    """Any printable byte stops a row, so rows finish at widely different
    steps and slots free mid-stream."""
    jeng, teng = _engines(trees, prefix_share=False)
    stops = [chr(c) for c in range(48, 123)]
    _, counts = _same(jeng, teng, _rows(10, seed=3), max_new_tokens=24, chunk_tokens=4,
                      stop_strings=stops)
    assert min(counts) < 24 and teng.refill_stats["refills"] >= 1


@pytest.mark.parametrize("cache_mb", [0, 256])
def test_refill_session_shared_prefix_matches_jax(trees, cache_mb):
    """Rows sharing a 120-token prefix: the session starts on the shared
    path (``rr_prefill_shared`` without the prefix-KV cache,
    ``dec_prefill_pre`` with it)."""
    jeng, teng = _engines(trees, len_buckets=(160,), prefix_cache_mb=cache_mb)
    _same(jeng, teng, _prefixed_rows(seed=17), max_new_tokens=12, chunk_tokens=4)
    assert ("dec_prefill_pre" if cache_mb else "rr_prefill_shared") in teng.programs


def test_refill_session_prefix_kv_reuse_matches_jax(trees):
    """Refill batches that extend the session's prefixes run only their
    suffixes on the session's prefix K/V: every refill is a hit."""
    jeng, teng = _engines(trees, len_buckets=(160,))
    _same(jeng, teng, _prefixed_rows(), max_new_tokens=12, chunk_tokens=4)
    assert teng.refill_stats["refills"] >= 1
    assert teng.refill_stats["prefix_kv_hits"] == teng.refill_stats["refills"]
    assert "rr_refill_pre" in teng.programs


def test_refill_session_prefix_kv_fallback_matches_jax(trees):
    """Pending rows that extend none of the session's prefixes fall back to
    a whole prefill of the refill batch."""
    jeng, teng = _engines(trees, len_buckets=(160,))
    rows = _prefixed_rows(n=5) + _rows(4, seed=11, lo=20, hi=40)
    _same(jeng, teng, rows, max_new_tokens=12, chunk_tokens=4)
    assert 0 < teng.refill_stats["prefix_kv_hits"] < teng.refill_stats["refills"]


@pytest.mark.parametrize("kvq", ["int8", "int4"])
def test_refill_session_quantized_kv_matches_jax(trees, kvq):
    jeng, teng = _engines(trees, prefix_share=False, kv_quantize=kvq)
    _same(jeng, teng, _rows(9, seed=4), max_new_tokens=12, chunk_tokens=4)


def test_refill_session_sliding_window_matches_jax(trees):
    """A window of 24 under per-row write positions."""
    jeng, teng = _engines(trees, window=24, rows_per_dispatch=3, prefix_share=False)
    _same(jeng, teng, _rows(7, seed=5, lo=30, hi=50), max_new_tokens=12, chunk_tokens=4)


def _repetitive_rows(n=9, seed=8):
    rng = np.random.RandomState(seed)
    return [([int(t) for t in rng.randint(2, 258, 8)] * 5)[: 30 + i] for i in range(n)]


def test_refill_session_spec_decode_matches_jax(trees):
    """Speculation inside the refill session: drafts from each slot's own
    history, refilled slots' histories scattered with their caches."""
    jeng, teng = _engines(trees, prefix_share=False, spec_lookup=3)
    got = _same(jeng, teng, _repetitive_rows(), max_new_tokens=16, chunk_tokens=8)
    assert teng.spec_stats["rounds"] > 0 and "dec_spec_chunk" in teng.programs
    _, plain = _engines(trees, prefix_share=False)
    assert plain.generate(_repetitive_rows(), max_new_tokens=16, chunk_tokens=8) == got


def test_refill_session_prefix_kv_spec_matches_jax(trees):
    """Prefix-KV refill under speculation: a refilled slot's history is the
    session's prefix tokens and the batch's suffixes."""
    jeng, teng = _engines(trees, len_buckets=(160,), spec_lookup=3)
    seg = [int(t) for t in np.random.RandomState(8).randint(2, 258, 8)]
    pre = (seg * 20)[:120]
    rows = [pre + (seg * 3)[: 8 + i % 5] for i in range(9)]
    _same(jeng, teng, rows, max_new_tokens=16, chunk_tokens=8)
    assert teng.refill_stats["prefix_kv_hits"] >= 1


def test_refill_not_engaged_single_chunk_matches_jax(trees):
    jeng, teng = _engines(trees, rows_per_dispatch=16, prefix_share=False)
    _same(jeng, teng, _rows(3, seed=6), max_new_tokens=12, chunk_tokens=4)
    assert teng.refill_stats["sessions"] == 0 and "dec_chunk" in teng.programs


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------
def test_refill_session_sampling_same_seed(trees):
    """Sampling on the refill route: a seed gives the same tokens again,
    another seed others; greedy at temperature 0."""
    _, teng = _engines(trees, prefix_share=False)
    rows = _rows(9, seed=12)
    kw = dict(max_new_tokens=12, chunk_tokens=4, temperature=1.5)
    a = teng.generate(rows, seed=3, **kw)
    assert teng.refill_stats["sessions"] == 1
    assert teng.generate(rows, seed=3, **kw) == a
    assert teng.generate(rows, seed=4, **kw) != a
    greedy = teng.generate(rows, max_new_tokens=12, chunk_tokens=4)
    assert teng.generate(rows, max_new_tokens=12, chunk_tokens=4, temperature=0.0,
                         seed=3) == greedy != a


def test_refill_session_oom_halves_and_recovers(trees):
    """A device OOM inside the session halves the rows per dispatch (a rung
    of the ladder), is remembered, and the whole session runs again."""
    _, teng = _engines(trees, rows_per_dispatch=8, prefix_share=False)
    rows = _rows(12, seed=9)
    want = teng.generate(rows, max_new_tokens=8, chunk_tokens=4)
    caps, orig = [], teng._generate_refill

    def refill(rows_, max_new, stops, chunk, row_limit, **kw):
        caps.append(row_limit)
        if row_limit > 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
        return orig(rows_, max_new, stops, chunk, row_limit, **kw)

    teng._generate_refill = refill
    assert teng.generate(rows, max_new_tokens=8, chunk_tokens=4) == want
    assert caps == [8, 4] and list(teng._learned_row_caps.values()) == [4]


def test_cuda_engine_raises_without_gpu(trees):
    """An engine or weights on the CUDA device raise on a machine without a
    GPU instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    tcfg = DecoderConfig.tiny()
    with pytest.raises((RuntimeError, AssertionError)):
        tdec.params_from_jax(trees[None], tcfg)
    model = tdec.params_from_jax(trees[None], tcfg, device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        ScoringEngine("decoder", tcfg, model, ByteTokenizer(tcfg.vocab_size), device="cuda",
                      spec_lookup=4).generate(_rows(9), max_new_tokens=8, chunk_tokens=4)


def test_pkv_insert_seeds_the_prefix_cache(trees):
    """A session's prefix K/V put in the cross-wave prefix cache: the next
    lookup of those prefixes hits, runs no ``prefix_kv`` and returns them."""
    _, teng = _engines(trees)
    rng = np.random.RandomState(21)
    pre_rows = [rng.randint(2, 258, size=n).tolist() for n in (30, 17)]
    ids, mask = _t(*_right(pre_rows, 32))
    ks, vs = tgen.decoder_prefix_kv(teng.model, ids, mask)
    teng._pkv_insert(pre_rows, ks, vs)
    got_k, got_v = teng._pkv_assemble(pre_rows, 32)
    assert teng.pkv_stats["hits"] == 2 and "prefix_kv" not in teng.programs
    for got, want in ((got_k, ks), (got_v, vs)):
        for g, p in enumerate(pre_rows):
            assert torch.equal(got[:, g, :, :len(p)], want[:, g, :, :len(p)])
