"""Port parity of decoder generation: the port's ``ScoringEngine.generate``
and ``engine/generate.py`` against the JAX package.

- Greedy ``generate`` token for token against the JAX engine (fp32, the same
  parameter tree and rows): a cache in the model's dtype, int8 and int4, on
  the left-padded (``dec_gen``/``dec_prefill``), shared-prefix
  (``*_shared``) and prefix-cache (``*_pre``) paths, in one go and in chunks
  with a stop string that fires; a Mistral-like window of 64; int8 and int4
  weights; several dispatches. The completions, the token counts and the
  programs run (the JAX ``_jit_cache`` names against the port's
  ``programs``) are equal. These are the per-dispatch route's tests: both
  engines run with ``LLMRANKERS_NO_REFILL=1``, off the slot-refill session
  that ``tests/test_torch_refill.py`` checks.
- Greedy decoding against HF ``generate`` on models built from config
  (Llama, Qwen2), left-padded; chunked decoding equals one pass; the decode
  writes the preallocated cache in place.
- ``_gen_row_limit`` equals the JAX engine's on the CPU (its 16 GiB
  fallback); a device OOM halves the rows per dispatch and is remembered.
- Sampling (not comparable with ``jax.random``): a seed reproduces its
  tokens, another seed differs, temperature 0 is greedy, the stream is keyed
  per global step (chunking does not change it) and per dispatch chunk.
- ``kv_quantize`` is validated as in JAX; with ``spec_lookup`` sampling
  raises, as in JAX.
- The decode step on device write positions (``generate.DecodeState``)
  against the host-position loop, on kept buffers and replayed through a
  stand-in capture (the ``replayed`` fixture); the JAX parity cases on
  replayed steps; which decodes capture, replay or run eagerly
  (``graph_stats``), and that an OOM backoff and ``score_labels`` free the
  kept buffers.
"""
import dataclasses
import gc
import types
import weakref

import numpy as np
import pytest
import torch

import jax

from llmrankers_tpu.engine import generate as jgen
from llmrankers_tpu.engine.engine import ScoringEngine as JaxEngine
from llmrankers_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmrankers_tpu.models import decoder as jdec
from llmrankers_tpu.models.config import DecoderConfig as JaxDecoderConfig
from llmrankers_tpu_torch.engine import engine as teng
from llmrankers_tpu_torch.engine import generate as tgen
from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import decoder as tdec
from llmrankers_tpu_torch.models.config import DecoderConfig

from test_models import _hf_llama

LADDERS = dict(len_buckets=(32, 64, 128, 256), batch_buckets=(4, 8, 16),
               max_batch_tokens=4096)
PATHS = {"plain": dict(prefix_share=False), "shared": dict(prefix_cache_mb=0),
         "cached": {}}
STOP = ("</answer>",)


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    # The per-dispatch route: both engines read this switch and run off
    # their slot-refill sessions.
    monkeypatch.setenv("LLMRANKERS_NO_REFILL", "1")


@pytest.fixture(scope="module")
def trees():
    out = {}
    for window in (None, 64):
        jcfg = dataclasses.replace(JaxDecoderConfig.tiny(attention_bias=True),
                                   sliding_window=window)
        tree = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.PRNGKey(1)))
        rng = np.random.RandomState(1)
        for key in ("bq", "bk", "bv"):  # the random init's biases are zeros
            tree["layers"][key] = (0.3 * rng.randn(*tree["layers"][key].shape)
                                   ).astype(np.float32)
        out[window] = tree
    return out


def _engines(trees, window=None, **kw):
    jcfg = dataclasses.replace(JaxDecoderConfig.tiny(attention_bias=True),
                               sliding_window=window)
    tcfg = dataclasses.replace(DecoderConfig.tiny(attention_bias=True),
                               sliding_window=window)
    tree = trees[window]
    jeng = JaxEngine("decoder", jcfg, jax.tree.map(jax.numpy.asarray, tree),
                     JaxByteTokenizer(jcfg.vocab_size), **LADDERS, **kw)
    teng_ = ScoringEngine("decoder", tcfg, tdec.params_from_jax(tree, tcfg, device="cpu"),
                          ByteTokenizer(tcfg.vocab_size), **LADDERS, **kw)
    return jeng, teng_


def _wave(seed=0, n_rows=10, prefixes=(70, 45), suffix=(3, 40)):
    rng = np.random.RandomState(seed)
    heads = [list(rng.randint(2, 258, size=n)) for n in prefixes]
    return [heads[i % len(heads)] + list(rng.randint(2, 258, size=rng.randint(*suffix)))
            for i in range(n_rows)]


def _same(jeng, teng_, rows, **gkw):
    want = jeng.generate(rows, **gkw)
    got = teng_.generate(rows, **gkw)
    assert got == want
    assert set(teng_.programs) == {key[0] for key in jeng._jit_cache}
    return got


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("kvq", [None, "int8", "int4"])
def test_generate_matches_jax(trees, kvq, path):
    jeng, teng_ = _engines(trees, kv_quantize=kvq, **PATHS[path])
    _same(jeng, teng_, _wave(), max_new_tokens=10)
    assert {p for p in teng_.programs if p.startswith("dec_")} == {
        "plain": {"dec_gen"}, "shared": {"dec_gen_shared"}, "cached": {"dec_gen_pre"}}[path]


@pytest.mark.parametrize("kvq,path", [(None, "plain"), ("int8", "shared"), ("int4", "cached")])
def test_chunked_stop_string_matches_jax(trees, kvq, path):
    """Chunks of 4 with a stop string: once "</answer>" (which never fires),
    then a stop string taken from a completion, which freezes rows between
    chunks and ends the loop early."""
    jeng, teng_ = _engines(trees, kv_quantize=kvq, **PATHS[path])
    rows = _wave(1)
    texts, _ = _same(jeng, teng_, rows, max_new_tokens=16, chunk_tokens=4, stop_strings=STOP)
    stop = max(texts, key=len)[:1]  # random bytes: many do not decode
    got, counts = _same(jeng, teng_, rows, max_new_tokens=16, chunk_tokens=4,
                        stop_strings=(stop,))
    assert stop and any(t.endswith(stop) for t in got) and min(counts) < 16
    assert "dec_chunk" in teng_.programs


def test_pipelined_chunks_match_jax(trees):
    """No stop strings and the tokenizer's EOS the model's: chunk i+1 is
    enqueued before chunk i is read back, and rows freeze on EOS on the
    device only."""
    jcfg = dataclasses.replace(JaxDecoderConfig.tiny(attention_bias=True), eos_token_id=1)
    tcfg = dataclasses.replace(DecoderConfig.tiny(attention_bias=True), eos_token_id=1)
    tree = trees[None]
    jeng = JaxEngine("decoder", jcfg, jax.tree.map(jax.numpy.asarray, tree),
                     JaxByteTokenizer(jcfg.vocab_size), kv_quantize="int8", **LADDERS)
    teng_ = ScoringEngine("decoder", tcfg, tdec.params_from_jax(tree, tcfg, device="cpu"),
                          ByteTokenizer(tcfg.vocab_size), kv_quantize="int8", **LADDERS)
    _same(jeng, teng_, _wave(8), max_new_tokens=14, chunk_tokens=4)
    assert teng_.programs["dec_chunk"] >= 2


@pytest.mark.parametrize("path", ["plain", "cached"])
def test_window_generate_matches_jax(trees, path):
    """A sliding window of 64 over prompts of up to 110 tokens (the decode's
    cumulative-position window mask on the shared path's holes)."""
    jeng, teng_ = _engines(trees, window=64, kv_quantize="int8", **PATHS[path])
    _same(jeng, teng_, _wave(2), max_new_tokens=12, chunk_tokens=5)


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_weights_generate_matches_jax(trees, quantize):
    jeng, teng_ = _engines(trees, quantize=quantize, kv_quantize="int4")
    _same(jeng, teng_, _wave(3), max_new_tokens=10)


def test_several_dispatches_match_jax(trees, monkeypatch):
    """Four rows per dispatch (the row limit forced): three dispatches, in
    chunks; the JAX engine off its refill session."""
    jeng, teng_ = _engines(trees, kv_quantize="int8", prefix_share=False)
    for eng in (jeng, teng_):
        monkeypatch.setattr(eng, "_gen_row_limit", lambda rows, max_new: 4)
    _same(jeng, teng_, _wave(4), max_new_tokens=9, chunk_tokens=4, stop_strings=STOP)
    assert teng_.programs["dec_prefill"] == 3


@pytest.mark.parametrize("kind", ["llama", "qwen2"])
def test_greedy_matches_hf(kind):
    """tests/test_generate.py's HF check on the port: left padding, 6 tokens."""
    model, cfg, params = _hf_llama(kind)
    tcfg = DecoderConfig(**dataclasses.asdict(cfg))
    tmodel = tdec.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.RandomState(4)
    B, L = 3, 10
    ids = rng.randint(2, 500, size=(B, L))
    mask = np.ones((B, L), dtype=np.int64)
    mask[1, :4] = 0
    ids[1, :4] = 0
    with torch.no_grad():
        want = model.generate(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask),
                              max_new_tokens=6, do_sample=False, num_beams=1,
                              pad_token_id=0).numpy()[:, L:]
        logits, cache = tgen.decoder_prefill(tmodel, torch.from_numpy(ids),
                                             torch.from_numpy(mask), 6)
        got = tgen.decoder_greedy_decode(tmodel, logits.argmax(-1), cache, L, 6,
                                         cfg.eos_token_id).numpy()
    T = min(got.shape[1], want.shape[1])
    for b in range(B):
        for t in range(T):
            assert got[b, t] == want[b, t], (b, t, got[b], want[b])
            if want[b, t] == cfg.eos_token_id:
                break


@pytest.mark.parametrize("kvq", [None, "int4"])
def test_chunked_decode_matches_one_pass_and_writes_in_place(kvq):
    model, cfg, params = _hf_llama("llama")
    tcfg = DecoderConfig(**dataclasses.asdict(cfg))
    tmodel = tdec.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.RandomState(7)
    ids = torch.from_numpy(rng.randint(2, 500, size=(2, 8)))
    mask = torch.ones((2, 8), dtype=torch.int64)
    with torch.no_grad():
        logits, cache = tgen.decoder_prefill(tmodel, ids, mask, 12, kv_quant=kvq)
        want = tgen.decoder_greedy_decode(tmodel, logits.argmax(-1), cache, 8, 12,
                                          cfg.eos_token_id)
        logits, cache = tgen.decoder_prefill(tmodel, ids, mask, 12, kv_quant=kvq)
        kc = cache[0] if kvq is None else cache[0][0]
        ptr = kc.data_ptr()
        tok, done, pieces = logits.argmax(-1), None, []
        for off in (0, 4, 8):
            out, (tok, cache, done) = tgen.decoder_decode_chunk(
                tmodel, tok, cache, 8, off, 4, cfg.eos_token_id, done=done)
            pieces.append(out)
    assert torch.equal(torch.cat(pieces, dim=1), want)
    kc = cache[0] if kvq is None else cache[0][0]
    assert kc.data_ptr() == ptr and kc.shape[3] == 20  # the preallocated cache
    assert bool(cache[2].all())  # every slot written: 8 prompt tokens, 12 new


def test_decoder_prefill_matches_jax(trees):
    """Last logits and the cache of the left-padded prefill, int8 KV: the
    payloads equal JAX's wherever the f32 K/V round alike."""
    tree = trees[None]
    jcfg = dataclasses.replace(JaxDecoderConfig.tiny(attention_bias=True), kv_quant="int8")
    tcfg = DecoderConfig.tiny(attention_bias=True)
    tmodel = tdec.params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.RandomState(9)
    ids = rng.randint(2, 258, size=(3, 20)).astype(np.int32)
    mask = np.ones((3, 20), np.int32)
    mask[1, :7] = 0
    want_l, (wk, wv, wmask, wpos) = jgen.decoder_prefill(
        jax.tree.map(jax.numpy.asarray, tree), jcfg, ids, mask, 5)
    with torch.no_grad():
        got_l, (gk, gv, gmask, gpos) = tgen.decoder_prefill(
            tmodel, torch.from_numpy(ids).long(), torch.from_numpy(mask), 5, kv_quant="int8")
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=0, atol=2e-4)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
    for got, want in ((gk, wk), (gv, wv)):
        assert got[0].shape == np.asarray(want[0]).shape
        diff = np.abs(got[0].numpy().astype(np.int32) - np.asarray(want[0]).astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)


@pytest.mark.parametrize("kvq,quantize", [(None, None), ("int8", None), ("int4", None),
                                          ("int8", "int8"), ("int4", "int4")])
def test_gen_row_limit_matches_jax(trees, monkeypatch, kvq, quantize):
    """The row limit on the CPU: the JAX formula against 16 GiB less the
    weights (the quantized JAX engine with its kernels allowed, as the port
    allows them)."""
    monkeypatch.setenv("LLMRANKERS_FORCE_QKERNELS", "1")
    jeng, teng_ = _engines(trees, kv_quantize=kvq, quantize=quantize)
    assert teng_._params_bytes() == sum(
        int(np.prod(x.shape)) * x.dtype.itemsize for x in jax.tree.leaves(jeng.params))
    for rows, new in ((_wave(5), 64), ([[3] * 3000], 2048)):
        assert teng_._gen_row_limit(rows, new) == jeng._gen_row_limit(rows, new)
    assert teng_._row_ladder() == jeng._row_ladder()
    assert [teng_._halve_cap(n) for n in (1, 7, 33, 100)] == [
        jeng._halve_cap(n) for n in (1, 7, 33, 100)]


def _fake_oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 6.90 GiB")


def test_oom_backoff_halves_and_recovers(trees):
    _, teng_ = _engines(trees, prefix_share=False)
    rows = _wave(6, n_rows=8)
    want = teng_.generate(rows, max_new_tokens=6)
    sizes, orig = [], teng_._generate_dispatch
    state = {"left": 1}

    def dispatch(chunk, *a, **kw):
        sizes.append(len(chunk))
        if len(chunk) > 4 and state["left"]:
            state["left"] -= 1
            raise _fake_oom()
        return orig(chunk, *a, **kw)

    teng_._generate_dispatch = dispatch
    assert teng_.generate(rows, max_new_tokens=6) == want
    assert sizes[0] == 8 and all(s <= 4 for s in sizes[1:])
    assert list(teng_._learned_row_caps.values()) == [4]
    sizes.clear()
    teng_.generate(rows, max_new_tokens=6)  # the learned cap holds
    assert sizes and all(s <= 4 for s in sizes)
    teng_._generate_dispatch = lambda chunk, *a, **kw: (_ for _ in ()).throw(
        ValueError("not an OOM"))
    with pytest.raises(ValueError, match="not an OOM"):
        teng_.generate(rows, max_new_tokens=6)


def test_is_oom_classifier():
    assert teng._is_oom(_fake_oom())
    assert not teng._is_oom(RuntimeError("CUDA error: an illegal memory access"))
    assert not teng._is_oom(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))


def test_sampling(trees, monkeypatch):
    """Seeded sampling: reproducible, seed-dependent, greedy at temperature
    0, keyed per global step (chunking keeps it) and per dispatch chunk."""
    _, teng_ = _engines(trees, kv_quantize="int4", prefix_share=False)
    rows = _wave(7, n_rows=4)
    kw = dict(max_new_tokens=12, temperature=1.5)
    a = teng_.generate(rows, seed=3, **kw)
    assert teng_.generate(rows, seed=3, **kw) == a
    assert teng_.generate(rows, seed=4, **kw) != a
    assert teng_.generate(rows, seed=3, chunk_tokens=5, **kw) == a
    greedy = teng_.generate(rows, max_new_tokens=12)
    assert teng_.generate(rows, max_new_tokens=12, temperature=0.0, seed=3) == greedy
    assert a != greedy
    # Two copies of one row in two dispatches sample different streams.
    monkeypatch.setattr(teng_, "_gen_row_limit", lambda rows, max_new: 1)
    texts, _ = teng_.generate([rows[0], rows[0]], seed=3, **kw)
    assert texts[0] != texts[1]
    assert teng_.generate([rows[0], rows[0]], seed=3, **kw)[0] == texts


def test_kv_quantize_validation(trees):
    tcfg = DecoderConfig.tiny(attention_bias=True)
    model = tdec.params_from_jax(trees[None], tcfg, device="cpu")
    tok = ByteTokenizer(tcfg.vocab_size)
    with pytest.raises(ValueError, match="unknown kv_quantize"):
        ScoringEngine("decoder", tcfg, model, tok, kv_quantize="fp8")
    odd = dataclasses.replace(tcfg, head_dim=15)
    with pytest.raises(ValueError, match="even head_dim"):
        ScoringEngine("decoder", odd, tdec.Decoder(odd, device="cpu"), tok, kv_quantize="int4")
    spec = ScoringEngine("decoder", tcfg, model, tok, spec_lookup=4)
    with pytest.raises(ValueError, match="incompatible with spec_lookup"):
        spec.generate([[5, 6]], 2, temperature=1.0)
    eng = ScoringEngine("decoder", tcfg, model, tok, kv_quantize="int8")
    assert eng.cfg.kv_quant == "int8" and model.cfg.kv_quant is None
    with pytest.raises(NotImplementedError, match="A10"):
        eng.generate([[5, 6]], 2, adapter="lora")


# ---------------------------------------------------------------------------
# The decode step on device write positions, kept buffers and replays
# ---------------------------------------------------------------------------
def _parent_chunk(model, tok, cache, L, offset, steps, eos_id, done=None):
    """The decode loop with host write positions (the cache written at
    ``L + t`` by a host slice, the key-mask bit by a host index, ``pos``
    advanced out of place): what the step on device positions must equal."""
    kc, vc, kmask, pos = cache
    if done is None:
        done = torch.zeros(tok.shape, dtype=torch.bool)
    dtype = tgen._act_dtype(model)
    win = tgen._win(model, kmask.shape[1])
    pad = model.cfg.pad_token_id
    outs = []
    for i in range(steps):
        t = offset + i
        cos, sin = model.rope(pos[:, None], dtype)
        logits, kn, vn = tgen._decode_token_forward(
            model, tok, kc, vc, tgen._window_mask(kmask, pos, win), cos, sin)
        tgen._cache_put(kc, kn[:, :, :, None, :], L + t)
        tgen._cache_put(vc, vn[:, :, :, None, :], L + t)
        kmask[:, L + t] = True
        nxt = torch.argmax(logits, dim=-1)
        outs.append(torch.where(done, torch.full_like(tok, pad), tok))
        done = done | (tok == eos_id)
        tok = torch.where(done, tok, nxt)
        pos = pos + 1
    return torch.stack(outs, dim=1), (tok, (kc, vc, kmask, pos), done)


class _FakeGraph:
    """A captured step on the CPU: replay runs the step eagerly."""

    def __init__(self, step):
        self.replay = step


def _fake_capture(step, dev):
    step()  # the warm-up writes the buffers, as on the card
    return _FakeGraph(step)


@pytest.fixture
def replayed(monkeypatch):
    """Graphs on the CPU: ``graph_wanted`` judged as on the card, and each
    capture a stand-in whose replay runs the captured step eagerly, so the
    engine's route to its kept buffers and replays runs here."""
    wanted = tgen.graph_wanted

    def on_card(model, steps, temperature=0.0, key=None):
        card = types.SimpleNamespace(plain_kernels=model.plain_kernels,
                                     final_ln=types.SimpleNamespace(device=torch.device("cuda")))
        return wanted(card, steps, temperature, key)

    monkeypatch.setattr(tgen, "graph_wanted", on_card)
    monkeypatch.setattr(tgen, "_capture_step", _fake_capture)


def _leaves(cache):
    return [x for half in cache[:2] for x in ((half,) if isinstance(half, torch.Tensor) else half)]


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("kvq", [None, "int8", "int4"])
def test_device_position_step_matches_parent_loop(trees, request, kvq, chunks):
    """The step on device write positions gives the host-position loop's
    tokens, cache bytes, key mask, positions and done, in one chunk or
    three, on a cache built over the arguments (``args``), on kept buffers
    that a prefill filled (``kept``) and replayed from a captured step over
    them (``replayed``, captured before the prefill, whose warm-up the
    prefill must wipe; its 3 chunks are 16 replayed steps and 2 eager)."""
    tcfg = DecoderConfig.tiny(attention_bias=True)
    model = tdec.params_from_jax(trees[None], tcfg, device="cpu")
    rng = np.random.RandomState(11)
    ids = torch.from_numpy(rng.randint(2, 258, size=(3, 12)))
    mask = torch.ones((3, 12), dtype=torch.int64)
    mask[1, :5] = 0
    steps, eos = 18, 7  # an EOS the random model emits now and then
    with torch.no_grad():
        logits, cache = tgen.decoder_prefill(model, ids, mask, steps, kv_quant=kvq)
        want, (wtok, wcache, wdone) = _parent_chunk(model, logits.argmax(-1), cache, 12, 0,
                                                    steps, eos)
    for route in ("args", "kept", "replayed"):
        if route == "replayed":
            request.getfixturevalue("replayed")
        with torch.no_grad():
            st = bufs = None
            if route != "args":
                st = tgen.DecodeState.alloc(model, 3, 12 + steps, tgen._act_dtype(model), kvq)
                bufs = (st.kc, st.vc)
                if route == "replayed":
                    st.capture(model, eos)
            logits, cache = tgen.decoder_prefill(model, ids, mask, steps, kv_quant=kvq,
                                                 bufs=bufs)
            tok, done, pieces = logits.argmax(-1), None, []
            sizes = [steps] if chunks == 1 else [16, 1, 1] if route == "replayed" else [6] * 3
            off = replays = 0
            for n in sizes:
                replay = route == "replayed" and tgen.graph_wanted(model, n)
                out, (tok, cache, done) = tgen.decoder_decode_chunk(
                    model, tok, cache, 12, off, n, eos, done=done, state=st, replay=replay)
                pieces.append(out.clone())
                off += n
                replays += n if replay else 0
        assert torch.equal(torch.cat(pieces, dim=1), want), route
        assert torch.equal(tok, wtok) and torch.equal(done, wdone), route
        assert torch.equal(cache[2], wcache[2]) and torch.equal(cache[3], wcache[3]), route
        for got, ref in zip(_leaves(cache), _leaves(wcache)):
            assert torch.equal(got, ref), route
        assert replays == (0 if route != "replayed" else 16 if chunks == 3 else steps), route


@pytest.mark.parametrize("case", ["plain-one", "shared-chunks", "cached-window", "dispatches"])
def test_replayed_generate_matches_jax(trees, monkeypatch, replayed, case):
    """The JAX parity cases on replayed steps, in one go and in chunks (the
    last shorter than a replay takes, so eager on the same buffers): the
    completions, counts and programs of the JAX engine, every step of 16 or
    more replayed."""
    window, kvq, path, gkw = {
        "plain-one": (None, None, "plain", dict(max_new_tokens=20)),
        "shared-chunks": (None, "int8", "shared", dict(max_new_tokens=40, chunk_tokens=16,
                                                        stop_strings=STOP)),
        "cached-window": (64, "int8", "cached", dict(max_new_tokens=36, chunk_tokens=16)),
        "dispatches": (None, "int8", "plain", dict(max_new_tokens=20)),
    }[case]
    jeng, teng_ = _engines(trees, window=window, kv_quantize=kvq, **PATHS[path])
    if case == "dispatches":
        for eng in (jeng, teng_):
            monkeypatch.setattr(eng, "_gen_row_limit", lambda rows, max_new: 4)
    _same(jeng, teng_, _wave(13, prefixes=(70,)), **gkw)
    new, chunk = gkw["max_new_tokens"], gkw.get("chunk_tokens", gkw["max_new_tokens"])
    dispatches = sum(v for k, v in teng_.programs.items()
                     if k.startswith(("dec_gen", "dec_prefill")))
    stats = teng_.graph_stats
    assert stats["captures"] == 1 and dispatches == (3 if case == "dispatches" else 1)
    assert stats["replays"] == dispatches * (new - new % chunk)
    assert stats["eager_steps"] == dispatches * (new % chunk)


def test_graph_counts_and_routes(trees, monkeypatch, replayed):
    """One capture serves the dispatches and calls of one shape; another T
    captures again; sampled decodes and decodes under 16 steps run
    eagerly (sampling frees the kept buffers); the programs are counted as
    without graphs."""
    _, eng = _engines(trees, kv_quantize="int8", prefix_share=False)
    _, ref = _engines(trees, kv_quantize="int8", prefix_share=False)
    ref.model.plain_kernels = True  # never replays: the route without graphs
    for e in (eng, ref):
        monkeypatch.setattr(e, "_gen_row_limit", lambda rows, max_new: 4)
    rows = _wave(14, n_rows=8, prefixes=(40,), suffix=(3, 20))
    calls = [dict(max_new_tokens=16), dict(max_new_tokens=16),
             dict(max_new_tokens=24, chunk_tokens=16),
             dict(max_new_tokens=12, temperature=1.5, seed=3), dict(max_new_tokens=8)]
    want = [(True, 1, 32, 0), (True, 1, 64, 0), (True, 2, 96, 16), (False, 2, 96, 40),
            (True, 2, 96, 56)]  # kept buffers, captures, replays, eager steps
    for kw, (kept, captures, replays, eager) in zip(calls, want):
        assert eng.generate(rows, **kw) == ref.generate(rows, **kw)
        assert eng.graph_stats == {"captures": captures, "replays": replays,
                                   "eager_steps": eager}
        if kept:
            assert eng._dstate.key[:2] == (4, 64 + kw["max_new_tokens"])
        else:
            assert eng._dstate is None
    assert eng.programs == ref.programs
    assert set(eng.programs) == {"dec_gen", "dec_prefill", "dec_chunk"}
    assert ref.graph_stats["captures"] == ref.graph_stats["replays"] == 0


def test_oom_backoff_frees_decode_state(trees, monkeypatch, replayed):
    """A device OOM frees the kept buffers and their graph before the
    allocator's cache is emptied; the smaller dispatches capture anew."""
    _, eng = _engines(trees, prefix_share=False)
    rows = _wave(6, n_rows=8)
    want = eng.generate(rows, max_new_tokens=16)
    assert eng.graph_stats["captures"] == 1 and eng._dstate.key[0] == 8
    seen, orig = [], eng._generate_dispatch
    state = {"left": 1}

    def dispatch(chunk, *a, **kw):
        if len(chunk) > 4 and state["left"]:
            state["left"] -= 1
            raise _fake_oom()
        return orig(chunk, *a, **kw)

    monkeypatch.setattr(eng, "_generate_dispatch", dispatch)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: seen.append(eng._dstate))
    assert eng.generate(rows, max_new_tokens=16) == want
    assert seen == [None]
    assert eng.graph_stats["captures"] == 2 and eng._dstate.key[0] == 4


def test_score_labels_frees_decode_state(trees, monkeypatch, replayed):
    """The kept buffers do not outlive a generate into ``score_labels``: the
    label call frees them and their graph, and the next generate of the
    shape allocates and captures anew, with the same completions."""
    _, eng = _engines(trees, kv_quantize="int8", prefix_share=False)
    rows = _wave(15, n_rows=4, prefixes=(40,), suffix=(3, 20))
    want = eng.generate(rows, max_new_tokens=16)
    held = weakref.ref(eng._dstate)
    eng.score_labels(rows, [5, 6, 7])
    gc.collect()
    assert eng._dstate is None and held() is None
    assert eng.generate(rows, max_new_tokens=16) == want
    assert eng.graph_stats == {"captures": 2, "replays": 32, "eager_steps": 0}
