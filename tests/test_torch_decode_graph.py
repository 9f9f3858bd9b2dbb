"""Greedy decode steps replayed from a CUDA graph, on the card: marked
``card`` and skipped without a GPU (run them there with ``python -m pytest
tests/test_torch_decode_graph.py -q -m card``; the other test files import
JAX, which the card's machine need not have).

On a small decoder (head_dim 64, so B8 takes it) in bf16 on the card:

- a replayed decode gives the eager decode's tokens, cache bytes, key mask,
  positions and done bit for bit, over int8 and int4 caches (the same
  kernels in the same order); the kernel wrappers count a capture's
  warm-up and captured steps and no replay, and the device trace of the
  replays holds B8 once a layer and step;
- through the engine, two dispatches and two calls of one shape make one
  capture, and ``replays`` equals their steps (one per step of a
  dispatch); a new cache length frees the kept buffers and captures again;
  a device OOM frees the buffers and their graph before the allocator's
  cache is emptied.

No JAX here: the eager route of the same code is the reference.
"""
import gc
import weakref

import pytest
import torch

from llmrankers_tpu_torch.engine import generate as gen
from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import decoder as dec
from llmrankers_tpu_torch.models.config import DecoderConfig
from llmrankers_tpu_torch.ops import kvq_attention

CFG = DecoderConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
LADDERS = dict(len_buckets=(64, 128), batch_buckets=(4, 8))


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return dec.init_params(CFG, torch.Generator(device="cuda").manual_seed(5),
                           dtype=torch.bfloat16, device="cuda")


def _rows(n, seed=0, lo=40, hi=60):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(2, 258, (int(torch.randint(lo, hi, (1,), generator=g)),),
                          generator=g).tolist() for _ in range(n)]


def _leaves(cache):
    return [x for half in cache[:2] for x in ((half,) if isinstance(half, torch.Tensor) else half)]


@pytest.mark.card
@pytest.mark.parametrize("kvq", ["int8", "int4"])
def test_replay_equals_eager_bit_for_bit(model, kvq):
    """Bit for bit against the eager decode; launches counted at the
    wrappers, and B8's kernels in the device trace of the replays."""
    ids = torch.randint(2, 258, (8, 64), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    mask = torch.ones_like(ids)
    mask[3, :20] = 0
    steps, eos, T = 40, 9, 64 + 40
    with torch.inference_mode():
        logits, cache = gen.decoder_prefill(model, ids, mask, steps, kv_quant=kvq)
        kvq_attention.kvq_decode_attention.launches = 0
        want, (wtok, wcache, wdone) = gen.decoder_decode_chunk(
            model, logits.argmax(-1), cache, 64, 0, steps, eos)
        eager_launches = kvq_attention.kvq_decode_attention.launches
        st = gen.DecodeState.alloc(model, 8, T, gen._act_dtype(model), kvq)
        st.capture(model, eos)
        captured = kvq_attention.kvq_decode_attention.launches - eager_launches
        logits, cache = gen.decoder_prefill(model, ids, mask, steps, kv_quant=kvq,
                                            bufs=(st.kc, st.vc))
        tok0 = logits.argmax(-1)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            got, (tok, gcache, done) = gen.decoder_decode_chunk(
                model, tok0, cache, 64, 0, steps, eos, state=st, replay=True)
            torch.cuda.synchronize()
    layers = CFG.num_hidden_layers
    # The wrapper counts the warm-up and the captured step, and no replay.
    assert eager_launches == layers * steps and captured == 2 * layers
    assert kvq_attention.kvq_decode_attention.launches == eager_launches + captured
    b8 = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
          and "kvq_decode_kernel" in e.name]
    assert len(b8) == layers * steps
    assert torch.equal(got, want) and torch.equal(tok, wtok) and torch.equal(done, wdone)
    assert torch.equal(gcache[2], wcache[2]) and torch.equal(gcache[3], wcache[3])
    for a, b in zip(_leaves(gcache), _leaves(wcache)):
        assert torch.equal(a, b)


def _engine(model, kvq="int8"):
    return ScoringEngine("decoder", CFG, model, ByteTokenizer(CFG.vocab_size),
                         kv_quantize=kvq, prefix_share=False, **LADDERS)


@pytest.mark.card
def test_one_capture_serves_dispatches_and_calls(model, monkeypatch):
    eng = _engine(model)
    monkeypatch.setattr(eng, "_gen_row_limit", lambda rows, max_new: 4)
    rows = _rows(8, seed=2)
    first = eng.generate(rows, max_new_tokens=24)
    held = eng._dstate
    assert eng.generate(rows, max_new_tokens=24) == first
    assert eng._dstate is held and eng.programs["dec_gen"] == 4
    assert eng.graph_stats == {"captures": 1, "replays": 4 * 24, "eager_steps": 0}
    # The eager route of the same engine gives the same completions.
    monkeypatch.setattr(gen, "GRAPH_MIN_STEPS", 10**9)
    eager = _engine(model)
    monkeypatch.setattr(eager, "_gen_row_limit", lambda rows, max_new: 4)
    assert eager.generate(rows, max_new_tokens=24) == first
    assert eager.graph_stats == {"captures": 0, "replays": 0, "eager_steps": 2 * 24}


@pytest.mark.card
def test_new_length_frees_and_captures_again(model):
    eng = _engine(model, "int4")
    rows = _rows(4, seed=3)
    eng.generate(rows, max_new_tokens=16)
    old = weakref.ref(eng._dstate)
    eng.generate(rows, max_new_tokens=20)
    gc.collect()
    assert old() is None and eng._dstate.key[:2] == (4, 64 + 20)
    assert eng.graph_stats == {"captures": 2, "replays": 16 + 20, "eager_steps": 0}


@pytest.mark.card
def test_oom_backoff_frees_the_graph(model, monkeypatch):
    eng = _engine(model)
    rows = _rows(8, seed=4)
    eng.generate(rows, max_new_tokens=16)
    held = weakref.ref(eng._dstate)
    orig, left, seen = eng._generate_dispatch, [1], []

    def dispatch(chunk, *a, **kw):
        if len(chunk) > 4 and left[0]:
            left[0] = 0
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 8 GiB")
        return orig(chunk, *a, **kw)

    empty = torch.cuda.empty_cache

    def record():
        seen.append((eng._dstate, held()))
        empty()

    monkeypatch.setattr(eng, "_generate_dispatch", dispatch)
    monkeypatch.setattr(torch.cuda, "empty_cache", record)
    # The tokens at 4 rows a dispatch may differ in bf16 from those at 8
    # (other GEMM shapes); the CPU test holds them.
    texts, _ = eng.generate(rows, max_new_tokens=16)
    # The backoff's call comes first; the capture at 4 rows empties the
    # cache again, with the new buffers held.
    assert len(texts) == 8 and seen[0] == (None, None) and len(seen) == 2
    assert eng.graph_stats["captures"] == 2 and eng._dstate.key[0] == 4
