"""Port parity of the quantized KV cache and of kernel B8's plain version.

- ``_kv_quant`` and ``_kv_quant4`` (the port's ``engine/generate.py``) give
  the JAX functions' int8 payloads and f32 scales bit for bit, on f32 and
  bf16 inputs, rows with exact round-half values and all-zero rows included;
  ``unpack4`` gives JAX's ``_unpack4`` planes.
- ``cached_qk``/``cached_pv`` (``ops/kvq_attention.py``) against the JAX
  ``_cached_qk``/``_cached_pv`` in every cache mode, and B8's plain version
  ``kvq_decode_attention_plain`` against the JAX decode block (the XLA path
  of ``_decode_token_forward``) and against the Pallas kernel
  ``kvq_decode_attention(..., interpret=True)``, within 1e-5 * max |want| in
  f32, at T a multiple of the Pallas tile and not, with ragged masks, a
  row that sees no cache key and a row with only its self term.
- The gate holds the controls ``chip_smoke.py`` runs on the card out: scales
  rolled by one position, nibble planes swapped, the self term dropped.
- The wrapper runs the plain version on CPU tensors and launches nothing;
  other devices raise; the CUDA source has its C entry and the ctypes
  argument list matches it.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llmrankers_tpu.engine import generate as jgen
from llmrankers_tpu.ops.kvq_attention import kvq_decode_attention as jax_kvq
from llmrankers_tpu_torch.engine import generate as tgen
from llmrankers_tpu_torch.ops import _build
from llmrankers_tpu_torch.ops import kvq_attention as tkvq

MODES = [None, "int8", "int4"]
REL_TOL = 1e-5  # of max |want|, f32: summation order only


def _x(seed, shape, dtype=np.float32, scale=3.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * scale).astype(np.float32)
    # Rows whose values sit on round-half boundaries of the quantizer, and an
    # all-zero row (amax floored at 1e-8).
    x[0, 0, 0, :] = np.linspace(-1.0, 1.0, shape[-1]) * 127.0
    x[0, 0, 1, :] = 0.0
    x[0, 0, 2, : shape[-1] // 2] = np.linspace(-3.5, 3.5, shape[-1] // 2)
    return x


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_bit_identical_to_jax(mode, dtype):
    x = _x(0, (2, 3, 9, 64))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = jgen._kv_pack(jx, mode)
    got_q, got_s = tgen._kv_pack(tx, mode)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_unpack4_matches_jax():
    q, _ = jgen._kv_quant4(jnp.asarray(_x(1, (2, 2, 5, 32))))
    lo_j, hi_j = jgen._unpack4(q, jnp.float32)
    lo_t, hi_t = tkvq.unpack4(torch.from_numpy(np.array(q)), torch.float32)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    assert set(np.unique(lo_t.numpy())) <= set(range(-7, 8))


def _operands(seed, B=3, KV=2, G=4, Dh=64, T=96, mode="int8"):
    """(JAX, torch) operands of one decode step: the cache quantized by the
    JAX functions, a ragged mask with a row that sees no cache key."""
    rng = np.random.RandomState(seed)
    qg = rng.randn(B, KV, G, Dh).astype(np.float32)
    k = (rng.randn(B, KV, T, Dh) * 2.0).astype(np.float32)
    v = (rng.randn(B, KV, T, Dh) * 2.0).astype(np.float32)
    kn = rng.randn(B, KV, Dh).astype(np.float32)
    vn = rng.randn(B, KV, Dh).astype(np.float32)
    if mode:
        kc = tuple(np.array(a) for a in jgen._kv_pack(jnp.asarray(k), mode))
        vc = tuple(np.array(a) for a in jgen._kv_pack(jnp.asarray(v), mode))
    else:
        kc, vc = k, v
    amask = np.zeros((B, T), bool)
    for b in range(B - 1):
        amask[b, 5 * b: T - 10 * b - 1] = True  # left and right holes
    # The last row sees no cache key: its output is its own v.
    j = tuple(jnp.asarray(a) for a in (qg, kn, vn, amask))
    t = tuple(torch.from_numpy(a) for a in (qg, kn, vn, amask))
    conv = (lambda c, f: tuple(f(a) for a in c) if isinstance(c, tuple) else f(c))
    jc = (conv(kc, jnp.asarray), conv(vc, jnp.asarray))
    tc = (conv(kc, torch.from_numpy), conv(vc, torch.from_numpy))
    return j, jc, t, tc


def _jax_block(qg, kc, vc, kn, vn, amask, scale, mode):
    """The JAX decode block (generate.py:613-640), as tests/test_kvq_attention.py
    writes it."""
    s = jgen._cached_qk(qg, kc, qg.dtype, mode, "bkgd,bktd->bkgt") * scale
    s = jnp.where(amask[:, None, None, :], s, jgen.NEG_INF)
    s_self = jnp.einsum("bkgd,bkd->bkg", qg, kn, preferred_element_type=jnp.float32) * scale
    m = jnp.maximum(jnp.max(s, axis=-1), s_self)
    p = jnp.exp(s - m[..., None])
    p_self = jnp.exp(s_self - m)
    z = p.sum(axis=-1) + p_self
    return (jgen._cached_pv(p, vc, qg.dtype, mode, "bkgt,bktd->bkgd")
            + p_self[..., None] * vn.astype(jnp.float32)[:, :, None, :]) / z[..., None]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
def test_cached_dots_match_jax(mode):
    (qg, _, _, _), (kc, vc), (tq, _, _, _), (tkc, tvc) = _operands(2, mode=mode)
    s_j = jgen._cached_qk(qg, kc, jnp.float32, mode, "bkgd,bktd->bkgt")
    s_t = tkvq.cached_qk(tq, tkc, torch.float32, mode, "bkgd,bktd->bkgt")
    _close(s_t.numpy(), s_j)
    p = np.random.RandomState(3).rand(*s_j.shape).astype(np.float32)
    a_j = jgen._cached_pv(jnp.asarray(p), vc, jnp.float32, mode, "bkgt,bktd->bkgd")
    a_t = tkvq.cached_pv(torch.from_numpy(p), tvc, torch.float32, mode, "bkgt,bktd->bkgd")
    _close(a_t.numpy(), a_j)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("T", [96, 512, 640])
def test_plain_matches_jax_block_and_pallas_interpret(mode, T):
    """T 96 is below the Pallas tile, 512 one tile, 640 not a multiple of
    256 or 512 (the Pallas wrapper pads it)."""
    j, jc, t, tc = _operands(4, T=T, mode=mode)
    (qg, kn, vn, amask), (tq, tkn, tvn, tmask) = j, t
    scale = qg.shape[-1] ** -0.5
    got = tkvq.kvq_decode_attention_plain(tq, *tc, tkn, tvn, tmask, scale, mode).numpy()
    _close(got, _jax_block(qg, *jc, kn, vn, amask, scale, mode))
    _close(got, jax_kvq(qg, *jc, kn, vn, amask, scale, mode, interpret=True))
    np.testing.assert_allclose(got[-1], np.repeat(np.asarray(vn)[-1][:, None], 4, 1),
                               rtol=1e-6, atol=1e-6)  # only the self term


def test_plain_bf16_cache_matches_jax_block():
    """A cache in the model's dtype (mode None) takes the same plain block."""
    j, jc, t, tc = _operands(5, mode=None)
    (qg, kn, vn, amask), (tq, tkn, tvn, tmask) = j, t
    got = tkvq.kvq_decode_attention_plain(tq, *tc, tkn, tvn, tmask, 0.125, None)
    _close(got.numpy(), _jax_block(qg, *jc, kn, vn, amask, 0.125, None))


def test_controls_miss_the_gate():
    """What chip_smoke.py holds the kernel to separates the wrong answers it
    names: scales rolled by one position, nibble planes swapped, self term
    dropped (each differs by far more than the plain-vs-plain error)."""
    _, _, t, tc = _operands(6, T=200, mode="int4")
    tq, tkn, tvn, tmask = t
    tq = tq * 3.0  # peaked attention, as a trained model's
    args = (tkn, tvn, tmask, 0.125, "int4")
    want = tkvq.kvq_decode_attention_plain(tq, *tc, *args)
    roll = [(c[0], c[1].roll(1, dims=2)) for c in tc]
    swap = [(((c[0].int() & 0x0F) << 4 | (c[0].int() >> 4) & 0x0F).to(torch.int8), c[1])
            for c in tc]
    no_self = tkvq.kvq_decode_attention_plain(
        tq, *tc, tkn, tvn, tmask & False, 0.125, "int4")  # only the self term
    for bad in (tkvq.kvq_decode_attention_plain(tq, *roll, *args),
                tkvq.kvq_decode_attention_plain(tq, *swap, *args), no_self):
        assert (bad - want).abs().max().item() > 0.05


def test_wrapper_on_cpu_and_other_devices():
    _, _, t, tc = _operands(7, mode="int8")
    tq, tkn, tvn, tmask = t
    n = tkvq.kvq_decode_attention.launches
    got = tkvq.kvq_decode_attention(tq, *tc, tkn, tvn, tmask, 0.125, "int8")
    want = tkvq.kvq_decode_attention_plain(tq, *tc, tkn, tvn, tmask, 0.125, "int8")
    assert torch.equal(got, want) and tkvq.kvq_decode_attention.launches == n
    meta = [x.to("meta") for x in (tq, tkn, tvn, tmask)]
    mc = [(c[0].to("meta"), c[1].to("meta")) for c in tc]
    with pytest.raises(ValueError, match="no kernel for device"):
        tkvq.kvq_decode_attention(meta[0], *mc, *meta[1:], 0.125, "int8")
    with pytest.raises(ValueError, match="unknown mode"):
        tkvq.kvq_decode_attention(tq, *tc, tkn, tvn, tmask, 0.125, None)


def test_kvq_source_has_its_entry_point():
    """B8 is a hand-written CUDA source with one C entry (the split pass and
    the combine pass); the wrapper's ctypes argument list matches it."""
    with open(os.path.join(_build.CSRC_DIR, "kvq_decode.cu")) as f:
        src = f.read()
    sig = src.split('extern "C" int kvq_decode_bf16(')[1].split(")")[0]
    params = [" ".join(p.split()) for p in sig.split(",")]
    kinds = ["ptr" if "*" in p or p.startswith("cudaStream_t") else p.split()[0]
             for p in params]
    assert kinds == ["ptr"] * 10 + ["int"] * 6 + ["float", "ptr"]
    assert "kvq_split_kernel" in src and "kvq_combine_kernel" in src
    assert f"constexpr int TCHUNK = {tkvq.T_CHUNK};" in src  # the workspace's size
    for lib in ("cublas", "cudnn", "scaled_dot_product"):
        assert lib not in src.lower()
