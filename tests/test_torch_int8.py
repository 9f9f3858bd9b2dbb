"""Port parity: the W8A8 kernels' plain versions and the packed flash
attention against the JAX Pallas kernels, run in interpret mode on the CPU.

``quantized_matmul_plain`` and ``gated_matmul_plain`` must quantize to the
same int8 values and sum them exactly, so they agree with the JAX kernels to
f32 rounding: max |diff| <= 1e-5 * max |want| for f32 outputs, and within one
bf16 ulp of |want| per element for bf16 outputs (the two may round one f32
ulp apart before the cast). The gated kernel's gelu_new adds a tanh
allowance of 1e-5 * max |want| per element in bf16: JAX's and PyTorch's tanh
differ by an f32 ulp or so, and where tanh is near -1 the gelu cancels, so the
bf16 result flips by a whole ulp at values far below max |want|. One
whole-row activation scale instead of one per K-block must miss the f32
tolerance. ``flash_mha_packed_plain`` must match
the JAX packed kernel within 2e-5 in f32, the bar ``tests/test_flash.py``
sets between the JAX flash variants.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llmrankers_tpu.ops import flash as jflash
from llmrankers_tpu.ops import int8_matmul as jint8
from llmrankers_tpu_torch.ops import flash as tflash
from llmrankers_tpu_torch.ops import int8_matmul as tint8

F32_TOL = 1e-5  # relative to max |want|
BF16_ULP = 2.0**-7  # one bf16 ulp, relative to |want|
FLASH_TOL = 2e-5


def _int8_weight(rng, K, N):
    w = rng.randn(K, N).astype(np.float32)
    sw = np.abs(w).max(axis=0, keepdims=True) / 127.0
    return np.clip(np.round(w / sw), -127, 127).astype(np.int8), sw.astype(np.float32)


def _activations(rng, M, K):
    # per-row scales that vary across the K-blocks, and one all-zero row
    x = rng.randn(M, K).astype(np.float32) * (0.1 + rng.rand(M, 1) * 4)
    x[:, : K // 3] *= 8.0
    x[3] = 0.0
    return x


def _torch_x(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _assert_close(got, want, dtype, tanh_allowance=0.0):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    if dtype == torch.float32:
        err = np.abs(got - want).max()
        assert err <= F32_TOL * np.abs(want).max(), err
    else:
        allow = 1e-6 + tanh_allowance * np.abs(want).max()
        bad = np.abs(got - want) > BF16_ULP * np.abs(want) + allow
        assert not bad.any(), np.abs(got - want).max()


@pytest.mark.parametrize("K,N,x_dtype,residual,gated,want", [
    (2048, 6144, torch.bfloat16, False, False, 1024),  # xl qkv
    (2048, 2048, torch.bfloat16, False, False, 1024),  # xl o
    (2048, 4096, torch.bfloat16, False, False, 1024),  # xl ckv
    (5120, 2048, torch.bfloat16, False, False, 1280),  # xl wo
    (5120, 2048, torch.bfloat16, True, False, 640),    # xl wo + residual
    (5120, 2048, torch.float32, False, False, 640),    # xl wo, f32 x
    (2048, 5120, torch.bfloat16, False, True, 2048),   # xl wi_g (N per half)
    (1024, 3072, torch.bfloat16, False, False, 1024),  # large qkv
    (1024, 1024, torch.bfloat16, False, False, 1024),  # large o
    (1024, 2048, torch.bfloat16, False, False, 1024),  # large ckv
    (2816, 1024, torch.bfloat16, False, False, 1408),  # large wo
    (1024, 2816, torch.bfloat16, False, True, 1024),   # large wi_g
    (128, 384, torch.float32, False, False, 128),      # 128-wide test qkv
    (128, 128, torch.float32, False, False, 128),      # test o
    (128, 256, torch.float32, False, False, 128),      # test ckv
    (256, 128, torch.float32, False, False, 256),      # test wo
    (128, 256, torch.float32, False, True, 128),       # test wi_g
])
def test_kblock_rule(K, N, x_dtype, residual, gated, want):
    assert tint8.kblock(K, N, x_dtype, residual, gated) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_quantized_matmul_plain_matches_jax(dtype, residual):
    rng = np.random.RandomState(0)
    M, K, N = 200, 5120, 256  # ragged M; nk = 4 (bf16), 8 (f32 + residual)
    x = _activations(rng, M, K)
    w8, sw = _int8_weight(rng, K, N)
    res = rng.randn(M, N).astype(np.float32) if residual else None
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xt = _torch_x(x, dtype)
    rt = None if res is None else _torch_x(res, dtype)
    want = jint8.quantized_matmul(
        jnp.asarray(xt.float().numpy(), jdt), jnp.asarray(w8), jnp.asarray(sw),
        residual=None if rt is None else jnp.asarray(rt.float().numpy(), jdt),
        interpret=True)
    got = tint8.quantized_matmul_plain(xt, torch.from_numpy(w8), torch.from_numpy(sw), rt)
    assert got.dtype == dtype and got.shape == (M, N)
    assert tint8.kblock(K, N, dtype, residual) < K
    _assert_close(got, want, dtype)
    assert (got[3].float() == (0 if rt is None else rt[3].float())).all()  # zero row


def test_whole_row_scale_misses_the_tolerance():
    """Negative control: one activation scale per row instead of one per
    K-block changes the int8 values, and the f32 tolerance catches it."""
    rng = np.random.RandomState(1)
    M, K, N = 64, 5120, 256
    x = _activations(rng, M, K)
    w8, sw = _int8_weight(rng, K, N)
    want = np.asarray(jint8.quantized_matmul(
        jnp.asarray(x), jnp.asarray(w8), jnp.asarray(sw), interpret=True))
    args = (torch.from_numpy(x), torch.from_numpy(w8), torch.from_numpy(sw))
    _assert_close(tint8.quantized_matmul_plain(*args), want, torch.float32)
    with pytest.raises(AssertionError):
        _assert_close(tint8.quantized_matmul_plain(*args, kblock=K), want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu_new", "relu"])
def test_gated_matmul_plain_matches_jax(dtype, act):
    rng = np.random.RandomState(2)
    M, K, N = 200, 2048, 256
    x = _activations(rng, M, K) * 0.05
    wp, sp = _int8_weight(rng, K, 2 * N)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xt = _torch_x(x, dtype)
    want = jint8.gated_matmul(jnp.asarray(xt.float().numpy(), jdt), jnp.asarray(wp),
                              jnp.asarray(sp), act=act, interpret=True)
    got = tint8.gated_matmul_plain(xt, torch.from_numpy(wp), torch.from_numpy(sp), act)
    assert got.dtype == dtype and got.shape == (M, N)
    _assert_close(got, want, dtype, tanh_allowance=1e-5 if act == "gelu_new" else 0.0)


def test_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors the wrappers take the plain versions over any leading
    dims and launch nothing."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(_activations(rng, 24, 256)).reshape(2, 12, 256)
    w8, sw = map(torch.from_numpy, _int8_weight(rng, 256, 384))
    res = torch.randn(2, 12, 384, generator=torch.Generator().manual_seed(0))
    n_q, n_g = tint8.quantized_matmul.launches, tint8.gated_matmul.launches
    got = tint8.quantized_matmul(x, w8, sw, residual=res)
    want = tint8.quantized_matmul_plain(x.reshape(24, 256), w8, sw, res.reshape(24, 384))
    assert torch.equal(got, want.reshape(2, 12, 384))
    g = tint8.gated_matmul(x, w8[:, :256], sw[:, :256], act="relu")
    assert g.shape == (2, 12, 128)
    assert (tint8.quantized_matmul.launches, tint8.gated_matmul.launches) == (n_q, n_g)
    with pytest.raises(ValueError, match="activation"):
        tint8.gated_matmul(x, w8[:, :256], sw[:, :256], act="swish")
    with pytest.raises(ValueError, match="no kernel"):
        tint8.quantized_matmul(x.to("meta"), w8.to("meta"), sw.to("meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_plain_gives_the_same_bits_on_a_kmajor_weight(dtype, residual):
    """B3's weights are stored K-major (an [N, K] buffer seen as [K, N]); the
    plain version reads the view as it is and gives the bits it gives on a
    contiguous copy."""
    rng = np.random.RandomState(4)
    M, K, N = 96, 2048, 384
    x = _torch_x(_activations(rng, M, K), dtype)
    w8, sw = map(torch.from_numpy, _int8_weight(rng, K, N))
    res = _torch_x(rng.randn(M, N).astype(np.float32), dtype) if residual else None
    wk = w8.t().contiguous().t()
    assert wk.stride() == (1, K) and torch.equal(wk, w8)
    got = tint8.quantized_matmul_plain(x, wk, sw, res)
    want = tint8.quantized_matmul_plain(x, w8, sw, res)
    assert got.dtype == dtype and torch.equal(got, want)


def test_layout_check_rejects_a_row_major_weight():
    """The B3 wrapper's layout check, on CPU tensors: it takes the K-major
    view and refuses a row-major weight (naming the layout), another shape or
    dtype, and an unaligned base, making no copy."""
    K, N = 256, 384
    w8 = torch.randint(-127, 128, (K, N), dtype=torch.int8)
    wk = w8.t().contiguous().t()
    tint8.check_kmajor("w8", wk, K, N)
    with pytest.raises(ValueError, match=r"K-major.*stride \(1, 256\).*row-major"):
        tint8.check_kmajor("w8", w8, K, N)
    with pytest.raises(ValueError, match="int8"):
        tint8.check_kmajor("w8", wk.float(), K, N)
    with pytest.raises(ValueError, match=r"\[256, 256\]"):
        tint8.check_kmajor("w8", wk, K, 256)
    buf = torch.zeros(N * K + 1, dtype=torch.int8)[1:]  # base one byte off
    with pytest.raises(ValueError, match="16-byte"):
        tint8.check_kmajor("w8", buf.view(N, K).t(), K, N)


# ---------------------------------------------------------------------------
# flash_mha_packed
# ---------------------------------------------------------------------------
@pytest.fixture
def _interpret_packed(monkeypatch):
    orig = jflash.pl.pallas_call
    monkeypatch.setattr(jflash.pl, "pallas_call", functools.partial(orig, interpret=True))
    monkeypatch.setattr(jflash, "flash_mha_packed", jflash.flash_mha_packed.__wrapped__)


@pytest.mark.parametrize("case", ["bias_padding", "unaligned", "causal"])
def test_flash_mha_packed_plain_matches_jax(case, _interpret_packed):
    B, H, Dh = 3, 4, 64
    L = 200 if case == "unaligned" else 256
    HD = H * Dh
    rng = np.random.RandomState(7)
    qkv = rng.randn(B, L, 3 * HD).astype(np.float32) * 0.3
    mask = np.ones((B, L), np.int32)
    mask[0, 150:] = 0  # right padding
    mask[2] = 0  # a batch-padding row
    bias = rng.randn(1, H, L, L).astype(np.float32)
    causal = case == "causal"
    kw = dict(kv_mask=mask, causal=causal, bias=bias, scale=1.0)
    want = np.asarray(jflash.flash_mha_packed(
        jnp.asarray(qkv), H, **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                               for k, v in kw.items()}))
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = tflash.flash_mha_packed(torch.from_numpy(qkv), H, **tkw)
    assert got.shape == (B, L, HD)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLASH_TOL)
    assert got[2].count_nonzero() == 0  # the all-padding row is exactly 0
    plain = tflash.flash_mha_packed_plain(torch.from_numpy(qkv), H, **tkw)
    assert torch.equal(got, plain)


def test_flash_mha_packed_reads_qkv_blocks():
    """The packed form equals blhd attention on the q, k, v column blocks."""
    rng = np.random.RandomState(8)
    qkv = torch.from_numpy(rng.randn(2, 33, 3 * 64).astype(np.float32))
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    assert torch.equal(tflash.flash_mha_packed(qkv, 4),
                       tflash.flash_mha_blhd_plain(q, k, v, 4))
    with pytest.raises(ValueError, match="3\\*H\\*Dh"):
        tflash.flash_mha_packed(qkv[..., :100], 4)
