"""Port parity of the W4A8 and the decoder's W8A8 kernels' plain versions
against the JAX Pallas kernels, run in interpret mode on the CPU.

- ``pack_int4`` gives the JAX function's packed bytes and group scales bit
  for bit, ``unpack_int4`` its weights, ``choose_group`` its groups.
- ``quantized_matmul_int4_plain`` (G 128, 256, 512; with and without a
  residual; ragged M; N = 384), ``gated_matmul_pair_plain`` (silu) and
  ``int8_matmul_plain`` quantize to the same int8 values and sum them
  exactly, so they agree with the JAX kernels to f32 rounding: max |diff| <=
  1e-5 * max |want| for f32 outputs, and within one bf16 ulp of |want| per
  element for bf16 outputs. The gated pair's silu adds 1e-5 * max |want| per
  element in bf16: JAX's and PyTorch's sigmoid differ by an f32 ulp or so.
- Negative controls: group scales rolled by one group and the zero-point
  term dropped must miss the f32 tolerance.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llmrankers_tpu.ops import int4_matmul as jint4
from llmrankers_tpu.ops import int8_matmul as jint8
from llmrankers_tpu_torch.models import quant as tquant
from llmrankers_tpu_torch.ops import int4_matmul as tint4
from llmrankers_tpu_torch.ops import int8_matmul as tint8

F32_TOL = 1e-5  # relative to max |want|
BF16_ULP = 2.0**-7  # one bf16 ulp, relative to |want|
SILU_ALLOWANCE = 1e-5  # per element, relative to max |want| (bf16 only)


def _activations(rng, M, K):
    # per-row scales that vary across the groups, and one all-zero row
    x = rng.randn(M, K).astype(np.float32) * (0.1 + rng.rand(M, 1) * 4)
    x[:, : K // 3] *= 8.0
    x[3] = 0.0
    return x


def _assert_close(got, want, dtype, allowance=0.0):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    if dtype == torch.float32:
        err = np.abs(got - want).max()
        assert err <= F32_TOL * np.abs(want).max(), err
    else:
        allow = 1e-6 + allowance * np.abs(want).max()
        bad = np.abs(got - want) > BF16_ULP * np.abs(want) + allow
        assert not bad.any(), np.abs(got - want).max()


def _jdt(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K", [100, 128, 192, 256, 768, 1024, 11008, 2048])
def test_choose_group_matches_jax(K):
    assert tint4.choose_group(K) == jint4.choose_group(K)
    assert tint4.GROUP_CANDIDATES == jint4.GROUP_CANDIDATES


@pytest.mark.parametrize("shape", [(256, 128), (768, 384), (1024, 256), (3, 256, 128)])
def test_pack_int4_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    w = (rng.randn(*shape) * rng.rand(*shape[:-2], 1, shape[-1]) * 3).astype(np.float32)
    w[..., 0, 0] = 0.0
    w[..., :, 1] = 0.0  # an all-zero column: amax floored at 1e-8
    jp, js = map(np.asarray, jint4.pack_int4(jnp.asarray(w)))
    tp, ts = tint4.pack_int4(torch.from_numpy(w))
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(ts.numpy(), js)
    back = tint4.unpack_int4(tp, ts)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jint4.unpack_int4(jp, js)))
    # within half an int4 step of w, per (group, column)
    K, N = shape[-2:]
    G = tint4.choose_group(K)
    amax = np.abs(w.reshape(*shape[:-2], K // G, G, N)).max(axis=-2, keepdims=True)
    err = np.abs(back.numpy() - w).reshape(*shape[:-2], K // G, G, N)
    assert (err <= amax / 7.0 * 0.5 + 1e-6).all()


def test_pack_int4_exact_on_grid():
    """Weights on the int4 grid survive pack and unpack exactly, negative
    high and low nibbles included."""
    rng = np.random.RandomState(1)
    q = rng.randint(-7, 8, (128, 128)).astype(np.float32)
    q[0] = 7.0
    p4, s4 = tint4.pack_int4(torch.from_numpy(q))
    assert torch.all(s4 == 1.0)
    assert torch.equal(tint4.unpack_int4(p4, s4), torch.from_numpy(q))


def test_pack_int4_rejects_bad_k():
    with pytest.raises(ValueError, match="divisible"):
        tint4.pack_int4(torch.zeros(100, 128))
    p4, s4 = tint4.pack_int4(torch.randn(256, 128))
    with pytest.raises(ValueError, match="do not fit"):
        tint4.quantized_matmul_int4_plain(torch.randn(4, 384), p4, s4)


# ---------------------------------------------------------------------------
# B7: quantized_matmul_int4
# ---------------------------------------------------------------------------
def _w4_case(G, residual, M=200, N=384, seed=0):
    rng = np.random.RandomState(seed + G)
    K = {512: 1024, 256: 768, 128: 384}[G]
    x = _activations(rng, M, K)
    w = rng.randn(K, N).astype(np.float32) * K**-0.5
    res = rng.randn(M, N).astype(np.float32) if residual else None
    jp, js = jint4.pack_int4(jnp.asarray(w))
    assert jp.shape == (K // 2, N) and js.shape == (K // G, N)
    return x, np.array(jp), np.array(js), res


def _jax_w4(x, p4, sw, res, dtype):
    return np.asarray(jint4.quantized_matmul_int4(
        jnp.asarray(x, _jdt(dtype)), jnp.asarray(p4), jnp.asarray(sw),
        residual=None if res is None else jnp.asarray(res, _jdt(dtype)),
        interpret=True), np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("G", [512, 256, 128])
def test_quantized_matmul_int4_plain_matches_jax(G, residual, dtype):
    x, p4, sw, res = _w4_case(G, residual)
    xt = torch.from_numpy(x).to(dtype)
    rt = None if res is None else torch.from_numpy(res).to(dtype)
    want = _jax_w4(xt.float().numpy(), p4, sw,
                   None if rt is None else rt.float().numpy(), dtype)
    got = tint4.quantized_matmul_int4_plain(xt, torch.from_numpy(p4), torch.from_numpy(sw), rt)
    assert got.dtype == dtype and got.shape == (200, 384)
    _assert_close(got, want, dtype)
    assert torch.equal(got[3].float(), torch.zeros(384) if rt is None else rt[3].float())
    # the K-major view the models hold (B7's layout) gives the same bits
    p4k = tquant.to_kmajor(torch.from_numpy(p4))
    assert p4k.stride() == (1, p4.shape[0])
    got_k = tint4.quantized_matmul_int4_plain(xt, p4k, torch.from_numpy(sw), rt)
    assert torch.equal(got_k, got)


def test_int4_controls_miss_the_tolerance():
    """Group scales rolled by one group, or the zero-point term dropped (the
    plain version plus the ``8 * sum(q_lo)`` term it subtracts), miss the f32
    tolerance."""
    x, p4, sw, _ = _w4_case(256, False, seed=3)
    want = _jax_w4(x, p4, sw, None, torch.float32)
    xt, pt, st = torch.from_numpy(x), torch.from_numpy(p4), torch.from_numpy(sw)
    got = tint4.quantized_matmul_int4_plain(xt, pt, st)
    _assert_close(got, want, torch.float32)
    with pytest.raises(AssertionError):
        _assert_close(tint4.quantized_matmul_int4_plain(xt, pt, st.roll(1, 0)), want,
                      torch.float32)
    q, scale = tint8.quantize_blocks(xt, 256)
    zero_point = ((8 * q[:, :, :128].sum(-1) * scale).double() @ st.double()).float()
    with pytest.raises(AssertionError):
        _assert_close(got + zero_point, want, torch.float32)


def test_quantized_matmul_int4_wrapper_on_cpu():
    """On CPU tensors the wrapper takes the plain version over any leading
    dims and launches nothing; other devices raise."""
    x, p4, sw, res = _w4_case(128, True, M=24, N=128)
    xt = torch.from_numpy(x).reshape(2, 12, -1)
    p4, sw = torch.from_numpy(p4), torch.from_numpy(sw)
    rt = torch.from_numpy(res).reshape(2, 12, -1)
    n = tint4.quantized_matmul_int4.launches
    got = tint4.quantized_matmul_int4(xt, p4, sw, residual=rt)
    want = tint4.quantized_matmul_int4_plain(xt.reshape(24, -1), p4, sw, rt.reshape(24, -1))
    assert torch.equal(got, want.reshape(2, 12, 128))
    assert tint4.quantized_matmul_int4.launches == n
    with pytest.raises(ValueError, match="no kernel"):
        tint4.quantized_matmul_int4(xt.to("meta"), p4.to("meta"), sw.to("meta"))


def _kernel_fold(x, p4k, sw):
    """The W4A8 kernel's arithmetic (``csrc/int4_w4a8.cu``) from the K-major
    packed buffer viewed as 32-bit words: the two masks on words (so the
    shift that carries a nibble into the next byte is pinned), one exact sum
    per group over both planes, ``float(acc) * 0.0625``, the f32 fold."""
    K = x.shape[1]
    Kh, N = p4k.shape
    nk = sw.shape[0]
    G = K // nk
    half = G // 2
    q, scale = tint8.quantize_blocks(x, G)
    words = p4k.t().contiguous().view(torch.int32).long() & 0xFFFFFFFF  # [N, Kh/4]
    planes = []
    for v in (((words << 4) & 0xF0F0F0F0) ^ 0x80808080, words & 0xF0F0F0F0):  # lo16, hi16
        b = torch.stack([(v >> (8 * k)) & 0xFF for k in range(4)], -1).reshape(N, Kh)
        planes.append((b - 256 * (b >= 128)).double())  # signed bytes, in memory order
    lo16, hi16 = planes
    acc_f = None
    for g in range(nk):
        cols = slice(g * half, (g + 1) * half)
        acc = (q[:, g, :half].double() @ lo16[:, cols].t()
               + q[:, g, half:].double() @ hi16[:, cols].t())
        assert acc.abs().max() < 2**24
        assert torch.equal(acc, acc.round())
        d = acc.float() * 0.0625
        term = (d * scale[:, g:g + 1]) * sw[g]
        acc_f = term if acc_f is None else acc_f + term
    return acc_f


@pytest.mark.parametrize("case", ["random", "extreme"])
@pytest.mark.parametrize("G", [512, 256, 128])
def test_kernel_fold_is_the_plain_fold(G, case):
    """The kernel's one-accumulator fold gives the plain version's f32 bits:
    16 D is exact in int32 and below 2^24, so float(acc) * 0.0625 is D, and
    the TPU body's d (two dots less a zero point) is D too. The extreme case
    quantizes every x of row 0 to +127 and every weight of column 0 to +7
    (|acc| = 16 G 127 7, the largest a group can hold), the rest to random
    signs of the same magnitudes."""
    rng = np.random.RandomState(G)
    K, M, N = {512: 1024, 256: 768, 128: 384}[G], 48, 256
    if case == "random":
        x = _activations(rng, M, K)
        w = rng.randn(K, N).astype(np.float32) * K**-0.5
    else:
        x = np.where(rng.rand(M, K) < 0.5, -1.0, 1.0).astype(np.float32)
        w = np.where(rng.rand(K, N) < 0.5, -1.0, 1.0).astype(np.float32)
        x[0], w[:, 0] = 1.0, 1.0
    p4, sw = tint4.pack_int4(torch.from_numpy(w))
    p4k = tquant.to_kmajor(p4)
    xt = torch.from_numpy(x).float()
    if case == "extreme":
        q, _ = tint8.quantize_blocks(xt, G)
        assert q.abs().min() == 127
        assert tint4.unpack_int4(p4, torch.ones_like(sw)).abs().min() == 7
    got = _kernel_fold(xt, p4k, sw)
    want = tint4.quantized_matmul_int4_plain(xt, p4k, sw)
    assert want.dtype == torch.float32 and torch.equal(got, want)
    if case == "extreme":
        d0 = got[0, 0] / (sw[:, 0] * (1 / 127.0)).sum()
        assert abs(d0.item() - G * 127 * 7) < 1e-3 * G * 127 * 7


def test_check_kmajor_refuses_a_row_major_leaf():
    """The B7 wrapper's layout check (``check_kmajor`` over the packed
    ``[K/2, N]`` leaf), on CPU tensors: it takes the K-major packed view and
    refuses a row-major leaf (naming the layout), another shape or dtype, and
    an unaligned base, making no copy."""
    K, N = 512, 384
    p4, _ = tint4.pack_int4(torch.randn(K, N))
    p4k = tquant.to_kmajor(p4)
    tint4.check_kmajor("p4", p4k, K // 2, N)
    with pytest.raises(ValueError, match=r"K-major.*stride \(1, 256\).*row-major"):
        tint4.check_kmajor("p4", p4, K // 2, N)
    with pytest.raises(ValueError, match="int8"):
        tint4.check_kmajor("p4", p4k.float(), K // 2, N)
    with pytest.raises(ValueError, match=r"\[256, 256\]"):
        tint4.check_kmajor("p4", p4k, K // 2, 256)
    buf = torch.zeros(N * K // 2 + 1, dtype=torch.int8)[1:]  # base one byte off
    with pytest.raises(ValueError, match="16-byte"):
        tint4.check_kmajor("p4", buf.view(N, K // 2).t(), K // 2, N)


# ---------------------------------------------------------------------------
# B6: gated_matmul_pair, and B9: int8_matmul
# ---------------------------------------------------------------------------
def _int8_weight(rng, K, N):
    w = rng.randn(K, N).astype(np.float32)
    sw = np.abs(w).max(axis=0, keepdims=True) / 127.0
    return np.clip(np.round(w / sw), -127, 127).astype(np.int8), sw.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_matmul_pair_plain_matches_jax(dtype):
    rng = np.random.RandomState(2)
    M, K, N = 200, 2048, 384
    x = _activations(rng, M, K) * 0.05
    (w0, s0), (w1, s1) = _int8_weight(rng, K, N), _int8_weight(rng, K, N)
    xt = torch.from_numpy(x).to(dtype)
    want = jint8.gated_matmul_pair(jnp.asarray(xt.float().numpy(), _jdt(dtype)),
                                   *map(jnp.asarray, (w0, s0, w1, s1)), act="silu",
                                   interpret=True)
    ts = [torch.from_numpy(a) for a in (w0, s0, w1, s1)]
    got = tint8.gated_matmul_pair_plain(xt, *ts)
    assert got.dtype == dtype and got.shape == (M, N)
    _assert_close(got, want, dtype, SILU_ALLOWANCE if dtype == torch.bfloat16 else 0.0)
    # the pair is the packed gated kernel over [w0 | w1]
    packed = tint8.gated_matmul_plain(xt, torch.cat(ts[::2], 1), torch.cat(ts[1::2], 1), "silu")
    assert torch.equal(got, packed)
    with pytest.raises(AssertionError):  # gate and up swapped
        _assert_close(tint8.gated_matmul_pair_plain(xt, *ts[2:], *ts[:2]), want, dtype,
                      SILU_ALLOWANCE)


@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 11008), (11008, 2048), (2048, 256)])
def test_gated_pair_kblock_is_the_packed_rule(K, N):
    """The pair's K-block (``_gated_pair_2d``'s VMEM rule) is the packed
    gated kernel's with N the width of one weight."""
    xbytes = 2
    bn, bk = jint8._largest_divisor(N, 512), jint8._largest_divisor(K, 2048)

    def vmem(bk_):
        nk_ = K // bk_
        return (2 * (256 * bk_ * xbytes + 2 * bk_ * bn) + 2 * 4 * 256 * bn
                + 2 * 256 * bn * xbytes * 2 + nk_ * 256 * (bk_ + 4) + 256 * bk_ * 4)

    while bk > 1024 and vmem(bk) > 13 * 2**20:
        bk //= 2
    assert tint8.kblock(K, N, torch.bfloat16, gated=True) == bk


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_plain_matches_jax(out_dtype):
    rng = np.random.RandomState(4)
    M, K, N = 200, 1024, 256
    x = _activations(rng, M, K)
    jx8, jsx = jint8.quantize_rows(jnp.asarray(x))
    tx8, tsx = tint8.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tx8.numpy(), np.asarray(jx8))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    w8, sw = _int8_weight(rng, K, N)
    want = jint8.int8_matmul(jx8, jsx, jnp.asarray(w8), jnp.asarray(sw),
                             out_dtype=_jdt(out_dtype), interpret=True)
    got = tint8.int8_matmul(tx8, tsx, torch.from_numpy(w8), torch.from_numpy(sw), out_dtype)
    assert got.dtype == out_dtype and got.shape == (M, N)
    _assert_close(got, want, out_dtype)
    with pytest.raises(AssertionError):  # sx rolled by one row
        _assert_close(tint8.int8_matmul_plain(tx8, tsx.roll(1, 0), torch.from_numpy(w8),
                                              torch.from_numpy(sw), out_dtype), want, out_dtype)


@pytest.mark.parametrize("K", [1024, 4352])
def test_int8_matmul_plain_gives_the_same_bits_on_a_kmajor_weight(K):
    """B9's weight is K-major on the card (an [N, K] buffer seen as [K, N]);
    the plain version reads that view as it lies and gives the bits it gives
    on the row-major weight, and those of the JAX kernel in f32. At K 4352
    the JAX kernel sums in int32 over 17 K-blocks of 256 (its ``bk_cap`` of
    2048 divides no larger 128-multiple of 4352) and the port's one sum over
    all of K must still equal it bit for bit."""
    rng = np.random.RandomState(7)
    M, N = 64, 256
    x = _activations(rng, M, K)
    x8, sx = tint8.quantize_rows(torch.from_numpy(x))
    w8, sw = map(torch.from_numpy, _int8_weight(rng, K, N))
    wk = tquant.to_kmajor(w8)
    assert wk.stride() == (1, K) and torch.equal(wk, w8)
    if K > 2048:
        assert K // jint8._largest_divisor(K, 2048) > 1
    want = np.asarray(jint8.int8_matmul(*(jnp.asarray(t.numpy()) for t in (x8, sx, w8, sw)),
                                        out_dtype=jnp.float32, interpret=True))
    got = tint8.int8_matmul_plain(x8, sx, wk, sw, torch.float32)
    assert torch.equal(got, tint8.int8_matmul_plain(x8, sx, w8, sw, torch.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tint8.int8_matmul(x8, sx, wk, sw),
                       tint8.int8_matmul_plain(x8, sx, w8, sw))


def test_int8_matmul_refuses_a_row_major_weight(monkeypatch):
    """Past the device check (meta tensors stand in for the card's), B9's
    wrapper takes its weight K-major, as B3's kernel loads it by TMA, and
    refuses a row-major one, naming the layout, before anything is built or
    launched."""
    M, K, N = 16, 256, 128

    def build():
        raise RuntimeError("build")

    monkeypatch.setattr(tint8, "_check_cuda", lambda fn, x: None)
    monkeypatch.setattr(tint8, "_lib", build)
    x8 = torch.empty(M, K, dtype=torch.int8, device="meta")
    sx = torch.empty(M, 1, dtype=torch.float32, device="meta")
    sw = torch.empty(1, N, dtype=torch.float32, device="meta")
    w8 = torch.empty(K, N, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match=r"K-major.*row-major"):
        tint8.int8_matmul(x8, sx, w8, sw)
    with pytest.raises(RuntimeError, match="build"):
        tint8.int8_matmul(x8, sx, w8.t().contiguous().t(), sw)


def test_pair_and_int8_matmul_wrappers_on_cpu():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(_activations(rng, 24, 256)).reshape(2, 12, 256)
    (w0, s0), (w1, s1) = (map(torch.from_numpy, _int8_weight(rng, 256, 128)) for _ in "ab")
    n_p, n_i = tint8.gated_matmul_pair.launches, tint8.int8_matmul.launches
    got = tint8.gated_matmul_pair(x, w0, s0, w1, s1)
    assert got.shape == (2, 12, 128)
    assert torch.equal(got, tint8.gated_matmul_pair_plain(x.reshape(24, 256), w0, s0, w1,
                                                          s1).reshape(2, 12, 128))
    x8, sx = tint8.quantize_rows(x.reshape(24, 256))
    assert tint8.int8_matmul(x8, sx, w0, s0).dtype == torch.bfloat16
    assert (tint8.gated_matmul_pair.launches, tint8.int8_matmul.launches) == (n_p, n_i)
    with pytest.raises(ValueError, match="activation"):
        tint8.gated_matmul_pair(x, w0, s0, w1, s1, act="swish")
    with pytest.raises(ValueError, match="no kernel"):
        tint8.gated_matmul_pair(*(t.to("meta") for t in (x, w0, s0, w1, s1)))
    with pytest.raises(ValueError, match="no kernel"):
        tint8.int8_matmul(*(t.to("meta") for t in (x8, sx, w0, s0)))
