"""Port parity: attention ops of ``llmrankers_tpu_torch.ops`` against JAX.

The same numpy inputs go through the JAX op and the port's op in fp32. The
port's flash wrappers take their plain versions on CPU tensors and are held
to the JAX Pallas kernels ``flash_mha_blhd`` and ``flash_mha`` run in
interpret mode (as ``tests/test_flash.py`` runs them), on every row including
all-padding rows, which both must return as zeros. The port's plain
``mha_flat`` and ``mha`` (GQA, windows and dense masks included) are held to
the JAX XLA versions. Tolerance: 1e-5 absolute in fp32 (the two frameworks
sum in other orders; the values are O(1)).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llmrankers_tpu.ops import attention as jattn
from llmrankers_tpu.ops import flash as jflash
from llmrankers_tpu_torch.ops import attention as tattn
from llmrankers_tpu_torch.ops import flash as tflash

ATOL = 1e-5


@pytest.fixture
def _interpret_blhd(monkeypatch):
    orig = jflash.pl.pallas_call
    monkeypatch.setattr(jflash.pl, "pallas_call", functools.partial(orig, interpret=True))
    monkeypatch.setattr(jflash, "flash_mha_blhd", jflash.flash_mha_blhd.__wrapped__)


@pytest.fixture
def _interpret_bhld(monkeypatch):
    orig = jflash.pl.pallas_call
    monkeypatch.setattr(jflash.pl, "pallas_call", functools.partial(orig, interpret=True))
    monkeypatch.setattr(jflash, "flash_mha", jflash.flash_mha.__wrapped__)


def _inputs(case, seed=0):
    """q/k/v [B, L, H*Dh] and keyword args for one mask/bias/causal case."""
    rng = np.random.RandomState(seed)
    B, H, Dh = 3, 4, 64
    Lq = Lk = 96
    if case == "causal_lq_ne_lk":
        Lq, Lk = 80, 144
    # q carries the 1/sqrt(Dh) that T5 folds into its init, so scores are O(1)
    q = (rng.randn(B, Lq, H * Dh) * Dh**-0.5).astype(np.float32)
    k = rng.randn(B, Lk, H * Dh).astype(np.float32)
    v = rng.randn(B, Lk, H * Dh).astype(np.float32)
    kw = {}
    if case in ("kvmask", "padrow", "bias_kvmask", "causal_lq_ne_lk"):
        m = np.ones((B, Lk), np.int32)
        m[0, -17:] = 0
        m[1, -3:] = 0
        if case == "padrow":
            m[2] = 0  # a batch-padding row: every key masked
        kw["kv_mask"] = m
    if case in ("bias", "bias_kvmask", "padrow", "causal_lq_ne_lk"):
        kw["bias"] = rng.randn(1, H, Lq, Lk).astype(np.float32)
    if case == "causal_lq_ne_lk":
        kw["causal"] = True
    return q, k, v, H, kw


def _jax_kw(kw):
    return {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}


def _torch_kw(kw):
    return {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
            for n, x in kw.items()}


CASES = ["plain", "bias", "kvmask", "bias_kvmask", "padrow", "causal_lq_ne_lk"]


@pytest.mark.parametrize("case", CASES)
def test_flash_plain_matches_pallas_interpret(case, _interpret_blhd):
    q, k, v, H, kw = _inputs(case)
    want = np.asarray(jflash.flash_mha_blhd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, scale=1.0, **_jax_kw(kw)))
    before = tflash.flash_mha_blhd.launches
    got = tflash.flash_mha_blhd(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), H, scale=1.0, **_torch_kw(kw))
    assert tflash.flash_mha_blhd.launches == before  # CPU: plain path, no launch
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if case == "padrow":
        assert not got[2].any() and not want[2].any()


@pytest.mark.parametrize("case", CASES)
def test_mha_flat_matches_xla(case):
    q, k, v, H, kw = _inputs(case, seed=1)
    want = np.asarray(jattn.mha_flat(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, scale=1.0,
        use_flash=False, **_jax_kw(kw)))
    got = tattn.mha_flat(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), H, scale=1.0, **_torch_kw(kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_flash_plain_matches_xla_on_valid_rows(case):
    """The flash semantics differ from XLA's only on rows with no valid key
    (zeros instead of the mean of v)."""
    q, k, v, H, kw = _inputs(case, seed=2)
    want = np.asarray(jattn.mha_flat(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, scale=1.0,
        use_flash=False, **_jax_kw(kw)))
    got = tflash.flash_mha_blhd(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), H, scale=1.0,
                                **_torch_kw(kw)).numpy()
    valid = [b for b in range(q.shape[0])
             if "kv_mask" not in kw or kw["kv_mask"][b].any()]
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=ATOL)


def test_flash_wrapper_rejects_other_devices():
    q = torch.zeros(1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tflash.flash_mha_blhd(q, q, q, 1)


def test_flash_rejects_batched_bias():
    q = torch.zeros(2, 4, 64)
    with pytest.raises(ValueError, match="batch-invariant"):
        tflash.flash_mha_blhd(q, q, q, 1, bias=torch.zeros(2, 1, 4, 4))


def test_mha_default_scale_matches_xla():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 3, 17, 16).astype(np.float32) for _ in range(3))
    want = np.asarray(jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tattn.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_rms_norm_and_gelu_new_match_jax():
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 7, 64) * 3).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(
        tattn.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(jattn.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tattn.gelu_new(torch.from_numpy(x)).numpy(),
        np.asarray(jattn.gelu_new(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


# -- flash_mha (B5): [B, H, L, Dh], GQA, causal at Lk - Lq, window ---------
BHLD_CASES = {
    # name: (H, KV, Lq, Lk, layout, causal, window, bias)
    "g1_bidir_right_pad": (4, 4, 96, 96, "right", False, None, True),
    "g2_causal_left_pad": (4, 2, 96, 96, "left", True, None, False),
    "g8_causal_left_pad": (8, 1, 80, 80, "left", True, None, False),
    "g2_shared_prefix_holes": (4, 2, 48, 64 + 48, "holes", True, None, False),
    "g8_shared_prefix_holes_bias": (8, 1, 40, 72 + 40, "holes", True, None, True),
    "g2_window_left_pad": (4, 2, 160, 160, "left", True, 64, False),
    "g1_causal_lk_gt_lq": (2, 2, 50, 130, "none", True, None, True),
}


def _bhld_inputs(H, KV, Lq, Lk, layout, bias, seed=0):
    """q [B, H, Lq, Dh], k/v [B, KV, Lk, Dh] and a key mask: left padding
    (a decoder prompt), right padding, or a right-padded prefix then a
    right-padded suffix (the shared path's holes). The last row is all
    padding, so every one of its queries sees no key."""
    rng = np.random.RandomState(seed)
    B, Dh = 3, 32
    q = rng.randn(B, H, Lq, Dh).astype(np.float32)
    k = rng.randn(B, KV, Lk, Dh).astype(np.float32)
    v = rng.randn(B, KV, Lk, Dh).astype(np.float32)
    m = np.ones((B, Lk), np.int32)
    if layout == "left":
        m[0, :11] = 0
        m[1, :Lk - 5] = 0
    elif layout == "right":
        m[0, -17:] = 0
        m[1, 3:] = 0
    elif layout == "holes":
        Lp = Lk - Lq
        m[0, Lp - 20:Lp] = 0  # prefix padding, a hole before the suffix
        m[0, -7:] = 0
        m[1, 5:Lp] = 0
        m[1, Lp + 9:] = 0
    m[2] = 0
    kw = {"kv_mask": m}
    if bias:
        kw["bias"] = rng.randn(1, H, Lq, Lk).astype(np.float32)
    return q, k, v, kw


@pytest.mark.parametrize("case", list(BHLD_CASES))
def test_flash_mha_plain_matches_pallas_interpret(case, _interpret_bhld):
    H, KV, Lq, Lk, layout, causal, window, bias = BHLD_CASES[case]
    q, k, v, kw = _bhld_inputs(H, KV, Lq, Lk, layout, bias)
    scale = q.shape[-1] ** -0.5
    want = np.asarray(jflash.flash_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, window=window, **_jax_kw(kw)))
    before = tflash.flash_mha.launches
    got = tflash.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal, scale=scale,
                           window=window, **_torch_kw(kw))
    assert tflash.flash_mha.launches == before  # CPU: plain path, no launch
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert not got[2].any() and not want[2].any()  # the all-padding row


def test_flash_mha_gqa_reads_head_h_over_g():
    """Control: with G = 2 the plain version must read K/V head h // G; the
    h % KV mapping gives another result (a G = 1 test could not tell)."""
    q, k, v, kw = _bhld_inputs(4, 2, 32, 32, "none", False)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tflash.flash_mha_plain(tq, tk, tv, causal=True)
    want = tflash.flash_mha_plain(tq, tk.repeat_interleave(2, 1),
                                  tv.repeat_interleave(2, 1), causal=True)
    wrong = tflash.flash_mha_plain(tq, tk.repeat(1, 2, 1, 1), tv.repeat(1, 2, 1, 1),
                                   causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=0)
    assert (got - wrong).abs().max() > 0.1


@pytest.mark.parametrize("case", list(BHLD_CASES))
def test_mha_matches_xla(case):
    """The port's plain mha (GQA repeat, where-masking, window) against the
    JAX XLA path, and its flash dispatch on the rows with a valid key."""
    H, KV, Lq, Lk, layout, causal, window, bias = BHLD_CASES[case]
    q, k, v, kw = _bhld_inputs(H, KV, Lq, Lk, layout, bias, seed=1)
    want = np.asarray(jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window, **_jax_kw(kw)))
    tkw = dict(causal=causal, window=window, **_torch_kw(kw))
    got = tattn.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **tkw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    flashed = tattn.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        use_flash=True, **tkw)
    # Flash differs only on query rows that see no valid key (zeros
    # instead of the mean of v).
    rel = np.arange(Lq)[:, None] + (Lk - Lq) - np.arange(Lk)[None, :]
    vis = (rel >= 0) & (rel < (window or Lk + 1)) if causal else np.ones((Lq, Lk), bool)
    sees = (vis[None] & kw["kv_mask"].astype(bool)[:, None, :]).any(-1)  # [B, Lq]
    np.testing.assert_allclose(flashed.numpy().transpose(0, 2, 1, 3)[sees],
                               want.transpose(0, 2, 1, 3)[sees], rtol=0, atol=ATOL)


def test_mha_dense_mask_matches_xla():
    """A dense [B, 1, Lq, Lk] mask (the windowed shared-prefix path) takes
    the plain path even with flash on, as in JAX."""
    rng = np.random.RandomState(5)
    q = rng.randn(2, 4, 130, 16).astype(np.float32)
    k = rng.randn(2, 2, 150, 16).astype(np.float32)
    v = rng.randn(2, 2, 150, 16).astype(np.float32)
    mask = rng.rand(2, 1, 130, 150) > 0.4
    want = np.asarray(jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                mask=jnp.asarray(mask), use_flash=False))
    before = tflash.flash_mha.launches
    got = tattn.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                    mask=torch.from_numpy(mask), use_flash=True)
    assert tflash.flash_mha.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_flash_mha_rejects_window_without_causal():
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="window requires causal"):
        tflash.flash_mha(q, q, q, window=2)
    with pytest.raises(ValueError, match="no kernel for device"):
        tflash.flash_mha(q.to("meta"), q.to("meta"), q.to("meta"))


# --- the flash kernel's host-side plan (TMA tensor maps, shared memory, key
# tiles): pure Python, exercised on the CPU on the views the wrappers build.

def _bhld_views(B=2, L=256, H=4, KV=2, Dh=64):
    """q/k/v/out as flash_mha gets them from the decoder: [B, H, L, Dh]
    transposed views of the [B, L, H, Dh] projections."""
    q = torch.zeros(B, L, H, Dh, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(B, L, KV, Dh, dtype=torch.bfloat16).transpose(1, 2)
    return q, k, k.clone(memory_format=torch.preserve_format), torch.empty_like(q)


def test_tma_strides_of_the_wrappers_views():
    B, L, H, Dh = 2, 96, 4, 64
    HD = H * Dh
    qkv = torch.zeros(B, L, 3 * HD, dtype=torch.bfloat16)
    for x in tflash._split_packed(qkv):  # flash_mha_packed's views, then _launch's
        view = x.unflatten(-1, (H, Dh)).transpose(1, 2)
        assert tflash._tma_strides("x", view) == (L * 3 * HD, Dh, 3 * HD)
    q, k, _, _ = _bhld_views(B, L, H, 2, 128)  # flash_mha's transposed views
    assert tflash._tma_strides("q", q) == (L * H * 128, 128, H * 128)
    assert tflash._tma_strides("k", k) == (L * 2 * 128, 128, 2 * 128)
    kc = torch.cat([k, k], dim=2)  # the prefix path's concatenated K
    assert tflash._tma_strides("k", kc) == (2 * 2 * L * 128, 2 * L * 128, 128)


def test_tma_strides_give_size_one_dims_dh():
    x = torch.zeros(1, 1, 40, 16, dtype=torch.bfloat16).as_strided((1, 1, 40, 16),
                                                                   (3, 5, 16, 1))
    assert tflash._tma_strides("x", x) == (16, 16, 16)


@pytest.mark.parametrize("bad, match", [
    ("last", "last stride 1"), ("row", "whole 16 bytes"), ("base", "16-byte aligned")])
def test_tma_strides_reject_what_tma_cannot_describe(bad, match):
    base = torch.zeros(2, 4, 64, 72, dtype=torch.bfloat16)
    x = {"last": base[..., ::2],  # columns 2 apart
         "row": torch.zeros(2, 4, 40, 68, dtype=torch.bfloat16)[..., :64],  # row stride 68
         "base": base[..., 4:68]}[bad]  # 8 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match=match):
        tflash._tma_strides("x", x)


def test_smem_bytes_follow_the_kernels_plan():
    # The kernel's own smem_plan gives these (chip_smoke.py phase 2 holds
    # _smem_bytes to flash_smem_bytes on the card at the same shapes).
    assert tflash._smem_bytes(64, 640, True) == 148676
    assert tflash._smem_bytes(128, 640, False) == 165060
    assert tflash._smem_bytes(128, 4096, False) == 165708
    assert tflash._smem_bytes(16, 256, True) == 87164
    assert tflash._smem_bytes(128, 4096, True) <= tflash.MAX_SMEM
    assert tflash._smem_bytes(128, 2**19, True) > tflash.MAX_SMEM


@pytest.mark.parametrize("case, match", [
    ("bias_lk", "multiple of 8"), ("smem", "shared memory"), ("layout", "whole 16 bytes"),
    ("dh", "Dh % 16")])
def test_launch_raises_before_building_on_what_the_kernel_does_not_take(case, match):
    B, H, KV, L, Dh = 2, 4, 2, 256, 64
    q, k, v, out = _bhld_views(B, L, H, KV, Dh)
    bias = None
    if case == "bias_lk":
        q, k, v, out = _bhld_views(B, 100, H, KV, Dh)
        q, out = q[:, :, :96], out[:, :, :96]
        k, v = k[:, :, :100], v[:, :, :100]
        bias = torch.zeros(1, H, 96, 100, dtype=torch.bfloat16)
    elif case == "smem":
        Lk = 2**19  # rows 8 elements apart over one small buffer: the checks only
        k = v = torch.zeros(Lk * 8 + 128, dtype=torch.bfloat16).as_strided(
            (1, 1, Lk, 128), (Lk * 8, Lk * 8, 8, 1))
        q, out = (torch.zeros(1, 1, 8, 128, dtype=torch.bfloat16) for _ in range(2))
        bias = torch.zeros(1, 1, 8, Lk, dtype=torch.bfloat16)
    elif case == "layout":
        k = torch.zeros(B, KV, L, Dh + 4, dtype=torch.bfloat16)[..., :Dh]
        v = k
    elif case == "dh":
        q, k, v, out = _bhld_views(B, L, H, KV, 24)
    with pytest.raises(ValueError, match=match):
        tflash._launch_bhld(q, k, v, out, None, False, bias, 1.0, None)


def _visible_pairs(mask_row, lq, lk, causal, window):
    rows = np.arange(lq)[:, None] + (lk - lq)
    cols = np.arange(lk)[None, :]
    vis = np.broadcast_to(np.asarray(mask_row, bool)[None, :], (lq, lk)).copy()
    if causal:
        vis &= cols <= rows
        if window:
            vis &= rows - cols < window
    return vis


@pytest.mark.parametrize("layout", ["left", "holes", "right_window", "one_tile", "none"])
def test_key_tiles_cover_every_visible_pair_and_skip_padding(layout):
    rng = np.random.RandomState(11)
    BQ, BK = tflash.BLOCK_Q, tflash.BLOCK_K
    lq, lk, causal, window = 640, 640, True, None
    if layout == "left":  # a decoder prompt batch row
        row = (np.arange(lk) >= 390).astype(np.int32)
    elif layout == "holes":  # prefix 256 | suffix 512, both right-padded
        lq, lk = 512, 768
        row = np.concatenate([np.arange(256) < 140, np.arange(512) < 300]).astype(np.int32)
    elif layout == "right_window":
        lq, lk, window = 1000, 1000, 128
        row = (np.arange(lk) < 700).astype(np.int32)
    elif layout == "one_tile":
        row = np.zeros(lk, np.int32)
        row[2 * BK:3 * BK] = rng.rand(BK) < 0.5
        row[2 * BK] = 1
    else:  # no mask, T5's bidirectional encoder at a ragged length
        lq, lk, causal, row = 200, 200, False, None
    full_row = np.ones(lk, np.int32) if row is None else row
    vis = _visible_pairs(full_row, lq, lk, causal, window)
    for q0 in range(0, lq, BQ):
        tiles = tflash.key_tiles(row, lq, lk, q0, causal, window)
        listed = {t for t, _ in tiles}
        need = {c // BK for c in np.nonzero(vis[q0:q0 + BQ].any(0))[0]}
        assert need <= listed, (q0, need - listed)
        for t, all_valid in tiles:
            keys = full_row[t * BK:(t + 1) * BK]
            assert keys.any()  # no tile without a valid key is loaded
            assert all_valid == (len(keys) == BK and bool(keys.all()))
    if layout == "left":  # the tiles wholly in the left padding drop out
        assert ([t for t, _ in tflash.key_tiles(row, lq, lk, 512, True)]
                == list(range(390 // BK, lk // BK)))
    if layout == "one_tile":
        assert tflash.key_tiles(row, lq, lk, 512, True) == [(2, False)]
