"""Port parity: attention ops of ``llmrankers_tpu_torch.ops`` against JAX.

The same numpy inputs go through the JAX op and the port's op in fp32. The
port's flash wrapper takes its plain version on CPU tensors and is held to
the JAX Pallas kernel ``flash_mha_blhd`` run in interpret mode (as
``tests/test_flash.py`` runs it), on every row including an all-padding row,
which both must return as zeros. The port's plain ``mha_flat`` is held to the
JAX XLA ``mha_flat``. Tolerance: 1e-5 absolute in fp32 (the two frameworks
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
