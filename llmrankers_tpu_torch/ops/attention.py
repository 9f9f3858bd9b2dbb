"""Attention, normalisation, activation and RoPE ops in plain PyTorch (RoPE's
frequencies default or YaRN, :func:`rope_inv_freq`).

Counterpart of ``llmrankers_tpu/ops/attention.py``'s XLA path, with the same
semantics: einsum scores accumulated in fp32, the additive T5 bias, masking by
``where`` with -1e9, softmax in fp32. :func:`mha` is the semantic definition
and dispatches to the hand-written flash kernel (:func:`.flash.flash_mha`)
under the JAX rule: flash on, no dense mask, Lq >= 128. The T5 encoder calls
the ``[B, L, H*Dh]`` flash wrappers of :mod:`.flash` itself.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .flash import flash_mha

NEG_INF = -1e9  # large-negative mask value, safe in bf16


def mha(
    q: torch.Tensor,  # [B, H, Lq, Dh]
    k: torch.Tensor,  # [B, KV, Lk, Dh], KV | H
    v: torch.Tensor,  # [B, KV, Lk, Dh]
    mask: Optional[torch.Tensor] = None,  # [B, 1|H, Lq, Lk] bool (plain path only)
    kv_mask: Optional[torch.Tensor] = None,  # [B, Lk] {0,1} key validity
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,  # [1|B, H, Lq, Lk] additive
    scale: Optional[float] = None,  # None -> 1/sqrt(Dh); T5 passes 1.0
    use_flash: bool = False,
    window: Optional[int] = None,  # causal sliding window, index space
) -> torch.Tensor:
    """Multi-head attention, returns [B, H, Lq, Dh] in q's dtype.

    GQA-native: ``k``/``v`` may carry fewer (KV) heads than ``q``; query
    head h reads K/V head h // G. The flash kernel reads them as they are;
    the plain path repeats them here. ``window`` bounds causal attention to
    the previous ``window`` positions in INDEX space, exact for one
    contiguously padded block (the prefix-sharing prefill rolls each row's
    prefix against its suffix to make it so); a dense ``mask`` is taken by
    the plain path only."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window is not None and not causal:
        raise ValueError("window requires causal attention")
    if use_flash and mask is None and q.shape[2] >= 128:
        return flash_mha(q, k, v, kv_mask=kv_mask, causal=causal, bias=bias,
                         scale=scale, window=window)
    if k.shape[1] != q.shape[1]:  # GQA repeat for the plain path only
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    dtype = q.dtype
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    if kv_mask is not None:
        scores = scores.masked_fill(~kv_mask.bool()[:, None, None, :], NEG_INF)
    if causal:
        Lq, Lk = q.shape[2], k.shape[2]
        rel = (torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
               - torch.arange(Lk, device=q.device)[None, :])
        tri = rel >= 0
        if window is not None:
            tri = tri & (rel < window)
        scores = scores.masked_fill(~tri, NEG_INF)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(dtype).float(), v.float())
    return out.to(dtype)


def mha_flat(
    q: torch.Tensor,  # [B, Lq, H*Dh], as the projections produce it
    k: torch.Tensor,  # [B, Lk, H*Dh]
    v: torch.Tensor,
    num_heads: int,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,  # [1, H, Lq, Lk]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`mha` over the [B, L, H*Dh] layout; returns [B, Lq, H*Dh]."""
    B, Lq, HD = q.shape
    Dh = HD // num_heads

    def split(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(B, x.shape[1], num_heads, Dh).transpose(1, 2)

    out = mha(split(q), split(k), split(v), kv_mask=kv_mask, causal=causal,
              bias=bias, scale=scale)
    return out.transpose(1, 2).reshape(B, Lq, HD)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """T5/Llama-style RMSNorm (no mean subtraction, no bias), fp32 stats."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """HF 'gelu_new' (tanh approximation), used by the flan-t5 gated FFN."""
    return 0.5 * x * (
        1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * torch.pow(x, 3.0)))
    )


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for RoPE at the given positions: [..., head_dim],
    computed in fp32 and cast to ``dtype`` (the activation dtype), so RoPE
    itself runs in that dtype, as in JAX."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    freqs = positions.float()[..., None] * inv_freq  # [..., Dh/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, H, L, Dh]; cos/sin: [B, L, Dh] (broadcast over heads)."""
    cos = cos[:, None, :, :]
    sin = sin[:, None, :, :]
    return x * cos + rotate_half(x) * sin


def rope_inv_freq(params: dict, head_dim: int, device=None) -> Tuple[torch.Tensor, float]:
    """(inverse frequencies [head_dim / 2] float32, cos/sin scale) of one
    attention type's RoPE: default at ``rope_theta``, or YaRN as transformers'
    ``_compute_yarn_parameters`` derives it (frequencies ramped between
    interpolation and extrapolation over the correction range of
    ``beta_fast``/``beta_slow`` at ``original_max_position_embeddings``,
    truncated; the scale ``attention_factor``, else 0.1 ln(factor) + 1)."""
    base = float(params["rope_theta"])
    pos_freqs = base ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                         / head_dim)
    if params.get("rope_type", "default") == "default":
        return 1.0 / pos_freqs, 1.0
    if params["rope_type"] != "yarn":
        raise NotImplementedError(f"rope_type {params['rope_type']!r}")
    factor = float(params["factor"])
    scale = params.get("attention_factor")
    if scale is None:
        scale = 0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0
    orig = params["original_max_position_embeddings"]

    def corr_dim(rot):
        return head_dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low, high = corr_dim(params.get("beta_fast") or 32), corr_dim(params.get("beta_slow") or 1)
    if params.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, head_dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extra = 1 - ramp  # the share of extrapolation
    inv = (1.0 / (factor * pos_freqs)) * (1 - extra) + (1.0 / pos_freqs) * extra
    return inv, float(scale)
