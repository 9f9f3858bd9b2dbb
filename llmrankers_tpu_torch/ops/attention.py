"""Attention, normalisation and activation ops in plain PyTorch.

Counterpart of ``llmrankers_tpu/ops/attention.py``'s XLA path, with the same
semantics: einsum scores accumulated in fp32, the additive T5 bias, masking by
``where`` with -1e9, softmax in fp32. The hand-written flash kernel lives in
:mod:`.flash`; the T5 encoder calls it there, every other attention here.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # large-negative mask value, safe in bf16


def mha(
    q: torch.Tensor,  # [B, H, Lq, Dh]
    k: torch.Tensor,  # [B, H, Lk, Dh]
    v: torch.Tensor,  # [B, H, Lk, Dh]
    kv_mask: Optional[torch.Tensor] = None,  # [B, Lk] {0,1} key validity
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,  # [1|B, H, Lq, Lk] additive
    scale: Optional[float] = None,  # None -> 1/sqrt(Dh); T5 passes 1.0
) -> torch.Tensor:
    """Multi-head attention, returns [B, H, Lq, Dh] in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dtype = q.dtype
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    if kv_mask is not None:
        scores = scores.masked_fill(~kv_mask.bool()[:, None, None, :], NEG_INF)
    if causal:
        Lq, Lk = q.shape[2], k.shape[2]
        rows = torch.arange(Lq, device=q.device)[:, None]
        cols = torch.arange(Lk, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows + (Lk - Lq), NEG_INF)
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
