"""Decoder prefill for scoring: counterpart of the scoring half of
``llmrankers_tpu/engine/generate.py``.

:func:`prefill_layers` runs a token block through the decoder, optionally
attending to precomputed per-row prefix K/V first (the shared-prefix path:
unique prompt prefixes run once, each row gathers its group's K/V).
:func:`decoder_prefix_kv` returns the prefixes' per-layer K/V,
:func:`decoder_shared_prefill` runs the suffixes on top of them and returns
each row's last real hidden state. Building a KV cache for generation comes
with decoder generation (ROADMAP A8) and raises here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.decoder import Decoder, positions_from_mask
from ..ops.attention import mha, rms_norm


def prefill_layers(
    model: Decoder,
    input_ids: torch.Tensor,  # [B, L]
    attn_mask: torch.Tensor,  # [B, L]
    pre_k: Optional[torch.Tensor] = None,  # [Ld, B, KV, Lp, Dh] per-row prefix KV
    pre_v: Optional[torch.Tensor] = None,
    pre_mask: Optional[torch.Tensor] = None,  # [B, Lp]
    pos_offset: Optional[torch.Tensor] = None,  # [B] RoPE offset (prefix lengths)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward over a token block. Returns (final hidden [B, L, D], k/v
    stacks [Ld, B, KV, L, Dh], positions [B, L])."""
    cfg = model.cfg
    x = model.embed_rows(input_ids)
    pos = positions_from_mask(attn_mask)
    if pos_offset is not None:
        pos = pos + pos_offset[:, None]
    cos, sin = model.rope(pos, x.dtype)
    have_pre = pre_k is not None
    kv_mask_full = (torch.cat([pre_mask, attn_mask], dim=1).contiguous()
                    if have_pre else attn_mask)
    # Sliding window. Without a prefix the block is contiguously padded, so
    # the index-space window is exact (and the kernel takes it). With a
    # prefix there are padding holes between the right-padded prefix and the
    # suffix, so index deltas are not position deltas: a dense positional
    # mask instead, on the plain path.
    win = cfg.sliding_window
    win = win if (win is not None and kv_mask_full.shape[1] > win) else None
    dense_win = None
    if win is not None and have_pre:
        pos_k = torch.cat([positions_from_mask(pre_mask), pos], dim=1)  # [B, Lp+L]
        rel = pos[:, :, None] - pos_k[:, None, :]  # [B, Lq, Lk]
        vis = (rel >= 0) & (rel < win) & kv_mask_full.bool()[:, None, :]
        dense_win = vis[:, None]  # [B, 1, Lq, Lk]

    ks, vs = [], []
    for i, lp in enumerate(model.layers):
        def attend(q, k, v):
            if have_pre:
                k = torch.cat([pre_k[i], k], dim=2)
                v = torch.cat([pre_v[i], v], dim=2)
            # causal with Lk > Lq: suffix token j sees every prefix key and
            # the suffix keys <= j (the diagonal offset is Lk - Lq = Lp).
            if dense_win is not None:
                return mha(q, k, v, mask=dense_win, scale=cfg.head_dim_**-0.5)
            return model.attention(q, k, v, kv_mask=kv_mask_full, window=win)

        x, k, v = model.layer(lp, x, cos, sin, attend)
        ks.append(k)
        vs.append(v)
    h = rms_norm(x, model.final_ln, cfg.rms_norm_eps)
    return h, torch.stack(ks), torch.stack(vs), pos


def decoder_prefix_kv(model: Decoder, input_ids: torch.Tensor,
                      attn_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer post-RoPE K/V of shared prompt prefixes [Ld, G, KV, Lp, Dh].

    Prefixes are RIGHT-padded with absolute positions 0..len-1, so the
    result is row-independent: every row sharing the prefix reuses it."""
    _, ks, vs, _ = prefill_layers(model, input_ids, attn_mask)
    return ks, vs


def decoder_shared_prefill(
    model: Decoder,
    pre_k: torch.Tensor,  # [Ld, B, KV, Lp, Dh] (gathered per row)
    pre_v: torch.Tensor,
    pre_mask: torch.Tensor,  # [B, Lp]
    suffix_ids: torch.Tensor,  # [B, Ls] RIGHT-padded
    suffix_mask: torch.Tensor,  # [B, Ls]
    max_new_tokens: Optional[int] = None,
):
    """Prefill suffix tokens on top of shared-prefix K/V. Returns (last
    real-token hidden [B, D], None); ``max_new_tokens=None`` is label
    scoring, which needs no cache. RoPE positions are contiguous per row;
    the holes between prefix and suffix are masked by the key mask."""
    if max_new_tokens is not None:
        raise NotImplementedError(
            "decoder generation caches are not ported yet (ROADMAP A8)")
    B = suffix_ids.shape[0]
    pre_len = pre_mask.sum(dim=1)  # [B]
    h, _, _, _ = prefill_layers(model, suffix_ids, suffix_mask, pre_k=pre_k,
                                pre_v=pre_v, pre_mask=pre_mask, pos_offset=pre_len)
    last_idx = torch.clamp(suffix_mask.sum(dim=1) - 1, min=0)
    return h[torch.arange(B, device=h.device), last_idx], None
