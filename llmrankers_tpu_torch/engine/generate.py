"""Decoder prefill and greedy decoding with KV caches: counterpart of the
decoder half of ``llmrankers_tpu/engine/generate.py``.

:func:`prefill_layers` runs a token block through the decoder, optionally
attending to precomputed per-row prefix K/V first (the shared-prefix path:
unique prompt prefixes run once, each row gathers its group's K/V).
:func:`decoder_prefix_kv` returns the prefixes' per-layer K/V,
:func:`decoder_shared_prefill` runs the suffixes on top of them and returns
each row's last real hidden state and, for generation, its cache.

Generation: :func:`decoder_prefill` (left-padded prompts) or
:func:`decoder_shared_prefill` builds a cache preallocated at ``L +
max_new_tokens`` along T, and :func:`decoder_decode_chunk` extends it one
token at a time. A cache is ``(k, v, key_mask [B, T] bool, next_pos [B])``
with k and v ``[Ld, B, KV, T, Dh]`` in the model's dtype, or quantized
(``kv_quant``): ``(payload [Ld, B, KV, T, Dhp] int8, scales [Ld, B, KV, T,
S] f32)``, int8 per position and head (Dhp = Dh, S = 1) or planar int4 (Dhp
= Dh/2, S = 2, :func:`_kv_quant4`); the mode is read back from the scales.
Each decode step writes its new rows into the cache in place, and the
current token joins attention as a rank-1 online-softmax term; over a
quantized cache on the card that attention is the hand-written kernel
(:func:`..ops.kvq_attention.kvq_decode_attention`), elsewhere its plain
version. The decode loop never reads a value back to the host: rows freeze
on EOS on the device, and the engine checks stop strings between chunks.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..models.decoder import Decoder, positions_from_mask
from ..ops.attention import mha, rms_norm
from ..ops.kvq_attention import kvq_decode_attention, kvq_decode_attention_plain

_M64 = (1 << 64) - 1

Cache = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (position, KV head): x [..., Dh] -> (int8 values,
    f32 scales [..., 1]), the JAX formula in f32."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / amax * 127.0), -127, 127).to(torch.int8)
    return q, amax / 127.0


def _kv_quant4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planar symmetric int4: x [..., Dh] -> (int8 bytes [..., Dh/2], f32
    scales [..., 2]). Byte j holds dim j in its low nibble and dim Dh/2 + j
    in its high nibble; each half has its own scale (amax/7, range -7..7)."""
    h = x.shape[-1] // 2
    xf = x.float()

    def q4(part):
        amax = part.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
        q = torch.clamp(torch.round(part / amax * 7.0), -7, 7).to(torch.int32)
        return q, amax / 7.0

    qlo, slo = q4(xf[..., :h])
    qhi, shi = q4(xf[..., h:])
    packed = ((qhi << 4) | (qlo & 0x0F)).to(torch.int8)
    return packed, torch.cat([slo, shi], dim=-1)


def _kv_pack(x: torch.Tensor, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """A K or V block quantized for the cache under ``mode`` ('int8' |
    'int4')."""
    return _kv_quant4(x) if mode == "int4" else _kv_quant(x)


def cache_mode(c: Cache) -> Optional[str]:
    """The quantization of a cache half: None, 'int8' or 'int4'."""
    if isinstance(c, torch.Tensor):
        return None
    return "int4" if c[1].shape[-1] == 2 else "int8"


def _cache_alloc(Ld: int, B: int, KV: int, T: int, Dh: int, dtype: torch.dtype,
                 device, mode: Optional[str]) -> Cache:
    """A zeroed cache half [Ld, B, KV, T, ...]: zeros, as the JAX cache is
    zero-padded, so unwritten slots hold finite values."""
    if mode is None:
        return torch.zeros((Ld, B, KV, T, Dh), dtype=dtype, device=device)
    Dhp, S = (Dh // 2, 2) if mode == "int4" else (Dh, 1)
    return (torch.zeros((Ld, B, KV, T, Dhp), dtype=torch.int8, device=device),
            torch.zeros((Ld, B, KV, T, S), dtype=torch.float32, device=device))


def _cache_put(c: Cache, x: torch.Tensor, start: int, layer: Optional[int] = None) -> None:
    """Write ``x`` [.., B, KV, n, Dh] into cache positions start..start+n-1 in
    place (of one layer, or of all when ``layer`` is None), quantizing it
    for a quantized cache."""
    n = x.shape[-2]
    mode = cache_mode(c)
    if mode is None:
        dst = c if layer is None else c[layer]
        dst[..., start:start + n, :] = x
        return
    q, s = _kv_pack(x, mode)
    for dst, src in zip(c, (q, s)):
        dst = dst if layer is None else dst[layer]
        dst[..., start:start + n, :] = src


def _layer(c: Cache, i: int) -> Cache:
    return c[i] if isinstance(c, torch.Tensor) else (c[0][i], c[1][i])


def _fold(key: int, data: int) -> int:
    """A new 63-bit seed from ``key`` and ``data`` (splitmix64 finalizer):
    the port's ``jax.random.fold_in``, keying one sample stream per
    dispatch chunk and per step."""
    z = (key ^ ((data + 0x9E3779B97F4A7C15) * 0xBF58476D1CE4E5B9)) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def _pick(logits: torch.Tensor, temperature: float, key: Optional[int]) -> torch.Tensor:
    """Next token: argmax, or (temperature > 0 with a key) a categorical
    sample of logits/temperature from a ``torch.Generator`` seeded with
    ``key``, every row independently. f32 softmax."""
    if temperature > 0.0 and key is not None:
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(key)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.argmax(logits, dim=-1)


def prefill_layers(
    model: Decoder,
    input_ids: torch.Tensor,  # [B, L]
    attn_mask: torch.Tensor,  # [B, L]
    pre_k: Optional[torch.Tensor] = None,  # [Ld, B, KV, Lp, Dh] per-row prefix KV
    pre_v: Optional[torch.Tensor] = None,
    pre_mask: Optional[torch.Tensor] = None,  # [B, Lp]
    pos_offset: Optional[torch.Tensor] = None,  # [B] RoPE offset (prefix lengths)
    cache: Optional[Tuple[Cache, Cache]] = None,  # written at [at, at + L)
    at: int = 0,
):
    """Forward over a token block. Returns (final hidden [B, L, D], k/v
    stacks [Ld, B, KV, L, Dh], positions [B, L]); with ``cache`` each
    layer's K/V goes into it at positions ``at``.. instead, and the stacks
    are None."""
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
        if cache is None:
            ks.append(k)
            vs.append(v)
        else:
            _cache_put(cache[0], k, at, layer=i)
            _cache_put(cache[1], v, at, layer=i)
    h = rms_norm(x, model.final_ln, cfg.rms_norm_eps)
    if cache is not None:
        return h, None, None, pos
    return h, torch.stack(ks), torch.stack(vs), pos


def decoder_prefix_kv(model: Decoder, input_ids: torch.Tensor,
                      attn_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer post-RoPE K/V of shared prompt prefixes [Ld, G, KV, Lp, Dh].

    Prefixes are RIGHT-padded with absolute positions 0..len-1, so the
    result is row-independent: every row sharing the prefix reuses it."""
    _, ks, vs, _ = prefill_layers(model, input_ids, attn_mask)
    return ks, vs


def _act_dtype(model: Decoder) -> torch.dtype:
    """The activations' dtype: the embedding's, or its scales' when it is
    int8."""
    return (model.embed if model.embed_scale is None else model.embed_scale).dtype


def _new_cache(model: Decoder, B: int, T: int, dtype, mode: Optional[str]):
    cfg = model.cfg
    shape = (cfg.num_hidden_layers, B, cfg.num_key_value_heads, T, cfg.head_dim_)
    return tuple(_cache_alloc(*shape, dtype, model.final_ln.device, mode) for _ in range(2))


def decoder_prefill(
    model: Decoder,
    input_ids: torch.Tensor,  # [B, L] left-padded
    attn_mask: torch.Tensor,  # [B, L]
    max_new_tokens: int,
    kv_quant: Optional[str] = None,  # None | 'int8' | 'int4'
):
    """Full forward over left-padded prompts: (last logits [B, V], cache)
    with the cache preallocated at L + max_new_tokens."""
    B, L = input_ids.shape
    kc, vc = _new_cache(model, B, L + max_new_tokens, _act_dtype(model), kv_quant)
    h, _, _, pos = prefill_layers(model, input_ids, attn_mask, cache=(kc, vc))
    last_logits = model.lm_logits(h[:, -1, :])
    key_mask = F.pad(attn_mask.bool(), (0, max_new_tokens))
    return last_logits, (kc, vc, key_mask, pos[:, -1] + 1)


def decoder_shared_prefill(
    model: Decoder,
    pre_k: torch.Tensor,  # [Ld, B, KV, Lp, Dh] (gathered per row)
    pre_v: torch.Tensor,
    pre_mask: torch.Tensor,  # [B, Lp]
    suffix_ids: torch.Tensor,  # [B, Ls] RIGHT-padded
    suffix_mask: torch.Tensor,  # [B, Ls]
    max_new_tokens: Optional[int] = None,
    kv_quant: Optional[str] = None,  # None | 'int8' | 'int4'
):
    """Prefill suffix tokens on top of shared-prefix K/V. Returns (last
    real-token hidden [B, D], cache); ``max_new_tokens=None`` is label
    scoring, which needs no cache (None). The cache holds [prefix | suffix |
    max_new_tokens free slots], with prompt length Lp + Ls; RoPE positions
    are contiguous per row, and the holes between prefix and suffix are
    masked by the key mask."""
    B = suffix_ids.shape[0]
    Lp, Ls = pre_k.shape[3], suffix_ids.shape[1]
    pre_len = pre_mask.sum(dim=1)  # [B]
    cache = None
    if max_new_tokens is not None:
        cache = _new_cache(model, B, Lp + Ls + max_new_tokens, pre_k.dtype, kv_quant)
        _cache_put(cache[0], pre_k, 0)
        _cache_put(cache[1], pre_v, 0)
    h, _, _, _ = prefill_layers(model, suffix_ids, suffix_mask, pre_k=pre_k,
                                pre_v=pre_v, pre_mask=pre_mask, pos_offset=pre_len,
                                cache=cache, at=Lp)
    last_idx = torch.clamp(suffix_mask.sum(dim=1) - 1, min=0)
    last_h = h[torch.arange(B, device=h.device), last_idx]
    if cache is None:
        return last_h, None
    key_mask = F.pad(torch.cat([pre_mask, suffix_mask], dim=1).bool(), (0, max_new_tokens))
    return last_h, (*cache, key_mask, pre_len + suffix_mask.sum(dim=1))


def _attend_cached(model: Decoder, qg, kcl: Cache, vcl: Cache, k_new, v_new, amask):
    """The decode step's attention of one layer, f32 [B, KV, G, Dh]: over a
    quantized cache the B8 kernel (its plain version on CPU tensors and
    under ``model.plain_kernels``); over a cache in the model's dtype plain
    einsums."""
    scale = model.cfg.head_dim_**-0.5
    mode = cache_mode(kcl)
    if mode is not None and not model.plain_kernels:
        return kvq_decode_attention(qg, kcl, vcl, k_new, v_new, amask, scale, mode)
    return kvq_decode_attention_plain(qg, kcl, vcl, k_new, v_new, amask, scale, mode)


def _decode_token_forward(model: Decoder, tok: torch.Tensor, kc: Cache, vc: Cache,
                          amask: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """One-token forward against read-only caches. Each layer returns only
    its new k/v row; the current token joins attention as a rank-1
    online-softmax term, and the caller appends the rows of all layers in
    place. Returns (logits [B, V], k_new, v_new [Ld, B, KV, Dh])."""
    cfg = model.cfg
    B = tok.shape[0]
    KV, Dh = cfg.num_key_value_heads, cfg.head_dim_
    G = cfg.num_attention_heads // KV
    x = model.embed_rows(tok[:, None])  # [B, 1, D]
    k_rows, v_rows = [], []
    for i, lp in enumerate(model.layers):
        def attend(q, k, v):  # q [B, H, 1, Dh], k/v [B, KV, 1, Dh]
            a = _attend_cached(model, q.reshape(B, KV, G, Dh), _layer(kc, i), _layer(vc, i),
                               k[:, :, 0], v[:, :, 0], amask)
            return a.to(q.dtype).reshape(B, KV * G, 1, Dh)

        x, k, v = model.layer(lp, x, cos, sin, attend)
        k_rows.append(k[:, :, 0])
        v_rows.append(v[:, :, 0])
    h = rms_norm(x[:, 0], model.final_ln, cfg.rms_norm_eps)
    return model.lm_logits(h), torch.stack(k_rows), torch.stack(v_rows)


def decoder_decode_chunk(
    model: Decoder,
    first_token: torch.Tensor,  # [B] next token to consume
    cache,
    prompt_len: int,
    offset: int,  # tokens already generated before this chunk
    steps: int,
    eos_id: int,
    done: Optional[torch.Tensor] = None,  # [B] rows frozen by the host
    temperature: float = 0.0,
    key: Optional[int] = None,  # sampling seed; step t samples with _fold(key, t)
):
    """Generate ``steps`` tokens, writing cache positions prompt_len + offset
    on. Returns (tokens [B, steps], (next token, cache, done)); the cache is
    updated in place. Step t emits the token it consumes (pad once the row
    is done) and picks the next; a row is done after it emits EOS."""
    k_cache, v_cache, kmask, pos = cache
    B = first_token.shape[0]
    T = kmask.shape[1]
    L = prompt_len
    pad = model.cfg.pad_token_id
    if done is None:
        done = torch.zeros((B,), dtype=torch.bool, device=first_token.device)
    # Sliding window: skipped unless the cache can outgrow it.
    win = model.cfg.sliding_window
    win = win if (win is not None and T > win) else None
    dtype = _act_dtype(model)
    tok, outs = first_token, []
    for i in range(steps):
        t = offset + i
        cos, sin = model.rope(pos[:, None], dtype)
        if win is not None:
            # Padding is contiguous per region and appended slots turn valid
            # in order, so the cumulative count of valid slots gives every
            # slot's RoPE position; keys a window or more behind drop out.
            slot_pos = torch.cumsum(kmask.long(), dim=1) - 1
            amask = kmask & (pos[:, None] - slot_pos < win)
        else:
            amask = kmask
        logits, k_new, v_new = _decode_token_forward(model, tok, k_cache, v_cache, amask,
                                                     cos, sin)
        _cache_put(k_cache, k_new[:, :, :, None, :], L + t)
        _cache_put(v_cache, v_new[:, :, :, None, :], L + t)
        kmask[:, L + t] = True
        nxt = _pick(logits, temperature, None if key is None else _fold(key, t))
        outs.append(torch.where(done, torch.full_like(tok, pad), tok))
        done = done | (tok == eos_id)
        tok = torch.where(done, tok, nxt)
        pos = pos + 1
    out = torch.stack(outs, dim=1) if outs else first_token.new_zeros((B, 0))
    return out, (tok, (k_cache, v_cache, kmask, pos), done)


def decoder_greedy_decode(model: Decoder, first_token: torch.Tensor, cache,
                          prompt_len: int, max_new_tokens: int, eos_id: int) -> torch.Tensor:
    """Continue greedy generation from a prefilled cache; returns [B,
    max_new_tokens] including the first token (pad after EOS)."""
    out, _ = decoder_decode_chunk(model, first_token, cache, prompt_len, 0,
                                  max_new_tokens, eos_id)
    return out
