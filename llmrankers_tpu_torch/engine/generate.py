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
Each step of a decode loop (a verify round under speculation) is the span
``decode.step`` of ``utils.metering``.

A step of :func:`decoder_decode_chunk` (:func:`_decode_step`) advances a
:class:`DecodeState` in place, its write position a device index, so the
same ops run eagerly or captured in a CUDA graph: the engine keeps one
shape's buffers with the graph of one greedy step (span ``decode.capture``)
and, on the card, replays it once a step for greedy chunks of
:data:`GRAPH_MIN_STEPS` or more (:func:`graph_wanted`).

Slot refill (continuous batching): :func:`decoder_decode_chunk_rr` decodes
with each row appending at its own write position ``wp`` (frozen on the
device once its budget is spent), and :func:`decoder_refill_slots` (a
left-padded prefill), :func:`decoder_refill_slots_shared` (shared prefixes)
or :func:`decoder_refill_slots_pre` (the session's prefix K/V) prefill
pending rows and scatter them into freed slots of the live session. Prompt-
lookup speculative decoding: :func:`decoder_spec_decode_chunk` drafts K
tokens from a bigram/trigram match in each row's own history and verifies
them in one (K+1)-token forward with greedy acceptance. Per-row writes
follow ``jax.lax.dynamic_update_slice``: a start past the end clamps
(:func:`_row_append`); a scatter to an out-of-range slot is dropped.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..models.decoder import Decoder, positions_from_mask
from ..ops.attention import rms_norm
from ..ops.kvq_attention import (NEG_INF, _dot, cached_pv, cached_qk, kvq_decode_attention,
                                 kvq_decode_attention_plain)
from ..utils.metering import span

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


def _cache_put(c: Cache, x: torch.Tensor, start: Union[int, torch.Tensor],
               layer: Optional[int] = None) -> None:
    """Write ``x`` [.., B, KV, n, Dh] into cache positions start..start+n-1 in
    place (of one layer, or of all when ``layer`` is None), quantizing it
    for a quantized cache. ``start`` is a host int, or for one position
    (n = 1) a device index [1] that the host never reads, so that a decode
    step captured in a CUDA graph writes where the step has advanced it."""
    n = x.shape[-2]
    mode = cache_mode(c)
    for dst, src in ((c, x),) if mode is None else zip(c, _kv_pack(x, mode)):
        dst = dst if layer is None else dst[layer]
        if isinstance(start, torch.Tensor):
            dst.index_copy_(dst.ndim - 2, start, src.to(dst.dtype))
        else:
            dst[..., start:start + n, :] = src


def _row_append(buf: torch.Tensor, blk: torch.Tensor, starts: torch.Tensor) -> None:
    """Per-row in-place write along T, the JAX ``_row_append`` (a vmapped
    ``dynamic_update_slice``): row b's block goes to positions start_b ..
    start_b + n - 1, with start_b clamped to [0, T - n] as
    ``dynamic_update_slice`` clamps it. ``buf`` is [B, T] with ``blk`` [B,
    n], or a cache leaf [Ld, B, KV, T, ...] with ``blk`` [Ld, B, KV, n, ...]."""
    cache = buf.ndim > 2
    T, n = (buf.shape[3], blk.shape[3]) if cache else (buf.shape[1], blk.shape[1])
    B = starts.shape[0]
    t_idx = starts.clamp(0, T - n)[:, None] + torch.arange(n, device=buf.device)
    b_idx = torch.arange(B, device=buf.device)[:, None].expand(B, n)
    if cache:
        # The two index tensors are split by a slice, so the indexed view
        # puts their [B, n] first: [B, n, Ld, KV, ...].
        buf[:, b_idx, :, t_idx] = blk.permute(1, 3, 0, 2, *range(4, blk.ndim))
    else:
        buf[b_idx, t_idx] = blk


def _cache_row_put(c: Cache, x: torch.Tensor, starts: torch.Tensor) -> None:
    """Write ``x`` [Ld, B, KV, n, Dh] into every layer of a cache half at
    each row's own start (:func:`_row_append`), quantizing it for a
    quantized cache."""
    mode = cache_mode(c)
    if mode is None:
        _row_append(c, x, starts)
        return
    for dst, src in zip(c, _kv_pack(x, mode)):
        _row_append(dst, src, starts)


def _slot_rows(slots, B: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows of a refill batch, their session slots) for the slots in range:
    a slot outside [0, B) marks a padding row, dropped as the JAX scatter's
    ``mode="drop"`` drops it. ``slots`` is a host sequence."""
    pairs = [(j, int(s)) for j, s in enumerate(slots) if 0 <= int(s) < B]
    rows = torch.tensor([j for j, _ in pairs], dtype=torch.long, device=device)
    dst = torch.tensor([s for _, s in pairs], dtype=torch.long, device=device)
    return rows, dst


def _layer(c: Cache, i: int) -> Cache:
    return c[i] if isinstance(c, torch.Tensor) else (c[0][i], c[1][i])


def _rows(c: Cache, r0: int, r1: int) -> Cache:
    """Rows r0..r1-1 of a cache half [Ld, B, ...], as views."""
    return c[:, r0:r1] if isinstance(c, torch.Tensor) else (c[0][:, r0:r1], c[1][:, r0:r1])


def _zero(*halves: Cache) -> None:
    """Zero cache halves in place."""
    for half in halves:
        for leaf in (half,) if isinstance(half, torch.Tensor) else half:
            leaf.zero_()


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
    ropes = model.ropes(pos, x.dtype)
    routing = model.routing(attn_mask)
    have_pre = pre_k is not None
    kv_mask_full = (torch.cat([pre_mask, attn_mask], dim=1).contiguous()
                    if have_pre else attn_mask)
    Lk = kv_mask_full.shape[1]
    # Sliding windows, per layer. Without a prefix the block is contiguously
    # padded, so the index-space window is exact (and the kernel takes it).
    # With a prefix, a windowed layer attends to each row's prefix K/V rolled
    # so that it ends where the suffix begins (its padding moved in front):
    # index deltas are then position deltas, and the kernel takes the window
    # as it does without a prefix.
    wins = [w if (w is not None and Lk > w) else None
            for w in map(cfg.layer_window, range(cfg.num_hidden_layers))]
    roll = roll_mask = None
    if have_pre and any(w is not None for w in wins):
        roll = _prefix_roll(pre_mask)
        roll_mask = torch.cat([pre_mask.gather(1, roll), attn_mask], dim=1).contiguous()

    ks, vs = [], []
    for i, lp in enumerate(model.layers):
        def attend(q, k, v):
            mask = kv_mask_full
            if have_pre:
                pk, pv = pre_k[i], pre_v[i]
                if wins[i] is not None:
                    idx = roll[:, None, :, None].expand(-1, pk.shape[1], -1, pk.shape[3])
                    pk, pv, mask = pk.gather(2, idx), pv.gather(2, idx), roll_mask
                k = torch.cat([pk, k], dim=2)
                v = torch.cat([pv, v], dim=2)
            # causal with Lk > Lq: suffix token j sees every prefix key and
            # the suffix keys <= j (the diagonal offset is Lk - Lq = Lp).
            return model.attention(q, k, v, kv_mask=mask, window=wins[i])

        x, k, v = model.layer(lp, x, *ropes[i], attend, routing)
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


def _prefix_roll(pre_mask: torch.Tensor) -> torch.Tensor:
    """[B, Lp] the source index of each slot of a right-padded prefix rolled
    to end at slot Lp - 1 (its padding moved in front): slot c takes (c + n)
    mod Lp, n the row's prefix length."""
    Lp = pre_mask.shape[1]
    return (torch.arange(Lp, device=pre_mask.device)[None, :]
            + pre_mask.sum(dim=1)[:, None]) % Lp


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


def _new_cache(model: Decoder, B: int, T: int, dtype, mode: Optional[str], bufs=None):
    """The (k, v) cache halves of B rows over T positions, zeroed: newly
    allocated, or ``bufs`` (a :class:`DecodeState`'s halves of that shape,
    or views of B of its rows, :func:`_rows`) zeroed in place."""
    cfg = model.cfg
    shape = (cfg.num_hidden_layers, B, cfg.num_key_value_heads, T, cfg.head_dim_)
    if bufs is None:
        return tuple(_cache_alloc(*shape, dtype, model.final_ln.device, mode) for _ in range(2))
    _zero(*bufs)
    return bufs


def decoder_prefill(
    model: Decoder,
    input_ids: torch.Tensor,  # [B, L] left-padded
    attn_mask: torch.Tensor,  # [B, L]
    max_new_tokens: int,
    kv_quant: Optional[str] = None,  # None | 'int8' | 'int4'
    bufs=None,  # cache halves to fill instead of allocating (``_new_cache``)
):
    """Full forward over left-padded prompts: (last logits [B, V], cache)
    with the cache preallocated at L + max_new_tokens."""
    B, L = input_ids.shape
    kc, vc = _new_cache(model, B, L + max_new_tokens, _act_dtype(model), kv_quant, bufs)
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
    bufs=None,  # cache halves to fill instead of allocating (``_new_cache``)
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
        cache = _new_cache(model, B, Lp + Ls + max_new_tokens, pre_k.dtype, kv_quant, bufs)
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
                          amask, cos, sin, routing=None):
    """One-token forward against read-only caches. Each layer returns only
    its new k/v row; the current token joins attention as a rank-1
    online-softmax term, and the caller appends the rows of all layers in
    place. ``amask`` [B, T], ``cos`` and ``sin`` are each one tensor for
    every layer or a list of one per layer (:func:`_step_inputs`);
    ``routing`` is the step's for routed-expert layers. Returns (logits [B,
    V], k_new, v_new [Ld, B, KV, Dh])."""
    cfg = model.cfg
    B = tok.shape[0]
    KV, Dh = cfg.num_key_value_heads, cfg.head_dim_
    G = cfg.num_attention_heads // KV
    x = model.embed_rows(tok[:, None])  # [B, 1, D]
    k_rows, v_rows = [], []

    def per(t, i):
        return t[i] if isinstance(t, list) else t

    for i, lp in enumerate(model.layers):
        def attend(q, k, v):  # q [B, H, 1, Dh], k/v [B, KV, 1, Dh]
            a = _attend_cached(model, q.reshape(B, KV, G, Dh), _layer(kc, i), _layer(vc, i),
                               k[:, :, 0], v[:, :, 0], per(amask, i))
            return a.to(q.dtype).reshape(B, KV * G, 1, Dh)

        x, k, v = model.layer(lp, x, per(cos, i), per(sin, i), attend, routing)
        k_rows.append(k[:, :, 0])
        v_rows.append(v[:, :, 0])
    h = rms_norm(x[:, 0], model.final_ln, cfg.rms_norm_eps)
    return model.lm_logits(h), torch.stack(k_rows), torch.stack(v_rows)


# A decode chunk replays the captured step when it has at least this many
# steps: shorter ones (a warm-up's, a short budget's tail) run eagerly, so
# they never pay for a capture.
GRAPH_MIN_STEPS = 16


def _win(model: Decoder, T: int, i: int = 0) -> Optional[int]:
    """The sliding window layer ``i``'s decode step applies: None unless the
    cache can outgrow it."""
    win = model.cfg.layer_window(i)
    return win if (win is not None and T > win) else None


def _step_inputs(model: Decoder, kmask: torch.Tensor, pos: torch.Tensor, dtype):
    """A decode step's per-layer inputs at RoPE positions ``pos`` [B]: each
    layer's key mask (``kmask`` less what its window leaves out, one mask per
    window) and its attention type's RoPE table, as lists (amasks, cos,
    sin) of one per layer."""
    T, made, amasks = kmask.shape[1], {}, []
    for i in range(model.cfg.num_hidden_layers):
        win = _win(model, T, i)
        if win not in made:
            made[win] = _window_mask(kmask, pos, win)
        amasks.append(made[win])
    ropes = model.ropes(pos[:, None], dtype)
    return amasks, [c for c, _ in ropes], [s for _, s in ropes]


def graph_wanted(model: Decoder, steps: int, temperature: float = 0.0,
                 key: Optional[int] = None) -> bool:
    """Whether a decode chunk of ``steps`` replays a captured step: on a CUDA
    device, on the kernels (not ``model.plain_kernels``), greedy (sampling
    seeds a host generator every step) and of at least
    :data:`GRAPH_MIN_STEPS` steps."""
    return (model.final_ln.device.type == "cuda" and not model.plain_kernels
            and not (temperature > 0.0 and key is not None) and steps >= GRAPH_MIN_STEPS)


class DecodeState:
    """What a decode step reads and advances in place: the cache halves,
    the key mask [B, T], RoPE positions [B], the next token [B], ``done``
    [B], the write position ``wp`` [1] (a device index: the step index is
    wp less the prompt length) and the emitted tokens ``out`` [B, T], each
    at its write position. :func:`decoder_decode_chunk` builds one over its
    arguments; the engine keeps one of a shape as static buffers
    (:meth:`alloc`, filled by a prefill through ``bufs``), and with it the
    CUDA graph of one greedy step over them (:meth:`capture`), replayed
    once a step. The kernel wrappers count their launches where they are
    called: a capture's warm-up step and its captured step each count one
    step's launches, and a replay counts none."""

    def __init__(self, kc: Cache, vc: Cache, kmask, pos, tok, done, wp, out):
        self.kc, self.vc, self.kmask, self.pos = kc, vc, kmask, pos
        self.tok, self.done, self.wp, self.out = tok, done, wp, out
        self.key = None  # (B, T, cache mode, dtype) of a kept state
        self.graph = None

    @classmethod
    def alloc(cls, model: Decoder, B: int, T: int, dtype, mode: Optional[str]) -> "DecodeState":
        """Zeroed static buffers of B rows over a cache of T positions."""
        dev = model.final_ln.device

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        st = cls(*_new_cache(model, B, T, dtype, mode), zeros((B, T), torch.bool),
                 zeros((B,), torch.long), zeros((B,), torch.long), zeros((B,), torch.bool),
                 zeros((1,), torch.long), zeros((B, T), torch.long))
        st.key = (B, T, mode, dtype)
        return st

    def nbytes(self) -> int:
        parts = (self.kc, self.vc, self.kmask, self.pos, self.tok, self.done, self.wp, self.out)
        return sum(x.numel() * x.element_size()
                   for p in parts for x in ((p,) if isinstance(p, torch.Tensor) else p))

    def load(self, tok, cache, done: Optional[torch.Tensor]) -> None:
        """Copy a chunk's inputs into the buffers; those that are already
        the state's own (the previous chunk's outputs) stay. The cache halves
        must be the state's own: a prefill filled them."""
        kc, vc, kmask, pos = cache
        if kc is not self.kc or vc is not self.vc:
            raise ValueError("decode state: the cache is not the state's own buffers")
        for dst, src in ((self.kmask, kmask), (self.pos, pos), (self.tok, tok)):
            if src is not dst:
                dst.copy_(src)
        if done is None:
            self.done.zero_()
        elif done is not self.done:
            self.done.copy_(done)

    def capture(self, model: Decoder, eos_id: int) -> None:
        """Capture one greedy step over the buffers in a CUDA graph
        (:func:`_capture_step`, after one eager warm-up step over a full key
        mask). Both steps write the buffers, so capture before a prefill
        fills them."""
        dtype = _act_dtype(model)
        with span("decode.capture"):
            self.kmask.fill_(True)
            self.graph = _capture_step(lambda: _decode_step(model, self, eos_id, dtype),
                                       self.kmask.device)


def _capture_step(step, dev) -> "torch.cuda.CUDAGraph":
    """``step`` run once eagerly on a side stream, where lazy set-up, cuBLAS's
    workspace and B8's shared-memory attribute happen, then captured on that
    stream in a CUDA graph."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        step()
    return graph


def _decode_step(model: Decoder, st: DecodeState, eos_id: int, dtype,
                 temperature: float = 0.0, key: Optional[int] = None) -> None:
    """One decode step on ``st``, in place: the token forward (each layer
    with its own key mask and RoPE table, :func:`_step_inputs`; the rows not
    ``done`` are the live ones that routed-expert layers count), the cache
    append and the key-mask bit at ``wp``, the pick, the emitted token (pad
    once the row is done) into ``out`` at ``wp``; then ``done``, the next
    token, ``pos`` and ``wp`` advance. No value comes back to the host, so the
    same ops run eagerly or captured in a CUDA graph."""
    logits, k_new, v_new = _decode_token_forward(
        model, st.tok, st.kc, st.vc, *_step_inputs(model, st.kmask, st.pos, dtype),
        model.routing(done=st.done))
    _cache_put(st.kc, k_new[:, :, :, None, :], st.wp)
    _cache_put(st.vc, v_new[:, :, :, None, :], st.wp)
    st.kmask.index_fill_(1, st.wp, True)
    nxt = _pick(logits, temperature, key)
    pad = torch.full_like(st.tok, model.cfg.pad_token_id)
    st.out.index_copy_(1, st.wp, torch.where(st.done, pad, st.tok)[:, None])
    done = st.done | (st.tok == eos_id)
    st.tok.copy_(torch.where(done, st.tok, nxt))
    st.done.copy_(done)
    st.pos.add_(1)
    st.wp.add_(1)


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
    state: Optional[DecodeState] = None,  # the engine's static buffers, cache included
    replay: bool = False,  # replay ``state``'s captured step once a step
):
    """Generate ``steps`` tokens, writing cache positions prompt_len + offset
    on. Returns (tokens [B, steps], (next token, cache, done)); the cache is
    updated in place. Step t emits the token it consumes (pad once the row
    is done) and picks the next; a row is done after it emits EOS.

    Each step is :func:`_decode_step` on a :class:`DecodeState`: ``state``
    (whose cache halves ``cache`` must be) or one over the arguments. With
    ``replay`` (for a chunk that :func:`graph_wanted`, on a ``state`` whose
    graph was captured with ``eos_id``) each step is one replay of the
    captured step; else the steps run eagerly."""
    k_cache, v_cache, kmask, pos = cache
    B = first_token.shape[0]
    T = kmask.shape[1]
    dev = first_token.device
    if state is None:
        st = DecodeState(k_cache, v_cache, kmask, pos.clone(), first_token.clone(),
                         torch.zeros((B,), dtype=torch.bool, device=dev) if done is None
                         else done.clone(), torch.zeros((1,), dtype=torch.long, device=dev),
                         first_token.new_zeros((B, T)))
    else:
        st = state
        st.load(first_token, cache, done)
    a = prompt_len + offset
    st.wp.fill_(a)
    if replay:
        for _ in range(steps):
            with span("decode.step"):
                st.graph.replay()
    else:
        dtype = _act_dtype(model)
        for i in range(steps):
            with span("decode.step"):
                _decode_step(model, st, eos_id, dtype, temperature,
                             None if key is None else _fold(key, offset + i))
    # ``done`` is copied: a caller may read it after enqueueing the next
    # chunk, which advances the state's own.
    return st.out[:, a:a + steps], (st.tok, (k_cache, v_cache, st.kmask, st.pos),
                                    st.done.clone())


def decoder_greedy_decode(model: Decoder, first_token: torch.Tensor, cache,
                          prompt_len: int, max_new_tokens: int, eos_id: int) -> torch.Tensor:
    """Continue greedy generation from a prefilled cache; returns [B,
    max_new_tokens] including the first token (pad after EOS)."""
    out, _ = decoder_decode_chunk(model, first_token, cache, prompt_len, 0,
                                  max_new_tokens, eos_id)
    return out


def _window_mask(kmask: torch.Tensor, pos: torch.Tensor, win: Optional[int]) -> torch.Tensor:
    """The decode step's key mask: ``kmask``, less the keys a sliding window
    or more behind ``pos`` (padding is contiguous per region and appended
    slots turn valid in order, so the running count of valid slots gives
    each slot's RoPE position)."""
    if win is None:
        return kmask
    slot_pos = torch.cumsum(kmask.long(), dim=1) - 1
    return kmask & (pos[:, None] - slot_pos < win)


# ---------------------------------------------------------------------------
# Slot refill (continuous batching)
# ---------------------------------------------------------------------------
def decoder_decode_chunk_rr(
    model: Decoder,
    first_token: torch.Tensor,  # [B] next token to consume per slot
    cache,
    wp: torch.Tensor,  # [B] per-row cache write position
    prompt_len: int,  # the session's prompt area (a row's wp starts there)
    max_new_tokens: int,  # per-row budget, counted from the row's wp - P
    steps: int,
    eos_id: int,
    done: torch.Tensor,  # [B]
    temperature: float = 0.0,
    key: Optional[int] = None,  # sampling seed; step i samples with _fold(key, step0 + i)
    step0: int = 0,
):
    """Decode chunk of a slot-refill session: each row appends its K/V at
    its own ``wp``, so a slot refilled at a later chunk boundary decodes
    beside older rows, with a full budget counted from its own prompt end
    and frozen on the device once that is spent. A row's tokens depend only
    on its own cache row, key mask and RoPE position, so with a uniform
    ``wp`` this is :func:`decoder_decode_chunk`. The cache is updated in
    place. Returns (tokens [B, steps], (next token, cache, wp, done))."""
    k_cache, v_cache, kmask, pos = cache
    pad = model.cfg.pad_token_id
    dtype = _act_dtype(model)
    tok, outs = first_token, []
    for i in range(steps):
        with span("decode.step"):
            live = ~done & (wp - prompt_len < max_new_tokens)
            logits, k_new, v_new = _decode_token_forward(
                model, tok, k_cache, v_cache, *_step_inputs(model, kmask, pos, dtype),
                model.routing(done=~live) if model.cfg.has_experts else None)
            nxt = _pick(logits, temperature, None if key is None else _fold(key, step0 + i))
            outs.append(torch.where(live, tok, torch.full_like(tok, pad)))
            # Frozen rows overwrite their one unused slot with a value their
            # mask never shows (the mask bit written is False); a row whose
            # budget is spent has wp == T, and the write clamps to T - 1, a
            # slot only that frozen row could read.
            _cache_row_put(k_cache, k_new[:, :, :, None, :], wp)
            _cache_row_put(v_cache, v_new[:, :, :, None, :], wp)
            _row_append(kmask, live[:, None], wp)
            done = done | (live & (tok == eos_id))
            tok = torch.where(live & ~done, nxt, tok)
            adv = live.to(wp.dtype)
            pos, wp = pos + adv, wp + adv
    out = torch.stack(outs, dim=1) if outs else first_token.new_zeros((first_token.shape[0], 0))
    return out, (tok, (k_cache, v_cache, kmask, pos), wp, done)


def _rr_scatter(cache, tok, wp, done, new_cache, new_tok, slots):
    """Scatter freshly prefilled rows into a session's state at ``slots``
    (a host sequence; a slot out of range marks a padding row and is
    dropped), in place. ``new_cache`` is an unpadded cache tuple whose T
    axis is the new rows' prompt length P: only [:P] of a slot is
    rewritten, and the previous occupant's K/V behind it stay, hidden by the
    key mask. Refilled rows restart at wp = P with their own RoPE
    position. Returns (tok, cache, wp, done)."""
    k_cache, v_cache, kmask, pos = cache
    nkc, nvc, nkmask, npos = new_cache
    B = kmask.shape[0]
    P = nkmask.shape[1]
    rows, dst = _slot_rows(slots, B, kmask.device)
    if rows.numel():
        for buf, new in ((k_cache, nkc), (v_cache, nvc)):
            pairs = zip(buf, new) if isinstance(buf, tuple) else ((buf, new),)
            for b, x in pairs:
                b[:, dst, :, :P] = x.index_select(1, rows).to(b.dtype)
        kmask[dst] = False
        kmask[dst, :P] = nkmask.bool().index_select(0, rows)
        pos[dst] = npos.index_select(0, rows).to(pos.dtype)
        tok[dst] = new_tok.index_select(0, rows).to(tok.dtype)
        wp[dst] = P
        done[dst] = False
    return tok, (k_cache, v_cache, kmask, pos), wp, done


def decoder_refill_slots(
    model: Decoder,
    cache,
    tok: torch.Tensor,
    wp: torch.Tensor,
    done: torch.Tensor,
    ids: torch.Tensor,  # [Br, P] left-padded to the session's prompt length
    mask: torch.Tensor,  # [Br, P]
    slots,  # [Br] session slot per row, host ints; out of range = padding
    temperature: float = 0.0,
    key: Optional[int] = None,
):
    """Prefill pending prompts and scatter them into a decode session: the
    session's cache keeps its shape and only the freed rows' contents are
    replaced. The new K/V stay at prompt length until the scatter (no
    P + max_new cache for the refill batch). Returns (tok, cache, wp, done)
    with the refilled slots live."""
    h, ks, vs, pos = prefill_layers(model, ids, mask)
    first = _pick(model.lm_logits(h[:, -1, :]), temperature, key)  # left-padded
    mode = cache_mode(cache[0])
    nkc, nvc = (ks, vs) if mode is None else (_kv_pack(ks, mode), _kv_pack(vs, mode))
    return _rr_scatter(cache, tok, wp, done, (nkc, nvc, mask, pos[:, -1] + 1), first, slots)


def decoder_refill_slots_pre(
    model: Decoder,
    cache,
    tok: torch.Tensor,
    wp: torch.Tensor,
    done: torch.Tensor,
    ks: torch.Tensor,  # [Ld, G, KV, Lp, Dh] the session's prefix K/V
    vs: torch.Tensor,
    pmask: torch.Tensor,  # [G, Lp]
    gidx: torch.Tensor,  # [Br] group per row
    sids: torch.Tensor,  # [Br, Ls] right-padded suffixes; Lp + Ls == P
    smask: torch.Tensor,
    slots,  # [Br] host ints
    temperature: float = 0.0,
    key: Optional[int] = None,
):
    """Refill from the session's prefix K/V: only the suffix tokens run a
    forward. The scattered rows have the shared-prefix layout (prefix, hole,
    suffix), beside left-padded rows of the same session: every row is
    described by its own key mask and RoPE position."""
    last_h, new_cache = decoder_shared_prefill(
        model, ks.index_select(1, gidx), vs.index_select(1, gidx),
        pmask.index_select(0, gidx), sids, smask, 0, kv_quant=cache_mode(cache[0]))
    first = _pick(model.lm_logits(last_h), temperature, key)
    return _rr_scatter(cache, tok, wp, done, new_cache, first, slots)


def decoder_refill_slots_shared(
    model: Decoder,
    cache,
    tok: torch.Tensor,
    wp: torch.Tensor,
    done: torch.Tensor,
    pids: torch.Tensor,  # [G, Lp] right-padded unique prefixes
    pmask: torch.Tensor,
    gidx: torch.Tensor,  # [Br]
    sids: torch.Tensor,  # [Br, Ls]; Lp + Ls == P
    smask: torch.Tensor,
    slots,  # [Br] host ints
    temperature: float = 0.0,
    key: Optional[int] = None,
):
    """:func:`decoder_refill_slots_pre` on prefixes of the refill batch's
    own: the unique prefixes run once, rows gather their group's K/V."""
    ks, vs = decoder_prefix_kv(model, pids, pmask)
    return decoder_refill_slots_pre(model, cache, tok, wp, done, ks, vs, pmask, gidx, sids,
                                    smask, slots, temperature=temperature, key=key)


def scatter_rows(buf: torch.Tensor, new: torch.Tensor, slots) -> None:
    """``buf[slots[j]] = new[j]`` in place for the slots in range (a padding
    row's out-of-range slot is dropped)."""
    rows, dst = _slot_rows(slots, buf.shape[0], buf.device)
    if rows.numel():
        buf[dst] = new.index_select(0, rows).to(buf.dtype)


# ---------------------------------------------------------------------------
# Prompt-lookup speculative decoding
# ---------------------------------------------------------------------------
def _shift(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """``x`` [B, T] moved n positions right along T, ``fill`` in front."""
    return torch.cat([torch.full_like(x[:, :n], fill), x[:, :-n]], dim=1)


def _verify_attention(q, k, v, kcl: Cache, vcl: Cache, amask, tri, scale: float,
                      mode: Optional[str]) -> torch.Tensor:
    """Attention of the S-token verify block, [B, H, S, Dh] in q's dtype:
    over the read-only cache (masked by ``amask``), over the block's earlier
    positions (strictly below the diagonal, ``tri``) and each token's own
    K/V as a separate term. Under a quantized cache the earlier positions
    go through the cache's quantizer, as a step-by-step decode would have
    read them back, and the self term stays unquantized, as in that decode.
    This is plain PyTorch over the cache: the JAX verify is XLA einsums, and
    the B8 kernel attends one query token, not a block."""
    B, H, S, Dh = q.shape
    KV = k.shape[1]
    dtype = q.dtype
    qg = q.reshape(B, KV, H // KV, S, Dh)
    s_c = cached_qk(qg, kcl, dtype, mode, "bkgsd,bktd->bkgst") * scale
    s_c = s_c.masked_fill(~amask, NEG_INF)
    kb, vb = (_kv_pack(k, mode), _kv_pack(v, mode)) if mode else (k, v)
    s_b = cached_qk(qg, kb, dtype, mode, "bkgsd,bkud->bkgsu") * scale
    s_b = s_b.masked_fill(~tri, NEG_INF)
    s_self = _dot("bkgsd,bksd->bkgs", qg, k) * scale
    m = torch.maximum(torch.maximum(s_c.amax(dim=-1), s_b.amax(dim=-1)), s_self)
    p_c = torch.exp(s_c - m[..., None])
    p_b = torch.exp(s_b - m[..., None])
    p_self = torch.exp(s_self - m)
    z = p_c.sum(dim=-1) + p_b.sum(dim=-1) + p_self
    a = (cached_pv(p_c, vcl, dtype, mode, "bkgst,bktd->bkgsd")
         + cached_pv(p_b, vb, dtype, mode, "bkgsu,bkud->bkgsd")
         + p_self[..., None] * v.float()[:, :, None]) / z[..., None]
    return a.to(dtype).reshape(B, H, S, Dh)


def decoder_spec_decode_chunk(
    model: Decoder,
    first_token: torch.Tensor,  # [B] pending token (greedy, not yet consumed)
    cache,
    hist: torch.Tensor,  # [B, T] token history laid out like the cache
    wp: torch.Tensor,  # [B] per-row cache write position
    prompt_len: int,
    max_new_tokens: int,  # per-row budget (frozen past it)
    rounds: int,
    K: int,  # draft length per round
    eos_id: int,
    done: Optional[torch.Tensor] = None,
):
    """``rounds`` rounds of prompt-lookup speculative decoding.

    Each round drafts K tokens from the last trigram match (else bigram) of
    the row's last tokens in its own valid history, then verifies the
    pending token and the drafts in one (K+1)-token forward against the
    read-only cache. Greedy acceptance keeps the tokens those of the
    step-by-step decode whatever the drafts: every emitted token is the
    model's argmax, and the drafts only decide how many one forward yields
    (1 to K+1). Rows accept different counts: each writes its block at its
    own ``wp`` (clamped as :func:`_row_append`), and only the consumed part
    is marked valid; the rest is overwritten by the next round's block, so
    the cache needs 2(K+1) slots of slack past ``prompt_len +
    max_new_tokens``. Caches and history are updated in place.

    Returns (tokens [B, rounds, K+1], counts [B, rounds], (next token,
    cache, hist, wp, done))."""
    k_cache, v_cache, kmask, pos = cache
    cfg = model.cfg
    B = first_token.shape[0]
    S = K + 1
    T = kmask.shape[1]
    dev = kmask.device
    pad = cfg.pad_token_id
    L = prompt_len
    mode = cache_mode(k_cache)
    scale = cfg.head_dim_**-0.5
    if done is None:
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
    pos_idx = torch.arange(T, device=dev)[None, :]
    idxS = torch.arange(S, device=dev)[None, :]
    # Strictly below the diagonal: each token's own K/V is the separate
    # unquantized self term of _verify_attention.
    rel = torch.arange(S, device=dev)[:, None] - torch.arange(S, device=dev)[None, :]
    tri0 = rel > 0
    wins = [_win(model, T, i) for i in range(cfg.num_hidden_layers)]
    tris = {w: tri0 & (rel < w) if w is not None and w < S else tri0 for w in set(wins)}
    tok, outs, counts = first_token, [], []
    for _ in range(rounds):
        with span("decode.step"):
            frozen = done | (wp - L >= max_new_tokens)
            # -- draft: the last match of the row's last two (three) tokens --
            p_prev = torch.where(kmask, pos_idx, -1).amax(dim=1)
            prev = hist.gather(1, p_prev.clamp_min(0)[:, None])[:, 0]
            prev = torch.where(p_prev >= 0, prev, -1)
            before = pos_idx < p_prev[:, None]
            # The last valid position is excluded: a match there is the current
            # context itself, whose continuation is not generated yet.
            match = ((hist == tok[:, None]) & (_shift(hist, 1, -1) == prev[:, None])
                     & kmask & _shift(kmask, 1, False) & before)
            p_prev2 = torch.where(kmask & before, pos_idx, -1).amax(dim=1)
            prev2 = hist.gather(1, p_prev2.clamp_min(0)[:, None])[:, 0]
            prev2 = torch.where(p_prev2 >= 0, prev2, -2)
            match3 = match & (_shift(hist, 2, -1) == prev2[:, None]) & _shift(kmask, 2, False)
            p2 = torch.where(match, pos_idx, -1).amax(dim=1)
            p3 = torch.where(match3, pos_idx, -1).amax(dim=1)
            p_best = torch.where(p3 >= 0, p3, p2)
            didx = (p_best[:, None] + 1 + torch.arange(K, device=dev)[None, :]).clamp_max(T - 1)
            dvalid = kmask.gather(1, didx) & (p_best >= 0)[:, None]
            drafts = torch.where(dvalid, hist.gather(1, didx), pad).to(tok.dtype)
            bt = torch.cat([tok[:, None], drafts], dim=1)  # [B, S]

            # -- verify: one S-token forward against the read-only cache --
            x = model.embed_rows(bt)
            poss = pos[:, None] + idxS
            ropes = model.ropes(poss, x.dtype)
            slot_pos = torch.cumsum(kmask.long(), dim=1) - 1
            amasks = {w: (kmask[:, None, :]
                          & (poss[:, :, None] - slot_pos[:, None, :] < w))[:, None, None]
                      if w is not None else kmask[:, None, None, None, :] for w in set(wins)}
            routing = model.routing(n=bt.numel())
            k_rows, v_rows = [], []
            for i, lp in enumerate(model.layers):
                kcl, vcl = _layer(k_cache, i), _layer(v_cache, i)
                amask, tri = amasks[wins[i]], tris[wins[i]]

                def attend(q, k, v):
                    return _verify_attention(q, k, v, kcl, vcl, amask, tri, scale, mode)

                x, k, v = model.layer(lp, x, *ropes[i], attend, routing)
                k_rows.append(k)
                v_rows.append(v)
            h = rms_norm(x, model.final_ln, cfg.rms_norm_eps)
            nxt = torch.argmax(model.lm_logits(h), dim=-1).to(tok.dtype)  # [B, S]

            # -- greedy acceptance --
            flags = torch.cumprod((bt[:, 1:] == nxt[:, :-1]).int(), dim=1)
            acc = flags.sum(dim=1)
            is_eos = (bt == eos_id) & (idxS <= acc[:, None])
            any_eos = is_eos.any(dim=1) & ~frozen
            first_eos = torch.argmax(is_eos.int(), dim=1)  # the first maximum
            c = torch.where(any_eos, first_eos + 1, acc + 1)
            c = torch.where(frozen, torch.zeros_like(c), c)
            outs.append(torch.where(idxS < c[:, None], bt, torch.full_like(bt, pad)))
            counts.append(c)
            bonus = nxt.gather(1, (c - 1).clamp_min(0)[:, None])[:, 0]
            tok = torch.where(frozen, tok, torch.where(any_eos, torch.full_like(tok, eos_id), bonus))
            done = done | any_eos

            # -- append the block at each row's own position --
            _cache_row_put(k_cache, torch.stack(k_rows), wp)
            _cache_row_put(v_cache, torch.stack(v_rows), wp)
            _row_append(hist, bt.to(hist.dtype), wp)
            _row_append(kmask, idxS < c[:, None], wp)
            c = c.to(wp.dtype)
            pos, wp = pos + c, wp + c
    return (torch.stack(outs, dim=1), torch.stack(counts, dim=1),
            (tok, (k_cache, v_cache, kmask, pos), hist, wp, done))
