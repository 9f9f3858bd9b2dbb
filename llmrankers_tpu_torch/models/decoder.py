"""Decoder-only transformer (Llama / Qwen2 / Qwen3 / Mistral) as an ``nn.Module``.

Counterpart of ``llmrankers_tpu/models/decoder.py``, with its parameter names
and its ``[in, out]`` weight layout (every projection is ``x @ w``): ``embed``,
``layers.{ln1, wq, wk, wv, bq, bk, bv, q_norm, k_norm, wo, ln2, w_gate, w_up,
w_down}``, ``final_ln`` and, untied, ``lm_head``. One ``nn.ParameterDict``
per layer holds what the JAX pytree stacks on a leading ``[L, ...]`` axis.
RoPE, RMSNorm with fp32 statistics, GQA, SwiGLU; optional qkv bias (Qwen2),
q/k head norm (Qwen3) and a sliding window (Mistral).

Left-padding aware: positions derive from the attention mask, so a
left-padded batch scores as its unpadded rows would. Attention goes through
:func:`..ops.attention.mha`, which runs the hand-written flash kernel
(:func:`..ops.flash.flash_mha`, GQA-native, its plain version on CPU tensors)
when ``use_flash`` is set and Lq >= 128, and the plain path otherwise.

Every matmul site goes through :func:`.quant.qmm` (the FFN through
:func:`.quant.swiglu_ffn`), so one module holds any quantization state: float
weights (``torch.matmul``); int8 ``[K, N]`` with ``<name>_scale``; packed
int4 ``[K/2, N]`` with ``<name>_scale4``; and an int8 head (``embed`` with
``embed_scale`` [V, 1] when tied, else ``lm_head`` with ``lm_head_scale``
[1, V]). ``quant`` names the quantized leaves' shapes and dtypes
(:func:`.quant.decoder_quant_specs`). With ``cfg.qkernels`` the quantized
sites run the W8A8 and W4A8 kernels by the JAX rule; ``plain_kernels``
routes them to the kernels' plain versions instead, on any device, to hold
the kernels against them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.attention import apply_rope, mha, rms_norm, rope_cos_sin
from .config import DecoderConfig
from .quant import (SCALE4_SUFFIX, SCALE_SUFFIX, _matmul, embed_rows, kmajor_leaves, qmm,
                    swiglu_ffn)
from ..utils.device import resolve_device
from .t5 import _empty, _fill

HEAD_LEAVES = ("embed", "embed_scale", "lm_head", "lm_head_scale")

# attend(q [B, H, L, Dh], k [B, KV, L, Dh], v) -> [B, H, L, Dh]
Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def positions_from_mask(attn_mask: torch.Tensor) -> torch.Tensor:
    """[B, L] {0,1} -> position ids, 0-based from the first real token."""
    return torch.clamp(torch.cumsum(attn_mask.long(), dim=-1) - 1, min=0)


def _layer_shapes(cfg: DecoderConfig) -> Dict[str, Tuple[int, ...]]:
    D, Fd = cfg.hidden_size, cfg.intermediate_size
    H, KV, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    shapes: Dict[str, Tuple[int, ...]] = {
        "ln1": (D,), "ln2": (D,),
        "wq": (D, H * Dh), "wk": (D, KV * Dh), "wv": (D, KV * Dh),
        "wo": (H * Dh, D),
        "w_gate": (D, Fd), "w_up": (D, Fd), "w_down": (Fd, D),
    }
    if cfg.attention_bias:
        shapes.update(bq=(H * Dh,), bk=(KV * Dh,), bv=(KV * Dh,))
    if cfg.qk_norm:
        shapes.update(q_norm=(Dh,), k_norm=(Dh,))
    return shapes


Quant = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


class Decoder(nn.Module):
    """A decoder-only LM for scoring: ``forward_hidden``, ``label_logits``.

    Runs on ``device`` (the card unless the caller asks for another; with no
    GPU the default raises). ``quant``: the quantized leaves, name -> (shape,
    dtype); every other leaf is float in ``dtype``."""

    def __init__(self, cfg: DecoderConfig, dtype=torch.float32, device="cuda",
                 use_flash: bool = False, quant: Optional[Quant] = None):
        super().__init__()
        device = resolve_device(device)
        quant = dict(quant or {})
        self.cfg = cfg
        self.use_flash = use_flash
        self.plain_kernels = False  # kernel sites call the plain versions

        # the GEMMs' K-major leaves (models/quant.py); the int8 head stays row-major
        kmajor = kmajor_leaves({k: v for k, v in quant.items() if k not in HEAD_LEAVES})

        def leaf(name, shape):
            shape, dt = quant.get(name, (shape, dtype))
            return _empty(shape, dt, device, name in kmajor)

        D, V = cfg.hidden_size, cfg.vocab_size
        self.embed = leaf("embed", (V, D))
        self.embed_scale = leaf("embed_scale", None) if "embed_scale" in quant else None
        shapes = _layer_shapes(cfg)
        shapes.update({k: s for k, (s, _) in quant.items()
                       if k.endswith((SCALE_SUFFIX, SCALE4_SUFFIX)) and k not in HEAD_LEAVES})
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: leaf(k, s) for k, s in shapes.items()})
            for _ in range(cfg.num_hidden_layers)
        )
        self.final_ln = _empty((D,), dtype, device)
        self.lm_head = None if cfg.tie_word_embeddings else leaf("lm_head", (D, V))
        self.lm_head_scale = (leaf("lm_head_scale", None) if "lm_head_scale" in quant
                              else None)

    # -- blocks ------------------------------------------------------------
    def rope(self, positions: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        return rope_cos_sin(positions, self.cfg.head_dim_, self.cfg.rope_theta, dtype)

    def layer(self, lp, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
              attend: Attend) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One block on ``h`` [B, L, D]: returns the new ``h`` and this block's
        post-RoPE K/V [B, KV, L, Dh]. ``attend`` runs the attention, so the
        prefix-sharing prefill can put prefix K/V before the block's own."""
        cfg = self.cfg
        B, L, _ = h.shape
        H, KV, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
        eps = cfg.rms_norm_eps
        kern, plain = cfg.qkernels, self.plain_kernels
        hn = rms_norm(h, lp["ln1"], eps)
        q, k, v = (qmm(lp, name, hn, kern, plain) for name in ("wq", "wk", "wv"))
        if cfg.attention_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = q.view(B, L, H, Dh).transpose(1, 2)
        k = k.view(B, L, KV, Dh).transpose(1, 2)
        v = v.view(B, L, KV, Dh).transpose(1, 2)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"], eps)
            k = rms_norm(k, lp["k_norm"], eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        a = attend(q, k, v).transpose(1, 2).reshape(B, L, H * Dh)
        h = h + qmm(lp, "wo", a, kern, plain)
        hn = rms_norm(h, lp["ln2"], eps)
        h = h + swiglu_ffn(lp, hn, kern, plain)
        return h, k, v

    def embed_rows(self, ids: torch.Tensor) -> torch.Tensor:
        return embed_rows(self, ids)

    def attention(self, q, k, v, **kw) -> torch.Tensor:
        """Causal attention at the model's scale, flash when ``use_flash``."""
        return mha(q, k, v, causal=True, scale=self.cfg.head_dim_**-0.5,
                   use_flash=self.use_flash, **kw)

    # -- forwards ------------------------------------------------------------
    def forward_hidden(self, input_ids: torch.Tensor, attn_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (final hidden states [B, L, D], positions [B, L])."""
        cfg = self.cfg
        L = input_ids.shape[1]
        x = self.embed_rows(input_ids)
        pos = positions_from_mask(attn_mask)
        cos, sin = self.rope(pos, x.dtype)
        # Sliding window: index-space masking is exact here because the
        # batch is contiguously left-padded; a no-op when the block fits.
        win = cfg.sliding_window
        win = win if (win is not None and L > win) else None

        def attend(q, k, v):
            return self.attention(q, k, v, kv_mask=attn_mask, window=win)

        for lp in self.layers:
            x, _, _ = self.layer(lp, x, cos, sin, attend)
        return rms_norm(x, self.final_ln, cfg.rms_norm_eps), pos

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Full-vocabulary logits; an int8 head multiplies the int8 bytes in
        the scale's dtype and applies the per-token scale to the logits."""
        if self.cfg.tie_word_embeddings:
            w, s = self.embed, self.embed_scale
            if s is None:
                return hidden @ w.T
            return _matmul(hidden, w.T.to(s.dtype)) * s.T
        w, s = self.lm_head, self.lm_head_scale
        if s is None:
            return hidden @ w
        return _matmul(hidden, w.to(s.dtype)) * s

    def label_logits(self, hidden: torch.Tensor, label_ids: torch.Tensor) -> torch.Tensor:
        """Logits of only the given label token ids: a [D, K] product
        instead of the full [D, V] vocabulary projection."""
        if self.cfg.tie_word_embeddings:
            return _matmul(hidden, self.embed_rows(label_ids).T)
        w, s = self.lm_head[:, label_ids], self.lm_head_scale
        if s is not None:  # dequantized in the product's dtype, as wmat
            dt = torch.promote_types(hidden.dtype, s.dtype)
            w = w.to(dt) * s[:, label_ids].to(dt)
        return _matmul(hidden, w)

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """Causal LM forward -> logits [B, L, V]."""
        hidden, _ = self.forward_hidden(input_ids, attn_mask)
        return self.lm_logits(hidden)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------
def _quantized_leaf(name: str, leaf: Any) -> bool:
    return (np.asarray(leaf).dtype == np.int8
            or name.endswith((SCALE_SUFFIX, SCALE4_SUFFIX)))


def _torch_dtype(leaf: Any) -> torch.dtype:
    """The torch dtype of a numpy leaf (JAX's bfloat16 included)."""
    name = np.asarray(leaf).dtype.name
    return torch.bfloat16 if name == "bfloat16" else getattr(torch, name)


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], cfg: DecoderConfig, dtype=torch.float32,
                    device="cuda") -> Decoder:
    """The port's module from a ``llmrankers_tpu.models.decoder`` parameter
    tree (leaves as numpy arrays; per-layer leaves stacked on [L]). A tree
    from the JAX ``quantize_decoder_params`` or
    ``quantize_decoder_params_int4`` loads into a quantized module: its int8
    and packed int4 leaves and their scales keep their dtype; float leaves
    take ``dtype``."""
    quant = {k: (tuple(np.shape(v)), _torch_dtype(v)) for k, v in tree.items()
             if k in HEAD_LEAVES and _quantized_leaf(k, v)}
    quant.update({k: (tuple(np.shape(v))[1:], _torch_dtype(v))
                  for k, v in tree["layers"].items() if _quantized_leaf(k, v)})
    model = Decoder(cfg, dtype=dtype, device=device, quant=quant)
    for name in HEAD_LEAVES + ("final_ln",):
        if getattr(model, name, None) is not None:
            _fill(getattr(model, name), tree[name], name)
    want = set(model.layers[0].keys())
    if set(tree["layers"]) != want:
        raise ValueError(f"layer leaves {sorted(tree['layers'])} != {sorted(want)}")
    for key in want:
        leaf = np.asarray(tree["layers"][key], dtype=np.float32)
        if leaf.shape[0] != len(model.layers):
            raise ValueError(f"{key}: {leaf.shape[0]} layers, config has "
                             f"{len(model.layers)}")
        for i, lp in enumerate(model.layers):
            _fill(lp[key], leaf[i], f"{key}[{i}]")
    return model


@torch.no_grad()
def init_params(cfg: DecoderConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Decoder:
    """Random init with the JAX ``init_params`` scales (fan-in for the
    projections, 0.02 for the embedding, ones for norms, zeros for qkv
    biases), drawn on ``device`` from ``generator`` (which must live there).
    The card unless the caller asks for another device; with no GPU the
    default raises."""
    model = Decoder(cfg, dtype=dtype, device=device)

    def nrm(p: nn.Parameter, scale: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=device) * scale)

    nrm(model.embed, 0.02)
    model.final_ln.fill_(1.0)
    if model.lm_head is not None:
        nrm(model.lm_head, cfg.hidden_size**-0.5)
    for lp in model.layers:
        for key, p in lp.items():
            if key.startswith("ln") or key.endswith("_norm"):
                p.fill_(1.0)
            elif key.startswith("b"):
                p.zero_()
            else:
                nrm(p, p.shape[0] ** -0.5)
    return model
