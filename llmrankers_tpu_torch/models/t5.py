"""T5 encoder-decoder (flan-t5 / t5-v1.1 / t5-v1.0) as an ``nn.Module``.

Counterpart of ``llmrankers_tpu/models/t5.py``, with its parameter names and
its ``[in, out]`` weight layout (every projection is ``x @ w``). One
``nn.ParameterDict`` per layer holds what the JAX pytree stacks on a leading
``[L, ...]`` axis. The architecture notes of the JAX module hold here too: RMS
norm with fp32 statistics, no attention-score scaling, no embedding scaling,
one relative-position bias per stack computed from its block-0 table, gated
gelu_new FFN for v1.1/flan, untied lm_head for v1.1/flan.

In bf16 the GEMMs are ``torch.matmul``. Encoder self-attention goes through
the flash kernel (:func:`..ops.flash.flash_mha_blhd`, which takes its plain
version on CPU tensors) at every length when ``use_flash`` is set; the
decoder's short self- and cross-attention stay on the plain path, as in JAX.

A quantized model (``quantized=True``, made by
:func:`.quant.quantize_t5_params`) holds int8 ``[K, N]`` weights and f32
``[1, N]`` scales under the packed names of ``quant.T5_PACKS``. A matmul
site whose weight dims are multiples of 128 and whose M = B*L is at least
1024 runs the W8A8 kernels (``quantized_matmul``;
``gated_matmul`` for the packed FFN), and the encoder's self-attention reads
q/k/v straight out of the packed qkv output (``flash_mha_packed``). Every
other quantized site computes ``x @ (w.to(x.dtype) * s.to(x.dtype))``, as the
JAX module does. ``plain_kernels`` routes each kernel site to the kernel's
plain version instead, on any device, to hold the kernels against it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import gelu_new, mha_flat, rms_norm
from ..ops.flash import (flash_mha_blhd, flash_mha_blhd_plain, flash_mha_packed,
                         flash_mha_packed_plain)
from ..ops.int8_matmul import (gated_matmul, gated_matmul_plain, quantized_matmul,
                               quantized_matmul_plain)
from ..utils.device import resolve_device
from .config import T5Config
from .quant import SCALE_SUFFIX, empty_leaf, int8_layer_specs, kmajor_leaves


def relative_position_bucket(
    relative_position: torch.Tensor,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """T5 bucketing of key_pos - query_pos (log-scale beyond max_exact)."""
    ret = torch.zeros_like(relative_position)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (relative_position > 0).to(ret.dtype) * num_buckets
        rel = relative_position.abs()
    else:
        rel = -torch.clamp(relative_position, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_if_large = max_exact + (
        torch.log(rel.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(rel.dtype)
    rel_if_large = torch.clamp(rel_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, rel, rel_if_large)


def compute_bias(
    rel_bias_table: torch.Tensor,  # [num_buckets, H]
    q_len: int,
    k_len: int,
    bidirectional: bool,
    cfg: T5Config,
    q_offset: int = 0,
) -> torch.Tensor:
    """[1, H, q_len, k_len] additive attention bias, contiguous."""
    dev = rel_bias_table.device
    ctx = torch.arange(q_len, device=dev)[:, None] + q_offset
    mem = torch.arange(k_len, device=dev)[None, :]
    buckets = relative_position_bucket(
        mem - ctx, bidirectional, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance,
    )
    return rel_bias_table[buckets].permute(2, 0, 1)[None].contiguous()


def _layer_shapes(cfg: T5Config, decoder: bool) -> Dict[str, Tuple[int, ...]]:
    D, I, Fd = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    attn = {"q": (D, I), "k": (D, I), "v": (D, I), "o": (I, D)}
    shapes: Dict[str, Tuple[int, ...]] = {"ln1": (D,), "ln2": (D,)}
    if decoder:
        shapes["ln3"] = (D,)
    shapes.update(attn)
    if decoder:
        shapes.update({"c" + k: s for k, s in attn.items()})
    if cfg.is_gated:
        shapes.update({"wi_0": (D, Fd), "wi_1": (D, Fd), "wo": (Fd, D)})
    else:
        shapes.update({"wi": (D, Fd), "wo": (Fd, D)})
    return shapes


def _empty(shape, dtype, device, kmajor: bool = False) -> nn.Parameter:
    return nn.Parameter(empty_leaf(shape, dtype, device, kmajor), requires_grad=False)


class T5Stack(nn.Module):
    """One encoder or decoder stack: relative-bias table, layers, final norm."""

    def __init__(self, cfg: T5Config, decoder: bool, dtype, device,
                 quantized: bool = False):
        super().__init__()
        n = cfg.num_decoder_layers if decoder else cfg.num_layers
        shapes = _layer_shapes(cfg, decoder)
        specs = ({k: (s, None) for k, s in shapes.items()} if not quantized else
                 int8_layer_specs(shapes, "decoder" if decoder else "encoder"))
        kmajor = kmajor_leaves(specs)  # the int8 GEMMs' leaves (models/quant.py)
        self.rel_bias = _empty(
            (cfg.relative_attention_num_buckets, cfg.num_heads), dtype, device
        )
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: _empty(s, dt or dtype, device, k in kmajor)
                              for k, (s, dt) in specs.items()})
            for _ in range(n)
        )
        self.final_ln = _empty((cfg.d_model,), dtype, device)


class T5(nn.Module):
    """flan-t5 for scoring: ``encode``, ``decode_hidden``, ``label_logits``.

    Runs on ``device``: the card unless the caller asks for another; with no
    GPU the default raises."""

    def __init__(self, cfg: T5Config, dtype=torch.float32, device="cuda",
                 use_flash: bool = True, quantized: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.use_flash = use_flash
        self.quantized = quantized
        self.plain_kernels = False  # kernel sites call the plain versions
        self.shared = _empty((cfg.vocab_size, cfg.d_model), dtype, device)
        self.encoder = T5Stack(cfg, False, dtype, device, quantized)
        self.decoder = T5Stack(cfg, True, dtype, device, quantized)
        self.lm_head = (
            None if cfg.tie_word_embeddings
            else _empty((cfg.d_model, cfg.vocab_size), dtype, device)
        )

    # -- blocks ------------------------------------------------------------
    def _kernel_worthwhile(self, x: torch.Tensor, w: torch.Tensor) -> bool:
        """The JAX dispatch rule (``t5.py::_kernel_worthwhile``) for an int8
        site: the W8A8 kernel takes it when both dims of w are multiples of
        128 and M = B*L >= 1024; small-M sites (the 1-2 token decoder) stay
        on the dequant matmul."""
        if w.shape[0] % 128 or w.shape[1] % 128:
            return False
        return x.numel() // x.shape[-1] >= 1024

    def _mm(self, lp, name: str, x: torch.Tensor) -> torch.Tensor:
        """One matmul site, plain or int8 (a packed leaf is one site too,
        as in JAX's ``_mm_packed``): the W8A8 kernel when worthwhile, else
        the dequant matmul with both operands in x's dtype."""
        w = lp[name]
        s = lp.get(name + SCALE_SUFFIX)
        if s is None:
            return x @ w
        if self._kernel_worthwhile(x, w):
            fn = quantized_matmul_plain if self.plain_kernels else quantized_matmul
            return fn(x, w, s)
        return x @ (w.to(x.dtype) * s.to(x.dtype))

    def _self_attn(self, lp, x, kv_mask, bias, causal, flash):
        H = self.cfg.num_heads
        kw = dict(kv_mask=kv_mask, causal=causal, bias=bias, scale=1.0)
        if "qkv" in lp:  # packed int8 projection
            qkv = self._mm(lp, "qkv", x)
            if flash:
                fn = flash_mha_packed_plain if self.plain_kernels else flash_mha_packed
                out = fn(qkv, H, **kw)
            else:
                HD = qkv.shape[-1] // 3
                out = mha_flat(qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:],
                               H, **kw)
        else:
            q, k, v = (self._mm(lp, n, x) for n in ("q", "k", "v"))
            if flash:
                fn = flash_mha_blhd_plain if self.plain_kernels else flash_mha_blhd
                out = fn(q, k, v, H, **kw)
            else:
                out = mha_flat(q, k, v, H, **kw)
        return self._mm(lp, "o", out)

    def _cross_attn(self, lp, x, enc_out, enc_mask):
        if "ckv" in lp:  # packed int8 cross k|v, M = B*L
            ckv = self._mm(lp, "ckv", enc_out)
            HD = ckv.shape[-1] // 2
            k, v = ckv[..., :HD], ckv[..., HD:]
        else:
            k, v = self._mm(lp, "ck", enc_out), self._mm(lp, "cv", enc_out)
        out = mha_flat(self._mm(lp, "cq", x), k, v, self.cfg.num_heads,
                       kv_mask=enc_mask, scale=1.0)
        return self._mm(lp, "co", out)

    def _ffn(self, lp, x):
        cfg = self.cfg
        act = gelu_new if cfg.act_fn == "gelu_new" else F.relu
        if cfg.is_gated and "wi_g" in lp:  # packed int8 gate|up
            w, s = lp["wi_g"], lp["wi_g" + SCALE_SUFFIX]
            if self._kernel_worthwhile(x, w):
                fn = gated_matmul_plain if self.plain_kernels else gated_matmul
                h = fn(x, w, s, act=cfg.act_fn)
            else:
                hh = x @ (w.to(x.dtype) * s.to(x.dtype))
                n = hh.shape[-1] // 2
                h = act(hh[..., :n]) * hh[..., n:]
        elif cfg.is_gated:
            h = act(self._mm(lp, "wi_0", x)) * self._mm(lp, "wi_1", x)
        else:
            h = F.relu(self._mm(lp, "wi", x))
        return self._mm(lp, "wo", h)

    # -- forwards ------------------------------------------------------------
    def encode(self, input_ids: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """[B, L] ids + [B, L] {0,1} int32 mask -> [B, L, D]."""
        cfg, enc = self.cfg, self.encoder
        x = F.embedding(input_ids, self.shared)
        L = input_ids.shape[1]
        bias = compute_bias(enc.rel_bias, L, L, True, cfg)
        for lp in enc.layers:
            hn = rms_norm(x, lp["ln1"], cfg.layer_norm_epsilon)
            x = x + self._self_attn(lp, hn, attn_mask, bias, False, self.use_flash)
            x = x + self._ffn(lp, rms_norm(x, lp["ln2"], cfg.layer_norm_epsilon))
        return rms_norm(x, enc.final_ln, cfg.layer_norm_epsilon)

    def decode_hidden(self, decoder_input_ids: torch.Tensor, enc_out: torch.Tensor,
                      enc_mask: torch.Tensor) -> torch.Tensor:
        """Decoder forward up to the final layer norm -> hidden [B, T, D]."""
        cfg, dec = self.cfg, self.decoder
        x = F.embedding(decoder_input_ids, self.shared)
        T = decoder_input_ids.shape[1]
        self_bias = compute_bias(dec.rel_bias, T, T, False, cfg)
        eps = cfg.layer_norm_epsilon
        for lp in dec.layers:
            hn = rms_norm(x, lp["ln1"], eps)
            x = x + self._self_attn(lp, hn, None, self_bias, True, False)
            x = x + self._cross_attn(lp, rms_norm(x, lp["ln2"], eps), enc_out, enc_mask)
            x = x + self._ffn(lp, rms_norm(x, lp["ln3"], eps))
        return rms_norm(x, dec.final_ln, eps)

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_word_embeddings:
            return (hidden * self.cfg.d_model**-0.5) @ self.shared.T
        return hidden @ self.lm_head

    def label_logits(self, hidden: torch.Tensor, label_ids: torch.Tensor) -> torch.Tensor:
        """Logits of only the given label token ids: a [D, K] product
        instead of the full [D, V] vocabulary projection."""
        if self.cfg.tie_word_embeddings:
            return (hidden * self.cfg.d_model**-0.5) @ self.shared[label_ids].T
        return hidden @ self.lm_head[:, label_ids]

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor,
                decoder_input_ids: torch.Tensor) -> torch.Tensor:
        """Full encoder-decoder forward -> logits [B, T, V]."""
        enc_out = self.encode(input_ids, attn_mask)
        return self.lm_logits(self.decode_hidden(decoder_input_ids, enc_out, attn_mask))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------
def _fill(param: nn.Parameter, value: Any, name: str) -> None:
    src = torch.tensor(np.asarray(value, dtype=np.float32))
    if tuple(src.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(param.shape)}")
    param.copy_(src)


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], cfg: T5Config, dtype=torch.float32,
                    device="cuda") -> T5:
    """The port's module from a ``llmrankers_tpu.models.t5`` parameter tree
    (leaves as numpy arrays; per-layer leaves stacked on a leading [L] axis),
    on ``device`` (the card unless the caller asks for another). A tree from
    the JAX ``quantize_t5_params(pack=True)`` loads into a quantized module:
    int8 leaves and f32 scales as they are."""
    quantized = any(k.endswith(SCALE_SUFFIX) for k in tree["encoder"]["layers"])
    model = T5(cfg, dtype=dtype, device=device, quantized=quantized)
    _fill(model.shared, tree["shared"], "shared")
    if model.lm_head is not None:
        _fill(model.lm_head, tree["lm_head"], "lm_head")
    for name in ("encoder", "decoder"):
        stack, src = getattr(model, name), tree[name]
        _fill(stack.rel_bias, src["rel_bias"], f"{name}.rel_bias")
        _fill(stack.final_ln, src["final_ln"], f"{name}.final_ln")
        if set(src["layers"]) != set(stack.layers[0].keys()):
            raise ValueError(f"{name}: layer leaves {sorted(src['layers'])} != "
                             f"{sorted(stack.layers[0].keys())}")
        for key in stack.layers[0].keys():
            leaf = np.asarray(src["layers"][key], dtype=np.float32)
            if leaf.shape[0] != len(stack.layers):
                raise ValueError(f"{name}.{key}: {leaf.shape[0]} layers, "
                                 f"config has {len(stack.layers)}")
            for i, lp in enumerate(stack.layers):
                _fill(lp[key], leaf[i], f"{name}.{key}[{i}]")
    return model


@torch.no_grad()
def init_params(cfg: T5Config, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> T5:
    """Random init with T5's fan-in scaling (the JAX ``init_params`` scales),
    drawn on ``device`` from ``generator`` (which must live there too). The
    card unless the caller asks for another device; with no GPU the default
    raises."""
    model = T5(cfg, dtype=dtype, device=device)
    D, I, Fd = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    scales = {
        "q": (D * cfg.d_kv) ** -0.5, "k": D**-0.5, "v": D**-0.5, "o": I**-0.5,
        "wi": D**-0.5, "wi_0": D**-0.5, "wi_1": D**-0.5, "wo": Fd**-0.5,
    }

    def nrm(p: nn.Parameter, scale: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=device) * scale)

    nrm(model.shared, 1.0)
    if model.lm_head is not None:
        nrm(model.lm_head, D**-0.5)
    for stack in (model.encoder, model.decoder):
        nrm(stack.rel_bias, D**-0.5)
        stack.final_ln.fill_(1.0)
        for lp in stack.layers:
            for key, p in lp.items():
                if key.startswith("ln"):
                    p.fill_(1.0)
                else:
                    nrm(p, scales[key.removeprefix("c")])
    return model
