"""Weight quantization: T5 W8A8, and the decoder's int8 and mixed int4/int8.

Counterpart of ``llmrankers_tpu/models/quant.py``. Every function gives the
JAX function's leaves bit for bit on the same float weights (the formulas in
f32, as JAX writes them), and weights keep the JAX shape ``[K, N]``.

Layout: the int8 layer leaves that the W8A8 GEMM (B3) reads and the
packed int4 leaves that the W4A8 GEMM (B7) reads are stored K-major
(:func:`kmajor_leaves`): an ``[N, K]`` buffer seen through its transpose,
shape ``[K, N]`` with stride ``(1, K)`` (packed int4: ``[N, K/2]`` seen as
``[K/2, N]``, stride ``(1, K/2)``), the same values and bytes as the
row-major leaf. Hopper's int8 ``wgmma`` reads both operands K-major from
shared memory only, so both kernels load these buffers by TMA as they lie.
The leaves of the gated kernels (B4: T5 ``wi_g``; B6: the decoder's
``w_gate`` and ``w_up``) and the decoder's int8 head stay row-major and
contiguous. The allocators (``T5Stack``, ``Decoder``) lay the leaves out
through :func:`empty_leaf`, so every ``copy_`` into them (the quantizers,
``params_from_jax``) keeps the layout.

T5: symmetric per-output-channel int8 for every per-layer matmul weight,
with f32 ``[1, N]`` scales under ``<name>_scale``. Embeddings, rel-pos
tables, norms and the LM head keep the model's dtype. ``pack=True`` then
concatenates sibling sites along the output axis per :data:`T5_PACKS`
(q|k|v -> ``qkv``, wi_0|wi_1 -> ``wi_g``, the decoder's ck|cv -> ``ckv``), so
each group is one wide GEMM and the encoder's qkv output feeds the packed
flash kernel without slice copies.

Decoder: :func:`quantize_decoder_params` makes every site of
:data:`QUANT_TARGETS` int8 with bf16 ``[1, N]`` scales, and the LM head too
(a tied embedding per row, ``[V, 1]`` scales). :func:`quantize_decoder_params_int4`
packs the sites of at least ``INT4_MIN_SITE_PARAMS`` weights whose input dim
admits a group as group-wise int4 (``ops/int4_matmul.py``, f32 scales under
``<name>_scale4``) and makes the rest int8. Each site then runs by
:func:`qmm` and :func:`swiglu_ffn`, the JAX dispatch site for site: with the
model's ``cfg.qkernels`` set, int4 sites whose N is a multiple of 128 take
the W4A8 kernel at any M, int8 sites with both dims multiples of 128 and
M = B*L >= 1024 take the W8A8 kernel (gate and up together take the gated
pair kernel), and every other quantized site multiplies by its dequantized
weight.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.int4_matmul import choose_group, pack_int4, unpack_int4
from ..ops.int4_matmul import quantized_matmul_int4, quantized_matmul_int4_plain
from ..ops.int8_matmul import (gated_matmul_pair, gated_matmul_pair_plain,
                               quantized_matmul, quantized_matmul_plain)

T5_TARGETS = (
    "q", "k", "v", "o", "cq", "ck", "cv", "co",
    "wi", "wi_0", "wi_1", "wo",
)
SCALE_SUFFIX = "_scale"
SCALE4_SUFFIX = "_scale4"  # marks a nibble-packed int4 leaf
QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# int4 sites below this weight count stay int8: the JAX package's cut-off,
# kept for parity (it routes Qwen2.5-3B's FFN sites to int4 and the attention
# projections to int8).
INT4_MIN_SITE_PARAMS = 8 * 2**20
T5_PACKS = {
    "encoder": (("qkv", ("q", "k", "v")), ("wi_g", ("wi_0", "wi_1"))),
    "decoder": (
        ("qkv", ("q", "k", "v")),
        ("ckv", ("ck", "cv")),
        ("wi_g", ("wi_0", "wi_1")),
    ),
}


# int8 leaves with a ``_scale`` leaf that the gated kernels read (B4, B6):
# they stay row-major.
GATED_LEAVES = ("wi_g", "w_gate", "w_up")


def kmajor_leaves(specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]) -> frozenset:
    """The layer leaves of ``specs`` (name -> (shape, dtype)) stored K-major:
    every int8 leaf with a ``_scale`` leaf (the W8A8 sites, which B3 reads)
    but :data:`GATED_LEAVES`, and every packed int4 leaf (with a ``_scale4``
    leaf, which B7 reads)."""
    return frozenset(name for name, (_, dt) in specs.items()
                     if dt == torch.int8 and (
                         (name + SCALE_SUFFIX in specs and name not in GATED_LEAVES)
                         or name + SCALE4_SUFFIX in specs))


def empty_leaf(shape, dtype, device, kmajor: bool = False) -> torch.Tensor:
    """An uninitialised leaf; a K-major ``[K, N]`` leaf is a contiguous
    ``[N, K]`` buffer seen through its transpose (stride ``(1, K)``)."""
    if kmajor:
        K, N = shape
        return torch.empty((N, K), dtype=dtype, device=device).t()
    return torch.empty(shape, dtype=dtype, device=device)


def to_kmajor(w: torch.Tensor) -> torch.Tensor:
    """``w`` [K, N] with the same values laid out K-major (stride ``(1, K)``)."""
    return w.t().contiguous().t()


def quantize_weight(w: torch.Tensor, dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float ``w`` -> (int8 ``w``, f32 scales), one scale per slice along
    ``dim`` (0: per output column of ``[K, N]``, scales ``[1, N]``), with the
    JAX formula in f32: ``clip(round(w / amax * 127), -127, 127)``, ``amax``
    floored at 1e-8, scale ``amax / 127``."""
    w = w.float()
    amax = w.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8)
    q = torch.clamp(torch.round(w / amax * 127.0), -127, 127).to(torch.int8)
    return q, amax / 127.0


def int8_layer_specs(shapes: Dict[str, Tuple[int, ...]], block: str
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The packed int8 layer layout of one stack (``block`` 'encoder' or
    'decoder') from its float leaf shapes: name -> (shape, dtype), with
    dtype None for leaves that keep the model's dtype."""
    specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    for name, shape in shapes.items():
        if name in T5_TARGETS:
            specs[name] = (shape, torch.int8)
            specs[name + SCALE_SUFFIX] = ((1, shape[1]), torch.float32)
        else:
            specs[name] = (shape, None)
    for packed, names in T5_PACKS[block]:
        if not all(n in shapes for n in names):
            continue
        n_out = sum(shapes[n][1] for n in names)
        for n in names:
            del specs[n], specs[n + SCALE_SUFFIX]
        specs[packed] = ((shapes[names[0]][0], n_out), torch.int8)
        specs[packed + SCALE_SUFFIX] = ((1, n_out), torch.float32)
    return specs


@torch.no_grad()
def quantize_t5_params(model, pack: bool = True):
    """A new ``T5`` with int8 packed layer weights (see module docstring).

    The float leaves that stay (embeddings, rel-pos tables, norms, LM head)
    are shared with ``model``, which is left as it is. Only the packed
    layout is ported: the unpacked int8 leaves of ``pack=False`` serve the
    JAX package's multi-device meshes (ROADMAP A13)."""
    from .t5 import T5

    if not pack:
        raise NotImplementedError(
            "unpacked int8 T5 leaves (pack=False) serve multi-device meshes, "
            "which are not ported yet (ROADMAP A13)")
    out = T5(model.cfg, dtype=model.shared.dtype, device=model.shared.device,
             use_flash=model.use_flash, quantized=True)
    out.shared = model.shared
    out.lm_head = model.lm_head
    for block in ("encoder", "decoder"):
        src, dst = getattr(model, block), getattr(out, block)
        dst.rel_bias = src.rel_bias
        dst.final_ln = src.final_ln
        for lp_src, lp_dst in zip(src.layers, dst.layers):
            leaves = {}
            for key, p in lp_src.items():
                if key in T5_TARGETS:
                    leaves[key], leaves[key + SCALE_SUFFIX] = quantize_weight(p)
                else:
                    lp_dst[key] = p
            for packed, names in T5_PACKS[block]:
                if all(n in leaves for n in names):
                    for suffix in ("", SCALE_SUFFIX):
                        leaves[packed + suffix] = torch.cat(
                            [leaves.pop(n + suffix) for n in names], dim=1)
            for key, value in leaves.items():
                lp_dst[key].copy_(value)
    return out


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def _flat_m(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1] if x.shape[-1] else 0


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's type promotion (bf16 with f32 computes in f32)."""
    if x.dtype == w.dtype:
        return x @ w
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def wmat(lp, name: str, x_dtype: torch.dtype) -> torch.Tensor:
    """The dequantized weight of a matmul site in any quantization state, for
    activations of ``x_dtype``: the leaf itself, the unpacked int4 weight in
    f32, or ``w8 * scale`` in the dtype the product with x takes (bf16 for
    bf16 x and scales; for f32 x the exact f32 product, which is what XLA
    computes for the JAX ``w.astype(s.dtype) * s`` fused into an f32
    matmul)."""
    w = lp[name]
    s4 = lp.get(name + SCALE4_SUFFIX)
    if s4 is not None:
        return unpack_int4(w, s4)
    s = lp.get(name + SCALE_SUFFIX)
    if s is None:
        return w
    dt = torch.promote_types(x_dtype, s.dtype)
    return w.to(dt) * s.to(dt)


def qmm(lp, name: str, x: torch.Tensor, kernel: bool = False,
        plain: bool = False) -> torch.Tensor:
    """``x @ weight`` for a matmul site of any quantization state, by the JAX
    rule (``quant.py::qmm``): with ``kernel`` (the model config's
    ``qkernels``) an int4 site whose N is a multiple of 128 runs the W4A8
    kernel at any M, an int8 site with both dims multiples of 128 and
    M >= 1024 the W8A8 kernel; everything else is ``(x @ wmat).to(x.dtype)``.
    ``plain`` runs each kernel site on the kernel's plain version instead."""
    w = lp[name]
    s4 = lp.get(name + SCALE4_SUFFIX)
    if kernel and s4 is not None and w.shape[-1] % 128 == 0:
        fn = quantized_matmul_int4_plain if plain else quantized_matmul_int4
        return fn(x, w, s4)
    s = lp.get(name + SCALE_SUFFIX)
    if (kernel and s is not None and w.shape[-2] % 128 == 0 and w.shape[-1] % 128 == 0
            and _flat_m(x) >= 1024):
        fn = quantized_matmul_plain if plain else quantized_matmul
        return fn(x, w, s)
    return _matmul(x, wmat(lp, name, x.dtype)).to(x.dtype)


def swiglu_ffn(lp, x: torch.Tensor, kernel: bool = False,
               plain: bool = False) -> torch.Tensor:
    """``silu(x @ w_gate) * (x @ w_up) @ w_down`` through the dispatch of
    :func:`qmm`; with ``kernel`` and int8 gate and up weights (both dims
    multiples of 128, M >= 1024) the gate pair runs as one gated kernel over
    the two leaves. The residual add stays with the caller."""
    wg = lp["w_gate"]
    if (kernel and ("w_gate" + SCALE_SUFFIX) in lp and ("w_up" + SCALE_SUFFIX) in lp
            and wg.shape[-2] % 128 == 0 and wg.shape[-1] % 128 == 0
            and _flat_m(x) >= 1024):
        fn = gated_matmul_pair_plain if plain else gated_matmul_pair
        g = fn(x, wg, lp["w_gate" + SCALE_SUFFIX], lp["w_up"], lp["w_up" + SCALE_SUFFIX],
               act="silu")
    else:
        g = F.silu(qmm(lp, "w_gate", x, kernel, plain)) * qmm(lp, "w_up", x, kernel, plain)
    return qmm(lp, "w_down", g, kernel, plain)


def embed_rows(model, ids: torch.Tensor) -> torch.Tensor:
    """The embedding gather; for an int8 table the rows and their scales are
    gathered and multiplied after, in the scale's dtype."""
    s = model.embed_scale
    if s is None:
        return F.embedding(ids, model.embed)
    return model.embed[ids].to(s.dtype) * s[ids]


def is_quantized(model) -> bool:
    lp = model.layers[0] if len(model.layers) else {}
    return any((t + SCALE_SUFFIX) in lp or (t + SCALE4_SUFFIX) in lp for t in QUANT_TARGETS)


def decoder_quant_specs(cfg, shapes: Dict[str, Tuple[int, ...]], mode: str,
                        min_site_params: int = INT4_MIN_SITE_PARAMS
                        ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The quantized leaves of a decoder, name -> (shape, dtype), from its
    float layer shapes: ``mode`` 'int8' (:func:`quantize_decoder_params`) or
    'int4' (:func:`quantize_decoder_params_int4`). Scales of int8 leaves are
    bf16; the head is int8 as the JAX ``_quantize_head`` makes it, an untied
    ``lm_head`` [D, V] per column, else the tied embedding [V, D] per row."""
    D, V, bf16 = cfg.hidden_size, cfg.vocab_size, torch.bfloat16
    if cfg.tie_word_embeddings:
        specs = {"embed": ((V, D), torch.int8), "embed_scale": ((V, 1), bf16)}
    else:
        specs = {"lm_head": ((D, V), torch.int8), "lm_head_scale": ((1, V), bf16)}
    for name in QUANT_TARGETS:
        if name not in shapes:
            continue
        K, N = shapes[name]
        G = choose_group(K)
        if mode == "int4" and G and K * N >= min_site_params:
            specs[name] = ((K // 2, N), torch.int8)
            specs[name + SCALE4_SUFFIX] = ((K // G, N), torch.float32)
        else:
            specs[name] = ((K, N), torch.int8)
            specs[name + SCALE_SUFFIX] = ((1, N), bf16)
    return specs


@torch.no_grad()
def _quantized_decoder(model, specs):
    """A new ``Decoder`` with the leaves of ``specs`` quantized from
    ``model``'s float weights; the other leaves are shared with ``model``,
    which is left as it is."""
    from .decoder import Decoder

    out = Decoder(model.cfg, dtype=model.final_ln.dtype, device=model.final_ln.device,
                  use_flash=model.use_flash, quant=specs)
    out.final_ln = model.final_ln
    for head, dim in (("embed", 1), ("lm_head", 0)):
        if head + SCALE_SUFFIX in specs:
            q, s = quantize_weight(getattr(model, head), dim)
            getattr(out, head).copy_(q)
            getattr(out, head + SCALE_SUFFIX).copy_(s)
        else:
            setattr(out, head, getattr(model, head))
    for lp_src, lp_dst in zip(model.layers, out.layers):
        for key, p in lp_src.items():
            if key in specs and key + SCALE4_SUFFIX in specs:
                q, s = pack_int4(p)
                lp_dst[key].copy_(q)
                lp_dst[key + SCALE4_SUFFIX].copy_(s)
            elif key in specs:
                q, s = quantize_weight(p)
                lp_dst[key].copy_(q)
                lp_dst[key + SCALE_SUFFIX].copy_(s)
            else:
                lp_dst[key] = p
    return out


def quantize_decoder_params(model):
    """A new ``Decoder`` with symmetric per-output-channel int8 weights at
    every site of :data:`QUANT_TARGETS` and bf16 scales, and the LM head
    int8, as the JAX ``quantize_decoder_params`` with its defaults."""
    from .decoder import _layer_shapes

    return _quantized_decoder(model, decoder_quant_specs(
        model.cfg, _layer_shapes(model.cfg), "int8"))


def quantize_decoder_params_int4(model, min_site_params: int = INT4_MIN_SITE_PARAMS):
    """A new ``Decoder`` with mixed int4/int8 weights, as the JAX
    ``quantize_decoder_params_int4`` with its head quantized: group-wise int4
    at the sites of at least ``min_site_params`` weights whose input dim
    admits a group, int8 with bf16 scales elsewhere, and the LM head int8."""
    from .decoder import _layer_shapes

    return _quantized_decoder(model, decoder_quant_specs(
        model.cfg, _layer_shapes(model.cfg), "int4", min_site_params))
