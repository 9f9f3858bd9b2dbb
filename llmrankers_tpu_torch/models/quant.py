"""int8 quantization of the T5 weights (W8A8 scoring path).

Counterpart of the T5 half of ``llmrankers_tpu/models/quant.py``: symmetric
per-output-channel int8 for every per-layer matmul weight, with f32 ``[1, N]``
scales under ``<name>_scale``, bit-identical to the JAX
``quantize_t5_params`` on the same float weights. Embeddings, rel-pos
tables, norms and the LM head keep the model's dtype. ``pack=True`` then
concatenates sibling sites along the output axis per :data:`T5_PACKS`
(q|k|v -> ``qkv``, wi_0|wi_1 -> ``wi_g``, the decoder's ck|cv -> ``ckv``), so
each group is one wide GEMM and the encoder's qkv output feeds the packed
flash kernel without slice copies. Weights keep the JAX layout ``[K, N]``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

T5_TARGETS = (
    "q", "k", "v", "o", "cq", "ck", "cv", "co",
    "wi", "wi_0", "wi_1", "wo",
)
SCALE_SUFFIX = "_scale"
T5_PACKS = {
    "encoder": (("qkv", ("q", "k", "v")), ("wi_g", ("wi_0", "wi_1"))),
    "decoder": (
        ("qkv", ("q", "k", "v")),
        ("ckv", ("ck", "cv")),
        ("wi_g", ("wi_0", "wi_1")),
    ),
}


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[K, N]`` float -> (int8 ``[K, N]``, f32 ``[1, N]`` scales), with the
    JAX formula in f32: ``clip(round(w / amax * 127), -127, 127)``, ``amax``
    floored at 1e-8, scale ``amax / 127``."""
    w = w.float()
    amax = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-8)
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
