"""Routed experts: the sparse MLP of a decoder layer (``mlp_layer_types``
"sparse").

A layer's experts are stacked: ``router`` [D, E], ``experts_gate_up`` [E, D,
2F] (gate | up) and ``experts_down`` [E, F, D]. :func:`moe_ffn` routes each
token: ``softmax(h @ router)`` in float32, the top ``num_experts_per_tok``,
each weight divided by their sum when ``norm_topk_prob``; the assignments
sorted by expert run as one grouped GEMM per projection
(``torch._grouped_mm``: CUTLASS's grouped GEMM on the card, its own fallback
on the CPU), and each token's outputs are summed with their weights. Nothing
reads a count back to the host and the shapes are fixed by the rows, so a
decode step's routing is captured in its CUDA graph with the rest.

:class:`Routing` is what one forward's expert layers share: in a prefill the
flat indices of the real tokens (pad positions are never routed). The
decoder counts each forward's routing on the device (:data:`COUNTS`), once a
forward and not per layer, read once when asked. Each expert layer is two
spans of ``utils.metering``: ``moe.route`` and ``moe.experts``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.metering import span

# The device counter's slots, summed over routed layers: token-expert
# assignments routed (real tokens x experts per token, prefill and decode)
# and pad positions not routed (prefill).
COUNTS = ("assignments", "pad_skipped")


class Routing:
    """``real``: [n] flat indices of the [B * L] positions to route (a
    prefill's real tokens), or None to route every row."""

    def __init__(self, real: Optional[torch.Tensor] = None):
        self.real = real

    @classmethod
    def prefill(cls, attn_mask: torch.Tensor) -> "Routing":
        """The real positions of a [B, L] mask. Finding them reads their
        number back to the host, once per forward."""
        return cls(real=attn_mask.reshape(-1).nonzero().squeeze(1))


def moe_ffn(lp, x: torch.Tensor, cfg, routing: Optional[Routing] = None) -> torch.Tensor:
    """The routed-expert MLP on ``x`` [B, L, D] (the residual add stays with
    the caller); positions that ``routing`` leaves out come out as zeros."""
    B, L, D = x.shape
    E, k, Fe = cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_intermediate_size
    flat = x.reshape(B * L, D)
    real = routing.real if routing is not None else None
    with span("moe.route"):
        xr = flat if real is None else flat.index_select(0, real)
        n = xr.shape[0]
        probs = torch.softmax(xr.float() @ lp["router"].float(), dim=-1)
        w, idx = probs.topk(k, dim=-1)  # [n, k]
        if cfg.norm_topk_prob:
            w = w / w.sum(dim=-1, keepdim=True)
        ids = idx.reshape(-1)
        order = ids.argsort(stable=True)  # assignments grouped by expert
        offs = torch.searchsorted(ids[order], torch.arange(E, device=x.device),
                                  right=True).to(torch.int32)
    with span("moe.experts"):
        xs = xr.index_select(0, order // k)
        h = torch._grouped_mm(xs, lp["experts_gate_up"], offs=offs)  # [n k, 2F]
        a = F.silu(h[:, :Fe]) * h[:, Fe:] * w.reshape(-1)[order, None].to(h.dtype)
        del xs, h
        o = torch._grouped_mm(a, lp["experts_down"], offs=offs)  # [n k, D]
        del a
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=x.device))
        y = o.index_select(0, inv).view(n, k, D).sum(dim=1)
    if real is not None:
        y = torch.zeros_like(flat).index_copy_(0, real, y)
    return y.view(B, L, D)

