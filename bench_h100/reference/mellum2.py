"""Mellum 2 (decoder-only: GQA with sliding-window and full layers, each
type with its own RoPE, routed experts in every MLP, untied head) in plain
float32 PyTorch, for greedy generation over an int8 KV cache.

The layer equations as ``config.json`` gives them:

- pre-norm attention: RMSNorm (fp32 statistics), q = h Wq, k = h Wk, v = h
  Wv (no bias, no q/k norm, no output gate), RoPE on the whole head by the
  layer's type (``rope_parameters``: default at ``rope_theta`` on sliding
  layers; YaRN on full layers, its frequencies as transformers'
  ``_compute_yarn_parameters`` derives them and cos and sin scaled by
  ``attention_factor``); causal GQA where, on a sliding layer, the key at
  position p_k is visible from p_q iff 0 <= p_q - p_k < ``sliding_window``;
  h += o Wo;
- routed MLP: r = softmax(h W_router) over the experts, in float32; the top
  ``num_experts_per_tok``, each weight divided by their sum
  (``norm_topk_prob``); h += sum_e w_e down_e(silu(gate_e h) * up_e h);
- final RMSNorm and an untied ``lm_head``.

:func:`served_logits` and :func:`gaps` have :mod:`.qwen2`'s signatures, so
the ``rankr1_generation`` driver uses this module unchanged; the KV cache is
worked out as there (served positions read earlier keys and values through
int8 per (position, KV head), their own as they are). The experts run
expert by expert over the tokens routed to each, so a row fits beside the
weights. Weights are read layer by layer (``get(name)`` returns a float32
tensor on the device).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import fp32, quant
from .qwen2 import Get, _norm, gaps  # noqa: F401  (gaps is this module's too)


def _dims(conf: Dict) -> Tuple[int, int, int, int]:
    D, H, KV = conf["hidden_size"], conf["num_attention_heads"], conf["num_key_value_heads"]
    return D, H, KV, conf.get("head_dim") or D // H


def param_specs(conf: Dict) -> List[Tuple[str, Tuple[int, ...], Optional[float]]]:
    """(name, shape, std) of every weight; std None is a norm weight of
    ones. Projections, the router and the experts at fan-in scale (``wq`` and
    ``wk`` times the configuration's ``qk_init_scale``, the router times its
    ``router_init_scale``, each 1 by default), the embedding at 0.02, the
    untied head at fan-in."""
    D, H, KV, Dh = _dims(conf)
    E, F = conf["num_experts"], conf["moe_intermediate_size"]
    scale = {"wq": conf.get("qk_init_scale", 1.0), "wk": conf.get("qk_init_scale", 1.0),
             "router": conf.get("router_init_scale", 1.0)}
    layer = {"ln1": (D,), "wq": (D, H * Dh), "wk": (D, KV * Dh), "wv": (D, KV * Dh),
             "wo": (H * Dh, D), "ln2": (D,), "router": (D, E),
             "experts_gate_up": (E, D, 2 * F), "experts_down": (E, F, D)}
    specs = [("embed", (conf["vocab_size"], D), 0.02)]
    for i in range(conf["num_hidden_layers"]):
        if conf["mlp_layer_types"][i] != "sparse":
            raise NotImplementedError("a dense MLP layer")
        for key, shape in layer.items():
            std = None if key.startswith("ln") else shape[-2] ** -0.5 * scale.get(key, 1.0)
            specs.append((f"layers.{i}.{key}", shape, std))
    specs += [("final_ln", (D,), None), ("lm_head", (D, conf["vocab_size"]), D ** -0.5)]
    return specs


def inv_freq(p: Dict, Dh: int, device) -> Tuple[torch.Tensor, float]:
    """(RoPE inverse frequencies [Dh / 2], cos/sin scale) of one layer type."""
    base = float(p["rope_theta"])
    freq = base ** (torch.arange(0, Dh, 2, device=device, dtype=torch.float32) / Dh)
    if p["rope_type"] == "default":
        return 1.0 / freq, 1.0
    assert p["rope_type"] == "yarn", p["rope_type"]
    factor, orig = float(p["factor"]), p["original_max_position_embeddings"]

    def dim_of(rotations):  # the dim whose wavelength fits ``rotations`` in orig
        return Dh * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    lo = max(math.floor(dim_of(p.get("beta_fast", 32))), 0)
    hi = min(math.ceil(dim_of(p.get("beta_slow", 1))), Dh - 1)
    ramp = ((torch.arange(Dh // 2, device=device, dtype=torch.float32) - lo)
            / max(hi - lo, 0.001)).clamp(0, 1)
    # Below lo the frequencies extrapolate (unchanged), above hi they
    # interpolate (divided by factor), linearly between.
    inv = (1.0 / freq) * (1 - ramp) + (1.0 / (factor * freq)) * ramp
    scale = p.get("attention_factor") or 0.1 * math.log(factor) + 1.0
    return inv, float(scale)


def _rope(x: torch.Tensor, pos: torch.Tensor, p: Dict) -> torch.Tensor:
    """x [heads, n, Dh] rotated by positions ``pos`` [n] (halves layout)."""
    Dh = x.shape[-1]
    inv, scale = inv_freq(p, Dh, x.device)
    f = pos.float()[:, None] * inv
    cos, sin = torch.cat([f, f], -1).cos() * scale, torch.cat([f, f], -1).sin() * scale
    x1, x2 = x[..., : Dh // 2], x[..., Dh // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def _attention(q, k, v, kq, vq, prompt: int, window: Optional[int], block: int = 1024
               ) -> torch.Tensor:
    """q [H, n, Dh], k/v [KV, n, Dh] (kq/vq their cached values) ->
    [H, n, Dh]: causal, within ``window`` positions when given; queries from
    ``prompt`` on read earlier keys from the cache and their own unquantized."""
    H, n, Dh = q.shape
    G = H // k.shape[0]
    rep = lambda t: t.repeat_interleave(G, 0)  # noqa: E731
    k, v, kq, vq = rep(k), rep(v), rep(kq), rep(vq)
    out = torch.empty_like(q)
    starts = list(range(0, prompt, block)) + [prompt]
    for a, b in zip(starts, starts[1:] + [n]):
        if a >= b:
            continue
        cached = a >= prompt
        keys, vals = (kq, vq) if cached else (k, v)
        s = (q[:, a:b] @ keys[:, :b].transpose(-1, -2)) * Dh**-0.5
        rows = torch.arange(a, b, device=q.device)
        if cached:  # each served position's own key joins unquantized
            s[:, rows - a, rows] = (q[:, a:b] * k[:, a:b]).sum(-1) * Dh**-0.5
        rel = rows[:, None] - torch.arange(b, device=q.device)[None, :]
        hidden = rel < 0
        if window is not None:
            hidden = hidden | (rel >= window)
        p = torch.softmax(s.masked_fill(hidden, float("-inf")), -1)
        o = p @ vals[:, :b]
        if cached:
            o = o + p[:, rows - a, rows][..., None] * (v[:, a:b] - vq[:, a:b])
        out[:, a:b] = o
    return out


def route(h: torch.Tensor, router: torch.Tensor, conf: Dict
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights, experts) [n, k] of each token of ``h`` [n, D]."""
    w, idx = torch.softmax(h @ router, -1).topk(conf["num_experts_per_tok"], dim=-1)
    if conf.get("norm_topk_prob", False):
        w = w / w.sum(-1, keepdim=True)
    return w, idx


def experts(get: Get, p: str, h: torch.Tensor, conf: Dict) -> torch.Tensor:
    """The routed MLP's output for ``h`` [n, D], expert by expert."""
    F = conf["moe_intermediate_size"]
    w, idx = route(h, get(p + "router"), conf)
    gate_up, down = get(p + "experts_gate_up"), get(p + "experts_down")
    out = torch.zeros_like(h)
    for e in range(conf["num_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        g = h[tok] @ gate_up[e]
        y = (torch.nn.functional.silu(g[:, :F]) * g[:, F:]) @ down[e]
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out


def served_logits(get: Get, conf: Dict, tokens: Sequence[int], prompt: int
                  ) -> torch.Tensor:
    """Logits [len(tokens) - prompt + 1, V] float32 at positions prompt - 1
    .. len(tokens) - 1 of the causal forward over ``tokens`` (the prompt,
    then the served tokens it consumed)."""
    fp32()
    D, H, KV, Dh = _dims(conf)
    eps = conf["rms_norm_eps"]
    embed = get("embed")
    ids = torch.tensor(list(tokens), device=embed.device)
    n = ids.shape[0]
    pos = torch.arange(n, device=embed.device)
    x = embed[ids]
    del embed
    for i in range(conf["num_hidden_layers"]):
        p, kind = f"layers.{i}.", conf["layer_types"][i]
        rope = conf["rope_parameters"][kind]
        window = conf["sliding_window"] if kind == "sliding_attention" else None
        h = _norm(x, get(p + "ln1"), eps)
        q = (h @ get(p + "wq")).reshape(n, H, Dh).transpose(0, 1)
        k = (h @ get(p + "wk")).reshape(n, KV, Dh).transpose(0, 1)
        v = (h @ get(p + "wv")).reshape(n, KV, Dh).transpose(0, 1)
        q, k = _rope(q, pos, rope), _rope(k, pos, rope)
        a = _attention(q, k, v, quant.kv(k), quant.kv(v), prompt, window)
        x = x + a.transpose(0, 1).reshape(n, H * Dh) @ get(p + "wo")
        x = x + experts(get, p, _norm(x, get(p + "ln2"), eps), conf)
    h = _norm(x[prompt - 1:], get("final_ln"), eps)
    return h @ get("lm_head")
