"""Qwen2 (decoder-only: RoPE, RMS norm, grouped-query attention with qkv
bias, SwiGLU, tied embeddings) in plain float32 PyTorch, for greedy
generation over an int8 KV cache.

:func:`served_logits` runs one row's prompt and the tokens it was served as
one causal forward, and gives the logits at every position that chose a
served token: the prompt's last position (which chose the first token) and
each served token but the last. The configuration's cache is worked out in
that forward: a served position attends to the keys and values before it
through symmetric int8 per (position, KV head) (:mod:`.quant`), and to its
own key and value as they are, as a decode step reads a cache it has not yet
written; prompt positions attend to each other unquantized, as a prefill
does. Weights are read layer by layer (``get(name)`` returns a float32
tensor on the device).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import quant

Get = Callable[[str], torch.Tensor]
BIAS_STD = 0.02  # the qkv biases' draw; the published model has trained ones


def _dims(conf: Dict) -> Tuple[int, int, int, int, int]:
    D, H, KV = conf["hidden_size"], conf["num_attention_heads"], conf["num_key_value_heads"]
    return D, H, KV, conf.get("head_dim") or D // H, conf["intermediate_size"]


def param_specs(conf: Dict) -> List[Tuple[str, Tuple[int, ...], Optional[float]]]:
    """(name, shape, std) of every weight; std None is a norm weight of
    ones. Projections at fan-in scale (``wq`` and ``wk`` times the
    configuration's ``qk_init_scale``, 1 by default), the embedding at 0.02
    (it is also the tied output head)."""
    D, H, KV, Dh, F = _dims(conf)
    qk = conf.get("qk_init_scale", 1.0)
    layer = {"ln1": (D,), "wq": (D, H * Dh), "wk": (D, KV * Dh), "wv": (D, KV * Dh),
             "bq": (H * Dh,), "bk": (KV * Dh,), "bv": (KV * Dh,), "wo": (H * Dh, D),
             "ln2": (D,), "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}
    specs = [("embed", (conf["vocab_size"], D), 0.02)]
    for i in range(conf["num_hidden_layers"]):
        for key, shape in layer.items():
            std = (None if key.startswith("ln") else BIAS_STD if key.startswith("b")
                   else shape[0] ** -0.5 * (qk if key in ("wq", "wk") else 1.0))
            specs.append((f"layers.{i}.{key}", shape, std))
    specs.append(("final_ln", (D,), None))
    return specs


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [heads, n, Dh] rotated by positions ``pos`` [n] (halves layout)."""
    Dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, device=x.device, dtype=torch.float32) / Dh)
    f = pos.float()[:, None] * inv
    cos, sin = torch.cat([f, f], -1).cos(), torch.cat([f, f], -1).sin()
    x1, x2 = x[..., : Dh // 2], x[..., Dh // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def _attention(q, k, v, kq, vq, prompt: int, block: int = 1024) -> torch.Tensor:
    """q [H, n, Dh], k/v [KV, n, Dh] (kq/vq their cached values) ->
    [H, n, Dh]: causal; queries from ``prompt`` on read earlier keys from
    the cache and their own unquantized."""
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
        s = s.masked_fill(torch.arange(b, device=q.device)[None, :] > rows[:, None],
                          float("-inf"))
        p = torch.softmax(s, -1)
        o = p @ vals[:, :b]
        if cached:
            o = o + p[:, rows - a, rows][..., None] * (v[:, a:b] - vq[:, a:b])
        out[:, a:b] = o
    return out


def served_logits(get: Get, conf: Dict, tokens: Sequence[int], prompt: int
                  ) -> torch.Tensor:
    """Logits [len(tokens) - prompt + 1, V] float32 at positions prompt - 1
    .. len(tokens) - 1 of the causal forward over ``tokens`` (the prompt,
    then the served tokens it consumed)."""
    D, H, KV, Dh, _ = _dims(conf)
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    embed = get("embed")
    ids = torch.tensor(list(tokens), device=embed.device)
    n = ids.shape[0]
    pos = torch.arange(n, device=embed.device)
    x = embed[ids]
    for i in range(conf["num_hidden_layers"]):
        p = f"layers.{i}."
        h = _norm(x, get(p + "ln1"), eps)
        q = (h @ get(p + "wq") + get(p + "bq")).reshape(n, H, Dh).transpose(0, 1)
        k = (h @ get(p + "wk") + get(p + "bk")).reshape(n, KV, Dh).transpose(0, 1)
        v = (h @ get(p + "wv") + get(p + "bv")).reshape(n, KV, Dh).transpose(0, 1)
        q, k = _rope(q, pos, theta), _rope(k, pos, theta)
        a = _attention(q, k, v, quant.kv(k), quant.kv(v), prompt)
        x = x + a.transpose(0, 1).reshape(n, H * Dh) @ get(p + "wo")
        h = _norm(x, get(p + "ln2"), eps)
        x = x + (torch.nn.functional.silu(h @ get(p + "w_gate")) * (h @ get(p + "w_up"))
                 ) @ get(p + "w_down")
    h = _norm(x[prompt - 1:], get("final_ln"), eps)
    return h @ embed.T


def gaps(logits: torch.Tensor, served: Sequence[int]) -> torch.Tensor:
    """Per position, how far the served token's logit lies below the best."""
    idx = torch.tensor(list(served), device=logits.device)
    return logits.max(-1).values - logits.gather(1, idx[:, None])[:, 0]
