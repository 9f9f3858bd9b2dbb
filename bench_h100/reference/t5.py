"""flan-t5 (T5 v1.1: gated-gelu FFN, untied head) in plain float32 PyTorch,
for label scoring: the encoder over prompts, and the decoder over a forced
prefix with the logits of the label tokens at its last position.

The published architecture: RMS norm without mean or bias, no scaling of
attention scores, one relative-position bias per stack from its bucket
table (bidirectional in the encoder, causal in the decoder, none in
cross-attention), ``gelu_new(x @ wi_0) * (x @ wi_1) @ wo``, an untied
``lm_head``. The configuration's W8A8 int8 scheme is applied by
:mod:`.quant` at every matmul site whose product has M = B*L >= 1024 rows
and whose weight dims are multiples of 128 (int8 weights and activations);
the other sites multiply by the int8 weight's dequantized value. ``bits``
gives the weight precision, so the same code is the lower-precision control
at 4.

Weights are a dict of name -> tensor under the names of
:func:`param_specs`, read layer by layer (``get(name)`` returns a float32
tensor on the device), so the reference fits beside little else.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import quant

Get = Callable[[str], torch.Tensor]


def _layer_shapes(conf: Dict, decoder: bool) -> Dict[str, Tuple[int, ...]]:
    D, I, Fd = conf["d_model"], conf["num_heads"] * conf["d_kv"], conf["d_ff"]
    shapes = {"ln1": (D,), "ln2": (D,)}
    if decoder:
        shapes["ln3"] = (D,)
    shapes.update(q=(D, I), k=(D, I), v=(D, I), o=(I, D))
    if decoder:
        shapes.update(cq=(D, I), ck=(D, I), cv=(D, I), co=(I, D))
    shapes.update(wi_0=(D, Fd), wi_1=(D, Fd), wo=(Fd, D))
    return shapes


def param_specs(conf: Dict) -> List[Tuple[str, Tuple[int, ...], Optional[float]]]:
    """(name, shape, std) of every weight; std None is a norm weight of
    ones. The scales are the fan-in scales of T5's initialisation, and the
    bucket tables are drawn at std 1, the scale of a trained model's."""
    D, I, Fd, dkv = conf["d_model"], conf["num_heads"] * conf["d_kv"], conf["d_ff"], conf["d_kv"]
    std = {"q": (D * dkv) ** -0.5, "k": D**-0.5, "v": D**-0.5, "o": I**-0.5,
           "wi_0": D**-0.5, "wi_1": D**-0.5, "wo": Fd**-0.5}
    specs = [("shared", (conf["vocab_size"], D), 1.0)]
    for stack, n in (("encoder", conf["num_layers"]), ("decoder", conf["num_decoder_layers"])):
        specs.append((f"{stack}.rel_bias", (conf["relative_attention_num_buckets"],
                                            conf["num_heads"]), 1.0))
        for i in range(n):
            for key, shape in _layer_shapes(conf, stack == "decoder").items():
                s = None if key.startswith("ln") else std[key.removeprefix("c")]
                specs.append((f"{stack}.layers.{i}.{key}", shape, s))
        specs.append((f"{stack}.final_ln", (D,), None))
    specs.append(("lm_head", (D, conf["vocab_size"]), D**-0.5))
    return specs


def _bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
            max_distance: int) -> torch.Tensor:
    """T5's bucket of key position - query position."""
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).long() * num_buckets
        n = rel.abs()
    else:
        n = -torch.clamp(rel, max=0)
    exact = num_buckets // 2
    large = exact + (torch.log(n.float() / exact + 1e-9) / math.log(max_distance / exact)
                     * (num_buckets - exact)).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(n < exact, n, large)


def _bias(table: torch.Tensor, lq: int, lk: int, bidirectional: bool, conf: Dict
          ) -> torch.Tensor:
    """[H, lq, lk] float32 bias."""
    dev = table.device
    rel = torch.arange(lk, device=dev)[None, :] - torch.arange(lq, device=dev)[:, None]
    b = _bucket(rel, bidirectional, conf["relative_attention_num_buckets"],
                conf["relative_attention_max_distance"])
    return table.float()[b].permute(2, 0, 1)


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


class _Sites:
    """Matmul sites under the configuration's scheme; ``bits`` the weights'
    precision (8 as configured, 4 for the control)."""

    def __init__(self, get: Get, bits: int):
        self.get, self.bits = get, bits

    def w(self, name: str) -> torch.Tensor:
        return quant.weight(self.get(name), self.bits)

    def mm(self, x: torch.Tensor, name: str, m_rows: int, gated_n: int = 0) -> torch.Tensor:
        """``x @ w`` at a site of M = ``m_rows``: activations through
        per-row int8 when the site takes W8A8."""
        w = self.w(name)
        K, N = w.shape
        if m_rows >= 1024 and K % 128 == 0 and N % 128 == 0:
            x = quant.rows(x, quant.kblock(K, gated_n or N, gated=bool(gated_n)))
        return x @ w

    def ffn(self, x: torch.Tensor, pre: str, m_rows: int) -> torch.Tensor:
        """The gated FFN; gate and up are one site (one activation
        quantization, the K-block of the packed gated kernel)."""
        w0, w1 = self.w(pre + "wi_0"), self.w(pre + "wi_1")
        K, N = w0.shape
        if m_rows >= 1024 and K % 128 == 0 and N % 128 == 0:
            x = quant.rows(x, quant.kblock(K, N, gated=True))
        h = _gelu_new(x @ w0) * (x @ w1)
        return self.mm(h, pre + "wo", m_rows)


def _attend(q, k, v, H: int, bias=None, key_mask=None, causal=False) -> torch.Tensor:
    """[B, Lq, H*Dh] from q [B, Lq, H*Dh], k/v [B, Lk, H*Dh]; unscaled scores."""
    B, Lq, HD = q.shape
    Lk, Dh = k.shape[1], HD // H
    split = lambda t: t.reshape(B, t.shape[1], H, Dh).transpose(1, 2)  # noqa: E731
    s = split(q) @ split(k).transpose(-1, -2)
    if bias is not None:
        s = s + bias
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    if causal:
        s = s.masked_fill(torch.ones(Lq, Lk, dtype=torch.bool, device=q.device)
                          .triu(1 + Lk - Lq), float("-inf"))
    return (torch.softmax(s, -1) @ split(v)).transpose(1, 2).reshape(B, Lq, HD)


def encode(get: Get, conf: Dict, ids: torch.Tensor, mask: torch.Tensor, m_rows: int,
           bits: int = 8) -> torch.Tensor:
    """Encoder output [B, L, D] float32 of right-padded ``ids`` with key
    ``mask``; ``m_rows`` is the dispatch's B*L, which picks W8A8 sites."""
    sites, eps, H = _Sites(get, bits), conf["layer_norm_epsilon"], conf["num_heads"]
    x = get("shared")[ids]
    L = ids.shape[1]
    bias = _bias(get("encoder.rel_bias"), L, L, True, conf)
    keys = mask.bool()
    for i in range(conf["num_layers"]):
        p = f"encoder.layers.{i}."
        h = _norm(x, get(p + "ln1"), eps)
        qkv = [sites.mm(h, p + n, m_rows) for n in ("q", "k", "v")]
        x = x + sites.mm(_attend(*qkv, H, bias=bias, key_mask=keys), p + "o", m_rows)
        x = x + sites.ffn(_norm(x, get(p + "ln2"), eps), p, m_rows)
    return _norm(x, get("encoder.final_ln"), eps)


def label_logits(get: Get, conf: Dict, enc: torch.Tensor, mask: torch.Tensor,
                 m_rows: int, b_rows: int, prefix: Sequence[int], labels: Sequence[int],
                 bits: int = 8) -> torch.Tensor:
    """[B, K] float32 logits of ``labels`` after the decoder reads the forced
    ``prefix`` over ``enc``. The dispatch held ``b_rows`` rows (padding
    included), so sites on the prefix have M = b_rows * len(prefix); the
    cross K/V sites have the encoder's ``m_rows``."""
    sites, eps, H = _Sites(get, bits), conf["layer_norm_epsilon"], conf["num_heads"]
    B, T = enc.shape[0], len(prefix)
    dev = enc.device
    x = get("shared")[torch.tensor(prefix, device=dev)].expand(B, T, -1)
    bias = _bias(get("decoder.rel_bias"), T, T, False, conf)
    keys, m_dec = mask.bool(), b_rows * T
    for i in range(conf["num_decoder_layers"]):
        p = f"decoder.layers.{i}."
        h = _norm(x, get(p + "ln1"), eps)
        qkv = [sites.mm(h, p + n, m_dec) for n in ("q", "k", "v")]
        x = x + sites.mm(_attend(*qkv, H, bias=bias, causal=True), p + "o", m_dec)
        h = _norm(x, get(p + "ln2"), eps)
        ck, cv = sites.mm(enc, p + "ck", m_rows), sites.mm(enc, p + "cv", m_rows)
        a = _attend(sites.mm(h, p + "cq", m_dec), ck, cv, H, key_mask=keys)
        x = x + sites.mm(a, p + "co", m_dec)
        x = x + sites.ffn(_norm(x, get(p + "ln3"), eps), p, m_dec)
    h = _norm(x[:, -1], get("decoder.final_ln"), eps)
    return h @ get("lm_head")[:, torch.tensor(list(labels), device=dev)]
