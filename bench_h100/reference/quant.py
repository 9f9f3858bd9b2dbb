"""The quantization schemes the configurations state, as fake quantization
in float32: a tensor is replaced by the dequantized value of its quantized
form, and the product runs in float32.

- Weights: symmetric per output column of ``[K, N]``: ``round(w / amax *
  qmax)`` times ``amax / qmax`` (``qmax`` 127 for int8, 7 for int4), ``amax``
  floored at 1e-8.
- W8A8 activations: symmetric per row and per K-block, ``scale = amax *
  f32(1/127)`` and ``round(x * (1 / scale))``, the block size by
  :func:`kblock` (the TPU kernels' rule, which the port keeps, so both sides
  quantize the same blocks).
- KV cache: symmetric int8 per (position, KV head) over the head dim, as the
  weights.

The formulas are written as the configurations' schemes write them, so a
value on a rounding tie rounds the same way on both sides.
"""
from __future__ import annotations

import torch

_VMEM_BUDGET = 13 * 2**20
_INV127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))  # f32(1/127)


def _largest_divisor(n: int, cap: int, step: int = 128) -> int:
    """Largest multiple of ``step`` that divides ``n`` and is <= cap; 0 if none."""
    best = 0
    for d in range(step, min(n, cap) + 1, step):
        if n % d == 0:
            best = d
    return best


def kblock(K: int, N: int, gated: bool = False, xbytes: int = 2) -> int:
    """The K-block that carries one activation scale per row: the largest
    128-multiple divisor of K up to 2048, halved while it is above 1024 and
    the TPU kernel's VMEM estimate is above 13 MiB (bf16 activations, no
    residual). ``N`` is the output width; for ``gated`` that of one half."""
    bm = 256
    bk = _largest_divisor(K, 2048)
    bn = _largest_divisor(N, 512 if gated else 2048)
    if bn == 0 or bk == 0:
        raise ValueError(f"no 128-multiple K-block for {K}x{N}")

    def vmem(bk_: int) -> int:
        nk_ = K // bk_
        if gated:
            return (2 * (bm * bk_ * xbytes + 2 * bk_ * bn) + 2 * 4 * bm * bn
                    + 2 * bm * bn * xbytes * 2 + nk_ * bm * (bk_ + 4) + bm * bk_ * 4)
        return (2 * (bm * bk_ * xbytes + bk_ * bn) + 4 * bm * bn + 4 * bm * bn
                + nk_ * bm * (bk_ + 4) + bm * bk_ * 4)

    while bk > 1024 and vmem(bk) > _VMEM_BUDGET:
        bk //= 2
    return bk


def weight(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """``w`` [K, N] through per-column symmetric quantization, float32."""
    qmax = 2 ** (bits - 1) - 1
    w = w.float()
    amax = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-8)
    return torch.clamp(torch.round(w / amax * qmax), -qmax, qmax) * (amax / qmax)


def rows(x: torch.Tensor, kb: int) -> torch.Tensor:
    """``x`` [..., K] through per-row, per-K-block symmetric int8, float32."""
    K = x.shape[-1]
    xb = x.float().reshape(*x.shape[:-1], K // kb, kb)
    scale = xb.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * _INV127
    return (torch.clamp(torch.round(xb * (1.0 / scale)), -127, 127) * scale).reshape(x.shape)


def kv(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., Dh] through symmetric int8 over its last dim, float32."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    return torch.clamp(torch.round(x / amax * 127.0), -127, 127) * (amax / 127.0)
