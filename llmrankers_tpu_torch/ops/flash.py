"""Flash attention over the [B, L, H*Dh] layout: wrappers, plain versions,
counts.

Counterparts of ``llmrankers_tpu/ops/flash.py::flash_mha_blhd`` and
``::flash_mha_packed``. On a CUDA tensor :func:`flash_mha_blhd` launches the
hand-written kernel ``csrc/flash_blhd.cu`` (bf16, ``sm_90a``) or raises; on a
CPU tensor it runs :func:`flash_mha_blhd_plain`, which computes what the
kernel computes with the TPU kernel's masking constants, so fully masked rows
come out as zeros. :func:`flash_mha_packed` runs the same kernel on q, k and
v read straight out of one packed ``[B, L, 3*H*Dh]`` qkv projection: three
strided views at column offsets 0, H*Dh and 2*H*Dh, no slice copies.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
M_FLOOR = -1e28  # floor of the running max: fully masked rows exp to 0


def flash_mha_blhd_plain(
    q: torch.Tensor,  # [B, Lq, H*Dh]
    k: torch.Tensor,  # [B, Lk, H*Dh]
    v: torch.Tensor,
    num_heads: int,
    kv_mask: Optional[torch.Tensor] = None,  # [B, Lk] {0,1}
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,  # [1, H, Lq, Lk]
    scale: float = 1.0,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in one softmax pass."""
    if bias is not None and bias.shape[0] != 1:
        raise ValueError("flash path requires batch-invariant bias")
    B, Lq, HD = q.shape
    Lk = k.shape[1]
    Dh = HD // num_heads

    def split(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(B, x.shape[1], num_heads, Dh).transpose(1, 2).float()

    s = torch.einsum("bhqd,bhkd->bhqk", split(q), split(k))
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + bias.float()
    if kv_mask is not None:
        s = s + ((1.0 - kv_mask.float()) * NEG_INF)[:, None, None, :]
    if causal:
        rows = torch.arange(Lq, device=q.device)[:, None]
        cols = torch.arange(Lk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows + (Lk - Lq), NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), split(v))
    out = out / l.clamp_min(1e-30)
    return out.transpose(1, 2).reshape(B, Lq, HD).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_blhd")
    fn = lib.flash_blhd_bf16
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [ptr] * 6 + [i32] * 5 + [i64] * 8 + [ctypes.c_float, i32, ptr]
        )
        fn.restype = ctypes.c_int
    return lib


def _check_rows(name: str, x: torch.Tensor) -> None:
    """The kernel reads rows with 16-byte loads: unit last stride, row and
    batch strides in whole 8-element groups, a 16-byte aligned base."""
    if x.stride(-1) != 1 or x.stride(0) % 8 or x.stride(1) % 8:
        raise ValueError(f"{name}: rows must be contiguous with strides "
                         f"divisible by 8, got strides {tuple(x.stride())}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: base pointer must be 16-byte aligned")


def flash_mha_blhd(
    q: torch.Tensor,  # [B, Lq, H*Dh]
    k: torch.Tensor,  # [B, Lk, H*Dh]
    v: torch.Tensor,
    num_heads: int,
    kv_mask: Optional[torch.Tensor] = None,  # [B, Lk] int32 {0,1}
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,  # [1, H, Lq, Lk], q's dtype
    scale: float = 1.0,
) -> torch.Tensor:
    """Flash attention, [B, Lq, H*Dh] in and out.

    CPU tensors take :func:`flash_mha_blhd_plain`. CUDA tensors launch the
    kernel on the current stream, without synchronising, and add one to
    ``flash_mha_blhd.launches``; what the kernel does not take raises:
    dtype other than bf16, Dh not a multiple of 16 or above 128, a bias of
    batch other than 1 or not contiguous, a mask other than int32."""
    if q.device.type == "cpu":
        return flash_mha_blhd_plain(q, k, v, num_heads, kv_mask=kv_mask,
                                    causal=causal, bias=bias, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_blhd: no kernel for device {q.device}")
    out = _launch(q, k, v, num_heads, kv_mask, causal, bias, scale)
    flash_mha_blhd.launches += 1
    return out


flash_mha_blhd.launches = 0


def _launch(q, k, v, num_heads, kv_mask, causal, bias, scale) -> torch.Tensor:
    """Check q/k/v (views allowed) and launch flash_blhd.cu on them."""
    B, Lq, HD = q.shape
    Lk = k.shape[1]
    if HD % num_heads:
        raise ValueError(f"H*Dh={HD} is not divisible by num_heads={num_heads}")
    Dh = HD // num_heads
    if Dh % 16 or Dh > 128:
        raise ValueError(f"flash kernel needs Dh % 16 == 0 and Dh <= 128, got {Dh}")
    if k.shape != (B, Lk, HD) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: flash kernel takes bf16 on {q.device}, "
                             f"got {x.dtype} on {x.device}")
        _check_rows(name, x)
    if kv_mask is not None and (
        kv_mask.shape != (B, Lk) or kv_mask.dtype != torch.int32
        or kv_mask.device != q.device or not kv_mask.is_contiguous()
    ):
        raise ValueError("kv_mask must be a contiguous int32 [B, Lk] tensor "
                         "on q's device")
    if bias is not None:
        if bias.shape[0] != 1:
            raise ValueError("flash path requires batch-invariant bias")
        if (bias.shape != (1, num_heads, Lq, Lk) or bias.dtype != q.dtype
                or bias.device != q.device or not bias.is_contiguous()):
            raise ValueError(f"bias must be a contiguous {q.dtype} "
                             f"[1, {num_heads}, {Lq}, {Lk}] tensor on q's device")
    out = torch.empty((B, Lq, HD), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_blhd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(),
            B, num_heads, Lq, Lk, Dh,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            float(scale), int(causal), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_blhd kernel launch failed: CUDA error {rc}")
    return out


def _split_packed(qkv: torch.Tensor):
    """q, k, v as views of the packed [B, L, 3*H*Dh] tensor (no copies)."""
    if qkv.shape[-1] % 3:
        raise ValueError(f"packed width {qkv.shape[-1]} is not 3*H*Dh")
    HD = qkv.shape[-1] // 3
    return qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:]


def flash_mha_packed_plain(
    qkv: torch.Tensor,  # [B, L, 3*H*Dh]
    num_heads: int,
    kv_mask: Optional[torch.Tensor] = None,  # [B, L] {0,1}
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,  # [1, H, L, L]
    scale: float = 1.0,
) -> torch.Tensor:
    """The packed kernel's function in plain PyTorch: self-attention over
    the q/k/v column blocks of the packed projection."""
    q, k, v = _split_packed(qkv)
    return flash_mha_blhd_plain(q, k, v, num_heads, kv_mask=kv_mask,
                                causal=causal, bias=bias, scale=scale)


def flash_mha_packed(
    qkv: torch.Tensor,  # [B, L, 3*H*Dh], contiguous
    num_heads: int,
    kv_mask: Optional[torch.Tensor] = None,  # [B, L] int32 {0,1}
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,  # [1, H, L, L], qkv's dtype
    scale: float = 1.0,
) -> torch.Tensor:
    """Self-attention straight off the packed qkv projection, [B, L, H*Dh] out.

    The TPU kernel's contract: self-attention only (Lq = Lk = L), causal
    offset 0. CPU tensors take :func:`flash_mha_packed_plain`. CUDA tensors
    launch ``csrc/flash_blhd.cu`` on three strided views of ``qkv`` (row
    stride 3*H*Dh, column offsets 0, H*Dh, 2*H*Dh) and add one to
    ``flash_mha_packed.launches``; what the kernel does not take raises, as
    for :func:`flash_mha_blhd`."""
    if qkv.device.type == "cpu":
        return flash_mha_packed_plain(qkv, num_heads, kv_mask=kv_mask,
                                      causal=causal, bias=bias, scale=scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_mha_packed: no kernel for device {qkv.device}")
    if not qkv.is_contiguous():
        raise ValueError("flash_mha_packed: qkv must be contiguous")
    q, k, v = _split_packed(qkv)
    out = _launch(q, k, v, num_heads, kv_mask, causal, bias, scale)
    flash_mha_packed.launches += 1
    return out


flash_mha_packed.launches = 0
