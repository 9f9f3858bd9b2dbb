"""W4A8 GEMM over group-wise int4 weights: packing, wrapper, plain version,
launch count.

Counterpart of ``llmrankers_tpu/ops/int4_matmul.py`` (``pack_int4``,
``unpack_int4``, ``quantized_matmul_int4``, body ``_kernel_w4a8``), with its
byte layout, so packed weights carry across unchanged. Weights are symmetric
int4 in [-7, 7] per (group of G input rows, output column), G the largest of
512, 256, 128 that divides K, with f32 scales ``[K/G, N]``; per group, packed
row r holds ``(hi4 << 4) | (lo4 + 8)``: lo4 is the weight of input row
``gG + r`` and hi4 that of ``gG + G/2 + r``. Activations are quantized to
int8 per row and per group (the W8A8 kernels' quantization with a K-block of
G); each group's sum ``D = q_lo . lo4 + q_hi . hi4`` is an exact integer,
folded into an f32 accumulator as ``(D * sx) * sw[g]``.

The kernel takes the packed leaf K-major (``int8_matmul.check_kmajor``): an
``[N, K/2]`` buffer seen through its transpose, shape ``[K/2, N]`` with
stride ``(1, K/2)``, the same bytes as JAX's leaf (``models/quant.py`` lays
the decoder's int4 leaves out so). On a CUDA tensor
:func:`quantized_matmul_int4` launches the hand-written kernel of
``csrc/int4_w4a8.cu`` (bf16 x, ``sm_90a``) or raises; on a CPU tensor it runs
:func:`quantized_matmul_int4_plain`, which computes the same numbers step by
step (the same int8 values, exact integer sums in float64, the same f32 fold
order) from either layout.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .int8_matmul import _check, _check_x, _out_dtype, check_kmajor, quantize_blocks

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# The C entry of csrc/int4_w4a8.cu: pointers, then ints, then the stream.
ENTRY = [_PTR] * 7 + [_I32] * 4 + [_PTR]

GROUP_CANDIDATES = (512, 256, 128)


def choose_group(K: int) -> int:
    """Largest supported quantization group dividing K; 0 when K admits none
    (the site is then not int4-quantized)."""
    for g in GROUP_CANDIDATES:
        if K % g == 0:
            return g
    return 0


def pack_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int4 quantization and nibble packing of
    ``[..., K, N]`` float weights, with the JAX formula in f32: ``amax``
    per group floored at 1e-8, ``scale = amax / 7``, ``q = clip(round(w /
    scale), -7, 7)``. Returns (packed int8 ``[..., K/2, N]``, f32 scales
    ``[..., K/G, N]``)."""
    K, N = w.shape[-2], w.shape[-1]
    G = choose_group(K)
    if G == 0:
        raise ValueError(f"int4 needs K divisible by one of {GROUP_CANDIDATES}, got {K}")
    lead = w.shape[:-2]
    wf = w.float().reshape(*lead, K // G, G, N)
    amax = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8)
    scale = amax / 7.0  # [-7, 7]: symmetric, -8 unused
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int32)
    lo = q[..., : G // 2, :] + 8  # biased to [1, 15]
    hi = q[..., G // 2:, :]
    packed = ((lo & 0xF) | (hi * 16)).to(torch.int8)
    return packed.reshape(*lead, K // 2, N), scale.reshape(*lead, K // G, N)


def unpack_int4(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``[..., K/2, N]`` packed int8 and ``[..., K/G, N]`` scales -> ``[...,
    K, N]`` weights in the scales' dtype (the dequantized site of a model
    whose int4 sites run without the kernel)."""
    Kh, N = packed.shape[-2], packed.shape[-1]
    nk = scales.shape[-2]
    G = 2 * Kh // nk
    lead = packed.shape[:-2]
    p32 = packed.to(torch.int32).reshape(*lead, nk, G // 2, N)
    lo = (p32 & 0xF) - 8
    hi = p32 >> 4  # arithmetic: the high nibble is signed
    q = torch.cat([lo, hi], dim=-2).to(scales.dtype)
    return (q * scales[..., None, :]).reshape(*lead, 2 * Kh, N)


def _group(K: int, Kh: int, sw: torch.Tensor) -> int:
    nk = sw.shape[0]
    G = K // nk if nk else 0
    if 2 * Kh != K or G * nk != K or G not in GROUP_CANDIDATES:
        raise ValueError(f"packed [{Kh}, N] and scales {tuple(sw.shape)} do not fit K={K}")
    return G


def quantized_matmul_int4_plain(
    x: torch.Tensor,  # [..., K] bf16/f32
    p4: torch.Tensor,  # [K/2, N] packed int4
    sw: torch.Tensor,  # [K/G, N] f32 group scales
    residual: Optional[torch.Tensor] = None,  # [..., N]
) -> torch.Tensor:
    """The W4A8 kernel's function in plain PyTorch, ``[..., N]`` in x's
    dtype, in the TPU body's order: per group ``d = float(q_lo . lo - 8
    sum(q_lo)) + float(q_hi . hi16) * 0.0625``, ``acc += (d * sx) * sw[g]``."""
    K = x.shape[-1]
    Kh, N = p4.shape
    G = _group(K, Kh, sw)
    half = G // 2
    q, scale = quantize_blocks(x.reshape(-1, K), G)  # [M, nk, G], [M, nk]
    p32 = p4.to(torch.int32).reshape(-1, half, N)
    lo = (p32 & 0xF).double()  # lo4 + 8
    hi16 = (p32 & -16).double()  # 16 * hi4, the signed high nibble in place
    swf = sw.float()
    acc = None
    for g in range(p32.shape[0]):
        qlo, qhi = q[:, g, :half].double(), q[:, g, half:].double()
        d_lo = qlo @ lo[g] - 8 * qlo.sum(dim=1, keepdim=True)
        d = d_lo.float() + (qhi @ hi16[g]).float() * 0.0625
        term = d * scale[:, g:g + 1] * swf[g]
        acc = term if acc is None else acc + term
    if residual is not None:
        acc = acc + residual.reshape(-1, N).float()
    return acc.to(_out_dtype(x)).reshape(*x.shape[:-1], N)


def _lib() -> ctypes.CDLL:
    lib = _build.load("int4_w4a8")
    if lib.quantized_matmul_int4_bf16.argtypes is None:
        lib.quantized_matmul_int4_bf16.argtypes = ENTRY
        lib.quantized_matmul_int4_bf16.restype = _I32
    return lib


def quantized_matmul_int4(
    x: torch.Tensor,  # [..., K] bf16 (f32 on the CPU)
    p4: torch.Tensor,  # [K/2, N] packed int4
    sw: torch.Tensor,  # [K/G, N] f32
    residual: Optional[torch.Tensor] = None,  # [..., N]
) -> torch.Tensor:
    """W4A8 ``x @ unpack(p4, sw) (+ residual)`` over any leading dims.

    CPU tensors take :func:`quantized_matmul_int4_plain`. CUDA tensors launch
    the quantize pass and the wgmma GEMM of ``csrc/int4_w4a8.cu`` on the
    current stream and add one to ``quantized_matmul_int4.launches``; what
    the kernel does not take raises: x other than contiguous bf16, a group
    other than 128, 256 or 512, N not a multiple of 128, a packed leaf that
    is not K-major (``int8_matmul.check_kmajor``), tensors off x's device,
    unaligned base pointers. Ragged M is masked inside the kernel."""
    if x.device.type == "cpu":
        return quantized_matmul_int4_plain(x, p4, sw, residual)
    lead, K = x.shape[:-1], x.shape[-1]
    Kh, N = p4.shape
    x2 = _check_x("quantized_matmul_int4", x, K, N)
    G = _group(K, Kh, sw)
    M = x2.shape[0]
    res2 = None
    if residual is not None:
        if not residual.is_contiguous():
            raise ValueError("residual: the kernel takes a contiguous tensor")
        res2 = residual.reshape(M, N)
        _check("residual", res2, torch.bfloat16, (M, N), x.device)
    check_kmajor("p4", p4, Kh, N, x.device)
    _check("sw", sw, torch.float32, (K // G, N), x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    x8 = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, K // G), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quantized_matmul_int4_bf16(
            x2.data_ptr(), p4.data_ptr(), sw.data_ptr(),
            None if res2 is None else res2.data_ptr(), x8.data_ptr(), sx.data_ptr(),
            out.data_ptr(), M, K, N, G, stream)
    if rc != 0:
        raise RuntimeError(f"int4_w4a8 quantized_matmul_int4 launch failed: error {rc} "
                           f"(> 0 CUDA runtime, < 0 -CUresult of a tensor map, -1000 no "
                           f"tensor-map encoder)")
    quantized_matmul_int4.launches += 1
    return out.reshape(*lead, N)


quantized_matmul_int4.launches = 0
