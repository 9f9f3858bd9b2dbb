"""W8A8 int8 GEMMs: wrappers, plain versions, K-block rule, launch counts.

Counterparts of ``llmrankers_tpu/ops/int8_matmul.py::quantized_matmul``
(body ``_kernel_fusedq``), ``::gated_matmul`` and ``::gated_matmul_pair``
(body ``_kernel_gated``), and ``::int8_matmul`` (body ``_kernel``).
Weights are symmetric per-output-channel int8 ``[K, N]`` with ``[1, N]``
scales (f32, or the decoder's bf16, taken in f32); activations are quantized
per row and per K-block of ``kblock`` columns (one scale each), the int8
products are summed exactly in int32 within a K-block, and each block's sum
is folded into an f32 accumulator times its row scale. The epilogue
multiplies the column scale (and adds a residual, or applies
``act(h0) * h1`` over the two halves of a packed gated weight or over two
separate weights). ``int8_matmul`` takes
activations the caller quantized per row (:func:`quantize_rows`) and sums
over all of K.

On a CUDA tensor :func:`quantized_matmul`, :func:`gated_matmul`,
:func:`gated_matmul_pair` and :func:`int8_matmul` launch the hand-written
kernels of ``csrc/int8_fusedq.cu`` (bf16 x, ``sm_90a``) or raise;
:func:`quantized_matmul` (B3), :func:`gated_matmul` (B4) and
:func:`gated_matmul_pair` (B6), on ``wgmma``, take their weights K-major
(:func:`check_kmajor`), :func:`int8_matmul` (B9) row-major and contiguous.
On a CPU tensor they run the plain versions, which compute the same numbers
step by step: the same quantized int8 values, exact integer sums (taken in
float64, exact below 2^53), the same f32 fold order.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

GELU_C = 0.7978845608028654  # sqrt(2/pi)
_VMEM_BUDGET = 13 * 2**20


def _largest_divisor(n: int, cap: int, step: int = 128) -> int:
    """Largest multiple of ``step`` that divides ``n`` and is <= cap; 0 if none."""
    best, t = 0, step
    while t <= min(n, cap):
        if n % t == 0:
            best = t
        t += step
    return best


def kblock(K: int, N: int, x_dtype: torch.dtype = torch.bfloat16,
           residual: bool = False, gated: bool = False) -> int:
    """The K-block that carries one activation scale per row.

    The JAX kernels' rule, computed the same way so the port quantizes to the
    same int8 values: the largest 128-multiple divisor of K up to 2048,
    halved while it is above 1024 and the TPU kernel's VMEM estimate (which
    depends on N, x's dtype, the residual and the gated variant's output
    dtype) is above 13 MiB. ``N`` is the output width: for ``gated`` the
    width of one half."""
    xbytes = torch.empty((), dtype=x_dtype).element_size()
    bm = 256
    bk = _largest_divisor(K, 2048)
    if gated:
        bn = _largest_divisor(N, 512)
    else:
        bn = _largest_divisor(N, 2048)
    if bn == 0 or bk == 0:
        raise ValueError(f"int8 matmul needs 128-multiple divisible K/N, got {K}x{N}")

    def vmem(bk_: int) -> int:
        nk_ = K // bk_
        if gated:
            return (2 * (bm * bk_ * xbytes + 2 * bk_ * bn) + 2 * 4 * bm * bn
                    + 2 * bm * bn * xbytes * 2 + nk_ * bm * (bk_ + 4)
                    + bm * bk_ * 4)
        res_bytes = 2 * bm * bn * 2 if residual else 0
        return (2 * (bm * bk_ * xbytes + bk_ * bn) + 4 * bm * bn + 4 * bm * bn
                + res_bytes + nk_ * bm * (bk_ + 4) + bm * bk_ * 4)

    while bk > 1024 and vmem(bk) > _VMEM_BUDGET:
        bk //= 2
    return bk


_kblock_rule = kblock  # the plain versions' argument of the same name shadows it


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _inv127(device) -> torch.Tensor:
    # f32(1/127) as JAX forms it from the Python float.
    return torch.tensor(1.0 / 127.0, dtype=torch.float32, device=device)


def quantize_blocks(x: torch.Tensor, kb: int):
    """Per-row, per-K-block symmetric int8 quantization of ``[M, K]`` x, as
    the TPU body does it: ``scale = max(amax, 1e-8) * f32(1/127)``, then
    ``clip(rint(x * (1 / scale)), -127, 127)``. Returns the quantized values
    as float32 ``[M, nk, kb]`` and the f32 scales ``[M, nk]``."""
    M, K = x.shape
    xf = x.float().reshape(M, K // kb, kb)
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) * _inv127(x.device)
    q = torch.clamp(torch.round(xf * (1.0 / scale)[..., None]), -127, 127)
    return q, scale


def _fold(q: torch.Tensor, scale: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """sum over K-blocks of float(int32 block sum) * row scale, in f32, in
    block order. The block sums are exact: float64 holds every int32."""
    M, nk, kb = q.shape
    w = w8.double().reshape(nk, kb, -1)
    acc = None
    for b in range(nk):
        d = (q[:, b].double() @ w[b]).float()
        term = d * scale[:, b:b + 1]
        acc = term if acc is None else acc + term
    return acc


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.dtype == torch.float32 else x.dtype


def quantized_matmul_plain(
    x: torch.Tensor,  # [..., K] bf16/f32
    w8: torch.Tensor,  # [K, N] int8
    sw: torch.Tensor,  # [1, N] f32 or bf16
    residual: Optional[torch.Tensor] = None,  # [..., N]
    kblock: Optional[int] = None,
) -> torch.Tensor:
    """The W8A8 kernel's function in plain PyTorch, ``[..., N]`` in x's
    dtype. ``kblock`` overrides the K-block rule."""
    K, N = w8.shape
    kb = kblock or _kblock_rule(K, N, x.dtype, residual is not None)
    q, scale = quantize_blocks(x.reshape(-1, K), kb)
    out = _fold(q, scale, w8) * sw.float().reshape(1, N)
    if residual is not None:
        out = out + residual.reshape(-1, N).float()
    return out.to(_out_dtype(x)).reshape(*x.shape[:-1], N)


def act_fn(name: str, h: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's epilogue activations, in its order of operations."""
    if name == "gelu_new":
        return 0.5 * h * (1.0 + torch.tanh(GELU_C * (h + 0.044715 * h * h * h)))
    if name == "relu":
        return torch.clamp_min(h, 0.0)
    if name == "silu":
        return h * torch.sigmoid(h)
    raise ValueError(f"unknown activation {name!r}")


def gated_matmul_plain(
    x: torch.Tensor,  # [..., K]
    wp: torch.Tensor,  # [K, 2N] int8: w0 | w1
    sp: torch.Tensor,  # [1, 2N] f32
    act: str = "gelu_new",
    kblock: Optional[int] = None,
) -> torch.Tensor:
    """``act(x @ w0) * (x @ w1)`` of the gated kernel in plain PyTorch,
    ``[..., N]`` in x's dtype."""
    K, N2 = wp.shape
    N = N2 // 2
    kb = kblock or _kblock_rule(K, N, x.dtype, gated=True)
    q, scale = quantize_blocks(x.reshape(-1, K), kb)
    sp = sp.float().reshape(1, N2)
    h0 = _fold(q, scale, wp[:, :N]) * sp[:, :N]
    h1 = _fold(q, scale, wp[:, N:]) * sp[:, N:]
    return (act_fn(act, h0) * h1).to(_out_dtype(x)).reshape(*x.shape[:-1], N)


def gated_matmul_pair_plain(
    x: torch.Tensor,  # [..., K]
    w0: torch.Tensor,  # [K, N] int8 (gate)
    s0: torch.Tensor,  # [1, N]
    w1: torch.Tensor,  # [K, N] int8 (up)
    s1: torch.Tensor,  # [1, N]
    act: str = "silu",
) -> torch.Tensor:
    """``act(x @ w0) * (x @ w1)`` over two separate int8 weights in plain
    PyTorch, ``[..., N]`` in x's dtype. The TPU kernel's K-block is that of
    the packed gated kernel with N the width of one weight."""
    K, N = w0.shape
    kb = kblock(K, N, x.dtype, gated=True)
    q, scale = quantize_blocks(x.reshape(-1, K), kb)
    h0 = _fold(q, scale, w0) * s0.float().reshape(1, N)
    h1 = _fold(q, scale, w1) * s1.float().reshape(1, N)
    return (act_fn(act, h0) * h1).to(_out_dtype(x)).reshape(*x.shape[:-1], N)


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization of ``[M, K]`` x, as the JAX
    ``quantize_rows`` writes it (a division, where the kernels multiply by a
    reciprocal): ``scale = max(amax, 1e-8) / 127``, ``clip(round(x /
    scale), -127, 127)``. Returns (int8 ``[M, K]``, f32 scales ``[M, 1]``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def int8_matmul_plain(
    x8: torch.Tensor,  # [M, K] int8
    sx: torch.Tensor,  # [M, 1] f32
    w8: torch.Tensor,  # [K, N] int8
    sw: torch.Tensor,  # [1, N] f32
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``(float(x8 @ w8) * sx) * sw`` in plain PyTorch: the int32 sum over all
    of K (exact in float64), converted to f32 once."""
    acc = (x8.double() @ w8.double()).float()
    return (acc * sx.float() * sw.float()).to(out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
_ACTS = {"gelu_new": 0, "relu": 1, "silu": 2}


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# The C entries of csrc/int8_fusedq.cu: pointers, then ints, then the stream.
ENTRIES = {
    "quantized_matmul_bf16": [_PTR] * 7 + [_I32] * 5 + [_PTR],
    "gated_matmul_bf16": [_PTR] * 6 + [_I32] * 5 + [_PTR],
    "gated_matmul_pair_bf16": [_PTR] * 8 + [_I32] * 6 + [_PTR],
    "int8_matmul_bf16": [_PTR] * 5 + [_I32] * 3 + [_PTR],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_fusedq")
    if lib.quantized_matmul_bf16.argtypes is None:
        for name, argtypes in ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, _I32
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name}: the kernel takes a contiguous {dtype} "
                         f"{list(shape)} tensor on {device}, got {t.dtype} "
                         f"{list(t.shape)} on {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: base pointer must be 16-byte aligned")


def check_kmajor(name: str, w: torch.Tensor, K: int, N: int, device=None) -> None:
    """Raise unless ``w`` is the K-major int8 ``[K, N]`` weight that B3's,
    B4's and B6's kernels load by TMA (or B7's packed int4 leaf, with ``K/2``
    rows): an ``[N, K]`` buffer seen through its transpose (stride
    ``(1, K)``, ``models/quant.py::to_kmajor``) with a 16-byte-aligned base,
    on ``device`` when one is given. A row-major weight is refused, not
    copied."""
    if device is not None and w.device != device:
        raise ValueError(f"{name}: the kernel takes a tensor on {device}, got {w.device}")
    if w.dtype != torch.int8 or tuple(w.shape) != (K, N):
        raise ValueError(f"{name}: the kernel takes an int8 [{K}, {N}] weight, got "
                         f"{w.dtype} {list(w.shape)}")
    if w.stride() != (1, K):
        raise ValueError(f"{name}: the kernel takes the weight K-major, an [N, K] "
                         f"buffer seen as [K, N] with stride (1, {K}); got stride "
                         f"{tuple(w.stride())}"
                         + (" (row-major)" if w.is_contiguous() else ""))
    if w.data_ptr() % 16:
        raise ValueError(f"{name}: base pointer must be 16-byte aligned")


def _check_scale(name: str, s: torch.Tensor, N: int, device) -> int:
    """A ``[1, N]`` column scale the kernel reads in place: f32, or bf16 (the
    decoder's leaves, widened exactly in the epilogue). Returns 1 for bf16."""
    bf16 = int(s.dtype == torch.bfloat16)
    _check(name, s, torch.bfloat16 if bf16 else torch.float32, (1, N), device)
    return bf16


def _check_x(fn: str, x: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """x as the kernel's [M, K] view, or raise."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {x.device}")
    if K % 128 or N % 128:
        raise ValueError(f"{fn}: K and N must be multiples of 128, got {K}x{N}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: x must be contiguous")
    x2 = x.reshape(-1, K)
    _check("x", x2, torch.bfloat16, (x2.shape[0], K), x.device)
    return x2


def _kblock_128(fn: str, K: int, N: int, x_dtype: torch.dtype, residual: bool = False,
                gated: bool = False) -> int:
    """The K-block rule's value, which the wgmma kernels take in stages of
    128 columns; raises unless it is a whole number of stages."""
    kb = kblock(K, N, x_dtype, residual, gated)
    if kb % 128:
        raise ValueError(f"{fn}: the kernel takes K-blocks of whole 128 columns, the "
                         f"rule gives {kb} at {K}x{N}")
    return kb


def _raise_rc(fn: str, rc: int) -> None:
    """Raise on a wgmma entry's return code: -1000 when the driver has no
    ``cuTensorMapEncodeTiled``, -CUresult when a tensor map could not be
    encoded, else a CUDA runtime error code (0: launched)."""
    if rc == -1000:
        raise RuntimeError(f"int8_fusedq {fn}: the driver has no cuTensorMapEncodeTiled")
    if rc < 0:
        raise RuntimeError(f"int8_fusedq {fn}: tensor map encoding failed (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"int8_fusedq {fn} launch failed: CUDA error {rc}")


def _scratch(x2: torch.Tensor, kb: int):
    M, K = x2.shape
    x8 = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    sx = torch.empty((M, K // kb), dtype=torch.float32, device=x2.device)
    return x8, sx


def quantized_matmul(
    x: torch.Tensor,  # [..., K] bf16 (f32 on the CPU)
    w8: torch.Tensor,  # [K, N] int8
    sw: torch.Tensor,  # [1, N] f32 or bf16
    residual: Optional[torch.Tensor] = None,  # [..., N]
) -> torch.Tensor:
    """Dynamic-activation W8A8 ``x @ (w8 * sw) (+ residual)`` over any
    leading dims.

    CPU tensors take :func:`quantized_matmul_plain`. CUDA tensors launch the
    quantize pass and the wgmma GEMM of ``csrc/int8_fusedq.cu`` on the
    current stream and add one to ``quantized_matmul.launches``; what the
    kernel does not take raises: x other than contiguous bf16, K or N not a
    multiple of 128, a weight that is not K-major (:func:`check_kmajor`),
    tensors off x's device, unaligned base pointers. Ragged M is masked
    inside the kernel."""
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, w8, sw, residual)
    lead, K = x.shape[:-1], x.shape[-1]
    N = w8.shape[1]
    x2 = _check_x("quantized_matmul", x, K, N)
    M = x2.shape[0]
    res2 = None
    if residual is not None:
        if not residual.is_contiguous():
            raise ValueError("residual: the kernel takes a contiguous tensor")
        res2 = residual.reshape(M, N)
    check_kmajor("w8", w8, K, N, x.device)
    sw_bf16 = _check_scale("sw", sw, N, x.device)
    if res2 is not None:
        _check("residual", res2, torch.bfloat16, (M, N), x.device)
    kb = _kblock_128("quantized_matmul", K, N, x.dtype, residual is not None)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    x8, sx = _scratch(x2, kb)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quantized_matmul_bf16(
            x2.data_ptr(), w8.data_ptr(), sw.data_ptr(),
            None if res2 is None else res2.data_ptr(),
            x8.data_ptr(), sx.data_ptr(), out.data_ptr(), M, K, N, kb, sw_bf16, stream)
    _raise_rc("quantized_matmul", rc)
    quantized_matmul.launches += 1
    return out.reshape(*lead, N)


quantized_matmul.launches = 0


def gated_matmul(
    x: torch.Tensor,  # [..., K]
    wp: torch.Tensor,  # [K, 2N] int8: gate | up, K-major on the card
    sp: torch.Tensor,  # [1, 2N] f32
    act: str = "gelu_new",
) -> torch.Tensor:
    """``act(x @ w0) * (x @ w1)`` over one packed int8 weight, any leading
    dims. CPU tensors take :func:`gated_matmul_plain`; CUDA tensors launch
    the quantize pass and the gated wgmma kernel of ``csrc/int8_fusedq.cu``
    (the ``[M, 2N]`` intermediate is never written) and add one to
    ``gated_matmul.launches``, under the checks of :func:`quantized_matmul`
    with N the width of one half: ``wp`` is K-major, a ``[2N, K]`` buffer
    seen as ``[K, 2N]`` (:func:`check_kmajor`), rows ``0..N-1`` the gate's."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return gated_matmul_plain(x, wp, sp, act)
    lead, K = x.shape[:-1], x.shape[-1]
    N = wp.shape[1] // 2
    x2 = _check_x("gated_matmul", x, K, N)
    M = x2.shape[0]
    check_kmajor("wp", wp, K, 2 * N, x.device)
    _check("sp", sp, torch.float32, (1, 2 * N), x.device)
    kb = _kblock_128("gated_matmul", K, N, x.dtype, gated=True)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    x8, sx = _scratch(x2, kb)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gated_matmul_bf16(
            x2.data_ptr(), wp.data_ptr(), sp.data_ptr(), x8.data_ptr(),
            sx.data_ptr(), out.data_ptr(), M, K, N, kb, _ACTS[act], stream)
    _raise_rc("gated_matmul", rc)
    gated_matmul.launches += 1
    return out.reshape(*lead, N)


gated_matmul.launches = 0


def gated_matmul_pair(
    x: torch.Tensor,  # [..., K]
    w0: torch.Tensor,  # [K, N] int8 (gate), K-major on the card
    s0: torch.Tensor,  # [1, N] f32 or bf16
    w1: torch.Tensor,  # [K, N] int8 (up), K-major on the card
    s1: torch.Tensor,  # [1, N], s0's dtype
    act: str = "silu",
) -> torch.Tensor:
    """``act(x @ w0) * (x @ w1)`` over two separate int8 weights (the
    decoder's SwiGLU gate and up), any leading dims. CPU tensors take
    :func:`gated_matmul_pair_plain`; CUDA tensors launch the quantize pass
    and the gated wgmma kernel of ``csrc/int8_fusedq.cu`` on the two weights
    in place (no packed copy; the ``[M, N]`` intermediates are never
    written) and add one to ``gated_matmul_pair.launches``, under the checks
    of :func:`quantized_matmul`: both weights K-major (:func:`check_kmajor`)."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return gated_matmul_pair_plain(x, w0, s0, w1, s1, act)
    lead, K = x.shape[:-1], x.shape[-1]
    N = w0.shape[1]
    x2 = _check_x("gated_matmul_pair", x, K, N)
    M = x2.shape[0]
    for name, w in (("w0", w0), ("w1", w1)):
        check_kmajor(name, w, K, N, x.device)
    s_bf16 = _check_scale("s0", s0, N, x.device)
    _check("s1", s1, s0.dtype, (1, N), x.device)
    kb = _kblock_128("gated_matmul_pair", K, N, x.dtype, gated=True)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    x8, sx = _scratch(x2, kb)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gated_matmul_pair_bf16(
            x2.data_ptr(), w0.data_ptr(), s0.data_ptr(), w1.data_ptr(), s1.data_ptr(),
            x8.data_ptr(), sx.data_ptr(), out.data_ptr(), M, K, N, kb, _ACTS[act], s_bf16,
            stream)
    _raise_rc("gated_matmul_pair", rc)
    gated_matmul_pair.launches += 1
    return out.reshape(*lead, N)


gated_matmul_pair.launches = 0


def int8_matmul(
    x8: torch.Tensor,  # [M, K] int8
    sx: torch.Tensor,  # [M, 1] f32 row scales
    w8: torch.Tensor,  # [K, N] int8
    sw: torch.Tensor,  # [1, N] f32 column scales
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """W8A8 on activations already quantized (:func:`quantize_rows`):
    ``(float(x8 @ w8) * sx) * sw``, ``[M, N]`` in ``out_dtype``. CPU tensors
    take :func:`int8_matmul_plain`; CUDA tensors launch the GEMM of
    ``csrc/int8_fusedq.cu`` with one K-block of K (bf16 output only) and add
    one to ``int8_matmul.launches``. The JAX package has no caller of it on
    its serving paths."""
    if x8.device.type == "cpu":
        return int8_matmul_plain(x8, sx, w8, sw, out_dtype)
    M, K = x8.shape
    N = w8.shape[1]
    if x8.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {x8.device}")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"int8_matmul: the kernel writes bfloat16, not {out_dtype}")
    if K % 128 or N % 128:
        raise ValueError(f"int8_matmul: K and N must be multiples of 128, got {K}x{N}")
    _check("x8", x8, torch.int8, (M, K), x8.device)
    _check("sx", sx, torch.float32, (M, 1), x8.device)
    _check("w8", w8, torch.int8, (K, N), x8.device)
    _check("sw", sw, torch.float32, (1, N), x8.device)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x8.device)
    if M == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x8.device):
        stream = torch.cuda.current_stream(x8.device).cuda_stream
        rc = lib.int8_matmul_bf16(x8.data_ptr(), sx.data_ptr(), w8.data_ptr(), sw.data_ptr(),
                                  out.data_ptr(), M, K, N, stream)
    if rc != 0:
        raise RuntimeError(f"int8_fusedq int8_matmul launch failed: CUDA error {rc}")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
