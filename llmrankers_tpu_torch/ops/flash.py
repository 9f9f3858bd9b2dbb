"""Flash attention: wrappers, plain versions, counts.

Counterparts of ``llmrankers_tpu/ops/flash.py::flash_mha_blhd``,
``::flash_mha_packed`` and ``::flash_mha``. Each wrapper, on a CUDA tensor,
launches the hand-written kernel ``csrc/flash_blhd.cu`` (bf16, ``sm_90a``)
or raises; on a CPU tensor it runs its plain version, which computes what
the kernel computes with the TPU kernel's masking constants, so fully masked
rows come out as zeros. The kernel reads q, k, v and the bias by TMA
through 4-D tensor maps that the wrapper's checks admit (:func:`_tma_strides`):
every tensor is addressed by its batch, head and row strides:

- :func:`flash_mha_blhd` on the ``[B, L, H*Dh]`` projection layout (head
  stride Dh);
- :func:`flash_mha_packed` on q, k and v read straight out of one packed
  ``[B, L, 3*H*Dh]`` qkv projection: three strided views at column offsets
  0, H*Dh and 2*H*Dh, no slice copies;
- :func:`flash_mha` on ``[B, H, L, Dh]`` (any strides with contiguous head
  rows), GQA-native: K/V may carry fewer heads, query head h reads K/V head
  h // G, and the repeated K/V is never built. It adds a causal sliding
  window in index space.
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


_STRIDES = ctypes.c_longlong * 12
# The kernel's tiles (csrc/flash_blhd.cu): query rows and keys per block and
# tile, ring depth, and the shared memory a block may take on sm_90.
BLOCK_Q, BLOCK_K, STAGES = 128, 64, 4
MAX_SMEM = 232448


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_blhd")
    fn = lib.flash_attn_bf16
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = (
            [ptr] * 6 + [i32] * 6 + [_STRIDES, ctypes.c_float, i32, i32, ptr]
        )
        fn.restype = ctypes.c_int
        lib.flash_smem_bytes.argtypes = [i32, i32, i32]
        lib.flash_smem_bytes.restype = i32
    return lib


def _smem_bytes(dh: int, lk: int, has_bias: bool) -> int:
    """Dynamic shared memory of one block, as ``smem_plan`` in the kernel
    lays it out: Q, the ring (K, V and the bias tile per stage), the
    mbarriers, one validity bit per key of whole key tiles, the tile list,
    and 1024 bytes to align the base."""
    tiles = -(-lk // BLOCK_K)
    ring = STAGES * (2 * BLOCK_K * dh * 2 + (BLOCK_Q * BLOCK_K * 2 if has_bias else 0))
    return (BLOCK_Q * dh * 2 + ring + 8 * (2 * STAGES + 1) + 4 * tiles * (BLOCK_K // 32)
            + 4 * tiles + 4 + 1024)


def _tma_strides(name: str, x: torch.Tensor) -> tuple:
    """(batch, head, row) strides of a [B, H, L, Dh] view, in elements, as
    the kernel's 4-D tensor maps take them, or raise on what TMA cannot
    describe: the last stride must be 1, the others whole 16 bytes (8
    elements) and below 2^40 bytes, the base 16-byte aligned. The stride of a
    dimension of size 1 is never stepped, so it is given as Dh."""
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: rows must be contiguous (last stride 1), "
                         f"got strides {tuple(x.stride())}")
    out = []
    for size, st in zip(x.shape[:3], x.stride()[:3]):
        st = x.shape[3] if size == 1 else st
        if st <= 0 or st % 8 or 2 * st >= 2**40:
            raise ValueError(f"{name}: TMA needs strides of whole 16 bytes (a multiple "
                             f"of 8 elements, positive, below 2^40 bytes), got "
                             f"strides {tuple(x.stride())}")
        out.append(st)
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: base pointer must be 16-byte aligned for TMA")
    return tuple(out)


def key_tiles(mask_row, lq: int, lk: int, q0: int, causal: bool = False,
              window: Optional[int] = None):
    """The key tiles that the block of query rows [q0, q0 + BLOCK_Q) loads,
    as the kernel lists them: inside its causal and window range and holding
    a valid key (``mask_row`` [Lk] {0,1}, or None for all valid); each as
    (tile index, every key of the tile valid)."""
    valid = [True] * lk if mask_row is None else [bool(x) for x in mask_row]
    t_begin, t_end = 0, -(-lk // BLOCK_K)
    if causal:
        off = lk - lq
        t_end = -(-min(lk, max(0, q0 + BLOCK_Q + off)) // BLOCK_K)
        if window:
            t_begin = max(0, q0 + off - window + 1) // BLOCK_K
    out = []
    for t in range(t_begin, t_end):
        keys = [valid[c] if c < lk else False
                for c in range(t * BLOCK_K, (t + 1) * BLOCK_K)]
        if any(keys):
            out.append((t, all(keys)))
    return out


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
    batch other than 1 or not contiguous, a mask other than int32, strides
    or bases TMA cannot describe (:func:`_tma_strides`), a bias with Lk not a
    multiple of 8, or an Lk whose key bits overflow shared memory."""
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
    """Launch the kernel on [B, L, H*Dh] q/k/v (views allowed): each as a
    [B, H, L, Dh] view with head stride Dh."""
    B, Lq, HD = q.shape
    if HD % num_heads:
        raise ValueError(f"H*Dh={HD} is not divisible by num_heads={num_heads}")
    if k.shape != (B, k.shape[1], HD) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    Dh = HD // num_heads

    def heads(x: torch.Tensor) -> torch.Tensor:
        return x.unflatten(-1, (num_heads, Dh)).transpose(1, 2)

    out = torch.empty((B, Lq, HD), dtype=q.dtype, device=q.device)
    _launch_bhld(heads(q), heads(k), heads(v), heads(out), kv_mask, causal,
                 bias, scale, None)
    return out


def _launch_bhld(q, k, v, out, kv_mask, causal, bias, scale, window) -> None:
    """Check [B, H, L, Dh] views q, k, v (K/V heads dividing H) and ``out``,
    and launch flash_blhd.cu into ``out``."""
    B, H, Lq, Dh = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    if Dh % 16 or Dh > 128:
        raise ValueError(f"flash kernel needs Dh % 16 == 0 and Dh <= 128, got {Dh}")
    if KV == 0 or H % KV or k.shape != (B, KV, Lk, Dh) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match (K/V heads must divide H)")
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window {window} needs causal attention and window >= 1")
    strides = []
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.device != q.device or x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: flash kernel takes bf16 on {q.device}, "
                             f"got {x.dtype} on {x.device}")
        strides += _tma_strides(name, x)
    if kv_mask is not None and (
        kv_mask.shape != (B, Lk) or kv_mask.dtype != torch.int32
        or kv_mask.device != q.device or not kv_mask.is_contiguous()
    ):
        raise ValueError("kv_mask must be a contiguous int32 [B, Lk] tensor "
                         "on q's device")
    if bias is not None:
        if bias.shape[0] != 1:
            raise ValueError("flash path requires batch-invariant bias")
        if (bias.shape != (1, H, Lq, Lk) or bias.dtype != q.dtype
                or bias.device != q.device or not bias.is_contiguous()):
            raise ValueError(f"bias must be a contiguous {q.dtype} "
                             f"[1, {H}, {Lq}, {Lk}] tensor on q's device")
        if Lk % 8 or bias.data_ptr() % 16:
            raise ValueError(f"bias: TMA needs Lk a multiple of 8 (rows of whole 16 "
                             f"bytes) and a 16-byte aligned base, got Lk {Lk}")
    smem = _smem_bytes(Dh, Lk, bias is not None)
    if smem > MAX_SMEM:
        raise ValueError(f"flash kernel: Dh {Dh}, Lk {Lk}"
                         f"{' with a bias' if bias is not None else ''} needs {smem} "
                         f"bytes of shared memory, above {MAX_SMEM}")
    if out.numel() == 0:
        return
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attn_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(),
            B, H, Lq, Lk, Dh, H // KV, _STRIDES(*strides),
            float(scale), int(causal), int(window or 0), stream,
        )
    if rc == -1000:
        raise RuntimeError("flash kernel: the driver has no cuTensorMapEncodeTiled")
    if rc < 0:
        raise RuntimeError(f"flash kernel: tensor map encoding failed (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {rc}")


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


def flash_mha_plain(
    q: torch.Tensor,  # [B, H, Lq, Dh]
    k: torch.Tensor,  # [B, KV, Lk, Dh], KV | H
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,  # [B, Lk] {0,1}
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,  # [1, H, Lq, Lk]
    scale: float = 1.0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function on [B, H, L, Dh] in plain PyTorch, in one
    softmax pass: K/V head h // G for query head h, the key penalty added,
    causal and window positions set to -1e30, and the TPU kernel's floors,
    so fully masked rows come out as zeros."""
    if bias is not None and bias.shape[0] != 1:
        raise ValueError("flash path requires batch-invariant bias")
    if window is not None and not causal:
        raise ValueError("window requires causal attention")
    Lq, Lk = q.shape[2], k.shape[2]
    G = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf)
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + bias.float()
    if kv_mask is not None:
        s = s + ((1.0 - kv_mask.float()) * NEG_INF)[:, None, None, :]
    if causal:
        rel = (torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
               - torch.arange(Lk, device=q.device)[None, :])
        vis = rel >= 0
        if window is not None:
            vis = vis & (rel < window)
        s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf)
    return (out / l.clamp_min(1e-30)).to(q.dtype)


def flash_mha(
    q: torch.Tensor,  # [B, H, Lq, Dh]
    k: torch.Tensor,  # [B, KV, Lk, Dh], KV | H
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,  # [B, Lk] int32 {0,1}
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,  # [1, H, Lq, Lk], q's dtype
    scale: float = 1.0,
    window: Optional[int] = None,  # causal sliding window, index space
) -> torch.Tensor:
    """GQA-native flash attention on [B, H, L, Dh]; returns [B, H, Lq, Dh].

    The causal diagonal sits at offset Lk - Lq: with keys ``[prefix |
    block]`` query row i sees every prefix key and block keys up to i.
    CPU tensors take :func:`flash_mha_plain`. CUDA tensors launch the
    kernel on the current stream, without synchronising, and add one to
    ``flash_mha.launches``; the output is a [B, H, Lq, Dh] view of a
    ``[B, Lq, H, Dh]`` buffer, so merging its heads back into ``[B, Lq,
    H*Dh]`` is free. What the kernel does not take raises, as for
    :func:`flash_mha_blhd`, and so does a window without ``causal``."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, kv_mask=kv_mask, causal=causal,
                               bias=bias, scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: no kernel for device {q.device}")
    B, H, Lq, Dh = q.shape
    out = torch.empty((B, Lq, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    _launch_bhld(q, k, v, out, kv_mask, causal, bias, scale, window)
    flash_mha.launches += 1
    return out


flash_mha.launches = 0
