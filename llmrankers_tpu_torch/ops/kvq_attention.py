"""One-token decode attention over a quantized KV cache: the cache's dot
products, the plain version, the wrapper and its launch count.

Counterpart of ``llmrankers_tpu/ops/kvq_attention.py`` (``kvq_decode_attention``,
body ``_kernel``) and of the ``_cached_qk``/softmax/``_cached_pv``/self-term
block of ``llmrankers_tpu/engine/generate.py::_decode_token_forward``, which is
the plain version here. GQA: the query is ``[B, KV, G, Dh]``, query group g of
KV head kv reads that head's cache. The cache is an int8 payload ``[B, KV, T,
Dhp]`` with f32 scales ``[B, KV, T, S]`` per position and head: int8 (Dhp = Dh,
S = 1) or planar int4 (Dhp = Dh/2, S = 2: the low nibble of byte j holds dim
j, the high nibble dim Dh/2 + j, each half with its own scale). The k scale
folds in after the q.k dot, per nibble plane; the v scale folds into the
probabilities before the p.v dot; masked keys (the window included) drop out
of the softmax; the current token's unquantized k/v join it last as a rank-1
self term. The output is f32 ``[B, KV, G, Dh]``.

On a CUDA tensor :func:`kvq_decode_attention` launches the hand-written kernel
of ``csrc/kvq_decode.cu`` (bf16 q, ``sm_90a``) or raises; on a CPU tensor it
runs :func:`kvq_decode_attention_plain`. The kernel is one launch of
``B * KV`` thread-block clusters (:func:`cluster_size` blocks each) that load
only the cache tiles :func:`key_tiles` lists.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple, Union

import torch

from . import _build

NEG_INF = -1e9  # the decode path's masked score (engine/generate.py)
# Mirrors of csrc/kvq_decode.cu's constants:
MAX_GROUP = 8  # query heads per KV head (MAXG: the mma rows)
TILE = 64  # cache positions per tile (TILE)
STAGES = 6  # tiles in flight per block (STAGES)
MAX_CLUSTER = 8  # blocks per (b, kv) cluster, the portable size (MAX_CLUSTER)
SMEM_LIMIT = 224256  # dynamic shared memory a block may use (SMEM_LIMIT: 8 KB static)

Cache = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def unpack4(packed: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planar int4 bytes -> (lower-half, upper-half) values in ``dtype``:
    the sign-extended low and high nibbles."""
    p = packed.to(torch.int32)
    return ((p << 28) >> 28).to(dtype), (p >> 4).to(dtype)


def _texp(scale_t: torch.Tensor, out_ndim: int) -> torch.Tensor:
    """A per-(B, KV, T) scale shaped to broadcast against scores or
    probabilities of rank ``out_ndim`` whose last axis is T."""
    for _ in range(out_ndim - 3):
        scale_t = scale_t[:, :, None]
    return scale_t


def _dot(sub: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of operands in any float type, products summed in f32 (the
    JAX ``preferred_element_type=float32``)."""
    return torch.einsum(sub, a.float(), b.float())


def cached_qk(qg: torch.Tensor, kc: Cache, dtype: torch.dtype, mode: Optional[str],
              sub: str) -> torch.Tensor:
    """q.K^T against a cached K in any mode (None, 'int8', 'int4'); ``sub``
    contracts d, with K's T axis second to last. The k scale folds in after
    the dot (it is per output column t); int4 runs one half-Dh dot per
    nibble plane, each with its own scale."""
    if mode == "int4":
        kp, ks = kc
        h = qg.shape[-1] // 2
        k_lo, k_hi = unpack4(kp, dtype)
        s_lo = _dot(sub, qg[..., :h], k_lo)
        s_hi = _dot(sub, qg[..., h:], k_hi)
        nd = s_lo.ndim
        return s_lo * _texp(ks[..., 0], nd) + s_hi * _texp(ks[..., 1], nd)
    if mode:  # int8
        k8, ksl = kc
        s = _dot(sub, qg, k8.to(dtype))
        return s * _texp(ksl[..., 0], s.ndim)
    return _dot(sub, qg, kc)


def cached_pv(p: torch.Tensor, vc: Cache, dtype: torch.dtype, mode: Optional[str],
              sub: str) -> torch.Tensor:
    """Probabilities . V against a cached V in any mode; ``sub`` contracts
    t. The per-t v scale folds into p before the dot (p then in ``dtype``);
    int4 runs one half-dot per nibble plane and concatenates along Dh."""
    if mode == "int4":
        vp, vs = vc
        v_lo, v_hi = unpack4(vp, dtype)
        a_lo = _dot(sub, (p * _texp(vs[..., 0], p.ndim)).to(dtype), v_lo)
        a_hi = _dot(sub, (p * _texp(vs[..., 1], p.ndim)).to(dtype), v_hi)
        return torch.cat([a_lo, a_hi], dim=-1)
    if mode:  # int8
        v8, vsl = vc
        return _dot(sub, (p * _texp(vsl[..., 0], p.ndim)).to(dtype), v8.to(dtype))
    return _dot(sub, p.to(dtype), vc)


def kvq_decode_attention_plain(
    qg: torch.Tensor,  # [B, KV, G, Dh]
    kc: Cache,  # [B, KV, T, Dh], or (payload [B, KV, T, Dhp], scales [B, KV, T, S])
    vc: Cache,
    k_new: torch.Tensor,  # [B, KV, Dh] the current token's K, unquantized
    v_new: torch.Tensor,  # [B, KV, Dh]
    amask: torch.Tensor,  # [B, T] bool key validity, the window included
    scale: float,
    mode: Optional[str],  # None | 'int8' | 'int4'
) -> torch.Tensor:
    """The decode step's attention in plain PyTorch, f32 [B, KV, G, Dh]: the
    JAX decode block, op for op (scores in f32, masked to -1e9, the self
    term joined as an online-softmax term)."""
    dtype = qg.dtype
    s = cached_qk(qg, kc, dtype, mode, "bkgd,bktd->bkgt") * scale
    s = s.masked_fill(~amask[:, None, None, :], NEG_INF)
    s_self = _dot("bkgd,bkd->bkg", qg, k_new) * scale
    m = torch.maximum(s.amax(dim=-1), s_self)  # [B, KV, G]
    p = torch.exp(s - m[..., None])
    p_self = torch.exp(s_self - m)
    z = p.sum(dim=-1) + p_self
    return (cached_pv(p, vc, dtype, mode, "bkgt,bktd->bkgd")
            + p_self[..., None] * v_new.float()[:, :, None, :]) / z[..., None]


def _lib() -> ctypes.CDLL:
    lib = _build.load("kvq_decode")
    fn = lib.kvq_decode_bf16
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 9 + [i32] * 7 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        lib.kvq_smem_bytes.argtypes = [i32] * 3
        lib.kvq_max_active_clusters.argtypes = [i32] * 4
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> torch.Tensor:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"kvq_decode_attention: {name} must be {dtype} {list(shape)} on "
                         f"{device}, got {t.dtype} {list(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"kvq_decode_attention: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"kvq_decode_attention: {name}: base pointer must be 16-byte aligned")
    return t


def n_tiles(T: int) -> int:
    """``TILE``-position tiles of a cache of length T (the last may be partial)."""
    return -(-T // TILE)


def _smem_bytes(Dh: int, int4: bool, T: int) -> int:
    """A block's dynamic shared memory (``kvq_smem_bytes`` in the source):
    the ring of ``STAGES`` K and V payload tiles with their f32 scale rows,
    then per tile two words of key-validity bits and a uint16 list entry."""
    dhp, s = (Dh // 2, 2) if int4 else (Dh, 1)
    return STAGES * 2 * TILE * (dhp + 4 * s) + 10 * n_tiles(T)


def cluster_size(B: int, KV: int, T: int, sms: int) -> int:
    """Blocks per (b, kv) cluster: enough that ``B * KV * cluster`` covers
    the card's ``sms`` SMs, at most ``MAX_CLUSTER`` (the portable size) and
    at most the cache's tiles; 1 where ``B * KV`` alone fills the card."""
    return max(1, min(MAX_CLUSTER, sms // (B * KV), n_tiles(T)))


def key_tiles(mask_row, T: int, cluster: int) -> List[List[int]]:
    """The cache tiles each block of a (b, kv) cluster loads, as the kernel
    plans them from the batch row ``mask_row`` ([T] of {0, 1}): the
    ``TILE``-position tiles that hold a valid key, in order, cut into
    ``cluster`` runs balanced by count (rank r takes entries [n*r // C,
    n*(r+1) // C) of the n valid tiles). A tile with no valid key is in no
    run."""
    valid = [bool(x) for x in mask_row]
    if len(valid) != T:
        raise ValueError(f"key_tiles: mask row of {len(valid)} keys, want {T}")
    tiles = [t for t in range(n_tiles(T)) if any(valid[t * TILE:(t + 1) * TILE])]
    n = len(tiles)
    return [tiles[n * r // cluster:n * (r + 1) // cluster] for r in range(cluster)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_shape(Dh: int, G: int, T: int, int4: bool) -> None:
    """Raises on what the kernel does not take, before anything is built."""
    if Dh not in (64, 128) or not 1 <= G <= MAX_GROUP:
        raise ValueError(f"kvq_decode_attention: the kernel takes Dh 64 or 128 and a "
                         f"group of 1 to {MAX_GROUP}, got Dh {Dh}, group {G}")
    if T < 1 or _smem_bytes(Dh, int4, T) > SMEM_LIMIT:
        raise ValueError(f"kvq_decode_attention: the kernel takes a cache of at least one "
                         f"position whose tile plan fits in {SMEM_LIMIT} bytes of shared "
                         f"memory, got T {T} ({_smem_bytes(Dh, int4, T)} bytes)")


def _operands(qg, kc, vc, k_new, v_new, amask, mode: str):
    """The kernel's operands (q, kp, ks, vp, vs, kn, vn, mask), each checked
    against what the kernel takes (:func:`_check_shape`, :func:`_check`);
    raises ValueError on the first that it does not."""
    B, KV, G, Dh = qg.shape
    int4 = mode == "int4"
    T = kc[0].shape[2]
    _check_shape(Dh, G, T, int4)
    Dhp, S = (Dh // 2, 2) if int4 else (Dh, 1)
    dev = qg.device
    return (_check("q", qg.contiguous(), torch.bfloat16, (B, KV, G, Dh), dev),
            _check("k payload", kc[0], torch.int8, (B, KV, T, Dhp), dev),
            _check("k scales", kc[1], torch.float32, (B, KV, T, S), dev),
            _check("v payload", vc[0], torch.int8, (B, KV, T, Dhp), dev),
            _check("v scales", vc[1], torch.float32, (B, KV, T, S), dev),
            _check("k_new", k_new.contiguous(), torch.bfloat16, (B, KV, Dh), dev),
            _check("v_new", v_new.contiguous(), torch.bfloat16, (B, KV, Dh), dev),
            _check("amask", amask.contiguous(), torch.bool, (B, T), dev))


def kvq_decode_attention(
    qg: torch.Tensor,  # [B, KV, G, Dh]
    kc: Tuple[torch.Tensor, torch.Tensor],  # payload [B, KV, T, Dhp], scales [B, KV, T, S]
    vc: Tuple[torch.Tensor, torch.Tensor],
    k_new: torch.Tensor,  # [B, KV, Dh]
    v_new: torch.Tensor,  # [B, KV, Dh]
    amask: torch.Tensor,  # [B, T] bool
    scale: float,
    mode: str,  # 'int8' | 'int4'
) -> torch.Tensor:
    """Decode attention over a quantized cache, f32 [B, KV, G, Dh].

    CPU tensors take :func:`kvq_decode_attention_plain`. CUDA tensors launch
    the kernel of ``csrc/kvq_decode.cu`` once on the current stream (B * KV
    clusters of :func:`cluster_size` blocks; the only allocation is the
    output) and add one to ``kvq_decode_attention.launches``; what the kernel
    does not take raises: q, k_new or v_new other than bf16, Dh other than 64
    or 128, a group outside 1-8, a cache whose tile plan overflows shared
    memory, tensors off q's device, a payload or scales not contiguous or not
    16-byte aligned, a launch the card refuses."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"kvq_decode_attention: unknown mode {mode!r}")
    if qg.device.type == "cpu":
        return kvq_decode_attention_plain(qg, kc, vc, k_new, v_new, amask, scale, mode)
    if qg.device.type != "cuda":
        raise ValueError(f"kvq_decode_attention: no kernel for device {qg.device}")
    q, kp, ks, vp, vs, kn, vn, mask = _operands(qg, kc, vc, k_new, v_new, amask, mode)
    B, KV, G, Dh = q.shape
    T = kp.shape[2]
    dev = q.device
    out = torch.empty((B, KV, G, Dh), dtype=torch.float32, device=dev)
    cluster = cluster_size(B, KV, T, _sm_count(dev.index if dev.index is not None
                                                 else torch.cuda.current_device()))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kvq_decode_bf16(
            q.data_ptr(), kp.data_ptr(), ks.data_ptr(), vp.data_ptr(), vs.data_ptr(),
            kn.data_ptr(), vn.data_ptr(), mask.data_ptr(), out.data_ptr(),
            B, KV, G, T, Dh, int(mode == "int4"), cluster, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"kvq_decode launch failed: CUDA error {rc}")
    kvq_decode_attention.launches += 1
    return out


kvq_decode_attention.launches = 0
