"""The benchmark's frozen yardstick: the H100's peaks, the least time of a
piece of work, B8's work on one operand set, and the kernel families.

Each piece is a copy, made once, of the repository's tools at the time the
benchmark was defined, so that no later change to those tools or to the port
moves what the benchmark measures against:

- ``H100_*`` and :func:`bound`: ``chip_smoke.py`` (``H100_BF16_FLOPS``,
  ``H100_INT8_OPS``, ``H100_BYTES_PER_S``, ``_bound``);
- :func:`kvq_work`: ``chip_flash_ab.py`` (``kvq_work``);
- :data:`FAMILIES` and :func:`family`: ``chip_profile.py`` (``FAMILIES``,
  ``_family``).
"""
from __future__ import annotations

# H100 SXM data sheet, dense rates at the 700 W limit: the least time a call
# could take is the larger of its operations over the peak for their type and
# the bytes it must move (each input read once, each output written once)
# over the memory rate.
H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12
H100_BYTES_PER_S = 3.35e12


def bound(ops, nbytes, peak):
    """(least ms on the card, what bounds it)."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def least_s(int8_ops: float, bf16_flops: float, nbytes: float) -> float:
    """Least seconds for work of both operation types and ``nbytes`` bytes:
    the larger of the summed compute times at each type's peak and the
    bytes at the memory rate."""
    compute = int8_ops / H100_INT8_OPS + bf16_flops / H100_BF16_FLOPS
    return max(compute, nbytes / H100_BYTES_PER_S)


def kvq_work(args) -> tuple[int, int]:
    """(operations, bytes) that B8 needs on one operand set, for its bound.
    A masked key adds exactly 0, so only the keys the mask leaves count: the
    bytes are the K and V payload and scale rows of those keys in each KV
    head, the mask, q, the self term and the f32 output, each moved once;
    the operations are q.k and p.v over those keys and the self term."""
    qg, kc, vc, kn, vn, mask = args
    B, KV, G, Dh = qg.shape
    valid = int(mask.sum())  # (row, key) pairs left; each KV head reads its own rows
    row = sum(c[0].shape[-1] * c[0].element_size() + c[1].shape[-1] * c[1].element_size()
              for c in (kc, vc))
    nbytes = (KV * valid * row + B * KV * G * Dh * 4
              + sum(t.numel() * t.element_size() for t in (qg, kn, vn, mask)))
    return 4 * KV * G * Dh * (valid + B), nbytes


FAMILIES = (  # first match wins, on the lower-cased kernel name
    ("kvq decode (B8)", ("kvq_",)),
    ("flash", ("flash_blhd",)),
    ("int8 gated gemm (B4/B6)", ("int8_gated_wgmma",)),
    ("int8 gemm (B3)", ("int8_gemm",)),
    ("w4a8 gemm (B7)", ("w4a8_gemm",)),
    ("int8 quantize", ("quantize_blocks",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("copy", ("copy", "cat", "memcpy", "index", "gather", "embedding")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise"
