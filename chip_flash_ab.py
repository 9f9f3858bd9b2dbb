#!/usr/bin/env python3
"""Time the flash kernel (or B8, B3 or B7) of two checkouts in turns on one GPU.

Run from the root of a checkout, with another checkout (for example the
parent commit, unpacked with ``git archive HEAD | tar -x -C build/parent``)
as the baseline:

    python3 chip_flash_ab.py build/parent

It starts one worker process per turn, in the order baseline, this tree,
this tree, baseline. Each worker imports ``llmrankers_tpu_torch.ops.flash``
from its own checkout (which builds that checkout's ``csrc/flash_blhd.cu``),
makes the same inputs from the same seed, and times the kernel with CUDA
events (mean of 20 launches after 3 of warm-up) at the main paths' shapes,
the ones ``chip_smoke.py`` phases 3, 4 and 7 time:

- B1: flan-t5-large's encoder, [32, 640, 16*64], a rel-pos bias table of
  std 1, right padding, one all-padding row;
- B2: flan-t5-xl's packed qkv [32, 640, 3*32*64], the same masks;
- B5 (a)-(d): Qwen2.5-3B's attention (H 16, KV 2, Dh 128, causal) on a
  left-padded B 32, L 640 batch; a suffix of 512 over [prefix 256 | suffix
  512] with holes; a window of 128 at H 32, KV 8; and B 4, L 4096 left
  padded to 2048-4096 tokens (Rank-R1's prompt bucket).

The worker of this tree also times SDPA with the equivalent float mask and
checks its output against the plain version. The last line is one JSON
object: per case both trees' times, SDPA's, the bound (the larger of the
bf16 operations over the visible pairs at 989 TFLOP/s and the bytes read
and written once at 3.35 TB/s) and this tree's TFLOP/s; the line before it
gives the card's name and power limit. It imports nothing of JAX.

With ``--kvq`` it times the decode-attention kernel B8
(``ops/kvq_attention.py::kvq_decode_attention``) instead, at the generate
phase's shape (B 8, KV 2, G 8, Dh 128, T 2304: a 1536-slot prefix area with
1200 real, a 640-slot suffix area with per-row lengths, 128 tail slots of
which 64 are written), int8 and int4, on the device with a cold L2
(:func:`cold_ms`: the calls over operand sets that together exceed 100 MB,
cycled, replayed from a captured CUDA graph), beside the warm host-bound
figure (20 back-to-back calls on one operand set between CUDA events) and
the wrapper's host time per call; this tree's worker also times SDPA on the
dequantized cache the same way and checks the kernel against its plain
version. B8's bound (:func:`kvq_work`) counts only the keys the mask leaves.

With ``--int8`` it times the W8A8 GEMMs instead: B3
(``ops/int8_matmul.py::quantized_matmul``) at ``chip_smoke.py`` phase 5's
sites (:data:`B3_SITES`), and the gated B4 (``gated_matmul``) and B6
(``gated_matmul_pair``) at phases 6's and 8's (:data:`GATED_SITES`): per
site the whole call (quantize pass and GEMM) from CUDA events, the two
kernels' device times from torch.profiler, and a sha256 of the output, which
must be the same for both trees and every run (each tree gets the weights in
the layout its wrappers take: B3's K-major where it has
``int8_matmul.check_kmajor``, the gated ones K-major unless its
``models/quant.py`` still has ``GATED_LEAVES``, else row-major); this tree's
worker also checks the output against the plain version and times bf16
``torch.matmul`` over the dequantized weights as a yardstick. The bound is
the larger of the int8 operations at 1,979 TOP/s and the bytes of x, the
weights, the scales, the residual and the output at 3.35 TB/s.

With ``--int4`` it times the W4A8 GEMM B7
(``ops/int4_matmul.py::quantized_matmul_int4``) the same way, at
``chip_smoke.py`` phase 9's sites and at decode's M 8 (:data:`B7_SITES`):
per site the whole call from CUDA events, the GEMM's and the quantize
pass's device times from torch.profiler, and a sha256 of the output, which
must be the same for both trees and every run (each tree gets the packed
weight in the layout its wrapper takes: K-major where it has
``int4_matmul.check_kmajor``, else row-major); this tree's worker also checks
the output against the plain version and times bf16 ``torch.matmul`` over the
dequantized weight as a yardstick. The bound counts the packed weight's
bytes, not a dequantized one's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS, H100_BYTES_PER_S = 989e12, 3.35e12
NEG = -1e30


COLD_BYTES = 100e6  # operand sets per timing cycle must exceed this (L2: 50 MB)


# B3's sites, (name, M, K, N, residual, bf16 column scales): flan-t5-xl's
# packed qkv, wo and the decoder's packed cross ckv (M = B*L of the encoder
# output), a ragged M with a residual, a small ragged M (an odd number of
# row tiles), and Qwen2.5-3B's int8 sites (its scale leaves are bf16).
# chip_smoke.py phase 5 checks B3 at the same sites.
B3_M = 32 * 640
B3_SITES = (("qkv", B3_M, 2048, 6144, False, False), ("wo", B3_M, 5120, 2048, False, False),
            ("wo+res", B3_M, 5120, 2048, True, False), ("ckv", B3_M, 2048, 4096, False, False),
            ("ragged+res", 20403, 5120, 2048, True, False),
            ("ragged+res, odd tiles", 1100, 2048, 2048, True, True),
            ("Qwen wq/wo", B3_M, 2048, 2048, False, True),
            ("Qwen wk/wv", B3_M, 2048, 256, False, True),
            ("Qwen w_down", B3_M, 11008, 2048, False, True))
H100_INT8_OPS = 1979e12

# B4's and B6's sites, (name, M, K, N, act, pair): flan-t5-xl's packed wi_g
# [K, 2N] and Qwen2.5-3B's w_gate and w_up (bf16 column scales), each also at
# a ragged M whose last row tile is mostly past M. chip_smoke.py phases 6
# and 8 check them at the same sites.
GATED_SITES = (("B4 wi_g", B3_M, 2048, 5120, "gelu_new", False),
               ("B4 ragged", 1100, 2048, 5120, "gelu_new", False),
               ("B6 gate/up", B3_M, 2048, 11008, "silu", True),
               ("B6 ragged", 1100, 2048, 11008, "silu", True))

# B7's sites, (name, M, K, N, residual): Qwen2.5-3B's int4 FFN at M = B*L
# (gate/up at G 512, down at G 256), a ragged M with a residual, and both
# sites at decode's M 8 (batch 8, one token). chip_smoke.py phase 9 checks
# B7 at the same sites.
B7_SITES = (("gate/up", B3_M, 2048, 11008, False), ("down", B3_M, 11008, 2048, False),
            ("ragged+res", 1000, 2048, 11008, True),
            ("gate/up M 8", 8, 2048, 11008, False), ("down M 8", 8, 11008, 2048, False))


def int8_operands(gen, M, K, N):
    """bf16 activations [M, K] with per-row scales, outlier columns and one
    all-zero row, and a per-channel int8 weight [K, N] (row-major) with f32
    scales, from the checkout on ``sys.path``."""
    import torch
    from llmrankers_tpu_torch.models.quant import quantize_weight

    dev = "cuda"
    x = torch.randn(M, K, generator=gen, device=dev)
    x = x * (0.5 + 2 * torch.rand(M, 1, generator=gen, device=dev))
    x[:, ::97] *= 8.0
    x[7] = 0.0
    w8, sw = quantize_weight(torch.randn(K, N, generator=gen, device=dev) * K**-0.5)
    return x.bfloat16(), w8.contiguous(), sw.contiguous()


def gated_operands(gen, M, K, N, pair):
    """The activations of :func:`int8_operands` and the gated weights, row-major:
    ``(x, (wp [K, 2N], sp [1, 2N] f32))`` for B4, or ``(x, (w0, s0, w1, s1))``
    with two [K, N] weights and bf16 scales (the decoder's leaves) for B6."""
    import torch
    from llmrankers_tpu_torch.models.quant import quantize_weight

    if not pair:
        x, wp, sp = int8_operands(gen, M, K, 2 * N)
        return x, (wp, sp)
    x, w0, s0 = int8_operands(gen, M, K, N)
    w1, s1 = quantize_weight(torch.randn(K, N, generator=gen, device="cuda") * K**-0.5)
    return x, (w0, s0.bfloat16(), w1.contiguous(), s1.bfloat16())


def int4_operands(gen, M, K, N, residual):
    """The activations of :func:`int8_operands`, a packed int4 weight
    [K/2, N] (row-major) with its f32 group scales from ``pack_int4``, and a
    bf16 residual [M, N] or None."""
    import torch
    from llmrankers_tpu_torch.ops.int4_matmul import pack_int4

    x, _, _ = int8_operands(gen, M, K, 128)
    p4, sw = pack_int4(torch.randn(K, N, generator=gen, device="cuda") * K**-0.5)
    res = torch.randn(M, N, generator=gen, device="cuda").bfloat16() if residual else None
    return x, p4.contiguous(), sw.contiguous(), res


def device_ms_by_kernel(fn, calls=5, attempts=5) -> dict:
    """Device ms per call of each kernel ``fn`` launches, from torch.profiler
    over ``calls`` calls after one warm-up: {kernel name: ms}. After one
    session, a later one in the same process can come back short of events
    when many kernels ran between them; a session where a kernel was not
    seen once per call is run again, up to ``attempts`` sessions."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(attempts):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out, seen = {}, {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
                out[e.key] = out.get(e.key, 0.0) + us / 1e3 / calls
                seen[e.key] = seen.get(e.key, 0) + e.count
        if out and all(n == calls for n in seen.values()):
            break
    return out


def cold_ms(calls, reps=2, iters=5) -> float:
    """Device ms per call with a cold L2: ``calls`` (one zero-argument
    callable per operand set, the sets together over ``COLD_BYTES``) are
    captured ``reps`` times over, in order, in one CUDA graph, which is
    replayed ``iters`` times between CUDA events. No host work between the
    launches, and each call finds its operands evicted by the others."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture wants
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for call in calls:
                call()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps * len(calls))


def n_cold_sets(set_bytes: int) -> int:
    """Operand sets enough to exceed ``COLD_BYTES`` together."""
    return int(COLD_BYTES // set_bytes) + 1


def host_us(call, n=200) -> float:
    """The host's time per call in microseconds (enqueue only: the queue
    holds far more than n launches)."""
    import time

    import torch
    call()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(n):
        call()
    dt = time.perf_counter() - tic
    torch.cuda.synchronize()
    return dt / n * 1e6


def kvq_inputs(gen, B, KV, G, Dh, T, mode, layout="shared", window=None, prefix=1200,
               suffix=640, new=128, prompt=3540):
    """B8's operands at trained-like scales: K/V rows whose norms vary from
    position to position (log-normal), queries whose scores have a spread of
    a few units, so attention is peaked and a wrong scale or plane moves the
    output. The key mask has the decode cache's layout, ``new`` tail slots of
    which the first half are written, after either (``shared``) a prefix area
    of min(1536, T // 2) slots with ``prefix`` real and a suffix area with
    per-row lengths from suffix // 2 to ``suffix``, or (``left``) left-padded
    prompts of ``prompt`` +- 150 tokens; the last row sees no cache key (only
    its self term). ``window`` keeps each row's last ``window`` valid keys."""
    import torch
    from llmrankers_tpu_torch.engine import generate

    dev = "cuda"

    def rows(*shape):
        x = torch.randn(*shape, generator=gen, device=dev)
        return x * torch.exp(0.5 * torch.randn(*shape[:-1], 1, generator=gen, device=dev))

    qg = (3.0 * torch.randn(B, KV, G, Dh, generator=gen, device=dev)).bfloat16()
    k, v = rows(B, KV, T, Dh), rows(B, KV, T, Dh)
    k_new, v_new = rows(B, KV, Dh).bfloat16(), rows(B, KV, Dh).bfloat16()
    kc, vc = generate._kv_pack(k, mode), generate._kv_pack(v, mode)
    slots = torch.arange(T, device=dev)[None, :]
    tail = (slots >= T - new) & (slots < T - new + new // 2)
    if layout == "left":
        plen = torch.randint(prompt - 150, prompt + 151, (B,), generator=gen, device=dev)
        plen = plen.clamp(max=T - new)
        mask = ((slots >= T - new - plen[:, None]) & (slots < T - new)) | tail
    else:
        Lp = min(1536, T // 2)
        slen = torch.randint(suffix // 2, suffix + 1, (B,), generator=gen, device=dev)
        mask = ((slots < min(prefix, Lp)) | ((slots >= Lp) & (slots < Lp + slen[:, None]))
                | tail)
    mask[-1] = False
    if window is not None:  # the decode loop's window: cumulative slot positions
        pos = mask.sum(1, keepdim=True)  # the current token's position
        mask = mask & (pos - (torch.cumsum(mask.long(), 1) - 1) < window)
    return qg, kc, vc, k_new, v_new, mask.contiguous()


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


def operand_bytes(args) -> int:
    """The bytes of one operand set as it lies in memory (for the cold-L2 cycle)."""
    qg, kc, vc, kn, vn, mask = args
    return sum(t.numel() * t.element_size() for t in (qg, *kc, *vc, kn, vn, mask))


def _kvq_worker(root: str, check: bool) -> dict:
    """B8 at the generate phase's shape, int8 and int4 (module docstring)."""
    sys.path.insert(0, root)
    import torch
    from llmrankers_tpu_torch.ops import kvq_attention

    gen = torch.Generator(device="cuda").manual_seed(7)
    B, KV, G, Dh, T = 8, 2, 8, 128, 2304
    scale = Dh**-0.5
    cases = {}
    for mode in ("int8", "int4"):
        first = kvq_inputs(gen, B, KV, G, Dh, T, mode)
        sets = [first] + [kvq_inputs(gen, B, KV, G, Dh, T, mode)
                          for _ in range(n_cold_sets(operand_bytes(first)) - 1)]
        fn = kvq_attention.kvq_decode_attention
        calls = [lambda a=a: fn(*a[:6], scale, mode) for a in sets]
        ops, nbytes = kvq_work(first)
        t_ops, t_bytes = ops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        rec = {"cold_ms": cold_ms(calls), "sets": len(sets), "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops > t_bytes else "bytes", "needed_bytes": nbytes,
               "host_us": host_us(calls[0])}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for _ in range(3):
            calls[0]()
        start.record()
        for _ in range(20):
            calls[0]()
        end.record()
        torch.cuda.synchronize()
        rec["warm_host_bound_ms"] = start.elapsed_time(end) / 20
        if check:
            got = calls[0]()
            want = kvq_attention.kvq_decode_attention_plain(*first[:6], scale, mode)
            rec["max_abs_err"] = (got - want).abs().max().item()
            sdpa = torch.nn.functional.scaled_dot_product_attention
            sd = [_dequantized(kvq_attention, a, mode) for a in sets]
            rec["sdpa_cold_ms"] = cold_ms([lambda d=d: sdpa(*d, scale=scale, enable_gqa=True)
                                           for d in sd])
        cases[mode] = rec
        del sets, calls
        torch.cuda.empty_cache()
    return cases


def _gemm_record(call, ops, tensors, gemm_keys) -> dict:
    """One GEMM site of ``--int8``/``--int4``: the whole call's ms from CUDA
    events (mean of 20 after 3), the GEMM's (kernels named with one of
    ``gemm_keys``) and the quantize pass's device ms from torch.profiler, the
    kernels one call launches, the bound, and the output's sha256."""
    import hashlib

    import torch
    got = call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        call()
    start.record()
    for _ in range(20):
        call()
    end.record()
    torch.cuda.synchronize()
    dev = device_ms_by_kernel(call)
    nbytes = sum(t.numel() * t.element_size() for t in (*tensors, got) if t is not None)
    return got, {
        "ms": start.elapsed_time(end) / 20, "ops": ops,
        "gemm_ms": sum(v for k, v in dev.items() if any(g in k for g in gemm_keys)),
        "quantize_ms": sum(v for k, v in dev.items() if "quantize_blocks" in k),
        "kernels": sorted(dev),
        "bound_ms": max(ops / H100_INT8_OPS, nbytes / H100_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if ops / H100_INT8_OPS > nbytes / H100_BYTES_PER_S
        else "bytes",
        "sha256": hashlib.sha256(got.view(torch.int16).cpu().numpy().tobytes()).hexdigest()}


def _yardstick_ms(x, *wbs) -> float:
    """bf16 ``torch.matmul`` of x by each dequantized weight: mean of 10."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def run():
        for wb in wbs:
            x @ wb

    for _ in range(2):
        run()
    start.record()
    for _ in range(10):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 10


def _int8_worker(root: str, check: bool) -> dict:
    """B3 at the phase-5 sites and B4, B6 at :data:`GATED_SITES` (module
    docstring): per site the whole call's ms from CUDA events, the GEMM's and
    the quantize pass's device ms from torch.profiler, and a sha256 of the
    output. A tree whose wrapper checks for K-major weights
    (``int8_matmul.check_kmajor``) gets B3's K-major, the same values, and
    one whose ``models/quant.py`` has no ``GATED_LEAVES`` (the gated leaves'
    row-major exception) gets the gated weights K-major too; an older tree
    gets them row-major."""
    sys.path.insert(0, root)
    import torch
    from llmrankers_tpu_torch.models import quant
    from llmrankers_tpu_torch.ops import int8_matmul

    int8_matmul._lib()  # build before timing
    kmajor = hasattr(int8_matmul, "check_kmajor")
    gated_kmajor = kmajor and not hasattr(quant, "GATED_LEAVES")
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = {}
    for site, M, K, N, with_res, bf16_scales in B3_SITES:
        x, w8, sw = int8_operands(gen, M, K, N)
        if bf16_scales:
            sw = sw.bfloat16()
        res = torch.randn(M, N, generator=gen, device="cuda").bfloat16() if with_res else None
        wk = w8.t().contiguous().t() if kmajor else w8
        got, rec = _gemm_record(lambda: int8_matmul.quantized_matmul(x, wk, sw, residual=res),
                                2 * M * K * N, (x, w8, sw, res), ("int8_gemm",))
        if check:
            want = int8_matmul.quantized_matmul_plain(x, w8, sw, res)
            rec["equal_to_plain"] = bool(torch.equal(got, want))
            rec["bf16_matmul_ms"] = _yardstick_ms(x, (w8.bfloat16() * sw.bfloat16()).contiguous())
            del want
        cases[site] = rec
        del x, w8, wk, sw, res, got
        torch.cuda.empty_cache()
    for site, M, K, N, act, pair in GATED_SITES:
        x, ws = gated_operands(gen, M, K, N, pair)
        lay = [w.t().contiguous().t() if gated_kmajor and w.dtype == torch.int8 else w
               for w in ws]
        fn, plain = ((int8_matmul.gated_matmul_pair, int8_matmul.gated_matmul_pair_plain)
                     if pair else (int8_matmul.gated_matmul, int8_matmul.gated_matmul_plain))
        # the old mma.sync body's name holds int8_gemm, the wgmma kernel's int8_gated
        got, rec = _gemm_record(lambda: fn(x, *lay, act=act), 2 * M * K * 2 * N, (x, *ws),
                                ("int8_gemm", "int8_gated"))
        if check:
            want = plain(x, *ws, act=act)
            rec["equal_to_plain"] = bool(torch.equal(got, want))
            rec["max_abs_err"] = (got.float() - want.float()).abs().max().item()
            deq = [(w.bfloat16() * s.bfloat16()).contiguous() for w, s in zip(ws[::2], ws[1::2])]
            rec["bf16_matmul_ms"] = _yardstick_ms(x, *deq)
            del want, deq
        cases[site] = rec
        del x, ws, lay, got
        torch.cuda.empty_cache()
    return cases


def _int4_worker(root: str, check: bool) -> dict:
    """B7 at :data:`B7_SITES` (module docstring), as :func:`_int8_worker`
    times B3. A tree whose wrapper checks for K-major packed weights
    (``int4_matmul.check_kmajor``) gets them K-major, the same bytes; an
    older tree gets them row-major."""
    sys.path.insert(0, root)
    import torch
    from llmrankers_tpu_torch.ops import int4_matmul

    int4_matmul._lib()  # build before timing
    kmajor = hasattr(int4_matmul, "check_kmajor")
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = {}
    for site, M, K, N, with_res in B7_SITES:
        x, p4, sw, res = int4_operands(gen, M, K, N, with_res)
        pk = p4.t().contiguous().t() if kmajor else p4
        got, rec = _gemm_record(
            lambda: int4_matmul.quantized_matmul_int4(x, pk, sw, residual=res),
            2 * M * K * N, (x, p4, sw, res), ("w4a8_gemm",))
        if check:
            want = int4_matmul.quantized_matmul_int4_plain(x, p4, sw, res)
            rec["equal_to_plain"] = bool(torch.equal(got, want))
            rec["bf16_matmul_ms"] = _yardstick_ms(
                x, int4_matmul.unpack_int4(p4, sw).bfloat16())
            del want
        cases[site] = rec
        del x, p4, pk, sw, res, got
        torch.cuda.empty_cache()
    return cases


def _dequantized(kvq_attention, args, mode):
    """SDPA's operands for one B8 operand set: q [B, KV*G, 1, Dh], the
    dequantized cache with the self term as its last key, bf16, and the
    additive mask."""
    import torch
    import torch.nn.functional as F
    qg, kc, vc, kn, vn, amask = args
    B, KV, G, Dh = qg.shape

    def deq(c):
        if mode == "int4":
            lo, hi = kvq_attention.unpack4(c[0], torch.float32)
            return torch.cat([lo * c[1][..., :1], hi * c[1][..., 1:]], -1)
        return c[0].float() * c[1]
    kd = torch.cat([deq(kc), kn.float()[:, :, None]], 2).bfloat16()
    vd = torch.cat([deq(vc), vn.float()[:, :, None]], 2).bfloat16()
    mask = torch.where(F.pad(amask, (0, 1), value=True), 0.0, NEG).bfloat16()
    return qg.reshape(B, KV * G, 1, Dh), kd, vd, mask[:, None, None, :]


def _worker(root: str, check: bool) -> dict:
    sys.path.insert(0, root)
    import torch
    from llmrankers_tpu_torch.models import t5
    from llmrankers_tpu_torch.models.config import T5Config
    from llmrankers_tpu_torch.ops import flash

    dev = "cuda"
    flash._lib()  # build before timing
    gen = torch.Generator(device=dev).manual_seed(7)

    def ms_of(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def right_mask(B, L):
        lens = torch.randint(L // 2, L + 1, (B,), generator=gen, device=dev)
        mask = (torch.arange(L, device=dev)[None] < lens[:, None]).int()
        mask[-1] = 0
        return mask.contiguous()

    def t5_bias(cfg, L):
        table = torch.randn(cfg.relative_attention_num_buckets, cfg.num_heads,
                            generator=gen, device=dev).bfloat16()
        return t5.compute_bias(table, L, L, True, cfg)

    cases = {}

    def add(name, run, plain, sdpa, flops, io_bytes):
        rec = {"ms": ms_of(run), "flops": flops,
               "bound_ms": max(flops / H100_BF16_FLOPS, io_bytes / H100_BYTES_PER_S) * 1e3}
        if check:
            got = run()
            want = plain()
            rec["max_abs_err"] = (got.float() - want.float()).abs().max().item()
            rec["sdpa_ms"] = ms_of(sdpa, 10, 2)
        cases[name] = rec
        torch.cuda.empty_cache()

    # B1
    cfg = T5Config.flan_t5_large()
    B, L, H, Dh = 32, 640, cfg.num_heads, cfg.d_kv
    q = (torch.randn(B, L, H * Dh, generator=gen, device=dev) * Dh**-0.5).bfloat16()
    k = torch.randn(B, L, H * Dh, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, L, H * Dh, generator=gen, device=dev).bfloat16()
    mask, bias = right_mask(B, L), t5_bias(cfg, L)
    kw = dict(kv_mask=mask, bias=bias, scale=1.0)
    heads = [x.unflatten(-1, (H, Dh)).transpose(1, 2) for x in (q, k, v)]
    fmask = bias + ((1 - mask) * NEG).to(q.dtype)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    add("B1", lambda: flash.flash_mha_blhd(q, k, v, H, **kw),
        lambda: flash.flash_mha_blhd_plain(q, k, v, H, **kw),
        lambda: sdpa(*heads, attn_mask=fmask, scale=1.0),
        4 * Dh * H * L * int(mask.sum()), nbytes(q, k, v, q, bias, mask))
    del q, k, v, heads, fmask

    # B2
    cfg = T5Config.flan_t5_xl()
    H, Dh = cfg.num_heads, cfg.d_kv
    HD = H * Dh
    qkv = torch.cat([torch.randn(B, L, HD, generator=gen, device=dev) * Dh**-0.5,
                     torch.randn(B, L, 2 * HD, generator=gen, device=dev)], -1).bfloat16()
    mask, bias = right_mask(B, L), t5_bias(cfg, L)
    kw = dict(kv_mask=mask, bias=bias, scale=1.0)
    heads = [x.unflatten(-1, (H, Dh)).transpose(1, 2)
             for x in qkv.unflatten(-1, (3, HD)).unbind(2)]
    fmask = bias + ((1 - mask) * NEG).to(qkv.dtype)[:, None, None, :]
    add("B2", lambda: flash.flash_mha_packed(qkv, H, **kw),
        lambda: flash.flash_mha_packed_plain(qkv, H, **kw),
        lambda: sdpa(*heads, attn_mask=fmask, scale=1.0),
        4 * Dh * H * L * int(mask.sum()), nbytes(qkv, heads[0], bias, mask))
    del qkv, heads, fmask

    # B5 (a)-(d)
    for name, (B, Lq, Lk, H, KV, layout, window, pad_row) in {
        "B5a": (32, 640, 640, 16, 2, "left", None, True),
        "B5b": (32, 512, 768, 16, 2, "holes", None, True),
        "B5c": (32, 640, 640, 32, 8, "left", 128, True),
        "B5d": (4, 4096, 4096, 16, 2, "left", None, False),
    }.items():
        Dh = 128
        q = torch.randn(B, Lq, H, Dh, generator=gen, device=dev).bfloat16().transpose(1, 2)
        k = torch.randn(B, Lk, KV, Dh, generator=gen, device=dev).bfloat16().transpose(1, 2)
        v = torch.randn(B, Lk, KV, Dh, generator=gen, device=dev).bfloat16().transpose(1, 2)
        if layout == "left":
            lens = torch.randint(Lk // 2, Lk + 1, (B,), generator=gen, device=dev)
            m = torch.arange(Lk, device=dev)[None] >= (Lk - lens)[:, None]
        else:
            Lp = Lk - Lq
            plen = torch.randint(Lp // 2, Lp + 1, (B,), generator=gen, device=dev)
            slen = torch.randint(Lq // 2, Lq + 1, (B,), generator=gen, device=dev)
            m = torch.cat([torch.arange(Lp, device=dev)[None] < plen[:, None],
                           torch.arange(Lq, device=dev)[None] < slen[:, None]], 1)
        mask = m.int()
        if pad_row:
            mask[-1] = 0
        mask = mask.contiguous()
        rel = (torch.arange(Lq, device=dev)[:, None] + (Lk - Lq)
               - torch.arange(Lk, device=dev)[None, :])
        vis = rel >= 0
        if window is not None:
            vis = vis & (rel < window)
        vis = vis[None] & mask.bool()[:, None, :]
        kw = dict(kv_mask=mask, causal=True, scale=Dh**-0.5, window=window)
        fmask = torch.where(vis, 0.0, NEG).to(q.dtype)[:, None]
        add(name, lambda: flash.flash_mha(q, k, v, **kw),
            lambda: flash.flash_mha_plain(q, k, v, **kw),
            lambda: sdpa(q, k, v, attn_mask=fmask, scale=Dh**-0.5, enable_gqa=True),
            4 * Dh * H * int(vis.sum()), nbytes(q, k, v, q, mask))
        del q, k, v, fmask, vis
    return cases


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("baseline", nargs="?", help="root of the baseline checkout")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    kind = parser.add_mutually_exclusive_group()
    kind.add_argument("--kvq", action="store_true",
                      help="time the decode-attention kernel B8 instead, cold L2")
    kind.add_argument("--int8", action="store_true",
                      help="time the W8A8 GEMMs B3, B4 and B6 instead, at chip_smoke.py "
                           "phases 5, 6 and 8's sites")
    kind.add_argument("--int4", action="store_true",
                      help="time the W4A8 GEMM B7 instead, at chip_smoke.py phase 9's sites "
                           "and at M 8")
    opts = parser.parse_args()
    if opts.worker:
        work = (_kvq_worker if opts.kvq else _int8_worker if opts.int8
                else _int4_worker if opts.int4 else _worker)
        print(json.dumps(work(opts.worker, opts.check)))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_flash_ab.py needs a CUDA GPU and none is available")
    if not opts.baseline:
        parser.error("give the baseline checkout's root")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    roots = {"baseline": os.path.abspath(opts.baseline), "change": ROOT}
    runs = {"baseline": [], "change": []}
    for i, tree in enumerate(("baseline", "change", "change", "baseline")):
        cmd = [sys.executable, os.path.join(ROOT, "chip_flash_ab.py"), "--worker", roots[tree]]
        if tree == "change" and not runs["change"]:
            cmd.append("--check")
        for kind in ("kvq", "int8", "int4"):
            if getattr(opts, kind):
                cmd.append("--" + kind)
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=roots[tree])
        if res.returncode != 0:
            sys.exit(f"worker {tree} failed:\n{res.stderr[-4000:]}")
        runs[tree].append(json.loads(res.stdout.strip().splitlines()[-1]))
    if opts.kvq:
        return _kvq_report(runs, smi)
    if opts.int8 or opts.int4:
        return _gemm_report("B3" if opts.int8 else "B7", runs, smi)
    out = {}
    for name, first in runs["change"][0].items():
        base = [r[name]["ms"] for r in runs["baseline"]]
        new = [r[name]["ms"] for r in runs["change"]]
        ms = sum(new) / 2
        out[name] = {"baseline_ms": base, "change_ms": new,
                     "speedup": (sum(base) / 2) / ms, "sdpa_ms": first["sdpa_ms"],
                     "bound_ms": first["bound_ms"],
                     "tflops": first["flops"] / ms / 1e9,
                     "max_abs_err": first["max_abs_err"]}
        print(f"{name}: baseline {base[0]:.4f}/{base[1]:.4f} ms, change {new[0]:.4f}/"
              f"{new[1]:.4f} ms ({out[name]['speedup']:.2f}x, {out[name]['tflops']:.1f} "
              f"TFLOP/s), SDPA {first['sdpa_ms']:.4f} ms, bound {first['bound_ms']:.4f} ms, "
              f"max |diff| vs plain {first['max_abs_err']:.4g}")
    print(smi)
    print(json.dumps(out))


def _gemm_report(kernel, runs, smi):
    """Per site both trees' call and GEMM times (``kernel`` B3 or B7; the
    gated sites carry their own names); exits non-zero when an output's hash
    differs between the trees or between runs, or this tree's output is not
    its plain version's."""
    out, bad = {}, []
    for site, first in runs["change"][0].items():
        recs = {tree: [r[site] for r in runs[tree]] for tree in runs}
        hashes = {r["sha256"] for rr in recs.values() for r in rr}
        if len(hashes) != 1 or not first["equal_to_plain"]:
            bad.append(site)
        base = [r["ms"] for r in recs["baseline"]]
        new = [r["ms"] for r in recs["change"]]
        gemm = [r["gemm_ms"] for r in recs["change"]]
        o = out[site] = {
            "baseline_ms": base, "change_ms": new, "speedup": sum(base) / sum(new),
            "baseline_gemm_ms": [r["gemm_ms"] for r in recs["baseline"]],
            "change_gemm_ms": gemm,
            "baseline_quantize_ms": [r["quantize_ms"] for r in recs["baseline"]],
            "change_quantize_ms": [r["quantize_ms"] for r in recs["change"]],
            "gemm_tops": first["ops"] / (sum(gemm) / 2) / 1e9,
            "call_tops": first["ops"] / (sum(new) / 2) / 1e9,
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "gemm_over_bound": sum(gemm) / 2 / first["bound_ms"],
            "bf16_matmul_ms": first["bf16_matmul_ms"],
            "baseline_kernels": recs["baseline"][0]["kernels"],
            "change_kernels": first["kernels"],
            "sha256_equal": len(hashes) == 1, "equal_to_plain": first["equal_to_plain"]}
        title = site if site in {g[0] for g in GATED_SITES} else f"{kernel} {site}"
        print(f"{title}: call baseline {base[0]:.4f}/{base[1]:.4f} ms, change "
              f"{new[0]:.4f}/{new[1]:.4f} ms ({o['speedup']:.2f}x, {o['call_tops']:.1f} TOP/s); device GEMM "
              "baseline " + "/".join(f"{x:.4f}" for x in o["baseline_gemm_ms"])
              + " ms, change " + "/".join(f"{x:.4f}" for x in gemm)
              + f" ms ({o['gemm_tops']:.1f} TOP/s, {o['gemm_over_bound']:.2f}x the bound "
              f"{o['bound_ms']:.4f} ms, {o['bound_by']}); quantize pass "
              + "/".join(f"{x:.4f}" for x in o["change_quantize_ms"])
              + f" ms; bf16 torch.matmul yardstick {o['bf16_matmul_ms']:.4f} ms; outputs' "
              f"sha256 {'equal' if o['sha256_equal'] else 'DIFFER'} across trees and runs, "
              f"{'equal' if o['equal_to_plain'] else 'NOT equal'} to the plain version")
    print(smi)
    print(json.dumps(out))
    if bad:
        sys.exit(f"{kernel} outputs differ between the trees or from the plain version at {bad}")


def _kvq_report(runs, smi):
    out = {}
    for mode, first in runs["change"][0].items():
        base = [r[mode]["cold_ms"] for r in runs["baseline"]]
        new = [r[mode]["cold_ms"] for r in runs["change"]]
        out[mode] = {
            "baseline_cold_ms": base, "change_cold_ms": new,
            "speedup": sum(base) / sum(new), "sdpa_cold_ms": first["sdpa_cold_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "needed_bytes": first["needed_bytes"], "sets": first["sets"],
            "baseline_warm_host_bound_ms": [r[mode]["warm_host_bound_ms"] for r in runs["baseline"]],
            "change_warm_host_bound_ms": [r[mode]["warm_host_bound_ms"] for r in runs["change"]],
            "baseline_host_us": [r[mode]["host_us"] for r in runs["baseline"]],
            "change_host_us": [r[mode]["host_us"] for r in runs["change"]],
            "max_abs_err": first["max_abs_err"]}
        o = out[mode]
        print(f"B8 {mode} T 2304, device time with a cold L2 ({first['sets']} operand sets "
              f"cycled, CUDA graph): baseline {base[0]:.4f}/{base[1]:.4f} ms, change "
              f"{new[0]:.4f}/{new[1]:.4f} ms ({o['speedup']:.2f}x), SDPA on the dequantized "
              f"cache {o['sdpa_cold_ms']:.4f} ms, bound {o['bound_ms']:.4f} ms ({o['bound_by']}, "
              f"{o['needed_bytes'] / 1e6:.2f} MB of the valid keys' rows and the rest); warm, "
              f"host-bound: baseline " + "/".join(f"{x:.4f}" for x in o["baseline_warm_host_bound_ms"])
              + " ms, change " + "/".join(f"{x:.4f}" for x in o["change_warm_host_bound_ms"])
              + " ms; wrapper host time per call: baseline "
              + "/".join(f"{x:.1f}" for x in o["baseline_host_us"]) + " us, change "
              + "/".join(f"{x:.1f}" for x in o["change_host_us"])
              + f" us; max |diff| vs plain {o['max_abs_err']:.4g}")
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
