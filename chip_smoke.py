#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``llmrankers_tpu_torch/csrc`` (one
nvcc per source, side by side) and then, one line per phase:

1. prints the device, and the card's name and power limit from nvidia-smi;
2. builds ``flash_blhd.cu``, ``int8_fusedq.cu``, ``int4_w4a8.cu`` and
   ``kvq_decode.cu`` and prints the build time and ptxas's registers and
   spills (the flash kernel and B8 per instance, with their stack and
   dynamic shared memory, which must match the wrappers' own plans; a spill
   store in the flash kernel or the int8 and int4 GEMMs (B3, B4, B6, B7,
   B9), or ptxas's warning that it serialised a
   kernel's wgmmas (C7515, C7518), fails);
3. B1: holds the flash kernel against its plain PyTorch version at the bf16
   path's shapes (flan-t5-large encoder: B 32, L 512 and 640, H 16, Dh 64,
   a rel-pos bias table of std 1 as in a trained model, right padding, one
   all-padding row that must come out as exact zeros, one causal case with
   Lq != Lk, a ragged causal case with Lq 40 and Lk 200, and t5-tiny's H 4,
   Dh 16 at L 256), checks that a wrong bias (none, or the next head's,
   key's or row's) and K/V read one key tile late fail the same gate, and
   times kernel and plain version;
4. B2: the packed flash at flan-t5-xl's encoder shape (B 32, L 640, H 32,
   Dh 64, qkv [32, 640, 6144]) against its plain version, with k read at
   q's offset, v at k's and K/V one key tile late as negative controls;
5. B3: the W8A8 GEMM (its wgmma kernel's registers and shared memory from
   the build log) on K-major weights, as the models hold them, at the xl
   sites qkv, wo (with and without a residual) and ckv (f32 column scales),
   ragged Ms of 20403 and 1100 with a residual, a [300, 256] x [256, 384]
   product, and Qwen2.5-3B's int8 sites wq/wo,
   wk/wv and w_down (bf16 column scales, read in place): every output equal
   to the plain version's bit for bit and within one bf16 ulp; activation
   scales at another K-block (the whole row, or half the K-block where it is
   the whole row) and column scales rolled by one must fail, and a
   row-major weight must raise; per site the whole call's time (CUDA
   events), the GEMM's and the quantize pass's device times (torch.profiler,
   in a worker process) and bf16 ``torch.matmul`` on the same shape as a
   yardstick;
6. B4: the gated wgmma GEMM (its registers and shared memory from the build
   log) at xl wi_g with gelu_new, on the K-major [2N, K] buffer the model
   holds, and at a ragged M of 1100: the same gate plus a stated tanh
   allowance, and the count of elements not bit-equal to the plain version;
   swapped halves and relu must fail, and a row-major wi_g must raise; the
   whole call's time (CUDA events), the GEMM's and the quantize pass's
   device times (torch.profiler, in phase 5's worker process), TOP/s and
   the multiple of the bound; bf16 ``torch.matmul`` over the dequantized
   wi_g as a yardstick;
7. B5: the GQA flash kernel on [B, H, L, Dh] views of the projections at
   Qwen2.5-3B's attention shapes (H 16, KV 2, Dh 128): (a) a left-padded
   causal batch, B 32, L 640, one all-padding row; (b) a shared-prefix
   suffix, Lq 512 over keys [prefix 256 | suffix 512] with padding holes,
   causal offset 256; (c) a sliding window of 128 at L 640, H 32, KV 8;
   (d) Rank-R1's prompt bucket, B 4, L 4096, left padding to 2048-4096
   tokens; checked only: (e) ragged, Lq 48 over Lk 1000 with holes, (f)
   every key tile but one padding; KV head h % KV, K/V one key tile late,
   causal offset 0 and no window must fail the gate; each case prints the
   share of key tiles the kernel loads (``flash.key_tiles``);
8. B6: the gated pair on the same kernel over two separate K-major int8
   weights at Qwen2.5-3B's FFN ([20480, 2048] x 2 x [2048, 11008], silu,
   bf16 scales) and at a ragged M of 1100, one bf16 ulp plus a silu
   allowance, with the count not bit-equal; gate and up swapped must fail
   and a row-major weight must raise; times as in phase 6; the two bf16
   products' torch.matmul time as a yardstick;
9. B7: the W4A8 GEMM (its wgmma kernel's registers and shared memory from
   the build log) on K-major packed weights, as the models hold them, at
   Qwen2.5-3B's int4 FFN sites (gate/up, G 512; down, G 256), a ragged M
   with a residual and both sites at decode's M 8: every output equal to the
   plain version bit for bit; the zero-point term dropped, group scales
   rolled by one group and the nibble planes swapped must fail the one-ulp
   gate, and a row-major packed weight must raise; per site the whole
   call's time (CUDA events), the GEMM's and the quantize pass's device
   times (torch.profiler, in a worker process) and bf16 ``torch.matmul``
   over the dequantized weight as a yardstick;
10. B9: int8_matmul, on B3's wgmma kernel with no quantize pass, on
    activations quantized per row and K-major weights at B3's qkv shape,
    Qwen2.5-3B's w_down (one int32 sum over K 11,008) and a ragged M of 1100:
    every output equal to the plain version bit for bit; sx rolled by one
    row must fail the one-ulp gate and a row-major weight must raise; per
    site the whole call's time (CUDA events), the GEMM's device time
    (torch.profiler, in phase 5's worker process, which must see one kernel
    a call and no quantize pass) and torch._int_mm's time as a yardstick;
11. ``score_labels`` on a random-init flan-t5-large at full width in bf16
    (its encoder bias table redrawn at std 1), once through the kernel and
    once with plain attention: encoder outputs and label logits, with a
    no-bias control at the encoder output;
12. reranks 4 synthetic queries x 100 passages of 128 tokens end to end
    through ``llmrankers_tpu_torch.cli.run.main`` on flan-t5-large in bf16
    (setwise heapsort, likelihood, num_child 2, k 10), counting B1's launches;
13. ``score_labels`` on a random-init flan-t5-xl at full width in W8A8 int8
    (encoder table at std 1), kernels against the same int8 path on their
    plain versions: encoder output, label logits, winners;
14. the decision-parity battery at xl: bf16 against int8 label winners on
    64 prompts, overall and on the rows with a clear bf16 margin;
15. the same end-to-end rerank on flan-t5-xl with ``--quantize int8``,
    counting the launches of B2, B3 and B4;
16. ``score_labels`` on a random-init Qwen2.5-3B at full width in bf16, 32
    setwise prompts of three 128-token passages in the chat template, on the
    plain (left-padded), shared-prefix and prefix-cache paths, kernel
    against plain attention: label logits, winners, last hidden states;
    rows gathering the next group's prefix K/V must fail the gate;
17. reranks the 4 x 100 input end to end on that Qwen2.5-3B through
    ``SetwiseLlmRanker.rerank_many`` (inputs from the CLI's ``load_inputs``),
    counting B5's launches and the engine's programs;
18. ``score_labels`` on that Qwen2.5-3B with ``quantize="int8"``: the
    left-padded path with the kernels (B3, B5, B6) against the same
    quantized weights on the kernels' plain versions, label logits and last
    hidden states within one bf16 ulp on every element (bf16's logits must
    miss that gate), the cached path against it, the rolled-prefix control,
    and the logits beside bf16's;
19. the end-to-end rerank with ``quantize="int8"``, B5, B3 and B6 launched
    in multiples of 36;
20. and 21. the same two phases with ``quantize="int4"`` (B3, B5, B7);
22. B8: decode attention over a quantized KV cache against its plain
    version at the generate phase's shape (B 8, KV 2, G 8, Dh 128, T 2304:
    a 1536-slot prefix area with 1200 real, a 640-slot suffix area with
    per-row lengths, 64 decoded slots; the last row sees only its self term),
    int8 and int4, with a window of 512, at T 1968, at Rank-R1's cache length
    (prompts of 3540 +- 150 tokens left-padded in the 4096 bucket, plus the
    completion budget: T 4224) and at Dh 64 (KV 2, G 7: Qwen2.5-0.5B's
    attention), int8 and int4; K/V rows of log-normal norms and peaked
    queries, so that scales rolled by one position, swapped nibble planes
    (int4), a dropped self term, one cluster rank's partial left out and,
    on a mask with one valid tile (held to the gate itself), that tile
    dropped must fail the gate; one call must launch exactly one device
    kernel (torch.profiler); kernel, plain version and SDPA on the
    dequantized cache (yardstick) timed on the device with a cold L2 (operand
    sets over 100 MB, cycled, replayed from a CUDA graph), beside the warm,
    host-bound times (CUDA events around back-to-back calls on one set) and
    the wrapper's host time per call;
23. ``ScoringEngine.generate`` on that Qwen2.5-3B at bench.py's
    rankr1_decode shape (batch 8, a shared 1200-token prefix, 640-token
    suffixes, 128 new tokens greedy in chunks of 64 with a stop string) with
    bf16 weights and bf16, int8 and int4 KV, then int8 and int4 weights with
    int4 KV: B8 launched 36 x 128 times with a quantized cache, the run's
    tokens teacher-forced through the decode with every kernel site on its
    plain version (first-step logits within a relative 0.05, 0.1 with
    quantized weights, as the hidden-state gates; every token the plain
    argmax or within 0.25 of it), ms per decode step, peak memory, and
    the decode-M (8) times of bf16, W8A16 and B7 at Qwen2.5-3B's sites;
24. slot refill on that Qwen2.5-3B: 24 rows of the generate phase's shape
    (rows 12 and 13 on prompts of their own), 8 rows per dispatch, 128 new
    tokens in chunks of 32, with bf16 weights and int8 KV and with int4
    weights and int4 KV, stop strings picked from a probe run of the
    dispatch route (a tokenizer that spells every id) so that rows finish at
    different chunk boundaries; the dispatch route (``LLMRANKERS_NO_REFILL=1``)
    and the refill session in turns (host walls, generated tokens/s);
    refills and prefix-KV hits, ``rr_refill_pre`` and the left-padded
    ``rr_refill`` run, B8 launched layers x steps of ``dec_chunk_rr``, B5
    launched inside the refill prefills; each row's tokens equal the
    dispatch route's up to its first step whose teacher-forced top-2 margin
    is within LOGIT_TOL; B8 held against its plain version on one decode
    step's layer-0 operands captured after the left-padded refill (both
    layouts, per-row write positions, stale K/V behind refilled rows), also
    with a refilled row's query aimed at its first key, where that row's
    mask one key tile late must miss the gate;
25. prompt-lookup speculative decoding (K 4) on the generate phase's 8 rows
    in the same two modes, against the step route in turns: the accept rate
    (tokens a round), walls, and the tokens held by the same margin rule;
26. Rank-R1 setwise end to end through ``cli.run.main`` on
    ``random:qwen2.5-3b`` with ``--kv_quantize int8`` and
    ``prompt_setwise-R1.toml``, 2 queries x 20 passages, num_child 19, k 1,
    128 completion tokens, counting B8's launches;
27. prints a JSON line of the nine kernels (with each one's bound on this
    card and the one-call PyTorch time where there is one; B6, B7 and B9
    carry a timing yardstick instead, and B9, which no path calls, is marked
    standalone; B8 with its launches in the generate and refill phases),
    then ``{"ok": true, "device": ...}``.

Any failed check raises and the exit code is not 0. Without a CUDA GPU it
exits with an error before printing anything. It imports nothing of JAX or of
the JAX package. Scratch files go to ``build/chip_smoke/`` in the checkout.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA GPU and none is available")

import chip_flash_ab as ab  # noqa: E402

from llmrankers_tpu_torch.cli import run as cli_run  # noqa: E402
from llmrankers_tpu_torch.engine import engine as engine_mod  # noqa: E402
from llmrankers_tpu_torch.engine import generate, parity  # noqa: E402
from llmrankers_tpu_torch.engine.engine import ScoringEngine  # noqa: E402
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmrankers_tpu_torch.models import decoder, t5  # noqa: E402
from llmrankers_tpu_torch.models.config import DecoderConfig, T5Config  # noqa: E402
from llmrankers_tpu_torch.models import quant  # noqa: E402
from llmrankers_tpu_torch.models.quant import quantize_weight  # noqa: E402
from llmrankers_tpu_torch.ops import (_build, flash, int4_matmul, int8_matmul,  # noqa: E402
                                      kvq_attention)
from llmrankers_tpu_torch.rankers.prompts import setwise_prompt  # noqa: E402
from llmrankers_tpu_torch.rankers.setwise import SetwiseLlmRanker  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")
N_PHASES = 27
SOURCES = ("flash_blhd", "int8_fusedq", "int4_w4a8", "kvq_decode")
KERNEL_TOL = 0.05  # bf16 flash kernel vs plain, max |diff| on rows with a valid key
# Label logits through 24+24 bf16 layers, kernel vs plain: each layer's
# output may differ by an ulp of bf16 (2^-8 relative), and the differences
# compound through the residual stream (and, in int8, flip round-half int8
# values that move their rows further); logits are O(1).
LOGIT_TOL = 0.25
# Encoder output, kernel vs plain: ||a - b|| / ||b|| over the valid positions,
# bf16 rounding (2^-8 relative) compounded through 24 layers.
ENC_TOL = 0.05
# The same in int8: a bf16 difference that moves an activation across a
# round-half boundary flips its int8 value, which moves the row at the next
# site and flips more of its values, so differences compound faster.
INT8_ENC_TOL = 0.1
# W8A8 kernels vs plain, per element: the int8 values and int32 sums are
# exact and the f32 steps are the same, so only the bf16 output rounding may
# differ: |diff| <= 2^-7 |want| + 1e-6, one bf16 ulp.
BF16_ULP = 2.0**-7
# B4 adds, per element, 1e-5 * max |want|: the kernel's tanhf against
# torch.tanh, near tanh = -1 where gelu_new cancels. B6 adds the same for
# silu: the kernel's expf against torch.sigmoid's.
TANH_ALLOWANCE = 1e-5
SILU_ALLOWANCE = 1e-5
N_QUERIES, N_DOCS, PASSAGE_TOKENS = 4, 100, 128
QUERY_HEADS = ("alpha", "bravo", "charlie", "delta")  # distinct first words
COUNTERS = {
    "flash_mha_blhd": flash.flash_mha_blhd,
    "flash_mha_packed": flash.flash_mha_packed,
    "quantized_matmul": int8_matmul.quantized_matmul,
    "gated_matmul": int8_matmul.gated_matmul,
    "flash_mha": flash.flash_mha,
    "gated_matmul_pair": int8_matmul.gated_matmul_pair,
    "quantized_matmul_int4": int4_matmul.quantized_matmul_int4,
    "int8_matmul": int8_matmul.int8_matmul,
    "kvq_decode_attention": kvq_attention.kvq_decode_attention,
}
# H100 SXM data sheet, dense rates at the 700 W limit: the least time a call
# could take is the larger of its operations over the peak for their type and
# the bytes it must move (each input read once, each output written once)
# over the memory rate.
H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12
H100_BYTES_PER_S = 3.35e12
NEG = -1e30  # the kernels' masked score, in the masks built for SDPA


def _cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _in_turns(run_kernel, run_plain, plain_iters=20):
    """ms of kernel and plain version, timed plain, kernel, kernel, plain:
    (kernel mean, plain mean, the four runs)."""
    plain = [_cuda_ms(run_plain, plain_iters, 1)]
    kern = [_cuda_ms(run_kernel), _cuda_ms(run_kernel)]
    plain.append(_cuda_ms(run_plain, plain_iters, 1))
    return sum(kern) / 2, sum(plain) / 2, (kern, plain)


def _turns_text(runs) -> str:
    kern, plain = runs
    return f"{kern[0]:.4f}/{kern[1]:.4f} vs {plain[0]:.4f}/{plain[1]:.4f}"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(ops, nbytes, peak):
    """(least ms on the card, what bounds it)."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sdpa_ms(q, k, v, mask, scale) -> float:
    """The one-call PyTorch time: scaled_dot_product_attention on the same
    [B, H, L, Dh] inputs with the equivalent additive float mask (timing
    only; the port never calls it). GQA K/V go in as they are."""
    fn = torch.nn.functional.scaled_dot_product_attention
    kw = dict(attn_mask=mask, scale=scale)
    if k.shape[1] != q.shape[1]:
        kw["enable_gqa"] = True
    return _cuda_ms(lambda: fn(q, k, v, **kw), iters=10, warmup=2)


def _record(err, ms, plain_ms, bound, library_ms, **extra):
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms, **extra}


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1/{N_PHASES}] device: {name}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name


def _ptxas_functions(log: str):
    """[(mangled name, registers, spill store bytes, stack bytes)] from
    ptxas's -v output, one per compiled kernel."""
    out, name, spills = [], None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name, spills = ln.split("'")[1], 0
        elif " bytes spill stores" in ln:
            spills = int(ln.split(" bytes spill stores")[0].split(",")[-1])
        elif "Used " in ln and name is not None:
            regs = int(ln.split("Used ")[1].split(" registers")[0])
            stack = (int(ln.split(" bytes cumulative stack")[0].split(",")[-1])
                     if "cumulative stack" in ln else 0)
            out.append((name, regs, spills, stack))
            name = None
    return out


# ptxas's warnings that it serialised a kernel's wgmmas (C7515, C7518): a
# divergent path or a call around them, which costs much of their rate.
WGMMA_SERIALISED = ("C7515", "C7518", "wgmma.mma_async instructions are serialized")


def phase_build():
    tic = time.perf_counter()
    _build.load_all(SOURCES)
    dt = time.perf_counter() - tic
    parts = []
    for name in SOURCES:
        log = _build.build_log(name)
        serialised = [ln for ln in log.splitlines() if any(w in ln for w in WGMMA_SERIALISED)]
        if serialised:
            raise AssertionError(f"{name}.cu: ptxas serialised the wgmmas: {serialised}")
        funcs = _ptxas_functions(log)
        if name in ("int8_fusedq", "int4_w4a8") and any(f[2] for f in funcs):
            raise AssertionError(f"{name}.cu spills: {funcs}")
        if name == "flash_blhd":
            parts.append(_flash_build_text(funcs))
            continue
        if name == "kvq_decode":
            parts.append(_kvq_build_text(funcs))
            continue
        parts.append(f"{name}.cu: {', '.join(str(f[1]) for f in funcs) or 'already built'}"
                     f" registers; spill stores {max((f[2] for f in funcs), default=0)} bytes")
    print(f"[2/{N_PHASES}] built {len(SOURCES)} sources with nvcc side by side in "
          f"{dt:.2f} s (ptxas per kernel: {' | '.join(parts)}); no wgmma serialised "
          f"(C7515/C7518)")


def _kvq_build_text(funcs) -> str:
    """B8's instances (Dh x int8/int4): registers, spills, stack, and the
    dynamic shared memory at the decode shapes, which the wrapper's
    ``_smem_bytes`` must match."""
    lib = kvq_attention._lib()
    per = []
    for mangled, regs, spills, stack in funcs:
        inst = (mangled.split("kvq_decode_kernelILi")[1].split("E")[0]
                if "kvq_decode_kernelILi" in mangled else "?")
        per.append(f"Dh {inst}{' int4' if 'ELb1E' in mangled else ''}: {regs} regs, "
                   f"{spills} B spill stores, {stack} B stack")
    smem = []
    for dh, int4, T in ((128, False, 2304), (128, True, 2304), (128, False, _r1_T()),
                        (64, False, 2304), (64, True, 1)):
        want = lib.kvq_smem_bytes(dh, int(int4), T)
        if kvq_attention._smem_bytes(dh, int4, T) != want:
            raise AssertionError(f"kvq_attention._smem_bytes({dh}, {int4}, {T}) != kernel's "
                                 f"{want}")
        smem.append(f"Dh {dh}{' int4' if int4 else ''} T {T} {want} B")
    return (f"kvq_decode.cu: {'; '.join(per) or 'already built'}; dynamic shared memory "
            f"{', '.join(smem)}")


def _flash_build_text(funcs) -> str:
    """The flash kernel's instances (one per Dh): registers at launch (the
    consumers take 232 and the producer 40 through setmaxnreg), spills,
    stack, and the dynamic shared memory at the main paths' shapes, which
    the kernel's own plan must match. Raises on a spill store."""
    lib = flash._lib()
    per_dh = []
    for mangled, regs, spills, stack in funcs:
        dh = (mangled.split("flash_blhd_kernelILi")[1].split("E")[0]
              if "flash_blhd_kernelILi" in mangled else "?")
        per_dh.append(f"Dh {dh}: {regs} regs, {spills} B spill stores, {stack} B stack")
        if spills:
            raise AssertionError(f"flash kernel Dh {dh} spills {spills} bytes: {funcs}")
    smem = []
    for dh, lk, bias in ((64, 640, True), (128, 640, False), (128, 4096, False), (16, 256, True)):
        want = lib.flash_smem_bytes(dh, lk, int(bias))
        if flash._smem_bytes(dh, lk, bias) != want:
            raise AssertionError(f"flash._smem_bytes({dh}, {lk}, {bias}) != kernel's {want}")
        smem.append(f"Dh {dh} Lk {lk}{' bias' if bias else ''} {want} B")
    return (f"flash_blhd.cu: {'; '.join(per_dh) or 'already built'}; dynamic shared "
            f"memory {', '.join(smem)}")


def _attn_case(gen, B, Lq, Lk, causal, table, cfg):
    H, Dh = cfg.num_heads, cfg.d_kv
    dev = "cuda"
    # q carries the 1/sqrt(Dh) that T5 folds into its init, as in the model.
    q = (torch.randn(B, Lq, H * Dh, generator=gen, device=dev) * Dh**-0.5).bfloat16()
    k = torch.randn(B, Lk, H * Dh, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, Lk, H * Dh, generator=gen, device=dev).bfloat16()
    lens = torch.randint(Lk // 2, Lk + 1, (B,), generator=gen, device=dev)
    mask = (torch.arange(Lk, device=dev)[None, :] < lens[:, None]).int()
    mask[-1] = 0  # a batch-padding row
    bias = t5.compute_bias(table, Lq, Lk, not causal, cfg, q_offset=Lk - Lq)
    kw = dict(kv_mask=mask.contiguous(), causal=causal, scale=1.0)
    got = flash.flash_mha_blhd(q, k, v, H, bias=bias, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    if got[-1].count_nonzero().item() != 0:
        raise AssertionError("all-padding row is not exactly 0")

    def err_against(b, kk=k, vv=v):  # max |diff| on the rows with a valid key
        want = flash.flash_mha_blhd_plain(q, kk, vv, H, bias=b, **kw)
        return (got[:-1].float() - want[:-1].float()).abs().max().item()

    err = err_against(bias)
    if not err <= KERNEL_TOL:
        raise AssertionError(f"kernel vs plain max |diff| {err} > {KERNEL_TOL}")
    # Negative controls: the plain version with the bias dropped, or read at
    # the wrong head, key column or query row, must fail the same gate, so
    # the gate tells a kernel that mishandles the bias from a right one.
    controls = {"no bias": None, "next head": bias.roll(1, 1),
                "next key": bias.roll(1, 3), "next row": bias.roll(1, 2)}
    ctl = {name: err_against(None if b is None else b.contiguous())
           for name, b in controls.items()}
    # The ring's own fault: K and V read one key tile late.
    ctl["K/V one tile late"] = err_against(bias, *(x.roll(-flash.BLOCK_K, 1) for x in (k, v)))
    blind = [name for name, e in ctl.items() if not e > KERNEL_TOL]
    if blind:
        raise AssertionError(f"gate {KERNEL_TOL} passes a wrong bias or tile {blind}: {ctl}")
    vis = _visible(mask, Lq, Lk) if causal else mask.bool()[:, None, :].expand(B, Lq, Lk)
    flops = 4 * Dh * H * int(vis.sum())  # QK^T and PV over the visible pairs

    def library_ms():
        heads = [x.unflatten(-1, (H, Dh)).transpose(1, 2) for x in (q, k, v)]
        pen = ((1 - mask) * NEG).to(q.dtype)[:, None, None, :]
        return _sdpa_ms(*heads, bias + pen, 1.0)

    return {"err": err, "ctl": ctl, "flops": flops,
            "bound": _bound(flops, _nbytes(q, k, v, got, bias, mask), H100_BF16_FLOPS),
            "kernel": lambda: flash.flash_mha_blhd(q, k, v, H, bias=bias, **kw),
            "plain": lambda: flash.flash_mha_blhd_plain(q, k, v, H, bias=bias, **kw),
            "library_ms": library_ms}


def trained_scale_bias(cfg, gen) -> torch.Tensor:
    """A [buckets, H] rel-pos table at the O(1) scale of a trained flan-t5;
    random init draws it at d_model**-0.5, too small to test the bias."""
    return torch.randn(cfg.relative_attention_num_buckets, cfg.num_heads,
                       generator=gen, device="cuda").bfloat16()


def phase_kernel(cfg):
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = trained_scale_bias(cfg, gen)
    cases = [_attn_case(gen, B, Lq, Lk, causal, table, cfg)
             for B, Lq, Lk, causal in ((32, 512, 512, False), (32, 512, 640, True),
                                       (4, 40, 200, True), (32, 640, 640, False))]
    # t5-tiny's width (H 4, Dh 16): the smallest instance of the kernel.
    tiny = T5Config.tiny()
    cases.insert(-1, _attn_case(gen, 8, 256, 256, False, trained_scale_bias(tiny, gen), tiny))
    errs = [c["err"] for c in cases]
    ctls = {}
    for c in cases:
        for name, e in c["ctl"].items():
            ctls[name] = min(e, ctls.get(name, e))
    timed = cases[-1]  # B 32, L 640
    ms, plain_ms, runs = _in_turns(timed["kernel"], timed["plain"])
    lib, bound = timed["library_ms"](), timed["bound"]
    print(f"[3/{N_PHASES}] B1 flash kernel vs plain, bf16, H16 Dh64, rel-pos bias "
          f"table of std 1: max |diff| {', '.join(f'{e:.4g}' for e in errs)} (L512, "
          f"causal 512x640, ragged causal 40x200, t5-tiny H4 Dh16 L256, L640; tol "
          f"{KERNEL_TOL}); controls, least over the cases: "
          + ", ".join(f"{n} {e:.4g}" for n, e in ctls.items())
          + f", all over tol; all-padding rows exactly 0; at B32 L640 kernel {ms:.4f} "
          f"ms ({_tflops(timed['flops'], ms):.1f} TFLOP/s), plain {plain_ms:.4f} ms (CUDA "
          f"events, mean of 20 after warm-up, two runs each: {_turns_text(runs)}); "
          f"bound {bound[0]:.4f} ms ({bound[1]}); SDPA with the float mask {lib:.4f} ms")
    return _record(max(errs), ms, plain_ms, bound, lib,
                   tflops=_tflops(timed["flops"], ms))


def _tflops(flops, ms) -> float:
    return flops / ms / 1e9


def phase_packed(gen):
    """B2 at flan-t5-xl's encoder shape."""
    cfg = T5Config.flan_t5_xl()
    B, L, H, Dh = 32, 640, cfg.num_heads, cfg.d_kv
    HD = H * Dh
    dev = "cuda"
    q = torch.randn(B, L, HD, generator=gen, device=dev) * Dh**-0.5
    k = torch.randn(B, L, HD, generator=gen, device=dev)
    v = torch.randn(B, L, HD, generator=gen, device=dev)
    qkv = torch.cat([q, k, v], dim=-1).bfloat16()
    lens = torch.randint(L // 2, L + 1, (B,), generator=gen, device=dev)
    mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]).int()
    mask[-1] = 0  # a batch-padding row
    bias = t5.compute_bias(trained_scale_bias(cfg, gen), L, L, True, cfg)
    kw = dict(kv_mask=mask.contiguous(), bias=bias, scale=1.0)
    got = flash.flash_mha_packed(qkv, H, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or got.shape != (B, L, HD):
        raise AssertionError(f"packed kernel output: shape {tuple(got.shape)} or not finite")
    if got[-1].count_nonzero().item() != 0:
        raise AssertionError("packed kernel: all-padding row is not exactly 0")

    def err_against(packed):
        want = flash.flash_mha_packed_plain(packed, H, **kw)
        return (got[:-1].float() - want[:-1].float()).abs().max().item()

    err = err_against(qkv)
    if not err <= KERNEL_TOL:
        raise AssertionError(f"packed kernel vs plain max |diff| {err} > {KERNEL_TOL}")
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    late = [x.roll(-flash.BLOCK_K, 1) for x in (kb, vb)]
    ctl = {"k at q's offset": err_against(torch.cat([qb, qb, vb], -1)),
           "v at k's offset": err_against(torch.cat([qb, kb, kb], -1)),
           "K/V one tile late": err_against(torch.cat([qb, *late], -1))}
    blind = [name for name, e in ctl.items() if not e > KERNEL_TOL]
    if blind:
        raise AssertionError(f"gate {KERNEL_TOL} passes a misread qkv {blind}: {ctl}")
    del q, k, v, qb, kb, vb, late
    ms, plain_ms, runs = _in_turns(lambda: flash.flash_mha_packed(qkv, H, **kw),
                                   lambda: flash.flash_mha_packed_plain(qkv, H, **kw), 5)
    # Attention: 2*Dh multiply-adds for QK^T and 2*Dh for PV per (head,
    # query, valid key) pair.
    flops = 4 * Dh * H * L * int(mask.sum())
    bound = _bound(flops, _nbytes(qkv, got, bias, mask), H100_BF16_FLOPS)
    heads = [x.unflatten(-1, (H, Dh)).transpose(1, 2)
             for x in qkv.unflatten(-1, (3, HD)).unbind(2)]
    lib = _sdpa_ms(*heads, bias + ((1 - mask) * NEG).to(qkv.dtype)[:, None, None, :], 1.0)
    ctl_k, ctl_v, ctl_late = ctl.values()
    print(f"[4/{N_PHASES}] B2 packed flash vs plain, bf16, qkv [{B}, {L}, {3 * HD}] "
          f"(xl: H {H}, Dh {Dh}), rel-pos table of std 1, right padding: max |diff| "
          f"{err:.4g} (tol {KERNEL_TOL}); k read at q's offset {ctl_k:.4g}, v at k's "
          f"{ctl_v:.4g}, K/V one key tile late {ctl_late:.4g}, all over tol; all-padding "
          f"row exactly 0; kernel {ms:.4f} ms ({_tflops(flops, ms):.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms (CUDA events, two runs each: {_turns_text(runs)}); "
          f"bound {bound[0]:.4f} ms ({bound[1]}); SDPA with the float mask {lib:.4f} ms")
    return _record(err, ms, plain_ms, bound, lib, tflops=_tflops(flops, ms))


def _ulp_gate(got, want, allowance=0.0):
    """(max |diff|, elements over one bf16 ulp of |want| + 1e-6 + allowance)."""
    d = (got.float() - want.float()).abs()
    lim = BF16_ULP * want.float().abs() + 1e-6 + allowance
    return d.max().item(), int((d > lim).sum().item())


B3_KERNEL = "int8_gemm_wgmma_kernel"  # B3's GEMM; the quantize pass is quantize_blocks_kernel


GATED_KERNEL = "int8_gated_wgmma_kernel"  # B4's and B6's GEMM


B7_KERNEL = "w4a8_gemm_wgmma_kernel"  # B7's GEMM; the quantize pass is quantize_blocks_kernel


def _refusal(what, call) -> str:
    """The message of the ValueError that ``call`` (a kernel wrapper given a
    row-major weight) must raise."""
    try:
        call()
    except ValueError as exc:
        return str(exc)
    raise AssertionError(f"{what} took a row-major weight")


def _gemm_build_text(source, kernel, smem) -> str:
    """A wgmma GEMM's kernel in ptxas's log of ``source`` (registers, spill
    stores) and its dynamic shared memory ``smem``."""
    funcs = [f for f in _ptxas_functions(_build.build_log(source)) if kernel in f[0]]
    regs = (f"{funcs[0][1]} registers, {funcs[0][2]} B spill stores" if funcs
            else "registers not in this process's build log (already built)")
    return f"{kernel}: {regs}, {smem} B dynamic shared memory"


@functools.lru_cache(maxsize=None)
def _gemm_device_times(kind):
    """Per site of B3, B4 and B6 (``kind`` "int8") or B7 ("int4"), the GEMM's and the
    quantize pass's device ms and the kernels one call launches, from
    torch.profiler in a process of its own (``chip_flash_ab.py --<kind>``'s
    worker on this tree): a profiler session leaves later sessions in its
    process short of events, and phase 22 counts one call's kernels with the
    profiler."""
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_flash_ab.py"), "--" + kind,
                          "--worker", ROOT], capture_output=True, text=True, cwd=ROOT)
    if res.returncode != 0:
        raise AssertionError(f"{kind} GEMM device times: the worker failed:\n"
                             f"{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _gemm_and_quantize_ms(what, dev, kernel):
    """The GEMM's and the quantize pass's device ms of one site of
    :func:`_gemm_device_times`; raises unless one call ran exactly the
    quantize pass and ``kernel``."""
    kernels = dev["kernels"]
    if (len(kernels) != 2 or not any(kernel in k for k in kernels)
            or not any("quantize_blocks" in k for k in kernels)):
        raise AssertionError(f"{what}: one call ran {kernels}, not the quantize pass and "
                             f"{kernel}")
    return dev["gemm_ms"], dev["quantize_ms"]


def phase_quantized_matmul(gen):
    """B3 at the flan-t5-xl sites and Qwen2.5-3B's (M = 32 rows x 640 tokens),
    and a ragged M, on K-major weights; a row-major weight must raise."""
    cases, timed = [], {}
    device = _gemm_device_times("int8")
    for site, M, K, N, with_res, bf16_scales in ab.B3_SITES:
        x, w8, sw = ab.int8_operands(gen, M, K, N)
        w8k = quant.to_kmajor(w8)  # the layout of the model's B3 leaves
        if bf16_scales:
            sw = sw.bfloat16()
        res = (torch.randn(M, N, generator=gen, device="cuda").bfloat16()
               if with_res else None)
        if not cases:
            refused = _refusal("B3", lambda: int8_matmul.quantized_matmul(x, w8, sw, residual=res))
        got = int8_matmul.quantized_matmul(x, w8k, sw, residual=res)
        torch.cuda.synchronize()
        want = int8_matmul.quantized_matmul_plain(x, w8, sw, res)
        if not torch.isfinite(got).all() or got.shape != (M, N):
            raise AssertionError(f"B3 {site}: shape {tuple(got.shape)} or not finite")
        zero = torch.zeros(N, device="cuda") if res is None else res[7].float()
        if not torch.equal(got[7].float(), zero):
            raise AssertionError(f"B3 {site}: an all-zero row is not 0*sw (+ residual)")
        if not torch.equal(got, want):
            raise AssertionError(f"B3 {site}: {int((got != want).sum())} elements differ "
                                 f"from the plain version")
        err, bad = _ulp_gate(got, want)
        if bad:
            raise AssertionError(f"B3 {site}: {bad} elements over one bf16 ulp, "
                                 f"max |diff| {err}")
        kb = int8_matmul.kblock(K, N, x.dtype, with_res)
        other_kb = K if kb != K else kb // 2  # a whole-row scale where kb < K
        controls = {
            "another K-block": int8_matmul.quantized_matmul_plain(x, w8, sw, res,
                                                                  kblock=other_kb),
            "sw rolled": int8_matmul.quantized_matmul_plain(x, w8, sw.roll(1, 1), res),
        }
        ctl = {name: _ulp_gate(got, c)[1] for name, c in controls.items()}
        del controls, want
        blind = [name for name, n in ctl.items() if n == 0]
        if blind:
            raise AssertionError(f"B3 {site}: the gate passes {blind}")
        ms, plain_ms, runs = _in_turns(
            lambda: int8_matmul.quantized_matmul(x, w8k, sw, residual=res),
            lambda: int8_matmul.quantized_matmul_plain(x, w8, sw, res), 3)
        gemm, qpass = _gemm_and_quantize_ms(f"B3 {site}", device[site], B3_KERNEL)
        ops = 2 * M * K * N
        bound = _bound(ops, _nbytes(x, w8, sw, res, got), H100_INT8_OPS)
        wb = (w8.bfloat16() * sw.bfloat16()).contiguous()
        yard = _cuda_ms(lambda: x @ wb, iters=10, warmup=2)
        cases.append((site, M, K, N, kb, other_kb, sw.dtype, ctl, ms, plain_ms, runs, bound,
                      gemm, qpass, yard))
        timed[site] = (err, ms, plain_ms, bound, gemm, qpass)
        del x, w8, w8k, sw, res, got, wb
        torch.cuda.empty_cache()
    # A small product of 3 x 3 tiles, the last row tile mostly past M.
    x, w8, sw = ab.int8_operands(gen, 300, 256, 384)
    edge = int8_matmul.quantized_matmul(x, quant.to_kmajor(w8), sw)
    if not torch.equal(edge, int8_matmul.quantized_matmul_plain(x, w8, sw)):
        raise AssertionError("B3 [300, 256]x[256, 384]: differs from the plain version")
    text = "; ".join(
        f"{site} [{M}, {K}]x[{K}, {N}] K-block {kb}, {str(dt)[6:]} sw: equal to the plain "
        f"version; over the gate with K-block {okb} {ctl['another K-block']} and with sw "
        f"rolled {ctl['sw rolled']} elements; call {ms:.4f} ms "
        f"({2 * M * K * N / ms / 1e9:.1f} TOP/s), plain {plain_ms:.4f} ms "
        f"({_turns_text(runs)}); device: GEMM {gemm:.4f} ms ({2 * M * K * N / gemm / 1e9:.1f} "
        f"TOP/s, {gemm / b[0]:.2f}x the bound), quantize pass {qp:.4f} ms; bound {b[0]:.4f} "
        f"ms ({b[1]}); bf16 torch.matmul yardstick {yd:.4f} ms"
        for site, M, K, N, kb, okb, dt, ctl, ms, plain_ms, runs, b, gemm, qp, yd in cases)
    b3_build = _gemm_build_text("int8_fusedq", B3_KERNEL,
                                int8_matmul._lib().quantized_matmul_smem_bytes())
    print(f"[5/{N_PHASES}] B3 W8A8 GEMM ({b3_build}) vs plain, bf16 x, K-major "
          f"int8 weights (a row-major one raises: {refused!r}); every output equal to the "
          f"plain version's bit for bit and within the gate |diff| <= 2^-7 |want| + 1e-6; "
          f"all-zero rows exactly 0*sw (+ residual); [300, 256]x[256, 384] (3 x 3 tiles) "
          f"equal too; {text}; CUDA events over whole calls, device times per kernel "
          f"from torch.profiler in a worker process (chip_flash_ab.py --int8, other "
          f"operands of the same shapes); no one PyTorch call computes it "
          f"(per-row, per-K-block activation quantization), the bf16 product is a timing "
          f"yardstick only")
    err = max(t[0] for t in timed.values())
    _, ms, plain_ms, bound, gemm, qpass = timed["qkv"]
    return _record(err, ms, plain_ms, bound, None, gemm_ms=gemm, quantize_ms=qpass)


def _gated_case(gen, site, M, K, N, act, pair, allowance_rel):
    """One B4 (``pair`` False) or B6 site of :data:`chip_flash_ab.GATED_SITES`
    on the K-major weights the models hold: (x, the weights as the kernel
    takes them, the row-major ones, output, the plain version's, max |diff|,
    the gate's allowance, elements not bit-equal).
    Raises on a wrong shape, a non-finite value or an element over the gate."""
    x, ws = ab.gated_operands(gen, M, K, N, pair)
    wk = [quant.to_kmajor(w) if w.dtype == torch.int8 else w for w in ws]
    fn, plain = ((int8_matmul.gated_matmul_pair, int8_matmul.gated_matmul_pair_plain)
                 if pair else (int8_matmul.gated_matmul, int8_matmul.gated_matmul_plain))
    got = fn(x, *wk, act=act)
    torch.cuda.synchronize()
    want = plain(x, *ws, act=act)
    if not torch.isfinite(got).all() or got.shape != (M, N):
        raise AssertionError(f"{site}: shape {tuple(got.shape)} or not finite")
    allowance = allowance_rel * want.float().abs().max().item()
    err, bad = _ulp_gate(got, want, allowance)
    if bad:
        raise AssertionError(f"{site}: {bad} elements over the gate, max |diff| {err}")
    return x, wk, ws, got, want, err, allowance, int((got != want).sum())


def _gated_device_text(site, M, K, N):
    """B4's or B6's GEMM and quantize-pass device ms at ``site`` (a worker
    process, :func:`_gemm_device_times`), its TOP/s and multiple of the
    bound: (gemm ms, quantize ms, text)."""
    dev = _gemm_device_times("int8")[site]
    gemm, qpass = _gemm_and_quantize_ms(site, dev, GATED_KERNEL)
    ops = 2 * M * K * 2 * N
    return gemm, qpass, (f"device: GEMM {gemm:.4f} ms ({ops / gemm / 1e9:.1f} TOP/s, "
                         f"{gemm / dev['bound_ms']:.2f}x its bound), quantize pass "
                         f"{qpass:.4f} ms")


def phase_gated_matmul(gen):
    """B4 at flan-t5-xl's wi_g: [20480, 2048] x [2048, 2 x 5120], gelu_new, on
    the K-major [2N, K] buffer the model holds, and at a ragged M of 1100; a
    row-major wi_g must raise."""
    (site, M, K, N, act, _), (rsite, rM, *_) = ab.GATED_SITES[:2]
    x, (wk, sp), (wp, _), got, want, err, allowance, differ = _gated_case(
        gen, site, M, K, N, act, False, TANH_ALLOWANCE)
    refused = _refusal("B4", lambda: int8_matmul.gated_matmul(x, wp, sp, act=act))
    relu = int8_matmul.gated_matmul(x, wk, sp, act="relu")
    relu_err, relu_bad = _ulp_gate(relu, int8_matmul.gated_matmul_plain(x, wp, sp, "relu"))
    if relu_bad:
        raise AssertionError(f"B4 relu: {relu_bad} elements over the gate")
    swapped = (torch.cat([wp[:, N:], wp[:, :N]], 1), torch.cat([sp[:, N:], sp[:, :N]], 1))
    controls = {"halves swapped": int8_matmul.gated_matmul_plain(x, *swapped, "gelu_new"),
                "relu for gelu_new": int8_matmul.gated_matmul_plain(x, wp, sp, "relu")}
    ctl = {name: _ulp_gate(got, c, allowance)[1] for name, c in controls.items()}
    del controls, want, relu, swapped
    blind = [name for name, n in ctl.items() if n == 0]
    if blind:
        raise AssertionError(f"B4: the gate passes {blind}")
    ms, plain_ms, runs = _in_turns(
        lambda: int8_matmul.gated_matmul(x, wk, sp, act="gelu_new"),
        lambda: int8_matmul.gated_matmul_plain(x, wp, sp, "gelu_new"), 3)
    tops = 2 * M * K * 2 * N / (ms * 1e-3) / 1e12
    bound = _bound(2 * M * K * 2 * N, _nbytes(x, wp, sp, got), H100_INT8_OPS)
    wb = (wp.bfloat16() * sp.bfloat16()).contiguous()  # wi_g dequantized, [K, 2N]
    yard = _cuda_ms(lambda: x @ wb, iters=10, warmup=2)
    del x, wk, wp, sp, got, wb
    torch.cuda.empty_cache()
    rerr, rdiffer = _gated_case(gen, rsite, rM, K, N, act, False, TANH_ALLOWANCE)[5::2]
    gemm, qpass, dev_text = _gated_device_text(site, M, K, N)
    build = _gemm_build_text("int8_fusedq", GATED_KERNEL,
                             int8_matmul._lib().gated_matmul_smem_bytes())
    print(f"[6/{N_PHASES}] B4 gated W8A8 GEMM ({build}) vs plain, K-major wi_g "
          f"[{M}, {K}]x[{K}, 2x{N}] K-block {int8_matmul.kblock(K, N, torch.bfloat16, gated=True)}, "
          f"gelu_new (a row-major wi_g raises: {refused!r}): max |diff| {err:.4g} (gate 2^-7 "
          f"|want| + 1e-6 + tanh allowance {allowance:.4g}), {differ} elements not bit-equal "
          f"to the plain version; relu {relu_err:.4g}; ragged M {rM} max |diff| {rerr:.4g}, "
          f"{rdiffer} not bit-equal; over the gate with the halves swapped "
          f"{ctl['halves swapped']} and with relu for gelu_new "
          f"{ctl['relu for gelu_new']} elements; kernel {ms:.4f} ms ({tops:.1f} TOP/s), "
          f"plain {plain_ms:.4f} ms ({_turns_text(runs)}); {dev_text}; bound {bound[0]:.4f} ms "
          f"({bound[1]}); no one PyTorch call computes it; yardstick for timing only: bf16 "
          f"torch.matmul over the dequantized wi_g [{K}, {2 * N}] {yard:.4f} ms")
    return _record(err, ms, plain_ms, bound, None, gemm_ms=gemm, quantize_ms=qpass,
                   yardstick_ms=yard, yardstick="bf16 torch.matmul over the dequantized wi_g")


def phase_gated_pair(gen):
    """B6 at Qwen2.5-3B's FFN: [20480, 2048] x two [2048, 11008], silu, on
    the K-major w_gate and w_up the model holds (bf16 scales, read in place),
    and at a ragged M of 1100; a row-major weight must raise."""
    (site, M, K, N, act, _), (rsite, rM, *_) = ab.GATED_SITES[2:]
    x, wk, (w0, s0, w1, s1), got, want, err, allowance, differ = _gated_case(
        gen, site, M, K, N, act, True, SILU_ALLOWANCE)
    refused = _refusal("B6", lambda: int8_matmul.gated_matmul_pair(x, w0, s0, wk[2], s1))
    ctl = _ulp_gate(got, int8_matmul.gated_matmul_pair_plain(x, w1, s1, w0, s0), allowance)[1]
    del want
    if ctl == 0:
        raise AssertionError("B6: the gate passes gate and up swapped")
    ms, plain_ms, runs = _in_turns(
        lambda: int8_matmul.gated_matmul_pair(x, *wk),
        lambda: int8_matmul.gated_matmul_pair_plain(x, w0, s0, w1, s1), 3)
    tops = 2 * M * K * 2 * N / (ms * 1e-3) / 1e12
    bound = _bound(2 * M * K * 2 * N, _nbytes(x, w0, s0, w1, s1, got), H100_INT8_OPS)
    wb0, wb1 = (w.bfloat16() * s.bfloat16() for w, s in ((w0, s0), (w1, s1)))
    yard = _cuda_ms(lambda: (x @ wb0, x @ wb1), iters=10, warmup=2)
    del x, wk, w0, s0, w1, s1, got, wb0, wb1
    torch.cuda.empty_cache()
    rerr, rdiffer = _gated_case(gen, rsite, rM, K, N, act, True, SILU_ALLOWANCE)[5::2]
    gemm, qpass, dev_text = _gated_device_text(site, M, K, N)
    build = _gemm_build_text("int8_fusedq", GATED_KERNEL,
                             int8_matmul._lib().gated_matmul_smem_bytes())
    print(f"[8/{N_PHASES}] B6 gated pair W8A8 GEMM ({build}) vs plain, silu, Qwen2.5-3B FFN "
          f"[{M}, {K}]x2x[{K}, {N}] K-major, K-block "
          f"{int8_matmul.kblock(K, N, torch.bfloat16, gated=True)} (a row-major weight "
          f"raises: {refused!r}): max |diff| {err:.4g} (gate 2^-7 |want| + 1e-6 + silu "
          f"allowance {allowance:.4g}), {differ} elements not bit-equal to the plain version; "
          f"ragged M {rM} max |diff| {rerr:.4g}, {rdiffer} not bit-equal; over the gate with "
          f"gate and up swapped {ctl} elements; kernel {ms:.4f} ms ({tops:.1f} TOP/s), plain "
          f"{plain_ms:.4f} ms ({_turns_text(runs)}); {dev_text}; bound {bound[0]:.4f} ms "
          f"({bound[1]}); no one PyTorch call computes it; yardstick for timing only: the two "
          f"bf16 products (torch.matmul on the dequantized weights) {yard:.4f} ms")
    return _record(err, ms, plain_ms, bound, None, gemm_ms=gemm, quantize_ms=qpass,
                   yardstick_ms=yard, yardstick="two bf16 torch.matmul on the dequantized weights")


def _w4_zero_point(x, sw):
    """The zero-point term the TPU body subtracts, as [M, N] f32: a kernel
    that folded ``q_lo . (lo4 + 8)`` without it would add this to its
    output."""
    G = x.shape[1] // sw.shape[0]
    q, scale = int8_matmul.quantize_blocks(x, G)
    zsum = 8 * q[:, :, : G // 2].sum(-1)  # [M, nk]
    return ((zsum * scale).double() @ sw.double()).float()


def phase_int4(gen):
    """B7 at Qwen2.5-3B's int4 FFN sites (gate/up G 512, down G 256), a
    ragged M with a residual and both sites at decode's M 8, on K-major
    packed weights; a row-major one must raise."""
    cases, rec, m8 = [], None, {}
    device = _gemm_device_times("int4")
    for site, M, K, N, with_res in ab.B7_SITES:
        x, p4, sw, res = ab.int4_operands(gen, M, K, N, with_res)
        p4k = quant.to_kmajor(p4)  # the layout of the model's int4 leaves
        if not cases:
            try:
                int4_matmul.quantized_matmul_int4(x, p4, sw, residual=res)
            except ValueError as exc:
                refused = str(exc)
            else:
                raise AssertionError("B7 took a row-major packed weight")
        got = int4_matmul.quantized_matmul_int4(x, p4k, sw, residual=res)
        torch.cuda.synchronize()
        want = int4_matmul.quantized_matmul_int4_plain(x, p4, sw, res)
        if not torch.isfinite(got).all() or got.shape != (M, N):
            raise AssertionError(f"B7 {site}: shape {tuple(got.shape)} or not finite")
        zero = torch.zeros(N, device="cuda") if res is None else res[7].float()
        if not torch.equal(got[7].float(), zero):
            raise AssertionError(f"B7 {site}: an all-zero row is not 0 (+ residual)")
        if not torch.equal(got, want):
            raise AssertionError(f"B7 {site}: {int((got != want).sum())} elements differ "
                                 f"from the plain version, max |diff| {_ulp_gate(got, want)[0]}")
        swapped = (((p4 & 0x0F) << 4) | ((p4 >> 4) & 0x0F)).to(torch.int8)
        controls = {
            "zero point dropped": (want.float() + _w4_zero_point(x, sw)).bfloat16(),
            "scales rolled by one group": int4_matmul.quantized_matmul_int4_plain(
                x, p4, sw.roll(1, 0), res),
            "nibble planes swapped": int4_matmul.quantized_matmul_int4_plain(
                x, swapped, sw, res),
        }
        ctl = {name: _ulp_gate(got, c)[1] for name, c in controls.items()}
        del controls, want, swapped
        blind = [name for name, n in ctl.items() if n == 0]
        if blind:
            raise AssertionError(f"B7 {site}: the gate passes {blind}")
        ms, plain_ms, runs = _in_turns(
            lambda: int4_matmul.quantized_matmul_int4(x, p4k, sw, residual=res),
            lambda: int4_matmul.quantized_matmul_int4_plain(x, p4, sw, res), 3)
        gemm, qpass = _gemm_and_quantize_ms(f"B7 {site}", device[site], B7_KERNEL)
        ops = 2 * M * K * N
        bound = _bound(ops, _nbytes(x, p4, sw, res, got), H100_INT8_OPS)
        wb = int4_matmul.unpack_int4(p4, sw).bfloat16()
        yard = _cuda_ms(lambda: x @ wb, iters=10, warmup=2)
        G = K // sw.shape[0]
        cases.append(f"{site} [{M}, {K}]x[{K}, {N}] G {G}: equal to the plain version; over "
                     f"the gate " + ", ".join(f"{n} {v}" for n, v in ctl.items())
                     + f" elements; call {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s), plain "
                     f"{plain_ms:.4f} ms ({_turns_text(runs)}); device: GEMM {gemm:.4f} ms "
                     f"({ops / gemm / 1e9:.1f} TOP/s, {gemm / bound[0]:.2f}x the bound), "
                     f"quantize pass {qpass:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}); "
                     f"bf16 torch.matmul yardstick {yard:.4f} ms")
        if rec is None:
            rec = _record(0.0, ms, plain_ms, bound, None, gemm_ms=gemm, quantize_ms=qpass,
                          yardstick_ms=yard,
                          yardstick="bf16 torch.matmul on the dequantized weight")
        if M == 8:
            m8[site] = {"ms": ms, "gemm_ms": gemm, "bound_ms": bound[0]}
        del x, p4, p4k, sw, res, got, wb
        torch.cuda.empty_cache()
    rec["m8"] = m8
    b7_build = _gemm_build_text("int4_w4a8", B7_KERNEL,
                                int4_matmul._lib().quantized_matmul_int4_smem_bytes())
    print(f"[9/{N_PHASES}] B7 W4A8 GEMM ({b7_build}) vs plain, bf16 x, K-major "
          f"packed int4 weights (a row-major one raises: {refused!r}); every output equal "
          f"to the plain version's bit for bit, all-zero rows exactly 0 (+ residual), each "
          f"control over the gate |diff| <= 2^-7 |want| + 1e-6: " + "; ".join(cases)
          + "; CUDA events over whole calls, device times per kernel from torch.profiler "
          "in a worker process (chip_flash_ab.py --int4, other operands of the same "
          "shapes); no one PyTorch call computes it (the yardstick is for timing only)")
    return rec


def _gemm_alone_ms(what, dev, kernel):
    """The GEMM's device ms of one B9 site of :func:`_gemm_device_times`;
    raises unless one call ran ``kernel`` and nothing else (no quantize
    pass)."""
    kernels = dev["kernels"]
    if len(kernels) != 1 or kernel not in kernels[0]:
        raise AssertionError(f"{what}: one call ran {kernels}, not {kernel} alone")
    return dev["gemm_ms"]


def phase_int8_matmul(gen):
    """B9 at :data:`chip_flash_ab.B9_SITES` on activations quantized per row
    and K-major weights: equal to the plain version bit for bit, one kernel a
    call; sx rolled by one row must miss the gate and a row-major weight must
    raise."""
    cases, rec = [], None
    device = _gemm_device_times("int8")
    for site, M, K, N in ab.B9_SITES:
        x, w8, sw = ab.int8_operands(gen, M, K, N)
        x8, sx = int8_matmul.quantize_rows(x)
        del x
        w8k = quant.to_kmajor(w8)  # the layout of every int8 leaf
        if not cases:
            refused = _refusal("B9", lambda: int8_matmul.int8_matmul(x8, sx, w8, sw))
        got = int8_matmul.int8_matmul(x8, sx, w8k, sw)
        torch.cuda.synchronize()
        want = int8_matmul.int8_matmul_plain(x8, sx, w8, sw)
        if not torch.isfinite(got).all() or got.shape != (M, N):
            raise AssertionError(f"{site}: shape {tuple(got.shape)} or not finite")
        if not torch.equal(got, want):
            raise AssertionError(f"{site}: {int((got != want).sum())} elements differ from "
                                 f"the plain version, max |diff| {_ulp_gate(got, want)[0]}")
        ctl = _ulp_gate(got, int8_matmul.int8_matmul_plain(x8, sx.roll(1, 0), w8, sw))[1]
        del want
        if ctl == 0:
            raise AssertionError(f"{site}: the gate passes sx rolled by one row")
        ms, plain_ms, runs = _in_turns(lambda: int8_matmul.int8_matmul(x8, sx, w8k, sw),
                                       lambda: int8_matmul.int8_matmul_plain(x8, sx, w8, sw), 3)
        gemm = _gemm_alone_ms(site, device[site], B3_KERNEL)
        ops = 2 * M * K * N
        bound = _bound(ops, _nbytes(x8, sx, w8, sw, got), H100_INT8_OPS)
        int_mm = _cuda_ms(lambda: torch._int_mm(x8, w8), iters=10, warmup=2)
        cases.append(f"{site} [{M}, {K}]x[{K}, {N}]: equal to the plain version; over the "
                     f"gate with sx rolled by one row {ctl} elements; call {ms:.4f} ms "
                     f"({ops / ms / 1e9:.1f} TOP/s), plain {plain_ms:.4f} ms "
                     f"({_turns_text(runs)}); device: GEMM {gemm:.4f} ms "
                     f"({ops / gemm / 1e9:.1f} TOP/s, {gemm / bound[0]:.2f}x the bound), one "
                     f"kernel a call, no quantize pass; bound {bound[0]:.4f} ms ({bound[1]}); "
                     f"torch._int_mm yardstick {int_mm:.4f} ms")
        if rec is None:
            rec = _record(0.0, ms, plain_ms, bound, None, gemm_ms=gemm, yardstick_ms=int_mm,
                          yardstick="torch._int_mm, the int32 product without the scales")
        del x8, sx, w8, w8k, sw, got
        torch.cuda.empty_cache()
    build = _gemm_build_text("int8_fusedq", B3_KERNEL,
                             int8_matmul._lib().quantized_matmul_smem_bytes())
    print(f"[10/{N_PHASES}] B9 int8_matmul on B3's kernel ({build}) vs plain, x8 quantized "
          f"per row, K-major int8 weights (a row-major one raises: {refused!r}); every "
          f"output equal to the plain version's bit for bit, the control over the gate "
          f"|diff| <= 2^-7 |want| + 1e-6: " + "; ".join(cases)
          + "; CUDA events over whole calls, device times from torch.profiler in a worker "
          "process (chip_flash_ab.py --int8, other operands of the same shapes); no one "
          "PyTorch call computes it, torch._int_mm (the int32 product alone, no scales) is "
          "a timing yardstick only")
    return rec


def _key_mask(gen, B, Lq, Lk, layout, pad_row=True):
    """int32 [B, Lk]: left padding (a decoder prompt batch); a right-padded
    prefix then a right-padded suffix (the shared path, with holes between
    them); or keys in one key tile only (every other tile is padding). With
    ``pad_row`` the last row is all padding."""
    dev = "cuda"
    if layout == "left":
        lens = torch.randint(Lk // 2, Lk + 1, (B,), generator=gen, device=dev)
        mask = torch.arange(Lk, device=dev)[None, :] >= (Lk - lens)[:, None]
    elif layout == "one tile":
        t0 = 2 * flash.BLOCK_K
        mask = torch.zeros(B, Lk, dtype=torch.bool, device=dev)
        mask[:, t0:t0 + flash.BLOCK_K] = torch.rand(B, flash.BLOCK_K, generator=gen,
                                                    device=dev) < 0.5
        mask[:, t0] = True
    else:
        Lp = Lk - Lq
        plen = torch.randint(Lp // 2, Lp + 1, (B,), generator=gen, device=dev)
        slen = torch.randint(Lq // 2, Lq + 1, (B,), generator=gen, device=dev)
        mask = torch.cat([torch.arange(Lp, device=dev)[None, :] < plen[:, None],
                          torch.arange(Lq, device=dev)[None, :] < slen[:, None]], dim=1)
    mask = mask.int()
    if pad_row:
        mask[-1] = 0
    return mask.contiguous()


def _visible(mask, Lq, Lk, window=None):
    """[B, Lq, Lk] bool: valid keys, causal at offset Lk - Lq, in the window."""
    rel = (torch.arange(Lq, device=mask.device)[:, None] + (Lk - Lq)
           - torch.arange(Lk, device=mask.device)[None, :])
    vis = rel >= 0
    if window is not None:
        vis = vis & (rel < window)
    return vis[None] & mask.bool()[:, None, :]


def _tile_share(mask, Lq, Lk, window=None) -> float:
    """Share of the causal kernel's (query block, key tile) pairs that it
    loads, from ``flash.key_tiles`` (the list each block builds) over the
    batch rows of ``mask``: the rest are padding or outside the band."""
    rows = mask.cpu().tolist()
    starts = range(0, Lq, flash.BLOCK_Q)
    loaded = sum(len(flash.key_tiles(r, Lq, Lk, q0, True, window))
                 for r in rows for q0 in starts)
    return loaded / (len(rows) * len(starts) * -(-Lk // flash.BLOCK_K))


def _b5_case(gen, B, Lq, Lk, H, KV, layout, window=None, Dh=128, pad_row=True):
    """B5 on q/k/v as the decoder gives them: [B, H, L, Dh] transposed
    views of the [B, L, H*Dh] projections. Returns the error, the controls'
    errors, the work, the bound, and closures that run the kernel, the plain
    version and SDPA's timing."""
    dev = "cuda"
    q = torch.randn(B, Lq, H, Dh, generator=gen, device=dev).bfloat16().transpose(1, 2)
    k = torch.randn(B, Lk, KV, Dh, generator=gen, device=dev).bfloat16().transpose(1, 2)
    v = torch.randn(B, Lk, KV, Dh, generator=gen, device=dev).bfloat16().transpose(1, 2)
    mask = _key_mask(gen, B, Lq, Lk, layout, pad_row)
    kw = dict(kv_mask=mask, causal=True, scale=Dh**-0.5, window=window)
    got = flash.flash_mha(q, k, v, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or got.shape != q.shape:
        raise AssertionError(f"B5 output: shape {tuple(got.shape)} or not finite")
    vis = _visible(mask, Lq, Lk, window)
    blind_rows = ~vis.any(-1)  # [B, Lq]: queries that see no key
    if got.transpose(1, 2)[blind_rows].count_nonzero().item() != 0:
        raise AssertionError("B5: queries that see no key (the all-padding row, "
                             "left-padding positions) are not exactly 0")
    rows = mask.any(1)  # batch rows with a valid key

    def err_against(want):
        return (got[rows].float() - want[rows].float()).abs().max().item()

    err = err_against(flash.flash_mha_plain(q, k, v, **kw))
    if not err <= KERNEL_TOL:
        raise AssertionError(f"B5 kernel vs plain max |diff| {err} > {KERNEL_TOL}")
    G = H // KV
    ctl = {"KV head h % KV": err_against(flash.flash_mha_plain(
        q, k.repeat(1, G, 1, 1), v.repeat(1, G, 1, 1), **kw)),
           "K/V one tile late": err_against(flash.flash_mha_plain(
               q, k.roll(-flash.BLOCK_K, 2), v.roll(-flash.BLOCK_K, 2), **kw))}
    if Lk != Lq:
        cols = torch.arange(Lk, device=dev)[None, :] > torch.arange(Lq, device=dev)[:, None]
        off0 = torch.where(cols, NEG, 0.0)[None, None].expand(1, H, Lq, Lk)
        ctl["causal offset 0"] = err_against(flash.flash_mha_plain(
            q, k, v, kv_mask=mask, bias=off0, scale=Dh**-0.5))
    if window is not None:
        ctl["no window"] = err_against(flash.flash_mha_plain(q, k, v, **{**kw, "window": None}))
    blind = [name for name, e in ctl.items() if not e > KERNEL_TOL]
    if blind:
        raise AssertionError(f"B5 gate {KERNEL_TOL} passes {blind}: {ctl}")
    flops = 4 * Dh * H * int(vis.sum())  # QK^T and PV over the visible pairs
    sdpa_mask = torch.where(vis, 0.0, NEG).to(q.dtype)[:, None]  # [B, 1, Lq, Lk]
    return {"err": err, "ctl": ctl, "flops": flops, "tiles": _tile_share(mask, Lq, Lk, window),
            "bound": _bound(flops, _nbytes(q, k, v, got, mask), H100_BF16_FLOPS),
            "kernel": lambda: flash.flash_mha(q, k, v, **kw),
            "plain": lambda: flash.flash_mha_plain(q, k, v, **kw),
            "library_ms": lambda: _sdpa_ms(q, k, v, sdpa_mask, Dh**-0.5)}


def phase_flash_mha(gen):
    """B5 at Qwen2.5-3B's attention shapes (c: a Mistral-like window; d:
    Rank-R1's 4096 prompt bucket), timed; then checked only: (e) ragged, Lq
    48 below one warpgroup's rows and Lk 1000 not a whole number of key
    tiles; (f) every key tile but one padding."""
    cfg = DecoderConfig.qwen25_3b()
    H, KV = cfg.num_attention_heads, cfg.num_key_value_heads
    cases = {"a": (32, 640, 640, H, KV, "left", None, True),
             "b": (32, 512, 256 + 512, H, KV, "holes", None, True),
             "c": (32, 640, 640, 32, 8, "left", 128, True),
             "d": (4, 4096, 4096, H, KV, "left", None, False),
             "e": (4, 48, 1000, H, KV, "holes", None, True),
             "f": (8, 640, 640, H, KV, "one tile", None, True)}
    out, parts = {}, []
    for name, (B, Lq, Lk, h, kv, layout, window, pad_row) in cases.items():
        case = _b5_case(gen, B, Lq, Lk, h, kv, layout, window, pad_row=pad_row)
        err, ctl, bound = case["err"], case["ctl"], case["bound"]
        text = (f"({name}) B{B} Lq{Lq} Lk{Lk} H{h} KV{kv} {layout} padding"
                f"{f' window {window}' if window else ''}: key tiles loaded "
                f"{100 * case['tiles']:.1f}%; max |diff| {err:.4g}; controls "
                + ", ".join(f"{c} {e:.4g}" for c, e in ctl.items()))
        if name in "abcd":
            ms, plain_ms, runs = _in_turns(case["kernel"], case["plain"], 3)
            lib = case["library_ms"]()
            tf = _tflops(case["flops"], ms)
            out[name] = _record(err, ms, plain_ms, bound, lib, tflops=tf)
            text += (f"; kernel {ms:.4f} ms ({tf:.1f} TFLOP/s), plain {plain_ms:.4f} ms "
                     f"({_turns_text(runs)}), bound {bound[0]:.4f} ms ({bound[1]}), "
                     f"SDPA {lib:.4f} ms")
        else:
            out[name] = {"max_abs_err": err}
        parts.append(text)
        del case
        torch.cuda.empty_cache()
    print(f"[7/{N_PHASES}] B5 GQA flash vs plain, bf16, Dh 128, scale Dh^-0.5, causal "
          f"(tol {KERNEL_TOL} on rows with a valid key; queries that see no key "
          f"exactly 0; every control over tol): " + "; ".join(parts))
    rec = dict(out["a"])  # the dec_labels shape stands for B5 in the summary
    rec["max_abs_err"] = max(r["max_abs_err"] for r in out.values())
    rec["cases"] = {name: r for name, r in out.items() if name != "a"}
    return rec


def _passage(i: int, text: str) -> str:
    filler = " it adds words so that the passage fills its tokens" * 4
    return f"{text}{filler} ({i})"


def _score_rows(engine):
    """32 setwise prompts of three 128-token passages (the 640 bucket), the
    first three labels and the ranker's decoder prefix."""
    tok = engine.tokenizer
    ranker = SetwiseLlmRanker(engine, num_child=2, k=10, scoring="likelihood")
    rows = []
    for i in range(32):
        docs = [tok.truncate(_passage(j, f"this passage talks about topic {j}"),
                             PASSAGE_TOKENS) for j in (3 * i, 3 * i + 1, 3 * i + 2)]
        rows.append(tok.encode(setwise_prompt(f"what is topic {i}", docs)))
    return rows, ranker.label_ids[:3], ranker.decoder_prefix


def _encoder_out(engine, rows, use_flash=True, plain=False):
    """The encoder's output at the valid positions of the padded rows, fp32."""
    ids, mask, _, _ = engine._pad_batch(rows)
    ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    engine.model.use_flash, engine.model.plain_kernels = use_flash, plain
    with torch.inference_mode():
        out = engine.model.encode(ids, mask)[mask.bool()].float()
    engine.model.use_flash, engine.model.plain_kernels = True, False
    return out


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _compare_logits(a, b, what):
    if a.shape != (32, 3) or not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise AssertionError(f"{what} label logits: shape {a.shape} or not finite")
    diff = float(np.abs(a - b).max())
    top2 = np.sort(b, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL
    agree = a.argmax(1) == b.argmax(1)
    if not diff <= LOGIT_TOL or not agree[clear].all():
        raise AssertionError(f"{what} label logits: max |diff| {diff}, winners "
                             f"differ on clear rows {np.where(clear & ~agree)}")
    return diff, int(agree.sum()), int(clear.sum())


def _timed_scores(engine, rows, labels, prefix):
    engine.score_labels(rows, labels, prefix)  # warm-up
    torch.cuda.synchronize()
    tic = time.perf_counter()
    logits = engine.score_labels(rows, labels, prefix)
    return logits, time.perf_counter() - tic


def phase_score_labels(cfg, model):
    engine = ScoringEngine("t5", cfg, model, ByteTokenizer(cfg.vocab_size))
    rows, labels, prefix = _score_rows(engine)
    logits, wall = {}, {}
    for use_flash in (True, False):
        model.use_flash = use_flash
        logits[use_flash], wall[use_flash] = _timed_scores(engine, rows, labels, prefix)
    model.use_flash = True
    # The label logits of a random-init model hardly depend on the encoder
    # (without its bias they moved by 0.14, under LOGIT_TOL), so the bias
    # path is held at the encoder output, with a negative control there.
    enc = {f: _encoder_out(engine, rows, f) for f in (True, False)}
    table = model.encoder.rel_bias.clone()
    model.encoder.rel_bias.zero_()
    enc_no_bias = _encoder_out(engine, rows, True)
    model.encoder.rel_bias.copy_(table)
    enc_err, enc_ctl = _rel(enc[True], enc[False]), _rel(enc_no_bias, enc[False])
    if not enc_err <= ENC_TOL:
        raise AssertionError(f"encoder output kernel vs plain: relative error "
                             f"{enc_err} > {ENC_TOL}")
    if not enc_ctl > ENC_TOL:
        raise AssertionError(f"gate {ENC_TOL} passes the encoder without its "
                             f"bias: relative error {enc_ctl}")
    diff, agree, clear = _compare_logits(logits[True], logits[False], "bf16")
    print(f"[11/{N_PHASES}] score_labels, flan-t5-large random init bf16 (encoder "
          f"rel-pos table of std 1), 32 rows x {max(map(len, rows))} tokens (L bucket "
          f"640): encoder output kernel vs plain relative error {enc_err:.4g} (tol "
          f"{ENC_TOL}), without the bias {enc_ctl:.4g}; label logits kernel vs plain "
          f"max |diff| {diff:.4g} (tol {LOGIT_TOL}); winners agree on {agree}/32 rows, "
          f"{clear} rows with margin > tol all agree; wall {wall[True] * 1e3:.1f} ms "
          f"with kernel, {wall[False] * 1e3:.1f} ms plain")


def phase_int8_score_labels(cfg, model):
    """The xl int8 path with its kernels against the same path on the
    kernels' plain versions."""
    engine = ScoringEngine("t5", cfg, model, ByteTokenizer(cfg.vocab_size), quantize="int8")
    rows, labels, prefix = _score_rows(engine)
    logits, wall = {}, {}
    for plain in (False, True):
        engine.model.plain_kernels = plain
        logits[plain], wall[plain] = _timed_scores(engine, rows, labels, prefix)
    engine.model.plain_kernels = False
    enc_err = _rel(_encoder_out(engine, rows), _encoder_out(engine, rows, plain=True))
    if not enc_err <= INT8_ENC_TOL:
        raise AssertionError(f"int8 encoder output kernels vs plain: relative error "
                             f"{enc_err} > {INT8_ENC_TOL}")
    diff, agree, clear = _compare_logits(logits[False], logits[True], "int8")
    print(f"[13/{N_PHASES}] score_labels, flan-t5-xl random init W8A8 int8 (bf16 "
          f"activations, encoder rel-pos table of std 1), 32 rows x "
          f"{max(map(len, rows))} tokens: encoder output kernels vs plain versions "
          f"relative error {enc_err:.4g} (tol {INT8_ENC_TOL}); label logits max |diff| "
          f"{diff:.4g} (tol {LOGIT_TOL}); winners agree on {agree}/32 rows, {clear} rows "
          f"with margin > tol all agree; wall {wall[False] * 1e3:.1f} ms with the "
          f"kernels, {wall[True] * 1e3:.1f} ms on the plain versions")


def phase_parity(model):
    tic = time.perf_counter()
    res = parity.t5_int8_decision_parity(model)
    if res["winner_agreement_clear_margin"] != 1.0:
        raise AssertionError(f"int8 decision parity on clear-margin rows: {res}")
    print(f"[14/{N_PHASES}] decision parity, flan-t5-xl random init, bf16 vs W8A8 int8, "
          f"{res['prompts']} prompts (bench.py's battery): label winners agree on "
          f"{res['winner_agreement']:.4f} of all rows and "
          f"{res['winner_agreement_clear_margin']:.4f} of the rows with a bf16 margin "
          f"above the median ({time.perf_counter() - tic:.1f} s)")


def _write_inputs():
    os.makedirs(SCRATCH, exist_ok=True)
    paths = {n: os.path.join(SCRATCH, n) for n in ("q.tsv", "c.jsonl", "run.txt", "out.txt")}
    with open(paths["q.tsv"], "w") as f:
        for qi in range(N_QUERIES):  # distinct within the 32-token query cut
            f.write(f"q{qi}\t{QUERY_HEADS[qi]}: which passage is about the gold "
                    f"topic {qi}\n")
    with open(paths["c.jsonl"], "w") as f:
        for d in range(N_DOCS - 1):
            f.write(json.dumps({"id": f"d{d}", "text": _passage(
                d, f"this passage talks about topic {d}")}) + "\n")
        for qi in range(N_QUERIES):
            f.write(json.dumps({"id": f"gold{qi}", "text": _passage(
                qi, f"this passage is about the gold topic {qi}")}) + "\n")
    with open(paths["run.txt"], "w") as f:
        for qi in range(N_QUERIES):
            docs = [f"d{d}" for d in range(N_DOCS - 1)]
            docs.insert(50 + qi, f"gold{qi}")
            for rank, d in enumerate(docs, 1):
                f.write(f"q{qi} Q0 {d} {rank} {N_DOCS - rank} bm25\n")
    return paths


def cli_args(paths, preset, quantize=None):
    extra = ["--quantize", quantize] if quantize else []
    return cli_run.parse_args([
        "run", "--model_name_or_path", f"random:{preset}", "--device", "cuda",
        "--dtype", "bfloat16", "--seed", "0", *extra,
        "--run_path", paths["run.txt"], "--query_file", paths["q.tsv"],
        "--corpus_file", paths["c.jsonl"], "--save_path", paths["out.txt"],
        "--hits", str(N_DOCS), "--query_length", "32",
        "--passage_length", str(PASSAGE_TOKENS), "--scoring", "likelihood",
        "setwise", "--num_child", "2", "--method", "heapsort", "--k", "10",
    ])


def phase_end_to_end(n, preset, quantize=None):
    """Rerank through the CLI; every kernel count is set to 0 just before
    and read just after."""
    paths = _write_inputs()
    args = cli_args(paths, preset, quantize)
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    report = cli_run.main(args)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    layers = cli_run.PRESETS[preset]().num_layers
    path = (("flash_mha_packed", "quantized_matmul", "gated_matmul") if quantize
            else ("flash_mha_blhd",))
    never = [name for name in path if launches[name] == 0]
    if never:
        raise AssertionError(f"the {preset} {quantize or 'bf16'} path never "
                             f"launched {never}: {launches}")
    attn = launches[path[0]]
    if attn % layers:
        raise AssertionError(f"{attn} {path[0]} launches is not a whole number of "
                             f"{layers}-layer encodes")
    with open(paths["out.txt"]) as f:
        lines = [ln.split() for ln in f]
    for qi in range(N_QUERIES):
        got = [ln for ln in lines if ln[0] == f"q{qi}"]
        want = sorted([f"d{d}" for d in range(N_DOCS - 1)] + [f"gold{qi}"])
        if sorted(ln[2] for ln in got) != want or [int(ln[3]) for ln in got] != list(
                range(1, N_DOCS + 1)):
            raise AssertionError(f"q{qi}: output is not a ranking of its {N_DOCS} docs")
    wall = report.wall_s
    comps = report.total.comparisons
    mem = torch.cuda.max_memory_allocated() / 2**30
    counts = ", ".join(f"{name} {launches[name]}" for name in COUNTERS)
    print(f"[{n}/{N_PHASES}] end to end, cli.run.main, random:{preset} bf16"
          f"{' --quantize ' + quantize if quantize else ''}, setwise heapsort "
          f"likelihood num_child 2 k 10, {N_QUERIES} queries x {N_DOCS} passages of "
          f"{PASSAGE_TOKENS} tokens: rerank wall {wall:.3f} s, "
          f"{N_QUERIES * N_DOCS / wall:.1f} docs/s, {comps} comparisons "
          f"({comps / N_QUERIES:.1f} per query); launches: {counts}; "
          f"max memory allocated {mem:.2f} GiB")
    return launches


def _decoder_rows(ranker, n=32):
    """n setwise prompts of three 128-token passages in the chat template,
    four queries with distinct heads, so rows of one query share a prefix."""
    tok = ranker.engine.tokenizer
    rows = []
    for i in range(n):
        g = i % len(QUERY_HEADS)
        docs = [tok.truncate(_passage(j, f"this passage talks about topic {j}"),
                             PASSAGE_TOKENS) for j in (3 * i, 3 * i + 1, 3 * i + 2)]
        text = setwise_prompt(f"{QUERY_HEADS[g]}: what is topic {g}", docs)
        text = tok.apply_chat_template([{"role": "user", "content": text}]) + " Passage:"
        rows.append(ranker._encode_prompt(text))
    return rows


def _decoder_engine(cfg, model, path):
    """A fresh engine on ``model`` for one scoring path (a fresh engine, so a
    run never reads prefix K/V that another attention mode computed)."""
    kw = {"plain": dict(prefix_share=False), "shared": dict(prefix_cache_mb=0),
          "cached": {}}[path]
    return ScoringEngine("decoder", cfg, model, ByteTokenizer(cfg.vocab_size), **kw)


def _shared_last_hidden(engine, rows, roll=0):
    """The shared path's last hidden states [B, D] (fp32) of the real rows;
    ``roll`` makes every row gather the K/V of the group ``roll`` after its
    own."""
    n, (pids, pmask, gidx, sids, smask), _ = engine._group(rows)
    if roll:
        gidx = (gidx + roll) % pids.shape[0]
    with torch.inference_mode():
        ks, vs = generate.decoder_prefix_kv(engine.model, pids, pmask)
        h, _ = generate.decoder_shared_prefill(
            engine.model, ks.index_select(1, gidx), vs.index_select(1, gidx),
            pmask.index_select(0, gidx), sids, smask)
    return h[:n].float()


def phase_decoder_score_labels(cfg, model):
    """Qwen2.5-3B score_labels on the plain, shared and cached paths, kernel
    (use_flash) against plain attention."""
    ranker = SetwiseLlmRanker(_decoder_engine(cfg, model, "plain"), num_child=2, k=10,
                              scoring="likelihood")
    rows, labels = _decoder_rows(ranker), ranker.label_ids[:3]
    logits, wall, programs = {}, {}, {}
    for path in ("plain", "shared", "cached"):
        for use_flash in (True, False):
            engine = _decoder_engine(cfg, model, path)
            model.use_flash = use_flash
            logits[path, use_flash], wall[path, use_flash] = _timed_scores(
                engine, rows, labels, [])
            programs[path] = sorted(engine.programs)
    model.use_flash = True
    text = []
    for path in ("plain", "shared", "cached"):
        diff, agree, clear = _compare_logits(logits[path, True], logits[path, False], path)
        text.append(f"{path} ({'+'.join(programs[path])}): max |diff| {diff:.4g}, winners "
                    f"{agree}/32, {clear} clear rows agree, wall {wall[path, True] * 1e3:.1f}"
                    f" ms kernel vs {wall[path, False] * 1e3:.1f} ms plain")
    shared_vs_plain, _, _ = _compare_logits(logits["shared", True], logits["plain", True],
                                            "shared vs plain path")
    # Last hidden states: left-padded forward and shared prefill, kernel vs
    # plain attention; rows gathering the next group's prefix must miss.
    plain_engine, shared_engine = (_decoder_engine(cfg, model, p) for p in ("plain", "shared"))
    ids, mask, n, _ = plain_engine._pad_batch(rows, left=True)
    ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    hid = {}
    for use_flash in (True, False):
        model.use_flash = use_flash
        with torch.inference_mode():
            hid["plain", use_flash] = model.forward_hidden(ids, mask)[0][:, -1][:n].float()
        hid["shared", use_flash] = _shared_last_hidden(shared_engine, rows)
    hid["rolled"] = _shared_last_hidden(shared_engine, rows, roll=1)
    model.use_flash = True
    errs = {p: _rel(hid[p, True], hid[p, False]) for p in ("plain", "shared")}
    errs["shared vs plain path"] = _rel(hid["shared", True], hid["plain", False])
    bad = {p: e for p, e in errs.items() if not e <= ENC_TOL}
    if bad:
        raise AssertionError(f"last hidden state relative error over {ENC_TOL}: {bad}")
    rolled = _rel(hid["rolled"], hid["shared", False])
    rolled_logits = float((model.label_logits(hid["rolled"].to(model.embed.dtype), torch.tensor(
        labels, device="cuda")).float() - torch.from_numpy(logits["shared", False]).cuda()
                          ).abs().max())
    if not (rolled > ENC_TOL and rolled_logits > LOGIT_TOL):
        raise AssertionError(f"gates {ENC_TOL}, {LOGIT_TOL} pass rows that gather the "
                             f"next group's prefix K/V: relative error {rolled}, logits "
                             f"{rolled_logits}")
    print(f"[16/{N_PHASES}] score_labels, Qwen2.5-3B random init bf16, 32 rows x "
          f"{max(map(len, rows))} tokens, 4 query heads, kernel vs plain attention "
          f"(logit tol {LOGIT_TOL}): " + "; ".join(text)
          + f"; shared vs plain path {shared_vs_plain:.4g}; last hidden state relative "
          f"error " + ", ".join(f"{p} {e:.4g}" for p, e in errs.items())
          + f" (tol {ENC_TOL}); rows gathering the next group's prefix K/V {rolled:.4g}, "
          f"logits {rolled_logits:.4g}, both over tol")
    return logits["plain", True]


# The kernels a quantized Qwen2.5-3B rerank must launch besides B5.
QUANT_KERNELS = {None: (), "int8": ("quantized_matmul", "gated_matmul_pair"),
                 "int4": ("quantized_matmul", "quantized_matmul_int4")}


def phase_decoder_end_to_end(n, cfg, model, quantize=None):
    """Rerank the 4 x 100 input on Qwen2.5-3B through SetwiseLlmRanker, on
    the model's own weights or with ``quantize``; the counts are set to 0
    just before and read just after."""
    paths = _write_inputs()
    args = cli_args(paths, "dec-tiny")  # the model is built here, not from the preset
    engine = ScoringEngine("decoder", cfg, model, ByteTokenizer(cfg.vocab_size),
                           quantize=quantize)
    ranker = cli_run.make_ranker(args, engine)
    first_stage = cli_run.load_inputs(args, ranker)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    tic = time.perf_counter()
    results = ranker.rerank_many([q for _, q, _ in first_stage],
                                 [r for _, _, r in first_stage])
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    for (qid, _, ranking), got in zip(first_stage, results):
        if sorted(d.docid for d in got) != sorted(d.docid for d in ranking) or len(
                got) != N_DOCS:
            raise AssertionError(f"{qid}: output is not a ranking of its {N_DOCS} docs")
    for name in ("flash_mha",) + QUANT_KERNELS[quantize]:
        if launches[name] == 0 or launches[name] % cfg.num_hidden_layers:
            raise AssertionError(f"{launches[name]} {name} launches is not a positive "
                                 f"multiple of {cfg.num_hidden_layers} layers: {launches}")
    programs = dict(engine.programs)
    missing = [p for p in ("dec_labels", "prefix_kv") if not programs.get(p)]
    if not (programs.get("dec_labels_shared") or programs.get("dec_labels_pre")):
        missing.append("dec_labels_shared/dec_labels_pre")
    if missing:
        raise AssertionError(f"the rerank never ran {missing}: {programs}")
    comps = ranker.stats.comparisons
    mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{n}/{N_PHASES}] end to end, SetwiseLlmRanker.rerank_many on Qwen2.5-3B "
          f"random init bf16{' --quantize ' + quantize if quantize else ''} (inputs from "
          f"load_inputs), setwise heapsort likelihood num_child 2 k 10, {N_QUERIES} "
          f"queries x {N_DOCS} passages of {PASSAGE_TOKENS} tokens: rerank wall "
          f"{wall:.3f} s, {N_QUERIES * N_DOCS / wall:.1f} docs/s, {comps} comparisons "
          f"({comps / N_QUERIES:.1f} per query); programs {programs}; pkv_stats "
          f"{engine.pkv_stats}; launches: " + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; max memory allocated {mem:.2f} GiB")
    return launches


def phase_quant_decoder_score_labels(n, cfg, model, quantize, bf16_logits):
    """Qwen2.5-3B score_labels with ``quantize``: the left-padded path with
    the kernels against the same quantized model on their plain versions
    (float64 sums: one path only), label logits and last hidden states held
    to one bf16 ulp per element (every kernel matches its plain version to
    the bit, and attention is B5 in both runs), with bf16's logits as the
    control that must miss; the cached path with the kernels against the
    left-padded one, shared-path hidden states, a rolled-gidx control, and
    the logits beside bf16's."""
    tok = ByteTokenizer(cfg.vocab_size)
    engine = ScoringEngine("decoder", cfg, model, tok, quantize=quantize, prefix_share=False)
    qmodel, qcfg = engine.model, engine.cfg
    ranker = SetwiseLlmRanker(engine, num_child=2, k=10, scoring="likelihood")
    rows, labels = _decoder_rows(ranker), ranker.label_ids[:3]
    logits, wall = {}, {}
    for plain in (False, True):
        qmodel.plain_kernels = plain
        logits[plain], wall[plain] = _timed_scores(engine, rows, labels, [])
    qmodel.plain_kernels = False
    _, agree, clear = _compare_logits(logits[False], logits[True], f"{quantize} plain path")
    cached = ScoringEngine("decoder", qcfg, qmodel, tok)  # already quantized
    logits["cached"], wall["cached"] = _timed_scores(cached, rows, labels, [])
    cached_diff, _, _ = _compare_logits(logits["cached"], logits[False],
                                        f"{quantize} cached vs plain path")
    ids, mask, nrows, _ = engine._pad_batch(rows, left=True)
    ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    hid = {}
    for plain in (False, True):
        qmodel.plain_kernels = plain
        with torch.inference_mode():
            hid[plain] = qmodel.forward_hidden(ids, mask)[0][:, -1][:nrows].float()
    qmodel.plain_kernels = False
    t = torch.from_numpy
    ulp = {"label logits": _ulp_gate(t(logits[False]), t(logits[True])),
           "last hidden states": _ulp_gate(hid[False], hid[True])}
    over = {what: g for what, g in ulp.items() if g[1]}
    if over:
        raise AssertionError(f"{quantize} kernels vs plain versions, (max |diff|, elements "
                             f"over one bf16 ulp): {over}")
    ctl_bf16 = _ulp_gate(t(bf16_logits), t(logits[True]))
    if ctl_bf16[1] == 0:
        raise AssertionError(f"the one-ulp gate passes bf16's logits for {quantize}'s")
    shared = ScoringEngine("decoder", qcfg, qmodel, tok, prefix_cache_mb=0)
    hid["shared"] = _shared_last_hidden(shared, rows)
    hid["rolled"] = _shared_last_hidden(shared, rows, roll=1)
    errs = {"shared vs plain path": _rel(hid["shared"], hid[False])}
    bad = {p: e for p, e in errs.items() if not e <= INT8_ENC_TOL}
    if bad:
        raise AssertionError(f"{quantize} last hidden state relative error over "
                             f"{INT8_ENC_TOL}: {bad}")
    rolled = _rel(hid["rolled"], hid["shared"])
    if not rolled > INT8_ENC_TOL:
        raise AssertionError(f"gate {INT8_ENC_TOL} passes rows that gather the next "
                             f"group's prefix K/V: relative error {rolled}")
    vs_bf16 = float(np.abs(logits[False] - bf16_logits).max())
    same = int((logits[False].argmax(1) == bf16_logits.argmax(1)).sum())
    print(f"[{n}/{N_PHASES}] score_labels, Qwen2.5-3B random init --quantize {quantize}, "
          f"32 rows x {max(map(len, rows))} tokens, kernels vs their plain versions on the "
          f"same quantized weights, gate one bf16 ulp per element: plain path "
          + ", ".join(f"{what} max |diff| {g[0]:.4g} ({g[1]} elements over)"
                      for what, g in ulp.items())
          + f", bf16's logits {ctl_bf16[1]} of {logits[True].size} over; winners "
          f"{agree}/32, {clear} clear rows agree, wall {wall[False] * 1e3:.1f} ms kernels "
          f"vs {wall[True] * 1e3:.1f} ms plain versions; cached path (kernels, "
          f"{'+'.join(sorted(cached.programs))}) vs plain path {cached_diff:.4g} (tol "
          f"{LOGIT_TOL}), wall {wall['cached'] * 1e3:.1f} ms; last hidden state relative "
          f"error " + ", ".join(f"{p} {e:.4g}" for p, e in errs.items())
          + f" (tol {INT8_ENC_TOL}); rows gathering the next group's prefix K/V "
          f"{rolled:.4g}, over tol; against bf16 (information, no gate): label logits max "
          f"|diff| {vs_bf16:.4g}, winners equal on {same}/32 rows")


# ---------------------------------------------------------------------------
# Decoder generation (B8): the kernel alone, generate, Rank-R1
# ---------------------------------------------------------------------------
GEN_BATCH, GEN_PREFIX, GEN_SUFFIX, GEN_NEW = 8, 1200, 640, 128  # bench.py rankr1_decode


def _gen_T():
    """The cache length the generate phase's shared path gives B8: the padded
    prefix area, the suffix area and the new tokens."""
    ladder = engine_mod.DEFAULT_LEN_BUCKETS
    return (engine_mod._bucket(GEN_PREFIX, ladder) + engine_mod._bucket(GEN_SUFFIX, ladder)
            + GEN_NEW)


R1_PROMPT = 3540  # Rank-R1 setwise prompts (phase 26), tokens


def _r1_T():
    """The cache length Rank-R1's decode gives B8: the prompt bucket and the
    completion budget."""
    return engine_mod._bucket(R1_PROMPT, engine_mod.DEFAULT_LEN_BUCKETS) + GEN_NEW


def _kvq_no_self(qg, kc, vc, amask, scale, mode):
    """The decode attention with the self term dropped (a control)."""
    s = kvq_attention.cached_qk(qg, kc, qg.dtype, mode, "bkgd,bktd->bkgt") * scale
    p = torch.softmax(s.masked_fill(~amask[:, None, None, :], -1e9), dim=-1)
    return kvq_attention.cached_pv(p, vc, qg.dtype, mode, "bkgt,bktd->bkgd")


def _without_rank(amask, cluster, rank):
    """The key mask with the tiles that cluster rank ``rank`` loads (each
    row's own plan, ``kvq_attention.key_tiles``) dropped: the answer of a
    kernel that left that rank's partial out."""
    out = amask.clone()
    T, tile = amask.shape[1], kvq_attention.TILE
    for b, row in enumerate(amask.cpu().tolist()):
        for t in kvq_attention.key_tiles(row, T, cluster)[rank]:
            out[b, t * tile:(t + 1) * tile] = False
    return out


def _kvq_case(gen, mode, T, window=None, layout="shared", KV=2, G=8, Dh=128):
    """B8 at one shape against its plain version, with its controls; device
    times with a cold L2 (kernel, plain, SDPA on the dequantized cache), the
    warm host-bound times and the wrapper's host time per call."""
    B = GEN_BATCH
    make = lambda: ab.kvq_inputs(gen, B, KV, G, Dh, T, mode, layout, window,  # noqa: E731
                                 GEN_PREFIX, GEN_SUFFIX, GEN_NEW, R1_PROMPT)
    qg, kc, vc, kn, vn, amask = first = make()
    scale = Dh**-0.5
    args = (qg, kc, vc, kn, vn, amask, scale, mode)
    got = kvq_attention.kvq_decode_attention(*args)
    torch.cuda.synchronize()
    if got.shape != (B, KV, G, Dh) or got.dtype != torch.float32 or not torch.isfinite(
            got).all():
        raise AssertionError(f"B8 output: {got.dtype} {tuple(got.shape)} or not finite")
    want = kvq_attention.kvq_decode_attention_plain(*args)
    err = (got - want).abs().max().item()
    if not err <= KERNEL_TOL:
        raise AssertionError(f"B8 {mode} T {T} kernel vs plain max |diff| {err} > "
                             f"{KERNEL_TOL}")
    plain = kvq_attention.kvq_decode_attention_plain
    ctl = {}
    roll = lambda c: (c[0], c[1].roll(1, dims=2))  # noqa: E731
    ctl["scales rolled by one"] = (kvq_attention.kvq_decode_attention(
        qg, roll(kc), roll(vc), kn, vn, amask, scale, mode) - want).abs().max().item()
    if mode == "int4":
        def swap(c):
            p = c[0].to(torch.int32)
            return ((((p & 0x0F) << 4) | ((p >> 4) & 0x0F)).to(torch.int8), c[1])
        ctl["nibble planes swapped"] = (kvq_attention.kvq_decode_attention(
            qg, swap(kc), swap(vc), kn, vn, amask, scale, mode) - want).abs().max().item()
    ctl["self term dropped"] = (got - _kvq_no_self(qg, kc, vc, amask, scale, mode)
                                ).abs().max().item()
    cluster = kvq_attention.cluster_size(B, KV, T, kvq_attention._sm_count(0))
    if cluster > 1:
        ctl[f"rank {cluster // 2} of {cluster} left out"] = (got - plain(
            qg, kc, vc, kn, vn, _without_rank(amask, cluster, cluster // 2), scale, mode)
        ).abs().max().item()
    # One valid tile per row (its keys half valid): held to the gate, and
    # the same computed with that tile dropped must miss it.
    one = torch.zeros_like(amask)
    t0 = 5 * kvq_attention.TILE
    one[:, t0:t0 + kvq_attention.TILE:2] = True
    got1 = kvq_attention.kvq_decode_attention(qg, kc, vc, kn, vn, one, scale, mode)
    err1 = (got1 - plain(qg, kc, vc, kn, vn, one, scale, mode)).abs().max().item()
    if not err1 <= KERNEL_TOL:
        raise AssertionError(f"B8 {mode} T {T}, one valid tile: max |diff| {err1}")
    ctl["the one valid tile dropped"] = (got1 - plain(
        qg, kc, vc, kn, vn, one & False, scale, mode)).abs().max().item()
    blind = [c for c, e in ctl.items() if not e > KERNEL_TOL]
    if blind:
        raise AssertionError(f"B8 gate {KERNEL_TOL} passes {blind}: {ctl}")
    # Bound: the rows of the keys the mask leaves (a masked key adds exactly
    # 0) and the other operands read once, the output written once; the int8
    # or nibble products at the bf16 rate (the kernel's tensor-core type).
    ops, nbytes = ab.kvq_work(first)
    bound = _bound(ops, nbytes, H100_BF16_FLOPS)
    # Device times with a cold L2: operand sets over 100 MB, cycled, from a
    # captured CUDA graph; the kernel, its plain version and SDPA on the
    # dequantized cache (the self term as its last key; timing only).
    sets = [first] + [make() for _ in range(ab.n_cold_sets(ab.operand_bytes(first)) - 1)]
    kern = [lambda a=a: kvq_attention.kvq_decode_attention(*a, scale, mode) for a in sets]
    cold = ab.cold_ms(kern)
    plain_cold = ab.cold_ms([lambda a=a: plain(*a, scale, mode) for a in sets], iters=2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sd = [ab._dequantized(kvq_attention, a, mode) for a in sets]
    lib = ab.cold_ms([lambda d=d: sdpa(*d, scale=scale, enable_gqa=True) for d in sd])
    del sd
    host = ab.host_us(kern[0])
    warm, warm_plain, runs = _in_turns(kern[0], lambda: plain(*args), 5)
    return _record(err, cold, plain_cold, bound, lib, ctl=ctl, runs=runs, nbytes=nbytes,
                   sets=len(sets), warm_ms=warm, warm_plain_ms=warm_plain, host_us=host,
                   cluster=cluster, one_tile_err=err1)


def _kernels_in_one_call(fn) -> int:
    """Device kernels one call of ``fn`` launches, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not all("kvq_decode_kernel" in n for n in names):
        raise AssertionError(f"one B8 call ran other device work: {names}")
    return len(names)


def phase_kvq(gen):
    """B8 alone: at the generate phase's shape int8 and int4, with a window,
    at the issue's unpadded T 1968, at Rank-R1's cache length and at Dh 64
    (Qwen2.5-0.5B's attention: KV 2, G 7, Dh 64)."""
    tic = time.perf_counter()
    T, T1 = _gen_T(), _r1_T()
    specs = [("int8", T, None, "shared", 2, 8, 128), ("int4", T, None, "shared", 2, 8, 128),
             ("int8", T, 512, "shared", 2, 8, 128), ("int4", 1968, None, "shared", 2, 8, 128),
             ("int8", 1968, None, "shared", 2, 8, 128), ("int8", T1, None, "left", 2, 8, 128),
             ("int8", T, None, "shared", 2, 7, 64), ("int4", T, None, "shared", 2, 7, 64)]
    cases, parts = {}, []
    for spec in specs:
        mode, t, window, layout, KV, G, Dh = spec
        rec = cases[spec] = _kvq_case(gen, mode, t, window, layout, KV, G, Dh)
        parts.append(
            f"{mode} T {t}{f' window {window}' if window else ''}"
            f"{' left-padded prompts' if layout == 'left' else ''} KV {KV} G {G} Dh {Dh} "
            f"(cluster {rec['cluster']}): max |diff| {rec['max_abs_err']:.4g} (one valid "
            f"tile {rec['one_tile_err']:.4g}); controls " + ", ".join(
                f"{c} {e:.4g}" for c, e in rec["ctl"].items())
            + f"; device, cold L2 ({rec['sets']} sets, CUDA graph): kernel {rec['ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, SDPA on the dequantized cache "
            f"{rec['library_ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
            f"{rec['nbytes'] / 1e6:.2f} MB needed); warm, host-bound: kernel {rec['warm_ms']:.4f} ms, "
            f"plain {rec['warm_plain_ms']:.4f} ms ({_turns_text(rec['runs'])}); wrapper host "
            f"time {rec['host_us']:.1f} us a call")
        torch.cuda.empty_cache()
    main8, main4 = cases[specs[0]], cases[specs[1]]
    qg, kc, vc, kn, vn, amask = ab.kvq_inputs(gen, GEN_BATCH, 2, 8, 128, T, "int8")
    n_kernels = _kernels_in_one_call(lambda: kvq_attention.kvq_decode_attention(
        qg, kc, vc, kn, vn, amask, 128**-0.5, "int8"))
    if n_kernels != 1:
        raise AssertionError(f"one B8 call launched {n_kernels} device kernels, want 1")
    lib = kvq_attention._lib()
    cl = kvq_attention.cluster_size(GEN_BATCH, 2, T, kvq_attention._sm_count(0))
    resident = {m: lib.kvq_max_active_clusters(128, int(m == "int4"), T, cl)
                for m in ("int8", "int4")}
    # The query above set the shared-memory attribute for T after a launch
    # at the longer T1 had raised it: a launch at T1 must still run.
    args1 = ab.kvq_inputs(gen, GEN_BATCH, 2, 8, 128, T1, "int8", "left", None, GEN_PREFIX,
                          GEN_SUFFIX, GEN_NEW, R1_PROMPT) + (128**-0.5, "int8")
    err_after = (kvq_attention.kvq_decode_attention(*args1)
                 - kvq_attention.kvq_decode_attention_plain(*args1)).abs().max().item()
    if not err_after <= KERNEL_TOL:
        raise AssertionError(f"B8 at T {T1} after the occupancy query: max |diff| {err_after}")
    print(f"[22/{N_PHASES}] B8 kvq_decode_attention vs plain, B {GEN_BATCH}, "
          f"prefix/suffix/tail holes, one row with only its self term (tol {KERNEL_TOL}; every "
          f"control over tol); one call = {n_kernels} device kernel; clusters of {cl} "
          f"resident at once at T {T}: int8 {resident['int8']}, int4 {resident['int4']} "
          f"(for {GEN_BATCH * 2}); T {T1} again after that query: max |diff| {err_after:.4g}: "
          + "; ".join(parts)
          + f" ({time.perf_counter() - tic:.1f} s)")
    drop = ("ctl", "runs", "nbytes")
    rec = {k: v for k, v in main8.items() if k not in drop}
    rec["max_abs_err"] = max(r["max_abs_err"] for r in cases.values())
    rec.update(shape=f"B{GEN_BATCH} KV2 G8 Dh128 T{T}", timing="device, cold L2, CUDA graph",
               int4_ms=main4["ms"], int4_plain_ms=main4["plain_ms"],
               int4_bound_ms=main4["bound_ms"], int4_library_ms=main4["library_ms"],
               int4_warm_ms=main4["warm_ms"], int4_host_us=main4["host_us"])
    return rec


def _gen_rows():
    """bench.py rankr1_decode's rows: one shared 1200-token prefix, 640-token
    suffixes, token ids from a seed."""
    rng = np.random.RandomState(929)
    pre = rng.randint(2, 30000, GEN_PREFIX).tolist()
    return [pre + rng.randint(2, 30000, GEN_SUFFIX).tolist() for _ in range(GEN_BATCH)]


def _forced_logits(engine, rows, tokens, steps, plain):
    """Logits [steps, B, V] of the decode steps that consume ``tokens[:, i]``
    (the kernel run's own tokens), on the engine's shared-prefix cache; with
    ``plain`` every kernel site of the decode on its plain version."""
    model = engine.model
    n, (pids, pmask, gidx, sids, smask), _ = engine._group(rows)
    ks, vs = generate.decoder_prefix_kv(model, pids, pmask)
    _, cache = generate.decoder_shared_prefill(
        model, ks.index_select(1, gidx), vs.index_select(1, gidx),
        pmask.index_select(0, gidx), sids, smask, steps, kv_quant=engine.cfg.kv_quant)
    kc, vc, kmask, pos = cache
    L = kmask.shape[1] - steps
    tok = torch.from_numpy(tokens).cuda()
    model.plain_kernels = plain
    out = []
    try:
        for i in range(steps):
            cos, sin = model.rope(pos[:, None], generate._act_dtype(model))
            logits, kn, vn = generate._decode_token_forward(model, tok[:, i], kc, vc, kmask,
                                                            cos, sin)
            generate._cache_put(kc, kn[:, :, :, None, :], L + i)
            generate._cache_put(vc, vn[:, :, :, None, :], L + i)
            kmask[:, L + i] = True
            pos = pos + 1
            out.append(logits.float())
    finally:
        model.plain_kernels = False
    return torch.stack(out)


def _site_times(model):
    """ms per call at decode M = 8 of the Qwen2.5-3B sites: bf16 torch.matmul,
    W8A16 (the int8 weight dequantized into the product, what qmm runs below
    M 1024) and B7."""
    from llmrankers_tpu_torch.models import quant
    lp = model.layers[0]
    x = {}
    out = {}
    for name in ("wq", "wk", "w_gate", "w_down"):
        w = lp[name]
        K, N = w.shape
        xx = x.setdefault(K, torch.randn(GEN_BATCH, K, device="cuda").bfloat16())
        w8, s8 = quantize_weight(w)
        s8 = s8.bfloat16()
        p4, s4 = int4_matmul.pack_int4(w)
        p4 = quant.to_kmajor(p4)  # the layout of the model's int4 leaves
        out[f"{name} [{K}, {N}]"] = (
            _cuda_ms(lambda: xx @ w, 50, 5),
            _cuda_ms(lambda: quant._matmul(xx, w8.to(s8.dtype) * s8), 50, 5),
            _cuda_ms(lambda: int4_matmul.quantized_matmul_int4(xx, p4, s4), 50, 5))
    return out


def phase_generate(n, cfg, model):
    """ScoringEngine.generate on Qwen2.5-3B at rankr1_decode's shape: bf16
    weights with bf16, int8 and int4 KV; int8 and int4 weights with int4 KV.
    Counts set to 0 just before each run and read just after."""
    tic0 = time.perf_counter()
    rows = _gen_rows()
    tok = ByteTokenizer(cfg.vocab_size)
    runs = [(None, None), (None, "int8"), (None, "int4"), ("int8", "int4"), ("int4", "int4")]
    parts, b8_launches, tokens = [], {}, {}
    stop = ("</answer>",)
    for quantize, kvq in runs:
        engine = ScoringEngine("decoder", cfg, model, tok, quantize=quantize, kv_quantize=kvq)
        label = f"{quantize or 'bf16'} weights, {kvq or 'bf16'} KV"
        engine.generate(rows, max_new_tokens=8, chunk_tokens=4, stop_strings=stop)  # warm-up
        # The dispatches' token matrices, before they are decoded to text.
        captured, dispatch = [], engine._generate_dispatch

        def recording(*a, **kw):
            captured.append(dispatch(*a, **kw))
            return captured[-1]

        engine._generate_dispatch = recording
        walls = {}
        for new in (1, GEN_NEW):  # prefill and one step; then the whole budget
            captured.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            engine.programs.clear()
            for fn in COUNTERS.values():
                fn.launches = 0
            tic = time.perf_counter()
            texts, ntoks = engine.generate(rows, max_new_tokens=new, chunk_tokens=GEN_NEW // 2,
                                           stop_strings=stop)
            torch.cuda.synchronize()
            walls[new] = time.perf_counter() - tic
        launches = {k: fn.launches for k, fn in COUNTERS.items()}
        programs = dict(engine.programs)
        mem = torch.cuda.max_memory_allocated() / 2**30
        ids = np.concatenate(captured)
        if len(texts) != GEN_BATCH or ids.shape != (GEN_BATCH, GEN_NEW) or sum(ntoks) == 0:
            raise AssertionError(f"{label}: generate gave {len(texts)} texts, tokens "
                                 f"{ids.shape}, counts {ntoks}")
        want_b8 = cfg.num_hidden_layers * GEN_NEW if kvq else 0
        if launches["kvq_decode_attention"] != want_b8:
            raise AssertionError(f"{label}: {launches['kvq_decode_attention']} B8 launches, "
                                 f"want {want_b8} (layers x steps): {launches}")
        if quantize == "int4" and not launches["quantized_matmul_int4"]:
            raise AssertionError(f"{label}: B7 never launched: {launches}")
        for p_ in ("dec_prefill_pre", "dec_chunk"):
            if not programs.get(p_):
                raise AssertionError(f"{label}: never ran {p_}: {programs}")
        gate = ""
        if kvq is not None:
            # The run's tokens, teacher-forced through the decode with the
            # kernels (first step) and on their plain versions (every step):
            # each token the run picked must be the plain argmax, or within
            # LOGIT_TOL of it, up to the row's EOS.
            with torch.inference_mode():
                kern = _forced_logits(engine, rows, ids, 1, plain=False)
                plain = _forced_logits(engine, rows, ids, GEN_NEW - 1, plain=True)
            first_diff = (kern[0] - plain[0]).abs().max().item()
            first_rel = _rel(kern[0], plain[0])
            # The hidden-state gates' convention: quantized weights move
            # the same difference further through 36 layers.
            rel_tol = INT8_ENC_TOL if quantize else ENC_TOL
            if not first_rel <= rel_tol:
                raise AssertionError(f"{label}: first decode step logits, kernels vs plain "
                                     f"versions, relative error {first_rel} > {rel_tol}")
            nxt = torch.from_numpy(ids[:, 1:]).cuda().T  # [steps, B]: the run's picks
            eos_at = [list(r).index(cfg.eos_token_id) if cfg.eos_token_id in r else GEN_NEW
                      for r in ids.tolist()]
            live = (torch.arange(1, GEN_NEW, device="cuda")[:, None]
                    <= torch.tensor(eos_at, device="cuda")[None, :])
            gap = (plain.max(-1).values - plain.gather(-1, nxt[..., None])[..., 0])[live]
            flips = int((gap > 0).sum())
            clear_miss = int((gap > LOGIT_TOL).sum())
            if clear_miss:
                raise AssertionError(f"{label}: {clear_miss} decode steps where the kernel "
                                     f"run's token is not the plain run's argmax by more "
                                     f"than {LOGIT_TOL}")
            gate = (f"; kernels vs plain versions: first-step logits relative error "
                    f"{first_rel:.4g} (tol {rel_tol}; max |diff| {first_diff:.4g} over the "
                    f"vocabulary), tokens equal to the plain argmax "
                    f"on {gap.numel() - flips} of {gap.numel()} steps, the rest within "
                    f"{LOGIT_TOL} of it (max gap {gap.max().item():.4g})")
            del kern, plain
        tokens[label] = ids
        b8_launches[label] = launches["kvq_decode_attention"]
        step_ms = (walls[GEN_NEW] - walls[1]) / (GEN_NEW - 1) * 1e3
        parts.append(
            f"{label}: wall {walls[GEN_NEW]:.3f} s for {GEN_NEW} tokens, {walls[1]:.3f} s for "
            f"prefill and one, so {step_ms:.2f} ms per decode step = "
            f"{GEN_BATCH * 1e3 / step_ms:.1f} tokens/s; programs {programs}; launches "
            + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
            + f"; max memory allocated {mem:.2f} GiB" + gate)
        del engine
        torch.cuda.empty_cache()
    ref = tokens["bf16 weights, bf16 KV"]
    agree = {k: float((v == ref).mean()) for k, v in tokens.items()}
    sites = _site_times(model)
    print(f"[{n}/{N_PHASES}] generate, Qwen2.5-3B random init, batch {GEN_BATCH}, shared "
          f"prefix {GEN_PREFIX} + suffix {GEN_SUFFIX}, {GEN_NEW} new tokens greedy in chunks "
          f"of {GEN_NEW // 2} with a stop string (one run each, host clock): "
          + "; ".join(parts)
          + "; token agreement with bf16/bf16 (information): " + ", ".join(
              f"{k} {v:.3f}" for k, v in agree.items())
          + "; ms per call at decode M 8 (bf16 / W8A16 / B7): " + ", ".join(
              f"{k} {a:.4f} / {b:.4f} / {c:.4f}" for k, (a, b, c) in sites.items())
          + f" ({time.perf_counter() - tic0:.1f} s)")
    return b8_launches


REFILL_ROWS, REFILL_CAP, REFILL_CHUNK = 24, 8, 32
UNSHARED = (12, 13)  # rows on prompts of their own: one refill batch, left-padded
SPEC_K = 4
SERVING_MODES = ((None, "int8"), ("int4", "int4"))  # (weights, KV) of phases 24 and 25


class IdTokenizer(ByteTokenizer):
    """The byte tokenizer with every id spelled ``<id>`` (pad and EOS left
    out): random weights emit ids above the bytes almost always, and a stop
    string ``<id>`` then fires on one token."""

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"<{i}>" for i in ids
                       if not (skip_special_tokens and i in (self.pad_id, self.eos_id)))


def _refill_rows():
    """The refill phase's 24 rows in ``_gen_rows``' shape: a shared
    1200-token prefix and 640-token suffixes, except rows 12 and 13, 1840
    tokens of their own. They form one refill batch that extends none of the
    session's prefixes, so it is prefilled left-padded beside rows of the
    shared layout (prefix, suffix, hole)."""
    rng = np.random.RandomState(930)
    pre = rng.randint(2, 30000, GEN_PREFIX).tolist()
    rows = [pre + rng.randint(2, 30000, GEN_SUFFIX).tolist() for _ in range(REFILL_ROWS)]
    for i in UNSHARED:
        rows[i] = rng.randint(2, 30000, GEN_PREFIX + GEN_SUFFIX).tolist()
    return rows


def _drive(engine, rows, stop, refill):
    """One ``generate`` of ``rows`` (GEN_NEW tokens in chunks of REFILL_CHUNK)
    on the refill session or, with ``LLMRANKERS_NO_REFILL=1``, the dispatch
    route, the counts set to 0 just before and read just after: (token
    matrix [n, GEN_NEW], token counts, host wall s, launches, programs)."""
    mats, orig = [], (engine._generate_refill, engine._generate_dispatch)

    def keep(fn):
        def run(*a, **kw):
            mats.append(fn(*a, **kw))
            return mats[-1]
        return run

    engine._generate_refill, engine._generate_dispatch = map(keep, orig)
    if refill:
        os.environ.pop("LLMRANKERS_NO_REFILL", None)
    else:
        os.environ["LLMRANKERS_NO_REFILL"] = "1"
    try:
        torch.cuda.synchronize()
        engine.programs.clear()
        for fn in COUNTERS.values():
            fn.launches = 0
        tic = time.perf_counter()
        texts, ntoks = engine.generate(rows, max_new_tokens=GEN_NEW,
                                       chunk_tokens=REFILL_CHUNK, stop_strings=stop)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    finally:
        os.environ.pop("LLMRANKERS_NO_REFILL", None)
        del engine._generate_refill, engine._generate_dispatch
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    ids = np.concatenate(mats)
    if len(texts) != len(rows) or ids.shape != (len(rows), GEN_NEW) or not sum(ntoks):
        raise AssertionError(f"generate gave {len(texts)} texts, tokens {ids.shape}, "
                             f"counts {ntoks}")
    return ids, ntoks, wall, launches, dict(engine.programs)


def _pick_stops(ids, most=4):
    """Stop strings (``<id>`` of a token) from a probe run's tokens, picked
    greedily so that rows finish at as many different chunk boundaries
    before the last as the tokens allow: (stops, finishing chunk per row,
    None for the budget)."""
    chunk = REFILL_CHUNK
    n_chunks = GEN_NEW // chunk
    first = [{} for _ in ids]
    for r, row in enumerate(ids.tolist()):
        for i, t in enumerate(row):
            first[r].setdefault(t, i)

    def finish(stops):
        out = []
        for r in range(len(ids)):
            hits = [first[r][t] // chunk for t in stops if t in first[r]]
            c = min(hits) if hits else None
            out.append(c if c is not None and c < n_chunks - 1 else None)
        return out

    def score(stops):
        f = [c for c in finish(stops) if c is not None]
        return len(set(f)), -abs(len(f) - len(ids) // 2)

    stops = []
    cands = {t for row in ids.tolist() for t in row}
    for _ in range(most):
        best = max(cands - set(stops), key=lambda t: score(stops + [t]), default=None)
        if best is None or score(stops + [best]) <= score(stops):
            break
        stops.append(best)
    return [f"<{t}>" for t in stops], finish(stops)


def _forced_margins(engine, rows, tokens):
    """Top-2 logit margins [n, S] of the steps that pick ``tokens[:, i]``:
    the prefill's for i 0, then the decode steps that consume ``tokens[:, i -
    1]``, teacher-forced on a left-padded cache with the engine's kernels."""
    model = engine.model
    S = tokens.shape[1]
    out = []
    for i0 in range(0, len(rows), GEN_BATCH):
        sub = rows[i0:i0 + GEN_BATCH]
        ids, mask, _, _ = engine._pad_batch(sub, left=True, b_cap=len(sub))
        logits, (kc, vc, kmask, pos) = generate.decoder_prefill(
            model, *engine._to_device(ids, mask), S, kv_quant=engine.cfg.kv_quant)
        L = ids.shape[1]
        tok = torch.from_numpy(tokens[i0:i0 + GEN_BATCH]).cuda()
        margins = []
        for i in range(S):
            top = logits.float().topk(2, dim=-1).values
            margins.append(top[:, 0] - top[:, 1])
            if i == S - 1:
                break
            cos, sin = model.rope(pos[:, None], generate._act_dtype(model))
            logits, kn, vn = generate._decode_token_forward(model, tok[:, i], kc, vc, kmask,
                                                            cos, sin)
            generate._cache_put(kc, kn[:, :, :, None, :], L + i)
            generate._cache_put(vc, vn[:, :, :, None, :], L + i)
            kmask[:, L + i] = True
            pos = pos + 1
        out.append(torch.stack(margins, dim=1).cpu().numpy())
        del kc, vc
    return np.concatenate(out)


def _margin_rule(engine, rows, ref, got, what):
    """Each row's tokens must equal the reference route's up to its first
    divergence, and the routes may diverge only where the teacher-forced
    top-2 logit margin (the reference's tokens before it forced, so both
    routes had that context) is within LOGIT_TOL: a divergence at a clear
    margin fails. Returns a summary."""
    div = {}
    for i in range(len(rows)):
        d = np.nonzero(ref[i] != got[i])[0]
        if d.size:
            div[i] = int(d[0])
    if not div:
        return f"{what}: all {len(rows)} rows token-equal"
    idx = sorted(div)
    with torch.inference_mode():
        margins = _forced_margins(engine, [rows[i] for i in idx],
                                  ref[idx, :max(div.values()) + 1])
    at = [(i, div[i], float(margins[j, div[i]])) for j, i in enumerate(idx)]
    bad = [x for x in at if not x[2] <= LOGIT_TOL]
    if bad:
        raise AssertionError(f"{what}: rows diverge at a clear margin (row, step, margin): "
                             f"{bad}")
    return (f"{what}: {len(rows) - len(idx)} of {len(rows)} rows token-equal, {len(idx)} "
            f"diverge at a near tie (row, step, margin <= {LOGIT_TOL}): "
            + ", ".join(f"({i}, {d}, {m:.3g})" for i, d, m in at))


def _dequant_keys(kc, mode, b):
    """Row b's cached keys, dequantized to f32 [KV, T, Dh]."""
    if mode == "int4":
        lo, hi = kvq_attention.unpack4(kc[0][b], torch.float32)
        return torch.cat([lo * kc[1][b][..., :1], hi * kc[1][b][..., 1:]], dim=-1)
    return kc[0][b].float() * kc[1][b]


def _b8_on_session(ops, mode):
    """B8 on one decode step's layer-0 operands captured from a live refill
    session, just after the left-padded refill: the mix of layouts, per-row
    write positions and the stale K/V behind refilled rows are checked to be
    there; kernel against plain within KERNEL_TOL, as captured and with a
    refilled row's query aimed at its first valid key; that row's mask one
    key tile later must miss the gate."""
    qg, kc, vc, kn, vn, amask = ops
    B, T = amask.shape
    P = T - GEN_NEW
    scale = qg.shape[-1]**-0.5
    plain = kvq_attention.kvq_decode_attention_plain
    kern = kvq_attention.kvq_decode_attention
    err = (kern(*ops, scale, mode) - plain(*ops, scale, mode)).abs().max().item()
    if not err <= KERNEL_TOL:
        raise AssertionError(f"B8 on a live refill session's operands ({mode}): max |diff| "
                             f"{err} > {KERNEL_TOL}")
    m = amask.cpu()
    left = [b for b in range(B) if not m[b, 0] and m[b, P - 1]]
    hole = [b for b in range(B) if m[b, 0] and not m[b, P - 1]]
    decoded = m[:, P:].sum(dim=1).tolist()
    stale = [b for b in left if decoded[b] == 0 and bool(kc[0][b, :, P:].ne(0).any())]
    if not (left and hole and stale and len(set(decoded)) > 1):
        raise AssertionError(f"captured step lacks the mix: left-padded rows {left}, rows "
                             f"with a hole {hole}, refilled rows with stale K/V {stale}, "
                             f"decoded per row {decoded}")
    b = stale[0]
    t0 = int(m[b].nonzero()[0])
    k0 = _dequant_keys(kc, mode, b)[:, t0]  # [KV, Dh]
    qa = qg.clone()
    qa[b] = (k0 * (30.0 / scale) / k0.pow(2).sum(-1, keepdim=True))[:, None].to(qg.dtype)
    aimed = (qa, kc, vc, kn, vn, amask, scale, mode)
    want = plain(*aimed)
    err_aimed = (kern(*aimed) - want).abs().max().item()
    if not err_aimed <= KERNEL_TOL:
        raise AssertionError(f"B8, aimed query on a live session ({mode}): max |diff| "
                             f"{err_aimed} > {KERNEL_TOL}")
    shifted = amask.clone()
    shifted[b] = amask[b].roll(kvq_attention.TILE)
    ctl = (kern(qa, kc, vc, kn, vn, shifted, scale, mode) - want).abs().max().item()
    if not ctl > KERNEL_TOL:
        raise AssertionError(f"B8 gate {KERNEL_TOL} passes row {b}'s mask one tile late "
                             f"({ctl})")
    return (f"B8 on a live step's layer-0 operands (rows left-padded {left}, with a hole "
            f"{hole}, decoded per row {decoded}, stale K/V behind refilled rows {stale}): "
            f"max |diff| {err:.4g}, with row {b}'s query aimed at its first key (t {t0}) "
            f"{err_aimed:.4g}; control, that row's mask one tile late: {ctl:.4g}")


def phase_refill(n, cfg, model):
    """Slot refill on Qwen2.5-3B: 24 rows through one session of 8 slots, 128
    new tokens in chunks of 32 with stop strings picked from a probe run,
    bf16 weights with int8 KV and int4 weights with int4 KV, against the
    dispatch route in turns; B8 held on a live step's operands."""
    tic0 = time.perf_counter()
    rows = _refill_rows()
    tok = IdTokenizer(cfg.vocab_size)
    layers = cfg.num_hidden_layers
    parts, refill_launches = [], {}
    # The refill calls, to count B5's launches inside them, and the first
    # decode step after the left-padded refill, to capture B8's operands.
    inside, cap = {"flash": 0, "depth": 0}, {}
    real = {name: getattr(generate, name) for name in (
        "decoder_refill_slots", "decoder_refill_slots_pre", "decoder_refill_slots_shared",
        "kvq_decode_attention")}

    def counted(name):
        def run(*a, **kw):
            inside["depth"] += 1
            before = flash.flash_mha.launches
            try:
                return real[name](*a, **kw)
            finally:
                inside["depth"] -= 1
                if not inside["depth"]:
                    inside["flash"] += flash.flash_mha.launches - before
                if name == "decoder_refill_slots" and "ops" not in cap:
                    cap["armed"] = True
        return run

    def capture(qg, kc, vc, kn, vn, amask, scale, mode):
        if cap.pop("armed", False):
            cap["ops"] = (qg.clone(), tuple(x.clone() for x in kc),
                          tuple(x.clone() for x in vc), kn.clone(), vn.clone(), amask.clone())
        return real["kvq_decode_attention"](qg, kc, vc, kn, vn, amask, scale, mode)

    for quantize, kvq in SERVING_MODES:
        label = f"{quantize or 'bf16'} weights, {kvq} KV"
        engine = ScoringEngine("decoder", cfg, model, tok, quantize=quantize, kv_quantize=kvq)
        engine._gen_row_limit = lambda rows_, max_new: REFILL_CAP
        probe = _drive(engine, rows, (), refill=False)[0]
        stops, fin = _pick_stops(probe)
        runs = {}
        for turn, refill in enumerate((False, True, True, False)):
            if turn == 1:
                for name in real:
                    setattr(generate, name, capture if name == "kvq_decode_attention"
                            else counted(name))
                inside["flash"] = 0
                cap.clear()
            try:
                runs.setdefault(refill, []).append(_drive(engine, rows, stops, refill))
                if turn == 1:
                    stats = dict(engine.refill_stats)
            finally:
                for name, fn in real.items():
                    setattr(generate, name, fn)
        ids_d, nt_d, _, launch_d, prog_d = runs[False][0]
        ids_r, nt_r, _, launches, programs = runs[True][0]
        if not (stats["refills"] >= 1 and stats["prefix_kv_hits"] >= 1
                and programs.get("rr_refill_pre") and programs.get("rr_refill")):
            raise AssertionError(f"{label}: refill stats {stats}, programs {programs}")
        want_b8 = layers * REFILL_CHUNK * programs["dec_chunk_rr"]
        if launches["kvq_decode_attention"] != want_b8:
            raise AssertionError(f"{label}: {launches['kvq_decode_attention']} B8 launches, "
                                 f"want {want_b8} (layers x steps of dec_chunk_rr)")
        if not inside["flash"]:
            raise AssertionError(f"{label}: B5 never launched in a refill prefill")
        if quantize == "int4" and not launches["quantized_matmul_int4"]:
            raise AssertionError(f"{label}: B7 never launched: {launches}")
        if "ops" not in cap:
            raise AssertionError(f"{label}: no decode step after the left-padded refill")
        b8_text = _b8_on_session(cap.pop("ops"), kvq)
        rule = [_margin_rule(engine, rows, ids_d, r[0], f"refill run {i + 1} vs dispatch")
                for i, r in enumerate(runs[True])]
        refill_launches[label] = launches["kvq_decode_attention"]
        walls = {k: [r[2] for r in v] for k, v in runs.items()}
        tps = {k: [sum(r[1]) / r[2] for r in v] for k, v in runs.items()}
        parts.append(
            f"{label}: stop strings {stops} (finishing chunk per row on the probe "
            f"{fin}); walls in turns dispatch {walls[False][0]:.3f} s, refill "
            f"{walls[True][0]:.3f} s, refill {walls[True][1]:.3f} s, dispatch "
            f"{walls[False][1]:.3f} s; generated tokens/s (prefills included) dispatch "
            + "/".join(f"{x:.1f}" for x in tps[False]) + ", refill "
            + "/".join(f"{x:.1f}" for x in tps[True])
            + f" ({sum(nt_r)} and {sum(nt_d)} tokens); refill stats {stats}; programs "
            f"{programs} (dispatch route {prog_d}); launches "
            + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
            + f" (B8 = {layers} x {REFILL_CHUNK} x {programs['dec_chunk_rr']}; B5 in "
            f"refill prefills {inside['flash']}); dispatch route launches "
            + ", ".join(f"{k} {v}" for k, v in launch_d.items() if v)
            + "; " + "; ".join(rule) + "; " + b8_text)
        del engine
        torch.cuda.empty_cache()
    print(f"[{n}/{N_PHASES}] slot refill, Qwen2.5-3B random init, {REFILL_ROWS} rows (shared "
          f"prefix {GEN_PREFIX} + suffix {GEN_SUFFIX}; rows {list(UNSHARED)} on prompts of "
          f"their own), {REFILL_CAP} rows per dispatch, {GEN_NEW} new tokens greedy in chunks "
          f"of {REFILL_CHUNK} (host clock; margin tol {LOGIT_TOL}, kernel tol {KERNEL_TOL}): "
          + " | ".join(parts) + f" ({time.perf_counter() - tic0:.1f} s)")
    return refill_launches


def phase_spec(n, cfg, model):
    """Prompt-lookup speculative decoding (K 4) on Qwen2.5-3B at the generate
    phase's shape (8 rows, shared prefix 1200 + suffix 640, 128 new tokens
    in chunks of 32), bf16 weights with int8 KV and int4 weights with int4
    KV, against the step route in turns; tokens held by the margin rule."""
    tic0 = time.perf_counter()
    rows = _gen_rows()
    tok = IdTokenizer(cfg.vocab_size)
    stop = ("</answer>",)
    parts = []
    for quantize, kvq in SERVING_MODES:
        label = f"{quantize or 'bf16'} weights, {kvq} KV"
        step = ScoringEngine("decoder", cfg, model, tok, quantize=quantize, kv_quantize=kvq)
        spec = ScoringEngine("decoder", cfg, model, tok, quantize=quantize, kv_quantize=kvq,
                             spec_lookup=SPEC_K)
        _drive(spec, rows[:2], stop, refill=False)  # warm-up
        runs = {}
        for which in ("step", "spec", "spec", "step"):
            eng = spec if which == "spec" else step
            before = dict(eng.spec_stats)
            runs.setdefault(which, []).append(_drive(eng, rows, stop, refill=False)
                                              + ({k: eng.spec_stats[k] - before[k]
                                                  for k in before},))
        ids_s, _, _, launches, programs, st = runs["spec"][0]
        if not programs.get("dec_spec_chunk") or not st["rounds"]:
            raise AssertionError(f"{label}: spec route ran {programs}, stats {st}")
        if quantize == "int4" and not launches["quantized_matmul_int4"]:
            raise AssertionError(f"{label}: B7 never launched: {launches}")
        ids_p = runs["step"][0][0]
        rule = [_margin_rule(step, rows, ids_p, r[0], f"spec run {i + 1} vs step")
                for i, r in enumerate(runs["spec"])]
        walls = {k: [r[2] for r in v] for k, v in runs.items()}
        parts.append(
            f"{label}: accept rate {st['tokens']} tokens / {st['rounds']} rounds = "
            f"{st['tokens'] / st['rounds']:.3f} tokens a round; walls in turns step "
            f"{walls['step'][0]:.3f} s, spec {walls['spec'][0]:.3f} s, spec "
            f"{walls['spec'][1]:.3f} s, step {walls['step'][1]:.3f} s; programs {programs}; "
            f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
            + "; " + "; ".join(rule))
        del step, spec
        torch.cuda.empty_cache()
    print(f"[{n}/{N_PHASES}] speculative decoding, prompt lookup K {SPEC_K}, Qwen2.5-3B "
          f"random init, batch {GEN_BATCH}, shared prefix {GEN_PREFIX} + suffix {GEN_SUFFIX}, "
          f"{GEN_NEW} new tokens in chunks of {REFILL_CHUNK} (host clock; margin tol "
          f"{LOGIT_TOL}): " + " | ".join(parts) + f" ({time.perf_counter() - tic0:.1f} s)")


def _write_r1_inputs(n_queries=2, n_docs=20):
    os.makedirs(SCRATCH, exist_ok=True)
    paths = {n: os.path.join(SCRATCH, "r1_" + n) for n in ("q.tsv", "c.jsonl", "run.txt",
                                                           "out.txt")}
    with open(paths["q.tsv"], "w") as f:
        for qi in range(n_queries):
            f.write(f"q{qi}\t{QUERY_HEADS[qi]}: which passage is about topic {qi}\n")
    with open(paths["c.jsonl"], "w") as f:
        for d in range(n_docs):
            f.write(json.dumps({"id": f"d{d}", "text": _passage(
                d, f"this passage talks about topic {d}")}) + "\n")
    with open(paths["run.txt"], "w") as f:
        for qi in range(n_queries):
            for rank in range(1, n_docs + 1):
                f.write(f"q{qi} Q0 d{rank - 1} {rank} {n_docs - rank} bm25\n")
    return paths


def phase_rank_r1(n):
    """Rank-R1 setwise end to end through the CLI on Qwen2.5-3B with an int8
    KV cache: 2 queries x 20 passages, num_child 19, k 1, 128 completion
    tokens. The counts are set to 0 just before and read just after."""
    paths = _write_r1_inputs()
    args = cli_run.parse_args([
        "run", "--model_name_or_path", "random:qwen2.5-3b", "--device", "cuda",
        "--dtype", "bfloat16", "--seed", "0", "--kv_quantize", "int8",
        "--prompt_file", os.path.join(ROOT, "llmrankers_tpu_torch", "prompts",
                                      "prompt_setwise-R1.toml"),
        "--run_path", paths["run.txt"], "--query_file", paths["q.tsv"],
        "--corpus_file", paths["c.jsonl"], "--save_path", paths["out.txt"],
        "--hits", "20", "--query_length", "32", "--passage_length", str(PASSAGE_TOKENS),
        "setwise", "--num_child", "19", "--method", "heapsort", "--k", "1",
        "--max_completion_tokens", str(GEN_NEW),
    ])
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    report = cli_run.main(args)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    comps = report.total.comparisons
    layers = DecoderConfig.qwen25_3b().num_hidden_layers
    b8 = launches["kvq_decode_attention"]
    if comps != 2 or b8 == 0 or b8 % (layers * GEN_NEW):
        raise AssertionError(f"Rank-R1: {comps} comparisons, {b8} B8 launches (want "
                             f"dispatches x {layers} layers x {GEN_NEW} steps): {launches}")
    if not launches["flash_mha"]:
        raise AssertionError(f"Rank-R1 prefill never launched B5: {launches}")
    with open(paths["out.txt"]) as f:
        lines = [ln.split() for ln in f]
    for qi in range(2):
        got = [ln for ln in lines if ln[0] == f"q{qi}"]
        if sorted(ln[2] for ln in got) != sorted(f"d{d}" for d in range(20)):
            raise AssertionError(f"Rank-R1 q{qi}: output is not a ranking of its 20 docs")
    mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{n}/{N_PHASES}] end to end, Rank-R1 setwise through cli.run.main, "
          f"random:qwen2.5-3b bf16 --kv_quantize int8, prompt_setwise-R1.toml, 2 queries x "
          f"20 passages of {PASSAGE_TOKENS} tokens, num_child 19, k 1, "
          f"--max_completion_tokens {GEN_NEW}: rerank wall {report.wall_s:.3f} s, {comps} "
          f"comparisons, {report.total.prompt_tokens} prompt and "
          f"{report.total.completion_tokens} completion tokens; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f"; max memory allocated {mem:.2f} GiB")
    return launches


def _kernel_entry(name, source, replaces, launches, measured, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **measured, **extra}


def main():
    name = phase_device()
    phase_build()
    large, xl = T5Config.flan_t5_large(), T5Config.flan_t5_xl()
    b1 = phase_kernel(large)
    gen = torch.Generator(device="cuda").manual_seed(1)
    b2 = phase_packed(gen)
    b3 = phase_quantized_matmul(gen)
    b4 = phase_gated_matmul(gen)
    torch.cuda.empty_cache()
    b5 = phase_flash_mha(gen)
    torch.cuda.empty_cache()
    b6 = phase_gated_pair(gen)
    torch.cuda.empty_cache()
    b7 = phase_int4(gen)
    b9 = phase_int8_matmul(gen)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = t5.init_params(large, gen, dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        model.encoder.rel_bias.copy_(trained_scale_bias(large, gen))
    phase_score_labels(large, model)
    del model
    torch.cuda.empty_cache()
    bf16_launches = phase_end_to_end(12, "t5-large")
    torch.cuda.empty_cache()
    model = t5.init_params(xl, gen, dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        model.encoder.rel_bias.copy_(trained_scale_bias(xl, gen))
    phase_int8_score_labels(xl, model)
    torch.cuda.empty_cache()
    phase_parity(model)
    del model
    torch.cuda.empty_cache()
    int8_launches = phase_end_to_end(15, "t5-xl", "int8")
    torch.cuda.empty_cache()
    qwen = DecoderConfig.qwen25_3b()
    model = decoder.init_params(qwen, gen, dtype=torch.bfloat16, device="cuda")
    bf16_logits = phase_decoder_score_labels(qwen, model)
    torch.cuda.empty_cache()
    dec_launches = phase_decoder_end_to_end(17, qwen, model)
    quant_launches = {}
    for n, quantize in ((18, "int8"), (20, "int4")):
        torch.cuda.empty_cache()
        phase_quant_decoder_score_labels(n, qwen, model, quantize, bf16_logits)
        torch.cuda.empty_cache()
        quant_launches[quantize] = phase_decoder_end_to_end(n + 1, qwen, model, quantize)
    torch.cuda.empty_cache()
    b8 = phase_kvq(torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.empty_cache()
    gen_launches = phase_generate(23, qwen, model)
    torch.cuda.empty_cache()
    refill_launches = phase_refill(24, qwen, model)
    torch.cuda.empty_cache()
    phase_spec(25, qwen, model)
    del model
    torch.cuda.empty_cache()
    r1_launches = phase_rank_r1(26)
    csrc, ops = "llmrankers_tpu_torch/csrc/", "llmrankers_tpu/ops/"
    print(f"[27/{N_PHASES}] kernels and result:")
    print(json.dumps({"kernels": [
        _kernel_entry("flash_mha_blhd", csrc + "flash_blhd.cu", ops + "flash.py:373",
                      bf16_launches["flash_mha_blhd"], b1),
        _kernel_entry("flash_mha_packed", csrc + "flash_blhd.cu", ops + "flash.py:500",
                      int8_launches["flash_mha_packed"], b2),
        _kernel_entry("quantized_matmul", csrc + "int8_fusedq.cu",
                      ops + "int8_matmul.py:395", int8_launches["quantized_matmul"], b3),
        _kernel_entry("gated_matmul", csrc + "int8_fusedq.cu",
                      ops + "int8_matmul.py:564", int8_launches["gated_matmul"], b4),
        _kernel_entry("flash_mha", csrc + "flash_blhd.cu", ops + "flash.py:220",
                      dec_launches["flash_mha"], b5),
        _kernel_entry("gated_matmul_pair", csrc + "int8_fusedq.cu",
                      ops + "int8_matmul.py:671", quant_launches["int8"]["gated_matmul_pair"],
                      b6),
        _kernel_entry("quantized_matmul_int4", csrc + "int4_w4a8.cu",
                      ops + "int4_matmul.py:281",
                      quant_launches["int4"]["quantized_matmul_int4"], b7),
        _kernel_entry("int8_matmul", csrc + "int8_fusedq.cu", ops + "int8_matmul.py:131",
                      0, b9, standalone=True),
        _kernel_entry("kvq_decode_attention", csrc + "kvq_decode.cu",
                      ops + "kvq_attention.py:167", r1_launches["kvq_decode_attention"], b8,
                      generate_launches=gen_launches, refill_launches=refill_launches),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
