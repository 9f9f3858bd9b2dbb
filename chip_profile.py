#!/usr/bin/env python3
"""Time and profile the PyTorch/CUDA port's main path on one GPU.

Run from the root of a checkout:

    python3 chip_profile.py                      # bf16 flan-t5-large
    python3 chip_profile.py --quantize int8      # W8A8 int8 flan-t5-xl
    python3 chip_profile.py --model qwen2.5-3b   # bf16 Qwen2.5-3B, decoder-only
    python3 chip_profile.py --model qwen2.5-3b --quantize int8   # or int4
    python3 chip_profile.py --decode             # Qwen2.5-3B generation

It runs ``chip_smoke.py``'s end-to-end configuration (random-init weights at
full width, 4 synthetic queries x 100 passages of 128 tokens, setwise
heapsort with likelihood scoring, num_child 2, k 10; flan-t5-large in bf16,
flan-t5-xl in int8 with ``--quantize int8``, or Qwen2.5-3B with the
shared-prefix path and the cross-wave prefix-KV cache, in bf16 or with
``--quantize int8`` or ``int4`` on the engine) through the CLI's
``make_engine`` (Qwen2.5-3B: a random-init engine built here)/
``make_ranker``/``load_inputs`` and the ranker's ``rerank_many``, all in one
process:

1. one warm-up rerank, then four timed reranks in the order plain, kernel,
   kernel, plain: rerank wall on the host clock, docs/s. "Plain" is plain
   attention in bf16, and every kernel site on the kernel's plain version
   when quantized (the quantized decoder: its GEMM sites and its attention).
   The decoder's prefix-KV cache starts empty in every rerank;
2. one more rerank with the kernels under ``torch.profiler``: device kernel
   time by kernel family, and the device's busy share in that same run
   (summed kernel time over the run's own wall; the profiler slows the host,
   so the unprofiled share is at least this);
3. with ``--quantize`` on Qwen2.5-3B, the time of each matmul site alone
   (wq/wo, wk/wv, w_gate/w_up, w_down on random weights, at M = 1024 and
   M = 20480) as bf16 ``torch.matmul``, int8 W8A16 (the dequantized product
   of the sites below the kernels' threshold), B3 and B7, in six rounds of
   turns (median and range): what a choice of the int4 cut-off
   ``INT4_MIN_SITE_PARAMS`` on this card rests on;
4. in bf16, the flash kernel's time at B 32, L 640 from CUDA events (T5:
   B1 at H 16, Dh 64; Qwen2.5-3B: B5 at H 16, KV 2, Dh 128, causal, left
   padding), its achieved bf16 TFLOP/s over the work the mask leaves, and
   that as a share of the H100 SXM data sheet's dense bf16 peak of 989
   TFLOP/s (rated at a 700 W power limit).

With ``--decode`` it measures generation instead: ``ScoringEngine.generate``
on Qwen2.5-3B at ``chip_smoke.py``'s generate shape (batch 8, a shared
1200-token prefix and 640-token suffixes, 128 new tokens greedy in chunks of
64 with the stop string "</answer>", which random weights never write), for
each weight and KV mode (bf16 weights with bf16, int8 and int4 KV; int8 and
int4 weights with int4 KV): prefill plus one step and the whole budget timed
in turns (1, 128, 128, 1 tokens), so the decode's ms per step is the
difference over 127 steps; the 128-token run with every kernel site on its
plain version, once between the kernel runs; and one profiled 128-token run
(busy share and device time by kernel family, B8 included).

It prints the card's name and power limit first and one JSON line of the
numbers last. Without a CUDA GPU it exits with an error.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

import chip_flash_ab as ab
import chip_smoke as smoke  # exits when there is no CUDA GPU
from llmrankers_tpu_torch.cli import run as cli_run
from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models import decoder
from llmrankers_tpu_torch.models.config import DecoderConfig, T5Config
from llmrankers_tpu_torch.models.quant import is_quantized, to_kmajor
from llmrankers_tpu_torch.ops import int4_matmul, int8_matmul

H100_BF16_PEAK_TFLOPS = 989.0  # NVIDIA H100 SXM data sheet, dense, 700 W
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


B7_KERNEL = "w4a8_gemm_wgmma_kernel"  # B7's GEMM; its quantize pass is quantize_blocks_kernel


def _family(name: str) -> str:
    low = name.lower()
    for family, keys in FAMILIES:
        if any(k in low for k in keys):
            return family
    return "elementwise"


def _use_kernels(model, on: bool) -> None:
    if getattr(model, "quantized", False):  # T5: GEMM and attention sites
        model.plain_kernels = not on
    elif isinstance(model, decoder.Decoder) and is_quantized(model):
        model.plain_kernels, model.use_flash = not on, on
    else:
        model.use_flash = on


def _rerank(args, engine, use_kernels: bool):
    """One rerank of the whole input: (wall seconds, comparisons). A decoder
    engine is made anew, so its prefix-KV cache starts empty."""
    if engine.kind == "decoder":
        engine = ScoringEngine("decoder", engine.cfg, engine.model, engine.tokenizer)
    _use_kernels(engine.model, use_kernels)
    ranker = cli_run.make_ranker(args, engine)
    first_stage = cli_run.load_inputs(args, ranker)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    ranker.rerank_many([q for _, q, _ in first_stage], [r for _, _, r in first_stage])
    torch.cuda.synchronize()
    return time.perf_counter() - tic, ranker.stats.comparisons


def _device_times(prof):
    """(kernel name, self device microseconds, count) of every device kernel."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append((e.key, us, e.count))
    return sorted(rows, key=lambda r: -r[1])


# Qwen2.5-3B's matmul sites, (name, K, N); wk/wv and wq/wo share shapes.
QWEN_SITES = (("wq/wo", 2048, 2048), ("wk/wv", 2048, 256),
              ("w_gate/w_up", 2048, 11008), ("w_down", 11008, 2048))


def site_times(ms=(1024, 20480), rounds=6):
    """ms per call of each Qwen2.5-3B site by route: CUDA events, mean of 20
    after warm-up, the routes timed in turns (forward, then backward,
    ``rounds`` times): {"site M": {"bf16": [t, ...], "w8a16": [...], "b3":
    [...], "b7": [...]}}, one mean per round. Each line printed gives a
    route's median and its range over the rounds."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, K, N in QWEN_SITES:
        for M in ms:
            x, w8, sw = ab.int8_operands(gen, M, K, N)
            w8k = to_kmajor(w8)  # B3 takes its weight K-major, as the model holds it
            wb = (w8.bfloat16() * sw.bfloat16()).contiguous()
            s8 = sw.bfloat16()
            p4, s4 = int4_matmul.pack_int4(torch.randn(K, N, generator=gen, device="cuda")
                                           * K**-0.5)
            p4 = to_kmajor(p4)  # B7 takes its packed weight K-major, as the model holds it
            routes = {
                "bf16": lambda: x @ wb,
                "w8a16": lambda: x @ (w8.to(s8.dtype) * s8),
                "b3": lambda: int8_matmul.quantized_matmul(x, w8k, s8),
                "b7": lambda: int4_matmul.quantized_matmul_int4(x, p4, s4),
            }
            out[f"{name} {M}"] = times = {route: [] for route in routes}
            order = list(routes)
            for _ in range(rounds):
                for route in order:
                    times[route].append(smoke._cuda_ms(routes[route]))
                order.reverse()
            print(f"  site {name:12s} [{M}, {K}]x[{K}, {N}]: " + ", ".join(
                f"{route} {statistics.median(t):.4f} ms ({min(t):.4f}-{max(t):.4f})"
                for route, t in times.items()))
            del x, w8, w8k, sw, wb, p4, s4
    return out


def _profile(fn):
    """Run ``fn`` under torch.profiler, tracing the device only (a decode
    run launches some 10^5 kernels; tracing the host's ops too costs
    minutes): (wall s, device kernel s, busy share, ms by kernel family,
    the top kernels)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    rows = _device_times(prof)
    total_us = sum(us for _, us, _ in rows)
    if total_us == 0:
        raise RuntimeError("the profiler recorded no device time")
    b7 = [name for name, _, _ in rows if _family(name) == "w4a8 gemm (B7)"]
    if not all(B7_KERNEL in name for name in b7):
        raise RuntimeError(f"kernels other than {B7_KERNEL} under w4a8 gemm (B7): {b7}")
    by_family = {}
    for name, us, _ in rows:
        by_family[_family(name)] = by_family.get(_family(name), 0.0) + us / 1e3
    return wall, total_us / 1e6, total_us / 1e6 / wall, by_family, rows[:8]


DECODE_MODES = ((None, None), (None, "int8"), (None, "int4"), ("int8", "int4"),
                ("int4", "int4"))


def decode_main():
    """Generation on Qwen2.5-3B for every weight and KV mode (module
    docstring)."""
    cfg = DecoderConfig.qwen25_3b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = decoder.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    rows, new = smoke._gen_rows(), smoke.GEN_NEW
    out = {"device": torch.cuda.get_device_name(0), "batch": len(rows),
           "prompt_tokens": len(rows[0]), "new_tokens": new, "modes": {}}
    for quantize, kvq in DECODE_MODES:
        engine = ScoringEngine("decoder", cfg, model, ByteTokenizer(cfg.vocab_size),
                               quantize=quantize, kv_quantize=kvq)
        label = f"{quantize or 'bf16'} weights, {kvq or 'bf16'} KV"

        def run(n):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            engine.generate(rows, max_new_tokens=n, chunk_tokens=new // 2,
                            stop_strings=("</answer>",))
            torch.cuda.synchronize()
            return time.perf_counter() - tic

        run(8)  # warm-up
        walls = {1: [], new: []}
        for n in (1, new, new, 1):
            walls[n].append(run(n))
        engine.model.plain_kernels = True
        plain = run(new)
        engine.model.plain_kernels = False
        step_ms = (statistics.mean(walls[new]) - statistics.mean(walls[1])) / (new - 1) * 1e3
        pwall, dev_s, busy, fam, top = _profile(lambda: run(new))
        print(f"{label}: walls 1 token {walls[1][0]:.4f}/{walls[1][1]:.4f} s, {new} tokens "
              f"{walls[new][0]:.4f}/{walls[new][1]:.4f} s, {new} on the plain versions "
              f"{plain:.4f} s; decode {step_ms:.3f} ms/step = "
              f"{len(rows) * 1e3 / step_ms:.1f} tokens/s; profiled {new}-token run: wall "
              f"{pwall:.4f} s, device kernel time {dev_s:.4f} s, busy share {busy:.4f}")
        for family, ms in sorted(fam.items(), key=lambda x: -x[1]):
            print(f"  {family:16s} {ms:10.1f} ms {100 * ms / (dev_s * 1e3):6.1f}%")
        for name, us, count in top:
            print(f"  {us / 1e3:9.1f} ms  n={count:6d}  {name[:100]}")
        out["modes"][label] = {
            "wall_1_s": walls[1], "wall_new_s": walls[new], "wall_new_plain_s": plain,
            "decode_ms_per_step": step_ms, "decode_tokens_per_s": len(rows) * 1e3 / step_ms,
            "profiled_wall_s": pwall, "device_kernel_s": dev_s, "busy_share_profiled": busy,
            "family_ms": fam}
        del engine
        torch.cuda.empty_cache()
    print(json.dumps(out))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quantize", choices=("int8", "int4"), default=None)
    parser.add_argument("--model", choices=("t5", "qwen2.5-3b"), default="t5")
    parser.add_argument("--decode", action="store_true",
                        help="Qwen2.5-3B generation in every weight and KV mode")
    opts = parser.parse_args()
    if opts.decode:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
        return decode_main()
    quantize = opts.quantize
    if quantize == "int4" and opts.model == "t5":
        parser.error("--quantize int4 targets decoder models (--model qwen2.5-3b)")
    preset = opts.model if opts.model != "t5" else "t5-xl" if quantize else "t5-large"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    if opts.model == "t5":
        args = smoke.cli_args(smoke._write_inputs(), preset, quantize)
        engine = cli_run.make_engine(args.run)
    else:  # the model is built here; the args only carry the input and ranker
        args = smoke.cli_args(smoke._write_inputs(), "dec-tiny")
        cfg = DecoderConfig.qwen25_3b()
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = decoder.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
        engine = ScoringEngine("decoder", cfg, model, ByteTokenizer(cfg.vocab_size),
                               quantize=quantize)
        del model  # a quantized engine holds its own copy of the weights
    docs = smoke.N_QUERIES * smoke.N_DOCS

    _rerank(args, engine, True)  # warm-up: first calls of each batch shape
    walls = {"plain": [], "kernel": []}
    comparisons = None
    for label in ("plain", "kernel", "kernel", "plain"):
        wall, comparisons = _rerank(args, engine, label == "kernel")
        walls[label].append(wall)
    print(f"rerank wall, random:{preset} {quantize or 'bf16'}, {smoke.N_QUERIES} "
          f"queries x {smoke.N_DOCS} passages, {comparisons} comparisons: kernels "
          + ", ".join(f"{w:.4f} s ({docs / w:.2f} docs/s)" for w in walls["kernel"])
          + "; plain versions "
          + ", ".join(f"{w:.4f} s ({docs / w:.2f} docs/s)" for w in walls["plain"]))

    for fn in smoke.COUNTERS.values():
        fn.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall, _ = _rerank(args, engine, True)
    launches = {name: fn.launches for name, fn in smoke.COUNTERS.items()}
    rows = _device_times(prof)
    total_us = sum(us for _, us, _ in rows)
    if total_us == 0:
        raise RuntimeError("the profiler recorded no device time")
    busy = total_us / 1e6 / prof_wall
    # B3's calls ran its wgmma kernel, B4's and B6's the gated wgmma kernel,
    # and the mma.sync body (int8_gemm_kernel) only B9's calls.
    int8_calls = {"int8_gemm_wgmma": launches["quantized_matmul"],
                  smoke.GATED_KERNEL: launches["gated_matmul"] + launches["gated_matmul_pair"],
                  "int8_gemm_kernel": launches["int8_matmul"]}
    if any(int8_calls.values()):
        ran = {key: sum(n for name, _, n in rows if key in name) for key in int8_calls}
        if ran != int8_calls:
            raise RuntimeError(f"int8 GEMM device launches {ran} for the wrappers' calls "
                               f"{int8_calls}")
    if launches["quantized_matmul_int4"]:  # B7's launches ran its wgmma kernel, no other
        b7 = {name: n for name, _, n in rows if _family(name) == "w4a8 gemm (B7)"}
        if (sum(b7.values()) != launches["quantized_matmul_int4"]
                or not all(B7_KERNEL in name for name in b7)):
            raise RuntimeError(f"device launches {b7} under w4a8 gemm (B7) for "
                               f"{launches['quantized_matmul_int4']} B7 calls")
    by_family = {}
    for name, us, _ in rows:
        by_family[_family(name)] = by_family.get(_family(name), 0.0) + us
    print(f"profiled rerank (kernels): wall {prof_wall:.4f} s, device kernel time "
          f"{total_us / 1e6:.4f} s, busy share {busy:.4f} under the profiler; "
          f"launches {launches}")
    for family, us in sorted(by_family.items(), key=lambda x: -x[1]):
        print(f"  {family:14s} {us / 1e3:10.1f} ms {100 * us / total_us:6.1f}%")
    for name, us, count in rows[:14]:
        print(f"  {us / 1e3:9.1f} ms  n={count:6d}  {name[:100]}")

    out = {
        "device": torch.cuda.get_device_name(0), "preset": preset,
        "quantize": quantize, "comparisons": comparisons,
        "wall_kernel_s": walls["kernel"], "wall_plain_s": walls["plain"],
        "profiled_wall_s": prof_wall, "device_kernel_s": total_us / 1e6,
        "busy_share_profiled": busy, "launches": launches,
        "family_ms": {f: us / 1e3 for f, us in by_family.items()},
    }
    if quantize and opts.model != "t5":
        print("per-site times, Qwen2.5-3B shapes, random weights (ms per call):")
        out["site_ms"] = site_times()
    if not quantize:
        gen = torch.Generator(device="cuda").manual_seed(0)
        B, L = 32, 640
        if opts.model == "t5":
            cfg = T5Config.flan_t5_large()
            H, Dh = cfg.num_heads, cfg.d_kv
            case = smoke._attn_case(gen, B, L, L, False,
                                    smoke.trained_scale_bias(cfg, gen), cfg)
        else:
            cfg = DecoderConfig.qwen25_3b()
            H, Dh = cfg.num_attention_heads, cfg.head_dim_
            case = smoke._b5_case(gen, B, L, L, H, cfg.num_key_value_heads, "left")
        ms = smoke._cuda_ms(case["kernel"])
        tflops = case["flops"] / (ms * 1e-3) / 1e12
        bound = case["bound"]
        print(f"flash kernel B{B} L{L} H{H} Dh{Dh} bf16: {ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}), {tflops:.2f} TFLOP/s over the masked work, "
              f"{100 * tflops / H100_BF16_PEAK_TFLOPS:.2f}% of the "
              f"{H100_BF16_PEAK_TFLOPS:.0f} TFLOP/s bf16 data-sheet peak")
        out.update(flash_ms_b32_l640=ms, flash_tflops=tflops, flash_bound_ms=bound[0])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
