#!/usr/bin/env python3
"""Time the flash kernel of two checkouts in turns on one GPU.

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
    opts = parser.parse_args()
    if opts.worker:
        print(json.dumps(_worker(opts.worker, opts.check)))
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
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=roots[tree])
        if res.returncode != 0:
            sys.exit(f"worker {tree} failed:\n{res.stderr[-4000:]}")
        runs[tree].append(json.loads(res.stdout.strip().splitlines()[-1]))
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


if __name__ == "__main__":
    main()
