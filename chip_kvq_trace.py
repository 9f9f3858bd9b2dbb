#!/usr/bin/env python3
"""Where the decode-attention kernel B8 spends one launch, block by block.

Run from the root of a checkout on one GPU:

    python3 chip_kvq_trace.py

It copies ``llmrankers_tpu_torch/csrc/kvq_decode.cu`` into
``build/kvq_trace/``, inserts a stamp at eight points of the kernel (thread 0
of each block reads ``clock64`` and, at the first and the last point, the
global timer), builds the copy with the port's nvcc flags and launches it
once per operand set with a cold L2 (a 256 MB buffer rewritten before each
launch) at the generate phase's shape (B 8, KV 2, G 8, Dh 128, T 2304,
``chip_flash_ab.kvq_inputs``), int8 and int4. The stamps go over the output,
which this build does not write. For each point it prints the median and the
largest time since the block's start over the blocks, in microseconds (the
clock's cycles over the global timer's nanoseconds give its rate), and the
cold device time of the unmodified kernel (``chip_flash_ab.cold_ms``); the
cluster size is the wrapper's (``kvq_attention.cluster_size``). The points:
the plan done (mask read, key bits, tile list), the group's tiles issued, the
first tile waited for, the last tile done, the block's partial merged, the
partials pushed to their owners and the cluster barrier passed, the join
done. It imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
POINTS = ("plan done", "tiles issued", "first tile waited", "last tile done",
          "partial merged", "pushed and cluster barrier passed", "join done")
# (anchor: a line of the kernel's code, found once; stamp inserted before it)
STAMPS = (
    ("  constexpr int DPL = DH / 32;", "  KVQ_STAMP(0) KVQ_TIME(0)\n"),
    ("  const int nvalid = s_nvalid;", "  KVQ_STAMP(1)\n"),
    ("  if (warp < G) {\n    float part = 0.f;", "  KVQ_STAMP(2)\n"),
    ("    const uint64_t vbits = bits[2 * t]", "    if (i == group) { KVQ_STAMP(3) }\n"),
    ("  constexpr int FRAG = MAXG * DH;", "  KVQ_STAMP(4)\n"),
    ("  const int chunk = (FRAG + C_ - 1) / C_;", "  KVQ_STAMP(5)\n"),
    ("  const int end = min(FRAG, (rank + 1) * chunk);", "  KVQ_STAMP(6)\n"),
)
MACROS = """
#define KVQ_SLOT(k) reinterpret_cast<long long*>(p.out)[(bh * MAX_CLUSTER + rank) * 16 + (k)]
#define KVQ_STAMP(k) if (tid == 0) { KVQ_SLOT(k) = clock64(); }
#define KVQ_TIME(k) if (tid == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); KVQ_SLOT(8 + (k)) = t_; }
"""
# The join's output write and the end of the kernel: the write is dropped
# (the stamps own the output) and the last stamp goes after the loop.
OUT_WRITE = "    p.out[(bh * G + g) * DH + d] = A / L;\n  }\n}\n"
TRACED_END = ("    if (A == -L) p.out[0] = A;  // keeps the join; the stamps own out\n  }\n"
              "  KVQ_STAMP(7) KVQ_TIME(1)\n}\n")


def traced_source() -> str:
    """kvq_decode.cu with the stamps in; raises where an anchor is not found once."""
    with open(os.path.join(ROOT, "llmrankers_tpu_torch", "csrc", "kvq_decode.cu")) as f:
        src = f.read()
    for anchor, stamp in STAMPS + ((OUT_WRITE, ""),):
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in kvq_decode.cu: {anchor!r}")
        src = src.replace(anchor, stamp + anchor)
    return MACROS + src.replace(OUT_WRITE, TRACED_END)


def build(src: str) -> ctypes.CDLL:
    from llmrankers_tpu_torch.ops import _build
    out = os.path.join(ROOT, "build", "kvq_trace")
    os.makedirs(out, exist_ok=True)
    path, so = os.path.join(out, "kvq_trace.cu"), os.path.join(out, "kvq_trace.so")
    with open(path, "w") as f:
        f.write(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    lib.kvq_decode_bf16.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    return lib


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_kvq_trace.py needs a CUDA GPU and none is available")
    import chip_flash_ab as ab
    from llmrankers_tpu_torch.ops import kvq_attention

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    lib = build(traced_source())
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, KV, G, Dh, T = 8, 2, 8, 128, 2304
    cluster = kvq_attention.cluster_size(
        B, KV, T, torch.cuda.get_device_properties(0).multi_processor_count)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for mode in ("int8", "int4"):
        sets = [ab.kvq_inputs(gen, B, KV, G, Dh, T, mode) for _ in range(4)]
        stamps = []
        for n, (qg, kc, vc, kn, vn, mask) in enumerate(sets):
            out = torch.zeros(B, KV, G, Dh, device="cuda")
            flush.fill_(n)
            torch.cuda.synchronize()
            rc = lib.kvq_decode_bf16(
                qg.data_ptr(), kc[0].data_ptr(), kc[1].data_ptr(), vc[0].data_ptr(),
                vc[1].data_ptr(), kn.data_ptr(), vn.data_ptr(), mask.data_ptr(), out.data_ptr(),
                B, KV, G, T, Dh, int(mode == "int4"), cluster, Dh**-0.5,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")
            stamps.append(out.view(torch.int64).reshape(-1)[:B * KV * 8 * 16]
                          .reshape(B * KV, 8, 16)[:, :cluster].cpu())
        st = torch.cat(stamps[1:]).double()  # the first launch also loads the module
        # A block with no tile (the row that sees only its self term) leaves
        # the first-tile stamp unset: NaN, out of the statistics.
        cyc = torch.where(st[..., 1:8] > 0, st[..., 1:8] - st[..., :1], float("nan"))
        ns = st[..., 9] - st[..., 8]
        ghz = ((st[..., 7] - st[..., 0]) / ns).median().item()
        parts = [f"{name} {cyc[..., k].nanmedian().item() / ghz / 1e3:.2f}/"
                 f"{cyc[..., k].nan_to_num(-1.0).max().item() / ghz / 1e3:.2f}"
                 for k, name in enumerate(POINTS)]
        fn = kvq_attention.kvq_decode_attention
        more = [ab.kvq_inputs(gen, B, KV, G, Dh, T, mode)
                for _ in range(max(0, ab.n_cold_sets(ab.operand_bytes(sets[0])) - len(sets)))]
        cold = ab.cold_ms([lambda a=a: fn(*a, Dh**-0.5, mode) for a in sets + more])
        print(f"B8 {mode} B {B} KV {KV} G {G} Dh {Dh} T {T}, cluster {cluster}: us since the "
              f"block's start, median/largest over {cyc.shape[0] * cyc.shape[1]} blocks: "
              + ", ".join(parts) + f"; a block {ns.median().item() / 1e3:.2f} us (clock "
              f"{ghz:.3f} GHz); unmodified kernel, cold L2: {cold * 1e3:.2f} us a launch")
    print(smi)


if __name__ == "__main__":
    main()
