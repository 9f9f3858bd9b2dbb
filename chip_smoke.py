#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``llmrankers_tpu_torch/csrc`` and then,
one line per phase:

1. prints the device, and the card's name and power limit from nvidia-smi;
2. builds the flash kernel with nvcc and prints the build time;
3. holds the kernel against its plain PyTorch version at the main path's
   shapes in bf16 (flan-t5-large encoder: B 32, L 512 and 640, H 16, Dh 64,
   a rel-pos bias table of std 1 as in a trained model, right padding, one
   all-padding row that must come out as exact zeros, one causal case with
   Lq != Lk), checks that a wrong bias (none, or the next head's, key's or
   row's) fails the same gate, and times kernel and plain version;
4. runs ``score_labels`` on a random-init flan-t5-large at full width in bf16
   (its encoder bias table redrawn at std 1), once through the kernel and
   once with plain attention, and compares the encoder outputs and the
   label logits; without its bias the encoder output must fail the gate;
5. reranks 4 synthetic queries x 100 passages of 128 tokens end to end
   through ``llmrankers_tpu_torch.cli.run.main`` (setwise heapsort,
   likelihood, num_child 2, k 10), counting the kernel's launches;
6. prints a JSON line of the kernels, then ``{"ok": true, "device": ...}``.

Any failed check raises and the exit code is not 0. Without a CUDA GPU it
exits with an error before printing anything. It imports nothing of JAX.
Scratch files go to ``build/chip_smoke/`` in the checkout.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA GPU and none is available")

from llmrankers_tpu.models.config import T5Config  # noqa: E402
from llmrankers_tpu_torch.cli import run as cli_run  # noqa: E402
from llmrankers_tpu_torch.engine.engine import ScoringEngine  # noqa: E402
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmrankers_tpu_torch.models import t5  # noqa: E402
from llmrankers_tpu_torch.ops import _build, flash  # noqa: E402
from llmrankers_tpu_torch.rankers.prompts import setwise_prompt  # noqa: E402
from llmrankers_tpu_torch.rankers.setwise import SetwiseLlmRanker  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")
KERNEL_TOL = 0.05  # bf16 kernel vs plain, max |diff| on rows with a valid key
# Label logits through 24+24 bf16 layers, kernel vs plain attention: each
# layer's attention output may differ by an ulp of bf16 (2^-8 relative), and
# the differences compound through the residual stream; logits are O(1).
LOGIT_TOL = 0.25
# Encoder output, kernel vs plain: ||a - b|| / ||b|| over the valid positions,
# bf16 rounding (2^-8 relative) compounded through 24 layers.
ENC_TOL = 0.05
N_QUERIES, N_DOCS, PASSAGE_TOKENS = 4, 100, 128


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


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1/6] device: {name}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name


def phase_build():
    tic = time.perf_counter()
    _build.load("flash_blhd")
    dt = time.perf_counter() - tic
    regs = [ln.split("Used ")[1].split(",")[0] for ln in
            _build.build_log("flash_blhd").splitlines() if "Used " in ln]
    print(f"[2/6] built flash_blhd.cu with nvcc in {dt:.2f} s "
          f"(ptxas, Dh 128..16: {'; '.join(regs) or 'already built'})")


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

    def err_against(b):  # max |diff| on the rows with a valid key
        want = flash.flash_mha_blhd_plain(q, k, v, H, bias=b, **kw)
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
    blind = [name for name, e in ctl.items() if not e > KERNEL_TOL]
    if blind:
        raise AssertionError(f"gate {KERNEL_TOL} passes a wrong bias {blind}: {ctl}")
    return err, min(ctl.values()), (
        lambda: flash.flash_mha_blhd(q, k, v, H, bias=bias, **kw)), (
        lambda: flash.flash_mha_blhd_plain(q, k, v, H, bias=bias, **kw))


def trained_scale_bias(cfg, gen) -> torch.Tensor:
    """A [buckets, H] rel-pos table at the O(1) scale of a trained flan-t5;
    random init draws it at d_model**-0.5, too small to test the bias."""
    return torch.randn(cfg.relative_attention_num_buckets, cfg.num_heads,
                       generator=gen, device="cuda").bfloat16()


def phase_kernel(cfg):
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = trained_scale_bias(cfg, gen)
    errs, ctls, timed = [], [], None
    for B, Lq, Lk, causal in ((32, 512, 512, False), (32, 512, 640, True),
                              (32, 640, 640, False)):
        err, ctl, run_kernel, run_plain = _attn_case(gen, B, Lq, Lk, causal, table, cfg)
        errs.append(err)
        ctls.append(ctl)
        timed = (run_kernel, run_plain)  # the last case: B 32, L 640
    run_kernel, run_plain = timed
    plain = [_cuda_ms(run_plain)]
    kern = [_cuda_ms(run_kernel), _cuda_ms(run_kernel)]
    plain.append(_cuda_ms(run_plain))
    ms, plain_ms = sum(kern) / 2, sum(plain) / 2
    print(f"[3/6] flash kernel vs plain, bf16, H16 Dh64, rel-pos bias table of std 1: "
          f"max |diff| {', '.join(f'{e:.4g}' for e in errs)} (L512, causal 512x640, "
          f"L640; tol {KERNEL_TOL}); against a wrong bias (none, next head, key or "
          f"row) at least {min(ctls):.4g}, over tol; all-padding rows exactly 0; "
          f"at B32 L640 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, "
          f"mean of 20 after warm-up, two runs each: {kern[0]:.4f}/{kern[1]:.4f} vs "
          f"{plain[0]:.4f}/{plain[1]:.4f})")
    return max(errs), ms, plain_ms


def _passage(i: int, text: str) -> str:
    filler = " it adds words so that the passage fills its tokens" * 4
    return f"{text}{filler} ({i})"


def phase_score_labels(cfg, model):
    tok = ByteTokenizer(cfg.vocab_size)
    engine = ScoringEngine("t5", cfg, model, tok)
    ranker = SetwiseLlmRanker(engine, num_child=2, k=10, scoring="likelihood")
    rows = []
    for i in range(32):
        docs = [tok.truncate(_passage(j, f"this passage talks about topic {j}"),
                             PASSAGE_TOKENS) for j in (3 * i, 3 * i + 1, 3 * i + 2)]
        rows.append(tok.encode(setwise_prompt(f"what is topic {i}", docs)))
    labels, prefix = ranker.label_ids[:3], ranker.decoder_prefix
    logits, wall = {}, {}
    for use_flash in (True, False):
        model.use_flash = use_flash
        engine.score_labels(rows, labels, prefix)  # warm-up
        torch.cuda.synchronize()
        tic = time.perf_counter()
        logits[use_flash] = engine.score_labels(rows, labels, prefix)
        wall[use_flash] = time.perf_counter() - tic
    # The label logits of a random-init model hardly depend on the encoder
    # (without its bias they moved by 0.14, under LOGIT_TOL), so the bias
    # path is held at the encoder output, with a negative control there.
    enc = {f: _encoder_out(engine, rows, f) for f in (True, False)}
    table = model.encoder.rel_bias.clone()
    model.encoder.rel_bias.zero_()
    enc_no_bias = _encoder_out(engine, rows, True)
    model.encoder.rel_bias.copy_(table)
    model.use_flash = True
    enc_err, enc_ctl = (float((x - enc[False]).norm() / enc[False].norm())
                        for x in (enc[True], enc_no_bias))
    if not enc_err <= ENC_TOL:
        raise AssertionError(f"encoder output kernel vs plain: relative error "
                             f"{enc_err} > {ENC_TOL}")
    if not enc_ctl > ENC_TOL:
        raise AssertionError(f"gate {ENC_TOL} passes the encoder without its "
                             f"bias: relative error {enc_ctl}")
    a, b = logits[True], logits[False]
    if a.shape != (32, 3) or not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise AssertionError(f"label logits: shape {a.shape} or not finite")
    diff = float(np.abs(a - b).max())
    top2 = np.sort(b, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL
    agree = (a.argmax(1) == b.argmax(1))
    if not diff <= LOGIT_TOL or not agree[clear].all():
        raise AssertionError(f"label logits kernel vs plain: max |diff| {diff}, "
                             f"winners differ on clear rows {np.where(clear & ~agree)}")
    print(f"[4/6] score_labels, flan-t5-large random init bf16 (encoder rel-pos "
          f"table of std 1), 32 rows x {max(map(len, rows))} tokens (L bucket 640): "
          f"encoder output kernel vs plain relative error {enc_err:.4g} (tol "
          f"{ENC_TOL}), without the bias {enc_ctl:.4g}; label logits kernel vs "
          f"plain max |diff| {diff:.4g} (tol {LOGIT_TOL}); winners agree on "
          f"{int(agree.sum())}/32 rows, {int(clear.sum())} rows with margin > tol "
          f"all agree; wall {wall[True] * 1e3:.1f} ms with kernel, "
          f"{wall[False] * 1e3:.1f} ms plain")


def _encoder_out(engine, rows, use_flash):
    """The encoder's output at the valid positions of the padded rows, fp32."""
    ids, mask, _, _ = engine._pad_batch(rows)
    ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    engine.model.use_flash = use_flash
    with torch.inference_mode():
        return engine.model.encode(ids, mask)[mask.bool()].float()


def _write_inputs():
    os.makedirs(SCRATCH, exist_ok=True)
    paths = {n: os.path.join(SCRATCH, n) for n in ("q.tsv", "c.jsonl", "run.txt", "out.txt")}
    with open(paths["q.tsv"], "w") as f:
        for qi in range(N_QUERIES):
            f.write(f"q{qi}\twhich passage is about the gold topic {qi}\n")
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


def phase_end_to_end():
    paths = _write_inputs()
    args = cli_run.parse_args([
        "run", "--model_name_or_path", "random:t5-large", "--device", "cuda",
        "--dtype", "bfloat16", "--seed", "0",
        "--run_path", paths["run.txt"], "--query_file", paths["q.tsv"],
        "--corpus_file", paths["c.jsonl"], "--save_path", paths["out.txt"],
        "--hits", str(N_DOCS), "--query_length", "32",
        "--passage_length", str(PASSAGE_TOKENS), "--scoring", "likelihood",
        "setwise", "--num_child", "2", "--method", "heapsort", "--k", "10",
    ])
    torch.cuda.reset_peak_memory_stats()
    flash.flash_mha_blhd.launches = 0
    report = cli_run.main(args)
    torch.cuda.synchronize()
    launches = flash.flash_mha_blhd.launches
    if launches == 0:
        raise AssertionError("the main path never launched the flash kernel")
    if launches % T5Config.flan_t5_large().num_layers:
        raise AssertionError(f"{launches} launches is not a whole number of encodes")
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
    print(f"[5/6] end to end, cli.run.main, random:t5-large bf16, setwise heapsort "
          f"likelihood num_child 2 k 10, {N_QUERIES} queries x {N_DOCS} passages of "
          f"{PASSAGE_TOKENS} tokens: rerank wall {wall:.3f} s, "
          f"{N_QUERIES * N_DOCS / wall:.1f} docs/s, {comps} comparisons "
          f"({comps / N_QUERIES:.1f} per query), flash launches {launches}, "
          f"max memory allocated {mem:.2f} GiB")
    return launches


def main():
    name = phase_device()
    phase_build()
    cfg = T5Config.flan_t5_large()
    err, ms, plain_ms = phase_kernel(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = t5.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        model.encoder.rel_bias.copy_(trained_scale_bias(cfg, gen))
    phase_score_labels(cfg, model)
    del model
    torch.cuda.empty_cache()
    launches = phase_end_to_end()
    print(json.dumps({"kernels": [{
        "name": "flash_mha_blhd", "route": "cuda",
        "source": "llmrankers_tpu_torch/csrc/flash_blhd.cu",
        "replaces": "llmrankers_tpu/ops/flash.py:373",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
