"""Main CLI of the port: rerank a first-stage TREC run on a torch device.

Counterpart of ``llmrankers_tpu/cli/run.py``, with the same flags (its
``parse_args`` and ``load_inputs`` are reused as they are). Usage:

    python -m llmrankers_tpu_torch.cli.run \\
        run --model_name_or_path random:t5-large --device cuda \\
            --run_path run.bm25.txt --query_file queries.tsv \\
            --corpus_file corpus.jsonl --save_path run.setwise.txt \\
            --hits 100 --passage_length 128 --scoring likelihood \\
        setwise --num_child 2 --method heapsort --k 10

``--device`` picks the torch device: ``cuda`` by default, which raises when
no GPU is present; the CPU runs only when asked for with ``--device cpu``.
Models are the ``random:{t5-tiny,t5-large,t5-xl}`` presets (random weights
from ``--seed``); ``--quantize int8`` runs them as W8A8 int8 on the int8
kernels. They tokenize with the byte tokenizer, or with the local
HF tokenizer directory that ``--tokenizer_name_or_path`` names (for example
flan-t5's, for prompts of its real token lengths). Flags of features that
are not ported yet raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import logging
import random
import time

import torch

from llmrankers_tpu.cli.run import load_inputs, parse_args
from llmrankers_tpu.models.config import T5Config

logger = logging.getLogger(__name__)

PRESETS = {
    "t5-tiny": T5Config.tiny,
    "t5-large": T5Config.flan_t5_large,
    "t5-xl": T5Config.flan_t5_xl,
}


def _check_ported(args) -> None:
    """Raise on any flag whose feature the port does not have yet."""
    r = args.run
    unported = [
        (r.openai_key, "--openai_key (API rankers)", "A6"),
        (r.kv_quantize, "--kv_quantize", "A8"),
        (r.awq_calib_file, "--awq_calib_file", "A9"),
        (r.spec_lookup, "--spec_lookup", "A8"),
        (r.lora_path_or_name, "--lora_path_or_name", "A10"),
        (r.prompt_file, "--prompt_file (Rank-R1)", "A8"),
        (r.tensor_parallel > 1 or r.data_parallel > 1,
         "--tensor_parallel/--data_parallel", "A13"),
        (r.cohorts > 1, "--cohorts", "A15"),
        (r.profile_dir, "--profile_dir", "A14"),
        (args.pointwise or args.pairwise or args.listwise,
         "pointwise/pairwise/listwise", "A6"),
    ]
    if args.setwise:
        unported += [
            (args.setwise.prompt_file, "setwise --prompt_file (Rank-R1)", "A8"),
            (args.setwise.lora_name_or_path, "setwise --lora_name_or_path", "A10"),
        ]
    for value, flag, item in unported:
        if value:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP {item})")


def resolve_device(name) -> torch.device:
    """``--device``: ``cuda`` unless another device is named; a missing GPU
    raises instead of falling back to the CPU."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return device


def make_engine(run_args):
    """A ScoringEngine on ``--device`` for a ``random:`` preset."""
    from ..engine.engine import ScoringEngine
    from ..engine.tokenizer import ByteTokenizer, HFTokenizer
    from ..models import t5 as t5_mod

    device = resolve_device(run_args.device)
    name = run_args.model_name_or_path or ""
    if not name.startswith("random:"):
        raise NotImplementedError(
            "loading checkpoints is not ported yet (ROADMAP A15); use a "
            f"random:{{{','.join(PRESETS)}}} preset")
    preset = name.split(":", 1)[1]
    if preset not in PRESETS:
        raise ValueError(f"unknown random preset {preset!r}")
    cfg = PRESETS[preset]()
    if run_args.tokenizer_name_or_path:
        tok = HFTokenizer(run_args.tokenizer_name_or_path)
        if tok.vocab_size > cfg.vocab_size:
            raise ValueError(f"tokenizer has {tok.vocab_size} tokens, the "
                             f"{preset} vocabulary {cfg.vocab_size}")
    else:
        tok = ByteTokenizer(cfg.vocab_size)
    dtype = torch.bfloat16 if run_args.dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(run_args.seed)
    model = t5_mod.init_params(cfg, gen, dtype=dtype, device=device)
    extra = {}
    if run_args.len_buckets is not None:
        extra["len_buckets"] = run_args.len_buckets
    if run_args.max_batch_tokens is not None:
        extra["max_batch_tokens"] = run_args.max_batch_tokens
    return ScoringEngine("t5", cfg, model, tok, device=device,
                         quantize=run_args.quantize, **extra)


def make_ranker(args, engine):
    from ..rankers.setwise import SetwiseLlmRanker

    if not args.setwise:
        raise NotImplementedError(
            "only the setwise ranker is ported (ROADMAP A6 ports the others)")
    return SetwiseLlmRanker(
        engine,
        num_child=args.setwise.num_child,
        k=args.setwise.k,
        scoring=args.run.scoring,
        method=args.setwise.method,
        num_permutation=args.setwise.num_permutation,
        seed=args.run.seed,
        spec_depth=args.setwise.speculative_depth,
        cache_comparisons=args.setwise.cache_comparisons,
    )


def main(args):
    """Rerank, stream each query's result to ``--save_path``, print the
    reference's four meters; returns the MeterReport."""
    from llmrankers_tpu.data.trec import RunWriter
    from llmrankers_tpu.utils.metering import EventLog, MeterReport

    _check_ported(args)
    rng = random.Random(args.run.seed)
    engine = make_engine(args.run)
    ranker = make_ranker(args, engine)
    first_stage = load_inputs(args, ranker)
    logger.info("reranking %d queries", len(first_stage))

    for _, _, ranking in first_stage:
        if args.run.shuffle_ranking == "random":
            rng.shuffle(ranking)
        elif args.run.shuffle_ranking == "inverse":
            ranking.reverse()
        elif args.run.shuffle_ranking is not None:
            raise ValueError(f"Invalid shuffle: {args.run.shuffle_ranking}")

    report = MeterReport()
    log = EventLog(args.run.event_log)
    tic = time.time()
    with RunWriter(args.run.save_path, "LLMRankers", append=args.run.resume) as w:
        def on_result(i, ranking):
            qid = first_stage[i][0]
            w.write_query(qid, ranking)
            log.emit("query_done", qid=qid)

        ranker.rerank_many([q for _, q, _ in first_stage],
                           [r for _, _, r in first_stage], on_result=on_result)
        report.wall_s = time.time() - tic
        for stats in ranker.per_query_stats:
            report.add_query(stats)
        report.truncated_rows = engine.truncated_rows
    report.print_summary()
    log.emit("run_done", **report.summary())
    log.close()
    return report


def cli_main() -> None:
    args = parse_args()
    if args.run is None:
        raise SystemExit("need the `run` section (see --help)")
    if args.run.ir_dataset_name and args.run.pyserini_index:
        raise SystemExit("--ir_dataset_name and --pyserini_index are exclusive")
    main(args)


if __name__ == "__main__":
    cli_main()
