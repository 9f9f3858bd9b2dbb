"""Main CLI of the port: rerank a first-stage TREC run on a torch device.

Counterpart of ``llmrankers_tpu/cli/run.py``, with the same flags: its
``build_parsers``, ``parse_args`` and ``load_inputs`` are copied here as they
are. Usage:

    python -m llmrankers_tpu_torch.cli.run \\
        run --model_name_or_path random:t5-large --device cuda \\
            --run_path run.bm25.txt --query_file queries.tsv \\
            --corpus_file corpus.jsonl --save_path run.setwise.txt \\
            --hits 100 --passage_length 128 --scoring likelihood \\
        setwise --num_child 2 --method heapsort --k 10

``--device`` picks the torch device: ``cuda`` by default, which raises when
no GPU is present; the CPU runs only when asked for with ``--device cpu``.
Models are the ``random:{t5-tiny,t5-large,t5-xl,dec-tiny,mistral-tiny,qwen2.5-3b}``
presets (random weights from ``--seed``; ``mistral-tiny`` is ``dec-tiny``
with a sliding window of 64); ``--quantize int8`` runs the T5 presets as
W8A8 int8 on the int8 kernels, and ``--quantize int8|int4`` the decoder
presets with int8 or mixed int4/int8 weights (the kernels take the sites
whose widths are multiples of 128; the 64-wide presets reach none). They
tokenize with the byte tokenizer, or
with the local HF tokenizer directory that ``--tokenizer_name_or_path``
names (for example flan-t5's, for prompts of its real token lengths).
``--prefix_cache_mb`` sizes the decoder engine's cross-wave prefix-KV cache.
On the decoder presets ``--scoring generation`` decodes one token per
comparison, ``--kv_quantize int8|int4`` quantizes the generation KV cache
(its decode attention runs the hand-written kernel on the card), and
``--prompt_file`` (in the run or the setwise section) runs the Rank-R1
setwise ranker with that TOML prompt pack and ``--max_completion_tokens``.
``--profile_dir`` writes a ``torch.profiler`` Chrome trace of the rerank, the
port's spans above its operators; with ``--event_log`` the ``run_done`` event
carries each span name's count and seconds and the engine's ``pad_stats``,
``graph_stats`` and ``wave_stats``.
Flags of features that are not ported yet raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import random
import sys
import time
from typing import List, Optional

import torch

from ..models.config import DecoderConfig, T5Config
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

PRESETS = {
    "t5-tiny": T5Config.tiny,
    "t5-large": T5Config.flan_t5_large,
    "t5-xl": T5Config.flan_t5_xl,
    "dec-tiny": DecoderConfig.tiny,
    "qwen2.5-3b": DecoderConfig.qwen25_3b,
    # Sliding-window smoke config (Mistral v0.1-style attention).
    "mistral-tiny": lambda: dataclasses.replace(DecoderConfig.tiny(), sliding_window=64),
}


def _bucket_list(text: str):
    """Sorted positive-int ladder; engine._bucket takes the FIRST entry
    >= n, so an unsorted ladder would silently over-pad. "auto" /
    "auto:K" pass through (DP re-planned ladder, utils/bucketplan.py)."""
    if text == "auto" or text.startswith("auto:"):
        if ":" in text:
            try:
                if int(text.split(":", 1)[1]) < 1:
                    raise ValueError
            except ValueError:
                raise argparse.ArgumentTypeError(
                    "auto:K needs a positive int K")
        return text
    try:
        vals = sorted({int(x) for x in text.split(",") if x.strip()})
    except ValueError:
        raise argparse.ArgumentTypeError(f"not a comma-list of ints: {text!r}")
    if not vals or vals[0] < 1:
        raise argparse.ArgumentTypeError("len_buckets need positive ints")
    return tuple(vals)


def _positive_int(text: str) -> int:
    v = int(text)
    if v < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return v


def build_parsers():
    parser = argparse.ArgumentParser(prog="llmrankers_tpu")
    commands = parser.add_subparsers(title="sub-commands")

    run_p = commands.add_parser("run")
    run_p.add_argument("--run_path", type=str, required=False)
    run_p.add_argument("--save_path", type=str, required=False)
    run_p.add_argument("--model_name_or_path", type=str)
    run_p.add_argument("--tokenizer_name_or_path", type=str, default=None)
    run_p.add_argument("--ir_dataset_name", type=str, default=None)
    run_p.add_argument("--pyserini_index", type=str, default=None)
    run_p.add_argument("--pyserini_dataset", type=str, default=None,
                       help="pyserini topics name for queries, e.g. "
                            "dl19-passage (run_setwise.py:262-263; "
                            "--pyserini_index alone appends '-test')")
    run_p.add_argument("--lora_path_or_name", type=str, default=None,
                       help="PEFT adapter dir merged into the model "
                            "(run_setwise.py:341; also accepted as "
                            "setwise --lora_name_or_path)")
    run_p.add_argument("--prompt_file", type=str, default=None,
                       help="TOML prompt pack (run-section placement "
                            "matches run_setwise.py:336; equivalent to "
                            "the method-section --prompt_file)")
    run_p.add_argument("--query_file", type=str, default=None,
                       help=".tsv or .jsonl query file (run_setwise.py:247-261)")
    run_p.add_argument("--corpus_file", type=str, default=None,
                       help=".jsonl corpus (id/title/text) used as docstore")
    run_p.add_argument("--hits", type=int, default=100)
    run_p.add_argument("--query_length", type=int, default=128)
    run_p.add_argument("--passage_length", type=int, default=128)
    run_p.add_argument("--device", type=str, default=None)  # parity no-op
    run_p.add_argument("--cache_dir", type=str, default=None)
    run_p.add_argument("--openai_key", type=str, default=None)
    run_p.add_argument("--api_base_url", type=str, default=None)
    run_p.add_argument("--scoring", type=str, default="generation",
                       choices=["generation", "likelihood"])
    run_p.add_argument("--shuffle_ranking", type=str, default=None,
                       choices=["inverse", "random"])
    run_p.add_argument("--dataset_number_of_shards", type=int, default=1)
    run_p.add_argument("--dataset_shard_index", type=int, default=0)
    run_p.add_argument("--resume", action="store_true",
                       help="skip qids already in save_path; append")
    run_p.add_argument("--tensor_parallel", type=int, default=1)
    run_p.add_argument("--data_parallel", type=int, default=1)
    run_p.add_argument("--dtype", type=str, default="bfloat16",
                       choices=["bfloat16", "float32"])
    run_p.add_argument("--quantize", type=str, default=None,
                       choices=["int8", "int4"],
                       help="weight quantization. int8 decoder: weight-only "
                            "W8A16 (halves weight HBM; ~2x decode throughput "
                            "at serving batch sizes). int8 T5: W8A8 via "
                            "the Pallas int8-MXU kernel on single-chip TPU "
                            "(the compute-bound scoring path runs on the "
                            "2x-peak int8 systolic path). int4: decoder-only "
                            "group-wise W4A8 Pallas kernel (quarter weight "
                            "HBM; ~2x the int8 decode ceiling; expect some "
                            "accuracy loss — validate on your task)")
    run_p.add_argument("--awq_calib_file", type=str, default=None,
                       help="AWQ-style activation-aware calibration for "
                            "--quantize on decoder models: a text file of "
                            "calibration prompts (one per line, in-domain "
                            "ranking prompts work best); per-(layer, site) "
                            "scales fitted on them are folded into the "
                            "weights before quantization (models/awq.py; "
                            "the vLLM '*-AWQ' checkpoint equivalent, "
                            "calibrated in-framework)")
    run_p.add_argument("--max_cached_adapters", type=int, default=1,
                       help="merged LoRA weight copies kept on device; "
                            "raise to the serving working set when "
                            "alternating adapters (each copy costs a full "
                            "model's HBM)")
    run_p.add_argument("--kv_quantize", type=str, default=None,
                       choices=["int8", "int4"],
                       help="quantized KV cache for decoder models: int8 "
                            "halves the cache HBM stream during decode and "
                            "doubles rows-per-chip under the memory cap; "
                            "int4 (planar nibble packing, per-half scales) "
                            "halves the cache FOOTPRINT again vs int8 "
                            "(more rows-per-chip) — its decode stream "
                            "matches int8's (docs/ARCHITECTURE.md)")
    run_p.add_argument("--prefix_cache_mb", type=int, default=256,
                       help="cross-wave prefix-KV cache budget (decoder "
                            "models): unique prompt prefixes' K/V kept on "
                            "device across dispatches, so a sort's "
                            "successive waves skip the query-head prefill "
                            "(vLLM cross-request prefix caching). 0 "
                            "disables")
    run_p.add_argument("--spec_lookup", type=int, default=0,
                       help="K>0: prompt-lookup speculative decoding with "
                            "K-token drafts (decoder generation; outputs "
                            "identical to plain greedy — vLLM ngram-spec "
                            "parity). Pays off when completions quote the "
                            "prompt, e.g. Rank-R1 reasoning")
    run_p.add_argument("--event_log", type=str, default=None)
    run_p.add_argument("--profile_dir", type=str, default=None,
                       help="write a torch.profiler Chrome trace of the rerank here")
    run_p.add_argument("--seed", type=int, default=929)
    run_p.add_argument("--len_buckets", type=_bucket_list, default=None,
                       help="comma-separated padded-length ladder, e.g. "
                            "'512,640,1024' (default: the engine's "
                            "general-purpose ladder). Fewer buckets = "
                            "fewer compiles; tighter buckets = less "
                            "padding waste. 'auto' (or 'auto:K') starts "
                            "on the default ladder and swaps in a "
                            "DP-optimal K-rung ladder planned from the "
                            "first ~4k observed row lengths")
    run_p.add_argument("--max_batch_tokens", type=_positive_int,
                       default=None,
                       help="per-dispatch token budget B*L (default 2^17); "
                            "lower to bound activation memory, raise for "
                            "throughput on small models")
    run_p.add_argument("--cohorts", type=int, default=1,
                       help="parallel rerank cohorts sharing the engine "
                            "(2 overlaps host work with device compute)")
    run_p.add_argument("--verbose", action="store_true",
                       help="log completions (Rank-R1 paths; the reference's "
                            "commented-out write_log_file, run_setwise.py:26-29)")

    pw = commands.add_parser("pointwise")
    pw.add_argument("--method", type=str, default="yes_no", choices=["qlm", "yes_no"])
    pw.add_argument("--batch_size", type=int, default=2)

    _cache_help = ("memoize repeated comparisons (arXiv:2505.24643): "
                   "identical ranking, fewer LLM calls; requires "
                   "deterministic scoring (num_permutation == 1)")
    pr = commands.add_parser("pairwise")
    pr.add_argument("--method", type=str, default="allpair",
                    choices=["allpair", "heapsort", "bubblesort"])
    pr.add_argument("--batch_size", type=int, default=2)
    pr.add_argument("--k", type=int, default=10)
    pr.add_argument("--cache_comparisons", action="store_true", help=_cache_help)

    sw = commands.add_parser("setwise")
    sw.add_argument("--num_child", type=int, default=3)
    sw.add_argument("--method", type=str, default="heapsort",
                    choices=["heapsort", "bubblesort", "insertion"])
    sw.add_argument("--k", type=int, default=10)
    sw.add_argument("--num_permutation", type=int, default=1)
    sw.add_argument("--speculative_depth", type=int, default=1,
                    help="heap-pop speculation depth (>1 batches the "
                         "descent subtree into one wave; identical "
                         "results for stateless comparisons, lower "
                         "latency, more comparisons; incompatible with "
                         "num_permutation>1 generation scoring)")
    sw.add_argument("--prompt_file", type=str, default=None,
                    help="TOML prompt pack -> Rank-R1 reasoning ranker")
    sw.add_argument("--lora_name_or_path", type=str, default=None)
    sw.add_argument("--max_completion_tokens", type=int, default=2048)
    sw.add_argument("--cache_comparisons", action="store_true", help=_cache_help)

    lw = commands.add_parser("listwise")
    lw.add_argument("--window_size", type=int, default=3)
    lw.add_argument("--step_size", type=int, default=1)
    lw.add_argument("--num_repeat", type=int, default=1)
    lw.add_argument("--prompt_file", type=str, default=None)
    lw.add_argument("--method", type=str, default="sliding",
                    choices=["sliding", "topdown"],
                    help="'sliding' = reference bottom-up window walk; "
                         "'topdown' = parallel pivot partitioning "
                         "(arXiv:2405.14589) — every level is one wave")
    lw.add_argument("--k", type=int, default=10,
                    help="topdown pivot rank (unused by sliding)")
    lw.add_argument("--cache_comparisons", action="store_true", help=_cache_help)

    return parser, commands


def parse_args(argv: Optional[List[str]] = None):
    """Two-level parse: split argv at sub-command names (the reference's
    custom splitter behavior, run.py:20-38)."""
    parser, commands = build_parsers()
    argv = list(sys.argv[1:] if argv is None else argv)
    sections: List[List[str]] = [[]]
    for tok in argv:
        if tok in commands.choices:
            sections.append([tok])
        else:
            sections[-1].append(tok)
    args = argparse.Namespace()
    for name in commands.choices:
        setattr(args, name, None)
    parser.parse_args(sections[0], namespace=args)
    for sec in sections[1:]:
        ns = argparse.Namespace()
        parser.parse_args(sec, namespace=ns)
        setattr(args, sec[0], ns)
    return args


def _check_ported(args) -> None:
    """Raise on any flag whose feature the port does not have yet."""
    r = args.run
    unported = [
        (r.openai_key, "--openai_key (API rankers)", "A6"),
        (r.awq_calib_file, "--awq_calib_file", "A9 (AWQ)"),
        (r.lora_path_or_name, "--lora_path_or_name", "A10"),
        (r.tensor_parallel > 1 or r.data_parallel > 1,
         "--tensor_parallel/--data_parallel", "A13"),
        (r.cohorts > 1, "--cohorts", "A15"),
        (args.pointwise or args.pairwise or args.listwise,
         "pointwise/pairwise/listwise", "A6"),
    ]
    if args.setwise:
        unported += [
            (args.setwise.lora_name_or_path, "setwise --lora_name_or_path", "A10"),
        ]
    for value, flag, item in unported:
        if value:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP {item})")


def make_engine(run_args):
    """A ScoringEngine on ``--device`` for a ``random:`` preset."""
    from ..engine.engine import ScoringEngine
    from ..engine.tokenizer import ByteTokenizer, HFTokenizer
    from ..models import decoder as dec_mod
    from ..models import t5 as t5_mod

    device = resolve_device(run_args.device, cpu_hint="pass --device cpu")
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
    kind = "t5" if isinstance(cfg, T5Config) else "decoder"
    mod = t5_mod if kind == "t5" else dec_mod
    model = mod.init_params(cfg, gen, dtype=dtype, device=device)
    extra = {}
    if run_args.len_buckets is not None:
        extra["len_buckets"] = run_args.len_buckets
    if run_args.max_batch_tokens is not None:
        extra["max_batch_tokens"] = run_args.max_batch_tokens
    return ScoringEngine(kind, cfg, model, tok, device=device,
                         quantize=run_args.quantize, kv_quantize=run_args.kv_quantize,
                         spec_lookup=run_args.spec_lookup,
                         prefix_cache_mb=run_args.prefix_cache_mb, **extra)


def make_ranker(args, engine):
    from ..rankers.setwise import SetwiseLlmRanker

    if not args.setwise:
        raise NotImplementedError(
            "only the setwise ranker is ported (ROADMAP A6 ports the others)")
    sw_prompt = args.setwise.prompt_file or args.run.prompt_file
    if sw_prompt:
        from ..rankers.rank_r1 import RankR1SetwiseLlmRanker

        return RankR1SetwiseLlmRanker(
            engine,
            prompt_file=sw_prompt,
            num_child=args.setwise.num_child,
            k=args.setwise.k,
            method=args.setwise.method,
            num_permutation=args.setwise.num_permutation,
            max_completion_tokens=args.setwise.max_completion_tokens,
            verbose=args.run.verbose,
            spec_depth=args.setwise.speculative_depth,
            cache_comparisons=args.setwise.cache_comparisons,
        )
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


def load_inputs(args, ranker):
    """Queries + first-stage rankings with reference truncation rules."""
    from ..data import docstore as ds_mod
    from ..data import trec
    from ..types import SearchResult

    r = args.run
    # -- queries ----------------------------------------------------------
    if r.query_file:
        query_map = ds_mod.load_queries(r.query_file)
    elif r.ir_dataset_name:
        query_map = ds_mod.load_queries_ir_datasets(r.ir_dataset_name)
    elif r.pyserini_dataset:
        query_map = ds_mod.load_queries_pyserini_topics(
            r.pyserini_dataset, exact=True
        )
    elif r.pyserini_index:
        query_map = ds_mod.load_queries_pyserini_topics(r.pyserini_index)
    else:
        raise ValueError("need --query_file, --ir_dataset_name, "
                         "--pyserini_dataset or --pyserini_index")
    query_map = {
        qid: ranker.truncate(text, r.query_length) for qid, text in query_map.items()
    }

    # -- docstore ---------------------------------------------------------
    if r.corpus_file:
        # Large corpora (full MS MARCO / BRIGHT) switch to the native
        # offset-indexed store automatically; small files load in memory.
        store = ds_mod.open_jsonl_docstore(r.corpus_file)
    elif r.ir_dataset_name:
        store = ds_mod.IrDatasetsDocstore(r.ir_dataset_name)
    elif r.pyserini_index:
        store = ds_mod.PyseriniDocstore(r.pyserini_index)
    else:
        raise ValueError("need a docstore source")

    groups = trec.read_run(r.run_path, hits=r.hits)
    groups = trec.split_into_shards(
        groups, r.dataset_number_of_shards, r.dataset_shard_index
    )
    done = trec.read_done_qids(r.save_path) if r.resume else set()

    first_stage = []
    for qid, pairs in groups:
        if qid in done:
            continue
        if qid not in query_map:
            raise KeyError(
                f"run file qid {qid!r} not found in the query source "
                f"({len(query_map)} queries loaded)"
            )
        ranking = [
            SearchResult(
                docid=d, score=s,
                text=ranker.truncate(store.get_text(d), r.passage_length),
            )
            for d, s in pairs
        ]
        first_stage.append((qid, query_map[qid], ranking))
    return first_stage


def main(args):
    """Rerank, stream each query's result to ``--save_path``, print the
    reference's four meters; returns the MeterReport."""
    from ..data.trec import RunWriter
    from ..utils import metering
    from ..utils.metering import EventLog, MeterReport
    from ..utils.profiling import trace

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
    if args.run.event_log:
        metering.enable()  # run_done carries the spans' totals
    tic = time.time()
    with RunWriter(args.run.save_path, "LLMRankers", append=args.run.resume) as w:
        def on_result(i, ranking):
            qid = first_stage[i][0]
            w.write_query(qid, ranking)
            log.emit("query_done", qid=qid)

        with trace(args.run.profile_dir):
            ranker.rerank_many([q for _, q, _ in first_stage],
                               [r for _, _, r in first_stage], on_result=on_result)
        report.wall_s = time.time() - tic
        for stats in ranker.per_query_stats:
            report.add_query(stats)
        report.truncated_rows = engine.truncated_rows
    report.print_summary()
    spans = {}
    if args.run.event_log:
        metering.disable()
        for name, t0, t1, *_ in metering.take():
            total = spans.setdefault(name, {"count": 0, "seconds": 0.0})
            total["count"] += 1
            total["seconds"] += t1 - t0
    log.emit("run_done", **report.summary(), spans=spans, pad_stats=dict(engine.pad_stats),
             graph_stats=dict(engine.graph_stats), wave_stats=dict(engine.wave_stats))
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
