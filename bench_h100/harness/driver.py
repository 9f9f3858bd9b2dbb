"""What every traffic driver shares: the program built from the cell's
configuration with the benchmark's weights, one call of the window (a
``rerank_many`` over a fresh seeded batch of queries), the program's
counters, and freeing the program before the reference runs.

A driver module under ``drivers/`` subclasses :class:`Driver` as ``Driver``
and adds its ranker (``make_ranker``), its warm-up, what it records on the
way and the comparison that decides ``correct`` (``check``).
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from llmrankers_tpu_torch.ops import flash, int8_matmul, kvq_attention
from llmrankers_tpu_torch.types import SearchResult

from . import port, traffic, weights
from .cell import Cell
from .trace import Spans

# The port's counts of its own kernel launches (each wrapper's ``launches``).
LAUNCH_COUNTERS = {
    "flash_mha_packed": flash.flash_mha_packed,
    "flash_mha": flash.flash_mha,
    "quantized_matmul": int8_matmul.quantized_matmul,
    "gated_matmul": int8_matmul.gated_matmul,
    "kvq_decode_attention": kvq_attention.kvq_decode_attention,
}
WARM_STREAM = 1  # the traffic stream of warm-up inputs (the window's is 0)


class Driver:
    def __init__(self, cell: Cell, seed: int, device: str = "cuda",
                 control: Optional[Dict] = None):
        """``control``: one of the configuration's ``controls``: its
        ``engine`` options replace the program's, and the driver's check
        reads its other keys."""
        self.cell, self.seed, self.device = cell, int(seed), device
        self.spans = Spans()
        self.control = control or {}
        self.work: List[Dict] = []  # one entry per engine call of the window
        self.recording = False

    # -- the program ------------------------------------------------------
    def tokenizer(self):
        return None  # the engine's default, the byte tokenizer

    def build(self) -> None:
        w = self.reference_weights()
        self.engine = port.engine(self.cell.conf, w, self.tokenizer(), device=self.device,
                                  **self.control.get("engine", {}))
        del w
        self.ranker = self.make_ranker()
        self.instrument()
        self.spans.wrap(self.ranker, "rerank_many", "rerank_many")
        free()

    def make_ranker(self):
        raise NotImplementedError

    def instrument(self) -> None:
        """Wrap the engine calls whose inputs and outputs the driver keeps."""

    def warm_up(self) -> None:
        raise NotImplementedError

    # -- one call of the window ---------------------------------------------
    def inputs(self, index: int, stream: int = 0):
        mix, r = self.cell.mix, self.ranker
        queries, lists = traffic.call_inputs(mix, self.seed, index, stream)
        queries = [r.truncate(q, mix["query_length"]) for q in queries]
        rankings = [[SearchResult(docid=d, score=float(len(docs) - j),
                                  text=r.truncate(t, mix["passage_length"]))
                     for j, (d, t) in enumerate(docs)] for docs in lists]
        return queries, rankings

    def call(self, index: int, stream: int = 0) -> Dict:
        queries, rankings = self.inputs(index, stream)
        cpu, start = time.process_time(), time.perf_counter()
        results = self.ranker.rerank_many(queries, rankings)
        end, cpu = time.perf_counter(), time.process_time() - cpu
        failed = sum(1 for got, want in zip(results, rankings)
                     if sorted(d.docid for d in got) != sorted(d.docid for d in want))
        failed += len(rankings) - len(results)
        s = self.ranker.stats
        return {"start": start, "end": end, "cpu_s": cpu, "queries": len(queries),
                "docs": sum(len(r) for r in rankings), "failed": failed,
                "comparisons": s.comparisons, "prompt_tokens": s.prompt_tokens,
                "completion_tokens": s.completion_tokens}

    def counters(self) -> Dict[str, int]:
        """The program's own counts: its dispatches by program name and its
        kernel wrappers' launches."""
        out = {"program." + k: v for k, v in self.engine.programs.items()}
        out.update({"launches." + k: fn.launches for k, fn in LAUNCH_COUNTERS.items()})
        return out

    # -- after the window ---------------------------------------------------
    def release(self) -> None:
        """Free the program and its state, so the reference has the card."""
        for name in ("ranker", "engine"):
            if hasattr(self, name):
                delattr(self, name)
        free()

    def reference_weights(self) -> Dict[str, torch.Tensor]:
        """The weights both sides get, made from the seed (the program's
        before the window, the reference's again after it)."""
        return weights.make(self.cell.reference().param_specs(self.cell.conf), self.seed,
                            self.device)

    def check(self) -> Dict[str, float]:
        """The numbers compared, by name."""
        raise NotImplementedError


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
