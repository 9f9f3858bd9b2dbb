"""Batched scoring engine: counterpart of ``llmrankers_tpu/engine/engine.py``.

The rankers call the engine through a small interface: ``kind``, ``cfg``,
``tokenizer``, ``score_labels`` and ``truncated_rows``. The host logic is the
JAX engine's, line for line, so the port's batches match it row for row:
token rows are padded into (batch, length) buckets from the same ladders, and
waves whose B*L exceeds ``max_batch_tokens`` are split at batch-bucket rungs.
The device half runs eagerly under ``torch.inference_mode()``.

Only ``kind="t5"`` and ``score_labels`` are ported, in the model's dtype or
with ``quantize="int8"``: W8A8 weights packed per ``models.quant.T5_PACKS``,
with every large-M site on the int8 kernels (their plain versions on the CPU),
the same route on every device. The rest of the JAX engine raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llmrankers_tpu.models.config import T5Config
from llmrankers_tpu.utils import native

from ..models.quant import quantize_t5_params
from ..models.t5 import T5
from .tokenizer import Tokenizer

# The JAX engine's ladders (tuned on TPU v5e), kept so the port's batches
# compare row for row with the reference; retuning them for the H100 is later
# work.
DEFAULT_LEN_BUCKETS = (64, 128, 256, 384, 512, 640, 768, 1024, 1536, 2048, 4096)
DEFAULT_BATCH_BUCKETS = (8, 32, 64, 128, 256, 512)


def _bucket(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder entry >= n; beyond the top, the next multiple of 512
    (clamping would silently truncate rows)."""
    for b in ladder:
        if n <= b:
            return b
    return -(-n // 512) * 512


class ScoringEngine:
    """One T5 model + tokenizer on one torch device."""

    def __init__(
        self,
        kind: str,  # 't5' ('decoder' is not ported yet)
        cfg: T5Config,
        model: T5,
        tokenizer: Tokenizer,
        device: Optional[Any] = None,  # default: the model's device
        len_buckets: Sequence[int] = DEFAULT_LEN_BUCKETS,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        max_batch_tokens: int = 2**17,
        quantize: Optional[str] = None,  # None | 'int8' (weights)
    ):
        if kind != "t5":
            raise NotImplementedError(
                f"kind={kind!r}: decoder-only models are not ported yet "
                "(ROADMAP A7)")
        if isinstance(len_buckets, str):
            raise NotImplementedError(
                "len_buckets 'auto' is not ported yet (ROADMAP A15)")
        if model.cfg != cfg:
            raise ValueError("cfg differs from the model's config")
        if quantize is not None:
            # The JAX engine's errors (engine.py:155-162).
            if quantize not in ("int8", "int4"):
                raise ValueError(f"unknown quantize mode {quantize!r}")
            if quantize == "int4":
                raise ValueError(
                    "quantize='int4' targets decoder models (T5 scoring"
                    " is compute-bound on the int8 MXU — use 'int8')"
                )
            # T5 scoring is compute-bound: int8 weights AND the W8A8
            # kernels at every site with M = B*L >= 1024 (t5._mm dispatch).
            model = quantize_t5_params(model, pack=True)
        self.kind = kind
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = (torch.device(device) if device is not None
                       else model.shared.device)
        self.model = model.to(self.device)
        self.len_buckets = tuple(len_buckets)
        self.batch_buckets = tuple(batch_buckets)
        self.max_batch_tokens = max_batch_tokens
        # Rows whose real tokens were cut to the model context. T5's
        # relative-position buckets saturate, so T5 rows are never cut.
        self.truncated_rows = 0

    # ------------------------------------------------------------------
    # Host-side padding and chunking (JAX engine: _pad_batch, _chunks)
    # ------------------------------------------------------------------
    def _pad_batch(self, rows: List[List[int]]) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """Right-pad token rows into a (batch, length) bucket."""
        n = len(rows)
        max_len = max((len(r) for r in rows), default=1)
        L = _bucket(max_len, self.len_buckets)
        B = _bucket(n, self.batch_buckets)
        ids, mask = native.pack_padded(rows, B, L, self.tokenizer.pad_id, False)
        return ids, mask, n, B

    def _chunks(self, rows: List[List[int]]):
        """Split a wave so B*L stays under max_batch_tokens, each full chunk
        landing on a batch-bucket rung (no systematic row padding)."""
        if not rows:
            return
        L = _bucket(max(len(r) for r in rows), self.len_buckets)
        per = max(1, self.max_batch_tokens // L)
        fitting = [b for b in self.batch_buckets if b <= per]
        if fitting:
            per = max(fitting)
        for i in range(0, len(rows), per):
            yield i, rows[i: i + per]

    # ------------------------------------------------------------------
    # score_labels: one forward, label-token logits
    # ------------------------------------------------------------------
    def _t5_labels(self, ids: np.ndarray, mask: np.ndarray, labels: torch.Tensor,
                   prefix: Tuple[int, ...]) -> torch.Tensor:
        """The JAX engine's ``t5_labels`` program: encode, decode the forced
        prefix, label logits at its last position, fp32 [B, K]."""
        ids_t = torch.from_numpy(ids).to(self.device)
        mask_t = torch.from_numpy(mask).to(self.device)
        pref = torch.tensor(prefix, device=self.device).expand(ids.shape[0], -1)
        enc_out = self.model.encode(ids_t, mask_t)
        hidden = self.model.decode_hidden(pref, enc_out, mask_t)
        return self.model.label_logits(hidden[:, -1, :], labels).float()

    def score_labels(
        self,
        prompt_rows: List[List[int]],
        label_ids: Sequence[int],
        decoder_prefix: Sequence[int] = (),
        adapter: Optional[str] = None,
    ) -> np.ndarray:
        """[N, K] fp32 logits of each label token at the first free decoder
        position (after the forced prefix; an empty prefix means the
        decoder start token)."""
        if adapter is not None:
            raise NotImplementedError("LoRA adapters are not ported yet (ROADMAP A10)")
        out = np.zeros((len(prompt_rows), len(label_ids)), np.float32)
        labels = torch.tensor([int(x) for x in label_ids], device=self.device)
        prefix = tuple(int(x) for x in decoder_prefix) or (
            int(self.cfg.decoder_start_token_id),)
        # Enqueue every chunk before reading any back, so host padding of
        # chunk i+1 overlaps device compute of chunk i.
        pending = []
        with torch.inference_mode():
            for off, chunk in self._chunks(prompt_rows):
                ids, mask, n, _ = self._pad_batch(chunk)
                pending.append((off, n, self._t5_labels(ids, mask, labels, prefix)))
            for off, n, res in pending:
                out[off: off + n] = res[:n].cpu().numpy()
        return out

    # ------------------------------------------------------------------
    # Not ported yet
    # ------------------------------------------------------------------
    def sequence_nll(self, *args, **kwargs):
        raise NotImplementedError("sequence_nll is not ported yet (ROADMAP A6)")

    def generate(self, *args, **kwargs):
        raise NotImplementedError("generate is not ported yet (ROADMAP A6)")

    def add_adapter(self, *args, **kwargs):
        raise NotImplementedError("LoRA adapters are not ported yet (ROADMAP A10)")
