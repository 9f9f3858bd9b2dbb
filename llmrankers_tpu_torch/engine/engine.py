"""Batched scoring engine: counterpart of ``llmrankers_tpu/engine/engine.py``.

The rankers call the engine through a small interface: ``kind``, ``cfg``,
``tokenizer``, ``score_labels``, ``generate`` and ``truncated_rows``. The host
logic is the JAX engine's, line for line, so the port's batches match it row for row:
token rows are padded into (batch, length) buckets from the same ladders, and
waves whose B*L exceeds ``max_batch_tokens`` are split at batch-bucket rungs.
The device half runs eagerly under ``torch.inference_mode()``; each dispatch
is one of the JAX engine's programs, and ``programs`` counts them by the JAX
program name.

``score_labels`` is ported for both kinds:

- ``kind="t5"`` (program ``t5_labels``), in the model's dtype or with
  ``quantize="int8"``: W8A8 weights packed per ``models.quant.T5_PACKS``,
  every large-M site on the int8 kernels (their plain versions on the CPU).
- ``kind="decoder"``, in the model's dtype or with ``quantize="int8"``
  (int8 weights and head, W8A8 kernels at the large-M sites) or ``"int4"``
  (group-wise int4 FFN on the W4A8 kernel, int8 elsewhere); the engine sets
  ``int8_kernel`` or ``int4_kernel`` on the config as the JAX engine does
  where its kernels run, so every kernel site launches its kernel on the
  card and its plain version on the CPU. Left-padded rows (``dec_labels``),
  or, when prompts of
  a chunk share a long prefix (``engine/prefix.py``), the unique prefixes run
  once and every row gathers its group's K/V (``dec_labels_shared``). With
  ``prefix_cache_mb`` > 0 the prefix K/V is kept across calls in an LRU
  cache under a byte budget: missing prefixes run in one ``prefix_kv``
  dispatch, and the rows run on the cached K/V (``dec_labels_pre``). Flash
  is on when the device is CUDA; rows are cut to the model context.

``generate`` is ported for the decoder kind: greedy or sampled decoding on a
KV cache in the model's dtype or quantized (``kv_quantize="int8"`` or
``"int4"``; over a quantized cache every decode step's attention runs the
hand-written kernel on the card). A wave is split into dispatches of at most
the rows whose caches fit (``_gen_row_limit``, halved and remembered on a
device OOM); each dispatch prefills its rows, left-padded (``dec_prefill``)
or on shared prefixes (``dec_prefill_shared``, or ``dec_prefill_pre`` on the
prefix-KV cache), and decodes in one go (``dec_gen*``) or in chunks
(``dec_chunk``) with a host check for stop strings between chunks. Slot
refill and speculative decoding are not ported (ROADMAP A8(b)): where the JAX
engine would refill slots, the port runs the dispatches one after another.

The rest of the JAX engine raises ``NotImplementedError`` naming the ROADMAP
item that ports it. The host modules come from the port's own copies
(``utils/native.py``, ``engine/prefix.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.config import DecoderConfig, T5Config
from ..models.decoder import Decoder
from ..models.quant import (quantize_decoder_params, quantize_decoder_params_int4,
                            quantize_t5_params)
from ..models.t5 import T5
from ..utils import native
from . import generate as gen_mod
from . import prefix as prefix_mod
from .tokenizer import Tokenizer

logger = logging.getLogger(__name__)

# The JAX engine's ladders (tuned on TPU v5e), kept so the port's batches
# compare row for row with the reference; retuning them for the H100 is later
# work.
DEFAULT_LEN_BUCKETS = (64, 128, 256, 384, 512, 640, 768, 1024, 1536, 2048, 4096)
DEFAULT_BATCH_BUCKETS = (8, 32, 64, 128, 256, 512)


def _is_oom(e: BaseException) -> bool:
    """True for device memory exhaustion."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


def _bucket(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder entry >= n; beyond the top, the next multiple of 512
    (clamping would silently truncate rows)."""
    for b in ladder:
        if n <= b:
            return b
    return -(-n // 512) * 512


class ScoringEngine:
    """One T5 or decoder-only model + tokenizer on one torch device."""

    def __init__(
        self,
        kind: str,  # 't5' | 'decoder'
        cfg: Any,  # T5Config | DecoderConfig
        model: Any,  # T5 | Decoder
        tokenizer: Tokenizer,
        device: Optional[Any] = None,  # default: the model's device
        len_buckets: Sequence[int] = DEFAULT_LEN_BUCKETS,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        max_batch_tokens: int = 2**17,
        quantize: Optional[str] = None,  # None | 'int8' | 'int4' (weights)
        kv_quantize: Optional[str] = None,  # None | 'int8' | 'int4' (decoder KV)
        spec_lookup: int = 0,  # not ported (speculative decoding)
        prefix_share: bool = True,  # share prompt-prefix KV (decoder kind)
        # Cross-wave prefix-KV cache budget (decoder kind): unique prompt
        # prefixes' per-layer K/V kept on device across calls, so a sort's
        # successive waves skip the prefix forward. 0 disables.
        prefix_cache_mb: int = 256,
        awq_calib: Optional[Sequence[str]] = None,  # not ported (AWQ)
    ):
        types = {"t5": (T5Config, T5), "decoder": (DecoderConfig, Decoder)}
        if kind not in types:
            raise ValueError(f"unknown model kind {kind!r}")
        if isinstance(len_buckets, str):
            raise NotImplementedError(
                "len_buckets 'auto' is not ported yet (ROADMAP A15)")
        if not isinstance(cfg, types[kind][0]) or not isinstance(model, types[kind][1]):
            raise TypeError(f"kind={kind!r} takes a {types[kind][0].__name__} and a "
                            f"{types[kind][1].__name__}, got {type(cfg).__name__} "
                            f"and {type(model).__name__}")
        if model.cfg != cfg:
            raise ValueError("cfg differs from the model's config")
        # The JAX engine's errors (engine.py:215-222, 239-240).
        if kv_quantize is not None:
            if kv_quantize not in ("int8", "int4"):
                raise ValueError(f"unknown kv_quantize mode {kv_quantize!r}")
            if kind != "decoder":
                raise ValueError("quantized KV cache targets decoder models")
            if kv_quantize == "int4" and cfg.head_dim_ % 2:
                raise ValueError("int4 KV cache needs an even head_dim")
        if spec_lookup:
            if kind != "decoder":
                raise ValueError("spec_lookup targets decoder generation")
            raise NotImplementedError(
                "speculative decoding (spec_lookup) is not ported yet (ROADMAP A8(b))")
        if awq_calib and quantize is not None:
            if kind != "decoder":
                raise ValueError("awq_calib targets decoder models")
            raise NotImplementedError(
                "AWQ calibration (awq_calib) is not ported yet (ROADMAP A9 (AWQ))")
        if quantize is not None:
            # The JAX engine's errors (engine.py:155-162).
            if quantize not in ("int8", "int4"):
                raise ValueError(f"unknown quantize mode {quantize!r}")
            if quantize == "int4" and kind != "decoder":
                raise ValueError(
                    "quantize='int4' targets decoder models (T5 scoring"
                    " is compute-bound on the int8 MXU — use 'int8')"
                )
            if kind == "decoder":
                # int8: weights and head, the W8A8 kernels at the sites with
                # M = B*L >= 1024 (the gate pair fused); int4: group-wise int4
                # FFN sites on the W4A8 kernel at any M, int8 elsewhere.
                if quantize == "int4":
                    model = quantize_decoder_params_int4(model)
                    cfg = dataclasses.replace(cfg, int4_kernel=True)
                else:
                    model = quantize_decoder_params(model)
                    cfg = dataclasses.replace(cfg, int8_kernel=True)
                model.cfg = cfg
            else:
                # T5 scoring is compute-bound: int8 weights AND the W8A8
                # kernels at every site with M = B*L >= 1024 (t5._mm dispatch).
                model = quantize_t5_params(model, pack=True)
        if kv_quantize is not None:
            # The engine's config carries the cache mode, as in JAX; the
            # model's does not (the prefill takes it, the decode reads it
            # back from the cache), so models are shared across engines.
            cfg = dataclasses.replace(cfg, kv_quant=kv_quantize)
        self.kind = kind
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = (torch.device(device) if device is not None
                       else model.embed.device if kind == "decoder"
                       else model.shared.device)
        self.model = model.to(self.device)
        if kind == "decoder":
            self.model.use_flash = self.device.type == "cuda"
        self.len_buckets = tuple(len_buckets)
        self.batch_buckets = tuple(batch_buckets)
        self.max_batch_tokens = max_batch_tokens
        # Rows whose real tokens were cut to the model context (decoder
        # RoPE range; T5's relative-position buckets saturate, so T5 rows
        # are never cut).
        self.truncated_rows = 0
        self._warned_ctx = False
        # Prompt-prefix KV sharing (decoder models only; T5's bidirectional
        # encoder makes prefix reuse inexact, so it never applies there).
        self.prefix_share = prefix_share and kind == "decoder"
        # Cross-wave prefix-KV cache: prefix tokens -> (ks [Ld, KV, len, Dh],
        # vs, nbytes), LRU-evicted to the byte budget. Entries are stored at
        # their exact prefix length (K/V at real positions does not depend
        # on padding: absolute RoPE, masked attention).
        self._pkv: "collections.OrderedDict[Any, Any]" = collections.OrderedDict()
        self._pkv_bytes = 0
        self._pkv_budget = int(prefix_cache_mb) * (1 << 20) if self.prefix_share else 0
        self.pkv_stats = {"hits": 0, "misses": 0, "evictions": 0}
        # Dispatches by the JAX engine's program name.
        self.programs: "collections.Counter[str]" = collections.Counter()
        # Rows per generate dispatch learned from device OOMs, by (kind,
        # padded length, max_new_tokens).
        self._learned_row_caps: Dict[Any, int] = {}

    # ------------------------------------------------------------------
    # Host-side padding, capping and chunking (JAX engine: _pad_batch,
    # _ctx_cap, _cap_len, _group, _chunks)
    # ------------------------------------------------------------------
    def _pad_batch(
        self, rows: List[List[int]], left: bool = False,
        b_cap: Optional[int] = None, l_force: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """Pad token rows into a (batch, length) bucket: right padding for
        T5 prompts and decoder prefixes/suffixes, left padding for whole
        decoder prompts. ``b_cap`` bounds the batch bucket (the padded batch
        is then the row count), ``l_force`` pins the padded length."""
        n = len(rows)
        max_len = max((len(r) for r in rows), default=1)
        if l_force is not None:
            L = l_force
        else:
            L = self._cap_len(_bucket(max_len, self.len_buckets), max_len)
        if L < max_len:  # context cap hit: count every truncated row
            self.truncated_rows += sum(1 for r in rows if len(r) > L)
        B = _bucket(n, self.batch_buckets)
        if b_cap is not None and B > b_cap:
            B = n
        ids, mask = native.pack_padded(rows, B, L, self.tokenizer.pad_id, left)
        return ids, mask, n, B

    def _ctx_cap(self) -> int:
        """Hard context cap: decoder RoPE positions past
        max_position_embeddings are outside the trained range. T5 rel-pos
        buckets saturate gracefully — no cap (returns 0)."""
        return self.cfg.max_position_embeddings if self.kind == "decoder" else 0

    def _cap_len(self, L: int, max_len: int) -> int:
        """Apply the context cap to a padded length, warning once when it
        truncates real tokens (tail kept for left padding, head for right
        — pack_padded's convention)."""
        cap = self._ctx_cap()
        if cap and L > cap:
            if max_len > cap and not self._warned_ctx:
                self._warned_ctx = True
                print(f"warning: truncating rows of {max_len} tokens to "
                      f"the model context ({cap})", file=sys.stderr)
            L = cap
        return L

    def _chunks(self, rows: List[List[int]], row_limit: Optional[int] = None):
        """Split a wave so B*L stays under max_batch_tokens (and under
        ``row_limit``, the generate path's per-dispatch row cap). Scoring
        chunks land on a batch-bucket rung (no systematic row padding);
        memory-capped generate chunks on a rung of the densified
        :meth:`_row_ladder`, or keep a limit below its smallest rung."""
        if not rows:
            return
        L = self._cap_len(_bucket(max(len(r) for r in rows), self.len_buckets), 0)
        per = max(1, self.max_batch_tokens // L)
        if row_limit is not None:
            per = max(1, min(per, row_limit))
        ladder = self._row_ladder() if row_limit is not None else self.batch_buckets
        fitting = [b for b in ladder if b <= per]
        if fitting:
            per = max(fitting)
        for i in range(0, len(rows), per):
            yield i, rows[i: i + per]

    def _row_ladder(self) -> List[int]:
        """Rows-per-dispatch rungs for memory-capped generate chunks: the
        batch buckets densified with mid rungs."""
        return sorted(set(self.batch_buckets) | {12, 16, 24, 48, 96, 192, 384})

    def _halve_cap(self, n: int) -> int:
        """Rows per dispatch after an OOM at ``n`` rows: the largest ladder
        rung <= n // 2, floor 1."""
        half = max(1, n // 2)
        fitting = [b for b in self._row_ladder() if b <= half]
        return max(fitting) if fitting else half

    def _params_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.model.parameters())

    def _gen_row_limit(self, rows: List[List[int]], max_new: int) -> int:
        """Rows per generate dispatch so the KV caches and the prefill's
        transients fit device memory: the JAX engine's per-row estimate
        (engine.py:947-1007, decoder kind) against the memory free on the
        card (``torch.cuda.mem_get_info`` plus what PyTorch's allocator holds
        unused), less 2 GiB, at 70%. Elsewhere the JAX fallback of 16 GiB
        less the weights. An estimate: a device OOM halves the cap."""
        cfg = self.cfg
        L = self._cap_len(_bucket(max(len(r) for r in rows), self.len_buckets), 0)
        bpe = 2  # bf16
        # int8 KV halves the cache bytes (plus one f32 scale, 4/Dh); int4
        # packs two dims per byte (plus two f32 scales, 8/Dh).
        if cfg.kv_quant == "int4":
            kv_bpe = 0.5 + 8.0 / cfg.head_dim_
        elif cfg.kv_quant:
            kv_bpe = 1 + 4.0 / cfg.head_dim_
        else:
            kv_bpe = bpe
        # Prefill transients per row: the [L, d_ff] FFN intermediates (one
        # fewer where the fused gated kernel keeps the pair out of memory)
        # and about ten [L, D] streams.
        ffn_live = 2 if cfg.qkernels else 3
        F_ = max(cfg.intermediate_size, cfg.hidden_size)
        per_row = (
            cfg.num_hidden_layers * cfg.num_key_value_heads
            * cfg.head_dim_ * (L + max_new) * 2 * kv_bpe  # self K/V
            + (ffn_live * F_ + 10 * cfg.hidden_size) * L * bpe
        )
        if self.device.type == "cuda":
            free_b, _ = torch.cuda.mem_get_info(self.device)
            free_b += (torch.cuda.memory_reserved(self.device)
                       - torch.cuda.memory_allocated(self.device))
            free = max(free_b - 2 * 1024**3, 1024**3) * 0.7
        else:
            limit = 16 * 1024**3
            free = max(limit - self._params_bytes() - 2 * 1024**3, 1024**3) * 0.7
        return max(1, int(free // per_row))

    def _to_device(self, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    def _group(self, chunk: List[List[int]], b_cap: Optional[int] = None):
        """Shared-prefix grouping of a chunk (decoder kind only).

        Returns (n, device args (pids, pmask, gidx, sids, smask), the unique
        prefixes' token lists) when sharing pays off, else None. Rows keep
        their original order; only the prefix compute is deduplicated.
        ``b_cap`` bounds the suffix batch (memory-capped generate chunks)."""
        if not self.prefix_share:
            return None
        grp = prefix_mod.group_shared_prefixes(chunk)
        if grp is None:
            return None
        pre_rows, gidx, suf_rows = grp
        # Prefix and suffix are padded separately, so the plain path's
        # context cap cannot see the combined length: rows that would
        # exceed it take the ungrouped path, which truncates them.
        cap = self._ctx_cap()
        if cap and any(len(pre_rows[g]) + len(s) > cap for g, s in zip(gidx, suf_rows)):
            return None
        # The prefix batch is the true group count, not a batch bucket.
        pids, pmask, _, _ = self._pad_batch(pre_rows, b_cap=len(pre_rows))
        sids, smask, n, B = self._pad_batch(suf_rows, b_cap=b_cap)
        gvec = np.zeros((B,), np.int64)
        gvec[: len(gidx)] = gidx
        return n, self._to_device(pids, pmask, gvec, sids, smask), pre_rows

    def _pkv_assemble(self, pre_rows: List[List[int]], Lp: int):
        """Cross-wave prefix-KV cache lookup and fill for one wave.

        Returns ``(ks, vs)`` shaped [Ld, G, KV, Lp, Dh] covering the wave's
        unique prefixes (cached entries padded with zeros to the wave's
        prefix area Lp, missing ones computed in ONE ``prefix_kv`` dispatch
        and inserted, LRU under the byte budget), or None when the cache is
        off. A sort's successive waves re-score the same query heads, so
        the cache dedups the prefix forward across dispatches."""
        if self._pkv_budget <= 0:
            return None
        keys = [tuple(p) for p in pre_rows]
        got: Dict[int, Any] = {}
        misses: List[int] = []
        for g, key in enumerate(keys):
            e = self._pkv.get(key)
            if e is None:
                misses.append(g)
            else:
                self._pkv.move_to_end(key)
                got[g] = (e[0], e[1])
        self.pkv_stats["hits"] += len(got)
        self.pkv_stats["misses"] += len(misses)
        if misses:
            mids, mmask, _, _ = self._pad_batch(
                [pre_rows[g] for g in misses], b_cap=len(misses), l_force=Lp)
            self.programs["prefix_kv"] += 1
            ks_m, vs_m = gen_mod.decoder_prefix_kv(self.model, *self._to_device(mids, mmask))
            for j, g in enumerate(misses):
                # Stored at the true length (>= 1 so an empty singleton
                # prefix stays indexable; its pmask row is all 0, so the
                # value is never attended), as copies that own their bytes.
                Lr = max(1, len(pre_rows[g]))
                ek = ks_m[:, j, :, :Lr, :].clone()
                ev = vs_m[:, j, :, :Lr, :].clone()
                got[g] = (ek, ev)
                nbytes = ek.numel() * ek.element_size() * 2
                old = self._pkv.pop(keys[g], None)
                if old is not None:
                    self._pkv_bytes -= old[2]
                self._pkv[keys[g]] = (ek, ev, nbytes)
                self._pkv_bytes += nbytes
            while self._pkv_bytes > self._pkv_budget and self._pkv:
                _, (_, _, eb) = self._pkv.popitem(last=False)
                self._pkv_bytes -= eb
                self.pkv_stats["evictions"] += 1
        ks_list, vs_list = [], []
        for g in range(len(pre_rows)):
            ek, ev = got[g]
            pad = (0, 0, 0, Lp - ek.shape[2])
            ks_list.append(F.pad(ek, pad))
            vs_list.append(F.pad(ev, pad))
        return torch.stack(ks_list, dim=1), torch.stack(vs_list, dim=1)

    # ------------------------------------------------------------------
    # Programs (the JAX engine's jitted programs, run eagerly)
    # ------------------------------------------------------------------
    def _t5_labels(self, ids: np.ndarray, mask: np.ndarray, labels: torch.Tensor,
                   prefix: Tuple[int, ...]) -> torch.Tensor:
        """``t5_labels``: encode, decode the forced prefix, label logits at
        its last position, fp32 [B, K]."""
        self.programs["t5_labels"] += 1
        ids_t, mask_t = self._to_device(ids, mask)
        pref = torch.tensor(prefix, device=self.device).expand(ids.shape[0], -1)
        enc_out = self.model.encode(ids_t, mask_t)
        hidden = self.model.decode_hidden(pref, enc_out, mask_t)
        return self.model.label_logits(hidden[:, -1, :], labels).float()

    def _dec_labels(self, ids: np.ndarray, mask: np.ndarray,
                    labels: torch.Tensor) -> torch.Tensor:
        """``dec_labels``: a left-padded forward; the last position is each
        row's last real token."""
        self.programs["dec_labels"] += 1
        hidden, _ = self.model.forward_hidden(*self._to_device(ids, mask))
        return self.model.label_logits(hidden[:, -1, :], labels).float()

    def _dec_labels_on(self, ks, vs, pmask, gidx, sids, smask, labels) -> torch.Tensor:
        """Rows gather their group's prefix K/V and prefill their suffixes."""
        last_h, _ = gen_mod.decoder_shared_prefill(
            self.model, ks.index_select(1, gidx), vs.index_select(1, gidx),
            pmask.index_select(0, gidx), sids, smask)
        return self.model.label_logits(last_h, labels).float()

    def _dec_labels_shared(self, pids, pmask, gidx, sids, smask, labels) -> torch.Tensor:
        """``dec_labels_shared``: the unique prefixes' forward, then the
        suffixes on top of it."""
        self.programs["dec_labels_shared"] += 1
        ks, vs = gen_mod.decoder_prefix_kv(self.model, pids, pmask)
        return self._dec_labels_on(ks, vs, pmask, gidx, sids, smask, labels)

    def _dec_labels_pre(self, ks, vs, pmask, gidx, sids, smask, labels) -> torch.Tensor:
        """``dec_labels_pre``: the suffixes on cache-assembled prefix K/V."""
        self.programs["dec_labels_pre"] += 1
        return self._dec_labels_on(ks, vs, pmask, gidx, sids, smask, labels)

    # ------------------------------------------------------------------
    # score_labels: one forward, label-token logits
    # ------------------------------------------------------------------
    def score_labels(
        self,
        prompt_rows: List[List[int]],
        label_ids: Sequence[int],
        decoder_prefix: Sequence[int] = (),
        adapter: Optional[str] = None,
        row_adapters: Optional[Sequence[Optional[str]]] = None,
    ) -> np.ndarray:
        """[N, K] fp32 logits of each label token at the first free decoder
        position: T5 after the forced prefix (an empty prefix means the
        decoder start token); decoder-only after the prompt's last real
        token (``decoder_prefix`` is not used there)."""
        if adapter is not None or row_adapters is not None:
            raise NotImplementedError("LoRA adapters are not ported yet (ROADMAP A10)")
        out = np.zeros((len(prompt_rows), len(label_ids)), np.float32)
        labels = torch.tensor([int(x) for x in label_ids], device=self.device)
        prefix = tuple(int(x) for x in decoder_prefix)
        if self.kind == "t5" and not prefix:
            prefix = (int(self.cfg.decoder_start_token_id),)
        # Enqueue every chunk before reading any back, so host padding of
        # chunk i+1 overlaps device compute of chunk i.
        pending = []
        with torch.inference_mode():
            for off, chunk in self._chunks(prompt_rows):
                if self.kind == "t5":
                    ids, mask, n, _ = self._pad_batch(chunk)
                    pending.append((off, n, self._t5_labels(ids, mask, labels, prefix)))
                    continue
                grp = self._group(chunk)
                if grp is None:
                    ids, mask, n, _ = self._pad_batch(chunk, left=True)
                    res = self._dec_labels(ids, mask, labels)
                else:
                    n, args, pre_rows = grp
                    pre = self._pkv_assemble(pre_rows, args[0].shape[1])
                    if pre is None:
                        res = self._dec_labels_shared(*args, labels)
                    else:
                        res = self._dec_labels_pre(*pre, *args[1:], labels)
                pending.append((off, n, res))
            for off, n, res in pending:
                out[off: off + n] = res[:n].cpu().numpy()
        return out

    # ------------------------------------------------------------------
    # generate: greedy (or sampled) decoding on a KV cache
    # ------------------------------------------------------------------
    def generate(
        self,
        prompt_rows: List[List[int]],
        max_new_tokens: int,
        decoder_prefix: Sequence[int] = (),
        stop_strings: Sequence[str] = (),
        chunk_tokens: Optional[int] = None,
        adapter: Optional[str] = None,
        row_adapters: Optional[Sequence[Optional[str]]] = None,
        temperature: float = 0.0,
        seed: Optional[int] = None,
    ) -> Tuple[List[str], List[int]]:
        """Decoder generation; returns (decoded completions, per-row new
        token counts up to and including EOS), as the JAX ``generate``
        (``decoder_prefix`` is not used by decoder-only models).

        ``temperature > 0`` samples each token from softmax(logits /
        temperature) (``seed`` keys the stream: one per dispatch chunk, by
        its row offset, and one per global step, so chunking does not change
        it; the samples are not JAX's). ``stop_strings`` cut the decoded
        text; with ``chunk_tokens`` below the budget (256 by default for
        budgets of 512 or more) decoding runs in chunks, and between chunks
        the host freezes rows whose text holds a stop string or EOS, and
        stops once every row is frozen."""
        if self.kind != "decoder":
            raise NotImplementedError("T5 generation is not ported yet (ROADMAP A6)")
        if adapter is not None or row_adapters is not None:
            raise NotImplementedError("LoRA adapters are not ported yet (ROADMAP A10)")
        sampling = None
        if temperature and temperature > 0.0:
            sampling = (float(temperature), 0 if seed is None else int(seed))
        results: List[str] = [""] * len(prompt_rows)
        ntokens: List[int] = [0] * len(prompt_rows)
        if chunk_tokens is None and max_new_tokens >= 512:
            chunk_tokens = 256
        if sampling is not None and chunk_tokens is None:
            chunk_tokens = max_new_tokens  # sampling rides the chunked loop
        if not prompt_rows:
            return results, ntokens
        row_limit = self._gen_row_limit(prompt_rows, max_new_tokens)
        # The engine's learned cap for this shape family: the estimate
        # above is an estimate, a device OOM is ground truth.
        L_key = self._cap_len(_bucket(max(len(r) for r in prompt_rows), self.len_buckets), 0)
        cap_key = ("gen", self.kind, L_key, max_new_tokens)
        learned = self._learned_row_caps.get(cap_key)
        if learned is not None:
            row_limit = min(row_limit, learned)

        def emit(off: int, toks: np.ndarray) -> None:
            # Frozen rows are filled with cfg.pad_token_id, which may differ
            # from the tokenizer's pad: strip both.
            pad_ids = {self.tokenizer.pad_id, int(self.cfg.pad_token_id)}
            for i, row in enumerate(toks):
                row_l = row.tolist()
                # Count up to and including EOS; trailing pad filler of rows
                # frozen early does not count.
                try:
                    ntok = row_l.index(self.tokenizer.eos_id) + 1
                except ValueError:
                    ntok = len(row_l)
                    while ntok > 0 and row_l[ntok - 1] in pad_ids:
                        ntok -= 1
                ntokens[off + i] = ntok
                text = self.tokenizer.decode(row_l[:ntok], skip_special_tokens=True)
                for stop in stop_strings:
                    cut = text.find(stop)
                    if cut != -1:
                        text = text[: cut + len(stop)]
                results[off + i] = text

        # Where the JAX engine would run a slot-refill session (several
        # dispatches, chunked), the port runs the dispatches in turn
        # (ROADMAP A8(b)).
        queue = list(self._chunks(prompt_rows, row_limit))
        with torch.inference_mode():
            while queue:
                off, chunk = queue.pop(0)
                try:
                    toks = self._generate_dispatch(
                        chunk, max_new_tokens, stop_strings, chunk_tokens, row_limit,
                        # A sample stream per dispatch chunk, keyed by its row
                        # offset in the wave.
                        sampling=((sampling[0], gen_mod._fold(sampling[1], off))
                                  if sampling else None))
                except Exception as e:  # halve and retry on a device OOM
                    if len(chunk) == 1 or not _is_oom(e):
                        raise
                    row_limit = self._halve_cap(len(chunk))
                    self._learned_row_caps[cap_key] = row_limit
                    logger.warning(
                        "device OOM at %d generate rows (L=%d max_new=%d); backing "
                        "off to %d rows/dispatch", len(chunk), L_key, max_new_tokens,
                        row_limit)
                    torch.cuda.empty_cache()
                    queue = [(off + i, sub) for i, sub in self._chunks(chunk, row_limit)
                             ] + queue
                    continue
                emit(off, toks)
        return results, ntokens

    def _generate_dispatch(self, chunk: List[List[int]], max_new_tokens: int,
                           stop_strings: Sequence[str], chunk_tokens: Optional[int],
                           row_limit: Optional[int], sampling=None) -> np.ndarray:
        """One generate dispatch over ``chunk`` rows: the emitted token matrix
        [n, max_new_tokens]. Everything that can exhaust device memory
        (prefill, decode, fetch) happens here, so generate's backoff can
        retry the chunk smaller. ``sampling`` is (temperature, seed)."""
        chunked = bool(chunk_tokens) and chunk_tokens < max_new_tokens or sampling is not None
        kvq = self.cfg.kv_quant
        grp = self._group(chunk, b_cap=row_limit)
        if grp is not None:
            n, (pids, pmask, gidx, sids, smask), pre_rows = grp
            B = sids.shape[0]
            prompt_len = pids.shape[1] + sids.shape[1]
            # Cross-wave prefix cache: cache-assembled prefix K/V instead of
            # the prefix forward (the *_pre programs).
            pre = self._pkv_assemble(pre_rows, pids.shape[1])
            if pre is not None:
                ks, vs = pre
                suffix = "_pre"
            else:
                ks, vs = gen_mod.decoder_prefix_kv(self.model, pids, pmask)
                suffix = "_shared"
            last_h, cache = gen_mod.decoder_shared_prefill(
                self.model, ks.index_select(1, gidx), vs.index_select(1, gidx),
                pmask.index_select(0, gidx), sids, smask, max_new_tokens, kv_quant=kvq)
            logits = self.model.lm_logits(last_h)
        else:
            ids, mask, n, B = self._pad_batch(chunk, left=True, b_cap=row_limit)
            prompt_len = ids.shape[1]
            logits, cache = gen_mod.decoder_prefill(
                self.model, *self._to_device(ids, mask), max_new_tokens, kv_quant=kvq)
            suffix = ""
        eos = int(self.cfg.eos_token_id)
        if chunked:
            self.programs["dec_prefill" + suffix] += 1
            k_pref = k_dec = None
            temperature = 0.0
            if sampling is not None:
                temperature = sampling[0]
                k_pref, k_dec = gen_mod._fold(sampling[1], 0), gen_mod._fold(sampling[1], 1)
            tok = gen_mod._pick(logits, temperature, k_pref)
            return self._decode_chunked(tok, cache, B, prompt_len, n, max_new_tokens,
                                        chunk_tokens or max_new_tokens, stop_strings,
                                        temperature, k_dec)
        self.programs["dec_gen" + suffix] += 1
        first = torch.argmax(logits, dim=-1)
        out = gen_mod.decoder_greedy_decode(self.model, first, cache, prompt_len,
                                            max_new_tokens, eos)
        return out[:n].cpu().numpy()

    def _decode_chunked(self, tok, cache, B: int, prompt_len: int, n: int,
                        max_new_tokens: int, chunk_tokens: int,
                        stop_strings: Sequence[str], temperature: float = 0.0,
                        key: Optional[int] = None) -> np.ndarray:
        """Decode from a prefilled cache in chunks of ``chunk_tokens``;
        between chunks the host decodes each live row and freezes those
        whose text holds a stop string (or EOS). Without stop strings, and
        with the tokenizer's EOS the model's, every freeze happens on the
        device, so chunk i+1 is enqueued before chunk i is read back; the
        tokens are the same either way. ``key`` seeds sampling, per global
        step."""
        eos = int(self.cfg.eos_token_id)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        pieces: List[np.ndarray] = []
        offset = 0
        pipelined = not stop_strings and self.tokenizer.eos_id == eos
        pending = None  # (out, done) of the chunk enqueued last
        while offset < max_new_tokens:
            steps = min(chunk_tokens, max_new_tokens - offset)
            self.programs["dec_chunk"] += 1
            out, (tok, cache, done) = gen_mod.decoder_decode_chunk(
                self.model, tok, cache, prompt_len, offset, steps, eos, done=done,
                temperature=temperature, key=key)
            offset += steps
            if pipelined:
                prev, pending = pending, (out, done)
                if prev is not None:
                    pieces.append(prev[0].cpu().numpy())
                    if bool(prev[1].all()):
                        break  # the chunk just enqueued is all pad filler
                continue
            pieces.append(out.cpu().numpy())
            if offset >= max_new_tokens:
                break
            acc = np.concatenate(pieces, axis=1)
            newly = self._host_freeze(done.cpu().numpy(), lambda i: acc[i].tolist(), n, B,
                                      None, stop_strings)
            if all(newly):
                break
            done = torch.tensor(newly, dtype=torch.bool, device=self.device)
        if pending is not None:
            pieces.append(pending[0].cpu().numpy())
        out = np.concatenate(pieces, axis=1)
        if out.shape[1] < max_new_tokens:
            out = np.pad(out, ((0, 0), (0, max_new_tokens - out.shape[1])),
                         constant_values=self.tokenizer.pad_id)
        return out[:n]

    def _host_freeze(self, done_h: np.ndarray, row_tokens, n: int, B: int,
                     max_new_tokens: Optional[int], stop_strings: Sequence[str]
                     ) -> List[bool]:
        """Between-chunk freeze decisions: a live row freezes on the
        tokenizer's EOS, a decoded stop string, or (when given) a spent
        budget; padding rows are always frozen."""
        eos = self.tokenizer.eos_id
        newly = [bool(d) for d in done_h]
        for i in range(n):
            if newly[i]:
                continue
            row = row_tokens(i)
            if max_new_tokens is not None and len(row) >= max_new_tokens:
                newly[i] = True
                continue
            if eos in row:
                newly[i] = True
                continue
            text = self.tokenizer.decode(row, skip_special_tokens=True)
            if any(stop in text for stop in stop_strings):
                newly[i] = True
        for i in range(n, B):
            newly[i] = True
        return newly

    # ------------------------------------------------------------------
    # Not ported yet
    # ------------------------------------------------------------------
    def sequence_nll(self, *args, **kwargs):
        raise NotImplementedError("sequence_nll is not ported yet (ROADMAP A6)")


    def add_adapter(self, *args, **kwargs):
        raise NotImplementedError("LoRA adapters are not ported yet (ROADMAP A10)")
