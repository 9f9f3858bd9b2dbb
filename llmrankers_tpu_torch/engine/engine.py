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
(``dec_chunk``) with a host check for stop strings between chunks. A wave
that needs several dispatches and is chunked runs instead as one slot-refill
session (continuous batching, ``_generate_refill``; ``LLMRANKERS_NO_REFILL=1``
turns it off, as in JAX): finished rows' slots are prefilled again from
pending rows at chunk boundaries (``rr_refill``, ``rr_refill_shared``, or
``rr_refill_pre`` on the session's prefix K/V) and every row decodes at its
own write position (``dec_chunk_rr``). With ``spec_lookup`` = K > 0 the
decode is prompt-lookup speculative (``dec_spec_chunk``): K drafts from the
row's own history, verified in one (K+1)-token forward, greedy only.

The rest of the JAX engine raises ``NotImplementedError`` naming the ROADMAP
item that ports it. The host modules come from the port's own copies
(``utils/native.py``, ``engine/prefix.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import os
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


def _spec_stitch(row: List[int], outs: np.ndarray, counts: np.ndarray, max_new: int
                 ) -> Tuple[int, int]:
    """Append one row's speculative rounds (``outs`` [rounds, K+1],
    ``counts`` [rounds]) to ``row``. Returns the accept-rate stats' share:
    (tokens the budget keeps, rounds that kept any)."""
    tokens = rounds = 0
    for out, cnt in zip(outs, counts.tolist()):
        if not cnt:
            continue
        kept = min(cnt, max(0, max_new - len(row)))
        if kept:
            tokens, rounds = tokens + kept, rounds + 1
        row.extend(out[:cnt].tolist())
    return tokens, rounds


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
        spec_lookup: int = 0,  # draft length of prompt-lookup speculation (0: off)
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
        if spec_lookup and kind != "decoder":
            raise ValueError("spec_lookup targets decoder generation")
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
        self.spec_lookup = int(spec_lookup)
        # Over the engine's lifetime: speculative tokens kept and the rounds
        # that kept any (accept rate = tokens / rounds); slot-refill
        # sessions, their refill batches and those on the session's prefix
        # K/V.
        self.spec_stats = {"tokens": 0, "rounds": 0}
        self.refill_stats = {"sessions": 0, "refills": 0, "prefix_kv_hits": 0}
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

    def _group(self, chunk: List[List[int]], b_cap: Optional[int] = None,
               l_total: Optional[int] = None):
        """Shared-prefix grouping of a chunk (decoder kind only).

        Returns (n, device args (pids, pmask, gidx, sids, smask), host info
        (the unique prefixes' token lists, padded prefix and suffix
        lengths)) when sharing pays off, else None. Rows keep their original
        order; only the prefix compute is deduplicated. ``b_cap`` bounds the
        suffix batch (memory-capped generate chunks); ``l_total`` pins the
        padded prefix plus suffix length to that many positions (a refill
        session's prompt area), and None is returned where they do not fit."""
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
        l_pre = l_suf = None
        if l_total is not None:
            # A ladder rung for the prefix, or its exact length where the
            # rung leaves the suffixes too little of the total.
            pre_max = max((len(p) for p in pre_rows), default=0)
            suf_max = max(len(r) for r in suf_rows)
            l_pre = _bucket(max(pre_max, 1), self.len_buckets)
            if l_pre + suf_max > l_total:
                l_pre = max(pre_max, 1)
            l_suf = l_total - l_pre
            if l_suf < suf_max or l_suf < 1:
                return None
        # The prefix batch is the true group count, not a batch bucket.
        pids, pmask, _, _ = self._pad_batch(pre_rows, b_cap=len(pre_rows), l_force=l_pre)
        sids, smask, n, B = self._pad_batch(suf_rows, b_cap=b_cap, l_force=l_suf)
        gvec = np.zeros((B,), np.int64)
        gvec[: len(gidx)] = gidx
        return (n, self._to_device(pids, pmask, gvec, sids, smask),
                (pre_rows, pids.shape[1], sids.shape[1]))

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
                got[g] = self._pkv_put(keys[g], ks_m[:, j], vs_m[:, j])
            self._pkv_evict()
        ks_list, vs_list = [], []
        for g in range(len(pre_rows)):
            ek, ev = got[g]
            pad = (0, 0, 0, Lp - ek.shape[2])
            ks_list.append(F.pad(ek, pad))
            vs_list.append(F.pad(ev, pad))
        return torch.stack(ks_list, dim=1), torch.stack(vs_list, dim=1)

    def _pkv_put(self, key: Tuple[int, ...], k: torch.Tensor, v: torch.Tensor):
        """Store one prefix's K/V [Ld, KV, Lp, Dh] in the prefix cache at its
        true length (>= 1 so an empty singleton prefix stays indexable; its
        pmask row is all 0, so the value is never attended), as copies that
        own their bytes. Returns them."""
        Lr = max(1, len(key))
        ek, ev = k[:, :, :Lr, :].clone(), v[:, :, :Lr, :].clone()
        old = self._pkv.pop(key, None)
        if old is not None:
            self._pkv_bytes -= old[2]
        nbytes = ek.numel() * ek.element_size() * 2
        self._pkv[key] = (ek, ev, nbytes)
        self._pkv_bytes += nbytes
        return ek, ev

    def _pkv_evict(self) -> None:
        """Drop the least recently used entries down to the byte budget."""
        while self._pkv_bytes > self._pkv_budget and self._pkv:
            _, (_, _, eb) = self._pkv.popitem(last=False)
            self._pkv_bytes -= eb
            self.pkv_stats["evictions"] += 1

    def _pkv_insert(self, pre_rows: List[List[int]], ks: torch.Tensor, vs: torch.Tensor
                    ) -> None:
        """Seed the cross-wave prefix cache with prefix K/V a refill session
        computed anyway ([Ld, G, KV, Lp, Dh]), so the next wave of the same
        sort starts from a hit."""
        if self._pkv_budget <= 0:
            return
        for g, p in enumerate(pre_rows):
            if tuple(p) in self._pkv:
                self._pkv.move_to_end(tuple(p))
            else:
                self._pkv_put(tuple(p), ks[:, g], vs[:, g])
        self._pkv_evict()

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
                    n, args, host = grp
                    pre = self._pkv_assemble(host[0], args[0].shape[1])
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
        it; in a slot-refill session one stream for the first tokens, one
        for the decode steps, by the session's step, and one per refill
        batch; the samples are not JAX's, and the same seed gives the same
        tokens on the same route). Sampling with ``spec_lookup`` raises, its
        acceptance being greedy. ``stop_strings`` cut the decoded
        text; with ``chunk_tokens`` below the budget (256 by default for
        budgets of 512 or more) decoding runs in chunks, and between chunks
        the host freezes rows whose text holds a stop string or EOS, and
        stops once every row is frozen. A chunked wave of several dispatches
        runs as one slot-refill session (``_generate_refill``) unless
        ``LLMRANKERS_NO_REFILL=1``."""
        if self.kind != "decoder":
            raise NotImplementedError("T5 generation is not ported yet (ROADMAP A6)")
        if adapter is not None or row_adapters is not None:
            raise NotImplementedError("LoRA adapters are not ported yet (ROADMAP A10)")
        sampling = None
        if temperature and temperature > 0.0:
            if self.spec_lookup:
                raise ValueError("temperature sampling is incompatible with "
                                 "spec_lookup (speculative acceptance is greedy)")
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

        queue = list(self._chunks(prompt_rows, row_limit))
        # Several dispatches, chunked: one slot-refill session serves them
        # all, finished rows' slots prefilled again from pending rows at
        # chunk boundaries. A device OOM halves the rows per dispatch and
        # runs the whole session again.
        if (len(queue) > 1 and chunk_tokens and chunk_tokens < max_new_tokens
                and os.environ.get("LLMRANKERS_NO_REFILL") != "1"):
            with torch.inference_mode():
                while True:
                    try:
                        toks = self._generate_refill(prompt_rows, max_new_tokens,
                                                     stop_strings, chunk_tokens, row_limit,
                                                     sampling=sampling)
                        break
                    except Exception as e:
                        if row_limit <= 1 or not _is_oom(e):
                            raise
                        row_limit = self._halve_cap(row_limit)
                        self._learned_row_caps[cap_key] = row_limit
                        logger.warning(
                            "device OOM in refill session (L=%d max_new=%d); backing off "
                            "to %d rows/dispatch", L_key, max_new_tokens, row_limit)
                        torch.cuda.empty_cache()
            emit(0, toks)
            return results, ntokens
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
        spec = self.spec_lookup > 0
        # Speculation pads the cache so that a verify block crossing the
        # budget, and frozen rows' block writes after it, stay in bounds.
        mn_pad = max_new_tokens + 2 * (self.spec_lookup + 1) if spec else max_new_tokens
        grp = self._group(chunk, b_cap=row_limit)
        if grp is not None:
            n, (pids, pmask, gidx, sids, smask), host = grp
            B = sids.shape[0]
            prompt_len = pids.shape[1] + sids.shape[1]
            # Cross-wave prefix cache: cache-assembled prefix K/V instead of
            # the prefix forward (the *_pre programs).
            pre = self._pkv_assemble(host[0], pids.shape[1])
            if pre is not None:
                ks, vs = pre
                suffix = "_pre"
            else:
                ks, vs = gen_mod.decoder_prefix_kv(self.model, pids, pmask)
                suffix = "_shared"
            last_h, cache = gen_mod.decoder_shared_prefill(
                self.model, ks.index_select(1, gidx), vs.index_select(1, gidx),
                pmask.index_select(0, gidx), sids, smask, mn_pad, kv_quant=kvq)
            logits = self.model.lm_logits(last_h)
            hist_args = ("shared", (pids, pmask, gidx, sids, smask))
        else:
            ids, mask, n, B = self._pad_batch(chunk, left=True, b_cap=row_limit)
            prompt_len = ids.shape[1]
            ids, mask = self._to_device(ids, mask)
            logits, cache = gen_mod.decoder_prefill(self.model, ids, mask, mn_pad, kv_quant=kvq)
            suffix = ""
            hist_args = ("plain", (ids, mask))
        eos = int(self.cfg.eos_token_id)
        if spec:
            self.programs["dec_prefill" + suffix] += 1
            hist = self._spec_history(*hist_args, prompt_len + mn_pad)
            return self._decode_spec_chunked(torch.argmax(logits, dim=-1), cache, hist, B,
                                             prompt_len, n, max_new_tokens, chunk_tokens or 256,
                                             stop_strings)
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

    # ------------------------------------------------------------------
    # Slot refill (continuous batching) and speculative decoding
    # ------------------------------------------------------------------
    def _spec_history(self, kind: str, args, width: int) -> torch.Tensor:
        """A speculative batch's token history [rows, width], laid out like
        its cache: the left-padded ids, or each row's padded prefix then its
        suffix area; pad after the prompt."""
        if kind == "shared":
            pids, _, gidx, sids, _ = args
            prompt = torch.cat([pids.index_select(0, gidx), sids], dim=1)
        else:
            prompt = args[0]
        hist = torch.full((prompt.shape[0], width), self.tokenizer.pad_id, dtype=torch.long,
                          device=self.device)
        hist[:, :prompt.shape[1]] = prompt
        return hist

    def _rr_prep(self, batch: List[List[int]], b_cap: int, P: int):
        """Pad a batch to a refill session's layout, a prompt area of exactly
        ``P`` positions: shared prefixes where they pay and fit, else left
        padding. Returns (kind, device args, n real rows, host info or
        None)."""
        grp = self._group(batch, b_cap=b_cap, l_total=P)
        if grp is not None:
            n, args, host = grp
            return "shared", args, n, host
        ids, mask, n, _ = self._pad_batch(batch, left=True, b_cap=b_cap, l_force=P)
        return "plain", self._to_device(ids, mask), n, None

    def _rr_prep_pre(self, batch: List[List[int]], n_real: int, Br: int, host):
        """Lay a refill batch out against the session's prefix K/V: every
        real row must extend one of the session's unique prefixes (the
        longest that matches; an empty prefix takes any row whose suffix
        fits whole). Returns device (gidx, sids, smask), or None when a row
        matches none. Rows past ``n_real`` are padding: group 0, a pad
        suffix, and a slot out of range, so their result is dropped."""
        pre_rows, _, Ls = host
        order = sorted(range(len(pre_rows)), key=lambda g: -len(pre_rows[g]))
        gidx = np.zeros((Br,), np.int64)
        sufs: List[List[int]] = []
        for j, row in enumerate(batch[:n_real]):
            g = next((gi for gi in order
                      if len(pre_rows[gi]) < len(row) <= len(pre_rows[gi]) + Ls
                      and row[:len(pre_rows[gi])] == pre_rows[gi]), None)
            if g is None:
                return None
            gidx[j] = g
            sufs.append(row[len(pre_rows[g]):])
        sufs += [[self.tokenizer.pad_id]] * (Br - n_real)
        sids, smask, _, _ = self._pad_batch(sufs, b_cap=Br, l_force=Ls)
        return self._to_device(gidx, sids, smask)

    def _generate_refill(self, rows: List[List[int]], max_new: int,
                         stop_strings: Sequence[str], chunk_tokens: int, row_limit: int,
                         sampling=None) -> np.ndarray:
        """A slot-refill (continuous batching) session over a wave of
        several dispatches, the JAX ``_generate_refill``.

        One fixed-shape session (B slots, prompt area P, cache P + max_new,
        plus 2(K+1) slots of slack under speculation) serves all rows: the
        first chunk of ``_chunks`` prefills into the slots, and at each
        ``chunk_tokens`` boundary the slots whose row finished (EOS or a
        spent budget on the device, a stop string or the tokenizer's EOS on
        the host) are prefilled again from the pending rows, in batches of
        Br = B // 4 (at least 1) rows, once that many slots are free or no
        row is live. Each row decodes at its own write position with a full
        budget. When the session started on shared prefixes, a refill
        batch whose rows extend them runs only its suffixes on the
        session's prefix K/V (``rr_refill_pre``); others prefill whole
        (``rr_refill_shared`` or ``rr_refill``). The loop reads the finished
        slots back at every chunk boundary.

        Where the arithmetic is exact (f32 on the CPU) the tokens are the
        per-chunk route's; in bf16 a refill batch's prefill runs at Br rows,
        not the dispatch's B, and another GEMM algorithm may flip a near-tie
        argmax. ``sampling`` is (temperature, seed): the first tokens, the
        decode steps (by the session's step) and each refill batch sample
        their own streams of ``_fold(seed, ...)``.

        Returns the emitted-token matrix [len(rows), max_new], pad after
        each row's end, as the per-chunk route."""
        N = len(rows)
        pad_tok = self.tokenizer.pad_id
        max_len = max(len(r) for r in rows)
        P = self._cap_len(_bucket(max_len, self.len_buckets), max_len)
        first = next(self._chunks(rows, row_limit))[1]
        K = self.spec_lookup
        spec = K > 0
        mn_pad = max_new + 2 * (K + 1) if spec else max_new
        kvq = self.cfg.kv_quant
        eos = int(self.cfg.eos_token_id)
        temperature, k_pref, k_dec, k_ref = 0.0, None, None, None
        if sampling is not None:
            temperature = sampling[0]
            k_pref, k_dec, k_ref = (gen_mod._fold(sampling[1], i) for i in range(3))
        kind0, args0, n0, sess_host = self._rr_prep(first, row_limit, P)
        sess_kv = None  # (ks, vs, pmask, pids): the session's prefix K/V
        if kind0 == "shared":
            pids, pmask, gidx, sids, smask = args0
            B = sids.shape[0]
            pre = self._pkv_assemble(sess_host[0], pids.shape[1])
            if pre is not None:
                ks, vs = pre
                self.programs["dec_prefill_pre"] += 1
            else:
                ks, vs = gen_mod.decoder_prefix_kv(self.model, pids, pmask)
                self.programs["rr_prefill_shared"] += 1
                self._pkv_insert(sess_host[0], ks, vs)
            last_h, cache = gen_mod.decoder_shared_prefill(
                self.model, ks.index_select(1, gidx), vs.index_select(1, gidx),
                pmask.index_select(0, gidx), sids, smask, mn_pad, kv_quant=kvq)
            tok = gen_mod._pick(self.model.lm_logits(last_h), temperature, k_pref)
            # Kept for the session: refill rows that extend these prefixes
            # run only their suffixes.
            sess_kv = (ks, vs, pmask, pids)
        else:
            ids, mask = args0
            B = ids.shape[0]
            self.programs["dec_prefill"] += 1
            logits, cache = gen_mod.decoder_prefill(self.model, ids, mask, mn_pad, kv_quant=kvq)
            tok = gen_mod._pick(logits, temperature, k_pref)
        pending = list(range(n0, N))
        Br = min(B, max(1, B // 4))
        wp = torch.full((B,), P, dtype=torch.long, device=self.device)
        done_np = np.zeros((B,), bool)
        done_np[n0:] = True  # padding rows are free slots from the start
        done = torch.from_numpy(done_np).to(self.device)
        hist = None
        if spec:
            rounds = max(1, chunk_tokens // (K + 1))
            hist = self._spec_history(kind0, args0, P + mn_pad)
        out_mat = np.full((N, max_new), int(self.cfg.pad_token_id), np.int64)
        acc: List[List[int]] = [[] for _ in range(B)]
        slot_rows: List[Optional[int]] = [i if i < n0 else None for i in range(B)]
        live, refills, pre_hits, spec_tokens, spec_rounds, chunk_no = n0, 0, 0, 0, 0, 0
        while True:
            chunk_no += 1
            if spec:
                self.programs["dec_spec_chunk"] += 1
                outs, counts, (tok, cache, hist, wp, done) = gen_mod.decoder_spec_decode_chunk(
                    self.model, tok, cache, hist, wp, P, max_new, rounds, K, eos, done=done)
                out_h, cnt_h = outs.cpu().numpy(), counts.cpu().numpy()
            else:
                self.programs["dec_chunk_rr"] += 1
                out, (tok, cache, wp, done) = gen_mod.decoder_decode_chunk_rr(
                    self.model, tok, cache, wp, P, max_new, chunk_tokens, eos, done,
                    temperature=temperature, key=k_dec, step0=chunk_no * chunk_tokens)
                out_h = out.cpu().numpy()
            done_np, wp_h = done.cpu().numpy().copy(), wp.cpu().numpy()
            host_froze = False
            finished: List[int] = []
            for s in range(B):
                if slot_rows[s] is None:
                    continue
                if spec:
                    kept = _spec_stitch(acc[s], out_h[s], cnt_h[s], max_new)
                    spec_tokens, spec_rounds = spec_tokens + kept[0], spec_rounds + kept[1]
                else:
                    acc[s].extend(out_h[s].tolist())
                fin = bool(done_np[s]) or int(wp_h[s]) - P >= max_new
                # The device freezes on the model's EOS; the host on the
                # tokenizer's where it differs, and on stop strings.
                if (not fin and self.tokenizer.eos_id != eos
                        and self.tokenizer.eos_id in acc[s][:max_new]):
                    fin = host_froze = done_np[s] = True
                if not fin and stop_strings:
                    text = self.tokenizer.decode(acc[s][:max_new], skip_special_tokens=True)
                    if any(st in text for st in stop_strings):
                        fin = host_froze = done_np[s] = True
                if fin:
                    finished.append(s)
            for s in finished:
                row = acc[s][:max_new]
                out_mat[slot_rows[s], :len(row)] = row
                slot_rows[s], acc[s] = None, []
                live -= 1
            if host_froze:
                done = torch.from_numpy(done_np).to(self.device)
            free = [s for s in range(B) if slot_rows[s] is None]
            # Wait for a full refill batch of free slots (bounds the prefill
            # transient and the per-refill cost) unless no row is live.
            while pending and free and (len(free) >= Br or live == 0):
                k = min(Br, len(pending), len(free))
                take, pending = pending[:k], pending[k:]
                use, free = free[:k], free[k:]
                batch = [rows[i] for i in take] + [[pad_tok]] * (Br - k)
                slots = np.full((Br,), B, np.int64)  # B: out of range, dropped
                slots[:k] = use
                key = None if k_ref is None else gen_mod._fold(k_ref, refills)
                pre = (self._rr_prep_pre(batch, k, Br, sess_host)
                       if sess_kv is not None else None)
                if pre is not None:
                    gidx_r, sids_r, smask_r = pre
                    self.programs["rr_refill_pre"] += 1
                    tok, cache, wp, done = gen_mod.decoder_refill_slots_pre(
                        self.model, cache, tok, wp, done, *sess_kv[:3], gidx_r, sids_r, smask_r,
                        slots, temperature, key)
                    pre_hits += 1
                    kindr, argsr = "shared", (sess_kv[3], sess_kv[2], gidx_r, sids_r, smask_r)
                else:
                    kindr, argsr, _, _ = self._rr_prep(batch, Br, P)
                    if kindr == "shared":
                        self.programs["rr_refill_shared"] += 1
                        refill = gen_mod.decoder_refill_slots_shared
                    else:
                        self.programs["rr_refill"] += 1
                        refill = gen_mod.decoder_refill_slots
                    tok, cache, wp, done = refill(self.model, cache, tok, wp, done, *argsr,
                                                  slots, temperature, key)
                if spec:
                    gen_mod.scatter_rows(hist, self._spec_history(kindr, argsr, P + mn_pad),
                                         slots)
                for slot, row_i in zip(use, take):
                    slot_rows[slot], acc[slot] = row_i, []
                live += k
                refills += 1
            if live == 0 and not pending:
                break
        self.refill_stats["sessions"] += 1
        self.refill_stats["refills"] += refills
        self.refill_stats["prefix_kv_hits"] += pre_hits
        self.spec_stats["tokens"] += spec_tokens
        self.spec_stats["rounds"] += spec_rounds
        return out_mat

    def _decode_spec_chunked(self, tok, cache, hist: torch.Tensor, B: int, prompt_len: int,
                             n: int, max_new_tokens: int, chunk_tokens: int,
                             stop_strings: Sequence[str]) -> np.ndarray:
        """Prompt-lookup speculative decoding from a prefilled cache, in
        chunks of ``chunk_tokens // (K+1)`` verify rounds, with the host's
        stop-string checks between chunks: the tokens of
        ``_decode_chunked`` (greedy acceptance), each round yielding 1 to
        K+1 of them, so rows advance unevenly and the host stitches them.
        Without stop strings and with the tokenizer's EOS the model's, chunk
        i+1 is enqueued before chunk i is read back."""
        K = self.spec_lookup
        rounds = max(1, chunk_tokens // (K + 1))
        eos = int(self.cfg.eos_token_id)
        wp = torch.full((B,), prompt_len, dtype=torch.long, device=self.device)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        rows_out: List[List[int]] = [[] for _ in range(B)]
        kept = [0, 0]  # tokens the budget keeps, rounds that kept any

        def stitch(outs_h, counts_h):
            for b in range(n):
                t, r = _spec_stitch(rows_out[b], outs_h[b], counts_h[b], max_new_tokens)
                kept[0] += t
                kept[1] += r

        pipelined = not stop_strings and self.tokenizer.eos_id == eos
        pending = None  # (outs, counts, frozen) of the chunk enqueued last
        while True:
            self.programs["dec_spec_chunk"] += 1
            outs, counts, (tok, cache, hist, wp, done_dev) = gen_mod.decoder_spec_decode_chunk(
                self.model, tok, cache, hist, wp, prompt_len, max_new_tokens, rounds, K, eos,
                done=done)
            if pipelined:
                done = done_dev
                # Every row done or past its budget: later rounds emit
                # nothing (a spent budget alone never sets ``done``).
                frozen = done_dev | (wp - prompt_len >= max_new_tokens)
                prev, pending = pending, (outs, counts, frozen)
                if prev is not None:
                    stitch(prev[0].cpu().numpy(), prev[1].cpu().numpy())
                    if bool(prev[2].all()):
                        break
                continue
            stitch(outs.cpu().numpy(), counts.cpu().numpy())
            newly = self._host_freeze(done_dev.cpu().numpy(), lambda i: rows_out[i], n, B,
                                      max_new_tokens, stop_strings)
            if all(newly):
                break
            done = torch.tensor(newly, dtype=torch.bool, device=self.device)
        if pending is not None:
            stitch(pending[0].cpu().numpy(), pending[1].cpu().numpy())
        self.spec_stats["tokens"] += kept[0]
        self.spec_stats["rounds"] += kept[1]
        out = np.full((n, max_new_tokens), self.tokenizer.pad_id, np.int64)
        for i in range(n):
            row = rows_out[i][:max_new_tokens]
            out[i, :len(row)] = row
        return out

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
