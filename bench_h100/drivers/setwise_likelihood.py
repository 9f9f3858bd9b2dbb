"""Setwise reranking with likelihood scoring (``SetwiseLlmRanker``, as the
CLI builds it): each comparison is one prompt row, and each wave of the
sorts is one ``engine.score_labels`` call.

The model ranks by a planted relevance signal. Random weights favour one
label throughout, which one by the seed, and that alone moved a call's work
by three times; a trained ranker's work follows relevance instead. So the
traffic writes each passage's grade as its first character (a marker,
``harness/traffic.py``), and :func:`plant_relevance` writes into the
configuration's weights a path that reads it: one encoder head copies the
label (``A``, ``B``, ...) in front of each marker into the marker's
position, the markers' embeddings carry their grade along one direction,
one head of the decoder's first cross-attention attends to the marker of
highest grade and carries its label to the output head, and each label's
``lm_head`` column is the first label's plus its own direction. The best
passage then wins by a wide margin, and two passages of one grade by the
smaller margin that the rest of the random model gives them.

Kept from the window, per ``score_labels`` call: the rows' real lengths
(the work a metric counts), and for a sample of calls drawn from the seed
and for the call with the longest row, the label logits the program
returned for the first rows of the dispatch and their encoder output. After
the window the reference scores those same rows (on T5; a decoder-only
cell of this mix needs a check of its own) and the comparison reads:

- ``enc_rel``: the largest, over the sampled dispatches, of
  ||program - reference|| / ||reference|| of the encoder output at the
  rows' real positions;
- ``winner_flips``: the comparisons whose winner (the label of highest
  logit among the row's passages) differs between program and reference,
  among those the reference decides by half the configuration's
  ``label_lead`` or more (a lead that precision cannot overturn);
- ``label_dev``: the largest |program - reference| of a label logit of a
  passage of those decided rows;
- read, not compared: ``decided_share``, the share of rows so decided, and
  ``label_dev_all``, ``label_dev`` over every row. Where two passages are
  near a tie for the best, the attention that picks between them splits,
  and how it splits moves both their logits by far more than precision
  moves a decided row's.
"""
from __future__ import annotations

import random
from typing import Dict, List

import numpy as np
import torch

from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.rankers.prompts import CHARACTERS, setwise_prompt
from llmrankers_tpu_torch.rankers.setwise import SetwiseLlmRanker

from harness import driver, weights

SAMPLE_WAVES = 4  # drawn from the first DRAW_FROM score_labels calls (waves)
DRAW_FROM = 15  # the first waves of a call (heap-q16's build phase and first pops), so
#                 a window of one call compares as many as a run
CAPTURE_ROWS = 16  # rows of a sampled dispatch that the check compares
SCORING = ("t5_labels", "dec_labels", "dec_labels_shared", "dec_labels_pre")


class Driver(driver.Driver):
    def reference_weights(self):
        w = super().reference_weights()
        if "relevance_head" in self.cell.conf:
            plant_relevance(w, self.cell.conf, self.cell.mix, self.seed)
        return w

    def make_ranker(self):
        return SetwiseLlmRanker(self.engine, **self.cell.mix["ranker"])

    def instrument(self) -> None:
        rng = random.Random(self.seed)
        self.sample = set(rng.sample(range(DRAW_FROM), SAMPLE_WAVES))
        self.kept: Dict[int, Dict] = {}  # score_labels call index -> what the check reads
        self.longest = (-1, None)  # (longest row, call index)
        eng = self.engine
        inner_score, self._capture = eng.score_labels, None
        if eng.kind == "t5":
            inner_encode = eng.model.encode

            def encode(ids, mask):
                out = inner_encode(ids, mask)
                if self._capture is not None and not self._capture:
                    r = min(CAPTURE_ROWS, ids.shape[0])
                    self._capture.append((ids[:r], mask[:r], out[:r].clone(), ids.shape))
                return out

            eng.model.encode = encode

        def score_labels(rows, label_ids, decoder_prefix=(), **kw):
            if not self.recording:
                return inner_score(rows, label_ids, decoder_prefix, **kw)
            k, top = len(self.work), max(len(r) for r in rows)
            keep = k in self.sample or top > self.longest[0]
            self._capture = [] if keep else None
            with self.spans.span("engine.score_labels"):
                out = inner_score(rows, label_ids, decoder_prefix, **kw)
            self.work.append({"op": "score_labels", "rows": [len(r) for r in rows],
                              "prefix": len(decoder_prefix), "labels": len(label_ids)})
            if keep:
                n = min(CAPTURE_ROWS, len(rows))
                self.kept[k] = {"labels": list(label_ids), "prefix": list(decoder_prefix),
                                "logits": out[:n].copy(), "encode": self._capture}
                if top > self.longest[0]:
                    old = self.longest[1]
                    self.longest = (top, k)
                    if old is not None and old not in self.sample:
                        del self.kept[old]
            self._capture = None
            return out

        eng.score_labels = score_labels

    def warm_up(self) -> None:
        """Every (batch, length) bucket the mix can dispatch: prompts at
        the shortest and longest lengths its sizes allow and at each rung of
        the engine's length ladder between, each at every batch bucket up to
        the rows of one dispatch (a larger wave is split into dispatches of
        those sizes) and to a wave's most rows."""
        eng, mix = self.engine, self.cell.mix
        lo, hi = prompt_range(self.ranker, mix)
        lengths = sorted({lo, hi} | {b for b in eng.len_buckets if lo < b < hi})
        most = mix["queries_per_call"] * mix["docs_per_query"] // mix["ranker"]["num_child"]
        labels = self.ranker.label_ids[: mix["ranker"]["num_child"] + 1]
        rng = np.random.default_rng([self.seed, driver.WARM_STREAM])
        with torch.inference_mode():
            for L in lengths:
                padded = min((b for b in eng.len_buckets if b >= L), default=L)
                top = min(eng.max_batch_tokens // padded, most)
                for n in eng.batch_buckets:
                    if n > max(top, eng.batch_buckets[0]):
                        break
                    rows = rng.integers(2, 258, size=(n, L)).tolist()
                    eng.score_labels(rows, labels, self.ranker.decoder_prefix)
        if self.device == "cuda":
            torch.cuda.synchronize()

    def counters(self) -> Dict[str, int]:
        out = super().counters()
        out["scoring_dispatches"] = sum(self.engine.programs[p] for p in SCORING)
        return out

    # -- the comparison -----------------------------------------------------
    def check(self) -> Dict[str, float]:
        """With a control of ``reference_bits``, the reference at those bits
        stands in the program's place and is judged as the program is."""
        if self.cell.conf["port"]["kind"] != "t5":
            raise NotImplementedError("the label check of a decoder-only cell of this mix")
        self.release()
        ref, conf = self.cell.reference(), self.cell.conf
        w = self.reference_weights()
        get = weights.getter(w)
        bits = self.control.get("reference_bits")
        tok = ByteTokenizer(conf["vocab_size"])
        decided_lead = conf["relevance_head"]["label_lead"] / 2
        worst = {"enc_rel": 0.0, "label_dev": 0.0, "label_dev_all": 0.0}
        flips = decided = rows = 0
        with torch.inference_mode():
            for k in sorted(self.kept):
                kept = self.kept[k]
                got = torch.from_numpy(kept["logits"]).to(self.device)
                nums = _t5(ref, get, conf, kept, got, bits, tok, decided_lead)
                for name in worst:
                    worst[name] = max(worst[name], nums[name])
                flips += nums["flips"]
                decided += nums["decided"]
                rows += nums["rows"]
                driver.free()
        del w
        driver.free()
        return {**worst, "winner_flips": float(flips),
                "decided_share": decided / max(rows, 1)}


def _t5(ref, get, conf, kept, got_logits, bits, tok, decided_lead) -> Dict[str, float]:
    """One sampled dispatch: the program's encoder output and label logits
    (or, with ``bits``, the reference's at those bits) against the
    reference's at the configuration's precision."""
    ids, mask, got_enc, shape = kept["encode"][0]
    B, L = shape
    n = got_logits.shape[0]
    ids, mask, got_enc = ids[:n].long(), mask[:n], got_enc[:n]
    real = int(mask.sum(1).max())
    ids, mask, got_enc = ids[:, :real], mask[:, :real], got_enc[:, :real].float()
    valid = mask.bool()

    def side(b):
        enc = ref.encode(get, conf, ids, mask, B * L, bits=b)
        return enc, ref.label_logits(get, conf, enc, mask, B * L, B, kept["prefix"],
                                     kept["labels"], bits=b)

    want_enc, want = side(8)
    if bits is not None:
        got_enc, got_logits = side(bits)
    out = {"enc_rel": float((got_enc[valid] - want_enc[valid]).norm()
                            / want_enc[valid].norm()),
           "label_dev": 0.0, "label_dev_all": 0.0, "flips": 0, "decided": 0, "rows": n}
    for i in range(n):
        docs = tok.decode(ids[i].tolist()).count("Passage ")
        top = want[i, :docs].topk(2)
        dev = float((got_logits[i, :docs] - want[i, :docs]).abs().max())
        out["label_dev_all"] = max(out["label_dev_all"], dev)
        if float(top.values[0] - top.values[1]) >= decided_lead:
            out["decided"] += 1
            out["flips"] += int(int(got_logits[i, :docs].argmax()) != int(top.indices[0]))
            out["label_dev"] = max(out["label_dev"], dev)
    return out


def plant_relevance(w: Dict[str, torch.Tensor], conf: Dict, mix: Dict, seed: int
                    ) -> Dict[str, torch.Tensor]:
    """Write the relevance path of the module docstring into ``w`` (the
    configuration's weights, in place); returns the directions it wrote
    along (orthonormal, drawn from the seed). Its sizes come from the
    configuration's ``relevance_head``."""
    rh, D, dkv = conf["relevance_head"], conf["d_model"], conf["d_kv"]
    tok = ByteTokenizer(conf["vocab_size"])
    labels = label_ids(conf, mix)
    markers = [tok.encode(c, add_special_tokens=False)[0] for c in mix["relevance"]["markers"]]
    last = tok.encode("<pad> Passage", add_special_tokens=False)[-1]
    n, dev, sq = len(labels), w["shared"].device, D ** 0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) + 0x5EED) % 2**63)

    def orthonormal(dim, k):
        return torch.linalg.qr(torch.randn(dim, k, generator=gen, device=dev))[0].T

    dirs = orthonormal(D, 1 + 2 * n)
    grade_dir, label_dir, out_dir = dirs[0], dirs[1:1 + n], dirs[1 + n:]
    hd = orthonormal(dkv, 2 * n + 1)
    enc_v, dec_qk, dec_v = hd[:n], hd[n], hd[n + 1:]
    h = slice(rh["head"] * dkv, (rh["head"] + 1) * dkv)
    emb = w["shared"].float()
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)  # noqa: E731

    # Encoder: head ``head`` attends ``offset`` tokens back (from each
    # marker to its label), in every layer, since the stack shares its
    # bias table; in the first layer it writes the label's direction,
    # ``label_residual`` * sqrt(D) long, into the marker's residual.
    rel = torch.tensor([-rh["offset"]], device=dev)
    bucket = int(bucket_of(rel, conf))
    w["encoder.rel_bias"][bucket, rh["head"]] = rh["offset_bias"]
    value = 0.5  # the head's output at a marker, in units of sqrt(D)
    w["encoder.layers.0.v"][:, h] = value * unit(emb[labels]).T @ enc_v
    w["encoder.layers.0.o"][h, :] = (rh["label_residual"] / value) * enc_v.T @ label_dir
    # Grades: the encoder's output is RMS-normed, and a marker's residual
    # is about label_residual * sqrt(D) long, so a component c along
    # grade_dir reads about c / label_residual there: grade g's marker
    # carries (grade_low + g * grade_step) * label_residual.
    for g, m in enumerate(markers):
        c = (rh["grade_low"] + g * rh["grade_step"]) * rh["label_residual"]
        w["shared"][m] += (c * grade_dir).to(w["shared"].dtype)
    # Decoder, first layer, cross-attention head ``head``: a query that the
    # prefix's last token makes, keys along grade_dir (score_scale per unit
    # of the encoder output there), values along the label directions, an
    # output ``decoder_residual`` * sqrt(D) long along the label's out_dir.
    qk = (rh["score_scale"] / sq) ** 0.5
    w["decoder.layers.0.cq"][:, h] = qk * torch.outer(unit(emb[last]), dec_qk)
    w["decoder.layers.0.ck"][:, h] = qk * torch.outer(grade_dir, dec_qk)
    carry = 0.25  # the head's value per unit of the label direction
    w["decoder.layers.0.cv"][:, h] = carry * label_dir.T @ dec_v
    w["decoder.layers.0.co"][h, :] = (rh["decoder_residual"] / carry) * dec_v.T @ out_dir
    # The output head: each label's column is the first label's plus its
    # own direction, so only the planted path tells the labels apart; the
    # final norm leaves about sqrt(D) of the output along out_dir, so a
    # winner leads by about label_lead logits.
    head = w["lm_head"]
    first = head[:, labels[0]].float()
    for lab, d in zip(labels, out_dir):
        head[:, lab] = (first + (rh["label_lead"] / sq) * d).to(head.dtype)
    return {"grade": grade_dir, "label": label_dir, "out": out_dir}


def bucket_of(rel: torch.Tensor, conf: Dict) -> torch.Tensor:
    """The encoder's relative-position bucket of ``rel`` (key - query)."""
    from reference.t5 import _bucket

    return _bucket(rel, True, conf["relative_attention_num_buckets"],
                   conf["relative_attention_max_distance"])


def label_ids(conf, mix) -> List[int]:
    """The label tokens the setwise ranker scores on T5 (its ``label_ids``),
    from the byte tokenizer the engine gets."""
    tok = ByteTokenizer(conf["vocab_size"])
    return [tok.encode(f"<pad> Passage {c}", add_special_tokens=False)[-1]
            for c in CHARACTERS[: mix["ranker"]["num_child"] + 1]]


def prompt_range(ranker, mix) -> List[int]:
    """The shortest and longest prompt rows (tokens) the mix can make: a
    comparison of num_child + 1 passages at the shortest and longest
    lengths, under the shortest and longest query."""
    tok = ranker.engine.tokenizer
    n = mix["ranker"]["num_child"] + 1
    out = []
    for q, p in ((mix["query_tokens"]["min"], mix["passage_tokens"]["min"]),
                 (min(mix["query_tokens"]["max"] + 8, mix["query_length"]),
                  min(mix["passage_tokens"]["max"], mix["passage_length"]))):
        out.append(len(_row(ranker, "q" * q, ["p" * p] * n)))
    return out


def _row(ranker, query: str, docs: List[str]) -> List[int]:
    """The token row of one comparison, as the ranker writes it on T5."""
    return ranker.engine.tokenizer.encode(setwise_prompt(query, docs), add_special_tokens=True)
