"""Setwise reranking with likelihood scoring on a chat decoder
(``SetwiseLlmRanker`` on a decoder engine: each comparison is one prompt row
in the tokenizer's chat template, ending in ``" Passage:"``, scored by the
label tokens' logits at its last position; each wave of the sorts is one
``engine.score_labels`` call, on shared prompt prefixes and the engine's
prefix-KV cache).

The model ranks by a planted relevance signal, as the T5 driver's does
(``drivers/setwise_likelihood.py``), through a path of the decoder's own;
its sizes are the traffic's ``planted``. Each passage's grade is its first
character (a marker); :func:`plant_relevance` writes into the seed's weights:

- the markers' embeddings carry their grade along one direction, and the
  label tokens' embeddings (the tied head's columns) are the first label's
  plus ``label_lead`` / sqrt(D) along a direction of their own, so only this
  path tells the labels apart;
- layer 0, query head 0: a marker attends evenly to the label tokens before
  it (a query from the grade direction, keys from the labels' shared
  embedding, on RoPE's lowest frequency, which no prompt length turns), and
  the values are such that the mean over labels 0..j is the unit vector u_j
  (label l's value is (l + 1) u_l - l u_(l-1)): a marker of passage j gets
  ``anchor_residual`` sqrt(D) along one direction and ``label_residual``
  sqrt(D) along label j's, the same length for every j;
- layer 1, query head 0: a constant query (its bias) attends to the marker of
  highest grade (keys along the grade direction, ``score_scale`` per unit of
  the normed residual there) and writes ``decoder_residual`` sqrt(D) along
  that passage's label direction of the head.

The best passage then wins by about ``label_lead`` logits, and two passages
of one grade by the smaller margin the rest of the random model gives them;
a call's comparisons follow the grades (heapsort's, about 127 a query).

Kept from the window, per ``score_labels`` call: the rows' real lengths and
their token ids (the work a metric counts, :func:`shared_work`) and, for a
sample of calls drawn from the seed and the call with the longest row, the
first rows of the dispatch, the label
logits the program returned and its logits over the whole vocabulary at
their last position. After the window the reference (``reference/qwen2.py``)
scores those rows in float32 and the comparison reads:

- ``winner_flips``: the comparisons whose winner changes, among those the
  reference decides by half ``label_lead`` or more (a lead that precision
  cannot overturn);
- ``label_rel``: the largest, over the sampled dispatches, of ||program -
  reference|| / ||reference|| of the label logits of the clear rows: decided,
  and their best passage's grade :data:`CLEAR_GRADES` or more above the
  runner-up's. Layer 1's planted head then puts under e^-13 of its weight
  on the runner-up; between closer grades the split it makes moves with
  the rounding of its scores (hundreds in bf16), by up to 2.5 logits in
  sound runs, as far as a lower precision moves a clear row;
- read, not compared: ``label_dev`` (the largest |program - reference| of a
  decided row's label logit), ``decided_share``, ``clear_share``, and
  ``logit_rel``, the
  relative deviation of the logits over the vocabulary (less the markers,
  whose tied-head rows carry the planted grades) at the rows' last
  positions. The planted writes dominate the final residual, so the rest of
  the vocabulary reads the small random part of the hidden state, whose
  relative error swings from seed to seed (0.046-0.188 sound, 0.325-0.453
  under ``int8_weights``, NVIDIA H100): too close to compare.
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.rankers.prompts import CHARACTERS, setwise_prompt

from drivers import setwise_likelihood
from harness import driver, weights

CAPTURE_ROWS = setwise_likelihood.CAPTURE_ROWS
CLEAR_GRADES = 3  # a clear row's best grade over its runner-up's
PASSAGE = re.compile(r'Passage [A-Z]: "(.)')  # a passage's first character: its marker
WARM_QUERIES = 4  # the warm-up call's queries: every program on shared prefixes


class Driver(setwise_likelihood.Driver):
    def reference_weights(self):
        w = driver.Driver.reference_weights(self)
        plant_relevance(w, self.cell.conf, self.cell.mix, self.seed)
        return w

    def instrument(self) -> None:
        super().instrument()
        eng = self.engine
        inner_score, inner_labels = eng.score_labels, eng.model.label_logits
        self._capture = None

        def label_logits(hidden, label_ids):
            if self._capture is not None and not self._capture:
                n = min(CAPTURE_ROWS, hidden.shape[0])
                self._capture.append(eng.model.lm_logits(hidden[:n]).float().cpu())
            return inner_labels(hidden, label_ids)

        def score_labels(rows, label_ids, decoder_prefix=(), **kw):
            k = len(self.work)
            out = inner_score(rows, label_ids, decoder_prefix, **kw)
            if self.recording:
                self.work[-1]["tokens"] = list(rows)  # the rows' ids, for :func:`shared_work`
            if self.recording and k in self.kept:
                kept = self.kept[k]
                n = min(len(rows), kept["encode"][0].shape[0])  # the first dispatch's
                kept["vocab"] = kept.pop("encode")[0][:n]
                kept["rows"] = [list(r) for r in rows[:n]]
            return out

        eng.model.label_logits = label_logits
        eng.score_labels = score_labels

    def warm_up(self) -> None:
        """Every (batch, length) bucket of the plain path (the T5 driver's
        warm-up at the decoder's prompt lengths), then a call of the mix's
        own inputs cut to a few queries (the shared-prefix programs and the
        prefix-KV cache), from the warm-up stream."""
        eng, mix = self.engine, self.cell.mix
        lo, hi = warm_lengths(self.ranker, mix)
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
                    eng.score_labels(rng.integers(2, 258, size=(n, L)).tolist(), labels)
        self.cell.mix = dict(mix, queries_per_call=WARM_QUERIES)
        try:
            self.call(0, stream=driver.WARM_STREAM)
        finally:
            self.cell.mix = mix
        if self.device == "cuda":
            torch.cuda.synchronize()

    def counters(self) -> Dict[str, int]:
        out = super().counters()
        out.update({"pkv." + k: v for k, v in self.engine.pkv_stats.items()})
        return out

    # -- the comparison -----------------------------------------------------
    def check(self) -> Dict[str, float]:
        self.release()
        ref, conf = self.cell.reference(), self.cell.conf
        w = self.reference_weights()
        get = weights.getter(w)
        decided_lead = self.cell.mix["planted"]["label_lead"] / 2
        tok = ByteTokenizer(conf["vocab_size"])
        # The markers' rows of the tied head carry the planted grades (hundreds
        # of logits along one direction): the comparison leaves them out.
        keep = torch.ones(conf["vocab_size"], dtype=torch.bool, device=self.device)
        keep[[tok.encode(c, add_special_tokens=False)[0]
              for c in self.cell.mix["relevance"]["markers"]]] = False
        grade = {m: g for g, m in enumerate(self.cell.mix["relevance"]["markers"])}
        worst = {"label_rel": 0.0, "logit_rel": 0.0, "label_dev": 0.0}
        flips = decided = clear = rows = 0
        with torch.inference_mode():
            for k in sorted(self.kept):
                kept = self.kept[k]
                got_vocab = kept["vocab"].to(self.device)
                got = torch.from_numpy(kept["logits"]).to(self.device)
                labels = torch.tensor(kept["labels"], device=self.device)
                want_vocab = torch.cat([ref.served_logits(get, conf, r, len(r))
                                        for r in kept["rows"]])
                worst["logit_rel"] = max(worst["logit_rel"], float(
                    (got_vocab - want_vocab)[:, keep].norm() / want_vocab[:, keep].norm()))
                diff = norm = 0.0
                for i, r in enumerate(kept["rows"]):
                    grades = sorted(grade[m] for m in PASSAGE.findall(tok.decode(r)))
                    docs = len(grades)
                    want = want_vocab[i, labels[:docs]]
                    top = want.topk(2)
                    rows += 1
                    if float(top.values[0] - top.values[1]) < decided_lead:
                        continue
                    decided += 1
                    flips += int(int(got[i, :docs].argmax()) != int(top.indices[0]))
                    worst["label_dev"] = max(worst["label_dev"], float(
                        (got[i, :docs] - want).abs().max()))
                    if grades[-1] - grades[-2] >= CLEAR_GRADES:
                        clear += 1
                        diff += float((got[i, :docs] - want).square().sum())
                        norm += float(want.square().sum())
                if norm:
                    worst["label_rel"] = max(worst["label_rel"], (diff / norm) ** 0.5)
                driver.free()
        del w
        driver.free()
        return {**worst, "winner_flips": float(flips), "decided_share": decided / max(rows, 1),
                "clear_share": clear / max(rows, 1)}


def shared_work(calls) -> tuple:
    """(positions, causal pairs) of the window's distinct prompt heads: the
    rows of every ``score_labels`` call in ``calls`` (work entries) as one
    trie, each position once however many rows share the head up to it, and
    a position at depth d attending to its d + 1 keys. The least work of a
    causal model that never computes a shared head twice (a prefix-KV cache
    that keeps every head), which the metrics of this cell count."""
    positions = pairs = 0
    prev: tuple = ()
    for row in sorted({tuple(r) for w in calls for r in w["tokens"]}):
        n = next((i for i, (a, b) in enumerate(zip(prev, row)) if a != b),
                 min(len(prev), len(row)))
        positions += len(row) - n
        pairs += (len(row) * (len(row) + 1) - n * (n + 1)) // 2
        prev = row
    return positions, pairs


def warm_lengths(ranker, mix) -> List[int]:
    """The shortest and longest prompt rows (tokens) of the mix, as the
    ranker writes them for a decoder."""
    tok = ranker.engine.tokenizer
    n = mix["ranker"]["num_child"] + 1
    out = []
    for q, p in ((mix["query_tokens"]["min"], mix["passage_tokens"]["min"]),
                 (min(mix["query_tokens"]["max"] + 8, mix["query_length"]),
                  min(mix["passage_tokens"]["max"], mix["passage_length"]))):
        text = tok.apply_chat_template(
            [{"role": "user", "content": setwise_prompt("q" * q, ["p" * p] * n)}]) + " Passage:"
        out.append(len(tok.encode(text, add_special_tokens=True)))
    return out


def plant_relevance(w: Dict[str, torch.Tensor], conf: Dict, mix: Dict, seed: int
                    ) -> Dict[str, torch.Tensor]:
    """Write the relevance path of the module docstring into ``w`` (the
    configuration's weights, in place); returns the directions it wrote
    along (orthonormal, drawn from the seed)."""
    pl = mix["planted"]
    D, H = conf["hidden_size"], conf["num_attention_heads"]
    Dh = conf.get("head_dim") or D // H
    tok = ByteTokenizer(conf["vocab_size"])
    labels = [tok.encode(f"Passage {c}", add_special_tokens=False)[-1]
              for c in CHARACTERS[: mix["ranker"]["num_child"] + 1]]
    markers = [tok.encode(c, add_special_tokens=False)[0] for c in mix["relevance"]["markers"]]
    n, emb, sq = len(labels), w["embed"], D ** 0.5
    dev = emb.device
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) + 0x5EED) % 2**63)
    first = emb[labels[0]].float().clone()
    unit = lambda x: x / x.norm()  # noqa: E731
    # Directions orthonormal to each other and to the first label's embedding,
    # so every label token reads alike along it.
    basis = torch.cat([unit(first)[:, None],
                       torch.randn(D, 2 + 2 * n, generator=gen, device=dev)], dim=1)
    dirs = torch.linalg.qr(basis)[0].T[1:]
    grade_dir, anchor_dir, label_dir, out_dir = dirs[0], dirs[1], dirs[2:2 + n], dirs[2 + n:]
    lowest = Dh // 2 - 1  # RoPE's lowest frequency pairs dims lowest and Dh - 1

    # Embeddings: grades along grade_dir; labels the first label's plus their
    # own out_dir, so a winner's out_dir component in the final hidden sets
    # its lead.
    for g, m in enumerate(markers):
        c = (pl["grade_low"] + g * pl["grade_step"]) * pl["anchor_residual"]
        emb[m] += (c * grade_dir).to(emb.dtype)
    for lab, d in zip(labels, out_dir):
        emb[lab] = (first + (pl["label_lead"] / sq) * d).to(emb.dtype)
    # The normed residual's reading at a label token: along the shared
    # first label (``shared``) and along its own direction (``own``).
    e = (first + (pl["label_lead"] / sq) * out_dir[0]).norm()
    shared, own = sq * first.norm() / e, sq * (pl["label_lead"] / sq) / e

    def head(layer):
        """Layer ``layer``'s query head 0 and KV head 0, cleared: its query
        reads nothing, its key and value only what is planted below."""
        p = f"layers.{layer}."
        w[p + "wq"][:, :Dh] = 0
        w[p + "bq"][:Dh] = 0
        w[p + "wk"][:, [lowest, Dh - 1]] = 0
        w[p + "bk"][[lowest, Dh - 1]] = 0
        w[p + "wv"][:, : n + 1] = 0
        w[p + "bv"][: n + 1] = 0
        w[p + "wo"][:Dh, :] = 0
        return p

    # Hop 1 (layer 0): markers attend evenly to the labels before them.
    p = head(0)
    qk = (pl["hop1_score"] * Dh ** 0.5 / (sq * shared)) ** 0.5
    w[p + "wq"][:, lowest] = (qk * grade_dir).to(emb.dtype)
    w[p + "wk"][:, lowest] = (qk * unit(first)).to(emb.dtype)
    u = torch.eye(n, device=dev)
    vals = [(l + 1) * u[l] - l * u[l - 1] if l else u[0] for l in range(n)]  # label l's value
    w[p + "wv"][:, :n] = (sum(torch.outer(out_dir[l], vals[l]) for l in range(n)) / own
                          ).to(emb.dtype)
    w[p + "wv"][:, n] = (unit(first) / shared).to(emb.dtype)  # 1 at every label
    w[p + "wo"][:n, :] = (pl["label_residual"] * sq * label_dir).to(emb.dtype)
    w[p + "wo"][n, :] = (pl["anchor_residual"] * sq * anchor_dir).to(emb.dtype)
    # Hop 2 (layer 1): a constant query; keys read the grade.
    p = head(1)
    w[p + "bq"][lowest] = 1.0
    w[p + "wk"][:, lowest] = (pl["score_scale"] * Dh ** 0.5 * grade_dir).to(emb.dtype)
    # A marker's normed residual holds sqrt(D) label_residual / |residual|
    # along its label's direction, |residual| about sqrt(D) times the norm of
    # (anchor, label, grade) residuals.
    norm = (pl["anchor_residual"] ** 2 + pl["label_residual"] ** 2) ** 0.5
    read = pl["label_residual"] / norm * sq
    w[p + "wv"][:, :n] = label_dir.T.to(emb.dtype)
    w[p + "wo"][:n, :] = (pl["decoder_residual"] * sq / read * out_dir).to(emb.dtype)
    return {"grade": grade_dir, "anchor": anchor_dir, "label": label_dir, "out": out_dir}
