"""The ranker planted in the T5 configuration's weights: on prompts of the
traffic, the reference's label logits pick the passage of highest grade,
by about the configuration's ``label_lead`` where the grades differ; the
planted path reads the marker, not the passage's place."""
import numpy as np
import torch

from drivers import setwise_likelihood as sl
from harness import traffic, weights
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.rankers.prompts import setwise_prompt
from reference import t5
from tiny_cells import tiny

SEED = 2**31 + 29


def _scores(cell, docs_sets, query):
    conf, mix = cell.conf, cell.mix
    w = weights.make(t5.param_specs(conf), SEED, device="cpu")
    sl.plant_relevance(w, conf, mix, SEED)
    get = weights.getter(w)
    tok = ByteTokenizer(conf["vocab_size"])
    rows = [tok.encode(setwise_prompt(query, docs)) for docs in docs_sets]
    L = max(map(len, rows))
    ids = torch.zeros(len(rows), L, dtype=torch.long)
    mask = torch.zeros(len(rows), L, dtype=torch.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)], mask[i, :len(r)] = torch.tensor(r), 1
    with torch.inference_mode():
        enc = t5.encode(get, conf, ids, mask, ids.numel())
        prefix = tok.encode("<pad> Passage", add_special_tokens=False)
        return t5.label_logits(get, conf, enc, mask, ids.numel(), len(rows), prefix,
                               sl.label_ids(conf, mix)).numpy()


def test_the_planted_ranker_picks_the_highest_grade():
    cell = tiny("t5xl-w8a8.heap-q16")
    marks = cell.mix["relevance"]["markers"]
    queries, lists = traffic.call_inputs(dict(cell.mix, docs_per_query=9), SEED, 0)
    texts = [t for _, t in lists[0]]
    rng = np.random.default_rng(0)
    sets, grades = [], []
    for _ in range(8):
        # grades apart as far as the tiny mix's ten passages (32 grades
        # over 10) are; the full-size cell's near grades are read on the card
        g = rng.choice(np.arange(0, len(marks), 4), size=3, replace=False)
        sets.append([marks[x] + texts[i][1:] for i, x in enumerate(g)])
        grades.append(g)
    # the same passages again, each with the grade moved to another place
    for g, docs in list(zip(grades, sets))[:4]:
        sets.append(docs[1:] + docs[:1])
        grades.append(np.roll(g, -1))
    logits = _scores(cell, sets, queries[0])
    lead = cell.conf["relevance_head"]["label_lead"]
    for g, row in zip(grades, logits):
        assert int(np.argmax(row)) == int(np.argmax(g)), (g, row)
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] > lead / 2, (g, row)
