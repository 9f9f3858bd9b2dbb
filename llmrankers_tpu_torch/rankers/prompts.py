"""Setwise prompt construction: counterpart of ``llmrankers_tpu/rankers/prompts.py``.

The prompt string is a behavioural contract, reproduced verbatim from the
reference so that identical models produce identical scores. Only the setwise
prompt is here; the other rankers' prompts come with their rankers.
(``llmrankers_tpu.rankers``'s package init imports every JAX ranker, so this
module is a copy, not an import.)
"""
from __future__ import annotations

from typing import Optional, Sequence

# Single-token passage labels; X/Y/Z excluded because they tokenize to
# multiple pieces under the T5 vocabulary.
CHARACTERS = [
    "A", "B", "C", "D", "E", "F", "G", "H", "I", "J", "K", "L", "M",
    "N", "O", "P", "Q", "R", "S", "T", "U", "V", "W",
]


def setwise_prompt(query: str, doc_texts: Sequence[str],
                   labels: Optional[Sequence[str]] = None) -> str:
    labels = labels or CHARACTERS
    passages = "\n\n".join(
        f'Passage {labels[i]}: "{t}"' for i, t in enumerate(doc_texts)
    )
    return (
        f'Given a query "{query}", which of the following passages is the most '
        "relevant one to the query?\n\n"
        + passages
        + "\n\nOutput only the passage label of the most relevant passage:"
    )
