"""Host-side tokenizers: counterpart of ``llmrankers_tpu/engine/tokenizer.py``.

Tokenization is host work, so the port keeps the same classes: the
``Tokenizer`` interface, the deterministic ``ByteTokenizer`` that tests and
benchmarks use with no network, and ``HFTokenizer``, which imports
``transformers`` only when one is built from a local tokenizer directory.
Chat templates serve the decoder-only models and come with them (ROADMAP
A7). (``llmrankers_tpu.engine``'s package init imports the JAX engine, so
this module is a copy, not an import.)
"""
from __future__ import annotations

from typing import List, Sequence


class Tokenizer:
    """Minimal interface used by the scoring engine."""

    pad_id: int
    eos_id: int
    vocab_size: int

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        raise NotImplementedError

    def truncate(self, text: str, length: int) -> str:
        raise NotImplementedError


class HFTokenizer(Tokenizer):
    """Wraps a local HF tokenizer directory (no network)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tk = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.pad_id = self.tk.pad_token_id if self.tk.pad_token_id is not None else 0
        self.eos_id = self.tk.eos_token_id if self.tk.eos_token_id is not None else 1
        self.vocab_size = len(self.tk)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self.tk.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self.tk.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def truncate(self, text: str, length: int) -> str:
        return self.tk.convert_tokens_to_string(self.tk.tokenize(text)[:length])


class ByteTokenizer(Tokenizer):
    """Deterministic reversible byte tokenizer for tests and benchmarks.

    T5 conventions: id 0 = <pad>, id 1 = </s>, bytes at id 2..257. Words are
    not merged, so the 'A'..'W' labels are single distinguishable tokens.
    """

    OFFSET = 2

    def __init__(self, vocab_size: int = 512):
        if vocab_size < 256 + self.OFFSET:
            raise ValueError(f"vocab_size {vocab_size} < {256 + self.OFFSET}")
        self.pad_id = 0
        self.eos_id = 1
        self.vocab_size = vocab_size

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        # "<pad>" prefix convention used by T5-style decoder prompts.
        ids: List[int] = []
        rest = text
        while rest.startswith("<pad>"):
            ids.append(self.pad_id)
            rest = rest[5:].lstrip(" ") if rest[5:6] == " " else rest[5:]
        ids.extend(b + self.OFFSET for b in rest.encode("utf-8"))
        if add_special_tokens:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for i in ids:
            if self.OFFSET <= i < 256 + self.OFFSET:
                out.append(i - self.OFFSET)
            elif not skip_special_tokens:
                out.extend(b"<pad>" if i == self.pad_id else b"</s>")
        return out.decode("utf-8", errors="ignore")

    def truncate(self, text: str, length: int) -> str:
        return text.encode("utf-8")[:length].decode("utf-8", errors="ignore")
