"""Host-side tokenizers: counterpart of ``llmrankers_tpu/engine/tokenizer.py``.

Tokenization is host work, so the port keeps the same classes: the
``Tokenizer`` interface, the deterministic ``ByteTokenizer`` that tests and
benchmarks use with no network, and ``HFTokenizer``, which imports
``transformers`` only when one is built from a local tokenizer directory.
``apply_chat_template`` wraps the decoder-only models' prompts; Vicuna v1.5
ships no chat template, so ``HFTokenizer`` installs ``VICUNA_CHAT_TEMPLATE``
for it, as the reference does.
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

    def apply_chat_template(
        self, messages: List[dict], add_generation_prompt: bool = True
    ) -> str:
        raise NotImplementedError


VICUNA_CHAT_TEMPLATE = (
    "{% if messages[0]['role'] == 'system' %}{% set loop_messages = messages[1:] %}"
    "{% set system_message = messages[0]['content'] %}{% else %}"
    "{% set loop_messages = messages %}{% set system_message = 'A chat between a "
    "curious user and an artificial intelligence assistant. The assistant gives "
    "helpful, detailed, and polite answers to the user\\'s questions.' %}{% endif %}"
    "{% for message in loop_messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate user/assistant/...') }}"
    "{% endif %}{% if loop.index0 == 0 %}{{ system_message }}{% endif %}"
    "{% if message['role'] == 'user' %}{{ ' USER: ' + message['content'].strip() }}"
    "{% elif message['role'] == 'assistant' %}"
    "{{ ' ASSISTANT: ' + message['content'].strip() + eos_token }}{% endif %}"
    "{% endfor %}{% if add_generation_prompt %}{{ ' ASSISTANT:' }}{% endif %}"
)


class HFTokenizer(Tokenizer):
    """Wraps a local HF tokenizer directory (no network)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tk = AutoTokenizer.from_pretrained(path, local_files_only=True)
        # Vicuna v1.5 ships no chat template; the reference installs one.
        if "vicuna" in path and "v1.5" in path:
            self.tk.chat_template = VICUNA_CHAT_TEMPLATE
        self.pad_id = self.tk.pad_token_id if self.tk.pad_token_id is not None else 0
        self.eos_id = self.tk.eos_token_id if self.tk.eos_token_id is not None else 1
        self.vocab_size = len(self.tk)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self.tk.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self.tk.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def truncate(self, text: str, length: int) -> str:
        return self.tk.convert_tokens_to_string(self.tk.tokenize(text)[:length])

    def apply_chat_template(
        self, messages: List[dict], add_generation_prompt: bool = True
    ) -> str:
        return self.tk.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=add_generation_prompt
        )


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

    def apply_chat_template(
        self, messages: List[dict], add_generation_prompt: bool = True
    ) -> str:
        parts = [f"<|{m['role']}|>\n{m['content']}\n" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "".join(parts)
