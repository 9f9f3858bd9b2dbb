"""The program under test, built from a configuration file: its model
module filled with the benchmark's weights, and its scoring engine.

The configuration's ``port.kind`` picks the port's model (``t5`` or
``decoder``); the published keys at the file's top level make its config
through the port's own reading of a ``config.json``; ``port.engine`` holds
the engine's options (the precision the configuration states). The weights
go into the module through ``load_state_dict`` under the reference's names.
"""
from __future__ import annotations

from typing import Dict

import torch

from llmrankers_tpu_torch.engine.engine import ScoringEngine
from llmrankers_tpu_torch.engine.tokenizer import ByteTokenizer
from llmrankers_tpu_torch.models.config import DecoderConfig, T5Config
from llmrankers_tpu_torch.models.decoder import Decoder
from llmrankers_tpu_torch.models.t5 import T5

KINDS = {"t5": (T5Config, T5), "decoder": (DecoderConfig, Decoder)}


def engine(conf: Dict, weights: Dict[str, torch.Tensor], tokenizer=None,
           device="cuda", dtype=torch.bfloat16, **overrides) -> ScoringEngine:
    """A ScoringEngine on ``device`` for ``conf`` holding ``weights`` (which
    the caller may free after), its model in ``dtype``. ``overrides``
    replace engine options."""
    kind = conf["port"]["kind"]
    cfg_cls, model_cls = KINDS[kind]
    cfg = cfg_cls.from_hf_config(conf)
    model = model_cls(cfg, dtype=dtype, device=device)
    model.load_state_dict(weights, strict=True)
    opts = {**conf["port"].get("engine", {}), **overrides}
    return ScoringEngine(kind, cfg, model, tokenizer or ByteTokenizer(cfg.vocab_size),
                         device=device, **opts)
