"""Model architecture configs.

Covers the two model families the reference drives through HF transformers:
T5 encoder-decoder (flan-t5-*, monoT5, duoT5 — pointwise.py:19-26,
setwise.py:40-59) and decoder-only chat models (Llama/Vicuna/Qwen —
setwise.py:60-71, Rank-R1/run_setwise.py:95-132). Configs are frozen
dataclasses so they can key jit caches.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    num_layers: int = 8
    num_decoder_layers: int = 8
    num_heads: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"  # flan-t5 / t5-v1.1; "relu" = t5-v1.0
    tie_word_embeddings: bool = False
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    # Route attention through the Pallas flash kernel (set by the engine
    # on TPU; static jit-cache key, so it lives on the config).
    use_flash: bool = False
    # Mesh for shard_map'd flash under TP/DP (hashable; set by the engine
    # alongside use_flash when the mesh spans >1 device).
    flash_mesh: Optional[Any] = None
    # Route quantized matmul sites through the Pallas W8A8 int8-MXU
    # kernel (set by the engine for single-device TPU when
    # quantize='int8'; multi-device GSPMD uses the w8a16 dequant path).
    int8_kernel: bool = False

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated")

    @property
    def act_fn(self) -> str:
        # HF encodes "gated-gelu" meaning gelu_new.
        if "gelu" in self.feed_forward_proj:
            return "gelu_new"
        return "relu"

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "T5Config":
        return cls(
            vocab_size=vocab_size, d_model=64, d_kv=16, d_ff=128,
            num_layers=2, num_decoder_layers=2, num_heads=4,
        )

    # Published shapes for the reference's headline models (flan-t5-large is
    # the README benchmark model, flan-t5-xl the north-star perf target).
    @classmethod
    def flan_t5_large(cls) -> "T5Config":
        return cls(d_model=1024, d_kv=64, d_ff=2816, num_layers=24,
                   num_decoder_layers=24, num_heads=16)

    @classmethod
    def flan_t5_xl(cls) -> "T5Config":
        return cls(d_model=2048, d_kv=64, d_ff=5120, num_layers=24,
                   num_decoder_layers=24, num_heads=32)

    @classmethod
    def from_hf_config(cls, d: dict) -> "T5Config":
        return cls(
            vocab_size=d["vocab_size"],
            d_model=d["d_model"],
            d_kv=d["d_kv"],
            d_ff=d["d_ff"],
            num_layers=d["num_layers"],
            num_decoder_layers=d.get("num_decoder_layers", d["num_layers"]),
            num_heads=d["num_heads"],
            relative_attention_num_buckets=d.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=d.get("relative_attention_max_distance", 128),
            layer_norm_epsilon=d.get("layer_norm_epsilon", 1e-6),
            feed_forward_proj=d.get("feed_forward_proj", "relu"),
            tie_word_embeddings=d.get("tie_word_embeddings", True),
            pad_token_id=d.get("pad_token_id", 0),
            eos_token_id=d.get("eos_token_id", 1),
            decoder_start_token_id=d.get("decoder_start_token_id", 0),
        )


@dataclass(frozen=True)
class DecoderConfig:
    """Decoder-only transformer: RoPE + RMSNorm + GQA + SwiGLU.

    Subsumes Llama (no qkv bias), Qwen2 (qkv bias), and Qwen3 (q/k norm) —
    the model families the reference's setwise/pairwise/listwise Llama
    paths and Rank-R1's vLLM path serve.
    """

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None  # defaults to hidden/heads; Qwen3 sets it
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    attention_bias: bool = False  # True for Qwen2
    qk_norm: bool = False  # True for Qwen3
    # Mistral sliding-window attention (HF config `sliding_window`): each
    # token attends to at most the previous `sliding_window` positions.
    # None = full causal attention (Llama/Qwen default; Mistral v0.2+
    # ships null here). Masking is position-based and statically skipped
    # whenever the sequence fits inside the window, so short rerank
    # prompts keep the exact same compiled programs.
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False
    pad_token_id: int = 0
    eos_token_id: int = 2
    bos_token_id: int = 1
    use_flash: bool = False
    flash_mesh: Optional[Any] = None  # see T5Config.flash_mesh
    # Quantized KV cache: None | 'int8' | 'int4'. int8 stores
    # per-(position, kv-head) scales and halves the cache HBM stream
    # during decode plus the per-row cache footprint; int4 packs two
    # nibbles per byte in planar layout (dims d and d+Dh/2 share a
    # byte) with per-(position, kv-head, half) scales and quarters the
    # stream. Set by the engine via kv_quantize=. All sites truthiness-
    # test this field, so the old bool semantics still hold.
    kv_quant: Optional[str] = None
    # Route int4-packed matmul sites through the Pallas W4A8 kernel
    # (set by the engine for single-device TPU when quantize='int4';
    # multi-device GSPMD uses the XLA unpack path). See
    # ops/int4_matmul.py.
    int4_kernel: bool = False
    # Route large-M int8 matmul sites (prefill) through the Pallas W8A8
    # kernel (set by the engine for single-device TPU when
    # quantize='int8'); decode's small-M steps stay on the fused
    # w8a16 dequant. See ops/int8_matmul.py and quant.qmm.
    int8_kernel: bool = False
    # Route the one-token decode step's attention against a QUANTIZED
    # KV cache through the fused Pallas kernel (opt-in via
    # LLMRANKERS_KVQ_KERNEL=1 on single-device TPU): one pass over the
    # packed cache instead of XLA's separate qk/pv reads. Measured
    # slower than the XLA path inside the full decode loop this round
    # (engine.py gate comment has the numbers), so off by default.
    kvq_kernel: bool = False

    @property
    def qkernels(self) -> bool:
        """Pallas quantized-matmul kernels allowed (single-chip TPU)."""
        return self.int4_kernel or self.int8_kernel

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, vocab_size: int = 512, qk_norm: bool = False,
             attention_bias: bool = False) -> "DecoderConfig":
        return cls(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            qk_norm=qk_norm, attention_bias=attention_bias,
        )

    @classmethod
    def qwen25_3b(cls) -> "DecoderConfig":
        # Rank-R1's GRPO v0.1 base model (Rank-R1/train_grpo.py:26).
        return cls(
            vocab_size=151936, hidden_size=2048, intermediate_size=11008,
            num_hidden_layers=36, num_attention_heads=16, num_key_value_heads=2,
            rms_norm_eps=1e-6, rope_theta=1000000.0, attention_bias=True,
            max_position_embeddings=32768, tie_word_embeddings=True,
            eos_token_id=151645,
        )

    @classmethod
    def from_hf_config(cls, d: dict) -> "DecoderConfig":
        mt = d.get("model_type", "llama")
        eos = d.get("eos_token_id", 2)
        if isinstance(eos, list):
            eos = eos[0]
        # Sliding window: Mistral enables it whenever the config carries a
        # non-null value; Qwen2 carries the field but gates it behind
        # `use_sliding_window` (default off).
        sw = d.get("sliding_window")
        if mt == "qwen2" and not d.get("use_sliding_window", False):
            sw = None
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            head_dim=d.get("head_dim"),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            attention_bias=d.get("attention_bias", mt == "qwen2"),
            qk_norm=mt == "qwen3",
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            pad_token_id=d.get("pad_token_id") or 0,
            eos_token_id=eos,
            bos_token_id=d.get("bos_token_id") or 1,
            sliding_window=sw,
        )


def load_hf_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Layer types, per-type RoPE and routed experts (the port's own; everything
# above is the JAX package's module)
#
# The port's ``DecoderConfig`` extends the one above with what a model whose
# layers differ needs: the attention type of each layer (``layer_types``:
# ``"sliding_attention"`` takes ``sliding_window``, ``"full_attention"``
# none), the MLP type of each layer (``mlp_layer_types``: ``"sparse"`` is a
# routed-expert layer), RoPE parameters per attention type, and the experts'
# sizes. Every new field defaults to what leaves today's models unchanged:
# without ``layer_types`` every layer takes ``sliding_window`` as before, and
# without ``rope_parameters`` every layer takes default RoPE at ``rope_theta``.
# ``from_hf_config`` reads them for ``model_type`` "mellum" and reads every
# other config exactly as the original does.
# ---------------------------------------------------------------------------
_JaxDecoderConfig = DecoderConfig

SLIDING, FULL = "sliding_attention", "full_attention"


@dataclass(frozen=True)
class DecoderConfig(_JaxDecoderConfig):  # noqa: F811 (the port's extension)
    layer_types: Optional[Tuple[str, ...]] = None
    mlp_layer_types: Optional[Tuple[str, ...]] = None
    # ((attention type, ((key, value), ...)), ...): hashable, as the config is
    rope_parameters: Optional[Tuple[Tuple[str, Tuple[Tuple[str, Any], ...]], ...]] = None
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = False

    def layer_window(self, i: int) -> Optional[int]:
        """The sliding window of layer ``i`` (None: full causal attention)."""
        if self.layer_types is not None and self.layer_types[i] != SLIDING:
            return None
        return self.sliding_window

    def layer_type(self, i: int) -> str:
        """Layer ``i``'s attention type; one type for a model without
        ``layer_types``."""
        return FULL if self.layer_types is None else self.layer_types[i]

    def rope_for(self, layer_type: str) -> dict:
        """RoPE parameters of an attention type: ``rope_type`` ("default" or
        "yarn"), ``rope_theta`` and, for YaRN, its keys as ``config.json``
        gives them."""
        if self.rope_parameters is None:
            return {"rope_type": "default", "rope_theta": self.rope_theta}
        return dict(dict(self.rope_parameters)[layer_type])

    def sparse(self, i: int) -> bool:
        """Whether layer ``i``'s MLP is the routed-expert layer."""
        return self.mlp_layer_types is not None and self.mlp_layer_types[i] == "sparse"

    @property
    def has_experts(self) -> bool:
        return self.mlp_layer_types is not None and "sparse" in self.mlp_layer_types

    @classmethod
    def from_hf_config(cls, d: dict) -> "DecoderConfig":
        base = super().from_hf_config(d)
        if d.get("model_type") != "mellum":
            return base
        rope = d["rope_parameters"]
        return dataclasses.replace(
            base,
            sliding_window=d["sliding_window"] if d.get("use_sliding_window", True) else None,
            rope_theta=rope["sliding_attention"]["rope_theta"],
            layer_types=tuple(d["layer_types"]),
            mlp_layer_types=tuple(d["mlp_layer_types"]),
            rope_parameters=tuple((t, tuple(sorted(p.items()))) for t, p in sorted(rope.items())),
            num_experts=d["num_experts"],
            num_experts_per_tok=d["num_experts_per_tok"],
            moe_intermediate_size=d["moe_intermediate_size"],
            norm_topk_prob=d.get("norm_topk_prob", False),
        )
