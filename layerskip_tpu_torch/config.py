"""Model and generation configuration (port of ``layerskip_tpu/config.py``).

The same architecture surface as the JAX package, with torch dtypes in place
of jnp ones. ``from_hf_dict`` keeps the JAX package's fallbacks, including
the Gemma-2 ones that differ from HF's defaults, so one ``config.json``
gives equal fields in both packages. Every family the JAX package runs
(Llama, Qwen2/Qwen3, Mistral, Gemma/Gemma-2/Gemma-3, Phi-3, Mixtral and
Qwen3-MoE) runs in the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List, Optional

import torch


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3 style RoPE frequency scaling (HF ``rope_scaling`` dict)."""

    rope_type: str = "default"  # "default" | "llama3" | "linear"
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192

    @staticmethod
    def from_hf(d: Optional[dict]) -> "RopeScaling":
        if not d:
            return RopeScaling()
        return RopeScaling(
            rope_type=d.get("rope_type", d.get("type", "default")),
            factor=float(d.get("factor", 1.0)),
            low_freq_factor=float(d.get("low_freq_factor", 1.0)),
            high_freq_factor=float(d.get("high_freq_factor", 4.0)),
            original_max_position_embeddings=int(
                d.get("original_max_position_embeddings", 8192)
            ),
        )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Llama-family architecture description (mirrors HF ``config.json``)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling = dataclasses.field(default_factory=RopeScaling)
    attention_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    norm_topk_prob: bool = True
    hidden_act: str = "silu"
    rms_norm_offset: bool = False
    scale_embeddings: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    query_pre_attn_scalar: Optional[float] = None
    sliding_window_pattern: int = 1
    sliding_layers: Optional[tuple] = None
    post_norms: bool = False
    rope_local_theta: Optional[float] = None
    tie_word_embeddings: bool = False
    bos_token_id: int = 1
    eos_token_id: Any = 2  # int or list[int]
    # weights/activations in ``dtype``; logits always fp32
    dtype: Any = torch.bfloat16

    @property
    def eos_token_ids(self) -> List[int]:
        e = self.eos_token_id
        if isinstance(e, (list, tuple)):
            return [int(x) for x in e]
        return [int(e)]

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def is_moe(self) -> bool:
        return self.num_local_experts > 0

    @property
    def sliding_layer_flags(self) -> Optional[tuple]:
        """Per-layer sliding flags, or None when the window (if any) applies
        to every layer (same rule as the JAX package)."""
        if self.sliding_window is None:
            return None
        if self.sliding_layers is not None:
            flags = tuple(bool(x) for x in self.sliding_layers)
            return None if all(flags) else flags
        if self.sliding_window_pattern > 1:
            p = self.sliding_window_pattern
            return tuple(
                (i + 1) % p != 0 for i in range(self.num_hidden_layers)
            )
        return None

    @property
    def norm_offset(self) -> float:
        """RMSNorm weight offset: 1.0 for Gemma ((1 + w) convention)."""
        return 1.0 if self.rms_norm_offset else 0.0

    @staticmethod
    def from_hf_dict(d: dict, dtype=torch.bfloat16) -> "ModelConfig":
        head_dim = d.get("head_dim") or (
            d["hidden_size"] // d["num_attention_heads"]
        )
        model_type = d.get("model_type", "")
        gemma = model_type.startswith("gemma")
        qwen3moe = model_type == "qwen3_moe"
        if qwen3moe and (int(d.get("decoder_sparse_step", 1)) > 1
                         or d.get("mlp_only_layers")):
            raise ValueError(
                "qwen3_moe with dense layers interleaved is not supported"
            )
        gemma2 = model_type == "gemma2"
        gemma3 = model_type.startswith("gemma3")
        layer_types = d.get("layer_types")
        sliding_layers = (
            tuple(t == "sliding_attention" for t in layer_types)
            if layer_types else None
        )
        sliding_window = d.get("sliding_window")
        if sliding_layers is not None:
            if all(sliding_layers):
                sliding_layers = None
            elif not any(sliding_layers):
                sliding_layers, sliding_window = None, None
        return ModelConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=(
                d.get("moe_intermediate_size") or d["intermediate_size"]
            ) if qwen3moe else d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get(
                "num_key_value_heads", d["num_attention_heads"]
            ),
            head_dim=head_dim,
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scaling=RopeScaling.from_hf(d.get("rope_scaling")),
            attention_bias=d.get("attention_bias", model_type == "qwen2"),
            qk_norm=model_type.startswith("qwen3") or gemma3,
            sliding_window=sliding_window,
            num_local_experts=d.get(
                "num_local_experts",
                d.get("num_experts", 128) if qwen3moe else 0
            ),
            num_experts_per_tok=d.get(
                "num_experts_per_tok", 8 if qwen3moe else 2
            ),
            norm_topk_prob=bool(d.get("norm_topk_prob", not qwen3moe)),
            hidden_act=(
                d.get("hidden_activation") or d.get("hidden_act")
                or ("gelu_pytorch_tanh" if gemma else "silu")
            ),
            rms_norm_offset=gemma,
            scale_embeddings=gemma,
            # the JAX package's fallbacks, kept as they are: a Gemma-2 dict
            # without the softcap keys gets 0, not HF's defaults
            attn_logit_softcap=float(d.get("attn_logit_softcapping") or 0.0),
            final_logit_softcap=float(
                d.get("final_logit_softcapping") or 0.0
            ),
            query_pre_attn_scalar=(
                float(d["query_pre_attn_scalar"])
                if d.get("query_pre_attn_scalar") else None
            ),
            sliding_window_pattern=int(
                d.get("sliding_window_pattern")
                or (2 if gemma2 else 6 if gemma3 else 1)
            ),
            sliding_layers=sliding_layers,
            post_norms=gemma2 or gemma3,
            rope_local_theta=(
                float(d["rope_local_base_freq"])
                if d.get("rope_local_base_freq") else None
            ),
            tie_word_embeddings=d.get("tie_word_embeddings", gemma),
            bos_token_id=d.get("bos_token_id", 1),
            eos_token_id=d.get("eos_token_id", 2),
            dtype=dtype,
        )

    @staticmethod
    def from_json(path: str, dtype=torch.bfloat16) -> "ModelConfig":
        with open(path) as f:
            return ModelConfig.from_hf_dict(json.load(f), dtype=dtype)

    @staticmethod
    def from_pretrained(path: str, dtype=torch.bfloat16) -> "ModelConfig":
        """Load from a local HF checkpoint directory (``config.json``)."""
        return ModelConfig.from_json(os.path.join(path, "config.json"), dtype)


def tiny_config(
    num_hidden_layers: int = 4,
    hidden_size: int = 64,
    num_attention_heads: int = 4,
    num_key_value_heads: int = 2,
    intermediate_size: int = 128,
    vocab_size: int = 256,
    max_position_embeddings: int = 256,
    dtype=torch.float32,
    **kw,
) -> ModelConfig:
    return ModelConfig(
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        intermediate_size=intermediate_size,
        num_hidden_layers=num_hidden_layers,
        num_attention_heads=num_attention_heads,
        num_key_value_heads=num_key_value_heads,
        head_dim=hidden_size // num_attention_heads,
        max_position_embeddings=max_position_embeddings,
        dtype=dtype,
        **kw,
    )


def llama2_7b_config() -> ModelConfig:
    """Llama-2-7B shape (the JAX package's ``7b`` bench/CLI preset)."""
    return ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        head_dim=128, max_position_embeddings=4096, rms_norm_eps=1e-5,
        rope_theta=10000.0, dtype=torch.bfloat16, tie_word_embeddings=True,
    )


def llama32_1b_config() -> ModelConfig:
    """Llama-3.2-1B shape (the JAX package's ``1b`` bench/CLI preset)."""
    return ModelConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
        head_dim=64, max_position_embeddings=4096, rms_norm_eps=1e-5,
        rope_theta=500000.0, dtype=torch.bfloat16, tie_word_embeddings=True,
    )


def gemma2_2b_config() -> ModelConfig:
    """Gemma-2-2B shape (HF ``google/gemma-2-2b`` config.json; the JAX
    package's ``gemma2-2b`` preset): 26 layers, head_dim 256, GeGLU,
    alternating 4096-token windows, softcaps 50/30, a tied 256000 x 2304
    head."""
    return ModelConfig(
        vocab_size=256000, hidden_size=2304, intermediate_size=9216,
        num_hidden_layers=26, num_attention_heads=8, num_key_value_heads=4,
        head_dim=256, max_position_embeddings=8192, rms_norm_eps=1e-6,
        rope_theta=10000.0, hidden_act="gelu_pytorch_tanh", rms_norm_offset=True,
        scale_embeddings=True, tie_word_embeddings=True, attn_logit_softcap=50.0,
        final_logit_softcap=30.0, query_pre_attn_scalar=256.0, sliding_window=4096,
        sliding_window_pattern=2, post_norms=True, dtype=torch.bfloat16,
    )


def moe_3b_config() -> ModelConfig:
    """The JAX package's Mixtral-architecture ``moe-3b`` preset: 16 layers
    of 8 experts, top-2, ~3.5B parameters in all and ~1.1B active a token."""
    return ModelConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=4096,
        num_hidden_layers=16, num_attention_heads=16, num_key_value_heads=8,
        head_dim=128, max_position_embeddings=4096, rope_theta=500000.0,
        num_local_experts=8, num_experts_per_tok=2, dtype=torch.bfloat16,
        tie_word_embeddings=True,
    )


PRESETS = {"7b": llama2_7b_config, "1b": llama32_1b_config,
           "gemma2-2b": gemma2_2b_config, "moe-3b": moe_3b_config}


@dataclasses.dataclass
class GenerationConfig:
    """Generation knobs, with the JAX package's names and defaults. This
    slice runs ``autoregressive`` and ``self_speculative`` with static-W
    early-exit drafting; the other options raise in the engine."""

    max_steps: int = 512
    exit_layer: int = -1
    num_speculations: int = -1
    generation_strategy: str = "autoregressive"
    pld_ngram: int = 3
    sample: bool = True
    temperature: float = 0.6
    top_k: int = 0
    top_p: float = 0.9
    no_repeat_ngram_size: Optional[int] = None
    stop_words: Optional[List[str]] = None
    stop_token_ids: Optional[List[int]] = None
    max_prompt_len: int = 0  # 0 -> bucketed automatically
    max_seq_len: int = 0  # 0 -> model max_position_embeddings
    kv_quant: bool = False
    draft_exit_prob: float = 0.0
    spec_tree_width: int = 0
    draft_quant: int = 0
    draft_quant_head: bool = False
    draft_quant_mlp_only: bool = False
