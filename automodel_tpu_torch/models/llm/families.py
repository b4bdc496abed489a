"""Model-family adapters: HF config dict → TransformerConfig (port of the
Llama entries of `automodel_tpu/models/llm/families.py`)."""

from __future__ import annotations

from typing import Any, Mapping

from automodel_tpu_torch.models.llm.decoder import TransformerConfig
from automodel_tpu_torch.ops.rope import RopeScalingConfig


def _base_kwargs(hf: Mapping[str, Any]) -> dict:
    hidden = int(hf["hidden_size"])
    heads = int(hf["num_attention_heads"])
    return dict(
        vocab_size=int(hf["vocab_size"]),
        hidden_size=hidden,
        intermediate_size=int(hf["intermediate_size"]),
        num_layers=int(hf["num_hidden_layers"]),
        num_heads=heads,
        num_kv_heads=int(hf.get("num_key_value_heads", heads)),
        head_dim=int(hf["head_dim"]) if hf.get("head_dim") else None,
        max_position_embeddings=int(hf.get("max_position_embeddings", 4096)),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_scaling=RopeScalingConfig.from_hf(hf.get("rope_scaling")),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", False)),
    )


def llama_config(hf: Mapping[str, Any], **overrides) -> TransformerConfig:
    """LlamaForCausalLM (Llama 2/3/3.x)."""
    kw = _base_kwargs(hf)
    kw["attention_bias"] = bool(hf.get("attention_bias", False))
    kw.update(overrides)
    return TransformerConfig(**kw)
