"""Model-family adapters: HF config dict → TransformerConfig (port of the
Llama, Mistral, Qwen2, Qwen3, Gemma-2 and Gemma-3 entries of
`automodel_tpu/models/llm/families.py`)."""

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


def mistral_config(hf: Mapping[str, Any], **overrides) -> TransformerConfig:
    """MistralForCausalLM: Llama's shape with a sliding window on every
    layer when the config names one."""
    kw = _base_kwargs(hf)
    if hf.get("sliding_window"):
        kw["sliding_window"] = int(hf["sliding_window"])
    kw.update(overrides)
    return TransformerConfig(**kw)


def qwen2_config(hf: Mapping[str, Any], **overrides) -> TransformerConfig:
    """Qwen2ForCausalLM: qkv bias; with `use_sliding_window`, the window on
    the layers from `max_window_layers` on."""
    kw = _base_kwargs(hf)
    kw["attention_bias"] = True
    if hf.get("use_sliding_window") and hf.get("sliding_window"):
        kw["sliding_window"] = int(hf["sliding_window"])
        # HF Qwen2 windows only layers >= max_window_layers
        mwl = int(hf.get("max_window_layers", 0))
        kw["layer_types"] = tuple(
            "sliding" if i >= mwl else "global" for i in range(kw["num_layers"])
        )
    kw.update(overrides)
    return TransformerConfig(**kw)


def qwen3_config(hf: Mapping[str, Any], **overrides) -> TransformerConfig:
    """Qwen3ForCausalLM: per-head q/k RMSNorm, no bias."""
    kw = _base_kwargs(hf)
    kw["qk_norm"] = True
    kw.update(overrides)
    return TransformerConfig(**kw)


def _gemma_layer_types(hf: Mapping[str, Any], n_layers: int, default) -> tuple:
    """Per-layer "sliding"/"global" types: HF's `layer_types` when given,
    else `default(i)` for layer i."""
    if hf.get("layer_types"):
        return tuple("sliding" if t == "sliding_attention" else "global"
                     for t in hf["layer_types"])
    return tuple(default(i) for i in range(n_layers))


def gemma3_config(hf: Mapping[str, Any], **overrides) -> TransformerConfig:
    """Gemma3ForCausalLM (text tower): Gemma-2's zero-centred sandwich norms
    plus q/k norms, a 5:1 sliding/global layer pattern by default (every
    `sliding_window_pattern`-th layer global), and the unscaled local rope
    theta `rope_local_base_freq` on the sliding layers."""
    kw = _base_kwargs(hf)
    kw["activation"] = "gelu_tanh"
    kw["zero_centered_norm"] = True
    kw["use_post_norms"] = True
    kw["qk_norm"] = True
    kw["embed_scale"] = float(kw["hidden_size"]) ** 0.5
    kw["rms_norm_eps"] = float(hf.get("rms_norm_eps", 1e-6))
    kw["tie_word_embeddings"] = bool(hf.get("tie_word_embeddings", True))
    if hf.get("query_pre_attn_scalar"):
        kw["attn_scale"] = float(hf["query_pre_attn_scalar"]) ** -0.5
    if hf.get("final_logit_softcapping"):
        kw["logits_soft_cap"] = float(hf["final_logit_softcapping"])
    if hf.get("sliding_window"):
        kw["sliding_window"] = int(hf["sliding_window"])
        pattern = int(hf.get("sliding_window_pattern", 6))
        kw["layer_types"] = _gemma_layer_types(
            hf, kw["num_layers"],
            lambda i: "global" if (i + 1) % pattern == 0 else "sliding")
        if hf.get("rope_local_base_freq"):
            kw["rope_local_theta"] = float(hf["rope_local_base_freq"])
    kw.update(overrides)
    return TransformerConfig(**kw)


def gemma2_config(hf: Mapping[str, Any], **overrides) -> TransformerConfig:
    """Gemma2ForCausalLM: zero-centred four-norm layers, embeddings scaled
    by sqrt(hidden), attention and final logit soft caps, the
    `query_pre_attn_scalar` attention scale, and sliding and global layers
    alternating (even layers sliding) by default."""
    kw = _base_kwargs(hf)
    kw["activation"] = "gelu_tanh"
    kw["zero_centered_norm"] = True
    kw["use_post_norms"] = True
    kw["embed_scale"] = float(kw["hidden_size"]) ** 0.5
    if hf.get("final_logit_softcapping"):
        kw["logits_soft_cap"] = float(hf["final_logit_softcapping"])
    if hf.get("attn_logit_softcapping"):
        kw["attn_soft_cap"] = float(hf["attn_logit_softcapping"])
    if hf.get("query_pre_attn_scalar"):
        kw["attn_scale"] = float(hf["query_pre_attn_scalar"]) ** -0.5
    if hf.get("sliding_window"):
        kw["sliding_window"] = int(hf["sliding_window"])
        kw["layer_types"] = _gemma_layer_types(
            hf, kw["num_layers"], lambda i: "sliding" if i % 2 == 0 else "global")
    # Gemma's HF configs rely on the class default tie_word_embeddings=True
    kw["tie_word_embeddings"] = bool(hf.get("tie_word_embeddings", True))
    kw.update(overrides)
    return TransformerConfig(**kw)
