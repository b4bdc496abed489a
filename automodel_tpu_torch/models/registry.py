"""Architecture registry: HF `architectures[0]` -> the port's implementation
(port of the entries of `automodel_tpu/models/registry.py` whose family
configs the port has: the dense Llama, Mistral, Ministral-3, Qwen2, Qwen3,
Gemma-2, Gemma-3, GLM-4, ERNIE-4.5, Hunyuan dense and Baichuan2, the
bidirectional Llama and Ministral-3 encoders; the MLA + MoE DeepSeek-V3,
Kimi-K2, GLM-4.7-Flash (GLM-4 MoE Lite) and Mistral-4; the DSA models
DeepSeek-V3.2, DeepSeek-V4 and GLM-5.x (GlmMoeDsa); and the GQA MoE
families Qwen3-MoE, Mixtral, gpt-oss, GLM-4.5, ERNIE-4.5-MoE, Hunyuan-MoE,
Hy-MT2, MiniMax-M2 and Ling 2.0, for training and serving; and, for
training and `generate()`, the heterogeneous MoE engine's Step-3.5,
MiMo-V2-Flash and MiniMax-M3 and the parallel dense + MoE Gemma-4)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

from automodel_tpu_torch.models.llm import decoder, families
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.moe_lm import families as moe_families
from automodel_tpu_torch.models.moe_lm import gemma4 as gemma4_module
from automodel_tpu_torch.models.moe_lm import het_families
from automodel_tpu_torch.models.moe_lm import het_moe as het_moe_module


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Everything the framework needs to drive one architecture."""

    name: str
    config_from_hf: Callable[..., Any]
    module: Any  # provides init / forward / head_kernel / unembed
    adapter_name: str = "dense_decoder"  # checkpoint/hf_adapter.py ADAPTERS key
    adapter_kwargs: dict = dataclasses.field(default_factory=dict)


MODEL_ARCH_MAPPING: dict[str, ModelSpec] = {
    "LlamaForCausalLM": ModelSpec("llama", families.llama_config, decoder),
    "MistralForCausalLM": ModelSpec("mistral", families.mistral_config, decoder),
    "Ministral3ForCausalLM": ModelSpec("ministral3", families.ministral3_config, decoder),
    "Ministral3BidirectionalModel": ModelSpec(
        "ministral_bidirectional", families.ministral_bidirectional_config, decoder
    ),
    "Qwen2ForCausalLM": ModelSpec("qwen2", families.qwen2_config, decoder),
    "Qwen3ForCausalLM": ModelSpec("qwen3", families.qwen3_config, decoder),
    "Gemma2ForCausalLM": ModelSpec("gemma2", families.gemma2_config, decoder),
    "Gemma3ForCausalLM": ModelSpec("gemma3", families.gemma3_config, decoder),
    "Glm4ForCausalLM": ModelSpec(
        "glm4", families.glm4_config, decoder, adapter_kwargs={"style": "glm4"}
    ),
    "Ernie4_5ForCausalLM": ModelSpec("ernie4_5", families.ernie4_5_config, decoder),
    "HunYuanDenseV1ForCausalLM": ModelSpec(
        "hunyuan_dense", families.hunyuan_dense_config, decoder,
        adapter_kwargs={"style": "hunyuan"},
    ),
    "BaichuanForCausalLM": ModelSpec(
        "baichuan", families.baichuan_config, decoder,
        adapter_kwargs={"style": "baichuan"},
    ),
    "LlamaBidirectionalModel": ModelSpec(
        "llama_bidirectional", families.llama_bidirectional_config, decoder
    ),
    "LlamaBidirectionalForSequenceClassification": ModelSpec(
        "llama_bidirectional", families.llama_bidirectional_config, decoder
    ),
    # MLA + MoE (Moonlight-16B-A3B runs as this): trains through `forward`
    # (aux loss, gate-bias update), serves through the engine
    "DeepseekV3ForCausalLM": ModelSpec(
        "deepseek_v3", moe_families.deepseek_v3_moe_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "deepseek"},
    ),
    # checkpoint-compatible with DeepSeek-V3
    # DeepSeek-V3.2 = the V3 body + DSA (its config carries index_topk)
    "DeepseekV32ForCausalLM": ModelSpec(
        "deepseek_v32", moe_families.deepseek_v4_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "deepseek"},
    ),
    "DeepseekV4ForCausalLM": ModelSpec(
        "deepseek_v4", moe_families.deepseek_v4_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "deepseek"},
    ),
    # GLM-5.x: the MLA + MoE body + the GLM indexer with IndexShare
    # (DeepSeek-style checkpoint names)
    "GlmMoeDsaForCausalLM": ModelSpec(
        "glm_moe_dsa", moe_families.glm_moe_dsa_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "deepseek"},
    ),
    "KimiK2ForCausalLM": ModelSpec(
        "kimi_k2", moe_families.deepseek_v3_moe_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "deepseek"},
    ),
    # GLM-4.7-Flash: the GLM-4 MoE body on MLA, DeepSeek-V3's config and names
    "Glm4MoeLiteForCausalLM": ModelSpec(
        "glm4_moe_lite", moe_families.deepseek_v3_moe_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "deepseek"},
    ),
    # the DeepSeek-V3 body with Llama-4's position-dependent q-rope scaling
    "Mistral4ForCausalLM": ModelSpec(
        "mistral4", moe_families.mistral4_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "deepseek"},
    ),
    # the GQA MoE families, with the JAX registry's adapter styles
    "Qwen3MoeForCausalLM": ModelSpec(
        "qwen3_moe", moe_families.qwen3_moe_config, moe_decoder, adapter_name="moe_decoder"
    ),
    "MixtralForCausalLM": ModelSpec(
        "mixtral", moe_families.mixtral_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "mixtral"},
    ),
    "GptOssForCausalLM": ModelSpec(
        "gpt_oss", moe_families.gpt_oss_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "gpt_oss"},
    ),
    "Glm4MoeForCausalLM": ModelSpec(
        "glm4_moe", moe_families.glm4_moe_config, moe_decoder,
        adapter_name="moe_decoder",
    ),
    "Ernie4_5_MoeForCausalLM": ModelSpec(
        "ernie4_5_moe", moe_families.ernie4_5_moe_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "ernie"},
    ),
    "HunYuanMoEV1ForCausalLM": ModelSpec(
        "hunyuan_moe", moe_families.hunyuan_moe_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "hunyuan"},
    ),
    "HyMT2ForCausalLM": ModelSpec(
        "hy_mt2", moe_families.hy_mt2_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "hy_mt2"},
    ),
    "MiniMaxM2ForCausalLM": ModelSpec(
        "minimax_m2", moe_families.minimax_m2_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "minimax"},
    ),
    # Ling 2.0: fused query_key_value checkpoint layout
    "BailingMoeV2ForCausalLM": ModelSpec(
        "ling_v2", moe_families.bailing_moe_v2_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "bailing"},
    ),
    # Gemma-4 MoE (the text decoder of the VL composite): parallel dense +
    # MoE FFN, KV sharing, its own router
    "Gemma4ForConditionalGeneration": ModelSpec(
        "gemma4_moe", gemma4_module.gemma4_moe_config, gemma4_module,
        adapter_name="gemma4_moe",
    ),
    # the heterogeneous engine: two attention geometries over per-layer
    # dense / MoE MLPs; MiniMax-M3 adds block-sparse attention layers
    "Step3p5ForCausalLM": ModelSpec(
        "step3p5", het_families.step3p5_config, het_moe_module,
        adapter_name="het_moe", adapter_kwargs={"style": "step3p5"},
    ),
    "MiMoV2FlashForCausalLM": ModelSpec(
        "mimo_v2_flash", het_families.mimo_v2_flash_config, het_moe_module,
        adapter_name="het_moe", adapter_kwargs={"style": "mimo"},
    ),
    "MiniMaxM3SparseForCausalLM": ModelSpec(
        "minimax_m3", het_families.minimax_m3_text_config, het_moe_module,
        adapter_name="het_moe", adapter_kwargs={"style": "minimax_m3"},
    ),
}


def get_model_spec(arch_or_hf_config: "str | Mapping") -> ModelSpec:
    if isinstance(arch_or_hf_config, str):
        arch = arch_or_hf_config
    else:
        archs = arch_or_hf_config.get("architectures") or []
        arch = archs[0] if archs else ""
    if arch not in MODEL_ARCH_MAPPING:
        # the other families are not ported yet
        raise NotImplementedError(
            f"Architecture '{arch}' is not ported to automodel_tpu_torch; "
            f"ported: {sorted(MODEL_ARCH_MAPPING)}"
        )
    return MODEL_ARCH_MAPPING[arch]
