"""Architecture registry: HF `architectures[0]` -> the port's implementation
(port of the entries of `automodel_tpu/models/registry.py` whose family
configs the port has: the dense Llama, Mistral, Qwen2, Qwen3, Gemma-2 and
Gemma-3; DeepSeek-V3 on MLA; and the GQA MoE families Qwen3-MoE,
Mixtral, gpt-oss, GLM-4.5, ERNIE-4.5-MoE, Hunyuan-MoE, MiniMax-M2 and
Ling 2.0, for training and serving)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

from automodel_tpu_torch.models.llm import decoder, families
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.moe_lm import families as moe_families


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
    "Qwen2ForCausalLM": ModelSpec("qwen2", families.qwen2_config, decoder),
    "Qwen3ForCausalLM": ModelSpec("qwen3", families.qwen3_config, decoder),
    "Gemma2ForCausalLM": ModelSpec("gemma2", families.gemma2_config, decoder),
    "Gemma3ForCausalLM": ModelSpec("gemma3", families.gemma3_config, decoder),
    # MLA + MoE (Moonlight-16B-A3B runs as this): trains through `forward`
    # (aux loss, gate-bias update), serves through the engine
    "DeepseekV3ForCausalLM": ModelSpec(
        "deepseek_v3", moe_families.deepseek_v3_moe_config, moe_decoder,
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
    "MiniMaxM2ForCausalLM": ModelSpec(
        "minimax_m2", moe_families.minimax_m2_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "minimax"},
    ),
    # Ling 2.0: fused query_key_value checkpoint layout
    "BailingMoeV2ForCausalLM": ModelSpec(
        "ling_v2", moe_families.bailing_moe_v2_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "bailing"},
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
