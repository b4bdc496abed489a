"""Architecture registry: HF `architectures[0]` -> the port's implementation
(port of the entries of `automodel_tpu/models/registry.py` whose family
configs the port has: Llama, and DeepSeek-V3 for training and serving)."""

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
    # MLA + MoE (Moonlight-16B-A3B runs as this): trains through `forward`
    # (aux loss, gate-bias update), serves through the engine
    "DeepseekV3ForCausalLM": ModelSpec(
        "deepseek_v3", moe_families.deepseek_v3_moe_config, moe_decoder,
        adapter_name="moe_decoder", adapter_kwargs={"style": "deepseek"},
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
