from automodel_tpu_torch.peft.lora import (
    LoRAConfig,
    init_lora,
    layer_stack,
    merge_lora,
    merged_state_dict,
    quantize_base,
)

__all__ = [
    "LoRAConfig",
    "init_lora",
    "layer_stack",
    "merge_lora",
    "merged_state_dict",
    "quantize_base",
]
