from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.gate import gate_forward, init_gate
from automodel_tpu_torch.moe.layer import init_moe, moe_forward

__all__ = [
    "MoEConfig",
    "gate_forward",
    "init_gate",
    "init_moe",
    "moe_forward",
]
