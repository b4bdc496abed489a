from automodel_tpu_torch.optim.optimizer import (
    LRSchedulerConfig,
    Optimizer,
    OptimizerConfig,
    default_weight_decay_mask,
)

__all__ = [
    "LRSchedulerConfig",
    "Optimizer",
    "OptimizerConfig",
    "default_weight_decay_mask",
]
