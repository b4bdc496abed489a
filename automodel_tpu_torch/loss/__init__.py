from automodel_tpu_torch.loss.linear_ce import fused_linear_cross_entropy
from automodel_tpu_torch.loss.masked_ce import (
    IGNORE_INDEX,
    cross_entropy_sum,
    masked_cross_entropy,
)

__all__ = [
    "IGNORE_INDEX",
    "cross_entropy_sum",
    "masked_cross_entropy",
    "fused_linear_cross_entropy",
]
