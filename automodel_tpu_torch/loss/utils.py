"""Loss composition helpers (port of `automodel_tpu/loss/utils.py`)."""

from __future__ import annotations

import torch


def combine_losses(
    ce_sum: torch.Tensor,
    num_label_tokens: torch.Tensor,
    aux_loss: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold an O(1) auxiliary loss into a SUM loss that the train step later
    divides by the global label-token count: multiplying the aux term by the
    same count first keeps its effective coefficient scale-invariant."""
    total = ce_sum
    if aux_loss is not None:
        total = total + aux_loss * num_label_tokens
    return total, num_label_tokens
