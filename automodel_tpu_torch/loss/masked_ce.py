"""Masked cross-entropy (port of `automodel_tpu/loss/masked_ce.py`).

Losses return an un-normalized sum plus the valid-token count, so the train
step divides once by the global number of label tokens.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def cross_entropy_sum(
    logits: torch.Tensor,  # (..., V) any float dtype; upcast to fp32 inside
    labels: torch.Tensor,  # (...,) integer, IGNORE_INDEX masked out
    ignore_index: int = IGNORE_INDEX,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sum_ce_fp32, num_valid_tokens_fp32)."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = torch.where(mask, lse - picked, 0.0)
    return ce.sum(), mask.sum().float()


def masked_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    ignore_index: int = IGNORE_INDEX,
    reduction: str = "sum",
) -> torch.Tensor:
    ce_sum, n = cross_entropy_sum(logits, labels, ignore_index)
    if reduction == "sum":
        return ce_sum
    if reduction == "mean":
        return ce_sum / torch.clamp(n, min=1.0)
    raise ValueError(f"Unknown reduction '{reduction}'")
