"""Normalization ops (port of `automodel_tpu/ops/norms.py`)."""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
    zero_centered: bool = False,
) -> torch.Tensor:
    """RMSNorm in fp32, output in x.dtype. scale shape: (hidden,).

    `zero_centered` follows the gemma convention (weight stored as scale-1).
    """
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = scale.float()
    if zero_centered:
        w = w + 1.0
    return (y * w).to(x.dtype)
