"""Normalization ops (port of `automodel_tpu/ops/norms.py`): RMSNorm and
LayerNorm, both in fp32 with the output in the input's dtype."""

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


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6,
) -> torch.Tensor:
    """Mean-centered LayerNorm in fp32, output in x.dtype."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)
