"""Initializers and the compute-dtype cast (port of the helpers in
`automodel_tpu/models/common/layers.py`). Random draws come from an explicit
`torch.Generator`; they do not reproduce `jax.random`'s numbers, so parity
tests hand both packages the same numpy weights instead."""

from __future__ import annotations

import torch


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (±3 std) fan-in init on the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    return _trunc_normal(gen, shape, std, dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               std: float = 0.02) -> torch.Tensor:
    return _trunc_normal(gen, shape, std, dtype)


def _trunc_normal(gen, shape, std, dtype):
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, std, -3.0 * std, 3.0 * std, generator=gen)
    return x.to(dtype)


def cast_params(params, dtype: torch.dtype, device=None):
    """Compute-dtype cast of a nested dict of tensors (floating leaves only),
    optionally moving every leaf to `device`. A leaf already in place is
    returned as is, not copied."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype, device) for k, v in params.items()}
    if params.is_floating_point():
        return params.to(device=device, dtype=dtype)
    return params.to(device)
