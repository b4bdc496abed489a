"""Paged-KV int8 quantization (port of the KV part of
`automodel_tpu/ops/quant.py`: `INT8_MAX`, `quantize_kv_rows`, `dequantize_kv`).

The quantized matmuls (`quantized_matmul`, `serve_precision`) and QAT are
not ported yet.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0

_F32 = torch.finfo(torch.float32)


def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """New-token KV cache rows → (int8 rows, per-row fp32 scales).

    `x` is (T, ...): one cache row per leading index (a GQA (Hkv, D) K or V
    row, an MLA (r,) latent or (dr,) rope row); everything behind the
    leading dim shares ONE scale, the granularity of the pool's (L, N+1, ps)
    scale planes. fp32 clip first, `+ 1e-12` on the scale, and rounding half
    to even (`torch.round`, as `jnp.round`)."""
    xf = torch.clamp(x.float(), _F32.min, _F32.max)
    red = tuple(range(1, x.dim()))
    scale = torch.amax(torch.abs(xf), dim=red) / INT8_MAX + 1e-12
    sb = scale.reshape(scale.shape + (1,) * (x.dim() - 1))
    q = torch.clamp(torch.round(xf / sb), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_kv_rows` over gathered page views: `scale`'s dims
    align with `q`'s leading dims and broadcast over the rest. Returns fp32."""
    sb = scale.reshape(scale.shape + (1,) * (q.dim() - scale.dim()))
    return q.float() * sb
