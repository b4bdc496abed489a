"""Rotary position embeddings (port of `automodel_tpu/ops/rope.py`).

Covers the default, linear and llama3 frequency scalings and the half-split
and interleaved rotations. The yarn scaling (DeepSeek MLA) and precomputed
multi-axis angles (MRoPE) belong to model families this port has not reached.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RopeScalingConfig:
    """Frequency scaling (HF `rope_scaling`): llama3 / linear."""

    rope_type: str = "default"  # "default" | "llama3" | "linear"
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192

    @classmethod
    def from_hf(cls, d: dict | None) -> "RopeScalingConfig":
        if not d:
            return cls()
        return cls(
            rope_type=d.get("rope_type", d.get("type", "default")),
            factor=float(d.get("factor", 1.0)),
            low_freq_factor=float(d.get("low_freq_factor", 1.0)),
            high_freq_factor=float(d.get("high_freq_factor", 4.0)),
            original_max_position_embeddings=int(
                d.get("original_max_position_embeddings", 8192)
            ),
        )


def rope_frequencies(
    head_dim: int,
    theta: float = 10000.0,
    scaling: RopeScalingConfig | None = None,
) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32, on the CPU."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim)
    )
    if scaling is None or scaling.rope_type == "default":
        return inv_freq
    if scaling.rope_type == "linear":
        return inv_freq / scaling.factor
    if scaling.rope_type == "llama3":
        orig = scaling.original_max_position_embeddings
        low_wavelen = orig / scaling.low_freq_factor
        high_wavelen = orig / scaling.high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        # smooth interpolation between scaled and unscaled bands
        smooth = (orig / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor
        )
        smooth = torch.clamp(smooth, 0.0, 1.0)
        scaled = inv_freq / scaling.factor
        blended = (1.0 - smooth) * scaled + smooth * inv_freq
        return torch.where(
            wavelen < high_wavelen,
            inv_freq,
            torch.where(wavelen > low_wavelen, scaled, blended),
        )
    raise NotImplementedError(f"rope_type '{scaling.rope_type}' is not ported")


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    inv_freq: torch.Tensor,
    interleaved: bool = False,
) -> torch.Tensor:
    """Rotate (..., seq, heads, head_dim) by per-token positions (..., seq).

    Default is the HF "half-split" convention; `interleaved=True` rotates
    adjacent even/odd pairs (GLM-4). When 2*len(inv_freq) < head_dim only
    the first 2*len(inv_freq) channels rotate (partial rotary).
    """
    orig_dtype = x.dtype
    rot = 2 * inv_freq.shape[-1]
    x_pass = None
    if rot < x.shape[-1]:
        x, x_pass = x[..., :rot], x[..., rot:]
    angles = positions[..., :, None].float() * inv_freq  # (..., S, D/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., :, None, :]
    x = x.float()
    if interleaved:
        x1, x2 = x[..., 0::2], x[..., 1::2]
        out = torch.stack(
            [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
        ).reshape(x.shape)
    else:
        x1, x2 = torch.chunk(x, 2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(orig_dtype)
    if x_pass is not None:
        out = torch.cat([out, x_pass], dim=-1)
    return out
