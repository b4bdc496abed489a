"""The MoE block: gate + routed experts + shared experts (port of `init_moe`
and `moe_forward` from `automodel_tpu/moe/layer.py`, dropless or capacity
dispatch with ep = 1).
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.common.layers import init_fns
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.experts import (
    compute_capacity,
    dispatch_tensors,
    experts_forward,
    experts_forward_dropless,
    init_experts,
    shared_expert_forward,
)
from automodel_tpu_torch.moe.gate import gate_forward, init_gate


def init_moe(cfg: MoEConfig, hidden_size: int, gen: torch.Generator,
             dtype: torch.dtype = torch.float32,
             num_layers: int | None = None) -> dict:
    """Gate, experts and shared-expert params (each leaf stacked on dim 0
    with `num_layers`), on the generator's device."""
    params = {
        "gate": init_gate(cfg, hidden_size, gen, dtype, num_layers),
        "experts": init_experts(cfg, hidden_size, gen, dtype, num_layers),
    }
    if cfg.n_shared_experts > 0:
        _, _, dense = init_fns(gen, dtype)
        lead = () if num_layers is None else (num_layers,)
        H, Hs = hidden_size, cfg.shared_intermediate
        params["shared"] = {
            "up_proj": {"kernel": dense(*lead, H, Hs)},
            "down_proj": {"kernel": dense(*lead, Hs, H)},
        }
        if cfg.shared_expert_is_gated:
            params["shared"]["gate_proj"] = {"kernel": dense(*lead, H, Hs)}
        if cfg.shared_expert_gated:
            params["shared"]["gate"] = {"kernel": dense(*lead, H, 1)}
    return params


def moe_forward(
    params: dict,
    cfg: MoEConfig,
    x: torch.Tensor,  # (B, S, H)
    token_mask: torch.Tensor | None = None,  # (B, S) bool
    mesh_ctx=None,
    forced_indices: torch.Tensor | None = None,  # (B*S, K) routing replay
):
    """Returns (out (B,S,H), aux_loss scalar, stats); stats["indices"] is
    the (T,K) selection. An expert-parallel mesh raises
    NotImplementedError."""
    if mesh_ctx is not None:
        raise NotImplementedError("expert parallelism (mesh_ctx) is not ported")
    B, S, H = x.shape
    flat = x.reshape(B * S, H)
    flat_mask = token_mask.reshape(B * S) if token_mask is not None else None
    weights, indices, aux_loss, stats = gate_forward(
        params["gate"], cfg, flat, flat_mask, forced_indices
    )
    stats = {**stats, "indices": indices}
    if cfg.dispatcher == "dropless":
        out = experts_forward_dropless(params["experts"], cfg, flat, weights, indices)
    else:
        capacity = compute_capacity(cfg, B * S)
        # the one-hot in the compute dtype (0 and 1 are exact in any)
        dispatch, combine = dispatch_tensors(cfg, indices, weights, capacity,
                                             dtype=flat.dtype)
        out = experts_forward(params["experts"], cfg, flat, dispatch, combine)
    if cfg.n_shared_experts > 0:
        out = out + shared_expert_forward(params["shared"], cfg, flat)
    return out.reshape(B, S, H).to(x.dtype), aux_loss, stats
