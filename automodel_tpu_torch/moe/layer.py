"""The MoE block: gate + routed experts + shared experts (port of `init_moe`,
`moe_param_specs` and `moe_forward` from `automodel_tpu/moe/layer.py`,
dropless or capacity dispatch).

On a mesh the block runs on this rank's tokens: the gate's statistics are
the global batch's (`gate_forward`), the dropless dispatch goes across the
`ep` ranks when `ep` > 1 (`experts_forward_dropless_ep`), and where `tp`
splits the experts' and shared experts' MLP dim, each rank runs its slice
(the tokens and routing weights enter through `copy_to`, the partial sums
are all-reduced over `tp`).
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.common.layers import init_fns
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.experts import (
    compute_capacity,
    dispatch_tensors,
    expert_param_specs,
    experts_forward,
    experts_forward_dropless,
    experts_forward_dropless_ep,
    init_experts,
    shared_expert_forward,
)
from automodel_tpu_torch.moe.gate import gate_forward, gate_param_specs, init_gate
from automodel_tpu_torch.parallel.collectives import copy_to, reduce_from


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


def moe_param_specs(cfg: MoEConfig) -> dict:
    """Logical axes of one MoE block's leaves (JAX `moe_param_specs`)."""
    specs = {"gate": gate_param_specs(cfg), "experts": expert_param_specs(cfg)}
    if cfg.n_shared_experts > 0:
        specs["shared"] = {
            "up_proj": {"kernel": ("embed", "mlp")},
            "down_proj": {"kernel": ("mlp", "embed")},
        }
        if cfg.shared_expert_is_gated:
            specs["shared"]["gate_proj"] = {"kernel": ("embed", "mlp")}
        if cfg.shared_expert_gated:
            specs["shared"]["gate"] = {"kernel": ("embed", None)}
    return specs


def _tp_expert_bias(params: dict, cfg: MoEConfig, tp) -> dict:
    """Under tp the experts' outputs are partial sums: the (tp-replicated)
    down-projection bias joins them on tp rank 0 alone, through `copy_to`,
    so its gradient is summed over tp."""
    import torch.distributed as dist

    if not cfg.expert_bias:
        return params
    down = params["experts"]["down_proj"]
    bias = copy_to(down["bias"], tp) * float(dist.get_rank(tp) == 0)
    return {**params, "experts": {**params["experts"], "down_proj": {**down, "bias": bias}}}


def moe_forward(
    params: dict,
    cfg: MoEConfig,
    x: torch.Tensor,  # (B, S, H)
    token_mask: torch.Tensor | None = None,  # (B, S) bool
    mesh_ctx=None,
    forced_indices: torch.Tensor | None = None,  # (B*S, K) routing replay
    spmd=None,
    tp=None,
):
    """Returns (out (B,S,H), aux_loss scalar, stats); stats["indices"] is
    the (T,K) selection. On a mesh, `spmd` (`parallel/spmd.Spmd`, or made
    from `mesh_ctx`) holds the groups and `params` this rank's local,
    unsharded-over-`dp_shard` leaves; `tp` is the group that splits the
    experts' MLP dim, or None."""
    if spmd is None and mesh_ctx is not None:
        from automodel_tpu_torch.parallel.spmd import Spmd

        spmd = Spmd(mesh_ctx)
    if tp is not None:
        if cfg.n_shared_experts > 0 and cfg.shared_expert_gated:
            raise NotImplementedError("the gated shared expert under tp > 1 is not ported")
        params = _tp_expert_bias(params, cfg, tp)
    B, S, H = x.shape
    flat = x.reshape(B * S, H)
    flat_mask = token_mask.reshape(B * S) if token_mask is not None else None
    weights, indices, aux_loss, stats = gate_forward(
        params["gate"], cfg, flat, flat_mask, forced_indices, spmd=spmd
    )
    stats = {**stats, "indices": indices}
    xe, we = copy_to(flat, tp), copy_to(weights, tp)
    if cfg.dispatcher == "dropless":
        if spmd is not None and spmd.ep_size > 1:
            out = experts_forward_dropless_ep(params["experts"], cfg, xe, we, indices,
                                              spmd.ep)
        else:
            out = experts_forward_dropless(params["experts"], cfg, xe, we, indices)
    else:
        if spmd is not None and spmd.ep_size > 1:
            raise NotImplementedError(
                "the capacity dispatcher across ep > 1 (JAX lets GSPMD place "
                "its einsums); use moe_dispatcher: dropless")
        capacity = compute_capacity(cfg, B * S)
        # the one-hot in the compute dtype (0 and 1 are exact in any)
        dispatch, combine = dispatch_tensors(cfg, indices, we, capacity,
                                             dtype=flat.dtype)
        out = experts_forward(params["experts"], cfg, xe, dispatch, combine)
    if cfg.n_shared_experts > 0:
        out = out + shared_expert_forward(params["shared"], cfg, xe)
    out = reduce_from(out, tp)
    return out.reshape(B, S, H).to(x.dtype), aux_loss, stats
