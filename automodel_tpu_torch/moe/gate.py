"""MoE router / gate (port of `init_gate`, `_group_limited_mask`,
`gate_forward` and `update_gate_bias` from `automodel_tpu/moe/gate.py`).

Softmax or sigmoid scoring, the DeepSeek correction bias (`e_score_bias`,
used for the selection only: no gradient reaches it, as JAX's
stop_gradient gives it none), group-limited top-k, top-k renormalization
and the routed scaling factor, the masked-token sentinel (index E), routing
replay, the deterministic balanced gate, the switch-style aux loss and the
aux-free bias update.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.common.layers import init_fns
from automodel_tpu_torch.moe.config import MoEConfig


def init_gate(cfg: MoEConfig, hidden_size: int, gen: torch.Generator,
              dtype: torch.dtype = torch.float32,
              num_layers: int | None = None) -> dict:
    """Router params; with `num_layers` every leaf is stacked on dim 0."""
    _, zeros, dense = init_fns(gen, dtype)
    lead = () if num_layers is None else (num_layers,)
    E = cfg.n_routed_experts
    params = {"weight": dense(*lead, hidden_size, E)}
    if cfg.router_bias:
        params["bias"] = zeros(*lead, E)
    if cfg.gate_bias_update_speed > 0:
        # selection-only bias
        params["e_score_bias"] = zeros(*lead, E)
    return params


def gate_param_specs(cfg: MoEConfig) -> dict:
    specs = {"weight": ("embed", None)}
    if cfg.router_bias:
        specs["bias"] = (None,)
    if cfg.gate_bias_update_speed > 0:
        specs["e_score_bias"] = (None,)
    return specs


def _group_limited_mask(scores: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """DeepSeek group-limited routing: keep only experts inside the
    topk_groups best groups (group score = sum of its top-2 experts)."""
    T = scores.shape[0]
    E, G = cfg.n_routed_experts, cfg.n_groups
    grouped = scores.reshape(T, G, E // G)
    top2 = torch.topk(grouped, min(2, E // G), dim=-1).values.sum(-1)  # (T, G)
    top_groups = torch.topk(top2, cfg.topk_groups, dim=-1).indices
    group_mask = torch.zeros((T, G), dtype=scores.dtype, device=scores.device)
    group_mask.scatter_(1, top_groups, 1.0)
    return group_mask.repeat_interleave(E // G, dim=-1)  # (T, E)


def gate_forward(
    params: dict,
    cfg: MoEConfig,
    x: torch.Tensor,  # (T, H)
    token_mask: torch.Tensor | None = None,  # (T,) bool; False = pad/ignored
    forced_indices: torch.Tensor | None = None,  # (T, K) routing replay
    spmd=None,
):
    """Route tokens. Returns (weights (T,K) fp32, indices (T,K) int32,
    aux_loss, stats), as the JAX `gate_forward`.

    Masked tokens are routed to the invalid expert index E, so the
    dropless dispatch skips them and they drop out of the statistics.
    `forced_indices` replays a captured selection (entries == E stay
    invalid); scores and weights come from the live router.

    On a mesh (`spmd`, `parallel/spmd.py`) x holds this rank's tokens of
    the global batch: the counts, the valid-token count and the summed
    probabilities are summed over the batch axes (differentiably), so the
    aux loss and the stats are the global batch's, as JAX computes them,
    and the balanced gate numbers tokens from this rank's offset."""
    T, _ = x.shape
    E, K = cfg.n_routed_experts, cfg.experts_per_token
    dev = x.device
    total = spmd.batch_sum if spmd is not None else (lambda v: v)

    if cfg.fake_balanced_gate:
        # deterministic round-robin: token t → experts (tK, tK+1, …) mod E
        t0 = spmd.batch_offset(T) if spmd is not None else 0
        base = ((torch.arange(T, device=dev)[:, None] + t0) * K
                + torch.arange(K, device=dev)[None, :]) % E
        weights = torch.full((T, K), 1.0 / K, dtype=torch.float32, device=dev)
        stats = {
            "tokens_per_expert": total(F.one_hot(base, E).float().sum((0, 1))),
            "mean_prob": torch.full((E,), 1.0 / E, dtype=torch.float32, device=dev),
        }
        return weights, base.to(torch.int32), torch.zeros((), device=dev), stats

    logits = x.float() @ params["weight"].float()  # (T, E)
    if "bias" in params:
        logits = logits + params["bias"].float()
    if cfg.score_func == "softmax":
        scores = torch.softmax(logits, dim=-1)
    elif cfg.score_func == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        raise ValueError(f"Unknown score_func '{cfg.score_func}'")

    select_scores = scores
    if "e_score_bias" in params:
        select_scores = scores + params["e_score_bias"].detach().float()
    if cfg.n_groups > 1:
        gmask = _group_limited_mask(select_scores, cfg)
        select_scores = torch.where(gmask > 0, select_scores, -torch.inf)

    replay_invalid = None
    if forced_indices is not None:
        indices = torch.clamp(forced_indices.long(), 0, E - 1)
        replay_invalid = forced_indices >= E
    else:
        indices = torch.topk(select_scores, K, dim=-1).indices  # (T, K)
    weights = torch.gather(scores, -1, indices)  # weight by raw score
    if replay_invalid is not None:
        weights = torch.where(replay_invalid, 0.0, weights)
        indices = torch.where(replay_invalid, E, indices)  # keep the invalid slot
    if cfg.norm_topk_prob:
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-20)
    weights = weights * cfg.route_scale

    if token_mask is not None:
        tm = token_mask.float()
        indices = torch.where(token_mask[:, None], indices, E)  # E = invalid slot
        weights = weights * tm[:, None]
        n_valid = torch.clamp(total(tm.sum()), min=1.0)
    else:
        tm = None
        n_valid = float(T) if spmd is None else total(
            torch.full((), float(T), device=dev))

    # load-balance statistics; the invalid index E one-hots to all zeros
    one_hot = F.one_hot(indices, E + 1)[..., :E].float()  # (T, K, E)
    tokens_per_expert = total(one_hot.sum((0, 1)))
    fraction = tokens_per_expert / (n_valid * K)
    if tm is None and spmd is None:
        mean_prob = scores.mean(0)
    elif tm is None:
        mean_prob = total(scores.sum(0)) / n_valid
    else:
        mean_prob = total((scores * tm[:, None]).sum(0)) / n_valid
    aux_loss = cfg.aux_loss_coeff * E * torch.sum(fraction * mean_prob)
    stats = {"tokens_per_expert": tokens_per_expert, "mean_prob": mean_prob}
    return weights.float(), indices.to(torch.int32), aux_loss, stats


def update_gate_bias(params: dict, cfg: MoEConfig,
                     tokens_per_expert: torch.Tensor) -> dict:
    """DeepSeek aux-free balancing: raise the selection bias of under-loaded
    experts and lower that of over-loaded ones by `gate_bias_update_speed`.
    Takes one layer's (E,) counts or a stack's (L, E), each layer against
    its own mean; returns new params (`params` itself without a bias)."""
    if "e_score_bias" not in params:
        return params
    tpe = tokens_per_expert.float()
    err = tpe.mean(-1, keepdim=True) - tpe  # > 0: under-loaded
    new_bias = params["e_score_bias"] + cfg.gate_bias_update_speed * torch.sign(err)
    return {**params, "e_score_bias": new_bias}
