"""Expert compute and token dispatch (port of `gated_combine`,
`init_experts`, `compute_capacity`, `dispatch_tensors`, `experts_forward`,
`experts_forward_dropless` and `shared_expert_forward` from
`automodel_tpu/moe/experts.py`).

The JAX dropless path sorts the (token, slot) pairs by expert and runs the
three expert products as `lax.ragged_dot` over device group sizes (an XLA
op, not a Pallas kernel). Here the same sort feeds one grouped product per
projection, and `index_add_` scatters the weighted rows back into token
order. Nothing is read to the host, so a MoE layer queues its kernels
without waiting for the device, forward and backward: bf16 differentiates
through `torch._grouped_mm`'s own autograd, other dtypes through a batched
product and a gather.

The capacity dispatcher is the JAX package's padded einsum dispatch: each
expert takes at most `compute_capacity` (token, slot) pairs, filled in
token-major order over the flattened (T*K) routing, and drops the rest; a
(T, E, C) one-hot moves the kept rows to expert-major buffers and back.

Expert parallelism (`experts_forward_dropless_ep`, JAX `:419` and
`_dropless_ep_local` `:233`): the experts are split over the `ep` ranks,
E/ep each, contiguously, so the rows sorted by expert are grouped by the
rank that owns them. The per-expert counts are exchanged on the device
(one small all-to-all), then read to the host once per layer, since
`all_to_all_single` takes its split sizes as host integers: that read is
the dispatch's one wait for the device. The rows travel with
`all_to_all_single` (exactly the routed rows, DeepEP's property, as
JAX's ragged path on TPU), are regrouped by local expert, run through the
grouped product, and come back the same way; masked pairs never leave.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from automodel_tpu_torch.models.common.layers import init_fns
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.parallel.collectives import all_to_all

_EXPERT_ACT = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "geglu": lambda x: F.gelu(x, approximate="tanh"),
    "quick_geglu": lambda x: x * torch.sigmoid(1.702 * x),
    "relu2": lambda x: torch.square(F.relu(x)),
}


def gated_combine(g, u, kind: str, limit: float = 7.0):
    """gate/up → MLP inner. "swigluoai" is gpt-oss's clamped variant:
    min(g,limit)·sigmoid(1.702·g)·(clip(u,±limit)+1); others are act(g)·u."""
    if kind == "swigluoai":
        g = torch.clamp(g, max=limit)
        u = torch.clamp(u, -limit, limit)
        return g * torch.sigmoid(1.702 * g) * (u + 1.0)
    return _EXPERT_ACT[kind](g) * u


def init_experts(cfg: MoEConfig, hidden_size: int, gen: torch.Generator,
                 dtype: torch.dtype = torch.float32,
                 num_layers: int | None = None) -> dict:
    """(E, H, I) / (E, I, H) expert kernels (stacked on dim 0 with
    `num_layers`), fan-in std as the JAX init."""
    _, zeros, dense = init_fns(gen, dtype)
    lead = () if num_layers is None else (num_layers,)
    E, H, I = cfg.n_routed_experts, hidden_size, cfg.moe_intermediate_size
    params = {
        "up_proj": {"kernel": dense(*lead, E, H, I)},
        "down_proj": {"kernel": dense(*lead, E, I, H)},
    }
    if cfg.gated_experts:
        params["gate_proj"] = {"kernel": dense(*lead, E, H, I)}
    if cfg.expert_bias:
        params["up_proj"]["bias"] = zeros(*lead, E, I)
        params["down_proj"]["bias"] = zeros(*lead, E, H)
        if cfg.gated_experts:
            params["gate_proj"]["bias"] = zeros(*lead, E, I)
    return params


def expert_param_specs(cfg: MoEConfig) -> dict:
    """Logical axes of the (E, in, out) expert leaves (JAX `:69`)."""
    specs = {
        "up_proj": {"kernel": ("expert", "expert_embed", "expert_mlp")},
        "down_proj": {"kernel": ("expert", "expert_mlp", "expert_embed")},
    }
    if cfg.gated_experts:
        specs["gate_proj"] = {"kernel": ("expert", "expert_embed", "expert_mlp")}
    if cfg.expert_bias:
        specs["up_proj"]["bias"] = ("expert", "expert_mlp")
        specs["down_proj"]["bias"] = ("expert", "expert_embed")
        if cfg.gated_experts:
            specs["gate_proj"]["bias"] = ("expert", "expert_mlp")
    return specs


def _expert_linear(rows, p, offs, expert):
    """rows (TK, in) sorted by expert -> (TK, out) through each row's expert.

    bf16 runs `torch._grouped_mm` over the group ends `offs`: one launch,
    each group's rows through its expert's kernel (E, in, out) as stored.
    It needs in and out to be multiples of 8 (16-byte strides) and writes
    no row past `offs[-1]`. On the card it takes bf16 alone: other dtypes
    take a fallback that copies `offs` to the host. So every other dtype
    runs each row through every expert and keeps its own expert's result:
    E times the products, one batched launch, no host read. Only fp32
    parity checks run that route."""
    kernel = p["kernel"].to(rows.dtype)
    if rows.dtype == torch.bfloat16:
        y = torch._grouped_mm(rows, kernel, offs=offs)
        if y.requires_grad:
            # its backward refuses a cotangent with zero strides (an
            # expanded one, as `.sum()` hands down)
            y.register_hook(torch.Tensor.contiguous)
    else:
        every = torch.matmul(rows, kernel)  # (E, TK, out)
        y = every[expert, torch.arange(rows.shape[0], device=rows.device)]
    if "bias" in p:
        y = y + p["bias"].to(rows.dtype)[expert]
    return y


def _expert_mlp(params: dict, cfg: MoEConfig, xs, offs, expert):
    """Rows sorted by expert through their gated MLP (groups end at offs)."""
    u = _expert_linear(xs, params["up_proj"], offs, expert)
    if cfg.gated_experts:
        g = _expert_linear(xs, params["gate_proj"], offs, expert)
        h_in = gated_combine(g, u, cfg.expert_activation, cfg.swiglu_limit)
    else:
        h_in = _EXPERT_ACT[cfg.expert_activation](u)
    return _expert_linear(h_in, params["down_proj"], offs, expert)


def compute_capacity(cfg: MoEConfig, num_tokens: int) -> int:
    """Pairs each expert's buffer holds: the even share times
    `capacity_factor`, at least 8 and rounded up to a multiple of 8."""
    per_expert = num_tokens * cfg.experts_per_token / cfg.n_routed_experts
    cap = int(per_expert * cfg.capacity_factor)
    return max(8, ((cap + 7) // 8) * 8)


def dispatch_tensors(
    cfg: MoEConfig,
    indices: torch.Tensor,  # (T, K) integer; E marks a masked token
    weights: torch.Tensor,  # (T, K) f32
    capacity: int,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch one-hot (T, E, C) in `dtype` and the combine weights
    (T, E) f32. The position of a pair within expert e's buffer is the
    number of earlier (token, slot) pairs routed to e, a cumsum over the
    flattened (T*K) routing order (Megatron's capacity semantics); pairs at
    or past `capacity` are dropped. A masked pair (index E) matches no
    expert and takes no place. The K slots accumulate into the (T, E, C)
    tensor one by one: no (T*K, E, C) tensor is made."""
    T, K = indices.shape
    E = cfg.n_routed_experts
    experts = torch.arange(E, device=indices.device)
    onehot = (indices.reshape(T * K, 1) == experts).to(torch.int32)  # (T*K, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos_in_expert = (pos * onehot).sum(-1).reshape(T, K)
    keep = (pos_in_expert < capacity).to(dtype)  # (T, K)
    slots = torch.arange(capacity, device=indices.device)
    dispatch = torch.zeros((T, E, capacity), dtype=dtype, device=indices.device)
    combine_w = torch.zeros((T, E), dtype=torch.float32, device=indices.device)
    for k in range(K):
        eh = (indices[:, k:k + 1] == experts).to(dtype)                # (T, E)
        ch = (pos_in_expert[:, k:k + 1] == slots).to(dtype)            # (T, C)
        kept_e = eh * keep[:, k:k + 1]
        dispatch = dispatch + kept_e[:, :, None] * ch[:, None, :]
        combine_w = combine_w + kept_e.float() * weights[:, k][:, None]
    return dispatch, combine_w


def experts_forward(
    params: dict,
    cfg: MoEConfig,
    x: torch.Tensor,          # (T, H)
    dispatch: torch.Tensor,   # (T, E, C) one-hot
    combine_w: torch.Tensor,  # (T, E) routing weights
) -> torch.Tensor:
    """Dispatch -> batched expert MLP -> weighted combine. Returns (T, H).
    The per-token routing weight factors as (T, E) and joins the combine
    product: no second (T, E, C) tensor."""
    dtype = x.dtype
    xe = torch.einsum("tec,th->ech", dispatch.to(dtype), x)

    def linear(a, p):
        y = torch.einsum("ech,ehi->eci", a, p["kernel"].to(dtype))
        if "bias" in p:
            y = y + p["bias"].to(dtype)[:, None, :]
        return y

    u = linear(xe, params["up_proj"])
    if cfg.gated_experts:
        g = linear(xe, params["gate_proj"])
        h_in = gated_combine(g, u, cfg.expert_activation, cfg.swiglu_limit)
    else:
        h_in = _EXPERT_ACT[cfg.expert_activation](u)
    y = linear(h_in, params["down_proj"])
    return torch.einsum("tec,te,ech->th", dispatch.to(dtype),
                        combine_w.to(dtype), y)


def experts_forward_dropless(
    params: dict,
    cfg: MoEConfig,
    x: torch.Tensor,        # (T, H)
    weights: torch.Tensor,  # (T, K)
    indices: torch.Tensor,  # (T, K); E marks a masked token
) -> torch.Tensor:
    """Dropless sort-based dispatch: (token, slot) pairs sorted stably by
    expert, each expert's rows through its gated MLP, rows weighted and
    added back into token order. Masked pairs (index E) sort last, past
    every group, and contribute exactly 0."""
    T, H = x.shape
    K, E = cfg.experts_per_token, cfg.n_routed_experts
    dtype = x.dtype

    flat_expert = indices.reshape(T * K).long()
    # stable sort groups rows by expert while keeping token order within
    sort_idx = torch.argsort(flat_expert, stable=True)
    token_of = sort_idx // K
    expert_of = flat_expert[sort_idx]
    valid = (expert_of < E)[:, None]
    # masked pairs' rows sort past the last group, where the grouped product
    # neither reads nor writes, nor does its backward: `where` (not a
    # product, as 0 * NaN is NaN) keeps what lies there out of the output
    # and, in a hook that only the backward runs, out of x's gradient
    xs = x[token_of]  # (TK, H)
    if xs.requires_grad:
        xs.register_hook(lambda g: torch.where(valid, g, 0))
    # group ends on the device: offs[e] = pairs routed to experts 0..e
    # (`bincount` on the card reads its input's maximum to the host)
    offs = torch.searchsorted(
        expert_of, torch.arange(1, E + 1, device=x.device), out_int32=True)
    # masked pairs carry the sentinel E: clipped for the bias gathers (as the
    # JAX path does), zeroed in the combine below
    safe_expert = torch.clamp(expert_of, 0, E - 1)

    y = _expert_mlp(params, cfg, xs, offs, safe_expert)

    w_sorted = weights.reshape(T * K)[sort_idx].to(dtype)
    # rows of masked pairs hold whatever the grouped product left there
    # (`ragged_dot` gives 0): zeroed before the weighting, so that neither
    # the output nor the weights' gradient (y times the cotangent) sees them
    y = torch.where(valid, y, 0)
    return torch.zeros((T, H), dtype=dtype, device=x.device).index_add_(
        0, token_of, y * w_sorted[:, None])


def experts_forward_dropless_ep(
    params: dict,           # this rank's experts: (E/ep, ...) leaves
    cfg: MoEConfig,
    x: torch.Tensor,        # (T, H) this rank's tokens
    weights: torch.Tensor,  # (T, K)
    indices: torch.Tensor,  # (T, K) global expert ids; E marks a masked token
    group,                  # the ep process group
    return_rows: bool = False,
):
    """Dropless dispatch across the `ep` ranks of `group`. Returns (T, H),
    and with `return_rows` also the (T*K, H) expert outputs of this rank's
    (token, slot) pairs before weighting, in (token, slot) order (masked
    pairs 0), for holding each expert's output to the unsharded path."""
    T, H = x.shape
    K, E = cfg.experts_per_token, cfg.n_routed_experts
    P = dist.get_world_size(group)
    if E % P:
        raise ValueError(f"n_routed_experts={E} not divisible by ep={P}")
    E_loc = E // P
    dtype, dev = x.dtype, x.device

    flat_expert = indices.reshape(T * K).long()
    sort_idx = torch.argsort(flat_expert, stable=True)
    token_of = sort_idx // K
    expert_of = flat_expert[sort_idx]
    # rows per expert on the device (sentinel E counts nowhere), then the
    # counts each peer sends this rank for each of its local experts
    ends = torch.searchsorted(expert_of, torch.arange(1, E + 1, device=dev))
    send_e = torch.diff(ends, prepend=ends.new_zeros(1))          # (E,)
    recv_e = torch.empty_like(send_e)
    dist.all_to_all_single(recv_e, send_e, group=group)           # (P*E_loc,)
    # the one host read of the layer: both directions' split sizes
    host = torch.cat([send_e, recv_e]).cpu()
    send_splits = host[:E].reshape(P, E_loc).sum(1).tolist()
    recv_splits = host[E:].reshape(P, E_loc).sum(1).tolist()
    n_send, n_recv = sum(send_splits), sum(recv_splits)

    xs = x[token_of[:n_send]]                                     # valid rows
    recv_x = all_to_all(xs, recv_splits, send_splits, group)      # (n_recv, H)
    # received rows come by (peer, expert): regroup them by local expert
    local_e = torch.repeat_interleave(
        torch.arange(E_loc, device=dev).repeat(P), recv_e.long(), output_size=n_recv)
    sort2 = torch.argsort(local_e, stable=True)
    offs = torch.cumsum(recv_e.reshape(P, E_loc).sum(0), 0).to(torch.int32)
    y2 = _expert_mlp(params, cfg, recv_x[sort2], offs, local_e[sort2])
    y_recv = torch.empty_like(y2).index_copy(0, sort2, y2)
    ys = all_to_all(y_recv, send_splits, recv_splits, group)      # (n_send, H)
    w_sorted = weights.reshape(T * K)[sort_idx[:n_send]].to(dtype)
    out = torch.zeros((T, H), dtype=dtype, device=dev).index_add_(
        0, token_of[:n_send], ys * w_sorted[:, None])
    if not return_rows:
        return out
    rows = torch.zeros((T * K, H), dtype=dtype, device=dev).index_copy(
        0, sort_idx[:n_send], ys)
    return out, rows


def shared_expert_forward(params: dict, cfg: MoEConfig,
                          flat: torch.Tensor) -> torch.Tensor:
    """Dense shared-expert branch added to the routed output (DeepSeek /
    Qwen-MoE style)."""
    u = flat @ params["up_proj"]["kernel"]
    if cfg.shared_expert_is_gated:
        g = flat @ params["gate_proj"]["kernel"]
        inner = gated_combine(g, u, cfg.shared_expert_activation, cfg.swiglu_limit)
    else:
        inner = _EXPERT_ACT[cfg.shared_expert_activation](u)
    out = inner @ params["down_proj"]["kernel"]
    if cfg.shared_expert_gated:
        out = out * torch.sigmoid(flat @ params["gate"]["kernel"])
    return out
