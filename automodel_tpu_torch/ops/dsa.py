"""DSA, DeepSeek Sparse Attention: the V3.2/V4 lightning indexer (port of
`automodel_tpu/ops/dsa.py`).

1. The indexer scores every (query, key) pair through a few small ReLU
   heads:  I[t,s] = Σ_h w[t,h] · ReLU(q_idx[t,h,:] · k_idx[s,:]) · Di**-0.5
2. per query, the top-k keys admitted by the causal/segment mask are
   selected;
3. MLA attention runs over the selection (`models/llm/mla.py`: a dense
   additive mask in the oracle, gathered latents in the chunked path).

The hard top-k passes no gradient, so the indexer learns from a KL term
against the main attention's head-averaged distribution (the target
detached), returned as an aux loss the recipe folds into the total.

Top-k ties: `jax.lax.top_k` keeps the lowest index among equal values, and
the GLM indexer's relu makes exact-zero ties in bulk. `torch.topk` documents
no tie order, so `stable_topk` takes the first k of a STABLE descending sort,
which keeps equal values in index order: the same set, in the same order.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.ops.flash_attention import NEG_INF
from automodel_tpu_torch.ops.matmul import bmm_fp32
from automodel_tpu_torch.ops.rope import apply_rope


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last dim, ties
    broken by the lowest index, as `jax.lax.top_k`."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pair_dots(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B, T, Hi, Di) against k (B, S, Di) -> (B, Hi, T, S) dot products
    with an fp32 result (`preferred_element_type=float32`)."""
    B, T, Hi, Di = q.shape
    a = q.permute(0, 2, 1, 3).reshape(B, Hi * T, Di)
    return bmm_fp32(a, k.transpose(1, 2)).reshape(B, Hi, T, k.shape[1])


def indexer_scores(x, ip, n_heads: int, head_dim: int, positions, inv_freq):
    """Lightning indexer scores (B, S, S) fp32 (queries x keys); `ip` holds
    the {"wq", "wk", "wgate"} kernels, `inv_freq` the rope (or None)."""
    B, S, _ = x.shape
    q = (x @ ip["wq"]["kernel"].to(x.dtype)).reshape(B, S, n_heads, head_dim)
    k = (x @ ip["wk"]["kernel"].to(x.dtype)).reshape(B, S, 1, head_dim)
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    w = x @ ip["wgate"]["kernel"].to(x.dtype)  # (B, S, n_heads)
    dots = torch.relu(pair_dots(q, k[:, :, 0, :])) * (head_dim ** -0.5)
    return torch.einsum("bth,bhts->bts", w.float(), dots)


def indexer_scores_glm(x, q_lat, ip, n_heads: int, head_dim: int, positions,
                       inv_freq):
    """GLM-5.x IndexShare indexer scores (B, S, S) fp32: queries project
    from the MLA q-lora residual `q_lat`, keys are LayerNorm'd (bias, eps
    1e-6), the rope slice comes first (`inv_freq` of the rope head dim), and
    the gate weights carry an extra n_heads**-0.5."""
    B, S, _ = x.shape
    q = (q_lat @ ip["wq"]["kernel"].to(x.dtype)).reshape(B, S, n_heads, head_dim)
    k = layer_norm_keys(x @ ip["wk"]["kernel"].to(x.dtype), ip["k_norm"])
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k[:, :, None, :], positions, inv_freq)[:, :, 0, :]
    w = (x @ ip["wgate"]["kernel"].to(x.dtype)).float() * (n_heads ** -0.5)
    dots = torch.relu(pair_dots(q, k) * (head_dim ** -0.5))
    return torch.einsum("bth,bhts->bts", w, dots)


def layer_norm_keys(k: torch.Tensor, norm: dict) -> torch.Tensor:
    """The GLM indexer's key LayerNorm in fp32, back to k's dtype."""
    kf = k.float()
    mu = kf.mean(-1, keepdim=True)
    var = kf.var(-1, unbiased=False, keepdim=True)
    kf = (kf - mu) * torch.rsqrt(var + 1e-6)
    return (kf * norm["scale"].float() + norm["bias"].float()).to(k.dtype)


def topk_select_mask(scores: torch.Tensor, base_mask: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean (B, S, S) selection: per query EXACTLY the top-k admissible
    keys (lowest index wins a tie); every admissible key when fewer than k
    are (early queries under causality)."""
    if base_mask.dim() == 2:
        base_mask = base_mask[None].expand(scores.shape)
    masked = torch.where(base_mask, scores, -torch.inf)
    k = min(k, scores.shape[-1])
    vals, idx = stable_topk(masked, k)
    sel = torch.zeros(masked.shape, dtype=torch.bool, device=scores.device)
    sel = sel.scatter(-1, idx, torch.isfinite(vals))
    return sel & base_mask


def indexer_kl_loss(scores, main_probs, select_mask, token_mask=None) -> torch.Tensor:
    """KL(p_main ‖ p_indexer) over the selected set, mean per real query.
    Both distributions renormalize over the selected keys; the main
    attention target is detached, so only the indexer learns from this
    term. Pad queries (`token_mask` False) are left out."""
    s = torch.where(select_mask, scores, NEG_INF)
    logq = torch.log_softmax(s, dim=-1)
    p = torch.where(select_mask, main_probs.detach(), 0.0)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-9)
    logp = torch.log(torch.clamp(p, min=1e-9))
    kl = torch.sum(p * (logp - logq), dim=-1)  # (B, S)
    if token_mask is None:
        return kl.mean()
    m = token_mask.float()
    return torch.sum(kl * m) / torch.clamp(m.sum(), min=1.0)
