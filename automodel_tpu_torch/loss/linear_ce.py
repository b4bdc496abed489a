"""Fused linear + cross-entropy: the lm_head loss without materialized
logits (port of `automodel_tpu/loss/linear_ce.py`).

The sequence is projected through the lm_head in chunks, each under
`torch.utils.checkpoint`, so the forward keeps no chunk's logits and the
backward recomputes one (chunk, vocab) block at a time: peak memory holds one
such block instead of (batch * seq, vocab). The product is a plain matrix
product with an fp32 result (`ops/matmul.py`), as XLA ran it.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX
from automodel_tpu_torch.ops.matmul import matmul_fp32


def _chunk_ce(h, kernel, labels, weights, ignore_index, logits_soft_cap):
    # the cast lives inside the chunk, as in the JAX scan body: each chunk's
    # kernel gradient is widened to fp32 before the chunks are summed
    logits = matmul_fp32(h, kernel.to(h.dtype))
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[:, None])[:, 0]
    ce = torch.where(mask, lse - picked, 0.0)
    if weights is not None:
        ce = ce * weights
    return ce.sum()


def fused_linear_cross_entropy(
    hidden: torch.Tensor,          # (B, S, H)
    lm_head_kernel: torch.Tensor,  # (H, V)
    labels: torch.Tensor,          # (B, S)
    *,
    chunk_size: int = 1024,
    ignore_index: int = IGNORE_INDEX,
    logits_soft_cap: float | None = None,
    token_weights: torch.Tensor | None = None,  # (B, S) per-token CE weight
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sum_ce_fp32, num_valid_tokens_fp32). `token_weights` scales
    each valid token's CE before the sum; the count stays unweighted."""
    B, S, H = hidden.shape
    flat_h = hidden.reshape(B * S, H)
    flat_l = labels.reshape(B * S)
    flat_w = None if token_weights is None else token_weights.reshape(B * S).float()
    ce_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, B * S, chunk_size):
        sl = slice(start, start + chunk_size)
        w = None if flat_w is None else flat_w[sl]
        ce_sum = ce_sum + checkpoint(
            _chunk_ce, flat_h[sl], lm_head_kernel, flat_l[sl], w, ignore_index,
            logits_soft_cap, use_reentrant=False,
        )
    n = (flat_l != ignore_index).sum().float()
    return ce_sum, n
