"""Fused linear + cross-entropy: the lm_head loss without materialized
logits (port of `automodel_tpu/loss/linear_ce.py`).

The sequence is projected through the lm_head in chunks, each under
`torch.utils.checkpoint`, so the forward keeps no chunk's logits and the
backward recomputes one (chunk, vocab) block at a time: peak memory holds one
such block instead of (batch * seq, vocab). The product is a plain matrix
product with an fp32 result (`ops/matmul.py`), as XLA ran it.

With `vocab_group` (the `tp` group of a vocab-sharded head) the kernel is
this rank's (H, V/tp) slice, whose first column is vocab row
`vocab_start`: the log-sum-exp takes the max and the sum of exponentials
over the group, the label's logit comes from the rank that holds it, and
the hidden state enters through `copy_to` (its gradient is the sum of the
ranks' partial ones). Every rank of the group computes the same loss.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX
from automodel_tpu_torch.ops.matmul import matmul_fp32
from automodel_tpu_torch.parallel.collectives import (
    all_reduce_max,
    copy_to,
    reduce_from,
)


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


def _chunk_ce_vocab_parallel(h, kernel, labels, weights, ignore_index,
                             logits_soft_cap, group, start):
    logits = matmul_fp32(h, kernel.to(h.dtype))  # (chunk, V / tp)
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    mask = labels != ignore_index
    m = all_reduce_max(logits.max(-1).values, group)
    lse = m + torch.log(reduce_from(torch.exp(logits - m[:, None]).sum(-1), group))
    rel = labels.long() - start
    inside = mask & (rel >= 0) & (rel < logits.shape[-1])
    picked = torch.gather(logits, -1, torch.where(inside, rel, 0)[:, None])[:, 0]
    picked = reduce_from(torch.where(inside, picked, 0.0), group)
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
    vocab_group=None,
    vocab_start: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sum_ce_fp32, num_valid_tokens_fp32). `token_weights` scales
    each valid token's CE before the sum; the count stays unweighted."""
    if vocab_group is not None:
        hidden = copy_to(hidden, vocab_group)
    B, S, H = hidden.shape
    flat_h = hidden.reshape(B * S, H)
    flat_l = labels.reshape(B * S)
    flat_w = None if token_weights is None else token_weights.reshape(B * S).float()
    ce_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, B * S, chunk_size):
        sl = slice(start, start + chunk_size)
        w = None if flat_w is None else flat_w[sl]
        if vocab_group is None:
            ce = checkpoint(_chunk_ce, flat_h[sl], lm_head_kernel, flat_l[sl], w,
                            ignore_index, logits_soft_cap, use_reentrant=False)
        else:
            ce = checkpoint(_chunk_ce_vocab_parallel, flat_h[sl], lm_head_kernel,
                            flat_l[sl], w, ignore_index, logits_soft_cap, vocab_group,
                            vocab_start, use_reentrant=False)
        ce_sum = ce_sum + ce
    n = (flat_l != ignore_index).sum().float()
    return ce_sum, n
