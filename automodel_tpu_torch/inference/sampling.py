"""Token-sampling filters (port of `automodel_tpu/inference/sampling.py`).

Semantics (HF `TopKLogitsWarper` / `TopPLogitsWarper`): top-k first, then
nucleus over the surviving distribution; `k=0/None` and `p>=1/None` mean
"off"; `p<=0` keeps the single best token (min_tokens_to_keep=1).
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.ops.paged_attention import NEG_INF


def filter_logits(
    logits: torch.Tensor,
    top_k: int | None = None,
    top_p: float | None = None,
) -> torch.Tensor:
    """Top-k / top-p filtering over the last axis; killed entries are set to
    NEG_INF."""
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1)[0][..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True)[0]
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose PRECEDING cumulative mass is < top_p (so the
        # token that crosses the threshold is included — HF convention)
        keep_sorted = (cum - probs) < top_p
        n_keep = torch.clamp(keep_sorted.sum(dim=-1, keepdim=True), min=1)
        thresh = torch.gather(sorted_logits, -1, n_keep - 1)
        logits = torch.where(logits < thresh, NEG_INF, logits)
    return logits
