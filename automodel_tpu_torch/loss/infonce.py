"""InfoNCE contrastive loss and the embedding pools of the retrieval
recipes (port of `automodel_tpu/loss/infonce.py`). In-batch negatives:
each query's positive is its own document, every other document of the
batch a negative."""

from __future__ import annotations

import torch


def info_nce_loss(
    query_emb: torch.Tensor,  # (B, D)
    doc_emb: torch.Tensor,    # (B, D)
    *,
    temperature: float = 0.05,
    symmetric: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum loss, count), the framework's loss contract."""
    q = query_emb / (torch.linalg.vector_norm(query_emb, dim=-1, keepdim=True) + 1e-8)
    d = doc_emb / (torch.linalg.vector_norm(doc_emb, dim=-1, keepdim=True) + 1e-8)
    logits = (q @ d.T).float() / temperature  # (B, B)
    diag = torch.diagonal(logits)
    total = torch.sum(torch.logsumexp(logits, dim=-1) - diag)
    if symmetric:
        loss_d = torch.sum(torch.logsumexp(logits.T, dim=-1) - diag)
        total = 0.5 * (total + loss_d)
    return total, torch.tensor(float(q.shape[0]), device=q.device)


def mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pooling (B, S, H) -> (B, H)."""
    m = mask.to(hidden.dtype)[..., None]
    return torch.sum(hidden * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)


def normalized_mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """`mean_pool`, then L2-normalised: the bi-encoder recipes' embedding."""
    e = mean_pool(hidden, mask)
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-8)
