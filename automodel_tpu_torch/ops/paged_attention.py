"""Ragged paged attention over a paged KV pool (port of
`automodel_tpu/ops/paged_attention.py`, GQA with fp pages).

Query tokens arrive as ONE flat ragged batch (decode rows of many requests
interleaved with chunked-prefill rows) and the KV cache lives in fixed-size
pages of a global pool, indexed per token through a page table:

- q (T, Hq, D); k_pages (N+1, ps, Hkv, D); v_pages (N+1, ps, Hkv, Dv);
- page_tables (T, P) int32, dense prefixes padded with a valid page index
  (the pool's trash page);
- positions (T,) int32: row t attends to global kv index
  `page_idx * ps + offset <= positions[t]`; positions[t] < 0 marks a pad
  row, whose output is 0.

Two implementations:

- `ragged_paged_attention_ref`: the plain PyTorch version (gather + masked
  softmax). It covers windows and sinks, runs on any device, and is what the
  CUDA kernel is checked against.
- the hand-written CUDA kernel (`ops/cuda/ragged_paged_attention.py`,
  `csrc/ragged_paged_attention.cu`) for CUDA tensors.

`ragged_paged_attention(impl="auto")` picks the kernel for CUDA tensors and
the plain version for CPU tensors. There is no fallback: a feature the kernel
does not cover (sliding windows, sinks) raises on CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: the JAX package's masked-logit value (ops/attention.py NEG_INF)
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _gather_mask(positions, page_size: int, P: int, window=None):
    """(T, P*ps) attend mask from positions (pads → all-False)."""
    kv_idx = torch.arange(P * page_size, device=positions.device)
    mask = kv_idx[None, :] <= positions[:, None]  # causal + allocation bound
    if window is not None:
        # window == 0 → global (the layer-loop convention of the engine)
        window = torch.as_tensor(window, device=positions.device)
        dist = positions[:, None] - kv_idx[None, :]
        mask = mask & ((window == 0) | (dist < window))
    return mask


def ragged_paged_attention_ref(
    q: torch.Tensor,            # (T, Hq, D)
    k_pages: torch.Tensor,      # (N, ps, Hkv, D)
    v_pages: torch.Tensor,      # (N, ps, Hkv, Dv)
    page_tables: torch.Tensor,  # (T, P) int32 — per-TOKEN page table row
    positions: torch.Tensor,    # (T,) int32; -1 = pad row
    *,
    scale: float,
    window=None,                # per-layer window; 0/None = global
    soft_cap: float | None = None,
    sinks: torch.Tensor | None = None,  # (Hq,) learned sink logits
) -> torch.Tensor:
    """Gather-based plain version; returns (T, Hq, Dv) with pad rows zeroed.
    Scores and softmax run in fp32; probabilities are cast to the value
    dtype for the value product, as in the JAX reference."""
    T, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    Dv = v_pages.shape[-1]
    P = page_tables.shape[1]
    G = Hq // Hkv
    positions = positions.long()

    pt = page_tables.long()
    keys = k_pages[pt].reshape(T, P * ps, Hkv, D)
    values = v_pages[pt].reshape(T, P * ps, Hkv, Dv)

    qg = q.reshape(T, Hkv, G, D)
    s = torch.einsum("tkgd,tckd->tkgc", qg.float(), keys.float()) * scale
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    mask = _gather_mask(positions, ps, P, window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    if sinks is not None:
        sink = sinks.float().reshape(1, Hkv, G, 1).expand(T, Hkv, G, 1)
        s = torch.cat([s, sink], dim=-1)
    p = F.softmax(s, dim=-1)
    if sinks is not None:
        p = p[..., :-1]
    # pad rows (positions < 0): every slot masked → softmax is uniform junk
    # (or all mass on the sink); zero the output explicitly
    p = torch.where(positions[:, None, None, None] >= 0, p, 0.0)
    o = torch.einsum("tkgc,tckd->tkgd", p.to(values.dtype), values)
    return o.reshape(T, Hq, Dv)


def ragged_paged_attention(
    q, k_pages, v_pages, page_tables, positions,
    *,
    scale: float | None = None,
    window=None,
    soft_cap: float | None = None,
    sinks=None,
    impl: str = "auto",
):
    """GQA entry. impl: "auto" (the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors) | "cuda" | "torch". The kernel raises for what
    it does not cover; nothing here switches to the plain version."""
    scale = scale if scale is not None else float(q.shape[-1]) ** -0.5
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    if impl == "cuda":
        if window is not None or sinks is not None:
            raise NotImplementedError(
                "the CUDA paged attention kernel covers neither sliding "
                "windows nor sinks"
            )
        from automodel_tpu_torch.ops.cuda.ragged_paged_attention import (
            ragged_paged_attention_cuda,
        )

        return ragged_paged_attention_cuda(
            q, k_pages, v_pages, page_tables, positions,
            scale=scale, soft_cap=soft_cap,
        )
    if impl == "torch":
        return ragged_paged_attention_ref(
            q, k_pages, v_pages, page_tables, positions,
            scale=scale, window=window, soft_cap=soft_cap, sinks=sinks,
        )
    raise ValueError(f"Unknown paged attention impl '{impl}'")
