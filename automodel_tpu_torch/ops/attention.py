"""Attention entry point (port of `automodel_tpu/ops/attention.py`).

Backends:

- "xla" (alias "torch"): einsum + fp32 masked softmax, the plain path and
  the oracle of the flash kernels; differentiable by autograd.
- "flash": `ops/flash_attention.py`, whose passes are the hand-written
  kernels K1-K3 on CUDA tensors and their plain versions on CPU tensors.
- "auto": flash for CUDA tensors, xla for CPU tensors.

Unlike the JAX dispatcher, "flash" never falls back to "xla": a case the
kernels do not cover raises NotImplementedError on the card.

Supports GQA, causal and bidirectional masks, packed-sequence segment ids,
sliding windows, logit soft-capping and attention sinks.
"""

from __future__ import annotations

from typing import Literal

import torch

from automodel_tpu_torch.ops.flash_attention import NEG_INF, flash_attention

AttnImpl = Literal["auto", "xla", "torch", "flash"]


def make_attention_mask(
    q_len: int,
    kv_len: int,
    *,
    causal: bool = True,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    sliding_window: int | None = None,
    device=None,
) -> torch.Tensor | None:
    """Boolean mask (B?, q_len, kv_len); True = attend."""
    masks = []
    if causal or sliding_window is not None:
        qp = q_positions if q_positions is not None else torch.arange(q_len, device=device)
        kp = kv_positions if kv_positions is not None else torch.arange(kv_len, device=device)
    if causal:
        masks.append(qp[..., :, None] >= kp[..., None, :])
    if sliding_window is not None:
        masks.append(qp[..., :, None] - kp[..., None, :] < sliding_window)
        if not causal:
            # bidirectional local attention: the window is two-sided
            masks.append(kp[..., None, :] - qp[..., :, None] < sliding_window)
    if q_segment_ids is not None and kv_segment_ids is not None:
        masks.append(q_segment_ids[..., :, None] == kv_segment_ids[..., None, :])
    if not masks:
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


def xla_attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, Dv)
    *,
    mask: torch.Tensor | None,
    scale: float | None = None,
    logits_soft_cap: float | None = None,
    sinks: torch.Tensor | None = None,  # (Hq,) learnable sink logits
) -> torch.Tensor:
    """Reference einsum attention; softmax in fp32. `sinks` (gpt-oss): one
    virtual kv slot per head whose logit is learned; it joins the softmax
    denominator but contributes no value."""
    B, S, Hq, D = q.shape
    _, T, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {Hq} % {Hkv}")
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    qg = q.reshape(B, S, Hkv, G, D)
    # fp32 result of the (possibly bf16) product, like preferred_element_type
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    if sinks is not None:
        sink = sinks.float().reshape(1, Hkv, G, 1, 1).expand(B, Hkv, G, S, 1)
        logits = torch.cat([logits, sink], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    if sinks is not None:
        probs = probs[..., :-1]
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    # v's head dim may differ from q/k's (MLA): reshape with v's
    return out.reshape(B, S, Hq, v.shape[-1])


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    sliding_window: int | None = None,
    logits_soft_cap: float | None = None,
    scale: float | None = None,
    sinks: torch.Tensor | None = None,
    impl: AttnImpl = "auto",
) -> torch.Tensor:
    """Main attention entry. Shapes: q (B,S,Hq,D); k,v (B,T,Hkv,D)."""
    resolved = impl
    if impl == "auto":
        resolved = "flash" if q.is_cuda else "xla"
    if resolved == "flash":
        return flash_attention(
            q, k, v,
            causal=causal,
            segment_ids=segment_ids,
            positions=positions,
            sliding_window=sliding_window,
            logits_soft_cap=logits_soft_cap,
            scale=scale,
            sinks=sinks,
        )
    if resolved in ("xla", "torch"):
        mask = make_attention_mask(
            q.shape[1], k.shape[1],
            causal=causal,
            q_segment_ids=segment_ids,
            kv_segment_ids=segment_ids,
            q_positions=positions,
            kv_positions=positions,
            sliding_window=sliding_window,
            device=q.device,
        )
        return xla_attention(
            q, k, v, mask=mask, scale=scale,
            logits_soft_cap=logits_soft_cap, sinks=sinks,
        )
    raise ValueError(f"Unknown attention impl '{impl}'")
