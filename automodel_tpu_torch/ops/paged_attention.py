"""Ragged paged attention over a paged KV pool (port of
`automodel_tpu/ops/paged_attention.py`: GQA and absorbed MLA, over fp pages
and over int8 pages with per-row scales).

Query tokens arrive as ONE flat ragged batch (decode rows of many requests
interleaved with chunked-prefill rows) and the KV cache lives in fixed-size
pages of a global pool, indexed per token through a page table:

- GQA: q (T, Hq, D); k_pages (N+1, ps, Hkv, D); v_pages (N+1, ps, Hkv, Dv);
- MLA: queries come pre-absorbed, q_abs (T, n, r) and q_rope (T, n, dr),
  over latent pages c_pages (N+1, ps, r) and rope pages kr_pages
  (N+1, ps, dr); the output stays in latent space (T, n, r);
- int8 pools (serving kv_cache_dtype="int8"): the same page layouts hold
  int8, with (N+1, ps) fp32 per-row scales beside each page array;
- page_tables (T, P) int32, dense prefixes padded with a valid page index
  (the pool's trash page);
- positions (T,) int32: row t attends to global kv index
  `page_idx * ps + offset <= positions[t]`; positions[t] < 0 marks a pad
  row, whose output is 0.

Two implementations of each:

- `ragged_paged_attention_ref` (K4, and K5 with `k_scales`/`v_scales`) and
  `ragged_paged_mla_attention_ref` (K6, and K7 with `c_scales`/
  `kr_scales`): the plain PyTorch versions (gather + masked softmax, int8
  pages dequantized on the gathered view), ports of the JAX XLA
  references. They run on any device and are what the CUDA kernels are
  checked against.
- the hand-written CUDA kernels (`ops/cuda/ragged_paged_attention.py`,
  `ops/cuda/paged_mla_attention.py`) for CUDA tensors.

The dispatchers pick the kernel for CUDA tensors and the plain version for
CPU tensors (`impl="auto"`). There is no fallback: a feature a kernel does
not cover (a sliding window in K6/K7: no MLA family has one) raises on
CUDA tensors. K4 and K5 take the engine's per-layer window (an int, 0 for
a global layer) and the sink logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from automodel_tpu_torch.ops.quant import dequantize_kv

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


def _gather_pages(pages, scales, pt, dtype):
    """Each row's pages as one contiguous (T, P*ps, ...) view; int8 pages
    (with `scales`) are dequantized on the view and cast to `dtype`."""
    T, P = pt.shape
    view = pages[pt].reshape(T, P * pages.shape[1], *pages.shape[2:])
    if scales is None:
        return view
    return dequantize_kv(view, scales[pt].reshape(T, -1)).to(dtype)


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
    k_scales: torch.Tensor | None = None,  # (N, ps) per-row dequant scales
    v_scales: torch.Tensor | None = None,  # (int8 pages; None = fp pages)
) -> torch.Tensor:
    """Gather-based plain version; returns (T, Hq, Dv) with pad rows zeroed.
    Scores and softmax run in fp32; probabilities are cast to the value
    dtype for the value product, as in the JAX reference. With scales the
    pages are int8 and the gathered view is dequantized to q's dtype."""
    T, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    P = page_tables.shape[1]
    G = Hq // Hkv
    positions = positions.long()

    pt = page_tables.long()
    keys = _gather_pages(k_pages, k_scales, pt, q.dtype)
    values = _gather_pages(v_pages, v_scales, pt, q.dtype)
    Dv = values.shape[-1]

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


def ragged_paged_mla_attention_ref(
    q_abs: torch.Tensor,        # (T, n, r) — q_nope absorbed through W_uk
    q_rope: torch.Tensor,       # (T, n, dr)
    c_pages: torch.Tensor,      # (N, ps, r) kv latents
    kr_pages: torch.Tensor,     # (N, ps, dr) shared rotated key-rope head
    page_tables: torch.Tensor,  # (T, P)
    positions: torch.Tensor,    # (T,)
    *,
    scale: float,
    window=None,
    c_scales: torch.Tensor | None = None,   # (N, ps) per-row dequant scales
    kr_scales: torch.Tensor | None = None,  # (int8 pages; None = fp pages)
) -> torch.Tensor:
    """Absorbed-MLA plain version; returns latent-space outputs (T, n, r)
    with pad rows zeroed. Scores and softmax in fp32; the probabilities are
    cast to the latent dtype for the value product (the JAX reference's
    `p.astype(c.dtype)`, which the bf16 kernel repeats)."""
    ps = c_pages.shape[1]
    P = page_tables.shape[1]
    positions = positions.long()
    pt = page_tables.long()
    c = _gather_pages(c_pages, c_scales, pt, q_abs.dtype)
    kr = _gather_pages(kr_pages, kr_scales, pt, q_abs.dtype)
    s = torch.einsum("tnr,tcr->tnc", q_abs.float(), c.float())
    s = s + torch.einsum("tnd,tcd->tnc", q_rope.float(), kr.float())
    s = s * scale
    mask = _gather_mask(positions, ps, P, window)
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = F.softmax(s, dim=-1)
    p = torch.where(positions[:, None, None] >= 0, p, 0.0)
    return torch.einsum("tnc,tcr->tnr", p.to(c.dtype), c)


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"Unknown paged attention impl '{impl}'")
    return impl


def ragged_paged_attention(
    q, k_pages, v_pages, page_tables, positions,
    *,
    scale: float | None = None,
    window=None,
    soft_cap: float | None = None,
    sinks=None,
    impl: str = "auto",
    k_scales=None,
    v_scales=None,
):
    """GQA entry. impl: "auto" (the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors) | "cuda" | "torch". With `k_scales`/`v_scales`
    ((N, ps) per-row scales) the pages are int8: K5 instead of K4. `window`
    is None or an int (0: global), `sinks` None or (Hq,) logits (float32
    for the kernels). The kernels raise for what they do not cover;
    nothing here switches to the plain version."""
    scale = scale if scale is not None else float(q.shape[-1]) ** -0.5
    if _resolve(impl, q) == "torch":
        return ragged_paged_attention_ref(
            q, k_pages, v_pages, page_tables, positions,
            scale=scale, window=window, soft_cap=soft_cap, sinks=sinks,
            k_scales=k_scales, v_scales=v_scales,
        )
    from automodel_tpu_torch.ops.cuda import ragged_paged_attention as k

    # window 0 is a global layer (the engine's convention), None to the kernels
    kw = dict(scale=scale, soft_cap=soft_cap, window=int(window or 0) or None,
              sinks=sinks)
    if k_scales is not None:
        return k.ragged_paged_attention_quant_cuda(
            q, k_pages, v_pages, k_scales, v_scales, page_tables, positions, **kw)
    return k.ragged_paged_attention_cuda(q, k_pages, v_pages, page_tables, positions, **kw)


def ragged_paged_mla_attention(
    q_abs, q_rope, c_pages, kr_pages, page_tables, positions,
    *,
    scale: float,
    window=None,
    impl: str = "auto",
    c_scales=None,
    kr_scales=None,
):
    """MLA (absorbed latent-cache) entry; the same dispatch contract as the
    GQA one: K6 on fp pages, K7 on int8 pages (`c_scales`/`kr_scales`).
    Returns latent-space outputs (T, n, r)."""
    if _resolve(impl, q_abs) == "torch":
        return ragged_paged_mla_attention_ref(
            q_abs, q_rope, c_pages, kr_pages, page_tables, positions,
            scale=scale, window=window, c_scales=c_scales, kr_scales=kr_scales,
        )
    if window is not None:
        raise NotImplementedError(
            "the CUDA paged MLA kernels do not cover sliding windows")
    from automodel_tpu_torch.ops.cuda import paged_mla_attention as k

    if c_scales is not None:
        return k.paged_mla_attention_quant_cuda(
            q_abs, q_rope, c_pages, kr_pages, c_scales, kr_scales,
            page_tables, positions, scale=scale,
        )
    return k.paged_mla_attention_cuda(
        q_abs, q_rope, c_pages, kr_pages, page_tables, positions, scale=scale,
    )
