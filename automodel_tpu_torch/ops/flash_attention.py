"""Flash attention forward and backward (port of
`automodel_tpu/ops/pallas/flash_attention.py`).

`flash_attention` keeps the JAX contract: q (B, S, Hq, D), k (B, T, Hkv, D),
v (B, T, Hkv, Dv) -> (B, S, Hq, Dv); causal masking by global index (or by
position when the kv side carries its own positions or segment ids), packed
segment ids, sliding windows, a logit soft cap, GQA, attention sinks, and a
differentiable lse with `return_lse=True`.

One `torch.autograd.Function` mirrors `_flash` / `_flash_fwd` / `_flash_bwd`:
the forward saves (out, lse); the backward forms
delta = rowsum(dO * O) - dlse in torch and runs the dq and dk/dv passes. The
sink rescale and d(sinks) stay in torch, as in the JAX wrapper. On CUDA
tensors the passes are the hand-written kernels K1-K3
(`ops/cuda/flash_attention.py`), instantiated for q/k and v head dims of
(16, 16), (64, 64), (128, 128) and MLA's (192, 128), which raise
NotImplementedError for what they do not cover (windows, position-causal
masking, other head dims); on CPU tensors they are the plain versions
below, which cover every mask and head dim. delta and dv run over v's head
dim, dq and dk over q/k's.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# sentinel lse of fully masked rows: keeps the backward's p = exp(s - lse) at 0
EMPTY_LSE = -NEG_INF


def flash_mask(B, S, T, *, causal_mode, qpos, qwin, qseg, kpos, kseg,
               has_window) -> torch.Tensor:
    """(B, S, T) boolean mask (True = attend) of the Pallas kernels'
    `_block_mask` over the whole extent. `causal_mode` is "index",
    "position" or None; the int arrays are (B, S) / (B, T)."""
    mask = qseg[:, :, None] == kseg[:, None, :]
    if causal_mode == "index":
        qi = torch.arange(S, device=qseg.device)[:, None]
        ki = torch.arange(T, device=qseg.device)[None, :]
        mask = mask & (qi >= ki)
    elif causal_mode == "position":
        mask = mask & (qpos[:, :, None] >= kpos[:, None, :])
    if has_window:
        mask = mask & (kpos[:, None, :] >= qwin[:, :, None])
        if causal_mode is None:
            mask = mask & (kpos[:, None, :] <= 2 * qpos[:, :, None] - qwin[:, :, None])
    return mask


def _scores(q, k, scale, soft_cap):
    """fp32 scores (B, Hkv, G, S, T) of the products of q and k, scaled and
    soft-capped; also returns tanh of the capped argument (or None)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    t = None
    if soft_cap is not None:
        t = torch.tanh(s / soft_cap)
        s = soft_cap * t
    return s, t


def flash_attention_ref(q, k, v, mask, *, scale: float,
                        soft_cap: float | None = None):
    """Plain version of K1: fp32 masked softmax. Returns out (B, S, Hq, Dv)
    in q's dtype and lse (B, Hq, S) fp32 with EMPTY_LSE on fully masked rows
    (whose output is 0). The probabilities are rounded to v's dtype before the
    value product, as the Pallas kernel does."""
    B, S, Hq, _ = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    s, _ = _scores(q, k, scale, soft_cap)
    m5 = mask[:, None, None]
    s = torch.where(m5, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(m5, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).float(), v.float())
    l_row = l[..., 0].permute(0, 3, 1, 2)[..., None]  # (B, S, Hkv, G, 1)
    out = torch.where(l_row > 0, acc / torch.where(l_row > 0, l_row, 1.0), 0.0)
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), EMPTY_LSE)
    return (out.reshape(B, S, Hq, Dv).to(q.dtype),
            lse[..., 0].reshape(B, Hq, S))


def flash_attention_bwd_ref(q, k, v, dout, lse, delta, mask, *, scale: float,
                            soft_cap: float | None = None):
    """Plain version of K2 and K3: (dq, dk, dv) from q, k, v, dout (q's
    dtype), the (B, Hq, S) fp32 lse and delta, by the formulas of
    `_recompute_p_ds`: p = exp(s - lse), ds = p * (dout.v^T - delta)
    (times 1 - tanh^2 under a soft cap), dq = scale ds.k, dk = scale ds^T.q,
    dv = p^T.dout. ds is rounded to the inputs' dtype before the dq and dk
    products, as the Pallas kernels do."""
    B, S, Hq, D = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    s, t = _scores(q, k, scale, soft_cap)
    m5 = mask[:, None, None]
    s = torch.where(m5, s, NEG_INF)
    p = torch.exp(s - lse.reshape(B, Hkv, G, S, 1))
    do = dout.float().reshape(B, S, Hkv, G, Dv)
    dp = torch.einsum("bskgd,btkd->bkgst", do, v.float())
    ds = p * (dp - delta.reshape(B, Hkv, G, S, 1))
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = torch.where(m5, ds, 0.0) * scale
    ds_lo = ds.to(q.dtype).float()
    dq = torch.einsum("bkgst,btkd->bskgd", ds_lo, k.float()).reshape(B, S, Hq, D)
    dk = torch.einsum("bkgst,bskgd->btkd", ds_lo,
                      q.float().reshape(B, S, Hkv, G, D))
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_args(causal_mode, qseg, has_seg):
    """(segment ids, causal) as K1-K3 take them: index-causal or none."""
    seg = qseg.to(torch.int32).contiguous() if has_seg else None
    return seg, causal_mode == "index"


class _Flash(torch.autograd.Function):
    """(q, k, v, sinks) -> (out, lse_pub), the JAX `_flash` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, sinks, aux, opts):
        (qpos, qwin, qseg, kpos, kseg) = aux
        causal_mode, has_window, asym, has_seg, soft_cap, scale = opts
        B, S, Hq, _ = q.shape
        T = k.shape[1]
        if q.is_cuda:
            from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

            fa_cuda.check_supported(
                q, k, v, sliding_window=True if has_window else None,
                position_causal=asym)
            seg, causal = _kernel_args(causal_mode, qseg, has_seg)
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse_raw = fa_cuda.flash_fwd_cuda(
                q, k, v, seg, scale=scale, soft_cap=soft_cap, causal=causal)
            mask = None
        else:
            mask = flash_mask(B, S, T, causal_mode=causal_mode, qpos=qpos,
                              qwin=qwin, qseg=qseg, kpos=kpos, kseg=kseg,
                              has_window=has_window)
            out, lse_raw = flash_attention_ref(q, k, v, mask, scale=scale,
                                               soft_cap=soft_cap)
        empty = lse_raw >= 0.5 * EMPTY_LSE
        lse_pub = torch.where(empty, NEG_INF, lse_raw)
        if sinks is not None:
            # the sink joins the denominator only: rescale out, lift lse; a
            # fully masked row puts all mass on the sink (out 0, lse = sink)
            sink_b = sinks.float().reshape(1, Hq, 1)
            lse_tot = torch.logaddexp(lse_pub, sink_b)
            scale_rows = torch.exp(lse_pub - lse_tot).transpose(1, 2)[..., None]
            out = (out.float() * scale_rows).to(out.dtype)
            lse_pub = lse_tot
        lse_res = torch.where(empty, EMPTY_LSE, lse_pub)
        ctx.save_for_backward(q, k, v, sinks, out, lse_pub, lse_res, mask, qseg)
        ctx.opts = (causal_mode, has_seg, soft_cap, scale)
        return out, lse_pub

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, sinks, out, lse_pub, lse_res, mask, qseg = ctx.saved_tensors
        causal_mode, has_seg, soft_cap, scale = ctx.opts
        Hq = q.shape[2]
        # delta = rowsum(dO * O) - dlse: the lse cotangent rides the same
        # p * (dp - delta) term (d lse / d s = p)
        dout32 = dout.float()
        delta = (dout32 * out.float()).sum(-1).transpose(1, 2)
        delta = (delta - dlse.float()).contiguous()
        do = dout32.to(q.dtype)
        if q.is_cuda:
            from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

            seg, causal = _kernel_args(causal_mode, qseg, has_seg)
            do = do.contiguous()
            kw = dict(scale=scale, soft_cap=soft_cap, causal=causal)
            dq = fa_cuda.flash_dq_cuda(q, k, v, do, lse_res, delta, seg, **kw)
            dk, dv = fa_cuda.flash_dkv_cuda(q, k, v, do, lse_res, delta, seg, **kw)
        else:
            dq, dk, dv = flash_attention_bwd_ref(
                q, k, v, do, lse_res, delta, mask, scale=scale,
                soft_cap=soft_cap)
        dsinks = None
        if sinks is not None:
            # d sink = p_sink * (0 - delta_tot + dlse) = -p_sink * delta
            p_sink = torch.exp(sinks.float().reshape(1, Hq, 1) - lse_pub)
            dsinks = -(p_sink * delta).sum((0, 2)).to(sinks.dtype)
        return dq, dk, dv, dsinks, None, None


def flash_attention(
    q, k, v,
    *,
    causal: bool = True,
    segment_ids=None,
    positions=None,
    kv_segment_ids=None,
    kv_positions=None,
    sliding_window=None,
    logits_soft_cap: float | None = None,
    scale: float | None = None,
    sinks=None,
    return_lse: bool = False,
):
    """Flash attention; q (B,S,Hq,D), k (B,T,Hkv,D), v (B,T,Hkv,Dv) ->
    (B,S,Hq,Dv). `kv_positions`/`kv_segment_ids` give the kv side its own
    coordinates and switch causal masking from global index to position.
    `sinks` is a (Hq,) vector of sink logits. With `return_lse=True` returns
    (out, lse), lse (B, Hq, S) fp32 (NEG_INF on fully masked rows) and
    differentiable. Raises NotImplementedError for q/k head dims that differ
    or Hq not a multiple of Hkv, and on CUDA tensors for what the kernels do
    not cover: nothing falls back to another implementation."""
    B, S, Hq, Dq = q.shape
    _, T, Hkv, Dk = k.shape
    if Dq != Dk:
        raise NotImplementedError("flash_attention: q/k head_dim mismatch")
    if Hq % Hkv != 0:
        raise NotImplementedError("flash_attention: GQA needs Hq % Hkv == 0")
    scale = scale if scale is not None else float(Dq) ** -0.5
    dev = q.device

    asym = kv_positions is not None or kv_segment_ids is not None
    if not causal:
        causal_mode = None
    elif asym:
        causal_mode = "position"
    else:
        causal_mode = "index"

    def as_int(x, n):
        return torch.as_tensor(x, device=dev).to(torch.int32).expand(B, n)

    qp = as_int(positions if positions is not None
                else torch.arange(S, device=dev)[None], S)
    kp = as_int(kv_positions if kv_positions is not None else qp, T) if asym else qp
    zeros_q = torch.zeros((B, S), dtype=torch.int32, device=dev)
    qs = as_int(segment_ids, S) if segment_ids is not None else zeros_q
    if asym:
        ks = (as_int(kv_segment_ids, T) if kv_segment_ids is not None
              else torch.zeros((B, T), dtype=torch.int32, device=dev))
    else:
        ks = qs
    has_window = sliding_window is not None
    qwin = qp - (int(sliding_window) - 1) if has_window else zeros_q

    out, lse = _Flash.apply(
        q, k, v, sinks, (qp, qwin, qs, kp, ks),
        (causal_mode, has_window, asym, segment_ids is not None,
         logits_soft_cap, float(scale)),
    )
    if return_lse:
        return out, lse
    return out
