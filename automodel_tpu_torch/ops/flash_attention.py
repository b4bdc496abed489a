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
(`ops/cuda/flash_attention.py`, through `kernels_forward` and
`kernels_backward`), which take every mask and are instantiated for q/k and
v head dims of (16, 16), (64, 64), (128, 128), (256, 256) and MLA's
(192, 128): a head of other dims up to 256 runs at the smallest of these
that holds it, q and k zero-padded to its q/k dim and v to its v dim (the
Pallas entry pads every head dim to 128 lanes), and its outputs and
gradients are sliced back; above 256 raises NotImplementedError. On CPU
tensors the passes are the plain versions below, which cover every mask and
head dim. delta and dv run over v's head dim, dq and dk over q/k's.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.parallel.sharding import refuse_dtensor

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


def _kernel_kwargs(aux, opts) -> dict:
    """The mask keywords of K1-K3 for the JAX entry's masks: segment ids
    only where some were given, positions only where a window or the
    position-causal mode reads them, kv positions and segment ids of their
    own only in that mode (`asym`)."""
    qpos, _, qseg, kpos, kseg = aux
    causal_mode, window, asym, has_seg = opts[:4]
    return dict(causal=causal_mode is not None,
                segment_ids=qseg if has_seg else None,
                kv_segment_ids=kseg if asym and has_seg else None,
                positions=qpos if window is not None or asym else None,
                kv_positions=kpos if asym else None,
                sliding_window=window)


def _mask_inputs(B, S, T, device, *, causal=True, segment_ids=None,
                 positions=None, kv_segment_ids=None, kv_positions=None,
                 sliding_window=None):
    """The JAX entry's mask keywords as int32 arrays, aux = (qpos, qwin,
    qseg, kpos, kseg), (B, S) and (B, T), and the options (causal_mode,
    window, asym, has_seg): causal by position when the kv side has
    positions or segment ids of its own, else by index."""
    asym = kv_positions is not None or kv_segment_ids is not None
    causal_mode = None if not causal else ("position" if asym else "index")

    def as_int(x, n):
        return torch.as_tensor(x, device=device).to(torch.int32).expand(B, n)

    qp = as_int(positions if positions is not None
                else torch.arange(S, device=device)[None], S)
    zeros_q = torch.zeros((B, S), dtype=torch.int32, device=device)
    zeros_kv = torch.zeros((B, T), dtype=torch.int32, device=device)
    qs = as_int(segment_ids, S) if segment_ids is not None else zeros_q
    if asym:
        kp = as_int(kv_positions if kv_positions is not None else qp, T)
        ks = as_int(kv_segment_ids, T) if kv_segment_ids is not None else zeros_kv
    elif S == T:
        kp, ks = qp, qs
    else:  # causal by index over T != S rows, as K1-K3 take it
        kp, ks = as_int(torch.arange(T, device=device)[None], T), zeros_kv
    window = int(sliding_window) if sliding_window is not None else None
    qwin = qp - (window - 1) if window is not None else zeros_q
    has_seg = segment_ids is not None or kv_segment_ids is not None
    return (qp, qwin, qs, kp, ks), (causal_mode, window, asym, has_seg)


def mask_case(B, S, T, *, device, causal=True, segment_ids=None,
              sliding_window=None, ring=None):
    """`flash_attention`'s mask keywords for a batch of packed documents or
    for one step of ring (context-parallel) attention, and the (B, S, T)
    boolean mask they make. Positions restart at 0 with each document of
    the (B, S) int32 `segment_ids`. `ring = (q_offset, kv_offset,
    kv_other_rows)`: the q rows sit at positions q_offset.., the kv rows at
    kv_offset.. with their first kv_other_rows in a document of their own,
    and causal masking is by position (T may differ from S)."""
    i32 = dict(dtype=torch.int32, device=device)
    pos = torch.arange(S, **i32)[None].expand(B, S)
    kw = dict(causal=causal, segment_ids=segment_ids, sliding_window=sliding_window)
    if segment_ids is not None:
        new_doc = torch.ones((B, S), dtype=torch.bool, device=device)
        new_doc[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
        starts = torch.where(new_doc, torch.arange(S, **i32), 0).cummax(1).values
        pos = pos - starts
    if sliding_window is not None or segment_ids is not None:
        kw["positions"] = pos.contiguous()
    if ring is not None:
        if segment_ids is not None:
            raise ValueError("mask_case: a ring step takes no packed segments")
        q_off, kv_off, other = ring
        kv_rows = torch.arange(T, **i32)[None].expand(B, T)
        kw.update(positions=(pos + q_off).contiguous(),
                  kv_positions=(kv_rows + kv_off).contiguous(),
                  segment_ids=torch.zeros((B, S), **i32),
                  kv_segment_ids=(kv_rows < other).to(torch.int32).contiguous())
    aux, opts = _mask_inputs(B, S, T, device, **kw)
    return kw, _mask_of(B, S, T, aux, opts)


def _mask_of(B, S, T, aux, opts) -> torch.Tensor:
    qpos, qwin, qseg, kpos, kseg = aux
    return flash_mask(B, S, T, causal_mode=opts[0], qpos=qpos, qwin=qwin,
                      qseg=qseg, kpos=kpos, kseg=kseg, has_window=opts[1] is not None)


def kernels_forward(q, k, v, *, scale: float, soft_cap, masks):
    """K1 on q (B, S, Hq, D), k (B, T, Hkv, D), v (B, T, Hkv, Dv) at any
    head dims up to 256: zero-padded to `padded_head_dims`, the output
    sliced back to Dv. `scale` is the caller's, from the true D; `masks`
    is `mask_args`'s. Returns (out, raw lse)."""
    from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

    Dp, Dvp = fa_cuda.padded_head_dims(q.shape[-1], v.shape[-1])
    out, lse = fa_cuda.flash_fwd_cuda(
        fa_cuda.pad_head_dim(q, Dp), fa_cuda.pad_head_dim(k, Dp),
        fa_cuda.pad_head_dim(v, Dvp), scale=scale, soft_cap=soft_cap, masks=masks)
    return out[..., :v.shape[-1]].contiguous(), lse


def kernels_backward(q, k, v, do, lse, delta, *, scale: float, soft_cap, masks):
    """K2 and K3 at any head dims up to 256, padded as `kernels_forward`:
    (dq, dk, dv) sliced back to q's, k's and v's head dims."""
    from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

    D, Dv = q.shape[-1], v.shape[-1]
    Dp, Dvp = fa_cuda.padded_head_dims(D, Dv)
    qp, kp = fa_cuda.pad_head_dim(q, Dp), fa_cuda.pad_head_dim(k, Dp)
    vp, dop = fa_cuda.pad_head_dim(v, Dvp), fa_cuda.pad_head_dim(do, Dvp)
    kw = dict(scale=scale, soft_cap=soft_cap, masks=masks)
    dq = fa_cuda.flash_dq_cuda(qp, kp, vp, dop, lse, delta, **kw)
    dk, dv = fa_cuda.flash_dkv_cuda(qp, kp, vp, dop, lse, delta, **kw)
    return (dq[..., :D].contiguous(), dk[..., :D].contiguous(),
            dv[..., :Dv].contiguous())


class _Flash(torch.autograd.Function):
    """(q, k, v, sinks) -> (out, lse_pub), the JAX `_flash` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, sinks, aux, opts):
        soft_cap, scale = opts[4:]
        B, S, Hq, _ = q.shape
        T = k.shape[1]
        if q.is_cuda:
            from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            # the kernels' mask arguments (positions, their granule ranges),
            # made once for K1 here and K2, K3 in the backward
            ctx.cuda_masks = fa_cuda.mask_args(q, k, **_kernel_kwargs(aux, opts))
            out, lse_raw = kernels_forward(q, k, v, scale=scale, soft_cap=soft_cap,
                                           masks=ctx.cuda_masks)
            mask = None
        else:
            mask = _mask_of(B, S, T, aux, opts)
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
        ctx.save_for_backward(q, k, v, sinks, out, lse_pub, lse_res, mask)
        ctx.opts = opts
        return out, lse_pub

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, sinks, out, lse_pub, lse_res, mask = ctx.saved_tensors
        soft_cap, scale = ctx.opts[4:]
        Hq = q.shape[2]
        # delta = rowsum(dO * O) - dlse: the lse cotangent rides the same
        # p * (dp - delta) term (d lse / d s = p)
        dout32 = dout.float()
        delta = (dout32 * out.float()).sum(-1).transpose(1, 2)
        delta = (delta - dlse.float()).contiguous()
        do = dout32.to(q.dtype)
        if q.is_cuda:
            dq, dk, dv = kernels_backward(
                q, k, v, do.contiguous(), lse_res, delta, scale=scale,
                soft_cap=soft_cap, masks=ctx.cuda_masks)
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
    or Hq not a multiple of Hkv, and on CUDA tensors for head dims above
    256: nothing falls back to another implementation."""
    refuse_dtensor("flash_attention", q=q, k=k, v=v, sinks=sinks)
    B, S, Hq, Dq = q.shape
    _, T, Hkv, Dk = k.shape
    if Dq != Dk:
        raise NotImplementedError("flash_attention: q/k head_dim mismatch")
    if Hq % Hkv != 0:
        raise NotImplementedError("flash_attention: GQA needs Hq % Hkv == 0")
    scale = scale if scale is not None else float(Dq) ** -0.5
    aux, opts = _mask_inputs(
        B, S, T, q.device, causal=causal, segment_ids=segment_ids,
        positions=positions, kv_segment_ids=kv_segment_ids,
        kv_positions=kv_positions, sliding_window=sliding_window)
    out, lse = _Flash.apply(q, k, v, sinks, aux,
                            (*opts, logits_soft_cap, float(scale)))
    if return_lse:
        return out, lse
    return out
