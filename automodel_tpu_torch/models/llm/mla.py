"""Multi-head Latent Attention (MLA), the DeepSeek V2/V3 attention, and DSA,
its lightning-indexer top-k sparse form of DeepSeek-V3.2/V4 and GLM-5 (port
of `automodel_tpu/models/llm/mla.py`).

Queries and keys/values are projected through low-rank latents; RoPE
applies to a small per-head rope slice plus ONE shared key-rope head:

    q = W_uq · rmsnorm(W_dq · x)            (or a direct W_q when no q rank)
    [c_kv ; k_rope] = W_dkv · x             (kv_lora_rank + qk_rope_head_dim)
    [k_nope ; v] = W_ukv · rmsnorm(c_kv)
    per head:  q = [q_nope ; rope(q_rope)],  k = [k_nope ; rope(k_rope)]

The training block attends with q/k of qk_nope + qk_rope (192 for
DeepSeek-V3 and Moonlight) and v of v_head_dim (128): on the card the flash
kernels K1-K3 take that pair as it is. The serving engine runs MLA absorbed
(`inference/generate.mla_absorbed_inputs` over the latent pool), DSA models
too (dense over the pool, as the JAX engine decodes them).

DSA (`dsa_index_topk` set; the MoE decoder dispatches it) has two paths,
selected by `resolve_dsa_impl`:

- the oracle `mla_sparse_attention_block`: indexer scores over (S, S), the
  top-k selection as a dense mask on the plain attention;
- the chunked `mla_sparse_attention_block_chunked`: per query block, the
  indexer scores against every key, the top-k indices, then absorbed
  attention over the gathered kv latents. Each block runs under
  `torch.utils.checkpoint` when autograd records, so neither pass keeps
  more than one block's (block, S) scores or (block, K, r) latents: memory
  O(S·block), where a Python loop under autograd would keep every block's
  until the backward (the JAX `lax.map` program's promise).

Both return (h, the indexer-KL aux, the selection) and select the same keys
(ties to the lowest index, `ops/dsa.stable_topk`); the aux is the indexer's
only gradient. Context parallelism is not ported.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from automodel_tpu_torch.models.common.layers import init_fns
from automodel_tpu_torch.ops.attention import dot_product_attention, make_attention_mask
from automodel_tpu_torch.ops.dsa import (
    indexer_kl_loss,
    indexer_scores,
    indexer_scores_glm,
    layer_norm_keys,
    pair_dots,
    stable_topk,
    topk_select_mask,
)
from automodel_tpu_torch.ops.flash_attention import NEG_INF
from automodel_tpu_torch.ops.matmul import bmm_fp32
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.quant import matmul as _mm
from automodel_tpu_torch.ops.rope import apply_rope, rope_frequencies
from automodel_tpu_torch.parallel.collectives import copy_to, reduce_from


def init_mla_layers(cfg, gen: torch.Generator, L: int,
                    dtype: torch.dtype = torch.float32) -> dict:
    """MLA attention params for an L-layer stack (cfg: TransformerConfig
    with the mla_* fields set), on the generator's device; DSA configs add
    the `indexer` subtree, drawn last."""
    ones, _, dense = init_fns(gen, dtype)
    H, n = cfg.hidden_size, cfg.num_heads
    r, dr = cfg.mla_kv_lora_rank, cfg.mla_qk_rope_head_dim
    qk = cfg.mla_qk_nope_head_dim + dr
    layers: dict = {
        "input_norm": {"scale": ones(L, H)},
        "post_attn_norm": {"scale": ones(L, H)},
        "kv_down_proj": {"kernel": dense(L, H, r + dr)},
        "kv_norm": {"scale": ones(L, r)},
        "kv_up_proj": {
            "kernel": dense(L, r, n * (cfg.mla_qk_nope_head_dim + cfg.mla_v_head_dim))
        },
        "o_proj": {"kernel": dense(L, n * cfg.mla_v_head_dim, H)},
    }
    if cfg.mla_q_lora_rank:
        layers["q_down_proj"] = {"kernel": dense(L, H, cfg.mla_q_lora_rank)}
        layers["q_norm"] = {"scale": ones(L, cfg.mla_q_lora_rank)}
        layers["q_up_proj"] = {"kernel": dense(L, cfg.mla_q_lora_rank, n * qk)}
    else:
        layers["q_proj"] = {"kernel": dense(L, H, n * qk)}
    if cfg.dsa_index_topk is not None:
        layers["indexer"] = init_indexer(cfg, gen, L, dtype)
    return layers


def mla_layer_specs(cfg) -> dict:
    """Logical axes of an MLA stack's leaves (JAX `mla_layer_specs`): the
    latent projections replicate on `tp`, the per-head ones split there."""
    layers = {
        "input_norm": {"scale": ("layers", "norm")},
        "post_attn_norm": {"scale": ("layers", "norm")},
        "kv_down_proj": {"kernel": ("layers", "embed", None)},
        "kv_norm": {"scale": ("layers", "norm")},
        "kv_up_proj": {"kernel": ("layers", None, "heads")},
        "o_proj": {"kernel": ("layers", "heads", "embed")},
    }
    if cfg.mla_q_lora_rank:
        layers["q_down_proj"] = {"kernel": ("layers", "embed", None)}
        layers["q_norm"] = {"scale": ("layers", "norm")}
        layers["q_up_proj"] = {"kernel": ("layers", None, "heads")}
    else:
        layers["q_proj"] = {"kernel": ("layers", "embed", "heads")}
    if cfg.dsa_index_topk is not None:
        layers["indexer"] = {
            "wq": {"kernel": ("layers", "embed", "heads")},
            "wk": {"kernel": ("layers", "embed", None)},
            "wgate": {"kernel": ("layers", "embed", None)},
        }
        if getattr(cfg, "dsa_indexer_style", "deepseek") == "glm":
            layers["indexer"]["wq"] = {"kernel": ("layers", None, "heads")}
            layers["indexer"]["k_norm"] = {"scale": ("layers", "norm"),
                                           "bias": ("layers", "norm")}
    return layers


def init_indexer(cfg, gen: torch.Generator, L: int,
                 dtype: torch.dtype = torch.float32) -> dict:
    """A fresh lightning-indexer stack (also the backfill of checkpoints that
    predate DSA). The GLM style projects queries from the q-lora residual
    and LayerNorms the keys."""
    ones, zeros, dense = init_fns(gen, dtype)
    H, Hi, Di = cfg.hidden_size, cfg.dsa_index_n_heads, cfg.dsa_index_head_dim
    if cfg.dsa_indexer_style == "glm":
        rq = cfg.mla_q_lora_rank or H
        return {
            "wq": {"kernel": dense(L, rq, Hi * Di)},
            "wk": {"kernel": dense(L, H, Di)},
            "k_norm": {"scale": ones(L, Di), "bias": zeros(L, Di)},
            "wgate": {"kernel": dense(L, H, Hi)},
        }
    return {
        "wq": {"kernel": dense(L, H, Hi * Di)},
        "wk": {"kernel": dense(L, H, Di)},
        "wgate": {"kernel": dense(L, H, Hi)},
    }


def _mla_qkv(x, lp, cfg, positions, inv_freq, tp=None):
    """Project the normed input to MLA q/k/v (B,S,n,·), the logit scale and
    the q-lora residual (after q_norm; None without a q rank), which the
    GLM indexer reads. With a `tp` group, lp holds this rank's heads (cfg
    their count): the latents, whole on every rank, enter the per-head
    projections through `copy_to`, and so does the shared rope key."""
    B, S, _ = x.shape
    n = cfg.num_heads
    dn, dr, dv = cfg.mla_qk_nope_head_dim, cfg.mla_qk_rope_head_dim, cfg.mla_v_head_dim
    prec = cfg.linear_precision

    q_lat = None
    if cfg.mla_q_lora_rank:
        q_lat = rms_norm(_mm(x, lp["q_down_proj"]["kernel"], prec), lp["q_norm"]["scale"],
                         cfg.rms_norm_eps)
        q = _mm(copy_to(q_lat, tp), lp["q_up_proj"]["kernel"], prec)
    else:
        q = _mm(copy_to(x, tp), lp["q_proj"]["kernel"], prec)
    q = q.reshape(B, S, n, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, inv_freq)
    if cfg.mla_qpe_scaling_beta is not None:
        # mistral4 llama4-style scaling of the rope slice
        sc = 1.0 + cfg.mla_qpe_scaling_beta * torch.log1p(
            torch.floor(positions.float() / cfg.mla_qpe_scaling_orig_max))
        q_rope = q_rope * sc[:, :, None, None].to(q_rope.dtype)
    q = torch.cat([q_nope, q_rope], dim=-1)

    kv = _mm(x, lp["kv_down_proj"]["kernel"], prec)  # (B, S, kv_rank + dr)
    r = cfg.mla_kv_lora_rank
    c_kv, k_rope = kv[..., :r], kv[..., r:]
    # one shared key-rope head, broadcast across heads after rotation
    k_rope = copy_to(apply_rope(k_rope[:, :, None, :], positions, inv_freq), tp)
    c_kv = rms_norm(c_kv, lp["kv_norm"]["scale"], cfg.rms_norm_eps)
    kv_up = _mm(copy_to(c_kv, tp), lp["kv_up_proj"]["kernel"], prec).reshape(
        B, S, n, dn + dv)
    k_nope, v = kv_up[..., :dn], kv_up[..., dn:]
    k = torch.cat([k_nope, k_rope.expand(B, S, n, dr)], dim=-1)
    scale = cfg.attn_scale if cfg.attn_scale is not None else (dn + dr) ** -0.5
    return q, k, v, scale, q_lat


def mla_attention_block(h, lp, cfg, positions, segment_ids, inv_freq,
                        sliding_window, tp=None):
    """Pre-norm MLA attention with residual (lp in the compute dtype); the
    counterpart of the dense `attention_block`. A DSA config's indexer is
    not read here (the MoE decoder sends DSA layers to the sparse blocks).
    With a `tp` group each rank runs its heads and the `o_proj` partial
    sums are all-reduced."""
    B, S, _ = h.shape
    x = rms_norm(h, lp["input_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    q, k, v, scale, _ = _mla_qkv(x, lp, cfg, positions, inv_freq, tp)
    attn = dot_product_attention(
        q, k, v,
        causal=cfg.causal,
        segment_ids=segment_ids,
        positions=positions,
        sliding_window=sliding_window,
        logits_soft_cap=cfg.attn_soft_cap,
        scale=scale,
        impl=cfg.attn_impl,
    )
    attn = attn.reshape(B, S, cfg.num_heads * cfg.mla_v_head_dim)
    return h + reduce_from(_mm(attn, lp["o_proj"]["kernel"], cfg.linear_precision), tp)


# ---------------------------------------------------------------------------
# DSA
# ---------------------------------------------------------------------------
def resolve_dsa_impl(cfg, seq_len: int) -> str:
    impl = cfg.dsa_impl
    if impl == "auto":
        return "chunked" if seq_len > 4 * cfg.dsa_query_block else "oracle"
    if impl not in ("oracle", "chunked"):
        raise ValueError(f"Unknown dsa_impl '{impl}'")
    return impl


def dsa_sel_init(cfg, B: int, S: int, device=None):
    """The zero IndexShare carry of the configured path: a dense (B, S, S)
    bool selection for the oracle, (B, S, K) top-k indices for the chunked
    path."""
    if resolve_dsa_impl(cfg, S) == "chunked":
        return torch.zeros((B, S, min(cfg.dsa_index_topk, S)), dtype=torch.int64,
                           device=device)
    return torch.zeros((B, S, S), dtype=torch.bool, device=device)


def _indexer_qkw(x, q_lat, lp, cfg, positions):
    """Roped indexer queries (B,S,Hi,Di), keys (B,S,Di) and fp32 gate
    weights (B,S,Hi), so that for both styles
    score[t,s] = Σ_h w[t,h] · relu(q[t,h]·k[s]) · Di**-0.5."""
    B, S, _ = x.shape
    Hi, Di = cfg.dsa_index_n_heads, cfg.dsa_index_head_dim
    ip = lp["indexer"]
    if cfg.dsa_indexer_style == "glm":
        inv_freq = rope_frequencies(cfg.mla_qk_rope_head_dim, cfg.rope_theta,
                                    cfg.rope_scaling)
        qsrc = q_lat if q_lat is not None else x
        q = (qsrc @ ip["wq"]["kernel"].to(x.dtype)).reshape(B, S, Hi, Di)
        k = layer_norm_keys(x @ ip["wk"]["kernel"].to(x.dtype), ip["k_norm"])
        w = (x @ ip["wgate"]["kernel"].to(x.dtype)).float() * (Hi ** -0.5)
    else:
        inv_freq = rope_frequencies(Di, cfg.rope_theta, cfg.rope_scaling)
        q = (x @ ip["wq"]["kernel"].to(x.dtype)).reshape(B, S, Hi, Di)
        k = x @ ip["wk"]["kernel"].to(x.dtype)
        w = (x @ ip["wgate"]["kernel"].to(x.dtype)).float()
    inv_freq = inv_freq.to(x.device)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k[:, :, None, :], positions, inv_freq)[:, :, 0, :]
    return q, k, w


def _sparse_block(qa_b, qr_b, qi_b, wi_b, qpos_b, qseg_b, tm_b, pidx_b,
                  ki, c_kv, k_rope, positions, seg, w_uv, *, run: bool,
                  K: int, scale: float, Di: int, causal: bool):
    """One query block of the chunked path: indexer scores against every
    key and the masked top-k (or the running selection `pidx_b` when `run`
    is False: an IndexShare "shared" layer), then absorbed attention over
    the gathered latents and the block's indexer KL. Returns (out
    (B, bq, n, dv), idx (B, bq, K), KL sum, real-query count)."""
    B, bq = qa_b.shape[:2]
    n, r = qa_b.shape[2], c_kv.shape[-1]
    dr = k_rope.shape[-1]
    adm = qseg_b[:, :, None] == seg[:, None, :]
    if causal:
        adm = adm & (qpos_b[:, :, None] >= positions[:, None, :])
    if run:
        # phase 1: indexer scores vs all keys, masked top-k
        d = torch.relu(pair_dots(qi_b, ki))  # (B, Hi, bq, S)
        scores = (d * wi_b.permute(0, 2, 1)[..., None]).sum(1) * (Di ** -0.5)
        masked = torch.where(adm, scores, -torch.inf)
        _, idx = stable_topk(masked, K)
        top_vals = torch.gather(masked, -1, idx)
        valid = torch.isfinite(top_vals)
    else:
        idx = pidx_b
        valid = torch.gather(adm, -1, idx)

    # phase 2: gather the latents, absorbed attention over K
    flat = idx.reshape(B, bq * K, 1)
    c_sel = torch.gather(c_kv, 1, flat.expand(-1, -1, r)).reshape(B * bq, K, r)
    kr_sel = torch.gather(k_rope, 1, flat.expand(-1, -1, dr)).reshape(B * bq, K, dr)
    s = bmm_fp32(qa_b.reshape(B * bq, n, r), c_sel.transpose(1, 2))
    s = s + bmm_fp32(qr_b.reshape(B * bq, n, dr), kr_sel.transpose(1, 2))
    s = torch.where(valid.reshape(B * bq, 1, K), s * scale, NEG_INF)
    p = torch.softmax(s, dim=-1)  # (B*bq, n, K)
    out_lat = torch.bmm(p.to(c_sel.dtype), c_sel).reshape(B, bq, n, r)
    out = torch.einsum("bqnr,rnd->bqnd", out_lat, w_uv)
    if not run:
        zero = torch.zeros((), dtype=torch.float32, device=out.device)
        return out, idx, zero, zero

    # the indexer KL over the selected set; the head-averaged main
    # distribution is the detached target
    logq = torch.log_softmax(torch.where(valid, top_vals, NEG_INF), dim=-1)
    pm = p.detach().reshape(B, bq, n, K).mean(2)
    pm = torch.where(valid, pm, 0.0)
    pm = pm / torch.clamp(pm.sum(-1, keepdim=True), min=1e-9)
    kl = torch.sum(pm * (torch.log(torch.clamp(pm, min=1e-9)) - logq), dim=-1)
    m = tm_b.float()
    return out, idx, torch.sum(kl * m), torch.sum(m)


def mla_sparse_attention_block_chunked(h, lp, cfg, positions, segment_ids, inv_freq,
                                       token_mask=None, prev_idx=None,
                                       indexer_flag=None):
    """Two-phase sparse MLA without (S, S) tensors: per query block the
    indexer scores against every key, the masked top-k indices, the kv
    LATENTS gathered at them (c_kv (K, r) and the shared rope key (K, dr)),
    and attention in latent space (the kv up-projection's halves folded
    into the query and the output, as the decode cache does). Returns
    (h_out, aux, idx) with idx (B, S, K), the IndexShare carry.

    `indexer_flag` is None (plain DSA) or this layer's IndexShare flag: True
    runs its indexer, False reuses `prev_idx` and adds no KL."""
    B, S, _ = h.shape
    n = cfg.num_heads
    dn, dr, dv = cfg.mla_qk_nope_head_dim, cfg.mla_qk_rope_head_dim, cfg.mla_v_head_dim
    r = cfg.mla_kv_lora_rank
    prec = cfg.linear_precision
    K = min(cfg.dsa_index_topk, S)
    bq = cfg.dsa_query_block
    while S % bq != 0:
        bq //= 2

    x = rms_norm(h, lp["input_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    # full-sequence latents: O(S·(r + dr))
    q_lat = None
    if cfg.mla_q_lora_rank:
        q_lat = rms_norm(_mm(x, lp["q_down_proj"]["kernel"], prec), lp["q_norm"]["scale"],
                         cfg.rms_norm_eps)
        q = _mm(q_lat, lp["q_up_proj"]["kernel"], prec)
    else:
        q = _mm(x, lp["q_proj"]["kernel"], prec)
    q = q.reshape(B, S, n, dn + dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], positions, inv_freq)
    kv = _mm(x, lp["kv_down_proj"]["kernel"], prec)
    c_kv = rms_norm(kv[..., :r], lp["kv_norm"]["scale"], cfg.rms_norm_eps)
    k_rope = apply_rope(kv[..., r:][:, :, None, :], positions, inv_freq)[:, :, 0, :]

    run = indexer_flag is None or bool(indexer_flag)
    if run:
        qi, ki, wi = _indexer_qkw(x, q_lat, lp, cfg, positions)
    W = lp["kv_up_proj"]["kernel"].to(x.dtype).reshape(r, n, dn + dv)
    w_uk, w_uv = W[..., :dn], W[..., dn:]
    q_abs = torch.einsum("bsnd,rnd->bsnr", q_nope, w_uk)
    scale = cfg.attn_scale if cfg.attn_scale is not None else (dn + dr) ** -0.5

    seg = segment_ids if segment_ids is not None else torch.zeros_like(positions)
    tmask = (token_mask if token_mask is not None
             else torch.ones((B, S), dtype=torch.bool, device=h.device))
    if not run and prev_idx is None:
        raise ValueError("an IndexShare shared layer needs the running selection")

    def split(a):
        return a.split(bq, dim=1) if a is not None else (None,) * (S // bq)

    blocks = zip(split(q_abs), split(q_rope), split(qi if run else None),
                 split(wi if run else None), split(positions), split(seg),
                 split(tmask), split(prev_idx if not run else None))
    shared = (ki if run else None, c_kv, k_rope, positions, seg, w_uv)
    kw = dict(run=run, K=K, scale=scale, Di=cfg.dsa_index_head_dim, causal=cfg.causal)

    def blk(*args):
        return _sparse_block(*args, **kw)

    outs, idxs, kl_sum, cnt = [], [], 0.0, 0.0
    for xs in blocks:
        if torch.is_grad_enabled():
            o, i, k_, c_ = torch.utils.checkpoint.checkpoint(
                blk, *xs, *shared, use_reentrant=False)
        else:
            o, i, k_, c_ = blk(*xs, *shared)
        outs.append(o)
        idxs.append(i)
        kl_sum, cnt = kl_sum + k_, cnt + c_
    attn = torch.cat(outs, dim=1).reshape(B, S, n * dv)
    idx = torch.cat(idxs, dim=1)
    if run:
        aux = cfg.dsa_indexer_loss_coeff * kl_sum / torch.clamp(cnt, min=1.0)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + _mm(attn, lp["o_proj"]["kernel"], prec), aux, idx


def mla_sparse_attention_block(h, lp, cfg, positions, segment_ids, inv_freq,
                               token_mask=None, prev_sel=None, indexer_flag=None):
    """DSA: lightning-indexer top-k sparse MLA, the dense-mask oracle (or the
    chunked path, by `resolve_dsa_impl`; `prev_sel` is then (B, S, K)
    indices). Returns (h_out, indexer-KL aux, sel): the aux rides the MoE
    decoder's loss carry and is the indexer's ONLY gradient (hard top-k);
    `token_mask` (B, S) keeps pad queries out of the KL.

    IndexShare (GLM-5.x): `indexer_flag` True runs this layer's indexer,
    False reuses `prev_sel` (the last full layer's selection) and adds no
    KL; the returned `sel` is the running selection."""
    if resolve_dsa_impl(cfg, h.shape[1]) == "chunked":
        return mla_sparse_attention_block_chunked(
            h, lp, cfg, positions, segment_ids, inv_freq, token_mask=token_mask,
            prev_idx=prev_sel, indexer_flag=indexer_flag)
    B, S, _ = h.shape
    x = rms_norm(h, lp["input_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    q, k, v, scale, q_lat = _mla_qkv(x, lp, cfg, positions, inv_freq)

    base_mask = make_attention_mask(
        S, S, causal=cfg.causal, q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
        q_positions=positions, kv_positions=positions, device=h.device)
    if base_mask is None:
        base_mask = torch.ones((1, S, S), dtype=torch.bool, device=h.device)

    # a shared IndexShare layer reuses the running selection and adds no KL
    run = indexer_flag is None or prev_sel is None or bool(indexer_flag)
    if run and cfg.dsa_indexer_style == "glm":
        # rope on the FIRST qk_rope_head_dim channels only
        inv_freq_idx = rope_frequencies(cfg.mla_qk_rope_head_dim, cfg.rope_theta,
                                        cfg.rope_scaling).to(h.device, non_blocking=True)
        scores = indexer_scores_glm(
            x, q_lat if q_lat is not None else x, lp["indexer"],
            cfg.dsa_index_n_heads, cfg.dsa_index_head_dim, positions, inv_freq_idx)
    elif run:
        # the main path's rope scaling: a yarn model's indexer agrees with its
        # attention about long-context positions
        inv_freq_idx = rope_frequencies(cfg.dsa_index_head_dim, cfg.rope_theta,
                                        cfg.rope_scaling).to(h.device, non_blocking=True)
        scores = indexer_scores(x, lp["indexer"], cfg.dsa_index_n_heads,
                                cfg.dsa_index_head_dim, positions, inv_freq_idx)
    sel = topk_select_mask(scores, base_mask, cfg.dsa_index_topk) if run else prev_sel

    qh, kh = q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3)  # (B, n, S, ·)
    logits = bmm_fp32(qh.reshape(-1, S, qh.shape[-1]),
                      kh.reshape(-1, S, kh.shape[-1]).transpose(1, 2))
    logits = logits.reshape(B, -1, S, S) * scale
    logits = torch.where(sel[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnst,btnv->bsnv", probs.to(v.dtype), v)

    if indexer_flag is None or bool(indexer_flag):
        aux = cfg.dsa_indexer_loss_coeff * indexer_kl_loss(
            scores, probs.mean(1), sel, token_mask=token_mask)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)

    attn = out.reshape(B, S, cfg.num_heads * cfg.mla_v_head_dim)
    return h + _mm(attn, lp["o_proj"]["kernel"], cfg.linear_precision), aux, sel
