"""Decoding helpers shared with the serving engine (port of `_dense_mlp`,
`_moe_mlp`, `_embed` and `mla_absorbed_inputs` from
`automodel_tpu/inference/generate.py`). The batch-synchronous `generate()`
is not ported yet."""

from __future__ import annotations

import dataclasses

import torch

from automodel_tpu_torch.models.llm.decoder import mlp_inner
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import apply_rope


def mla_absorbed_inputs(x, lp, cfg, positions, inv_freq):
    """Shared MLA absorbed-decode projections.

    Returns (q_abs, q_rope, c_kv, k_rope, w_uv): q_abs (B,S,n,r) is q_nope
    folded through the key half of the kv up-projection (scores are taken in
    latent space), c_kv (B,S,r) the rms-normed kv latent and k_rope (B,S,dr)
    the rotated shared key-rope head (the two cached quantities), and w_uv
    (r,n,dv) the value half the caller applies after the softmax."""
    B, Sq, _ = x.shape
    n = cfg.num_heads
    dn, dr, dv = cfg.mla_qk_nope_head_dim, cfg.mla_qk_rope_head_dim, cfg.mla_v_head_dim
    r = cfg.mla_kv_lora_rank
    if cfg.mla_q_lora_rank:
        q_lat = rms_norm(x @ lp["q_down_proj"]["kernel"], lp["q_norm"]["scale"],
                         cfg.rms_norm_eps)
        q = q_lat @ lp["q_up_proj"]["kernel"]
    else:
        q = x @ lp["q_proj"]["kernel"]
    q = q.reshape(B, Sq, n, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, inv_freq)
    if cfg.mla_qpe_scaling_beta is not None:
        sc = 1.0 + cfg.mla_qpe_scaling_beta * torch.log1p(
            torch.floor(positions.float() / cfg.mla_qpe_scaling_orig_max)
        )
        q_rope = q_rope * sc[:, :, None, None].to(q_rope.dtype)

    kv = x @ lp["kv_down_proj"]["kernel"]
    c_kv, k_rope = kv[..., :r], kv[..., r:]
    c_kv = rms_norm(c_kv, lp["kv_norm"]["scale"], cfg.rms_norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, inv_freq)[:, :, 0, :]
    W = lp["kv_up_proj"]["kernel"].reshape(r, n, dn + dv)
    w_uk, w_uv = W[..., :dn], W[..., dn:]
    q_abs = torch.einsum("bsnd,rnd->bsnr", q_nope, w_uk)
    return q_abs, q_rope, c_kv, k_rope, w_uv


def _dense_mlp(h, lp, cfg):
    x = rms_norm(h, lp["post_attn_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    mlp_out = mlp_inner(x, lp, cfg) @ lp["down_proj"]["kernel"]
    if cfg.use_post_norms:
        mlp_out = rms_norm(mlp_out, lp["post_mlp_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    return h + mlp_out


def _moe_mlp(h, lp, cfg):
    from automodel_tpu_torch.moe.layer import moe_forward

    # force dropless dispatch: the capacity dispatcher's bound depends on the
    # token population, so a capacity-trained config would drop differently
    # at decode time; dropless is exact for any population
    moe_cfg = dataclasses.replace(cfg.moe, dispatcher="dropless")
    x = rms_norm(h, lp["post_attn_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    moe_out, _aux, _stats = moe_forward(lp["moe"], moe_cfg, x)
    return h + moe_out


def _embed(params, cfg, ids):
    h = params["embed"]["embedding"][ids].to(cfg.dtype)
    if cfg.embed_scale != 1.0:
        h = h * cfg.embed_scale
    return h
