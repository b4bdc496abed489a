"""Multi-head Latent Attention (MLA), the DeepSeek V2/V3 attention (port of
`init_mla_layers`, `_mla_qkv` and `mla_attention_block` from
`automodel_tpu/models/llm/mla.py`).

Queries and keys/values are projected through low-rank latents; RoPE
applies to a small per-head rope slice plus ONE shared key-rope head:

    q = W_uq · rmsnorm(W_dq · x)            (or a direct W_q when no q rank)
    [c_kv ; k_rope] = W_dkv · x             (kv_lora_rank + qk_rope_head_dim)
    [k_nope ; v] = W_ukv · rmsnorm(c_kv)
    per head:  q = [q_nope ; rope(q_rope)],  k = [k_nope ; rope(k_rope)]

The training block attends with q/k of qk_nope + qk_rope (192 for
DeepSeek-V3 and Moonlight) and v of v_head_dim (128): on the card the flash
kernels K1-K3 take that pair as it is. The serving engine runs MLA absorbed
(`inference/generate.mla_absorbed_inputs` over the latent pool). The DSA
lightning indexer (`init_indexer`, the `mla_sparse_*` paths) and context
parallelism are not ported.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.common.layers import init_fns
from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import apply_rope


def init_mla_layers(cfg, gen: torch.Generator, L: int,
                    dtype: torch.dtype = torch.float32) -> dict:
    """MLA attention params for an L-layer stack (cfg: TransformerConfig
    with the mla_* fields set), on the generator's device."""
    if cfg.dsa_index_topk is not None:
        raise NotImplementedError(
            "DSA (dsa_index_topk, the lightning indexer) is not ported")
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
    return layers


def _mla_qkv(x, lp, cfg, positions, inv_freq):
    """Project the normed input to MLA q/k/v (B,S,n,·) and the logit scale
    (the JAX function also returns the q-lora residual, which only the
    unported DSA indexer reads)."""
    B, S, _ = x.shape
    n = cfg.num_heads
    dn, dr, dv = cfg.mla_qk_nope_head_dim, cfg.mla_qk_rope_head_dim, cfg.mla_v_head_dim

    if cfg.mla_q_lora_rank:
        q_lat = rms_norm(x @ lp["q_down_proj"]["kernel"], lp["q_norm"]["scale"],
                         cfg.rms_norm_eps)
        q = q_lat @ lp["q_up_proj"]["kernel"]
    else:
        q = x @ lp["q_proj"]["kernel"]
    q = q.reshape(B, S, n, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, inv_freq)
    if cfg.mla_qpe_scaling_beta is not None:
        # mistral4 llama4-style scaling of the rope slice
        sc = 1.0 + cfg.mla_qpe_scaling_beta * torch.log1p(
            torch.floor(positions.float() / cfg.mla_qpe_scaling_orig_max))
        q_rope = q_rope * sc[:, :, None, None].to(q_rope.dtype)
    q = torch.cat([q_nope, q_rope], dim=-1)

    kv = x @ lp["kv_down_proj"]["kernel"]  # (B, S, kv_rank + dr)
    r = cfg.mla_kv_lora_rank
    c_kv, k_rope = kv[..., :r], kv[..., r:]
    # one shared key-rope head, broadcast across heads after rotation
    k_rope = apply_rope(k_rope[:, :, None, :], positions, inv_freq)
    c_kv = rms_norm(c_kv, lp["kv_norm"]["scale"], cfg.rms_norm_eps)
    kv_up = (c_kv @ lp["kv_up_proj"]["kernel"]).reshape(B, S, n, dn + dv)
    k_nope, v = kv_up[..., :dn], kv_up[..., dn:]
    k = torch.cat([k_nope, k_rope.expand(B, S, n, dr)], dim=-1)
    scale = cfg.attn_scale if cfg.attn_scale is not None else (dn + dr) ** -0.5
    return q, k, v, scale


def mla_attention_block(h, lp, cfg, positions, segment_ids, inv_freq,
                        sliding_window):
    """Pre-norm MLA attention with residual (lp in the compute dtype); the
    counterpart of the dense `attention_block`. The DSA indexer raises
    NotImplementedError."""
    if cfg.dsa_index_topk is not None:
        raise NotImplementedError(
            "DSA (dsa_index_topk, the lightning indexer) is not ported")
    B, S, _ = h.shape
    x = rms_norm(h, lp["input_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    q, k, v, scale = _mla_qkv(x, lp, cfg, positions, inv_freq)
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
    return h + attn @ lp["o_proj"]["kernel"]
