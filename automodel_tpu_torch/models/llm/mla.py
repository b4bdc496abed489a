"""Multi-head Latent Attention (MLA), the DeepSeek V2/V3 attention (port of
`init_mla_layers` from `automodel_tpu/models/llm/mla.py`).

Queries and keys/values are projected through low-rank latents; RoPE
applies to a small per-head rope slice plus ONE shared key-rope head:

    q = W_uq · rmsnorm(W_dq · x)            (or a direct W_q when no q rank)
    [c_kv ; k_rope] = W_dkv · x             (kv_lora_rank + qk_rope_head_dim)
    [k_nope ; v] = W_ukv · rmsnorm(c_kv)

The serving engine runs MLA absorbed (`inference/generate.mla_absorbed_inputs`
over the latent pool). The training forward and the DSA lightning indexer
(`init_indexer`, the `mla_sparse_*` paths) are not ported.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.common.layers import init_fns


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
