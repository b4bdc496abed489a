"""MoE model-family adapters: HF config dict → MoETransformerConfig (port of
`deepseek_v3_moe_config` from `automodel_tpu/models/moe_lm/families.py`)."""

from __future__ import annotations

from typing import Any, Mapping

from automodel_tpu_torch.models.llm.families import _base_kwargs
from automodel_tpu_torch.models.moe_lm.decoder import MoETransformerConfig
from automodel_tpu_torch.moe.config import MoEConfig


def deepseek_v3_moe_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """DeepSeek-V3-style MoE body: sigmoid scores, group-limited routing,
    shared experts, aux-free gate-bias balancing, first-k-dense layers.
    Uses MLA attention when the HF config carries kv_lora_rank. Yarn rope
    (the V3 checkpoints' long-context scaling) folds its mscale² into the
    attention scale. Kimi-K2's config names the same architecture."""
    kw = _base_kwargs(hf)
    moe = MoEConfig(
        n_routed_experts=int(hf["n_routed_experts"]),
        n_shared_experts=int(hf.get("n_shared_experts", 0)),
        experts_per_token=int(hf["num_experts_per_tok"]),
        n_groups=int(hf.get("n_group", 1)),
        topk_groups=int(hf.get("topk_group", 1)),
        moe_intermediate_size=int(hf["moe_intermediate_size"]),
        score_func="sigmoid" if hf.get("scoring_func", "sigmoid") == "sigmoid" else "softmax",
        norm_topk_prob=bool(hf.get("norm_topk_prob", True)),
        route_scale=float(hf.get("routed_scaling_factor", 1.0)),
        aux_loss_coeff=float(hf.get("aux_loss_alpha", 0.0)),
        gate_bias_update_speed=float(hf.get("bias_update_speed", 0.001)),
    )
    first_k = int(hf.get("first_k_dense_replace", 0))
    if hf.get("num_nextn_predict_layers"):
        kw["mtp_num_layers"] = min(int(hf["num_nextn_predict_layers"]), 1)
    if hf.get("kv_lora_rank"):
        kw["attention_type"] = "mla"
        kw["mla_q_lora_rank"] = int(hf["q_lora_rank"]) if hf.get("q_lora_rank") else None
        kw["mla_kv_lora_rank"] = int(hf["kv_lora_rank"])
        kw["mla_qk_nope_head_dim"] = int(hf.get("qk_nope_head_dim", 128))
        kw["mla_qk_rope_head_dim"] = int(hf.get("qk_rope_head_dim", 64))
        kw["mla_v_head_dim"] = int(hf.get("v_head_dim", 128))
        kw["head_dim"] = None
        rs = kw["rope_scaling"]
        if rs.rope_type == "yarn":
            qk = kw["mla_qk_nope_head_dim"] + kw["mla_qk_rope_head_dim"]
            kw["attn_scale"] = qk ** -0.5 * rs.yarn_mscale() ** 2
    moe_overrides = overrides.pop("moe", None)
    kw.update(overrides)
    return MoETransformerConfig(moe=moe_overrides or moe, first_k_dense=first_k, **kw)
