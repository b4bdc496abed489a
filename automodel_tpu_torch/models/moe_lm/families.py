"""MoE model-family adapters: HF config dict → MoETransformerConfig (port of
`automodel_tpu/models/moe_lm/families.py`: DeepSeek-V3 / Kimi-K2 /
GLM-4.7-Flash and Mistral-4 on MLA, the DSA families DeepSeek-V3.2/V4 and
GLM-5.x, and the GQA families Qwen3-MoE, Mixtral, gpt-oss, GLM-4.5,
ERNIE-4.5-MoE, MiniMax-M2, Hunyuan-MoE, Hy-MT2 and Ling 2.0 (BailingMoeV2),
field for field)."""

from __future__ import annotations

import dataclasses
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


def deepseek_v4_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """DeepseekV4ForCausalLM (and DeepSeek-V3.2): the V3 MoE + MLA body plus
    DSA, the lightning indexer's top-k sparse attention (index_topk /
    index_n_heads / index_head_dim are the HF config fields). The
    uncompressed indexer; indexer weights start fresh when a checkpoint has
    none."""
    dsa = {}
    if hf.get("index_topk"):
        dsa = dict(
            dsa_index_topk=int(hf["index_topk"]),
            dsa_index_n_heads=int(hf.get("index_n_heads", 4)),
            dsa_index_head_dim=int(hf.get("index_head_dim", 64)),
        )
    return deepseek_v3_moe_config(hf, **dsa, **overrides)


def glm_moe_dsa_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """GlmMoeDsaForCausalLM (GLM-5.x): the DeepSeek-style MLA + MoE body plus
    the GLM lightning indexer (queries from the q-lora residual, LayerNorm'd
    keys, rope-first slice) with IndexShare: "shared" layers of
    `indexer_types` reuse the previous full layer's top-k selection."""
    dsa = {}
    if hf.get("index_topk"):
        dsa = dict(
            dsa_index_topk=int(hf["index_topk"]),
            dsa_index_n_heads=int(hf.get("index_n_heads", 4)),
            dsa_index_head_dim=int(hf.get("index_head_dim", 64)),
            dsa_indexer_style="glm",
        )
        if hf.get("indexer_types"):
            dsa["dsa_indexer_types"] = tuple(hf["indexer_types"])
    return deepseek_v3_moe_config(hf, **dsa, **overrides)


def qwen3_moe_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """Qwen3MoeForCausalLM (reference: models/qwen3_moe, 838 LoC)."""
    kw = _base_kwargs(hf)
    kw["qk_norm"] = True
    moe = MoEConfig(
        n_routed_experts=int(hf["num_experts"]),
        experts_per_token=int(hf["num_experts_per_tok"]),
        moe_intermediate_size=int(hf["moe_intermediate_size"]),
        norm_topk_prob=bool(hf.get("norm_topk_prob", True)),
        score_func="softmax",
        aux_loss_coeff=float(hf.get("router_aux_loss_coef", 0.0)),
    )
    moe_overrides = overrides.pop("moe", None)
    kw.update(overrides)
    return MoETransformerConfig(moe=moe_overrides or moe, first_k_dense=0, **kw)


def mixtral_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """MixtralForCausalLM — softmax top-k with renormalization (equivalent to
    softmax over the selected logits)."""
    kw = _base_kwargs(hf)
    moe = MoEConfig(
        n_routed_experts=int(hf["num_local_experts"]),
        experts_per_token=int(hf["num_experts_per_tok"]),
        moe_intermediate_size=int(hf["intermediate_size"]),
        norm_topk_prob=True,
        score_func="softmax",
        aux_loss_coeff=float(hf.get("router_aux_loss_coef", 0.02)),
    )
    moe_overrides = overrides.pop("moe", None)
    kw.update(overrides)
    return MoETransformerConfig(moe=moe_overrides or moe, first_k_dense=0, **kw)


def bailing_moe_v2_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """BailingMoeV2ForCausalLM (Ling 2.0 mini/flash/1T; reference:
    models/ling_v2, 1007 LoC): GQA with per-head qk-norm and partial rotary,
    first-k-dense prefix, DeepSeek-style sigmoid grouped routing with the
    aux-free expert bias, one shared expert. Checkpoints store fused
    query_key_value / attention.dense / word_embeddings names — the
    adapter's "bailing" style."""
    if hf.get("use_qkv_bias"):
        raise NotImplementedError("bailing fused qkv bias")
    kw = _base_kwargs(hf)
    kw["qk_norm"] = bool(hf.get("use_qk_norm", True))
    kw["partial_rotary_factor"] = float(hf.get("partial_rotary_factor", 1.0))
    enable_bias = bool(hf.get("moe_router_enable_expert_bias", True))
    moe = MoEConfig(
        n_routed_experts=int(hf["num_experts"]),
        n_shared_experts=int(hf.get("num_shared_experts", 1)),
        experts_per_token=int(hf["num_experts_per_tok"]),
        n_groups=int(hf.get("n_group", 1)),
        topk_groups=int(hf.get("topk_group", 1)),
        moe_intermediate_size=int(hf["moe_intermediate_size"]),
        score_func=(
            "sigmoid" if hf.get("score_function", "sigmoid") == "sigmoid" else "softmax"
        ),
        norm_topk_prob=bool(hf.get("norm_topk_prob", True)),
        route_scale=float(hf.get("routed_scaling_factor", 1.0)),
        aux_loss_coeff=float(hf.get("router_aux_loss_coef", 0.0) or 0.0),
        gate_bias_update_speed=(
            float(hf.get("bias_update_speed", 0.001)) if enable_bias else 0.0
        ),
    )
    first_k = int(hf.get("first_k_dense_replace", 1))
    moe_overrides = overrides.pop("moe", None)
    kw.update(overrides)
    return MoETransformerConfig(moe=moe_overrides or moe, first_k_dense=first_k, **kw)


def glm4_moe_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """Glm4MoeForCausalLM (GLM-4.5/4.6; reference: models/glm4_moe, 658 LoC):
    DeepSeek-style sigmoid grouped router with e_score correction bias +
    shared experts + first-k-dense, on GQA attention with partial
    half-split rotary and optional qk-norm."""
    kw = _base_kwargs(hf)
    kw["attention_bias"] = bool(hf.get("attention_bias", False))
    kw["partial_rotary_factor"] = float(hf.get("partial_rotary_factor", 0.5))
    kw["qk_norm"] = bool(hf.get("use_qk_norm", False))
    moe = MoEConfig(
        n_routed_experts=int(hf["n_routed_experts"]),
        n_shared_experts=int(hf.get("n_shared_experts", 0)),
        experts_per_token=int(hf["num_experts_per_tok"]),
        n_groups=int(hf.get("n_group", 1)),
        topk_groups=int(hf.get("topk_group", 1)),
        moe_intermediate_size=int(hf["moe_intermediate_size"]),
        score_func="sigmoid",
        norm_topk_prob=bool(hf.get("norm_topk_prob", True)),
        route_scale=float(hf.get("routed_scaling_factor", 1.0)),
        aux_loss_coeff=float(hf.get("aux_loss_alpha", 0.0)),
        gate_bias_update_speed=float(hf.get("bias_update_speed", 0.001)),
    )
    first_k = int(hf.get("first_k_dense_replace", 0))
    moe_overrides = overrides.pop("moe", None)
    kw.update(overrides)
    return MoETransformerConfig(moe=moe_overrides or moe, first_k_dense=first_k, **kw)


def ernie4_5_moe_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """Ernie4_5_MoeForCausalLM (reference: models/ernie4_5, 897 LoC):
    softmax scoring with the aux-free `moe_statics` correction bias applied
    to the probabilities for SELECTION only, renormalized top-k weights,
    one fused shared-experts MLP, dense layers before
    `moe_layer_start_index`."""
    interval = int(hf.get("moe_layer_interval", 1))
    if interval != 1:
        raise NotImplementedError("ernie moe_layer_interval != 1")
    n_layers = int(hf["num_hidden_layers"])
    end = int(hf.get("moe_layer_end_index", n_layers - 1))
    if end not in (-1, n_layers - 1):
        raise NotImplementedError("ernie moe_layer_end_index < num_layers-1")
    kw = _base_kwargs(hf)
    kw["rope_interleaved"] = True  # glm-style interleaved rotary
    kw["attention_bias"] = bool(hf.get("use_bias", False))
    kw["tie_word_embeddings"] = bool(hf.get("tie_word_embeddings", True))
    n_shared = int(hf.get("moe_num_shared_experts", 0))
    moe = MoEConfig(
        n_routed_experts=int(hf["moe_num_experts"]),
        n_shared_experts=n_shared,
        experts_per_token=int(hf["moe_k"]),
        moe_intermediate_size=int(hf["moe_intermediate_size"]),
        shared_expert_intermediate_size=(
            int(hf["moe_intermediate_size"]) * n_shared if n_shared else None
        ),
        score_func="softmax",
        norm_topk_prob=True,
        aux_loss_coeff=float(hf.get("router_aux_loss_coef", 0.0)),
        gate_bias_update_speed=float(hf.get("bias_update_speed", 0.001)),
    )
    first_k = int(hf.get("moe_layer_start_index", 0))
    moe_overrides = overrides.pop("moe", None)
    kw.update(overrides)
    return MoETransformerConfig(moe=moe_overrides or moe, first_k_dense=first_k, **kw)


def minimax_m2_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """MiniMaxM2ForCausalLM (reference: models/minimax_m2, 748 LoC): GQA
    with RMSNorm over the FLATTENED q/k projections, partial rotary via
    `rotary_dim`, and a no-shared-experts MoE with a forced e-score
    correction bias (reference model.py:134 force_e_score_correction_bias)."""
    kw = _base_kwargs(hf)
    head_dim = kw["head_dim"] or kw["hidden_size"] // kw["num_heads"]
    if hf.get("rotary_dim"):
        kw["partial_rotary_factor"] = float(hf["rotary_dim"]) / head_dim
    kw["qk_norm_flat"] = bool(hf.get("use_qk_norm", True))
    score = str(hf.get("scoring_func", "sigmoid")).lower()
    moe = MoEConfig(
        n_routed_experts=int(hf["num_local_experts"]),
        experts_per_token=int(hf["num_experts_per_tok"]),
        moe_intermediate_size=int(hf["intermediate_size"]),
        score_func="softmax" if score == "softmax" else "sigmoid",
        norm_topk_prob=True,
        aux_loss_coeff=float(hf.get("router_aux_loss_coef", 0.0)),
        gate_bias_update_speed=float(hf.get("bias_update_speed", 0.001)),
    )
    moe_overrides = overrides.pop("moe", None)
    kw.update(overrides)
    return MoETransformerConfig(moe=moe_overrides or moe, first_k_dense=0, **kw)


def hunyuan_moe_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """HunYuanMoEV1ForCausalLM (reference: models/hy_v3, 838 LoC): softmax
    top-k renormalized router (no bias/groups), an always-on shared MLP at
    the dense intermediate size, post-rope qk-norm attention."""
    kw = _base_kwargs(hf)
    kw["attention_bias"] = bool(hf.get("attention_bias", False))
    kw["qk_norm"] = True
    kw["qk_norm_after_rope"] = True
    n_experts = hf["num_experts"]
    topk = hf.get("moe_topk", 1)
    if not isinstance(n_experts, int) or not isinstance(topk, int):
        raise NotImplementedError("hunyuan per-layer expert-count lists")
    # Released HunYuan-A13B checkpoints carry moe_intermediate_size /
    # num_shared_expert; fall back to the dense intermediate size (what the
    # installed transformers modeling always uses) only when absent.
    moe_inter = hf.get("moe_intermediate_size")
    if moe_inter is None:
        moe_inter = hf["intermediate_size"]
    n_shared = hf.get("num_shared_expert")
    if n_shared is None:
        n_shared = 1
    # released A13B checkpoints carry these as uniform per-layer lists
    if isinstance(moe_inter, (list, tuple)) and len(set(moe_inter)) == 1:
        moe_inter = moe_inter[0]
    if isinstance(n_shared, (list, tuple)) and len(set(n_shared)) == 1:
        n_shared = n_shared[0]
    if not isinstance(moe_inter, int) or not isinstance(n_shared, int):
        raise NotImplementedError("hunyuan per-layer moe size/shared lists")
    moe = MoEConfig(
        n_routed_experts=int(n_experts),
        n_shared_experts=int(n_shared),
        experts_per_token=int(topk),
        moe_intermediate_size=int(moe_inter),
        # shared width n_shared·moe_inter comes from shared_intermediate's default
        score_func="softmax",
        norm_topk_prob=True,
        aux_loss_coeff=float(hf.get("router_aux_loss_coef", 0.0)),
    )
    moe_overrides = overrides.pop("moe", None)
    kw.update(overrides)
    return MoETransformerConfig(moe=moe_overrides or moe, first_k_dense=0, **kw)


def gpt_oss_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """GptOssForCausalLM: alternating sliding/full attention with learnable
    sinks, biased router, fused-gate_up experts with biases and the clamped
    swiglu-oai activation (reference: models/gpt_oss, 1082 LoC).

    A yarn `rope_scaling` (the published checkpoints' factor 32) rescales
    the frequencies only: as in the JAX package, its attention factor is
    not folded into `attn_scale` (ROADMAP.md, recorded questions)."""
    kw = _base_kwargs(hf)
    kw["attention_bias"] = bool(hf.get("attention_bias", True))
    kw["o_proj_bias"] = bool(hf.get("attention_bias", True))
    kw["attention_sinks"] = True
    if hf.get("sliding_window"):
        kw["sliding_window"] = int(hf["sliding_window"])
        if hf.get("layer_types"):
            kw["layer_types"] = tuple(
                "sliding" if t == "sliding_attention" else "global"
                for t in hf["layer_types"]
            )
        else:
            kw["layer_types"] = tuple(
                "sliding" if i % 2 == 0 else "global" for i in range(kw["num_layers"])
            )
    moe = MoEConfig(
        n_routed_experts=int(hf["num_local_experts"]),
        experts_per_token=int(hf.get("num_experts_per_tok", 4)),
        moe_intermediate_size=int(hf["intermediate_size"]),
        norm_topk_prob=True,   # softmax-over-top-k == normalized softmax top-k
        score_func="softmax",
        router_bias=True,
        expert_bias=True,
        expert_activation="swigluoai",
        swiglu_limit=float(hf.get("swiglu_limit", 7.0)),
        aux_loss_coeff=float(hf.get("router_aux_loss_coef", 0.0)),
    )
    moe_overrides = overrides.pop("moe", None)
    kw.update(overrides)
    return MoETransformerConfig(moe=moe_overrides or moe, first_k_dense=0, **kw)


def hy_mt2_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """HyMT2ForCausalLM (Tencent Hy-MT2-30B-A3B, a translation MoE): GQA with
    per-head qk-norm before rope, a dense first layer (first_k_dense_replace)
    then MoE layers of routed experts of `expert_hidden_dim` and shared ones
    of `shared_expert_intermediate_size`, the router sigmoid by
    `moe_router_use_sigmoid` with `route_norm` and `router_scaling_factor`,
    and the aux-free expert bias (update speed 0.001) when
    `moe_router_enable_expert_bias`."""
    kw = _base_kwargs(hf)
    kw["qk_norm"] = bool(hf.get("qk_norm", True))
    kw["attention_bias"] = bool(hf.get("attention_bias", False))
    moe_inter = int(hf.get("expert_hidden_dim") or hf["moe_intermediate_size"])
    n_shared = int(hf.get("num_shared_experts", 0) or 0)
    moe = MoEConfig(
        n_routed_experts=int(hf["num_experts"]),
        n_shared_experts=n_shared,
        experts_per_token=int(hf["num_experts_per_tok"]),
        moe_intermediate_size=moe_inter,
        shared_expert_intermediate_size=(
            int(hf.get("shared_expert_intermediate_size") or moe_inter * n_shared)
            if n_shared else None
        ),
        score_func="sigmoid" if hf.get("moe_router_use_sigmoid", True) else "softmax",
        norm_topk_prob=bool(hf.get("route_norm", True)),
        route_scale=float(hf.get("router_scaling_factor", 1.0) or 1.0),
        gate_bias_update_speed=(
            0.001 if bool(hf.get("moe_router_enable_expert_bias", False)) else 0.0
        ),
    )
    first_k = int(hf.get("first_k_dense_replace", 1))
    moe_overrides = overrides.pop("moe", None)
    kw.update(overrides)
    return MoETransformerConfig(moe=moe_overrides or moe, first_k_dense=first_k, **kw)


def mistral4_config(hf: Mapping[str, Any], **overrides) -> MoETransformerConfig:
    """Mistral4ForCausalLM: the DeepSeek-V3 MLA + MoE body with Llama-4's
    position-dependent q-rope scaling, 1 + beta * log(1 + floor(pos /
    original_max_position_embeddings)) from `rope_parameters`
    (`llama_4_scaling_beta`), which the MLA forward and the absorbed decode
    (`inference/generate.mla_absorbed_inputs`, the engine's too) apply."""
    cfg = deepseek_v3_moe_config(hf, **overrides)
    rp = hf.get("rope_parameters") or hf.get("rope_scaling") or {}
    beta = rp.get("llama_4_scaling_beta")
    if beta:
        cfg = dataclasses.replace(
            cfg,
            mla_qpe_scaling_beta=float(beta),
            mla_qpe_scaling_orig_max=int(rp.get("original_max_position_embeddings", 8192)),
        )
    return cfg
