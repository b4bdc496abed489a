"""Step-3.5, MiMo-V2-Flash and MiniMax-M3 on the heterogeneous MoE decoder
(port of `automodel_tpu/models/moe_lm/het_families.py`): the three HF
config functions, field for field, and `HetMoEAdapter`, the HF checkpoint
names of each family, registered as the "het_moe" adapter.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from automodel_tpu_torch.checkpoint.hf_adapter import (
    ADAPTERS,
    Reader,
    _get,
    _set,
    _stack,
    _t,
)
from automodel_tpu_torch.models.moe_lm.het_moe import (
    AttnGeom,
    HetMoEConfig,
    _init_attn_group,
    layer_rows,
)
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def _finish(kw: dict, overrides: dict) -> HetMoEConfig:
    moe_overrides = overrides.pop("moe", None)
    kw.update(overrides)  # unknown keys raise in HetMoEConfig
    if moe_overrides is not None:
        kw["moe"] = moe_overrides
    return HetMoEConfig(**kw)


def step3p5_config(hf: Mapping[str, Any], **overrides) -> HetMoEConfig:
    """Step3p5ForCausalLM: sliding layers re-headed by
    `attention_other_setting`, per-layer rope theta / partial rotary / NoPE,
    the head-wise sigmoid gate, `moe_layers_enum` MoE placement with a
    separate shared expert."""
    L = int(hf["num_hidden_layers"])
    heads = int(hf["num_attention_heads"])
    kv = int(hf.get("num_attention_groups", heads))
    other = dict(hf.get("attention_other_setting") or {})
    head_dim = int(hf.get("head_dim", hf["hidden_size"] // heads))
    lt_raw = list(hf.get("layer_types") or ["full_attention"] * L)
    layer_types = tuple("sliding" if t == "sliding_attention" else "global" for t in lt_raw)
    enum = hf.get("moe_layers_enum")
    if enum is None:
        moe_set = set(range(1, L))
    elif isinstance(enum, str):
        moe_set = {int(i) for i in enum.strip().split(",")}
    elif isinstance(enum, int):
        moe_set = {enum}
    else:
        moe_set = {int(i) for i in enum}
    thetas = hf.get("rope_theta", 10000.0)
    thetas = tuple(thetas) if isinstance(thetas, (list, tuple)) else (float(thetas),) * L
    prf = hf.get("partial_rotary_factors")
    prf = tuple(prf) if prf else (1.0,) * L
    use_rope = hf.get("use_rope_layers")
    use_rope = tuple(bool(b) for b in use_rope) if use_rope else (True,) * L
    use_bias = bool(hf.get("use_moe_router_bias", False))
    act = str(hf.get("moe_router_activation", "softmax"))
    share_dim = hf.get("share_expert_dims") or hf.get("share_expert_dim") or 0
    if isinstance(share_dim, (list, tuple)):
        if len(set(share_dim)) != 1:
            raise NotImplementedError("step3p5 per-layer share_expert_dims")
        share_dim = share_dim[0]
    limits = hf.get("swiglu_limits_shared") or hf.get("swiglu_limits")
    limit = None
    if limits:
        nz = {float(x) for x in limits if x}
        if len(nz) > 1:
            raise NotImplementedError("step3p5 per-layer swiglu limits")
        limit = nz.pop() if nz else None
    moe = MoEConfig(
        n_routed_experts=int(hf["moe_num_experts"]),
        experts_per_token=int(hf.get("moe_top_k", 2)),
        moe_intermediate_size=int(hf.get("moe_intermediate_size", hf["intermediate_size"])),
        score_func="sigmoid" if act == "sigmoid" else "softmax",
        norm_topk_prob=True,
        route_scale=float(hf.get("moe_router_scaling_factor", 1.0)),
        gate_bias_update_speed=0.001 if use_bias else 0.0,
    )
    kw = dict(
        vocab_size=int(hf["vocab_size"]),
        hidden_size=int(hf["hidden_size"]),
        intermediate_size=int(hf["intermediate_size"]),
        num_layers=L,
        layer_types=layer_types,
        global_attn=AttnGeom(num_heads=heads, num_kv_heads=kv, head_dim=head_dim),
        sliding_attn=AttnGeom(
            num_heads=int(other.get("num_attention_heads", heads)),
            num_kv_heads=int(other.get("num_attention_groups", kv)),
            head_dim=head_dim,
            sliding_window=int(hf.get("sliding_window") or 0) or None,
        ),
        qk_norm=True,
        head_gate=bool(hf.get("use_head_wise_attn_gate", False)),
        attention_bias=bool(hf.get("attention_bias", False)),
        rope_thetas=thetas,
        partial_rotary=prf,
        use_rope=use_rope,
        mlp_kinds=tuple("moe" if i in moe_set else "dense" for i in range(L)),
        moe=moe,
        share_expert_dim=int(share_dim),
        swiglu_limit=limit,
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", False)),
    )
    return _finish(kw, overrides)


def mimo_v2_flash_config(hf: Mapping[str, Any], **overrides) -> HetMoEConfig:
    """MiMoV2FlashForCausalLM: `hybrid_layer_pattern` (1 = sliding) with the
    swa_* head settings, per-type attention-sink logits, DeepSeek-style
    sigmoid routing on every `moe_layer_freq` layer."""
    L = int(hf["num_hidden_layers"])
    heads = int(hf["num_attention_heads"])
    kv = int(hf.get("num_key_value_heads", heads))
    pattern = hf.get("hybrid_layer_pattern")
    if pattern is None:
        block = hf.get("hybrid_block_size")
        if block:
            pattern = [0 if ((i + 1) % int(block) == 0) else 1 for i in range(L)]
        else:
            pattern = [0 if (i % 6 == 0 or i == L - 1) else 1 for i in range(L)]
    layer_types = tuple("sliding" if p == 1 else "global" for p in pattern)
    freq = hf.get("moe_layer_freq")
    if freq is None:
        freq = [1] * L
    head_dim = int(hf.get("head_dim", hf["hidden_size"] // heads))
    v_dim = int(hf.get("v_head_dim", head_dim) or head_dim)
    prf = float(hf.get("partial_rotary_factor", 1.0))
    moe = MoEConfig(
        n_routed_experts=int(hf["n_routed_experts"]),
        n_shared_experts=int(hf.get("n_shared_experts") or 0),
        experts_per_token=int(hf.get("num_experts_per_tok", 8)),
        n_groups=int(hf.get("n_group", 1)),
        topk_groups=int(hf.get("topk_group", 1)),
        moe_intermediate_size=int(hf["moe_intermediate_size"]),
        score_func="sigmoid" if hf.get("scoring_func", "sigmoid") == "sigmoid" else "softmax",
        norm_topk_prob=bool(hf.get("norm_topk_prob", True)),
        route_scale=float(hf.get("routed_scaling_factor", 1.0) or 1.0),
        gate_bias_update_speed=float(hf.get("bias_update_speed", 0.001)),
    )
    thetas = tuple(
        float(hf.get("swa_rope_theta", 10000.0)) if lt == "sliding"
        else float(hf.get("rope_theta", 5_000_000.0))
        for lt in layer_types
    )
    kw = dict(
        vocab_size=int(hf["vocab_size"]),
        hidden_size=int(hf["hidden_size"]),
        intermediate_size=int(hf["intermediate_size"]),
        num_layers=L,
        layer_types=layer_types,
        global_attn=AttnGeom(
            num_heads=heads, num_kv_heads=kv, head_dim=head_dim, v_head_dim=v_dim,
            sinks=bool(hf.get("add_full_attention_sink_bias", False)),
        ),
        sliding_attn=AttnGeom(
            num_heads=int(hf.get("swa_num_attention_heads", heads)),
            num_kv_heads=int(hf.get("swa_num_key_value_heads", kv)),
            head_dim=int(hf.get("swa_head_dim", head_dim) or head_dim),
            v_head_dim=int(hf.get("swa_v_head_dim", v_dim) or v_dim),
            sliding_window=int(hf.get("sliding_window") or 128),
            sinks=bool(hf.get("add_swa_attention_sink_bias", True)),
        ),
        qk_norm=False,
        attention_bias=bool(hf.get("attention_bias", False)),
        rope_thetas=thetas,
        partial_rotary=(prf,) * L,
        use_rope=(True,) * L,
        mlp_kinds=tuple("moe" if f else "dense" for f in freq),
        moe=moe,
        share_expert_dim=0,  # the shared experts live inside the MoE block
        rms_norm_eps=float(hf.get("layernorm_epsilon", hf.get("rms_norm_eps", 1e-5))),
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", False)),
    )
    return _finish(kw, overrides)


def minimax_m3_text_config(hf: Mapping[str, Any], **overrides) -> HetMoEConfig:
    """MiniMaxM3SparseForCausalLM: one attention geometry with per-head
    gemma qk-norm, partial rope (`rotary_dim` of head_dim), dense or MoE per
    layer from `moe_layer_freq` (0 = dense), SwiGLU-OAI dense and shared
    MLPs, sigmoid routing with the correction bias and routed scaling, and
    block-level sparse attention on the layers
    `sparse_attention_config.sparse_attention_freq` selects.
    `num_mtp_modules` is accepted and dropped, as in the JAX package."""
    L = int(hf["num_hidden_layers"])
    heads = int(hf["num_attention_heads"])
    kv = int(hf.get("num_key_value_heads", heads))
    head_dim = int(hf.get("head_dim", hf["hidden_size"] // heads))
    rotary_dim = int(hf.get("rotary_dim") or round(
        head_dim * float(hf.get("partial_rotary_factor", 1.0))))
    freq = hf.get("moe_layer_freq")
    mlp_kinds = tuple(
        "dense" if (freq is not None and not freq[i]) else "moe" for i in range(L))
    sp_cfg = dict(hf.get("sparse_attention_config") or {})
    if sp_cfg and sp_cfg.get("use_sparse_attention", True):
        sp_freq = sp_cfg.get("sparse_attention_freq")
        sparse = tuple(bool(sp_freq[i]) if sp_freq is not None else True for i in range(L))
    else:
        sparse = ()
    n_shared = int(hf.get("n_shared_experts") or 0)
    moe = MoEConfig(
        n_routed_experts=int(hf.get("num_local_experts", hf.get("num_experts", 8))),
        n_shared_experts=0,  # the shared expert is the share_expert_dim MLP
        experts_per_token=int(hf.get("num_experts_per_tok", 4)),
        moe_intermediate_size=int(hf["intermediate_size"]),
        score_func=(
            "softmax" if str(hf.get("scoring_func", "sigmoid")).lower() == "softmax"
            else "sigmoid"
        ),
        norm_topk_prob=True,
        route_scale=float(hf.get("routed_scaling_factor", 1.0) or 1.0),
        gate_bias_update_speed=0.001 if bool(hf.get("use_routing_bias", True)) else 0.0,
        expert_activation="swigluoai",
        swiglu_limit=float(hf.get("swiglu_limit", 7.0)),
    )
    kw = dict(
        vocab_size=int(hf["vocab_size"]),
        hidden_size=int(hf["hidden_size"]),
        intermediate_size=int(hf.get("dense_intermediate_size", hf["intermediate_size"])),
        num_layers=L,
        layer_types=("global",) * L,
        global_attn=AttnGeom(num_heads=heads, num_kv_heads=kv, head_dim=head_dim),
        sliding_attn=AttnGeom(num_heads=heads, num_kv_heads=kv, head_dim=head_dim),
        qk_norm=bool(hf.get("use_qk_norm", True)),
        rope_thetas=(float(hf.get("rope_theta", 5_000_000.0)),) * L,
        partial_rotary=(rotary_dim / head_dim,) * L,
        use_rope=(True,) * L,
        mlp_kinds=mlp_kinds,
        moe=moe,
        share_expert_dim=int(hf.get("shared_intermediate_size",
                                    hf["intermediate_size"])) * n_shared,
        swiglu_limit=float(hf.get("swiglu_limit", 7.0)),
        dense_activation="swigluoai",
        zero_centered_norm=bool(hf.get("use_gemma_norm", True)),
        sparse_attn=sparse,
        sparse_index_heads=int(sp_cfg.get("sparse_num_index_heads", 1) or 1),
        sparse_index_dim=int(sp_cfg.get("sparse_index_dim", 64) or 64),
        sparse_block_size=int(sp_cfg.get("sparse_block_size", 32) or 32),
        sparse_topk_blocks=int(sp_cfg.get("sparse_topk_blocks", 8) or 8),
        sparse_init_blocks=int(sp_cfg.get("sparse_init_block", 0) or 0),
        sparse_local_blocks=int(sp_cfg.get("sparse_local_block", 1) or 1),
        sparse_score_type=str(sp_cfg.get("sparse_score_type", "max")),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", False)),
    )
    if bool(hf.get("attention_output_gate", False)):
        raise NotImplementedError(
            "minimax_m3 attention_output_gate (the JAX package refuses it too)")
    return _finish(kw, overrides)


# ---------------------------------------------------------------------------
# HF checkpoint adapter
# ---------------------------------------------------------------------------
_IDX_ENTRIES = (
    ("self_attn.index_q_proj.weight", ("index_q_proj", "kernel"), True),
    ("self_attn.index_k_proj.weight", ("index_k_proj", "kernel"), True),
    ("self_attn.index_q_norm.weight", ("index_q_norm", "scale"), False),
    ("self_attn.index_k_norm.weight", ("index_k_norm", "scale"), False),
)
_MLP = ("gate_proj", "up_proj", "down_proj")
_M3_PROJ = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}


@dataclasses.dataclass
class HetMoEAdapter:
    """HF names <-> het_moe params, as the JAX adapter:

    - "step3p5": `self_attn.{q,k}_norm` and `g_proj`; STACKED expert tensors
      `moe.{gate,up,down}_proj.weight` (E, I, H) / (E, H, I), the router
      `moe.gate.weight` (E, H) with `moe.router_bias`, the shared expert
      under `share_expert.*`.
    - "mimo": per-expert `mlp.experts.{e}.{proj}.weight`, the router
      `mlp.gate.weight` with `mlp.gate.e_score_correction_bias`, per-layer
      `self_attn.attention_sink_bias`, shared experts under
      `mlp.shared_experts.*`.
    - "minimax_m3": per-expert `block_sparse_moe.experts.{e}.w1/w3/w2`, the
      router `block_sparse_moe.gate.weight` with
      `block_sparse_moe.e_score_correction_bias`, the shared experts under
      `block_sparse_moe.shared_experts.*` (the `shared_mlp`), the indexer
      `self_attn.index_{q,k}_{proj,norm}` on sparse layers.

    A geometry no layer uses is in no checkpoint: `from_hf` fills its one
    row from a generator seeded 0 on the target device (the JAX adapter
    from `jax.random.key(0)`: the values differ, and nothing reads them)."""

    cfg: Any  # HetMoEConfig
    style: str = "step3p5"

    STYLES = ("step3p5", "mimo", "minimax_m3")

    def __post_init__(self):
        if self.style not in self.STYLES:
            raise NotImplementedError(
                f"het_moe adapter style {self.style!r}; known: {self.STYLES}")

    def _attn_entries(self, g: AttnGeom) -> list:
        e = [(f"self_attn.{p}.weight", (p, "kernel"), True)
             for p in ("q_proj", "k_proj", "v_proj", "o_proj")]
        if self.cfg.qk_norm:
            e += [("self_attn.q_norm.weight", ("q_norm", "scale"), False),
                  ("self_attn.k_norm.weight", ("k_norm", "scale"), False)]
        if self.cfg.head_gate:
            e.append(("self_attn.g_proj.weight", ("g_proj", "kernel"), True))
        if g.sinks:
            e.append(("self_attn.attention_sink_bias", ("sinks",), False))
        return e

    def _gate_name(self, li: int) -> str:
        return {"minimax_m3": f"model.layers.{li}.block_sparse_moe.gate.weight",
                "step3p5": f"model.layers.{li}.moe.gate.weight",
                "mimo": f"model.layers.{li}.mlp.gate.weight"}[self.style]

    def _escore_name(self, li: int) -> str:
        return {"minimax_m3": f"model.layers.{li}.block_sparse_moe.e_score_correction_bias",
                "step3p5": f"model.layers.{li}.moe.router_bias",
                "mimo": f"model.layers.{li}.mlp.gate.e_score_correction_bias"}[self.style]

    def _expert_name(self, li: int, e: int, proj: str) -> str:
        if self.style == "minimax_m3":
            return f"model.layers.{li}.block_sparse_moe.experts.{e}.{_M3_PROJ[proj]}.weight"
        return f"model.layers.{li}.mlp.experts.{e}.{proj}.weight"

    def _shared_name(self, li: int, proj: str) -> str:
        return {"minimax_m3": f"model.layers.{li}.block_sparse_moe.shared_experts.{proj}.weight",
                "step3p5": f"model.layers.{li}.share_expert.{proj}.weight",
                "mimo": f"model.layers.{li}.mlp.shared_experts.{proj}.weight"}[self.style]

    def _shared_path(self) -> tuple | None:
        """Where the shared expert lives: the share_expert_dim MLP
        (Step-3.5, MiniMax-M3) or the MoE block's own (MiMo)."""
        if self.style == "mimo":
            return ("moe", "shared") if self.cfg.moe.n_shared_experts else None
        return ("shared_mlp",) if self.cfg.share_expert_dim else None

    # -- export --------------------------------------------------------------
    def to_hf(self, params: Mapping):
        """Yield (hf_name, tensor) in the JAX adapter's names; tensors stay
        on the params' device, as views."""
        cfg = self.cfg
        yield "model.embed_tokens.weight", params["embed"]["embedding"]
        yield "model.norm.weight", params["final_norm"]["scale"]
        if not cfg.tie_word_embeddings:
            yield "lm_head.weight", _t(params["lm_head"]["kernel"])
        shared = self._shared_path()
        for li, lt, a_key, ai, is_moe, mi, is_sparse, spi in layer_rows(cfg):
            base = f"model.layers.{li}."
            yield base + "input_layernorm.weight", params["input_norms"]["scale"][li]
            yield base + "post_attention_layernorm.weight", params["post_norms"]["scale"][li]
            for suf, path, tr in self._attn_entries(cfg.geom(lt)):
                x = _get(params[a_key], path)[ai]
                yield base + suf, (_t(x) if tr else x)
            if is_sparse:
                for suf, path, tr in _IDX_ENTRIES:
                    x = _get(params["indexer"], path)[spi]
                    yield base + suf, (_t(x) if tr else x)
            if not is_moe:
                for proj in _MLP:
                    yield base + f"mlp.{proj}.weight", _t(params["dense_mlp"][proj]["kernel"][mi])
                continue
            moe = params["moe"]
            yield self._gate_name(li), _t(moe["gate"]["weight"][mi])
            if "e_score_bias" in moe["gate"]:
                yield self._escore_name(li), moe["gate"]["e_score_bias"][mi]
            if self.style == "step3p5":
                # stacked: ours (E, H, I) / (E, I, H), HF's transposed
                for proj in _MLP:
                    yield (base + f"moe.{proj}.weight",
                           moe["experts"][proj]["kernel"][mi].transpose(-1, -2))
            else:
                for e in range(cfg.moe.n_routed_experts):
                    for proj in _MLP:
                        yield (self._expert_name(li, e, proj),
                               _t(moe["experts"][proj]["kernel"][mi, e]))
            if shared is not None:
                for proj in _MLP:
                    yield (self._shared_name(li, proj),
                           _t(_get(params, shared)[proj]["kernel"][mi]))

    # -- import --------------------------------------------------------------
    def from_hf(self, read: Reader, device=None, dtype: torch.dtype = torch.float32) -> dict:
        """The params tree on `device` (None means CUDA) in `dtype`, each
        stack filled one HF tensor at a time."""
        cfg = self.cfg
        device = resolve_device(device)
        rows = layer_rows(cfg)
        out: dict = {}

        def load(tr):
            def one(name):
                x = read(name).to(device)
                return _t(x) if tr else x
            return one

        def stack(path, names, tr=True):
            _set(out, path, _stack((len(names),), lambda i: names[i], load(tr),
                                   dtype, device))

        for name, path, tr in (("model.embed_tokens.weight", ("embed", "embedding"), False),
                               ("model.norm.weight", ("final_norm", "scale"), False)):
            _set(out, path, _stack((), lambda: name, load(tr), dtype, device))
        if not cfg.tie_word_embeddings:
            _set(out, ("lm_head", "kernel"),
                 _stack((), lambda: "lm_head.weight", load(True), dtype, device))
        L = cfg.num_layers
        stack(("input_norms", "scale"),
              [f"model.layers.{li}.input_layernorm.weight" for li in range(L)], False)
        stack(("post_norms", "scale"),
              [f"model.layers.{li}.post_attention_layernorm.weight" for li in range(L)], False)
        for a_key, lt_name in (("g_attn", "global"), ("s_attn", "sliding")):
            lis = [r[0] for r in rows if r[1] == lt_name]
            g = cfg.geom(lt_name)
            if not lis:
                # one unused row keeps the layout uniform
                gen = torch.Generator(device=device).manual_seed(0)
                out[a_key] = _init_attn_group(cfg, g, gen, 1, dtype)
                continue
            for suf, path, tr in self._attn_entries(g):
                stack((a_key,) + path, [f"model.layers.{li}.{suf}" for li in lis], tr)
        sparse = [r[0] for r in rows if r[6]]
        for suf, path, tr in _IDX_ENTRIES if sparse else ():
            stack(("indexer",) + path, [f"model.layers.{li}.{suf}" for li in sparse], tr)
        dense = [r[0] for r in rows if not r[4]]
        for proj in _MLP if dense else ():
            stack(("dense_mlp", proj, "kernel"),
                  [f"model.layers.{li}.mlp.{proj}.weight" for li in dense])
        moe_rows = [r[0] for r in rows if r[4]]
        if not moe_rows:
            return out
        stack(("moe", "gate", "weight"), [self._gate_name(li) for li in moe_rows])
        if cfg.moe.gate_bias_update_speed > 0:
            stack(("moe", "gate", "e_score_bias"),
                  [self._escore_name(li) for li in moe_rows], False)
        for proj in _MLP:
            path = ("moe", "experts", proj, "kernel")
            if self.style == "step3p5":
                _set(out, path, _stack(
                    (len(moe_rows),), lambda i: f"model.layers.{moe_rows[i]}.moe.{proj}.weight",
                    lambda n: read(n).to(device).transpose(-1, -2), dtype, device))
            else:
                _set(out, path, _stack(
                    (len(moe_rows), cfg.moe.n_routed_experts),
                    lambda i, e: self._expert_name(moe_rows[i], e, proj),
                    load(True), dtype, device))
        shared = self._shared_path()
        for proj in _MLP if shared is not None else ():
            stack(shared + (proj, "kernel"), [self._shared_name(li, proj) for li in moe_rows])
        return out


ADAPTERS["het_moe"] = HetMoEAdapter
