"""Gemma-4 MoE (the 26B-A4B family), a decoder whose FFN runs a dense MLP
and a routed MoE in parallel (port of `automodel_tpu/models/moe_lm/gemma4.py`).

Per layer, as in the JAX module:

    x = residual + post_attn_norm(attn(input_norm(x)))
    d = post_ffn_norm_1(dense_mlp(pre_ffn_norm(x)))
    m = post_ffn_norm_2(moe(pre_ffn_norm_2(x), routed on the RAW x))
    x = (x + post_ffn_norm(d + m)) * layer_scalar

- The router (`gemma4_gate`) scores a scale-free RMSNorm of the raw
  residual, times hidden**-0.5 and a learned per-channel scale, in fp32:
  softmax -> top-k (ties to the lowest expert index, `stable_topk`, as
  `jax.lax.top_k`) -> renormalize. No aux loss.
- Attention as Gemma-3: per-head zero-centered qk-norm, the
  `query_pre_attn_scalar` scale (`attn_scale`), sliding and global layers
  with their own rope theta, zero-centered norms, scaled embeddings. Every
  layer attends through `ops/attention.dot_product_attention` (K1-K3 on
  the card).
- KV sharing: the trailing `num_kv_shared_layers` layers compute no K/V and
  read the most recent full layer's of the same type. Their k/v kernels
  and k_norm are zero placeholders in the stacked layout, absent from HF
  checkpoints; they get zero gradients (the unbind's backward fills the
  rows no layer read) and stay zero under AdamW.

The parameter layout is the JAX package's (one `layers` stack). The expert
products are the dropless grouped path of `moe/experts.py`; the
expert-parallel path and the parameter specs are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from automodel_tpu_torch.checkpoint.hf_adapter import (
    ADAPTERS,
    Reader,
    _set,
    _stack,
    _stack_zero_fill,
    _t,
)
from automodel_tpu_torch.models.common.layers import (
    cast_params,
    embed_init,
    init_fns,
    maybe_remat,
    unstack_layers,
)
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.experts import experts_forward_dropless, init_experts
from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.dsa import stable_topk
from automodel_tpu_torch.ops.matmul import matmul_fp32
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import RopeScalingConfig, apply_rope, rope_frequencies
from automodel_tpu_torch.utils.device import resolve_device

__all__ = ["Gemma4MoEAdapter", "Gemma4MoEConfig", "forward", "gemma4_gate",
           "gemma4_moe_config", "head_kernel", "init", "unembed"]


@dataclasses.dataclass(frozen=True)
class Gemma4MoEConfig:
    """The JAX `Gemma4MoEConfig`, field for field; `dtype` is a torch dtype."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 4096      # the dense branch's MLP
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 256
    layer_types: tuple = ()            # "sliding" | "global" per layer
    sliding_window: Optional[int] = 512
    rope_theta: float = 1_000_000.0
    rope_local_theta: float = 10_000.0
    rope_scaling: RopeScalingConfig = dataclasses.field(default_factory=RopeScalingConfig)
    attn_scale: Optional[float] = None  # query_pre_attn_scalar ** -0.5
    num_kv_shared_layers: int = 0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    causal: bool = True
    logits_soft_cap: Optional[float] = None
    dtype: Any = torch.bfloat16
    remat_policy: str = "full"
    attn_impl: str = "auto"
    scan_unroll: int = 1
    mtp_num_layers: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim

    @property
    def embed_scale(self) -> float:
        return float(self.hidden_size) ** 0.5

    def resolved_layer_types(self) -> tuple:
        return self.layer_types or tuple(
            "sliding" if (i + 1) % 6 else "global" for i in range(self.num_layers))

    def flops_per_token(self, seq_len: int) -> float:
        H, D = self.hidden_size, self.head_dim
        attn_p = H * D * (2 * self.num_heads + 2 * self.num_kv_heads)
        mlp_p = 3 * H * self.intermediate_size
        moe_p = 3 * H * self.moe.moe_intermediate_size * self.moe.experts_per_token
        n = self.vocab_size * H + self.num_layers * (attn_p + mlp_p + moe_p)
        return 6.0 * n + 6.0 * self.num_layers * self.num_heads * D * seq_len


def init(cfg: Gemma4MoEConfig, gen: torch.Generator,
         dtype: torch.dtype = torch.float32) -> dict:
    """Random params on the generator's device, drawn in `dtype`. The norms
    start at zero (zero-centered), `layer_scalar` and the router scale at 1."""
    H, I, D, L = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim, cfg.num_layers
    ones, zeros, dense = init_fns(gen, dtype)
    layers = {
        "input_norm": {"scale": zeros(L, H)},
        "post_attn_norm": {"scale": zeros(L, H)},
        "q_proj": {"kernel": dense(L, H, cfg.num_heads * D)},
        "k_proj": {"kernel": dense(L, H, cfg.num_kv_heads * D)},
        "v_proj": {"kernel": dense(L, H, cfg.num_kv_heads * D)},
        "o_proj": {"kernel": dense(L, cfg.num_heads * D, H)},
        "q_norm": {"scale": zeros(L, D)},
        "k_norm": {"scale": zeros(L, D)},
        "pre_ffn_norm": {"scale": zeros(L, H)},
        "post_ffn_norm_1": {"scale": zeros(L, H)},
        "pre_ffn_norm_2": {"scale": zeros(L, H)},
        "post_ffn_norm_2": {"scale": zeros(L, H)},
        "post_ffn_norm": {"scale": zeros(L, H)},
        "layer_scalar": ones(L, 1),
        "gate_proj": {"kernel": dense(L, H, I)},
        "up_proj": {"kernel": dense(L, H, I)},
        "down_proj": {"kernel": dense(L, I, H)},
        "router": {
            "proj": {"kernel": dense(L, H, cfg.moe.n_routed_experts)},
            "scale": ones(L, H),
        },
        "experts": init_experts(cfg.moe, H, gen, dtype, num_layers=L),
    }
    params = {
        "embed": {"embedding": embed_init(gen, (cfg.vocab_size, H), dtype)},
        "final_norm": {"scale": zeros(H)},
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": dense(H, cfg.vocab_size)}
    return params


def gemma4_gate(x_raw, lp: dict, cfg: Gemma4MoEConfig):
    """The router on the RAW residual (T, H): scale-free RMSNorm,
    * H**-0.5 * scale, fp32 linear, softmax, top-k, renormalized. Returns
    (weights (T, K) fp32, indices (T, K))."""
    x = x_raw.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + cfg.rms_norm_eps)
    x = x * (float(cfg.hidden_size) ** -0.5)
    x = x * lp["router"]["scale"].float()
    logits = x @ lp["router"]["proj"]["kernel"].float()
    probs = torch.softmax(logits, dim=-1)
    weights, indices = stable_topk(probs, cfg.moe.experts_per_token)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-20)
    return weights, indices


def head_kernel(params: dict, cfg: Gemma4MoEConfig) -> torch.Tensor:
    """(H, V) output-projection kernel, tied or untied."""
    if cfg.tie_word_embeddings:
        return params["embed"]["embedding"].T
    return params["lm_head"]["kernel"]


def unembed(params: dict, cfg: Gemma4MoEConfig, h: torch.Tensor) -> torch.Tensor:
    """hidden -> fp32 logits, soft-capped when the config says so."""
    logits = matmul_fp32(h, head_kernel(params, cfg).to(h.dtype))
    if cfg.logits_soft_cap is not None:
        logits = cfg.logits_soft_cap * torch.tanh(logits / cfg.logits_soft_cap)
    return logits


def forward(
    params: dict,
    cfg: Gemma4MoEConfig,
    input_ids: torch.Tensor,  # (B, S) integer
    *,
    positions: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    mesh_ctx=None,
    return_hidden: bool = False,
    token_mask: torch.Tensor | None = None,
    return_stats: bool = False,
    lora: dict | None = None,
    lora_cfg=None,
) -> tuple:
    """Returns (logits-or-hidden, aux_loss[, stats]), the moe_lm protocol,
    as the JAX `forward` on one device: the aux loss is always 0 (the
    router has none) and, as in JAX, `token_mask` routes nothing
    differently. stats["tokens_per_expert"] is (num_layers, E)."""
    for name, value in (("mesh_ctx (expert parallelism)", mesh_ctx),
                        ("lora (PEFT on Gemma-4 MoE)", lora)):
        if value is not None:
            raise NotImplementedError(f"gemma4 forward: {name} is not ported")
    dtype = cfg.dtype
    B, S = input_ids.shape
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    h = params["embed"]["embedding"][input_ids].to(dtype)
    h = h * torch.tensor(cfg.embed_scale, dtype=dtype)

    inv_freq = {
        "global": rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling),
        "sliding": rope_frequencies(cfg.head_dim, cfg.rope_local_theta, None),
    }
    inv_freq = {k: v.to(dev, non_blocking=True) for k, v in inv_freq.items()}
    D, H, E = cfg.head_dim, cfg.hidden_size, cfg.moe.n_routed_experts
    scale = cfg.attn_scale if cfg.attn_scale is not None else D ** -0.5
    eps = cfg.rms_norm_eps
    first_shared = cfg.num_layers - cfg.num_kv_shared_layers

    def norm(x, lp, name):
        return rms_norm(x, lp[name]["scale"], eps, zero_centered=True)

    def one_layer(h, lp, lt, kv_in):
        """Returns (h_out, k, v, tokens_per_expert)."""
        lp = cast_params(lp, dtype)
        window = cfg.sliding_window if lt == "sliding" else None
        resid = h
        x = norm(h, lp, "input_norm")
        q = (x @ lp["q_proj"]["kernel"]).reshape(B, S, cfg.num_heads, D)
        q = apply_rope(norm(q, lp, "q_norm"), positions, inv_freq[lt])
        if kv_in is None:
            k = (x @ lp["k_proj"]["kernel"]).reshape(B, S, cfg.num_kv_heads, D)
            k = apply_rope(norm(k, lp, "k_norm"), positions, inv_freq[lt])
            v = (x @ lp["v_proj"]["kernel"]).reshape(B, S, cfg.num_kv_heads, D)
        else:
            k, v = kv_in
        attn = dot_product_attention(
            q, k, v, causal=cfg.causal, segment_ids=segment_ids,
            positions=positions, sliding_window=window, scale=scale,
            impl=cfg.attn_impl,
        ).reshape(B, S, cfg.num_heads * D)
        h = resid + norm(attn @ lp["o_proj"]["kernel"], lp, "post_attn_norm")

        resid = h
        xd = norm(h, lp, "pre_ffn_norm")
        d = F.gelu(xd @ lp["gate_proj"]["kernel"], approximate="tanh") * (
            xd @ lp["up_proj"]["kernel"])
        d = norm(d @ lp["down_proj"]["kernel"], lp, "post_ffn_norm_1")

        flat = norm(h, lp, "pre_ffn_norm_2").reshape(B * S, H)
        weights, indices = gemma4_gate(h.reshape(B * S, H), lp, cfg)
        routed = experts_forward_dropless(lp["experts"], cfg.moe, flat,
                                          weights.to(flat.dtype), indices)
        m = norm(routed.reshape(B, S, H), lp, "post_ffn_norm_2")
        h = (resid + norm(d + m, lp, "post_ffn_norm")) * lp["layer_scalar"][0]
        tpe = torch.zeros(E, device=dev).scatter_add_(
            0, indices.reshape(-1).long(), torch.ones(indices.numel(), device=dev))
        return h, k, v, tpe

    layer_fn = maybe_remat(one_layer, cfg.remat_policy)
    last_kv: dict = {"sliding": None, "global": None}
    stats_rows = []
    rows = unstack_layers(params["layers"])
    for i, lt in enumerate(cfg.resolved_layer_types()):
        kv_in = last_kv[lt] if i >= first_shared else None
        h, k, v, tpe = layer_fn(h, rows[i], lt, kv_in)
        if i < first_shared:
            last_kv[lt] = (k, v)
        stats_rows.append(tpe)

    h = rms_norm(h, params["final_norm"]["scale"].to(dtype), eps, zero_centered=True)
    out = h if return_hidden else unembed(params, cfg, h)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if return_stats:
        return out, aux, {"tokens_per_expert": torch.stack(stats_rows)}
    return out, aux


def gemma4_moe_config(hf: dict, **overrides) -> Gemma4MoEConfig:
    """Gemma4ForConditionalGeneration -> its text decoder's config (a VL
    composite nests it under `text_config`). Override keys the config does
    not have are dropped, as in the JAX function."""
    text = hf.get("text_config") or hf
    lt = text.get("layer_types")
    if lt is not None:
        layer_types = tuple("sliding" if t == "sliding_attention" else "global" for t in lt)
    else:
        pattern = int(text.get("sliding_window_pattern", 6) or 6)
        layer_types = tuple(
            "global" if (i + 1) % pattern == 0 else "sliding"
            for i in range(int(text["num_hidden_layers"])))
    moe_inter = text.get("moe_intermediate_size") or text.get("expert_intermediate_size")
    moe = MoEConfig(
        n_routed_experts=int(text["num_experts"]),
        experts_per_token=int(text["top_k_experts"]),
        moe_intermediate_size=int(moe_inter),
        score_func="softmax",
        norm_topk_prob=True,
        expert_activation="geglu",
        aux_loss_coeff=0.0,
        dispatcher="dropless",
    )
    heads = int(text["num_attention_heads"])
    qpas = text.get("query_pre_attn_scalar")
    kw = dict(
        vocab_size=int(text["vocab_size"]),
        hidden_size=int(text["hidden_size"]),
        intermediate_size=int(text["intermediate_size"]),
        num_layers=int(text["num_hidden_layers"]),
        num_heads=heads,
        num_kv_heads=int(text.get("num_key_value_heads", heads)),
        head_dim=int(text.get("head_dim", 256)),
        layer_types=layer_types,
        sliding_window=int(text.get("sliding_window", 512) or 512),
        rope_theta=float(text.get("rope_theta", 1_000_000.0)),
        rope_local_theta=float(text.get("rope_local_base_freq", 10_000.0)),
        rope_scaling=RopeScalingConfig.from_hf(text.get("rope_scaling")),
        attn_scale=(float(qpas) ** -0.5) if qpas else None,
        num_kv_shared_layers=int(text.get("num_kv_shared_layers", 0) or 0),
        rms_norm_eps=float(text.get("rms_norm_eps", 1e-6)),
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", True)),
        moe=moe,
    )
    moe_overrides = overrides.pop("moe", None)
    known = {f.name for f in dataclasses.fields(Gemma4MoEConfig)}
    kw.update({k: v for k, v in overrides.items() if k in known})
    if moe_overrides is not None:
        kw["moe"] = moe_overrides
    return Gemma4MoEConfig(**kw)


class Gemma4MoEAdapter:
    """Gemma4ForConditionalGeneration text weights <-> the params tree, in
    the JAX adapter's names: experts stacked as `moe.gate_up_proj`
    (E, 2I, H) [gate; up] and `moe.down_proj` (E, H, I), with a
    `moe.per_expert_scale` (E) folded into down_proj at load and exported as
    ones; the router's `router.proj.weight` and `router.scale`; a
    `layer_scalar` per layer (ones where a checkpoint has none). KV-shared
    layers carry no k/v/k_norm keys: zero rows at load, left out at export.
    Loading reads the `model.language_model.` prefix or `model.`; export
    writes the former."""

    _NORMS = {
        "input_layernorm": "input_norm",
        "post_attention_layernorm": "post_attn_norm",
        "pre_feedforward_layernorm": "pre_ffn_norm",
        "post_feedforward_layernorm_1": "post_ffn_norm_1",
        "pre_feedforward_layernorm_2": "pre_ffn_norm_2",
        "post_feedforward_layernorm_2": "post_ffn_norm_2",
        "post_feedforward_layernorm": "post_ffn_norm",
    }

    def __init__(self, cfg: Gemma4MoEConfig):
        self.cfg = cfg

    def _kv_absent(self, i: int) -> bool:
        return i >= self.cfg.num_layers - self.cfg.num_kv_shared_layers

    def from_hf(self, read: Reader, device=None, dtype: torch.dtype = torch.float32) -> dict:
        """The params tree on `device` (None means CUDA) in `dtype`."""
        cfg = self.cfg
        device = resolve_device(device)
        L, I = cfg.num_layers, cfg.moe.moe_intermediate_size
        keys = set(read.keys()) if hasattr(read, "keys") else None

        def has(name):
            if keys is not None:
                return name in keys
            try:
                read(name)
                return True
            except KeyError:
                return False

        prefix = ("model.language_model."
                  if has("model.language_model.embed_tokens.weight") else "model.")

        def load(tr):
            def one(name):
                x = read(name).to(device)
                return _t(x) if tr else x
            return one

        def name_of(suffix):
            return lambda i: f"{prefix}layers.{i}.{suffix}"

        def stack(path, suffix, tr):
            _set(out, ("layers",) + path, _stack((L,), name_of(suffix), load(tr), dtype, device))

        out: dict = {}
        _set(out, ("embed", "embedding"), _stack(
            (), lambda: prefix + "embed_tokens.weight", load(False), dtype, device))
        _set(out, ("final_norm", "scale"), _stack(
            (), lambda: prefix + "norm.weight", load(False), dtype, device))
        if not cfg.tie_word_embeddings and has("lm_head.weight"):
            _set(out, ("lm_head", "kernel"), _stack(
                (), lambda: "lm_head.weight", load(True), dtype, device))
        for hf_name, key in self._NORMS.items():
            stack((key, "scale"), hf_name + ".weight", False)
        stack(("q_norm", "scale"), "self_attn.q_norm.weight", False)
        stack(("q_proj", "kernel"), "self_attn.q_proj.weight", True)
        stack(("o_proj", "kernel"), "self_attn.o_proj.weight", True)

        def guarded(tr):
            one = load(tr)

            def read_kv(name):
                if self._kv_absent(int(name.split("layers.")[1].split(".")[0])):
                    raise KeyError(name)
                return one(name)
            return read_kv

        for path, suffix, tr in ((("k_proj", "kernel"), "self_attn.k_proj.weight", True),
                                 (("v_proj", "kernel"), "self_attn.v_proj.weight", True),
                                 (("k_norm", "scale"), "self_attn.k_norm.weight", False)):
            _set(out, ("layers",) + path, _stack_zero_fill(
                L, name_of(suffix), guarded(tr), dtype, device, self._kv_absent))

        def scalar(name):
            return read(name).to(device).reshape(1) if has(name) else torch.ones(1)

        _set(out, ("layers", "layer_scalar"), _stack(
            (L,), name_of("layer_scalar"), scalar, dtype, device))
        for proj in ("gate_proj", "up_proj", "down_proj"):
            stack((proj, "kernel"), f"mlp.{proj}.weight", True)
        stack(("router", "proj", "kernel"), "router.proj.weight", True)
        stack(("router", "scale"), "router.scale", False)

        experts = ("layers", "experts")
        for proj, cols in (("gate_proj", slice(0, I)), ("up_proj", slice(I, 2 * I))):
            # (E, 2I, H) -> (E, H, 2I) -> the gate or up half
            _set(out, experts + (proj, "kernel"), _stack(
                (L,), name_of("moe.gate_up_proj"),
                lambda n, cols=cols: read(n).to(device).transpose(-1, -2)[..., cols],
                dtype, device))

        def down(name):
            dn = read(name).to(device)                       # (E, H, I)
            pes_name = name.replace("moe.down_proj", "moe.per_expert_scale")
            pes = (read(pes_name).to(device) if has(pes_name)
                   else torch.ones(dn.shape[0], dtype=dn.dtype, device=device))
            return dn.transpose(-1, -2) * pes[:, None, None]

        _set(out, experts + ("down_proj", "kernel"), _stack(
            (L,), name_of("moe.down_proj"), down, dtype, device))
        return out

    def to_hf(self, params):
        """Yield (hf_name, tensor) under `model.language_model.`."""
        cfg = self.cfg
        prefix = "model.language_model."
        yield prefix + "embed_tokens.weight", params["embed"]["embedding"]
        yield prefix + "norm.weight", params["final_norm"]["scale"]
        if not cfg.tie_word_embeddings and "lm_head" in params:
            yield "lm_head.weight", _t(params["lm_head"]["kernel"])
        lay = params["layers"]
        for i in range(cfg.num_layers):
            base = f"{prefix}layers.{i}."
            for hf_name, key in self._NORMS.items():
                yield base + hf_name + ".weight", lay[key]["scale"][i]
            yield base + "self_attn.q_norm.weight", lay["q_norm"]["scale"][i]
            yield base + "self_attn.q_proj.weight", _t(lay["q_proj"]["kernel"][i])
            yield base + "self_attn.o_proj.weight", _t(lay["o_proj"]["kernel"][i])
            if not self._kv_absent(i):
                yield base + "self_attn.k_proj.weight", _t(lay["k_proj"]["kernel"][i])
                yield base + "self_attn.v_proj.weight", _t(lay["v_proj"]["kernel"][i])
                yield base + "self_attn.k_norm.weight", lay["k_norm"]["scale"][i]
            yield base + "layer_scalar", lay["layer_scalar"][i].reshape(1)
            for proj in ("gate_proj", "up_proj", "down_proj"):
                yield base + f"mlp.{proj}.weight", _t(lay[proj]["kernel"][i])
            yield base + "router.proj.weight", _t(lay["router"]["proj"]["kernel"][i])
            yield base + "router.scale", lay["router"]["scale"][i]
            ex = lay["experts"]
            g, u = ex["gate_proj"]["kernel"][i], ex["up_proj"]["kernel"][i]  # (E, H, I)
            yield base + "moe.gate_up_proj", torch.cat([g, u], dim=-1).transpose(-1, -2)
            yield base + "moe.down_proj", ex["down_proj"]["kernel"][i].transpose(-1, -2)
            yield base + "moe.per_expert_scale", torch.ones(
                g.shape[0], dtype=g.dtype, device=g.device)


ADAPTERS["gemma4_moe"] = Gemma4MoEAdapter
