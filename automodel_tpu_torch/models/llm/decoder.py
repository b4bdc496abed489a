"""Generic dense decoder LM (port of `automodel_tpu/models/llm/decoder.py`).

The parameter layout is the JAX package's, key for key: per-layer weights
stacked on dim 0 under `params["layers"]`, linear kernels stored `(in, out)`
and applied as `x @ W`. So weights convert by copying (`convert.py`).

Ported here: the config, `layer_windows`, `init`, and the layer pieces the
serving engine runs (`_dense`, `head_kernel`/`unembed`, `project_qkv`,
`mlp_inner`). The full-sequence `forward` belongs to the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.common.layers import dense_init, embed_init
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import RopeScalingConfig, apply_rope


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The dense-decoder fields of the JAX `TransformerConfig`, with the same
    names and defaults; `dtype` is a torch dtype."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: RopeScalingConfig = dataclasses.field(default_factory=RopeScalingConfig)
    rms_norm_eps: float = 1e-5
    attention_bias: bool = False
    qk_norm: bool = False  # qwen3-style per-head-dim RMSNorm on q/k
    qk_norm_after_rope: bool = False
    qk_norm_flat: bool = False  # RMSNorm over the flattened q/k projections
    partial_rotary_factor: float = 1.0
    rope_interleaved: bool = False
    # gemma3: sliding-window layers use this rope theta (no scaling)
    rope_local_theta: Optional[float] = None
    attn_scale: Optional[float] = None  # None → head_dim**-0.5
    sliding_window: Optional[int] = None
    # per-layer "sliding"/"global" types; None → sliding_window on all layers
    layer_types: Optional[tuple] = None
    use_post_norms: bool = False  # gemma2-style norms on the attn/mlp branches
    logits_soft_cap: Optional[float] = None
    attn_soft_cap: Optional[float] = None
    embed_scale: float = 1.0
    tie_word_embeddings: bool = False
    activation: str = "silu"
    zero_centered_norm: bool = False  # gemma stores scale-1
    normalized_lm_head: bool = False  # baichuan NormHead
    attention_sinks: bool = False  # gpt-oss per-head sink logits
    o_proj_bias: bool = False
    # "gqa" only: MLA ("mla") models are not ported yet
    attention_type: str = "gqa"
    dtype: torch.dtype = torch.bfloat16

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def rope_dim(self) -> int:
        d = round(self.resolved_head_dim * self.partial_rotary_factor)
        return d - (d % 2)


def layer_windows(cfg: TransformerConfig, num_layers: int | None = None) -> tuple:
    """Per-layer static sliding windows (None = global attention)."""
    L = num_layers if num_layers is not None else cfg.num_layers
    if cfg.sliding_window is None:
        return (None,) * L
    if cfg.layer_types is None:
        return (cfg.sliding_window,) * L
    if len(cfg.layer_types) != L:
        raise ValueError(f"{len(cfg.layer_types)} layer_types for {L} layers")
    return tuple(
        cfg.sliding_window if t == "sliding" else None for t in cfg.layer_types
    )


ACTIVATIONS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}


def init(cfg: TransformerConfig, gen: torch.Generator,
         dtype: torch.dtype = torch.float32) -> dict:
    """Random params with per-layer weights stacked on dim 0, on the
    generator's device (so a large model initialises on the card with no
    host copy). `dtype` defaults to fp32 masters; pass the compute dtype to
    skip the fp32 copy of a large model."""
    if cfg.attention_type != "gqa":
        raise NotImplementedError(f"attention_type {cfg.attention_type!r}")
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    D = cfg.resolved_head_dim
    dev = gen.device

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def dense(*shape):
        return dense_init(gen, shape, dtype)

    layers = {
        "input_norm": {"scale": ones(L, H)},
        "q_proj": {"kernel": dense(L, H, cfg.num_heads * D)},
        "k_proj": {"kernel": dense(L, H, cfg.num_kv_heads * D)},
        "v_proj": {"kernel": dense(L, H, cfg.num_kv_heads * D)},
        "o_proj": {"kernel": dense(L, cfg.num_heads * D, H)},
        "post_attn_norm": {"scale": ones(L, H)},
    }
    if cfg.attention_bias:
        layers["q_proj"]["bias"] = zeros(L, cfg.num_heads * D)
        layers["k_proj"]["bias"] = zeros(L, cfg.num_kv_heads * D)
        layers["v_proj"]["bias"] = zeros(L, cfg.num_kv_heads * D)
    if cfg.o_proj_bias:
        layers["o_proj"]["bias"] = zeros(L, H)
    if cfg.qk_norm:
        layers["q_norm"] = {"scale": ones(L, D)}
        layers["k_norm"] = {"scale": ones(L, D)}
    if cfg.qk_norm_flat:
        layers["q_norm"] = {"scale": ones(L, cfg.num_heads * D)}
        layers["k_norm"] = {"scale": ones(L, cfg.num_kv_heads * D)}
    if cfg.use_post_norms:
        layers["post_attn_out_norm"] = {"scale": ones(L, H)}
        layers["post_mlp_norm"] = {"scale": ones(L, H)}
    if cfg.attention_sinks:
        layers["sinks"] = zeros(L, cfg.num_heads)
    layers["gate_proj"] = {"kernel": dense(L, H, I)}
    layers["up_proj"] = {"kernel": dense(L, H, I)}
    layers["down_proj"] = {"kernel": dense(L, I, H)}
    params = {
        "embed": {"embedding": embed_init(gen, (cfg.vocab_size, H), dtype)},
        "layers": layers,
        "final_norm": {"scale": ones(H)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": dense(H, cfg.vocab_size)}
    return params


def _dense(x, p):
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def head_kernel(params: dict, cfg: TransformerConfig) -> torch.Tensor:
    """(H, V) output-projection kernel: tied/untied, with baichuan NormHead
    L2-normalization per vocab row when cfg.normalized_lm_head."""
    if cfg.tie_word_embeddings:
        kernel = params["embed"]["embedding"].T
    else:
        kernel = params["lm_head"]["kernel"]
    if cfg.normalized_lm_head:
        kf = kernel.float()
        norm = torch.sqrt(torch.sum(kf * kf, dim=0, keepdim=True))
        kernel = (kf / torch.clamp(norm, min=1e-12)).to(kernel.dtype)
    return kernel


def unembed(params: dict, cfg: TransformerConfig, h: torch.Tensor) -> torch.Tensor:
    """hidden → fp32 logits (with optional tied embeddings / soft cap). The
    product runs in h's dtype and is widened after (JAX asks XLA for an fp32
    result directly; the two agree exactly in fp32)."""
    logits = (h @ head_kernel(params, cfg).to(h.dtype)).float()
    if cfg.logits_soft_cap is not None:
        logits = cfg.logits_soft_cap * torch.tanh(logits / cfg.logits_soft_cap)
    return logits


def project_qkv(x, lp, cfg: TransformerConfig, positions, inv_freq):
    """q/k/v projections incl. bias, qk-norm and rope. x (B, S, H) →
    q (B, S, Hq, D), k/v (B, S, Hkv, D)."""
    B, S, _ = x.shape
    D = cfg.resolved_head_dim
    eps, zc = cfg.rms_norm_eps, cfg.zero_centered_norm
    q = _dense(x, lp["q_proj"])
    k = _dense(x, lp["k_proj"])
    v = _dense(x, lp["v_proj"])
    if cfg.qk_norm_flat:
        q = rms_norm(q, lp["q_norm"]["scale"], eps, zc)
        k = rms_norm(k, lp["k_norm"]["scale"], eps, zc)
    q = q.reshape(B, S, cfg.num_heads, D)
    k = k.reshape(B, S, cfg.num_kv_heads, D)
    v = v.reshape(B, S, cfg.num_kv_heads, D)
    if cfg.qk_norm and not cfg.qk_norm_after_rope:
        q = rms_norm(q, lp["q_norm"]["scale"], eps, zc)
        k = rms_norm(k, lp["k_norm"]["scale"], eps, zc)
    q = apply_rope(q, positions, inv_freq, cfg.rope_interleaved)
    k = apply_rope(k, positions, inv_freq, cfg.rope_interleaved)
    if cfg.qk_norm and cfg.qk_norm_after_rope:
        q = rms_norm(q, lp["q_norm"]["scale"], eps, zc)
        k = rms_norm(k, lp["k_norm"]["scale"], eps, zc)
    return q, k, v


def mlp_inner(x, lp, cfg: TransformerConfig):
    """Gated MLP core (no norm/residual)."""
    act = ACTIVATIONS[cfg.activation]
    return act(x @ lp["gate_proj"]["kernel"]) * (x @ lp["up_proj"]["kernel"])
