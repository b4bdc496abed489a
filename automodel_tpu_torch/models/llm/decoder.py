"""Generic dense decoder LM (port of `automodel_tpu/models/llm/decoder.py`).

The parameter layout is the JAX package's, key for key: per-layer weights
stacked on dim 0 under `params["layers"]`, linear kernels stored `(in, out)`
and applied as `x @ W`. So weights convert by copying (`convert.py`).

Ported here: the config (with the MLA and DSA fields), `layer_windows`,
`init` (GQA or MLA attention), the layer pieces the serving engine runs
(`_dense`, `head_kernel`/`unembed`, `project_qkv`, `mlp_inner`) and the
full-sequence training `forward` (`attention_block`, which hands MLA layers
to `models/llm/mla.py`, `mlp_block`, `_decoder_layer`). With
`linear_precision` "fp8" or "int8" the projections and the MLP go through
`ops/quant.matmul` (per-channel dynamic quantization), as in JAX; the LM
head and the embeddings stay unquantized. Meshes, pipeline and context
parallelism and the EAGLE-3 aux-hidden capture raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.common.layers import (
    cast_params,
    embed_init,
    init_fns,
    scan_layers_windowed,
)
from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.matmul import matmul_fp32
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.quant import matmul as _mm
from automodel_tpu_torch.ops.rope import (
    RopeScalingConfig,
    apply_rope,
    rope_frequencies,
)
from automodel_tpu_torch.peft.lora import layer_stack, merge_lora


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
    causal: bool = True  # False: bidirectional attention (encoders)
    normalized_lm_head: bool = False  # baichuan NormHead
    attention_sinks: bool = False  # gpt-oss per-head sink logits
    o_proj_bias: bool = False
    # attention flavor: "gqa" (default) or "mla" (DeepSeek latent attention)
    attention_type: str = "gqa"
    mla_q_lora_rank: Optional[int] = None
    mla_kv_lora_rank: int = 512
    mla_qk_nope_head_dim: int = 128
    mla_qk_rope_head_dim: int = 64
    mla_v_head_dim: int = 128
    # Mistral-4 llama4-style position-dependent q-rope scaling:
    # q_pe *= 1 + beta * log(1 + floor(pos / orig_max)); None = off
    mla_qpe_scaling_beta: Optional[float] = None
    mla_qpe_scaling_orig_max: int = 8192
    # DSA (DeepSeek sparse attention, V3.2/V4): lightning-indexer top-k
    # sparse MLA (`models/llm/mla.py`). None → dense MLA.
    dsa_index_topk: Optional[int] = None
    dsa_index_n_heads: int = 4
    dsa_index_head_dim: int = 64
    dsa_indexer_loss_coeff: float = 0.01
    # "deepseek": the lightning indexer on the hidden state, full-head rope.
    # "glm": GLM-5.x — queries from the MLA q-lora residual, LayerNorm'd
    # keys, the rope slice first and half-split, an n_heads**-0.5 gate factor
    dsa_indexer_style: str = "deepseek"
    # GLM IndexShare: per-layer "full" (runs its own indexer) | "shared"
    # (reuses the previous full layer's selection). None → all full.
    dsa_indexer_types: Optional[tuple] = None
    # "oracle": the dense (S, S) mask formulation (exact, the test
    # reference). "chunked": per query block, indexer scores + top-k, then
    # absorbed MLA over the gathered kv latents; memory O(S·block).
    # "auto": chunked once S > 4·dsa_query_block.
    dsa_impl: str = "auto"
    dsa_query_block: int = 256
    dtype: torch.dtype = torch.bfloat16
    # execution knobs: "full" recomputes each layer in backward, "none"
    # saves every activation; attention backend as in ops/attention.py
    remat_policy: str = "full"
    attn_impl: str = "auto"
    # the linears' product: None, or "fp8" / "int8" dynamic per-channel
    # quantization (`ops/quant.matmul`); the LM head and embeddings stay
    linear_precision: Optional[str] = None

    @property
    def resolved_head_dim(self) -> int:
        if self.attention_type == "mla":
            return self.mla_qk_nope_head_dim + self.mla_qk_rope_head_dim
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def rope_dim(self) -> int:
        if self.attention_type == "mla":
            return self.mla_qk_rope_head_dim
        d = round(self.resolved_head_dim * self.partial_rotary_factor)
        return d - (d % 2)

    def attn_params_per_layer(self) -> int:
        """Projection parameter count of one attention block."""
        H = self.hidden_size
        if self.attention_type == "mla":
            dn, dr, dv = (
                self.mla_qk_nope_head_dim,
                self.mla_qk_rope_head_dim,
                self.mla_v_head_dim,
            )
            n = self.num_heads
            q = (
                H * self.mla_q_lora_rank + self.mla_q_lora_rank * n * (dn + dr)
                if self.mla_q_lora_rank
                else H * n * (dn + dr)
            )
            kv = H * (self.mla_kv_lora_rank + dr) + self.mla_kv_lora_rank * n * (dn + dv)
            return q + kv + n * dv * H
        D = self.resolved_head_dim
        return H * (self.num_heads + 2 * self.num_kv_heads) * D + self.num_heads * D * H

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token (fwd+bwd ~ 6*N + attention term) for MFU."""
        D = self.resolved_head_dim
        n_params = (
            self.vocab_size * self.hidden_size * (1 if self.tie_word_embeddings else 2)
            + self.num_layers
            * (self.attn_params_per_layer() + 3 * self.hidden_size * self.intermediate_size)
        )
        attn_flops = 6 * self.num_layers * self.num_heads * D * seq_len  # 2*2*1.5 causal
        return 6.0 * n_params + attn_flops


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


def make_freq_for(cfg: TransformerConfig, device):
    """Per-layer-window rope frequencies on `device`: gemma3's sliding
    layers rotate with the local unscaled theta, every other layer with
    rope_theta and rope_scaling. The copies to the card do not wait for it
    (a blocking copy would be a host sync inside the train step)."""
    inv_freq = rope_frequencies(cfg.rope_dim, cfg.rope_theta, cfg.rope_scaling).to(
        device, non_blocking=True)
    if cfg.rope_local_theta is None:
        return lambda window: inv_freq
    local = rope_frequencies(cfg.rope_dim, cfg.rope_local_theta, None).to(
        device, non_blocking=True)
    return lambda window: local if window is not None else inv_freq


def init_attention_layers(cfg: TransformerConfig, gen: torch.Generator, L: int,
                          dtype: torch.dtype = torch.float32) -> dict:
    """Attention + norms portion of an L-layer stack (shared with the MoE
    decoder), on the generator's device."""
    if cfg.attention_type == "mla":
        from automodel_tpu_torch.models.llm.mla import init_mla_layers

        return init_mla_layers(cfg, gen, L, dtype)
    if cfg.attention_type != "gqa":
        raise NotImplementedError(f"attention_type {cfg.attention_type!r}")
    H, D = cfg.hidden_size, cfg.resolved_head_dim
    ones, zeros, dense = init_fns(gen, dtype)
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
    return layers


def init(cfg: TransformerConfig, gen: torch.Generator,
         dtype: torch.dtype = torch.float32) -> dict:
    """Random params with per-layer weights stacked on dim 0, on the
    generator's device (so a large model initialises on the card with no
    host copy). `dtype` defaults to fp32 masters; pass the compute dtype to
    skip the fp32 copy of a large model."""
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    _, _, dense = init_fns(gen, dtype)
    layers = init_attention_layers(cfg, gen, L, dtype)
    layers["gate_proj"] = {"kernel": dense(L, H, I)}
    layers["up_proj"] = {"kernel": dense(L, H, I)}
    layers["down_proj"] = {"kernel": dense(L, I, H)}
    params = {
        "embed": {"embedding": embed_init(gen, (cfg.vocab_size, H), dtype)},
        "layers": layers,
        "final_norm": {"scale": torch.ones(H, dtype=dtype, device=gen.device)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": dense(H, cfg.vocab_size)}
    return params


def _dense(x, p, precision=None):
    y = _mm(x, p["kernel"], precision)
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
    product has an fp32 result from operands in h's dtype, as JAX's
    `preferred_element_type=jnp.float32`: bf16 logits are never rounded."""
    logits = matmul_fp32(h, head_kernel(params, cfg).to(h.dtype))
    if cfg.logits_soft_cap is not None:
        logits = cfg.logits_soft_cap * torch.tanh(logits / cfg.logits_soft_cap)
    return logits


def project_qkv(x, lp, cfg: TransformerConfig, positions, inv_freq):
    """q/k/v projections incl. bias, qk-norm and rope. x (B, S, H) →
    q (B, S, Hq, D), k/v (B, S, Hkv, D)."""
    B, S, _ = x.shape
    D = cfg.resolved_head_dim
    eps, zc = cfg.rms_norm_eps, cfg.zero_centered_norm
    prec = cfg.linear_precision
    q = _dense(x, lp["q_proj"], prec)
    k = _dense(x, lp["k_proj"], prec)
    v = _dense(x, lp["v_proj"], prec)
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
    prec = cfg.linear_precision
    return (act(_mm(x, lp["gate_proj"]["kernel"], prec))
            * _mm(x, lp["up_proj"]["kernel"], prec))


def forward(
    params: dict,
    cfg: TransformerConfig,
    input_ids: torch.Tensor,  # (B, S) integer
    *,
    positions: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    mesh_ctx=None,
    return_hidden: bool = False,
    inputs_embeds: torch.Tensor | None = None,  # (B, S, H)
    return_aux_hidden: tuple | None = None,
    lora: dict | None = None,
    lora_cfg=None,
) -> torch.Tensor:
    """Run the decoder. Returns logits (B, S, V) fp32, or hidden (B, S, H)
    when `return_hidden` (pair with loss/linear_ce.py, which never builds the
    full logits). The fp32 masters are cast to `cfg.dtype` here, so autograd
    carries fp32 gradients back to them.

    With `lora` (the adapter tree of `peft/lora.py`, and its `lora_cfg`),
    `params` is the frozen base (QLoRA leaves too): each layer's adapters
    merge into its kernels inside the layer loop, under its remat, before
    the cast, and the head merges where `unembed` uses it."""
    if mesh_ctx is not None:
        raise NotImplementedError(
            "mesh_ctx: meshes, pipeline and context parallelism are not ported")
    if return_aux_hidden is not None:
        raise NotImplementedError("return_aux_hidden (EAGLE-3 capture) is not ported")
    if cfg.attention_type not in ("gqa", "mla"):
        raise NotImplementedError(f"attention_type {cfg.attention_type!r}")
    dtype = cfg.dtype
    B, S = input_ids.shape
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)

    if inputs_embeds is not None:
        h = inputs_embeds.to(dtype)
    else:
        # gather, then cast: the same values as casting the table first
        h = params["embed"]["embedding"][input_ids].to(dtype)
    if cfg.embed_scale != 1.0:
        h = h * torch.tensor(cfg.embed_scale, dtype=dtype)

    freq_for = make_freq_for(cfg, dev)
    stacked, merged = layer_stack(params, "layers", lora, lora_cfg)

    def layer(h, lp, window):
        return _decoder_layer(h, cast_params(merged(lp), dtype), cfg, positions,
                              segment_ids, freq_for(window), window)

    h = scan_layers_windowed(layer, h, stacked, layer_windows(cfg),
                             remat_policy=cfg.remat_policy)
    h = rms_norm(h, params["final_norm"]["scale"].to(dtype), cfg.rms_norm_eps,
                 cfg.zero_centered_norm)
    if return_hidden:
        return h
    if lora is not None:
        params = merge_lora(params, lora, lora_cfg, skip=("layers",))
    return unembed(params, cfg, h)


def attention_block(h, lp, cfg: TransformerConfig, positions, segment_ids,
                    inv_freq, sliding_window):
    """Pre-norm attention with residual (lp in the compute dtype); MLA
    layers go to `mla.mla_attention_block`."""
    if cfg.attention_type == "mla":
        from automodel_tpu_torch.models.llm.mla import mla_attention_block

        return mla_attention_block(h, lp, cfg, positions, segment_ids, inv_freq,
                                   sliding_window)
    B, S, _ = h.shape
    x = rms_norm(h, lp["input_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    q, k, v = project_qkv(x, lp, cfg, positions, inv_freq)
    sinks = lp.get("sinks") if cfg.attention_sinks else None
    attn = dot_product_attention(
        q, k, v,
        causal=cfg.causal,
        segment_ids=segment_ids,
        positions=positions,
        sliding_window=sliding_window,
        logits_soft_cap=cfg.attn_soft_cap,
        scale=cfg.attn_scale,
        sinks=sinks,
        impl=cfg.attn_impl,
    )
    attn_out = _dense(attn.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim),
                      lp["o_proj"], cfg.linear_precision)
    if cfg.use_post_norms:
        attn_out = rms_norm(attn_out, lp["post_attn_out_norm"]["scale"],
                            cfg.rms_norm_eps, cfg.zero_centered_norm)
    return h + attn_out


def mlp_block(h, lp, cfg: TransformerConfig):
    """Pre-norm gated MLP with residual."""
    x = rms_norm(h, lp["post_attn_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    mlp_out = _mm(mlp_inner(x, lp, cfg), lp["down_proj"]["kernel"], cfg.linear_precision)
    if cfg.use_post_norms:
        mlp_out = rms_norm(mlp_out, lp["post_mlp_norm"]["scale"],
                           cfg.rms_norm_eps, cfg.zero_centered_norm)
    return h + mlp_out


def _decoder_layer(h, lp, cfg: TransformerConfig, positions, segment_ids,
                   inv_freq, sliding_window):
    h = attention_block(h, lp, cfg, positions, segment_ids, inv_freq, sliding_window)
    return mlp_block(h, lp, cfg)
