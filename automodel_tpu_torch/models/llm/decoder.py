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
head and the embeddings stay unquantized.

On a mesh (`mesh_ctx`, params as DTensors laid out by `param_specs`), the
forward runs on each rank's shards (`parallel/spmd.py`): each layer's
weights are all-gathered over `dp_shard` inside the layer loop (FSDP), and
where `tp` splits the heads and the MLP, each rank runs its heads and its
I/tp slice, the `o_proj` and `down_proj` partial sums all-reduced over
`tp` (JAX's manual mode, `decoder.py:877-898`); the embedding lookup is
vocab-parallel. DSA's sparse attention under `tp` raises
NotImplementedError, and so do context and pipeline parallelism
(ROADMAP.md item 12b) and the EAGLE-3 aux-hidden capture.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
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
from automodel_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    copy_to,
    group_size,
    reduce_from,
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


def attention_layer_specs(cfg: TransformerConfig) -> dict:
    """Logical axes of the attention stack's leaves (JAX
    `attention_layer_specs`); MLA's from `mla.mla_layer_specs`."""
    if cfg.attention_type == "mla":
        from automodel_tpu_torch.models.llm.mla import mla_layer_specs

        return mla_layer_specs(cfg)
    layers = {
        "input_norm": {"scale": ("layers", "norm")},
        "q_proj": {"kernel": ("layers", "embed", "heads")},
        "k_proj": {"kernel": ("layers", "embed", "kv_heads")},
        "v_proj": {"kernel": ("layers", "embed", "kv_heads")},
        "o_proj": {"kernel": ("layers", "heads", "embed")},
        "post_attn_norm": {"scale": ("layers", "norm")},
    }
    if cfg.attention_bias:
        layers["q_proj"]["bias"] = ("layers", "heads")
        layers["k_proj"]["bias"] = ("layers", "kv_heads")
        layers["v_proj"]["bias"] = ("layers", "kv_heads")
    if cfg.o_proj_bias:
        layers["o_proj"]["bias"] = ("layers", "norm")
    if cfg.qk_norm or cfg.qk_norm_flat:
        layers["q_norm"] = {"scale": ("layers", "norm")}
        layers["k_norm"] = {"scale": ("layers", "norm")}
    if cfg.use_post_norms:
        layers["post_attn_out_norm"] = {"scale": ("layers", "norm")}
        layers["post_mlp_norm"] = {"scale": ("layers", "norm")}
    if cfg.attention_sinks:
        layers["sinks"] = ("layers", "heads")
    return layers


MLP_SPECS = {
    "gate_proj": {"kernel": ("layers", "embed", "mlp")},
    "up_proj": {"kernel": ("layers", "embed", "mlp")},
    "down_proj": {"kernel": ("layers", "mlp", "embed")},
}


def param_specs(cfg: TransformerConfig) -> dict:
    """Logical axis names per param (JAX `param_specs`, `decoder.py:341`),
    read by `parallel/sharding.logical_to_shardings`."""
    layers = attention_layer_specs(cfg)
    layers.update({k: dict(v) for k, v in MLP_SPECS.items()})
    specs = {
        "embed": {"embedding": ("vocab", "embed")},
        "layers": layers,
        "final_norm": {"scale": ("norm",)},
    }
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = {"kernel": ("embed", "vocab")}
    return specs


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


def project_qkv(x, lp, cfg: TransformerConfig, positions, inv_freq, flat_norm=rms_norm):
    """q/k/v projections incl. bias, qk-norm and rope. x (B, S, H) →
    q (B, S, Hq, D), k/v (B, S, Hkv, D). `flat_norm` normalizes the
    flattened projections under `qk_norm_flat`."""
    B, S, _ = x.shape
    D = cfg.resolved_head_dim
    eps, zc = cfg.rms_norm_eps, cfg.zero_centered_norm
    prec = cfg.linear_precision
    q = _dense(x, lp["q_proj"], prec)
    k = _dense(x, lp["k_proj"], prec)
    v = _dense(x, lp["v_proj"], prec)
    if cfg.qk_norm_flat:
        q = flat_norm(q, lp["q_norm"]["scale"], eps, zc)
        k = flat_norm(k, lp["k_norm"]["scale"], eps, zc)
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


def _tp_flat_norm(tp):
    """RMSNorm over projections whose heads are split on `tp`: the mean
    square sums over the ranks, and each rank scales by its slice of the
    whole (tp-replicated) scale."""
    def norm(x, scale, eps, zero_centered):
        n = x.shape[-1]
        xf = x.float()
        var = all_reduce_sum(torch.sum(xf * xf, dim=-1, keepdim=True), tp) / (
            n * group_size(tp))
        w = scale.float().narrow(-1, dist.get_rank(tp) * n, n)
        if zero_centered:
            w = w + 1.0
        return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)

    return norm


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
    if return_aux_hidden is not None:
        raise NotImplementedError("return_aux_hidden (EAGLE-3 capture) is not ported")
    if cfg.attention_type not in ("gqa", "mla"):
        raise NotImplementedError(f"attention_type {cfg.attention_type!r}")
    dtype = cfg.dtype
    B, S = input_ids.shape
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    spmd = mesh_spmd(mesh_ctx)

    if inputs_embeds is not None:
        h = inputs_embeds.to(dtype)
    elif spmd is not None:
        h = spmd.embed(params["embed"]["embedding"], input_ids, dtype)
    else:
        # gather, then cast: the same values as casting the table first
        h = params["embed"]["embedding"][input_ids].to(dtype)
    if cfg.embed_scale != 1.0:
        h = h * torch.tensor(cfg.embed_scale, dtype=dtype)

    freq_for = make_freq_for(cfg, dev)
    stacked, merged = layer_stack(params, "layers", lora, lora_cfg)
    run = LayerRunner(spmd, stacked, cfg, dtype, merged, lora is not None)

    def layer(h, lp, window):
        return _decoder_layer(h, run.params(lp), run.cfg, positions,
                              segment_ids, freq_for(window), window, run.tp)

    h = scan_layers_windowed(layer, h, run.stacked, layer_windows(cfg),
                             remat_policy=cfg.remat_policy)
    final = params["final_norm"]["scale"]
    if spmd is not None:
        final = spmd.gather_tree(final)
    h = rms_norm(h, final.to(dtype), cfg.rms_norm_eps, cfg.zero_centered_norm)
    if return_hidden:
        return h
    if spmd is not None:
        raise NotImplementedError(
            "the logits of a mesh forward: train with return_hidden and the "
            "vocab-parallel cross-entropy")
    if lora is not None:
        params = merge_lora(params, lora, lora_cfg, skip=("layers",))
    return unembed(params, cfg, h)


def mesh_spmd(mesh_ctx):
    """The SPMD helpers of a mesh forward, or None without a mesh."""
    if mesh_ctx is None:
        return None
    from automodel_tpu_torch.parallel.spmd import Spmd

    return Spmd(mesh_ctx)


class LayerRunner:
    """One decoder stack's layer loop, on one device or on a mesh: the
    stacked tree the loop unstacks, each layer's params in the compute dtype
    (unsharded over `dp_shard` one layer at a time on a mesh, the LoRA
    adapters merged), the config each rank runs and the `tp` group of its
    attention and MLP (None when the layout leaves them whole)."""

    def __init__(self, spmd, stacked, cfg, dtype, merged=lambda lp: lp,
                 has_lora: bool = False, mlp: bool = True):
        self.cfg, self.dtype, self.merged, self.tp = cfg, dtype, merged, None
        self.stacked, self._unshard, self._lora_tp = stacked, None, None
        if spmd is None:
            return
        self._tp_group = spmd.tp
        base = stacked["base"] if has_lora else stacked
        attn_key = "q_proj" if "q_proj" in base else "q_up_proj"
        attn_tp = spmd.tp_of(base[attn_key]["kernel"], -1) is not None
        mlp_tp = mlp and "gate_proj" in base and spmd.tp_of(base["gate_proj"]["kernel"], -1) is not None
        if attn_tp and getattr(cfg, "dsa_index_topk", None) is not None:
            raise NotImplementedError("DSA sparse attention under tp > 1 is not ported")
        if attn_tp != mlp_tp and mlp and "gate_proj" in base:
            raise NotImplementedError(
                "tp splitting the attention heads but not the MLP, or the "
                "reverse (the divisibility fallback replicated one of them)")
        if attn_tp:
            from automodel_tpu_torch.parallel.spmd import local_cfg

            self.cfg = local_cfg(cfg, spmd.tp_size, mlp_tp)
            self.tp = spmd.tp
        self.stacked, self._unshard = spmd.layer_stack(stacked)
        # merging LoRA needs the adapters in their own dtype, as one device does
        self._gather_dtype = None if has_lora else dtype
        self._lora_tp = spmd.lora_tp_flags(stacked) if has_lora else None

    def params(self, lp):
        if self._unshard is not None:
            lp = self._unshard(lp, self._gather_dtype)
        if self._lora_tp is not None:
            lp = dict(lp, lora=self._spmd_copy(lp["lora"]))
        return cast_params(self.merged(lp), self.dtype)

    def _spmd_copy(self, lora):
        return {k: {n: copy_to(x, self._tp_group) if self._lora_tp[k][n] else x
                    for n, x in ab.items()} for k, ab in lora.items()}


def attention_block(h, lp, cfg: TransformerConfig, positions, segment_ids,
                    inv_freq, sliding_window, tp=None):
    """Pre-norm attention with residual (lp in the compute dtype); MLA
    layers go to `mla.mla_attention_block`. With a `tp` group, lp holds
    this rank's heads (cfg their count): the normed input enters through
    `copy_to` and the `o_proj` partial sum is all-reduced over `tp` before
    its bias."""
    if cfg.attention_type == "mla":
        from automodel_tpu_torch.models.llm.mla import mla_attention_block

        return mla_attention_block(h, lp, cfg, positions, segment_ids, inv_freq,
                                   sliding_window, tp)
    B, S, _ = h.shape
    x = rms_norm(h, lp["input_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    flat_norm = rms_norm
    if tp is not None and (cfg.qk_norm or cfg.qk_norm_flat):
        # each rank scales its own heads: the scale's gradient sums over tp
        lp = {**lp, **{n: {"scale": copy_to(lp[n]["scale"], tp)}
                       for n in ("q_norm", "k_norm")}}
        if cfg.qk_norm_flat:
            flat_norm = _tp_flat_norm(tp)
    q, k, v = project_qkv(copy_to(x, tp), lp, cfg, positions, inv_freq, flat_norm)
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
    attn_out = reduce_from(
        _mm(attn.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim),
            lp["o_proj"]["kernel"], cfg.linear_precision), tp)
    if "bias" in lp["o_proj"]:
        attn_out = attn_out + lp["o_proj"]["bias"]
    if cfg.use_post_norms:
        attn_out = rms_norm(attn_out, lp["post_attn_out_norm"]["scale"],
                            cfg.rms_norm_eps, cfg.zero_centered_norm)
    return h + attn_out


def mlp_block(h, lp, cfg: TransformerConfig, tp=None):
    """Pre-norm gated MLP with residual; with a `tp` group, lp holds this
    rank's I/tp slice and the `down_proj` partial sum is all-reduced."""
    x = rms_norm(h, lp["post_attn_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    mlp_out = reduce_from(_mm(mlp_inner(copy_to(x, tp), lp, cfg), lp["down_proj"]["kernel"],
                              cfg.linear_precision), tp)
    if cfg.use_post_norms:
        mlp_out = rms_norm(mlp_out, lp["post_mlp_norm"]["scale"],
                           cfg.rms_norm_eps, cfg.zero_centered_norm)
    return h + mlp_out


def _decoder_layer(h, lp, cfg: TransformerConfig, positions, segment_ids,
                   inv_freq, sliding_window, tp=None):
    h = attention_block(h, lp, cfg, positions, segment_ids, inv_freq, sliding_window, tp)
    return mlp_block(h, lp, cfg, tp)
