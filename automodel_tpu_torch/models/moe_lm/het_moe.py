"""Heterogeneous-attention MoE decoder, the Step-3.5 / MiMo-V2-Flash /
MiniMax-M3 engine (port of `automodel_tpu/models/moe_lm/het_moe.py`).

The layers interleave two attention geometries by `layer_types`: global
layers and sliding-window layers, each with its own head counts and (for
MiMo) its own q/k and v head dims and attention-sink logits. Each layer's
MLP is dense or a routed MoE (plus, for Step-3.5 and MiniMax-M3, a shared
expert of `share_expert_dim`). Per layer: rope theta, partial rotary
(`int(head_dim * frac) // 2 * 2` channels) or none (NoPE layers).

The parameter layout is the JAX package's, key for key: the attention
weights stacked per geometry (`g_attn`, `s_attn`, each at least one row),
the MLPs per kind (`dense_mlp`, `moe`, `shared_mlp`), MiniMax-M3's lightning
indexers under `indexer`, one row per sparse layer; `layer_rows` maps each
layer to its rows. `forward` unbinds each stack once and runs a Python
loop over the layers, each under the port's `maybe_remat`, the fp32
masters cast to `cfg.dtype` inside the layer.

Every dense layer attends through `ops/attention.dot_product_attention`
(K1-K3 on the card, with windows and sinks). MiniMax-M3's block-sparse
layers select key blocks with the indexer (`select_sparse_blocks`, ties
broken by the lowest block index, as `jax.lax.top_k`) and attend under the
explicit keep mask in plain torch (`_sparse_masked_attention`), as the JAX
package does in XLA: no kernel runs there.

Meshes (`mesh_ctx`), VLM merged embeddings and LoRA raise
NotImplementedError; the parameter specs are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.common.layers import (
    cast_params,
    embed_init,
    init_fns,
    maybe_remat,
    unstack_layers,
)
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.experts import gated_combine
from automodel_tpu_torch.moe.gate import update_gate_bias
from automodel_tpu_torch.moe.layer import init_moe, moe_forward
from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.dsa import stable_topk
from automodel_tpu_torch.ops.flash_attention import NEG_INF
from automodel_tpu_torch.ops.matmul import matmul_fp32
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.quant import matmul as _mm
from automodel_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = ["AttnGeom", "HetMoEConfig", "apply_gate_bias_update", "forward",
           "head_kernel", "init", "layer_rows", "select_sparse_blocks", "unembed"]


@dataclasses.dataclass(frozen=True)
class AttnGeom:
    """One attention geometry (the global or the sliding group)."""

    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 64
    v_head_dim: Optional[int] = None   # None -> head_dim (MiMo's differ)
    sliding_window: Optional[int] = None
    sinks: bool = False                # learnable per-head sink logit (MiMo)

    @property
    def vd(self) -> int:
        return self.v_head_dim or self.head_dim


@dataclasses.dataclass(frozen=True)
class HetMoEConfig:
    """The JAX `HetMoEConfig`, field for field; `dtype` is a torch dtype."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632      # dense-layer MLP width
    num_layers: int = 4
    layer_types: tuple = ()            # "global" | "sliding" per layer
    global_attn: AttnGeom = dataclasses.field(default_factory=AttnGeom)
    sliding_attn: AttnGeom = dataclasses.field(default_factory=AttnGeom)
    qk_norm: bool = True               # per-head-dim RMSNorm on q/k
    head_gate: bool = False            # Step-3.5's g_proj sigmoid head gate
    attention_bias: bool = False
    # per-layer rope: theta / rotary fraction / enabled (NoPE layers)
    rope_thetas: tuple = ()
    partial_rotary: tuple = ()
    use_rope: tuple = ()
    mlp_kinds: tuple = ()              # "dense" | "moe" per layer
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    share_expert_dim: int = 0          # per-MoE-layer shared expert width
    swiglu_limit: Optional[float] = None  # clamp of the dense/shared MLPs
    # "swiglu_clamped": silu(clip(g)) * clip(u) (Step-3.5);
    # "swigluoai": g * sigmoid(1.702 g) * (u + 1), gate max-clamped (MiniMax-M3)
    dense_activation: str = "swiglu_clamped"
    zero_centered_norm: bool = False   # gemma (1 + w) norms (MiniMax-M3)
    # MiniMax-M3 block-sparse attention: the lightning indexer picks, per
    # query, the top-k key blocks
    sparse_attn: tuple = ()            # per-layer bool; () -> none
    sparse_index_heads: int = 1
    sparse_index_dim: int = 64
    sparse_block_size: int = 32
    sparse_topk_blocks: int = 8
    sparse_init_blocks: int = 1
    sparse_local_blocks: int = 1
    sparse_score_type: str = "max"     # "max" | "lse" block reduction
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    logits_soft_cap: Optional[float] = None
    causal: bool = True
    linear_precision: Optional[str] = None  # None | "fp8" | "int8"
    dtype: Any = torch.bfloat16
    remat_policy: str = "full"
    attn_impl: str = "auto"
    scan_unroll: int = 1
    mtp_num_layers: int = 0

    def __post_init__(self):
        assert len(self.layer_types) == self.num_layers
        assert len(self.mlp_kinds) == self.num_layers
        assert not self.sparse_attn or len(self.sparse_attn) == self.num_layers

    @property
    def num_sparse_layers(self) -> int:
        return sum(1 for s in self.sparse_attn if s)

    def geom(self, lt: str) -> AttnGeom:
        return self.sliding_attn if lt == "sliding" else self.global_attn

    @property
    def num_moe_layers(self) -> int:
        return sum(1 for k in self.mlp_kinds if k == "moe")

    def flops_per_token(self, seq_len: int) -> float:
        H = self.hidden_size
        total = self.vocab_size * H * (1 if self.tie_word_embeddings else 2)
        for i, lt in enumerate(self.layer_types):
            g = self.geom(lt)
            total += H * g.head_dim * (g.num_heads + 2 * g.num_kv_heads)
            total += g.num_heads * g.vd * H
            if self.mlp_kinds[i] == "moe":
                total += 3 * H * self.moe.moe_intermediate_size * self.moe.experts_per_token
                total += 3 * H * self.share_expert_dim
                if self.moe.n_shared_experts:
                    total += 3 * H * self.moe.shared_intermediate
                total += H * self.moe.n_routed_experts  # router
            else:
                total += 3 * H * self.intermediate_size
        attn_flops = sum(
            6.0 * self.geom(lt).num_heads * self.geom(lt).head_dim * seq_len
            for lt in self.layer_types
        )
        return 6.0 * total + attn_flops


def _init_attn_group(cfg: HetMoEConfig, g: AttnGeom, gen, n: int, dtype) -> dict:
    H = cfg.hidden_size
    ones, zeros, dense = init_fns(gen, dtype)
    p = {
        "q_proj": {"kernel": dense(n, H, g.num_heads * g.head_dim)},
        "k_proj": {"kernel": dense(n, H, g.num_kv_heads * g.head_dim)},
        "v_proj": {"kernel": dense(n, H, g.num_kv_heads * g.vd)},
        "o_proj": {"kernel": dense(n, g.num_heads * g.vd, H)},
    }
    if cfg.attention_bias:
        for name, width in (
            ("q_proj", g.num_heads * g.head_dim),
            ("k_proj", g.num_kv_heads * g.head_dim),
            ("v_proj", g.num_kv_heads * g.vd),
            ("o_proj", H),
        ):
            p[name]["bias"] = zeros(n, width)
    if cfg.qk_norm:
        norm1 = zeros if cfg.zero_centered_norm else ones
        p["q_norm"] = {"scale": norm1(n, g.head_dim)}
        p["k_norm"] = {"scale": norm1(n, g.head_dim)}
    if cfg.head_gate:
        p["g_proj"] = {"kernel": dense(n, H, g.num_heads)}
    if g.sinks:
        p["sinks"] = zeros(n, g.num_heads)
    return p


def _mlp_stack(cfg: HetMoEConfig, gen, n: int, width: int, dtype) -> dict:
    H = cfg.hidden_size
    _, _, dense = init_fns(gen, dtype)
    return {
        "gate_proj": {"kernel": dense(n, H, width)},
        "up_proj": {"kernel": dense(n, H, width)},
        "down_proj": {"kernel": dense(n, width, H)},
    }


def init(cfg: HetMoEConfig, gen: torch.Generator,
         dtype: torch.dtype = torch.float32) -> dict:
    """Random params on the generator's device, drawn in `dtype`, in the
    JAX package's layout: a geometry with no layer keeps one unused row."""
    H, L = cfg.hidden_size, cfg.num_layers
    n_g = sum(1 for t in cfg.layer_types if t == "global")
    n_s = L - n_g
    n_d = sum(1 for k in cfg.mlp_kinds if k == "dense")
    n_m = L - n_d
    ones, zeros, dense = init_fns(gen, dtype)
    norm1 = zeros if cfg.zero_centered_norm else ones
    params: dict = {
        "embed": {"embedding": embed_init(gen, (cfg.vocab_size, H), dtype)},
        "final_norm": {"scale": norm1(H)},
        "input_norms": {"scale": norm1(L, H)},
        "post_norms": {"scale": norm1(L, H)},
        "g_attn": _init_attn_group(cfg, cfg.global_attn, gen, max(n_g, 1), dtype),
        "s_attn": _init_attn_group(cfg, cfg.sliding_attn, gen, max(n_s, 1), dtype),
    }
    n_sp = cfg.num_sparse_layers
    if n_sp:
        Di, Hi = cfg.sparse_index_dim, cfg.sparse_index_heads
        params["indexer"] = {
            "index_q_proj": {"kernel": dense(n_sp, H, Hi * Di)},
            "index_k_proj": {"kernel": dense(n_sp, H, Di)},
            "index_q_norm": {"scale": norm1(n_sp, Di)},
            "index_k_norm": {"scale": norm1(n_sp, Di)},
        }
    if n_d:
        params["dense_mlp"] = _mlp_stack(cfg, gen, n_d, cfg.intermediate_size, dtype)
    if n_m:
        params["moe"] = init_moe(cfg.moe, H, gen, dtype, num_layers=n_m)
        if cfg.share_expert_dim:
            params["shared_mlp"] = _mlp_stack(cfg, gen, n_m, cfg.share_expert_dim, dtype)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": dense(H, cfg.vocab_size)}
    return params


def _clamped_swiglu(x, lp: dict, limit, kind: str = "swiglu_clamped",
                    precision: str | None = None):
    """One dense or shared MLP (`lp`: one layer's gate/up/down kernels)."""
    g = _mm(x, lp["gate_proj"]["kernel"], precision)
    u = _mm(x, lp["up_proj"]["kernel"], precision)
    if kind == "swigluoai":
        inner = gated_combine(g, u, "swigluoai", limit if limit is not None else 7.0)
    else:
        if limit is not None:
            g = torch.clamp(g, -limit, limit)
            u = torch.clamp(u, -limit, limit)
        inner = F.silu(g) * u
    return _mm(inner, lp["down_proj"]["kernel"], precision)


def layer_rows(cfg: HetMoEConfig):
    """Static per-layer bookkeeping shared by `forward`, the HF adapter and
    the KV-cache decode: (li, layer_type, attn_group_key, attn_index,
    is_moe, mlp_index, is_sparse, sparse_index) per layer."""
    gi = si = di = mi = spi = 0
    rows = []
    for li, lt in enumerate(cfg.layer_types):
        a_key = "s_attn" if lt == "sliding" else "g_attn"
        ai = si if lt == "sliding" else gi
        is_moe = cfg.mlp_kinds[li] == "moe"
        is_sparse = bool(cfg.sparse_attn and cfg.sparse_attn[li])
        rows.append((li, lt, a_key, ai, is_moe, mi if is_moe else di, is_sparse, spi))
        si, gi = si + (lt == "sliding"), gi + (lt != "sliding")
        mi, di = mi + is_moe, di + (not is_moe)
        spi += is_sparse
    return rows


def layer_inv_freq(cfg: HetMoEConfig, li: int, device=None):
    """Layer li's rope inverse frequencies, or None on a NoPE layer (or a
    layer whose rotary width rounds to 0): its own theta over
    `int(head_dim * frac) // 2 * 2` channels of its geometry's head dim."""
    g = cfg.geom(cfg.layer_types[li])
    theta = cfg.rope_thetas[li] if cfg.rope_thetas else 10000.0
    frac = cfg.partial_rotary[li] if cfg.partial_rotary else 1.0
    roped = cfg.use_rope[li] if cfg.use_rope else True
    rot = int(g.head_dim * frac) // 2 * 2
    if not (roped and rot):
        return None
    return rope_frequencies(rot, theta).to(device, non_blocking=True)


def index_projections(ip: dict, cfg: HetMoEConfig, x, positions, inv_freq):
    """One lightning indexer's (idx_q (B, S, Hi, Di), idx_k (B, S, Di)):
    per-head normed projections plus the layer's partial rope, shared by
    the training forward and the decode cache. `ip` is the layer's row of
    `indexer`; the indexer runs in full precision (no linear_precision)."""
    B, S, _ = x.shape
    Hi, Di = cfg.sparse_index_heads, cfg.sparse_index_dim
    eps, zc = cfg.rms_norm_eps, cfg.zero_centered_norm
    idx_q = (x @ ip["index_q_proj"]["kernel"]).reshape(B, S, Hi, Di)
    idx_k = (x @ ip["index_k_proj"]["kernel"]).reshape(B, S, 1, Di)
    idx_q = rms_norm(idx_q, ip["index_q_norm"]["scale"], eps, zc)
    idx_k = rms_norm(idx_k, ip["index_k_norm"]["scale"], eps, zc)
    if inv_freq is not None:
        idx_q = apply_rope(idx_q, positions, inv_freq)
        idx_k = apply_rope(idx_k, positions, inv_freq)
    return idx_q, idx_k[:, :, 0, :]


def select_sparse_blocks(
    idx_q: torch.Tensor,       # (B, S, Hi, Di) normed, roped index queries
    idx_k: torch.Tensor,       # (B, T, Di) shared index key
    positions: torch.Tensor,   # (B, S) key-ROW index of each query
    *,
    block_size: int,
    topk_blocks: int,
    init_blocks: int,
    local_blocks: int,
    score_type: str = "max",
) -> torch.Tensor:
    """Per-query top-k key-block selection: key-level causal scores ->
    block scores (max or logsumexp) -> the first `init_blocks` blocks and
    the `local_blocks` ending at the query's own forced -> top-k of the
    rest. Returns the (B, Hi, S, T) bool keep mask at key granularity, still
    causal per key. Hard selection: no gradient reaches the indexer. Ties
    among block scores keep the lowest block index (`stable_topk`, as
    `jax.lax.top_k`)."""
    B, S, Hi, Di = idx_q.shape
    T = idx_k.shape[1]
    dev = idx_q.device
    s = torch.einsum("bqhd,btd->bhqt", idx_q.float(), idx_k.float()) * (Di ** -0.5)
    kpos = torch.arange(T, device=dev)
    causal_key = kpos[None, None, None, :] <= positions[:, None, :, None]
    s = torch.where(causal_key, s, NEG_INF)
    nb = -(-T // block_size)
    pad = nb * block_size - T
    if pad:
        s = F.pad(s, (0, pad), value=NEG_INF)
    s = s.reshape(B, Hi, S, nb, block_size)
    if score_type == "lse":
        block_score = torch.logsumexp(s, dim=-1)
    else:
        block_score = torch.amax(s, dim=-1)               # (B, Hi, S, nb)
    blk = torch.arange(nb, device=dev)
    cur_block = positions // block_size                     # (B, S)
    causal_block = blk[None, None, None, :] <= cur_block[:, None, :, None]
    # the trailing `local_blocks` blocks ending at the current one, and the
    # first `init_blocks`
    forced = (
        (blk[None, None, None, :] > (cur_block[:, None, :, None] - local_blocks))
        | (blk[None, None, None, :] < init_blocks)
    ) & causal_block
    sel = torch.where(causal_block, block_score, NEG_INF)
    sel = torch.where(forced, torch.inf, sel)
    k_eff = min(topk_blocks, nb)
    _, top_idx = stable_topk(sel, k_eff)                     # (B, Hi, S, k_eff)
    keep_blocks = torch.zeros(sel.shape, dtype=torch.bool, device=dev)
    keep_blocks.scatter_(-1, top_idx, True)
    keep_blocks = keep_blocks & causal_block
    keep = keep_blocks.repeat_interleave(block_size, dim=-1)[..., :T]
    return keep & causal_key


def sparse_keep_mask(ip: dict, cfg: HetMoEConfig, x, positions, inv_freq,
                     num_heads: int, segment_ids=None) -> torch.Tensor:
    """One sparse layer's (B, Hq, S, S) bool keep mask: its indexer over the
    normed hidden `x`, block selection over key ROWS (packed documents are
    cut by the segment AND), repeated over the `num_heads // Hi` heads of
    each index head. `positions` drive only the indexer's rope phase."""
    idx_q, idx_k = index_projections(ip, cfg, x, positions, inv_freq)
    B, S = x.shape[:2]
    rows = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    keep = select_sparse_blocks(
        idx_q, idx_k, rows,
        block_size=cfg.sparse_block_size,
        topk_blocks=cfg.sparse_topk_blocks,
        init_blocks=cfg.sparse_init_blocks,
        local_blocks=cfg.sparse_local_blocks,
        score_type=cfg.sparse_score_type,
    )
    if segment_ids is not None:
        keep = keep & (segment_ids[:, None, :, None] == segment_ids[:, None, None, :])
    return keep.repeat_interleave(num_heads // cfg.sparse_index_heads, dim=1)


def _sparse_masked_attention(q, k, v, keep, scale):
    """GQA attention under an explicit (B, Hq, S, T) bool keep mask (already
    causal), in plain torch, as the JAX package runs it in XLA: the
    block-sparse pattern has no kernel in either package."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    s = torch.where(keep.reshape(B, Hkv, G, S, T), s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", p, v)
    return o.reshape(B, S, Hq, v.shape[-1])


def head_kernel(params: dict, cfg: HetMoEConfig) -> torch.Tensor:
    """(H, V) output-projection kernel, tied or untied."""
    if cfg.tie_word_embeddings:
        return params["embed"]["embedding"].T
    return params["lm_head"]["kernel"]


def unembed(params: dict, cfg: HetMoEConfig, h: torch.Tensor) -> torch.Tensor:
    """hidden -> fp32 logits (the product's result in fp32, as JAX's
    `preferred_element_type`), soft-capped when the config says so."""
    logits = matmul_fp32(h, head_kernel(params, cfg).to(h.dtype))
    if cfg.logits_soft_cap is not None:
        logits = cfg.logits_soft_cap * torch.tanh(logits / cfg.logits_soft_cap)
    return logits


def _rows_of(params: dict, key: str) -> list:
    """The per-row views of one stack (empty when the model has none)."""
    return unstack_layers(params[key]) if key in params else []


def project_qkv(x, lp: dict, g: AttnGeom, cfg: HetMoEConfig, positions, inv_freq):
    """q (B, S, Hq, D), k (B, S, Hkv, D), v (B, S, Hkv, Dv) of one layer
    from its normed input: the projections (under `linear_precision`),
    their biases, qk-norm and the layer's rope. Shared by the training
    forward and the decode cache. `lp` is the layer's row of its
    geometry's stack."""
    B, S, _ = x.shape
    prec, eps, zc = cfg.linear_precision, cfg.rms_norm_eps, cfg.zero_centered_norm
    q = _mm(x, lp["q_proj"]["kernel"], prec).reshape(B, S, g.num_heads, g.head_dim)
    k = _mm(x, lp["k_proj"]["kernel"], prec).reshape(B, S, g.num_kv_heads, g.head_dim)
    v = _mm(x, lp["v_proj"]["kernel"], prec).reshape(B, S, g.num_kv_heads, g.vd)
    if cfg.attention_bias:
        q = q + lp["q_proj"]["bias"].reshape(1, 1, g.num_heads, g.head_dim)
        k = k + lp["k_proj"]["bias"].reshape(1, 1, g.num_kv_heads, g.head_dim)
        v = v + lp["v_proj"]["bias"].reshape(1, 1, g.num_kv_heads, g.vd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"]["scale"], eps, zc)
        k = rms_norm(k, lp["k_norm"]["scale"], eps, zc)
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    return q, k, v


def attention(x, lp: dict, g: AttnGeom, cfg: HetMoEConfig, positions, inv_freq,
              segment_ids=None, keep=None):
    """One layer's attention from its normed input `x` (B, S, H) to the
    o_proj output: `project_qkv`, dense attention (K1-K3 on the card) or
    the sparse layer's masked attention under `keep`, the head gate."""
    B, S, _ = x.shape
    q, k, v = project_qkv(x, lp, g, cfg, positions, inv_freq)
    if keep is not None:
        attn = _sparse_masked_attention(q, k, v, keep, g.head_dim ** -0.5)
    else:
        attn = dot_product_attention(
            q, k, v, causal=cfg.causal, segment_ids=segment_ids,
            positions=positions, sliding_window=g.sliding_window,
            sinks=lp["sinks"] if g.sinks else None, impl=cfg.attn_impl,
        )
    if cfg.head_gate:
        gate = torch.sigmoid(x @ lp["g_proj"]["kernel"])
        attn = attn * gate[..., :, None].to(attn.dtype)
    out = _mm(attn.reshape(B, S, g.num_heads * g.vd), lp["o_proj"]["kernel"],
              cfg.linear_precision)
    if cfg.attention_bias and "bias" in lp["o_proj"]:
        out = out + lp["o_proj"]["bias"]
    return out


def forward(
    params: dict,
    cfg: HetMoEConfig,
    input_ids: torch.Tensor,  # (B, S) integer
    *,
    positions: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    mesh_ctx=None,
    return_hidden: bool = False,
    token_mask: torch.Tensor | None = None,  # (B, S) bool; False = pad tokens
    return_stats: bool = False,
    inputs_embeds=None,
    lora: dict | None = None,
    lora_cfg=None,
) -> tuple:
    """Returns (logits-or-hidden, aux_loss[, stats]), the moe_lm protocol,
    as the JAX `forward` on one device: logits (B, S, V) fp32 or hidden
    (B, S, H); aux_loss the MoE layers' summed balance loss (fp32 scalar);
    stats["tokens_per_expert"] (num_moe_layers, E)."""
    unported = {
        "mesh_ctx (expert and context parallelism)": mesh_ctx,
        "inputs_embeds (VLM merged embeddings)": inputs_embeds,
        "lora (PEFT on the heterogeneous engine)": lora,
    }
    for name, value in unported.items():
        if value is not None:
            raise NotImplementedError(f"het_moe forward: {name} is not ported")
    dtype = cfg.dtype
    B, S = input_ids.shape
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    h = params["embed"]["embedding"][input_ids].to(dtype)
    eps, zc, prec = cfg.rms_norm_eps, cfg.zero_centered_norm, cfg.linear_precision

    groups = {key: _rows_of(params, key) for key in
              ("g_attn", "s_attn", "indexer", "dense_mlp", "moe", "shared_mlp")}
    in_norms = torch.unbind(params["input_norms"]["scale"], 0)
    post_norms = torch.unbind(params["post_norms"]["scale"], 0)

    def layer(h, lp, row, inv_freq):
        li, lt, _, _, is_moe, _, is_sparse, _ = row
        lp = cast_params(lp, dtype)
        g = cfg.geom(lt)
        x = rms_norm(h, lp["input_norm"], eps, zc)
        keep = None
        if is_sparse:
            keep = sparse_keep_mask(lp["indexer"], cfg, x, positions, inv_freq,
                                    g.num_heads, segment_ids=segment_ids)
        h = h + attention(x, lp["attn"], g, cfg, positions, inv_freq,
                          segment_ids=segment_ids, keep=keep)
        x = rms_norm(h, lp["post_norm"], eps, zc)
        if is_moe:
            moe_out, aux, st = moe_forward(lp["moe"], cfg.moe, x, token_mask)
            if cfg.share_expert_dim:
                moe_out = moe_out + _clamped_swiglu(
                    x, lp["shared_mlp"], cfg.swiglu_limit, cfg.dense_activation, prec)
            return h + moe_out, aux, st["tokens_per_expert"]
        h = h + _clamped_swiglu(x, lp["dense_mlp"], cfg.swiglu_limit,
                                cfg.dense_activation, prec)
        return h, None, None

    layer_fn = maybe_remat(layer, cfg.remat_policy)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    stats_rows = []
    for row in layer_rows(cfg):
        li, _, gk, ai, is_moe, mi, is_sparse, spi = row
        lp = {"input_norm": in_norms[li], "post_norm": post_norms[li],
              "attn": groups[gk][ai]}
        if is_sparse:
            lp["indexer"] = groups["indexer"][spi]
        if is_moe:
            lp["moe"] = groups["moe"][mi]
            if cfg.share_expert_dim:
                lp["shared_mlp"] = groups["shared_mlp"][mi]
        else:
            lp["dense_mlp"] = groups["dense_mlp"][mi]
        h, aux, tpe = layer_fn(h, lp, row, layer_inv_freq(cfg, li, dev))
        if is_moe:
            aux_total = aux_total + aux
            stats_rows.append(tpe)

    h = rms_norm(h, params["final_norm"]["scale"].to(dtype), eps, zc)
    out = h if return_hidden else unembed(params, cfg, h)
    if return_stats:
        tpe = (torch.stack(stats_rows) if stats_rows else
               torch.zeros((0, cfg.moe.n_routed_experts), device=dev))
        return out, aux_total, {"tokens_per_expert": tpe}
    return out, aux_total


@torch.no_grad()
def apply_gate_bias_update(params: dict, cfg: HetMoEConfig,
                           tokens_per_expert: torch.Tensor) -> dict:
    """DeepSeek aux-free balancing over the stacked MoE gates, after the
    optimizer step (`tokens_per_expert` (num_moe_layers, E)): updates the
    `e_score_bias` master leaf in place and returns `params`."""
    if "moe" not in params:
        return params
    gate = params["moe"]["gate"]
    new = update_gate_bias(gate, cfg.moe, tokens_per_expert)
    if new is not gate:
        gate["e_score_bias"].copy_(new["e_score_bias"])
    return params
