"""Autoregressive generation with a dense KV cache, for the dense and MoE
decoders (port of `automodel_tpu/inference/generate.py`), plus the decoding
helpers the serving engine shares (`mla_absorbed_inputs`, `_dense_mlp`,
`_moe_mlp`, `_embed`).

`generate()` is batch-synchronous: one prefill pass over the prompts, then
one step per new token for the whole batch. The JAX package runs it as one
jit, a `lax.scan` over steps around a scan over layers, with static caches
of S + max_new_tokens slots; here a Python loop runs the steps and the
layers, over caches preallocated on the device for the same slots, and
each layer attends over the slots written so far.

- GQA layers cache K/V (L, B, T, Hkv, D) and attend with plain einsums,
  as the JAX function does (no Pallas kernel there, and none here), with
  per-layer sliding windows, the attention soft cap, sinks, and Gemma-3's
  local rope theta on windowed layers.
- MLA layers cache the rms-normed kv latent (B, T, r) and the rotated
  shared key-rope head (B, T, dr) and attend absorbed, in latent space.
- MoE layers route every token through the gate, dispatch forced dropless.
- `cfg.linear_precision` ("fp8" / "int8") quantizes the linears the JAX
  function quantizes: q/k/v, the MLP and MLA's projections and o_proj (a
  GQA layer's o_proj stays unquantized there, and here). A DSA model
  decodes with dense MLA over its latent cache, as in JAX.
- Greedy (temperature 0) or temperature sampling with top-k / top-p from an
  explicit `torch.Generator`; the draws differ from `jax.random`'s. With
  `eos_token_id`, a sequence that emitted it keeps emitting it.

A heterogeneous MoE config (`HetMoEConfig`: Step-3.5, MiMo-V2-Flash,
MiniMax-M3) goes to `het_generate.py`, as in JAX. A Gemma-4 MoE config, which
the JAX function drives neither way, and the VLM arguments (`prompt_embeds`,
`rope_angles`, `decode_rope_pos0`, `deepstack_embeds`, ROADMAP.md queue 1
item 18) raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from automodel_tpu_torch.inference.sampling import filter_logits
from automodel_tpu_torch.models.common.layers import cast_params, unstack_layers
from automodel_tpu_torch.models.llm.decoder import (
    TransformerConfig,
    _dense,
    layer_windows,
    make_freq_for,
    mlp_inner,
    project_qkv,
    unembed,
)
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.paged_attention import NEG_INF
from automodel_tpu_torch.ops.quant import matmul as _mm
from automodel_tpu_torch.ops.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 -> greedy
    top_k: int | None = None      # sample from the k highest-prob tokens
    top_p: float | None = None    # nucleus sampling (smallest mass >= p)
    eos_token_id: int | None = None


def mla_absorbed_inputs(x, lp, cfg, positions, inv_freq):
    """Shared MLA absorbed-decode projections.

    Returns (q_abs, q_rope, c_kv, k_rope, w_uv): q_abs (B,S,n,r) is q_nope
    folded through the key half of the kv up-projection (scores are taken in
    latent space), c_kv (B,S,r) the rms-normed kv latent and k_rope (B,S,dr)
    the rotated shared key-rope head (the two cached quantities), and w_uv
    (r,n,dv) the value half the caller applies after the softmax."""
    B, Sq, _ = x.shape
    n = cfg.num_heads
    dn, dr, dv = cfg.mla_qk_nope_head_dim, cfg.mla_qk_rope_head_dim, cfg.mla_v_head_dim
    r = cfg.mla_kv_lora_rank
    prec = cfg.linear_precision
    if cfg.mla_q_lora_rank:
        q_lat = rms_norm(_mm(x, lp["q_down_proj"]["kernel"], prec), lp["q_norm"]["scale"],
                         cfg.rms_norm_eps)
        q = _mm(q_lat, lp["q_up_proj"]["kernel"], prec)
    else:
        q = _mm(x, lp["q_proj"]["kernel"], prec)
    q = q.reshape(B, Sq, n, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, inv_freq)
    if cfg.mla_qpe_scaling_beta is not None:
        sc = 1.0 + cfg.mla_qpe_scaling_beta * torch.log1p(
            torch.floor(positions.float() / cfg.mla_qpe_scaling_orig_max)
        )
        q_rope = q_rope * sc[:, :, None, None].to(q_rope.dtype)

    kv = _mm(x, lp["kv_down_proj"]["kernel"], prec)
    c_kv, k_rope = kv[..., :r], kv[..., r:]
    c_kv = rms_norm(c_kv, lp["kv_norm"]["scale"], cfg.rms_norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, inv_freq)[:, :, 0, :]
    W = lp["kv_up_proj"]["kernel"].reshape(r, n, dn + dv)
    w_uk, w_uv = W[..., :dn], W[..., dn:]
    q_abs = torch.einsum("bsnd,rnd->bsnr", q_nope, w_uk)
    return q_abs, q_rope, c_kv, k_rope, w_uv


def _dense_mlp(h, lp, cfg):
    x = rms_norm(h, lp["post_attn_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    mlp_out = _mm(mlp_inner(x, lp, cfg), lp["down_proj"]["kernel"], cfg.linear_precision)
    if cfg.use_post_norms:
        mlp_out = rms_norm(mlp_out, lp["post_mlp_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    return h + mlp_out


def _moe_mlp(h, lp, cfg):
    from automodel_tpu_torch.moe.layer import moe_forward

    # force dropless dispatch: the capacity dispatcher's bound depends on the
    # token population, so a capacity-trained config would drop differently
    # at decode time; dropless is exact for any population
    moe_cfg = dataclasses.replace(cfg.moe, dispatcher="dropless")
    x = rms_norm(h, lp["post_attn_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    moe_out, _aux, _stats = moe_forward(lp["moe"], moe_cfg, x)
    return h + moe_out


def _embed(params, cfg, ids):
    h = params["embed"]["embedding"][ids].to(cfg.dtype)
    if cfg.embed_scale != 1.0:
        h = h * cfg.embed_scale
    return h


def _attend(q, keys, values, cfg, *, q_positions, window=None, sinks=None):
    """q (B,Sq,Hq,D) against the cache's first T slots, keys/values
    (B,T,Hkv,D): a query attends to slots at or before its position (and
    within `window` of it; None is global), plus the (Hq,) sink logits in
    the softmax's denominator. Scores and the softmax in fp32; the value
    product in the values' dtype."""
    B, Sq, Hq, D = q.shape
    T, Hkv = keys.shape[1], keys.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), keys.float())
    scale = cfg.attn_scale if cfg.attn_scale is not None else D ** -0.5
    s = s * scale
    if cfg.attn_soft_cap is not None:
        s = cfg.attn_soft_cap * torch.tanh(s / cfg.attn_soft_cap)
    kv_idx = torch.arange(T, device=q.device)
    mask = kv_idx[None, None, :] <= q_positions[:, :, None]  # (B, Sq, T)
    if window is not None:
        mask = mask & (q_positions[:, :, None] - kv_idx[None, None, :] < window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    if sinks is not None:
        sink = sinks.float().reshape(1, Hkv, G, 1, 1).expand(B, Hkv, G, Sq, 1)
        s = torch.cat([s, sink], dim=-1)
    p = torch.softmax(s, dim=-1)
    if sinks is not None:
        p = p[..., :-1]
    o = torch.einsum("bkgst,btkd->bskgd", p.to(values.dtype), values)
    return o.reshape(B, Sq, Hq, D)


def _gqa_attn_with_cache(h, lp, cfg, positions, inv_freq, cache_k, cache_v,
                         write_at: int, window=None):
    """GQA attention sub-block: writes the new K/V at slot `write_at` of the
    caches (in place) and attends over the slots up to the last one
    written; returns the post-residual h."""
    B, Sq, _ = h.shape
    x = rms_norm(h, lp["input_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    q, k, v = project_qkv(x, lp, cfg, positions, inv_freq)
    end = write_at + Sq
    cache_k[:, write_at:end] = k.to(cache_k.dtype)
    cache_v[:, write_at:end] = v.to(cache_v.dtype)
    attn = _attend(q, cache_k[:, :end], cache_v[:, :end], cfg, q_positions=positions,
                   window=window, sinks=lp.get("sinks") if cfg.attention_sinks else None)
    attn_out = _dense(attn.reshape(B, Sq, cfg.num_heads * cfg.resolved_head_dim),
                      lp["o_proj"])
    if cfg.use_post_norms:
        attn_out = rms_norm(attn_out, lp["post_attn_out_norm"]["scale"],
                            cfg.rms_norm_eps, cfg.zero_centered_norm)
    return h + attn_out


def _mla_attn_with_cache(h, lp, cfg, positions, inv_freq, cache_c, cache_kr,
                         write_at: int, window=None):
    """MLA attention sub-block over the absorbed latent cache: cache_c
    (B,T,r) the rms-normed kv latent, cache_kr (B,T,dr) the rotated shared
    key-rope head; scores (q_nope W_uk) c + q_rope k_rope, values c W_uv."""
    B, Sq, _ = h.shape
    n = cfg.num_heads
    dn, dr, dv = cfg.mla_qk_nope_head_dim, cfg.mla_qk_rope_head_dim, cfg.mla_v_head_dim
    x = rms_norm(h, lp["input_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    q_abs, q_rope, c_kv, k_rope, w_uv = mla_absorbed_inputs(x, lp, cfg, positions, inv_freq)
    end = write_at + Sq
    cache_c[:, write_at:end] = c_kv.to(cache_c.dtype)
    cache_kr[:, write_at:end] = k_rope.to(cache_kr.dtype)
    c, kr = cache_c[:, :end], cache_kr[:, :end]
    s = torch.einsum("bsnr,btr->bnst", q_abs.float(), c.float())
    s = s + torch.einsum("bsnd,btd->bnst", q_rope.float(), kr.float())
    scale = cfg.attn_scale if cfg.attn_scale is not None else (dn + dr) ** -0.5
    s = s * scale
    kv_idx = torch.arange(end, device=h.device)
    mask = kv_idx[None, None, :] <= positions[:, :, None]
    if window is not None:
        mask = mask & (positions[:, :, None] - kv_idx[None, None, :] < window)
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out_lat = torch.einsum("bnst,btr->bsnr", p.to(c.dtype), c)
    attn = torch.einsum("bsnr,rnd->bsnd", out_lat, w_uv).reshape(B, Sq, n * dv)
    return h + _mm(attn, lp["o_proj"]["kernel"], cfg.linear_precision)


def _cache_shapes(cfg, L: int, B: int, T: int, device) -> tuple:
    """One stack's two caches, zeros in the compute dtype: the MLA latent and
    key-rope head, or GQA's K and V."""
    if cfg.attention_type == "mla":
        shapes = ((L, B, T, cfg.mla_kv_lora_rank), (L, B, T, cfg.mla_qk_rope_head_dim))
    else:
        D = cfg.resolved_head_dim
        shapes = ((L, B, T, cfg.num_kv_heads, D),) * 2
    return tuple(torch.zeros(sh, dtype=cfg.dtype, device=device) for sh in shapes)


@torch.no_grad()
def generate(
    params: dict,
    cfg: TransformerConfig,
    input_ids: torch.Tensor,  # (B, S_prompt) integer, no padding
    rng: torch.Generator | None = None,
    gen: GenerateConfig = GenerateConfig(),
    prompt_embeds=None,
    rope_angles=None,
    decode_rope_pos0=None,
    deepstack_embeds=None,
) -> torch.Tensor:
    """Returns (B, S_prompt + max_new_tokens) token ids on the prompt's
    device. `rng` draws the sampled tokens (temperature > 0; a generator on
    the prompt's device); greedy decoding needs none."""
    from automodel_tpu_torch.models.moe_lm.decoder import MoETransformerConfig
    from automodel_tpu_torch.models.moe_lm.het_moe import HetMoEConfig

    for name, value in (("prompt_embeds", prompt_embeds), ("rope_angles", rope_angles),
                        ("decode_rope_pos0", decode_rope_pos0),
                        ("deepstack_embeds", deepstack_embeds)):
        if value is not None:
            raise NotImplementedError(
                f"generate: {name} (the VLM path) is not ported (ROADMAP.md queue 1 item 18)")
    if isinstance(cfg, HetMoEConfig):
        # per-layer geometries, MLP kinds and sparse index caches: its own loop
        from automodel_tpu_torch.inference.het_generate import het_generate

        return het_generate(params, cfg, input_ids, rng, gen)
    if type(cfg) not in (TransformerConfig, MoETransformerConfig):
        raise NotImplementedError(
            f"generate: {type(cfg).__name__} has no generation path (the JAX "
            "function drives the layer-scan decoders and the heterogeneous MoE "
            "engine only)")
    params = cast_params(params, cfg.dtype)
    B, S = input_ids.shape
    T = S + gen.max_new_tokens
    dev = input_ids.device
    is_moe = isinstance(cfg, MoETransformerConfig)
    freq_for = make_freq_for(cfg, dev)
    attn_fn = _mla_attn_with_cache if cfg.attention_type == "mla" else _gqa_attn_with_cache

    # (per-layer params, mlp) of each stack: the dense decoder has one, the
    # MoE decoder first_k_dense dense layers, then the MoE stack
    if is_moe:
        stacks = []
        if cfg.first_k_dense > 0:
            stacks.append((unstack_layers(params["dense_layers"]), _dense_mlp))
        stacks.append((unstack_layers(params["moe_layers"]), _moe_mlp))
    else:
        stacks = [(unstack_layers(params["layers"]), _dense_mlp)]
    layers = [(lp, mlp) for lps, mlp in stacks for lp in lps]
    windows = layer_windows(cfg, len(layers))
    caches = [_cache_shapes(cfg, len(lps), B, T, dev) for lps, _ in stacks]
    layer_caches = [(c0[i], c1[i]) for c0, c1 in caches for i in range(c0.shape[0])]

    def run_layers(h, positions, write_at: int):
        for (lp, mlp), window, (c0, c1) in zip(layers, windows, layer_caches):
            h = attn_fn(h, lp, cfg, positions, freq_for(window), c0, c1, write_at,
                        window=window)
            h = mlp(h, lp, cfg)
        h = rms_norm(h[:, -1:], params["final_norm"]["scale"], cfg.rms_norm_eps,
                     cfg.zero_centered_norm)
        return unembed(params, cfg, h)[:, 0]

    def sample(logits):
        if gen.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        logits = filter_logits(logits / gen.temperature, gen.top_k, gen.top_p)
        return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=rng)[:, 0]

    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    token = sample(run_layers(_embed(params, cfg, input_ids), positions, 0))
    eos = gen.eos_token_id
    done = token == eos if eos is not None else None
    out = [token]
    for step in range(gen.max_new_tokens - 1):
        pos = S + step  # the cache slot of `token`
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
        token = sample(run_layers(_embed(params, cfg, token[:, None]), positions, pos))
        if eos is not None:
            # after EOS, keep emitting EOS (static shapes, HF-style padding)
            token = torch.where(done, eos, token)
            done = done | (token == eos)
        out.append(token)
    return torch.cat([input_ids, torch.stack(out, 1).to(input_ids.dtype)], dim=1)
