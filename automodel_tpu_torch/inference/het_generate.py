"""KV-cache generation for the heterogeneous MoE engine (port of
`automodel_tpu/inference/het_generate.py`): Step-3.5, MiMo-V2-Flash and
MiniMax-M3.

The layers differ in attention geometry, MLP kind and (MiniMax-M3)
block-sparse attention, so the generic layer loop of `generate.py` cannot
drive them. Prefill is one pass over the prompt that writes each layer's
cache (K, V and, on a sparse layer, the indexer's shared key `idx_k`);
decode is a Python loop over steps (JAX: `lax.scan`) with the layer loop
inside. A sparse layer re-runs the block top-k for each decoded token over
the cached index keys (`positions` give the query's cache row), so decode
applies the training-time selection.

Attention is plain einsums over the dense (B, T, ...) caches, as in the JAX
function: no kernel runs here, K1-K3 included. What JAX does differently
from the training `forward` is kept: the scores are scaled by the q/k head
dim's `** -0.5` (never an override), the head gate is repeated over the v
head dim before it multiplies the flattened heads, and o_proj and the MLPs
ignore `linear_precision` (q/k/v honour it). Sampling goes through
`filter_logits`; the draws come from a `torch.Generator` and differ from
`jax.random`'s. `generate.generate` dispatches here for a `HetMoEConfig`.
"""

from __future__ import annotations

import dataclasses

import torch

from automodel_tpu_torch.inference.sampling import filter_logits
from automodel_tpu_torch.models.common.layers import cast_params, unstack_layers
from automodel_tpu_torch.models.moe_lm.het_moe import (
    HetMoEConfig,
    _clamped_swiglu,
    index_projections,
    layer_inv_freq,
    layer_rows,
    project_qkv,
    select_sparse_blocks,
    unembed,
)
from automodel_tpu_torch.moe.layer import moe_forward
from automodel_tpu_torch.ops.flash_attention import NEG_INF
from automodel_tpu_torch.ops.norms import rms_norm


def _cached_attention(q, keys, positions, attend_len: int, g, keep=None):
    """fp32 scores (B, Hkv, G, Sq, T) of q (B, Sq, Hq, D) against the whole
    cache, causal by `positions`, bounded by `attend_len`, windowed on a
    sliding layer and cut by a sparse layer's (B, Hq, Sq, T) `keep`."""
    B, Sq, Hq, D = q.shape
    T, Hkv = keys.shape[1], keys.shape[2]
    kv_idx = torch.arange(T, device=q.device)
    mask = (kv_idx[None, None, :] <= positions[:, :, None]) & (kv_idx < attend_len)
    if g.sliding_window:
        mask = mask & (positions[:, :, None] - kv_idx[None, None, :] < g.sliding_window)
    mask4 = mask[:, None].expand(B, Hq, Sq, T)
    if keep is not None:
        mask4 = mask4 & keep
    G = Hq // Hkv
    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, Sq, Hkv, G, D).float(),
                     keys.float())
    s = s * (g.head_dim ** -0.5)
    return torch.where(mask4.reshape(B, Hkv, G, Sq, T), s, NEG_INF)


def _softmax_out(s, values, sinks, g):
    B, Hkv, G, Sq, _ = s.shape
    if sinks is not None:
        sink = sinks.float().reshape(1, Hkv, G, 1, 1).expand(B, Hkv, G, Sq, 1)
        s = torch.cat([s, sink], dim=-1)
    p = torch.softmax(s, dim=-1)
    if sinks is not None:
        p = p[..., :-1]
    o = torch.einsum("bkgst,btkd->bskgd", p.to(values.dtype), values)
    return o.reshape(B, Sq, g.num_heads * g.vd)


@torch.no_grad()
def het_generate(
    params: dict,
    cfg: HetMoEConfig,
    input_ids: torch.Tensor,  # (B, S_prompt) integer, no padding
    rng: torch.Generator | None,
    gen,                      # inference.generate.GenerateConfig
    prompt_embeds=None,
) -> torch.Tensor:
    """Returns (B, S_prompt + max_new_tokens) token ids (greedy at
    temperature 0, else sampled with `rng`) on the prompt's device. With
    `eos_token_id`, a sequence that emitted it keeps emitting it."""
    if prompt_embeds is not None:
        raise NotImplementedError(
            "het_generate: prompt_embeds (the VLM path) is not ported")
    params = cast_params(params, cfg.dtype)
    B, S = input_ids.shape
    T = S + gen.max_new_tokens
    dev = input_ids.device
    eps, zc = cfg.rms_norm_eps, cfg.zero_centered_norm
    rows = layer_rows(cfg)
    freqs = [layer_inv_freq(cfg, li, dev) for li, *_ in rows]
    groups = {key: unstack_layers(params[key]) for key in
              ("g_attn", "s_attn", "indexer", "dense_mlp", "moe", "shared_mlp")
              if key in params}
    # dropless is exact for any token population (the capacity dispatcher's
    # bound depends on it)
    moe_cfg = dataclasses.replace(cfg.moe, dispatcher="dropless")

    def run_once(h, positions, caches, write_at: int, attend_len: int):
        """One pass over the layers for the Sq = h.shape[1] new tokens,
        their cache rows written in place at `write_at`."""
        Sq = h.shape[1]
        for (li, lt, gk, ai, is_moe, mi, is_sparse, spi), inv_freq, c in zip(
                rows, freqs, caches):
            g = cfg.geom(lt)
            lp = groups[gk][ai]
            x = rms_norm(h, params["input_norms"]["scale"][li], eps, zc)
            q, k, v = project_qkv(x, lp, g, cfg, positions, inv_freq)
            c[0][:, write_at:write_at + Sq] = k
            c[1][:, write_at:write_at + Sq] = v
            keep = None
            if is_sparse:
                idx_q, idx_k = index_projections(groups["indexer"][spi], cfg, x,
                                                 positions, inv_freq)
                c[2][:, write_at:write_at + Sq] = idx_k
                keep = select_sparse_blocks(
                    idx_q, c[2], positions,
                    block_size=cfg.sparse_block_size,
                    topk_blocks=cfg.sparse_topk_blocks,
                    init_blocks=cfg.sparse_init_blocks,
                    local_blocks=cfg.sparse_local_blocks,
                    score_type=cfg.sparse_score_type,
                ).repeat_interleave(g.num_heads // cfg.sparse_index_heads, dim=1)
            s = _cached_attention(q, c[0], positions, attend_len, g, keep=keep)
            attn = _softmax_out(s, c[1], lp["sinks"] if g.sinks else None, g)
            if cfg.head_gate:
                gate = torch.sigmoid(x @ lp["g_proj"]["kernel"])
                gr = gate[..., None].repeat_interleave(g.vd, dim=-1).reshape(
                    B, Sq, g.num_heads * g.vd)
                attn = attn * gr.to(attn.dtype)
            out = attn @ lp["o_proj"]["kernel"]
            if cfg.attention_bias and "bias" in lp["o_proj"]:
                out = out + lp["o_proj"]["bias"]
            h = h + out
            x = rms_norm(h, params["post_norms"]["scale"][li], eps, zc)
            if is_moe:
                moe_out, _, _ = moe_forward(groups["moe"][mi], moe_cfg, x)
                if cfg.share_expert_dim:
                    moe_out = moe_out + _clamped_swiglu(
                        x, groups["shared_mlp"][mi], cfg.swiglu_limit, cfg.dense_activation)
                h = h + moe_out
            else:
                h = h + _clamped_swiglu(x, groups["dense_mlp"][mi], cfg.swiglu_limit,
                                        cfg.dense_activation)
        h = rms_norm(h[:, -1:], params["final_norm"]["scale"], eps, zc)
        return unembed(params, cfg, h)[:, 0]

    caches = []
    for li, lt, *_rest in rows:
        g = cfg.geom(lt)
        c = [torch.zeros((B, T, g.num_kv_heads, g.head_dim), dtype=cfg.dtype, device=dev),
             torch.zeros((B, T, g.num_kv_heads, g.vd), dtype=cfg.dtype, device=dev)]
        if cfg.sparse_attn and cfg.sparse_attn[li]:
            c.append(torch.zeros((B, T, cfg.sparse_index_dim), dtype=cfg.dtype, device=dev))
        caches.append(c)

    def sample(logits):
        if gen.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        logits = filter_logits(logits / gen.temperature, gen.top_k, gen.top_p)
        return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=rng)[:, 0]

    # -- prefill ---------------------------------------------------------------
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    h = params["embed"]["embedding"][input_ids].to(cfg.dtype)
    token = sample(run_once(h, positions, caches, 0, S))
    eos = gen.eos_token_id
    done = token == eos if eos is not None else None
    out = [token]
    for step in range(gen.max_new_tokens - 1):
        pos = S + step  # the cache row of `token`
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
        h = params["embed"]["embedding"][token[:, None]].to(cfg.dtype)
        token = sample(run_once(h, positions, caches, pos, pos + 1))
        if eos is not None:
            token = torch.where(done, eos, token)
            done = done | (token == eos)
        out.append(token)
    return torch.cat([input_ids, torch.stack(out, 1).to(input_ids.dtype)], dim=1)
