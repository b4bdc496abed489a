"""MoE decoder LM, the engine behind DeepSeek-style sparse models (port of
`MoETransformerConfig`, `init`, `forward` and `apply_gate_bias_update` from
`automodel_tpu/models/moe_lm/decoder.py`).

The first `first_k_dense` layers are dense decoder layers (`dense_layers`),
the rest replace the gated MLP with the MoE block (`moe_layers`, the MoE
params under `moe`), each stack's weights stacked on dim 0 with the JAX
package's keys. The serving engine runs both stacks; the training `forward`
runs them with the aux (load-balance) loss and each MoE layer's tokens per
expert riding the layer loop's carry.

- DSA (`dsa_index_topk` on an MLA config): every layer, dense prefix and
  MoE stack alike, attends through `mla.mla_sparse_attention_block` (the
  oracle or the chunked path), and its indexer-KL aux joins the same loss
  carry. GLM IndexShare (`dsa_indexer_types`): a "shared" layer reuses the
  running selection of the last "full" layer, which rides the carry.
- Routing replay: `return_routing` adds stats["routing"] (Lm, B*S, K), the
  expert indices each MoE layer chose; `routing_override` pins them on
  another forward (`moe_forward`'s `forced_indices`) while the weights
  recompute from the live router.

On a mesh (`mesh_ctx`, params as DTensors laid out by `param_specs`) both
stacks run as the dense decoder's do (`decoder.LayerRunner`: one layer
unsharded over `dp_shard` at a time, tp heads), the MoE blocks on this
rank's tokens with expert parallelism over `ep` (`moe/layer.py`).

The pipeline branch, the EAGLE-3 aux-hidden capture and VLM inputs
(embeds, MRoPE angles, deepstack) are not ported. With
`mtp_num_layers > 0`, `init` adds the MTP head's params under `mtp`
(`mtp.py`), which the training recipe's loss runs.
"""

from __future__ import annotations

import dataclasses

import torch

from automodel_tpu_torch.models.common.layers import (
    embed_init,
    init_fns,
    scan_layers_windowed,
)
from automodel_tpu_torch.models.llm.decoder import (
    MLP_SPECS,
    LayerRunner,
    TransformerConfig,
    attention_block,
    attention_layer_specs,
    head_kernel,
    init_attention_layers,
    layer_windows,
    make_freq_for,
    mesh_spmd,
    mlp_block,
    unembed,
)
from automodel_tpu_torch.models.moe_lm.mtp import init_mtp, mtp_param_specs
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.gate import update_gate_bias
from automodel_tpu_torch.moe.layer import init_moe, moe_forward, moe_param_specs
from automodel_tpu_torch.utils.tree import tree_map
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.peft.lora import layer_stack, merge_lora

__all__ = ["MoETransformerConfig", "apply_gate_bias_update", "forward",
           "head_kernel", "init", "param_specs", "unembed"]


@dataclasses.dataclass(frozen=True)
class MoETransformerConfig(TransformerConfig):
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    first_k_dense: int = 0  # deepseek first_k_dense_replace
    mtp_num_layers: int = 0      # depth-1 MTP head when > 0
    mtp_loss_coeff: float = 0.1  # weight of the MTP CE term

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense

    def flops_per_token(self, seq_len: int) -> float:
        """Activated-params FLOPs/token for MFU (routed experts count k/E)."""
        D = self.resolved_head_dim
        H = self.hidden_size
        attn_params = self.attn_params_per_layer()
        dense_mlp = 3 * H * self.intermediate_size
        moe_mlp = (
            3 * H * self.moe.moe_intermediate_size * self.moe.experts_per_token
            + 3 * H * self.moe.shared_intermediate * (1 if self.moe.n_shared_experts else 0)
            + H * self.moe.n_routed_experts  # router
        )
        n_active = (
            self.vocab_size * H * (1 if self.tie_word_embeddings else 2)
            + self.num_layers * attn_params
            + self.first_k_dense * dense_mlp
            + self.num_moe_layers * moe_mlp
        )
        attn_flops = 6 * self.num_layers * self.num_heads * D * seq_len
        return 6.0 * n_active + attn_flops


def init(cfg: MoETransformerConfig, gen: torch.Generator,
         dtype: torch.dtype = torch.float32) -> dict:
    """Random params on the generator's device: the `dense_layers` stack
    (when first_k_dense > 0), then the `moe_layers` stack. Pass the compute
    dtype for a large model: every leaf is drawn directly in it. With
    `mtp_num_layers > 0` the MTP head's params follow, under `mtp`, drawn
    last, so the other leaves do not depend on it."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    ones, _, dense = init_fns(gen, dtype)
    params: dict = {
        "embed": {"embedding": embed_init(gen, (cfg.vocab_size, H), dtype)},
        "final_norm": {"scale": ones(H)},
    }
    if cfg.first_k_dense > 0:
        L = cfg.first_k_dense
        dense_layers = init_attention_layers(cfg, gen, L, dtype)
        dense_layers["gate_proj"] = {"kernel": dense(L, H, I)}
        dense_layers["up_proj"] = {"kernel": dense(L, H, I)}
        dense_layers["down_proj"] = {"kernel": dense(L, I, H)}
        params["dense_layers"] = dense_layers
    Lm = cfg.num_moe_layers
    moe_layers = init_attention_layers(cfg, gen, Lm, dtype)
    moe_layers["moe"] = init_moe(cfg.moe, H, gen, dtype, num_layers=Lm)
    params["moe_layers"] = moe_layers
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": dense(H, cfg.vocab_size)}
    if cfg.mtp_num_layers > 0:
        params["mtp"] = init_mtp(cfg, gen, dtype)
    return params


def param_specs(cfg: MoETransformerConfig) -> dict:
    """Logical axes of every leaf (JAX `param_specs`, `decoder.py:134`)."""
    specs: dict = {
        "embed": {"embedding": ("vocab", "embed")},
        "final_norm": {"scale": ("norm",)},
    }
    if cfg.first_k_dense > 0:
        d = attention_layer_specs(cfg)
        d.update({k: dict(v) for k, v in MLP_SPECS.items()})
        specs["dense_layers"] = d
    m = attention_layer_specs(cfg)
    m["moe"] = tree_map(lambda s: ("layers",) + s, moe_param_specs(cfg.moe))
    specs["moe_layers"] = m
    if cfg.mtp_num_layers > 0:
        specs["mtp"] = mtp_param_specs(cfg)
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = {"kernel": ("embed", "vocab")}
    return specs


def forward(
    params: dict,
    cfg: MoETransformerConfig,
    input_ids: torch.Tensor,  # (B, S) integer
    *,
    positions: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    mesh_ctx=None,
    return_hidden: bool = False,
    token_mask: torch.Tensor | None = None,  # (B, S) bool; False = pad tokens
    return_stats: bool = False,
    return_routing: bool = False,
    routing_override=None,
    return_aux_hidden: tuple | None = None,
    inputs_embeds=None,
    rope_angles=None,
    deepstack_embeds=None,
    lora: dict | None = None,
    lora_cfg=None,
) -> tuple:
    """Returns (logits-or-hidden, aux_loss[, stats]), as the JAX `forward`
    on one device: logits (B, S, V) fp32, or hidden (B, S, H) with
    `return_hidden`; aux_loss the sum of the MoE layers' load-balance
    losses (fp32 scalar); stats["tokens_per_expert"] (num_moe_layers, E),
    which `apply_gate_bias_update` takes after the optimizer step. Masked
    tokens (`token_mask` False) route nowhere and drop out of the aux loss
    and the counts. The fp32 masters are cast to `cfg.dtype` inside each
    layer (under its remat), so autograd carries fp32 gradients back. With
    `lora` and `lora_cfg`, `params` is the frozen base and each layer's
    adapters merge inside the layer loop, as in the dense `forward`.

    With `return_stats` and `return_routing`, stats["routing"] is each MoE
    layer's (B*S, K) expert indices, stacked (Lm, B*S, K); handed back as
    `routing_override`, it pins the selection (routing replay)."""
    unported = {
        "return_aux_hidden (the EAGLE-3 aux-hidden capture)": return_aux_hidden,
        "inputs_embeds (VLM merged embeddings)": inputs_embeds,
        "rope_angles (MRoPE)": rope_angles,
        "deepstack_embeds (deepstack injection)": deepstack_embeds,
    }
    for name, value in unported.items():
        if value is not None:
            raise NotImplementedError(f"MoE forward: {name} is not ported")
    dtype = cfg.dtype
    B, S = input_ids.shape
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    spmd = mesh_spmd(mesh_ctx)

    if spmd is not None:
        h = spmd.embed(params["embed"]["embedding"], input_ids, dtype)
    else:
        h = params["embed"]["embedding"][input_ids].to(dtype)
    if cfg.embed_scale != 1.0:
        h = h * torch.tensor(cfg.embed_scale, dtype=dtype)
    freq_for = make_freq_for(cfg, dev)
    windows = layer_windows(cfg)

    # DSA: the indexer-KL aux rides the loss carry with the balance loss;
    # under IndexShare the running selection rides it too (only then: plain
    # DSA would drag a dead S²-scale buffer through every layer)
    use_dsa = cfg.attention_type == "mla" and cfg.dsa_index_topk is not None
    idx_types = cfg.dsa_indexer_types
    index_share = use_dsa and idx_types is not None
    if index_share:
        if len(idx_types) != cfg.num_layers:
            raise ValueError(f"{len(idx_types)} indexer_types for {cfg.num_layers} layers")
        if idx_types[0] != "full":
            raise ValueError("IndexShare: layer 0 must run its indexer")
    flags = [t == "full" for t in idx_types] if index_share else None

    def attn(h, lp, window, sel, gidx, run):
        if use_dsa:
            from automodel_tpu_torch.models.llm.mla import mla_sparse_attention_block

            h, idx_aux, sel_new = mla_sparse_attention_block(
                h, lp, cfg, positions, segment_ids, freq_for(window),
                token_mask=token_mask,
                prev_sel=sel if index_share else None,
                indexer_flag=flags[gidx] if index_share else None)
            return h, idx_aux, (sel_new if index_share else sel)
        return (attention_block(h, lp, run.cfg, positions, segment_ids,
                                freq_for(window), window, run.tp), 0.0, sel)

    # the carry: (hidden, aux loss, tokens per expert and routing of the MoE
    # layers run, the IndexShare selection)
    has_lora = lora is not None
    if cfg.first_k_dense > 0:
        dense_stack, dense_merged = layer_stack(params, "dense_layers", lora, lora_cfg)
        dense_run = LayerRunner(spmd, dense_stack, cfg, dtype, dense_merged, has_lora)
    moe_stack, moe_merged = layer_stack(params, "moe_layers", lora, lora_cfg)
    moe_run = LayerRunner(spmd, moe_stack, cfg, dtype, moe_merged, has_lora, mlp=False)
    moe_tp = None
    if spmd is not None:
        experts = (moe_stack["base"] if has_lora else moe_stack)["moe"]["experts"]
        moe_tp = spmd.tp_of(experts["up_proj"]["kernel"], -1)
    K = cfg.first_k_dense

    def dense_layer(carry, lp, static):
        h, aux, tpe, routing, sel = carry
        window, gidx = static
        lp = dense_run.params(lp)
        h, idx_aux, sel = attn(h, lp, window, sel, gidx, dense_run)
        return mlp_block(h, lp, dense_run.cfg, dense_run.tp), aux + idx_aux, tpe, routing, sel

    def moe_layer(carry, lp, static):
        h, aux, tpe, routing, sel = carry
        window, gidx = static
        lp = moe_run.params(lp)
        h, idx_aux, sel = attn(h, lp, window, sel, gidx, moe_run)
        x = rms_norm(h, lp["post_attn_norm"]["scale"], cfg.rms_norm_eps,
                     cfg.zero_centered_norm)
        forced = routing_override[gidx - K] if routing_override is not None else None
        moe_out, layer_aux, stats = moe_forward(lp["moe"], cfg.moe, x, token_mask,
                                                forced_indices=forced, spmd=spmd,
                                                tp=moe_tp)
        return (h + moe_out, aux + idx_aux + layer_aux,
                tpe + (stats["tokens_per_expert"],), routing + (stats["indices"],), sel)

    sel0 = None
    if index_share:
        from automodel_tpu_torch.models.llm.mla import dsa_sel_init

        sel0 = dsa_sel_init(cfg, B, S, dev)
    carry = (h, torch.zeros((), dtype=torch.float32, device=dev), (), (), sel0)
    statics = tuple(zip(windows, range(cfg.num_layers)))
    if K > 0:
        carry = scan_layers_windowed(dense_layer, carry, dense_run.stacked,
                                     statics[:K], remat_policy=cfg.remat_policy)
    carry = scan_layers_windowed(moe_layer, carry, moe_run.stacked,
                                 statics[K:], remat_policy=cfg.remat_policy)
    h, aux_loss, tpe, routing, _ = carry

    final = params["final_norm"]["scale"]
    if spmd is not None:
        if not return_hidden:
            raise NotImplementedError(
                "the logits of a mesh forward: train with return_hidden and the "
                "vocab-parallel cross-entropy")
        final = spmd.gather_tree(final)
    h = rms_norm(h, final.to(dtype), cfg.rms_norm_eps, cfg.zero_centered_norm)
    if not return_hidden and lora is not None:
        params = merge_lora(params, lora, lora_cfg, skip=("dense_layers", "moe_layers"))
    out = h if return_hidden else unembed(params, cfg, h)
    if return_stats:
        # (num_moe_layers, E): a dense prefix alone (every layer dense, as a
        # depth-cut DeepSeek-V3 is) has no MoE layer to count
        tpe = (torch.stack(tpe) if tpe else
               torch.zeros((0, cfg.moe.n_routed_experts), device=dev))
        stats_out = {"tokens_per_expert": tpe}
        if return_routing:
            stats_out["routing"] = (
                torch.stack(routing) if routing else
                torch.zeros((0, B * S, cfg.moe.experts_per_token),
                            dtype=torch.int64, device=dev))
        return out, aux_loss, stats_out
    return out, aux_loss


@torch.no_grad()
def apply_gate_bias_update(params: dict, cfg: MoETransformerConfig,
                           tokens_per_expert: torch.Tensor) -> dict:
    """DeepSeek aux-free balancing across all MoE layers at once, after the
    optimizer step: tokens_per_expert (num_moe_layers, E) from
    forward(..., return_stats=True). Updates the stacked `e_score_bias` in
    place (the master leaf the optimizer holds) and returns `params`."""
    gate = params["moe_layers"]["moe"]["gate"]
    new = update_gate_bias(gate, cfg.moe, tokens_per_expert)
    if new is not gate:
        gate["e_score_bias"].copy_(new["e_score_bias"])
    return params
