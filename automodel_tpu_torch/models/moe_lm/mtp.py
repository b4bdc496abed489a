"""Multi-Token Prediction (MTP) head: DeepSeek-V3's auxiliary depth-1
future-token predictor (port of `init_mtp`, `mtp_hidden` and `mtp_loss`
from `automodel_tpu/models/moe_lm/mtp.py`).

Structure (depth 1):

    h_mtp = Block( W_proj · concat( RMSNorm_h(h_main), RMSNorm_e(embed(t+1)) ) )

sharing the main embedding and unembedding; its logits predict t+2. The
loss is the same chunked fused linear CE, scaled by `mtp_loss_coeff` and
joined to the main objective by the recipe.

The block is the main config's attention block (an MLA block for an MLA
config, so on the card it runs K1-K3 as the main layers do) plus a dense
MLP of width `intermediate_size`. Deviation from DeepSeek-V3, kept from the
JAX package: a dense MLP, not a MoE block. MTP weights are training-only
state and are not mapped by the HF adapter. The block's weights are cast
to the compute dtype, as every layer of the main stack is, and it runs
under the config's remat policy. On a mesh (`mesh_ctx`) the head runs on
the local shards as the main stacks do (`mtp_param_specs` lays them out).
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.loss.linear_ce import fused_linear_cross_entropy
from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX
from automodel_tpu_torch.models.common.layers import (
    init_fns,
    maybe_remat,
    unstack_layers,
)
from automodel_tpu_torch.models.llm.decoder import (
    MLP_SPECS,
    LayerRunner,
    attention_block,
    attention_layer_specs,
    init_attention_layers,
    mesh_spmd,
    mlp_block,
)
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import rope_frequencies


def init_mtp(cfg, gen: torch.Generator, dtype: torch.dtype = torch.float32) -> dict:
    """One MTP block on the generator's device; layer params keep the
    stacked (L=1, ...) convention."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    ones, _, dense = init_fns(gen, dtype)
    block = init_attention_layers(cfg, gen, 1, dtype)
    block["gate_proj"] = {"kernel": dense(1, H, I)}
    block["up_proj"] = {"kernel": dense(1, H, I)}
    block["down_proj"] = {"kernel": dense(1, I, H)}
    return {
        "hnorm": {"scale": ones(H)},
        "enorm": {"scale": ones(H)},
        "eh_proj": {"kernel": dense(2 * H, H)},
        "block": block,
        "final_norm": {"scale": ones(H)},
    }


def mtp_param_specs(cfg) -> dict:
    """Logical axes of the MTP head's leaves (JAX `mtp_param_specs`, `:58`)."""
    return {
        "hnorm": {"scale": ("norm",)},
        "enorm": {"scale": ("norm",)},
        "eh_proj": {"kernel": (None, "embed")},
        "block": {**attention_layer_specs(cfg),
                  **{k: dict(v) for k, v in MLP_SPECS.items()}},
        "final_norm": {"scale": ("norm",)},
    }


def mtp_hidden(
    params: dict,             # full model params (embed + mtp subtree)
    cfg,
    h_main: torch.Tensor,     # (B, S, H) final hidden states of the main model
    input_ids: torch.Tensor,  # (B, S)
    positions: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    mesh_ctx=None,
) -> torch.Tensor:
    """Hidden states (B, S, H) whose logits predict token t+2 at position t."""
    mtp = params["mtp"]
    dtype = cfg.dtype
    eps = cfg.rms_norm_eps
    B, S = input_ids.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=input_ids.device).expand(B, S)
    spmd = mesh_spmd(mesh_ctx)
    # embedding of the NEXT token (t+1), shifted left; the last slot repeats
    next_ids = torch.cat([input_ids[:, 1:], input_ids[:, -1:]], dim=1)
    top = {k: mtp[k] for k in ("hnorm", "enorm", "eh_proj", "final_norm")}
    if spmd is not None:
        emb = spmd.embed(params["embed"]["embedding"], next_ids, dtype)
        top = spmd.gather_tree(top)
    else:
        emb = params["embed"]["embedding"][next_ids].to(dtype)
    x = torch.cat([rms_norm(h_main, top["hnorm"]["scale"], eps),
                   rms_norm(emb, top["enorm"]["scale"], eps)], dim=-1)
    h = x @ top["eh_proj"]["kernel"].to(dtype)

    inv_freq = rope_frequencies(cfg.rope_dim, cfg.rope_theta,
                                cfg.rope_scaling).to(input_ids.device, non_blocking=True)
    run = LayerRunner(spmd, mtp["block"], cfg, dtype)
    (lp,) = unstack_layers(run.stacked)  # the L=1 dim

    def block(h, lp):
        lp = run.params(lp)
        h = attention_block(h, lp, run.cfg, positions, segment_ids, inv_freq,
                            cfg.sliding_window, run.tp)
        return mlp_block(h, lp, run.cfg, run.tp)

    h = maybe_remat(block, cfg.remat_policy)(h, lp)
    return rms_norm(h, top["final_norm"]["scale"], eps)


def mtp_labels(labels: torch.Tensor,
               segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Labels shifted one more step (t+2 at slot t), the last slot
    IGNORE_INDEX; on packed sequences a slot whose next token lies in
    another document is ignored too."""
    out = torch.cat([labels[:, 1:], torch.full_like(labels[:, -1:], IGNORE_INDEX)],
                    dim=1)
    if segment_ids is not None:
        same_doc = torch.cat([segment_ids[:, 1:] == segment_ids[:, :-1],
                              torch.zeros_like(segment_ids[:, -1:], dtype=torch.bool)],
                             dim=1)
        out = torch.where(same_doc, out, IGNORE_INDEX)
    return out


def mtp_loss(
    hidden_mtp: torch.Tensor,  # (B, S, H)
    lm_kernel: torch.Tensor,   # (H, V)
    labels: torch.Tensor,      # (B, S): next-token labels (t+1 at slot t)
    *,
    chunk_size: int = 1024,
    segment_ids: torch.Tensor | None = None,  # (B, S): packed documents
    logits_soft_cap: float | None = None,
    **vocab_parallel,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(CE sum, label count) against `mtp_labels`: MTP never supervises
    across document boundaries (the invariant of packed datasets).
    `vocab_parallel` (`vocab_group`, `vocab_start`) as the main CE's."""
    return fused_linear_cross_entropy(
        hidden_mtp, lm_kernel, mtp_labels(labels, segment_ids),
        chunk_size=chunk_size, logits_soft_cap=logits_soft_cap, **vocab_parallel,
    )
