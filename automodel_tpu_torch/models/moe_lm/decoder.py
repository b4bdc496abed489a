"""MoE decoder LM, the engine behind DeepSeek-style sparse models (port of
`MoETransformerConfig` and `init` from `automodel_tpu/models/moe_lm/decoder.py`).

The first `first_k_dense` layers are dense decoder layers (`dense_layers`),
the rest replace the gated MLP with the MoE block (`moe_layers`, the MoE
params under `moe`), each stack's weights stacked on dim 0 with the JAX
package's keys. The serving engine runs both stacks; the training forward,
the MTP head and the parameter specs are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from automodel_tpu_torch.models.common.layers import embed_init, init_fns
from automodel_tpu_torch.models.llm.decoder import (
    TransformerConfig,
    head_kernel,
    init_attention_layers,
    unembed,
)
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.layer import init_moe

__all__ = ["MoETransformerConfig", "forward", "head_kernel", "init", "unembed"]


@dataclasses.dataclass(frozen=True)
class MoETransformerConfig(TransformerConfig):
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    first_k_dense: int = 0  # deepseek first_k_dense_replace
    mtp_num_layers: int = 0      # depth-1 MTP head when > 0 (not ported)
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
    dtype for a large model: every leaf is drawn directly in it."""
    if cfg.mtp_num_layers > 0:
        raise NotImplementedError("the MTP head (mtp_num_layers > 0) is not ported")
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
    return params


def forward(params: dict, cfg: MoETransformerConfig, input_ids, **kwargs):
    """The MoE training forward is not ported yet (the MoE decoder serves
    through `serving/engine.py`)."""
    raise NotImplementedError("the MoE decoder's training forward is not ported")
