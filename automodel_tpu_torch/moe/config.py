"""MoE configuration (port of `automodel_tpu/moe/config.py`, field for field).

Routed/shared expert counts, top-k, grouped routing, score function,
aux-loss coefficient, the DeepSeek-style gate-bias update speed, the
expert activations and the dispatcher ("dropless", or "capacity" with its
`capacity_factor`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed_experts: int = 8
    n_shared_experts: int = 0
    experts_per_token: int = 2  # top-k
    n_groups: int = 1           # deepseek group-limited routing
    topk_groups: int = 1
    score_func: str = "softmax"  # "softmax" | "sigmoid"
    norm_topk_prob: bool = True
    route_scale: float = 1.0
    aux_loss_coeff: float = 0.0
    gate_bias_update_speed: float = 0.0  # deepseek aux-free balancing
    # silu | geglu | quick_geglu | swigluoai are GATED (3-matrix) MLPs;
    # relu2 is NON-gated (up/down only, inner = relu(u)²)
    expert_activation: str = "silu"
    expert_bias: bool = False         # gpt-oss experts carry projection biases
    swiglu_limit: float = 7.0         # swigluoai clamp (HF swiglu_limit)
    router_bias: bool = False         # gpt-oss router linear has a bias
    moe_intermediate_size: int = 512
    shared_expert_intermediate_size: Optional[int] = None
    shared_expert_gated: bool = False  # qwen3-next: sigmoid(gate(x))·shared(x)
    shared_expert_activation: str = "silu"  # nemotron: relu2 (non-gated)
    capacity_factor: float = 1.25    # static-shape dispatch headroom
    # "dropless": sort + grouped GEMM; "capacity": padded einsum dispatch
    dispatcher: str = "dropless"
    router_dtype: str = "float32"
    fake_balanced_gate: bool = False  # perf benchmarking

    def __post_init__(self):
        if self.dispatcher not in ("capacity", "dropless"):
            raise ValueError(
                f"Unknown MoE dispatcher '{self.dispatcher}' "
                "(expected 'capacity' or 'dropless')"
            )
        known_acts = ("silu", "geglu", "quick_geglu", "relu2", "swigluoai")
        for field in ("expert_activation", "shared_expert_activation"):
            if getattr(self, field) not in known_acts:
                raise ValueError(
                    f"Unknown {field} '{getattr(self, field)}' (expected one of {known_acts})"
                )

    @property
    def gated_experts(self) -> bool:
        return self.expert_activation != "relu2"

    @property
    def shared_expert_is_gated(self) -> bool:
        return self.shared_expert_activation != "relu2"

    @property
    def shared_intermediate(self) -> int:
        if self.shared_expert_intermediate_size is not None:
            return self.shared_expert_intermediate_size
        return self.moe_intermediate_size * self.n_shared_experts
