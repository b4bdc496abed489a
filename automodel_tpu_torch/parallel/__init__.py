"""Sharding rules, the explicit collectives and the SPMD helpers the
models run on a mesh (port of `automodel_tpu/parallel/`; `cp.py` and
`pp.py` are ROADMAP.md item 12b)."""

from automodel_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    AxisRules,
    Layout,
    distribute_params,
    layout_of,
    local_tree,
    logical_to_shardings,
    with_logical_constraint,
)

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "Layout",
    "distribute_params",
    "layout_of",
    "local_tree",
    "logical_to_shardings",
    "with_logical_constraint",
]
