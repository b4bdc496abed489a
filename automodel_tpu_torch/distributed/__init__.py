"""The mesh and the process group (port of `automodel_tpu/distributed/`)."""

from automodel_tpu_torch.distributed.init_utils import (
    destroy_distributed,
    get_rank_safe,
    get_world_size_safe,
    initialize_distributed,
    is_main_process,
    launched_distributed,
)
from automodel_tpu_torch.distributed.mesh import (
    MeshAxisName,
    MeshConfig,
    MeshContext,
    refuse_unported_axes,
)

__all__ = [
    "MeshAxisName",
    "MeshConfig",
    "MeshContext",
    "destroy_distributed",
    "get_rank_safe",
    "get_world_size_safe",
    "initialize_distributed",
    "is_main_process",
    "launched_distributed",
    "refuse_unported_axes",
]
