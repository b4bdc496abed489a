"""Checkpoints: the train-state checkpointer (save, retention, resume) and
HF safetensors checkpoints (the port's own reader and writer of the file
format and the adapters between HF names and the stacked parameter
trees)."""

from automodel_tpu_torch.checkpoint.checkpointer import (
    Checkpointer,
    CheckpointingConfig,
    is_remote_path,
)
from automodel_tpu_torch.checkpoint.hf_adapter import (
    ADAPTERS,
    DenseDecoderAdapter,
    HFCheckpointReader,
    MoEDecoderAdapter,
    get_adapter,
    save_hf_checkpoint,
)

__all__ = [
    "ADAPTERS",
    "Checkpointer",
    "CheckpointingConfig",
    "DenseDecoderAdapter",
    "HFCheckpointReader",
    "MoEDecoderAdapter",
    "get_adapter",
    "is_remote_path",
    "save_hf_checkpoint",
]
