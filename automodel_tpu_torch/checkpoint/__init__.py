"""HF safetensors checkpoints: the port's own reader and writer of the file
format and the adapters between HF names and the stacked parameter trees.
The train-state checkpointer (save, retention, resume) is not ported yet."""

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
    "DenseDecoderAdapter",
    "HFCheckpointReader",
    "MoEDecoderAdapter",
    "get_adapter",
    "save_hf_checkpoint",
]
