"""Device resolution and dtype mapping for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. A CUDA request without a CUDA device raises: the
    port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name ("float32", "bfloat16",
    "float16") or a numpy dtype (including ml_dtypes' bfloat16, by name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]
