"""The safetensors file format, read and written with torch alone.

A file is a little-endian u64 header length, a JSON header and the raw
tensor bytes. The header maps each tensor name to its `dtype`, `shape` and
`data_offsets` (begin, end) into the byte buffer that follows the header;
an optional `__metadata__` entry holds string pairs. The port reads and
writes the format itself because the card's machine has neither the
`safetensors` package nor `ml_dtypes` (which the JAX reader needs for fp8).

Reads map the file (`mmap`) and copy one tensor at a time, so host memory
holds one tensor beyond the mapping. Writes stream: the header is computed
from the shapes, then each tensor is copied to the host and written in
turn.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Iterable, Mapping

import numpy as np
import torch

# the dtypes the JAX package's reader takes
DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in DTYPES.items()}


class SafetensorsFile:
    """One file, mapped read-only; `get(name)` returns a CPU tensor that
    owns its memory (it outlives `close`)."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        (hlen,) = struct.unpack("<Q", self._file.read(8))
        header = json.loads(self._file.read(hlen))
        self._start = 8 + hlen
        self.metadata = header.pop("__metadata__", None) or {}
        self._entries = header
        self._map = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)

    def keys(self):
        return self._entries.keys()

    def get(self, name: str) -> torch.Tensor:
        meta = self._entries[name]
        if meta["dtype"] not in DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has unsupported dtype {meta['dtype']}")
        dtype = DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        if end == begin:
            return torch.empty(meta["shape"], dtype=dtype)
        raw = np.frombuffer(self._map, np.uint8, end - begin, self._start + begin)
        return torch.from_numpy(raw.copy()).view(dtype).reshape(meta["shape"])

    def close(self) -> None:
        self._map.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_file(tensors: "Mapping[str, torch.Tensor] | Iterable[tuple[str, torch.Tensor]]",
              path: str, metadata: Mapping[str, str] | None = None) -> None:
    """Write tensors (on any device, any strides) to one file, in the given
    order. The header is padded with spaces to a multiple of 8 bytes, as the
    `safetensors` package writes it."""
    items = list(tensors.items() if isinstance(tensors, Mapping) else tensors)
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in items:
            # made contiguous where it lies (a transpose on the card), then copied
            host = t.detach().contiguous().to("cpu").reshape(-1).view(torch.uint8)
            f.write(host.numpy().data)
