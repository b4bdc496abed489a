"""NanoGPT-style .bin shard pretraining dataset (a copy of
`automodel_tpu/datasets/nanogpt.py`, numpy only, so the port imports
nothing of the JAX package): memory-mapped token shards with the
256 x int32 header

    header[0] = 278895051 (or legacy 20240520)
    header[1] = 1
    header[2] = num_tokens
    header[3] = dtype.itemsize (new format; 2=uint16, 4=uint32)

A map-style dataset (len/getitem): the shard layout is resolved once into
a global chunk index, chunk order is a seeded permutation, and resume is a
row index in the dataloader state; shards stay memory-mapped, so only the
touched pages load. `write_bin_shard` writes the same format.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Optional

import numpy as np

MAGIC = 278895051
LEGACY_MAGIC = 20240520
HEADER_INTS = 256


def write_bin_shard(tokens: np.ndarray, path: str) -> None:
    """Write tokens (uint16/uint32) as a new-format .bin shard."""
    tokens = np.asarray(tokens)
    assert tokens.dtype in (np.uint16, np.uint32), tokens.dtype
    header = np.zeros(HEADER_INTS, np.int32)
    header[0] = MAGIC
    header[1] = 1
    header[2] = tokens.size
    header[3] = tokens.dtype.itemsize
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(tokens.tobytes())


def _open_shard(path: str) -> np.ndarray:
    header = np.memmap(path, dtype=np.int32, mode="r", shape=(HEADER_INTS,))
    magic = int(header[0])
    if magic == MAGIC:
        itemsize = int(header[3]) or 2
    elif magic == LEGACY_MAGIC:
        itemsize = 2
    else:
        raise ValueError(f"{path}: bad magic {magic} (not a nanogpt .bin shard)")
    dtype = {2: np.uint16, 4: np.uint32}[itemsize]
    n = int(header[2])
    return np.memmap(path, dtype=dtype, mode="r", offset=HEADER_INTS * 4, shape=(n,))


@dataclasses.dataclass
class NanogptBinDatasetConfig:
    path: str = ""          # glob over .bin shards, e.g. data/fineweb_*.bin
    seq_len: int = 1024
    shuffle_seed: Optional[int] = 0  # None = sequential document order
    bos_token_id: Optional[int] = None  # align chunk starts to BOS when set

    def build(self, tokenizer=None) -> "NanogptBinDataset":
        return NanogptBinDataset(self)


class NanogptBinDataset:
    """seq_len+1 token windows across all shards → (input_ids, labels)."""

    def __init__(self, config: NanogptBinDatasetConfig):
        self.config = config
        paths = sorted(glob.glob(config.path)) if any(
            ch in config.path for ch in "*?[") else [config.path]
        if not paths or not all(os.path.exists(p) for p in paths):
            raise FileNotFoundError(f"no .bin shards match {config.path!r}")
        self.shards = [_open_shard(p) for p in paths]

        w = config.seq_len + 1
        # global chunk table: (shard_idx, start) for every full window;
        # with bos_token_id, windows start at document heads (greedy
        # non-overlapping BOS alignment)
        entries = []
        for si, shard in enumerate(self.shards):
            if config.bos_token_id is not None:
                # scan in blocks: finding BOS needs one sequential pass, but
                # never materialize a whole multi-GB shard at once
                block = 1 << 22
                parts = [
                    np.flatnonzero(shard[o : o + block] == config.bos_token_id) + o
                    for o in range(0, shard.shape[0], block)
                ]
                bos = np.concatenate(parts).astype(np.int64)
                starts_l = []
                cursor = -1
                for p in bos:
                    if p > cursor and p + w <= shard.shape[0]:
                        starts_l.append(p)
                        cursor = p + config.seq_len - 1
                starts = np.asarray(starts_l, np.int64)
            else:
                n_chunks = (shard.shape[0] - 1) // config.seq_len
                starts = np.arange(n_chunks, dtype=np.int64) * config.seq_len
                starts = starts[starts + w <= shard.shape[0]]
            entries.append(
                np.stack([np.full_like(starts, si), starts], axis=1)
            )
        self.index = np.concatenate(entries) if entries else np.zeros((0, 2), np.int64)
        if config.shuffle_seed is not None:
            rng = np.random.default_rng(config.shuffle_seed)
            self.index = self.index[rng.permutation(len(self.index))]

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int) -> dict:
        si, start = self.index[idx]
        w = self.config.seq_len + 1
        window = np.asarray(self.shards[si][start : start + w], np.int64)
        return {
            "input_ids": window[:-1].astype(np.int32),
            "labels": window[1:].astype(np.int32),
        }
