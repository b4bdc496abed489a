"""Memory-mapped token-stream pretraining dataset with native index maps
(port of `automodel_tpu/datasets/megatron/gpt_dataset.py`, numpy and the
port's own `index_helpers`). Layout on disk:

    <prefix>.bin          flat token stream (uint16 or int32, memmapped)
    <prefix>.doclens.npy  optional int32 per-document token counts

Per epoch, seeded by `seed * 1000003 + epoch`: the documents are shuffled
(native Fisher-Yates), the contiguous (seq_len + 1)-token sample map is
built natively over the shuffled documents, and the sample order is
shuffled (seed + 1). A sample may span documents; it comes out as
`input_ids` / `labels` (the same tokens shifted by one). Deterministic in
(seed, epoch), resumable by sample index.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from automodel_tpu_torch.datasets.megatron.index_helpers import (
    build_sample_index,
    build_shuffle_index,
)


@dataclasses.dataclass
class TokenBinDatasetConfig:
    prefix: str = ""
    seq_len: int = 2048
    seed: int = 0
    dtype: str = "uint16"

    def build(self) -> "TokenBinDataset":
        return TokenBinDataset(self)


class TokenBinDataset:
    def __init__(self, config: TokenBinDatasetConfig, epoch: int = 0):
        self.config = config
        self.tokens = np.memmap(config.prefix + ".bin", dtype=config.dtype, mode="r")
        doclens_path = config.prefix + ".doclens.npy"
        if os.path.exists(doclens_path):
            self.doc_lens = np.load(doclens_path).astype(np.int32)
        else:
            self.doc_lens = np.asarray([len(self.tokens)], np.int32)
        if int(self.doc_lens.sum()) != len(self.tokens):
            raise ValueError(
                f"{doclens_path}: the document lengths sum to {int(self.doc_lens.sum())}, "
                f"the stream holds {len(self.tokens)} tokens")
        self._epoch = None
        self.set_epoch(epoch)

    def set_epoch(self, epoch: int) -> None:
        if epoch == self._epoch:
            return
        self._epoch = epoch
        c = self.config
        seed = c.seed * 1000003 + epoch
        self.doc_order = build_shuffle_index(len(self.doc_lens), seed)
        self.shuffled_lens = self.doc_lens[self.doc_order]
        max_samples = max((int(self.doc_lens.sum()) - 1) // c.seq_len, 0)
        self.sample_idx = build_sample_index(self.shuffled_lens, c.seq_len, max_samples)
        self.sample_order = build_shuffle_index(len(self.sample_idx) - 1, seed + 1)
        # where each (shuffled) document starts in the stream
        starts = np.zeros(len(self.doc_lens) + 1, np.int64)
        np.cumsum(self.doc_lens, out=starts[1:])
        self.doc_starts = starts[self.doc_order]

    def __len__(self) -> int:
        return len(self.sample_order)

    def _gather(self, row: int) -> np.ndarray:
        """The seq_len + 1 tokens of sample `row` of the map, across
        documents."""
        need = self.config.seq_len + 1
        out = np.empty((need,), np.int64)
        d, off = (int(x) for x in self.sample_idx[row])
        got = 0
        while got < need:
            take = min(int(self.shuffled_lens[d]) - off, need - got)
            s = int(self.doc_starts[d]) + off
            out[got:got + take] = self.tokens[s:s + take]
            got += take
            d += 1
            off = 0
        return out

    def __getitem__(self, idx: int) -> dict:
        tokens = self._gather(int(self.sample_order[idx]))
        return {
            "input_ids": tokens[:-1].astype(np.int32),
            "labels": tokens[1:].astype(np.int32),
        }
