"""Hermetic mock datasets for CI and benchmarking.

A copy of the next-token-prediction mock of `automodel_tpu/datasets/mock.py`
(numpy only), so that both packages see identical batches from one seed and
the port never imports the JAX package. The other mocks of that file
(sequence classification, retrieval, rerank, diffusion latents) belong to
recipes not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MockDatasetConfig:
    num_samples: int = 1024
    seq_len: int = 512
    vocab_size: int = 32000
    seed: int = 0
    packed: bool = False
    docs_per_sample: int = 4  # packed only
    # packed only: force document boundaries at multiples of `align` (plus
    # the random interior cuts) so no document crosses an align-sized
    # sub-buffer — the capacity-aligned packing blockdiag CP needs
    # (set align = seq_len // cp; see parallel/cp.py blockdiag sharder)
    align: int = 0

    def build(self) -> "MockDataset":
        return MockDataset(self)


class MockDataset:
    """Deterministic random next-token-prediction samples."""

    def __init__(self, config: MockDatasetConfig):
        self.config = config

    def __len__(self) -> int:
        return self.config.num_samples

    def __getitem__(self, idx: int) -> dict:
        c = self.config
        rng = np.random.default_rng(c.seed * 100003 + idx)
        tokens = rng.integers(1, c.vocab_size, c.seq_len + 1, dtype=np.int32)
        sample = {
            "input_ids": tokens[:-1],
            "labels": tokens[1:].copy(),
        }
        if c.packed:
            # synthetic document boundaries → segment ids + per-doc positions
            cuts = np.sort(rng.choice(np.arange(1, c.seq_len), c.docs_per_sample - 1, replace=False))
            if c.align:
                cuts = np.unique(np.concatenate(
                    [cuts, np.arange(c.align, c.seq_len, c.align)]
                ))
            seg = np.zeros(c.seq_len, np.int32)
            pos = np.zeros(c.seq_len, np.int32)
            prev = 0
            for d, cut in enumerate(list(cuts) + [c.seq_len]):
                seg[prev:cut] = d
                pos[prev:cut] = np.arange(cut - prev)
                prev = cut
            sample["segment_ids"] = seg
            sample["positions"] = pos
            # no cross-document next-token supervision
            labels = sample["labels"]
            labels[np.flatnonzero(np.diff(seg))] = -100
        return sample
