"""Hermetic mock datasets for CI and benchmarking.

A copy of the next-token-prediction, sequence-classification, retrieval
and rerank mocks of `automodel_tpu/datasets/mock.py` (numpy only), so that
both packages see identical batches from one seed and the port never
imports the JAX package. The diffusion-latent mock belongs to a recipe not
ported yet.
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


@dataclasses.dataclass
class MockSeqClsDatasetConfig:
    """Mock sequence-classification set."""

    num_samples: int = 256
    seq_len: int = 64
    vocab_size: int = 512
    num_labels: int = 4
    seed: int = 0

    def build(self) -> "MockSeqClsDataset":
        return MockSeqClsDataset(self)


class MockSeqClsDataset:
    def __init__(self, config: MockSeqClsDatasetConfig):
        self.config = config

    def __len__(self) -> int:
        return self.config.num_samples

    def __getitem__(self, idx: int) -> dict:
        c = self.config
        rng = np.random.default_rng(c.seed * 77771 + idx)
        label = int(rng.integers(0, c.num_labels))
        # learnable signal: the label's token id is over-represented
        tokens = rng.integers(1, c.vocab_size, c.seq_len, dtype=np.int32)
        tokens[rng.random(c.seq_len) < 0.3] = label + 1
        n_real = int(rng.integers(c.seq_len // 2, c.seq_len + 1))
        mask = np.zeros(c.seq_len, np.int32)
        mask[:n_real] = 1
        tokens[n_real:] = 0
        return {
            "input_ids": tokens,
            "attention_mask": mask,
            "label": np.int32(label),
        }


@dataclasses.dataclass
class MockRetrievalDatasetConfig:
    """Mock (query, positive-doc) pairs for bi-encoder training."""

    num_samples: int = 256
    seq_len: int = 32
    vocab_size: int = 512
    seed: int = 0

    def build(self) -> "MockRetrievalDataset":
        return MockRetrievalDataset(self)


class MockRetrievalDataset:
    def __init__(self, config: MockRetrievalDatasetConfig):
        self.config = config

    def __len__(self) -> int:
        return self.config.num_samples

    def __getitem__(self, idx: int) -> dict:
        c = self.config
        rng = np.random.default_rng(c.seed * 55001 + idx)
        # query and its positive share a vocabulary slice: a learnable match
        base = rng.integers(1, c.vocab_size // 2)
        q = rng.integers(base, base + 40, c.seq_len).astype(np.int32) % c.vocab_size
        d = rng.integers(base, base + 40, c.seq_len).astype(np.int32) % c.vocab_size
        ones = np.ones(c.seq_len, np.int32)
        return {
            "query_ids": q, "doc_ids": d,
            "query_mask": ones, "doc_mask": ones.copy(),
        }


@dataclasses.dataclass
class MockRerankDatasetConfig:
    """Mock (query ⊕ doc) groups: slot 0 positive, the rest negatives."""

    num_samples: int = 256
    seq_len: int = 32
    group_size: int = 4
    vocab_size: int = 512
    seed: int = 0

    def build(self) -> "MockRerankDataset":
        return MockRerankDataset(self)


class MockRerankDataset:
    def __init__(self, config: MockRerankDatasetConfig):
        self.config = config

    def __len__(self) -> int:
        return self.config.num_samples

    def __getitem__(self, idx: int) -> dict:
        c = self.config
        rng = np.random.default_rng(c.seed * 31337 + idx)
        # the positive pair shares a token band; negatives are uniform
        base = int(rng.integers(1, c.vocab_size // 2))
        pos = rng.integers(base, base + 30, c.seq_len).astype(np.int32) % c.vocab_size
        pairs = [pos]
        for _ in range(c.group_size - 1):
            pairs.append(rng.integers(1, c.vocab_size, c.seq_len).astype(np.int32))
        return {
            "pair_ids": np.stack(pairs),
            "pair_mask": np.ones((c.group_size, c.seq_len), np.int32),
        }
