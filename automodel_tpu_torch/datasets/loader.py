"""Dataloader: map-style dataset → (grad_accum, microbatch, seq) batches
(port of `automodel_tpu/datasets/loader.py`).

Shuffling with an epoch-dependent numpy seed (the same order as the JAX
package's), and a checkpointable position. The port runs one process, so
there is no rank sharding; `make_global_batch` is a host-to-device copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class DataloaderConfig:
    microbatch_size: int = 8       # per GLOBAL step, per grad-accum slice
    grad_acc_steps: int = 1
    shuffle: bool = True
    # group similar lengths per microbatch (needs `dataset.lengths`)
    length_grouped: bool = False
    seed: int = 0
    drop_last: bool = True

    def build(self, dataset) -> "Dataloader":
        return Dataloader(self, dataset)


class Dataloader:
    def __init__(self, config: DataloaderConfig, dataset):
        self.config = config
        self.dataset = dataset
        self.epoch = 0
        self.batch_index = 0  # resumable position within the epoch

    @property
    def samples_per_step(self) -> int:
        return self.config.microbatch_size * self.config.grad_acc_steps

    def __len__(self) -> int:
        return len(self.dataset) // self.samples_per_step

    def set_epoch(self, epoch: int) -> None:
        # keep a checkpoint-restored batch_index when re-entering the SAME
        # epoch (mid-epoch resume); only an actual epoch change rewinds
        if epoch != self.epoch:
            self.epoch = epoch
            self.batch_index = 0

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.config.length_grouped:
            lengths = getattr(self.dataset, "lengths", None)
            if lengths is None:
                raise ValueError(
                    "dataloader.length_grouped requires the dataset to expose "
                    "a `lengths` sequence"
                )
            return length_grouped_order(
                lengths, self.config.microbatch_size, self.config.seed, self.epoch
            )
        if not self.config.shuffle:
            return np.arange(n)
        rng = np.random.default_rng(self.config.seed * 1000003 + self.epoch)
        return rng.permutation(n)

    def __iter__(self) -> Iterator[dict]:
        """Yields microbatches: dict of (microbatch_size, ...) arrays."""
        order = self._order()
        per = self.config.microbatch_size
        n_micro = len(order) // per
        start = self.batch_index
        for b in range(start, n_micro):
            self.batch_index = b + 1
            idx = order[b * per : (b + 1) * per]
            samples = [self.dataset[int(i)] for i in idx]
            yield {
                k: np.stack([s[k] for s in samples]) for k in samples[0]
            }
        self.batch_index = 0

    # -- checkpointable position (StatefulDataLoader analog) ---------------
    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "batch_index": self.batch_index}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.batch_index = int(state["batch_index"])


def length_grouped_order(lengths, microbatch_size: int, seed: int, epoch: int):
    """Shuffled length-grouped sample order (reference: the length-grouped
    sampler): sort by length within shuffled mega-chunks so microbatches have
    similar lengths (less padding waste) while keeping epoch-level shuffling."""
    lengths = np.asarray(lengths)
    n = len(lengths)
    rng = np.random.default_rng(seed * 7919 + epoch)
    perm = rng.permutation(n)
    mega = microbatch_size * 64
    out = []
    for start in range(0, n, mega):
        chunk = perm[start : start + mega]
        out.append(chunk[np.argsort(lengths[chunk], kind="stable")])
    return np.concatenate(out)


def stack_microbatches(microbatches: list) -> dict:
    """List of grad-accum microbatch dicts → (accum, micro, ...) arrays."""
    keys = microbatches[0].keys()
    return {k: np.stack([m[k] for m in microbatches]) for k in keys}


def make_global_batch(batch: dict, device) -> dict:
    """Host numpy batch -> the same dict of tensors on `device`."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
        for k, v in batch.items()
    }
