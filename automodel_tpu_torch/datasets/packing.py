"""Sequence packing: variable-length documents -> fixed (seq_len,) rows with
segment ids and per-document positions (a copy of
`automodel_tpu/datasets/packing.py`, numpy only, so the port imports
nothing of the JAX package). The (segment_ids, positions) pairs are the
layout the decoder's attention and K1-K3 read.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np

IGNORE_INDEX = -100


@dataclasses.dataclass
class PackedSequenceConfig:
    seq_len: int = 2048
    pad_id: int = 0
    drop_last_incomplete: bool = False
    # "first_fit": streaming greedy (order-preserving, O(1) memory).
    # "knapsack": NeAT-style greedy knapsack over the whole corpus — sort by
    # length descending, place each into the fullest bin that still fits
    # (best fit decreasing); materializes all documents first but packs
    # tighter.
    strategy: str = "first_fit"
    # capacity alignment: no document crosses a multiple of `align` inside
    # the row (documents longer than align are truncated to it); the JAX
    # package's block-diagonal context parallelism sets align = seq_len // cp.
    # 0 = off.
    align: int = 0


def pack_documents(
    docs: Iterable[dict],  # each: {"input_ids": (n,), "labels": (n,)}
    config: PackedSequenceConfig,
) -> Iterator[dict]:
    """Greedy first-fit packing; emits rows with segment_ids/positions.

    Documents longer than seq_len are truncated. The first token of each
    document keeps its label masked only if the doc provided it masked —
    cross-document supervision never occurs because labels come from within
    each document.
    """
    S = config.seq_len
    buf_ids = np.full(S, config.pad_id, np.int32)
    buf_labels = np.full(S, IGNORE_INDEX, np.int32)
    buf_seg = np.zeros(S, np.int32)
    buf_pos = np.zeros(S, np.int32)
    offset = 0
    seg = 0

    def flush():
        nonlocal buf_ids, buf_labels, buf_seg, buf_pos, offset, seg
        row = {
            "input_ids": buf_ids,
            "labels": buf_labels,
            "segment_ids": buf_seg,
            "positions": buf_pos,
        }
        buf_ids = np.full(S, config.pad_id, np.int32)
        buf_labels = np.full(S, IGNORE_INDEX, np.int32)
        buf_seg = np.zeros(S, np.int32)
        buf_pos = np.zeros(S, np.int32)
        offset = 0
        seg = 0
        return row

    if config.strategy == "knapsack":
        docs = _knapsack_order(docs, S)
    elif config.strategy != "first_fit":
        raise ValueError(f"unknown packing strategy {config.strategy!r}")

    A = config.align
    if A and (A <= 0 or S % A != 0):
        raise ValueError(f"packing align={A} must divide seq_len={S}")

    for doc in docs:
        cap = min(S, A) if A else S
        ids = np.asarray(doc["input_ids"], np.int32)[:cap]
        labels = np.asarray(doc["labels"], np.int32)[: len(ids)]
        n = len(ids)
        if A and (offset % A) + n > A:
            # skip to the next align boundary so the doc stays inside one
            # align-sized sub-buffer (pad slots keep segment 0)
            offset = ((offset // A) + 1) * A
        if offset + n > S:
            yield flush()
        buf_ids[offset : offset + n] = ids
        buf_labels[offset : offset + n] = labels
        # documents take segment ids from 1, so padding (segment 0) never
        # matches a real document in a partly filled row
        buf_seg[offset : offset + n] = seg + 1
        buf_pos[offset : offset + n] = np.arange(n)
        offset += n
        seg += 1
        if offset == S:
            yield flush()
    if offset > 0 and not config.drop_last_incomplete:
        yield flush()


def _knapsack_order(docs: Iterable[dict], seq_len: int) -> Iterator[dict]:
    """NeAT-style greedy knapsack: documents longest-first, each placed into
    the FULLEST bin that still fits (best-fit-decreasing); bins re-emitted
    document-by-document so the streaming packer above reproduces the bin
    layout exactly (each bin fits by construction).
    """
    items = list(docs)
    lengths = [min(len(np.asarray(d["input_ids"])), seq_len) for d in items]
    order = sorted(range(len(items)), key=lambda i: -lengths[i])
    loads: list[int] = []
    bins: list[list[int]] = []
    for i in order:
        n = lengths[i]
        # fullest fitting bin (linear scan; lengths are descending so early
        # bins fill first and the scan stays short in practice)
        best, best_load = -1, -1
        for b, used in enumerate(loads):
            if used + n <= seq_len and used > best_load:
                best, best_load = b, used
        if best >= 0:
            bins[best].append(i)
            loads[best] += n
        else:
            bins.append([i])
            loads.append(n)
    for b in bins:
        for i in b:
            yield items[i]
