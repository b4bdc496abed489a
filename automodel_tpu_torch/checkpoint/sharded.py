"""Sharded train-state checkpoints that reshard across topologies.

A train state on a mesh holds DTensors. Each rank saves the blocks it
owns: for every DTensor leaf, the rank at coordinate 0 on each mesh axis
that does not split it writes `{"__shard__": global shape, "offsets":
block offsets, "data": local block}`; rank 0 alone writes the plain
tensors and host values. So every element is written once, whatever the
replication (HSDP's `dp_replicate`, `tp`-replicated norms).

Restoring is planning by boxes: the live leaf's block on the live mesh
(a DTensor's placements and this rank's coordinates, or the whole tensor
for a plain one) is filled from every saved block that overlaps it, so a
checkpoint written at one mesh restores at another, at one process
included, and a one-process checkpoint (whole tensors) restores onto a
mesh. Each saved block is read through a memory map: a rank reads the
bytes it needs.
"""

from __future__ import annotations

import copy
import math
from typing import Any

import torch

from automodel_tpu_torch.parallel.sharding import dtensor_box, is_dtensor

SHARD_KEY = "__shard__"
SHARDED_MARKER = "__sharded__"


def has_dtensor(tree) -> bool:
    if isinstance(tree, dict):
        return any(has_dtensor(v) for v in tree.values())
    return is_dtensor(tree)


def to_blocks(tree, rank: int):
    """The part of `tree` this rank writes (see the module docstring);
    what another rank writes becomes None."""
    if isinstance(tree, dict):
        return {k: to_blocks(v, rank) for k, v in tree.items()}
    if is_dtensor(tree):
        offs, _, primary = dtensor_box(tree)
        if not primary:
            return None
        return {SHARD_KEY: list(tree.shape), "offsets": list(offs), "data": tree.to_local()}
    return tree if rank == 0 else None


def _pieces(saved: list) -> list:
    return [s for s in saved if s is not None]


@torch.no_grad()
def assemble(live: Any, saved: list, path: str = "state") -> Any:
    """Fill the live tree's tensors in place from the saved trees `saved`
    (one per writing rank, or one whole tree); host values come from the
    first tree that holds them. Returns the live tree."""
    if isinstance(live, dict):
        trees = _pieces(saved)
        keys = set().union(*(t.keys() for t in trees if isinstance(t, dict)))
        if set(live.keys()) != keys:
            raise ValueError(f"{path}: the saved tree's keys differ from the state's")
        return {k: assemble(live[k], [t.get(k) if isinstance(t, dict) else None
                                      for t in saved], f"{path}.{k}")
                for k in live}
    pieces = _pieces(saved)
    if not torch.is_tensor(live):
        if not pieces:
            raise ValueError(f"{path}: no saved value")
        return copy.deepcopy(pieces[0])
    target = live.to_local() if is_dtensor(live) else live
    if is_dtensor(live):
        t_offs, t_lens, _ = dtensor_box(live)
    else:
        t_offs, t_lens = [0] * live.dim(), list(live.shape)
    filled = 0
    for piece in pieces:
        if isinstance(piece, (int, float)) and target.dim() == 0:
            target.fill_(piece)
            return live
        if isinstance(piece, dict) and SHARD_KEY in piece:
            shape, offs, data = piece[SHARD_KEY], piece["offsets"], piece["data"]
        elif torch.is_tensor(piece):
            shape, offs, data = list(piece.shape), [0] * piece.dim(), piece
        else:
            raise ValueError(f"{path}: the saved tree holds {type(piece)}")
        if list(shape) != list(live.shape):
            raise ValueError(f"{path}: saved global shape {list(shape)}, "
                             f"the state's {list(live.shape)}")
        src, dst = data, target
        for d in range(target.dim()):
            lo = max(offs[d], t_offs[d])
            hi = min(offs[d] + data.shape[d], t_offs[d] + t_lens[d])
            if hi <= lo:
                break
            src = src.narrow(d, lo - offs[d], hi - lo)
            dst = dst.narrow(d, lo - t_offs[d], hi - lo)
        else:
            dst.copy_(src)
            filled += src.numel()
    if filled != math.prod(t_lens):
        raise ValueError(f"{path}: the saved blocks cover {filled} of "
                         f"{math.prod(t_lens)} elements of this rank's block")
    return live
