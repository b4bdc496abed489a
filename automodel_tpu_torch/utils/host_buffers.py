"""Host copies of a train state, shared by the checkpointer's saves and the
rollback manager's snapshots.

`HostBuffers.snapshot(state)` copies every tensor of the state's tree into a
host buffer kept by tree path, made once and reused while the tensor's
shape and dtype stay the same, so a snapshot costs one copy at the
transfer rate and no allocation after the first. A device tensor's buffer
is page-locked while the page-locked buffers of every `HostBuffers` alive
in the process stay within `PINNED_LIMIT` (a quarter of the host's
memory), and pageable past it: the checkpointer and the rollback manager
draw on one budget. `restore(state, saved)` copies a saved tree back into
the live state's tensors in place, so every reference to them (the
optimizer's moments, a recipe's views) stays valid. A DTensor (a train
state on a mesh) is copied and filled through its local shard.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import weakref
from typing import Any

import torch

from automodel_tpu_torch.parallel.sharding import local

# the share of the host's memory that snapshot buffers may page-lock
PINNED_SHARE = 0.25
PINNED_LIMIT = int(PINNED_SHARE * os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))

_ALIVE: "weakref.WeakSet[HostBuffers]" = weakref.WeakSet()


def pinned_in_use() -> int:
    """Bytes page-locked by every `HostBuffers` alive in the process."""
    return sum(b.pinned_bytes for b in list(_ALIVE))


def as_tree(state: Any) -> Any:
    """A dataclass state as the dict of its fields (no copies)."""
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    return state


class HostBuffers:
    """Host buffers for a state's tensors, by tree path. `nbytes` and
    `pinned_bytes` are the bytes they hold and the page-locked part."""

    def __init__(self):
        self.bufs: dict = {}
        self.nbytes = 0
        self.pinned_bytes = 0
        _ALIVE.add(self)

    def copy(self, tree: Any, path: str = "") -> Any:
        """The tree with every tensor copied into its buffer (without
        waiting, for a device tensor); other leaves deep-copied."""
        if isinstance(tree, dict):
            return {k: self.copy(v, f"{path}.{k}") for k, v in tree.items()}
        if not torch.is_tensor(tree):
            return copy.deepcopy(tree)
        tree = local(tree)
        buf = self.bufs.get(path)
        if buf is None or buf.shape != tree.shape or buf.dtype != tree.dtype:
            if buf is not None:
                self.nbytes -= buf.nbytes
                self.pinned_bytes -= buf.nbytes if buf.is_pinned() else 0
                del self.bufs[path]
            nbytes = tree.numel() * tree.element_size()
            pin = tree.is_cuda and pinned_in_use() + nbytes <= PINNED_LIMIT
            self.pinned_bytes += nbytes if pin else 0
            self.nbytes += nbytes
            buf = self.bufs[path] = torch.empty(tree.shape, dtype=tree.dtype,
                                                pin_memory=pin)
        return buf.copy_(tree.detach(), non_blocking=tree.is_cuda)

    def snapshot(self, state: Any) -> Any:
        """A host copy of `state` (a dataclass becomes the dict of its
        fields) in these buffers; returns once the copies have landed."""
        host = self.copy(as_tree(state))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return host

    def clear(self) -> None:
        """Free the buffers (a later snapshot makes them anew)."""
        self.bufs.clear()
        self.nbytes = self.pinned_bytes = 0


@torch.no_grad()
def fill(live: Any, saved: Any, path: str = "state") -> Any:
    """Copy `saved` into the live tree's tensors in place (a number into a
    scalar tensor); other leaves (host counters) come from `saved`. Trees
    and shapes must match."""
    if isinstance(live, dict):
        if not isinstance(saved, dict) or live.keys() != saved.keys():
            raise ValueError(f"{path}: the saved tree's keys differ from the state's")
        return {k: fill(live[k], saved[k], f"{path}.{k}") for k in live}
    if torch.is_tensor(live):
        target = local(live)
        if isinstance(saved, (int, float)) and target.dim() == 0:
            target.fill_(saved)
            return live
        if not torch.is_tensor(saved) or saved.shape != target.shape:
            raise ValueError(f"{path}: the saved tree holds "
                             f"{getattr(saved, 'shape', type(saved))}, the state {target.shape}")
        target.copy_(saved)
        return live
    return copy.deepcopy(saved)


def restore(state: Any, saved: Any) -> Any:
    """`fill` the live `state` from `saved`; a dataclass state comes back as
    a new dataclass holding the same tensors."""
    filled = fill(as_tree(state), saved)
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return dataclasses.replace(state, **filled)
    return filled
