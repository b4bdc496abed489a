"""Train-state checkpointer: save, retention, best-step tracking and restore
(port of `automodel_tpu/checkpoint/checkpointer.py`).

The JAX package saves through orbax; the port writes one directory per
step (on a mesh, see below):

    <checkpoint_dir>/step_<N>/state.pt      the train state (torch.save)
                             /extra.json    the recipe's tracked host state
                             /metrics.json  the metrics `best_metric` reads

`state.pt` holds the train state's tree (a dataclass becomes a dict of its
fields) with every tensor moved to the host: the params, the optimizer's
state and the host integers (steps, counts). A step is written into
`step_<N>.tmp/` and renamed on commit, so `latest_step` never sees a
half-written step. The `step_` prefix keeps the port's steps apart from
orbax's bare `<N>/` directories.

Retention keeps the `max_recent_checkpoints` newest steps, and the best
step too when `best_metric` is set. With `async_save` the state is copied
to host memory on the caller's thread and written by a background thread;
`wait()` joins it and re-raises a failed write. Device tensors are copied
into host buffers that the checkpointer keeps from one save to the next
(the next save waits for the previous write) until `close()`, so the
trainer is held for one device-to-host copy at the card's transfer rate
(`utils/host_buffers.py`, whose page-locked budget the rollback's
snapshots share). `restore` copies the saved tensors into the live ones,
which keep their device and dtype.
`last_save` holds the newest save's step, bytes (those of `state.pt`, and
the page-locked part of the buffers) and seconds: the copy to host memory
(`host_s`, on the caller's thread) and the write and commit
(`write_s`, set when the write lands).

A train state on a mesh (DTensor leaves) is saved sharded
(`checkpoint/sharded.py`): every rank writes the blocks it owns to
`rank_<r>.pt` beside `state.pt`, which then holds only the marker
`{"__sharded__": world}`; the ranks meet at a barrier before rank 0
renames the step into place and prunes, so the commit is the last rank's
write. These saves are synchronous (the barriers belong to the caller's
thread). `restore` plans by boxes: a sharded or a one-process step
restores onto any mesh, and onto one process, each leaf's live block
filled from the saved blocks that overlap it.

The two packages' train states do not read each other: orbax cannot read
`state.pt` and the port does not read orbax's directories. They meet at the
consolidated HF export (`hf_adapter.save_hf_checkpoint`).

The `resilience` section's retry wraps save and restore (`set_retry`), and
the fault probes sit where the JAX package puts them: `checkpoint_write`
and `checkpoint_restore` inside each attempt (so a retried save really
re-runs the failure point), `checkpoint_wait` in `wait()`, which is not
retried (the failed write is consumed). An exception of the background
write, a `FaultCrash` included, is kept and raised by the next `wait()`
or save. What is not ported: remote URIs (`gs://...`, ROADMAP.md queue 1
item 16).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from automodel_tpu_torch.checkpoint.sharded import (
    SHARDED_MARKER,
    assemble,
    has_dtensor,
    to_blocks,
)
from automodel_tpu_torch.resilience.faults import fault_hit
from automodel_tpu_torch.resilience.retry import RetryPolicy, retry_call
from automodel_tpu_torch.utils.host_buffers import HostBuffers, as_tree, restore

logger = logging.getLogger(__name__)

_STEP_DIR = re.compile(r"step_(\d+)")


def is_remote_path(path: str) -> bool:
    """True for fsspec-style URIs (gs://..., s3://..., file://...).
    Windows drive letters (C:\\...) are NOT URIs."""
    scheme, sep, _ = str(path).partition("://")
    return bool(sep) and scheme.isalnum() and len(scheme) > 1


@dataclasses.dataclass
class CheckpointingConfig:
    """The JAX package's checkpoint section, fields and defaults."""

    enabled: bool = True
    checkpoint_dir: str = "checkpoints"
    save_every_steps: int = 1000
    max_recent_checkpoints: Optional[int] = 5
    async_save: bool = True
    save_consolidated: str | bool = False  # False | "final" | "every"
    best_metric: Optional[str] = None  # e.g. "val_loss": keeps the best too
    best_mode: str = "min"

    def build(self) -> "Checkpointer":
        return Checkpointer(self)


class Checkpointer:
    def __init__(self, config: CheckpointingConfig):
        if is_remote_path(config.checkpoint_dir):
            raise NotImplementedError(
                f"checkpoint_dir {config.checkpoint_dir!r} is a remote URI: the port "
                "writes local directories only (ROADMAP.md queue 1 item 16)")
        self.config = config
        os.makedirs(config.checkpoint_dir, exist_ok=True)
        self.root = os.path.abspath(config.checkpoint_dir)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._buffers = HostBuffers()  # the snapshot's host copies
        self.last_save: dict = {}
        # retry wiring (resilience layer): None → every op is one attempt
        self.retry_policy: Optional[RetryPolicy] = None
        self._on_retry = None

    def set_retry(self, policy: Optional[RetryPolicy], on_attempt=None) -> None:
        """Wrap save and restore in retry-with-backoff (resilience/retry.py);
        `on_attempt(point, attempt, exc, delay_s)` observes every failure."""
        self.retry_policy = policy
        self._on_retry = on_attempt

    def _attempt(self, point: str, fn):
        # FileNotFoundError is deterministic (a missing checkpoint does not
        # appear on retry) and callers' fallbacks match on the type
        return retry_call(
            fn, policy=self.retry_policy, point=point,
            on_attempt=self._on_retry, no_retry=(FileNotFoundError,),
        )

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def all_steps(self) -> list[int]:
        """The committed steps, ascending (`.tmp` directories are not)."""
        steps = []
        for name in os.listdir(self.root):
            m = _STEP_DIR.fullmatch(name)
            if m and os.path.isfile(os.path.join(self.root, name, "state.pt")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    # -- save ------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict | None = None,
             metrics: dict | None = None) -> bool:
        """Save the train state plus a JSON side-car of host state (the
        recipe's tracked dataloader, scheduler and RNG). A step already
        committed is not saved again. Every call saves: the caller decides
        when (`should_save`)."""
        if not self.config.enabled:
            return False
        self._join()  # one write at a time; a failed earlier write raises
        if step in self.all_steps():
            return False

        sharded = has_dtensor(as_tree(state))

        def attempt():
            fault_hit("checkpoint_write", step=step)
            t0 = time.perf_counter()
            tree = to_blocks(as_tree(state), _rank()) if sharded else state
            snapshot = self._buffers.snapshot(tree)
            self.last_save = {"step": step, "host_s": time.perf_counter() - t0,
                              "pinned_bytes": self._buffers.pinned_bytes}
            if sharded:
                self._write_sharded(step, snapshot, extra, metrics)
            elif self.config.async_save:
                self._writer = threading.Thread(
                    target=self._write_async, args=(step, snapshot, extra, metrics),
                    name=f"checkpoint-step-{step}", daemon=True)
                self._writer.start()
            else:
                self._write(step, snapshot, extra, metrics)

        self._attempt("checkpoint_write", attempt)
        return True

    def _write_async(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _write(self, step: int, snapshot: dict, extra: dict | None,
               metrics: dict | None) -> None:
        t0 = time.perf_counter()
        final = self._dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(snapshot, os.path.join(tmp, "state.pt"))
        nbytes = os.path.getsize(os.path.join(tmp, "state.pt"))
        for name, obj in (("extra.json", extra), ("metrics.json", metrics)):
            if obj is not None:
                with open(os.path.join(tmp, name), "w") as f:
                    json.dump(obj, f)
        os.rename(tmp, final)
        self.last_save.update(bytes=nbytes, write_s=time.perf_counter() - t0)
        logger.info("saved checkpoint at step %d", step)
        self._prune()

    def _write_sharded(self, step: int, snapshot: dict, extra: dict | None,
                       metrics: dict | None) -> None:
        """Every rank's blocks into `step_<N>.tmp/`, then one rename by rank
        0 after a barrier (see the module docstring)."""
        t0 = time.perf_counter()
        rank, world = _rank(), _world()
        final = self._dir(step)
        tmp = final + ".tmp"
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _barrier()
        path = os.path.join(tmp, f"rank_{rank:05d}.pt")
        torch.save(snapshot, path)
        nbytes = os.path.getsize(path)
        if rank == 0:
            for name, obj in (("extra.json", extra), ("metrics.json", metrics)):
                if obj is not None:
                    with open(os.path.join(tmp, name), "w") as f:
                        json.dump(obj, f)
            torch.save({SHARDED_MARKER: world}, os.path.join(tmp, "state.pt"))
        _barrier()
        if rank == 0:
            os.rename(tmp, final)
            self._prune()
        _barrier()
        self.last_save.update(bytes=nbytes, write_s=time.perf_counter() - t0)
        logger.info("saved sharded checkpoint at step %d (rank %d of %d)", step, rank, world)

    def _prune(self) -> None:
        """Drop the steps retention does not keep."""
        keep_n = self.config.max_recent_checkpoints
        steps = self.all_steps()
        if keep_n is None:
            return
        keep = set(steps[-keep_n:]) if keep_n > 0 else set()
        best = self.best_step()
        if best is not None:
            keep.add(best)
        for step in steps:
            if step not in keep:
                shutil.rmtree(self._dir(step), ignore_errors=True)

    def should_save(self, step: int) -> bool:
        return (
            self.config.enabled
            and step > 0
            and step % self.config.save_every_steps == 0
        )

    # -- load ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The committed step whose `best_metric` is best, or None."""
        name = self.config.best_metric
        if name is None:
            return None
        scored = []
        for step in self.all_steps():
            path = os.path.join(self._dir(step), "metrics.json")
            if os.path.isfile(path):
                with open(path) as f:
                    value = json.load(f).get(name)
                if value is not None:
                    scored.append((float(value), step))
        if not scored:
            return None
        pick = min if self.config.best_mode == "min" else max
        return pick(scored)[1]

    def restore(self, state: Any, step: Optional[int] = None,
                with_extra: bool = False):
        """Restore `step` (the latest when None) into the live `state`: its
        tensors are filled in place, keeping their device and dtype; returns
        the restored state (a new dataclass for a dataclass state), and the
        side-car dict with `with_extra`."""
        step = step if step is not None else self.latest_step()
        if step is None or step not in self.all_steps():
            raise FileNotFoundError(
                f"no checkpoint{'' if step is None else f' at step {step}'} "
                f"under {self.config.checkpoint_dir}")

        def load(name):
            return torch.load(os.path.join(self._dir(step), name),
                              map_location="cpu", weights_only=True, mmap=True)

        def attempt():
            fault_hit("checkpoint_restore", step=step)
            saved = load("state.pt")
            if isinstance(saved, dict) and SHARDED_MARKER in saved:
                return [load(f"rank_{r:05d}.pt") for r in range(saved[SHARDED_MARKER])]
            return saved

        saved = self._attempt("checkpoint_restore", attempt)
        if isinstance(saved, list) or has_dtensor(as_tree(state)):
            filled = assemble(as_tree(state), saved if isinstance(saved, list) else [saved])
            if dataclasses.is_dataclass(state) and not isinstance(state, type):
                filled = dataclasses.replace(state, **filled)
        else:
            filled = restore(state, saved)
        if not with_extra:
            return filled
        path = os.path.join(self._dir(step), "extra.json")
        extra = {}
        if os.path.isfile(path):
            with open(path) as f:
                extra = json.load(f)
        return filled, extra

    # -- lifecycle ---------------------------------------------------------
    def wait(self) -> None:
        """Block until the background write has landed; re-raise its error.

        Deliberately NOT retried: the failed write is consumed, and waiting
        again would turn a missing checkpoint into silent success. The
        caller's save cadence (or the emergency path's committed=False
        report) is the recovery story."""
        fault_hit("checkpoint_wait")
        self._join()

    def _join(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        """Wait for the write, then free the snapshot buffers (a later save
        makes them anew)."""
        self._join()
        self._buffers.clear()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
