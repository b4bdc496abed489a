"""In-trainer auto-recovery: host-offloaded rollback snapshots (port of
`automodel_tpu/resilience/rollback.py`).

A NaN streak or loss spike detected mid-run rolls the train state back to
the last known-good snapshot instead of (a) dying or (b) silently skipping
every remaining update. The snapshot lives in HOST memory, so it costs no
device memory and survives a device-side NaN wavefront. The port copies
the state into host buffers allocated once and reused by every later
snapshot (`utils/host_buffers.py`, page-locked within the budget that the
checkpointer's buffers share); a restore copies them back into the SAME
device tensors in place, so every reference to them (the optimizer's
moments, the engine's or the recipe's views) stays valid.

Recovery semantics (as in the JAX package):

- the data stream and the step counter keep moving FORWARD: the batches
  consumed between the snapshot and the bad step are the "offending data
  window" and are deterministically skipped (they were already drawn from
  the dataloader, whose position is not rewound);
- the model/optimizer state (the fp32 masters, the moments and the
  optimizer's own step counter, hence the LR schedule) rewinds to the
  snapshot: the discarded updates never happened;
- restarts are BOUNDED: exceeding ``max_rollbacks`` raises
  :class:`ResilienceError` naming the first bad step.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from automodel_tpu_torch.observability.metrics import default_registry
from automodel_tpu_torch.utils.host_buffers import HostBuffers, restore

logger = logging.getLogger(__name__)


class ResilienceError(RuntimeError):
    """Unrecoverable divergence / recovery budget exhausted."""


@dataclasses.dataclass
class RollbackStats:
    rollbacks: int = 0
    wasted_steps: int = 0
    snapshots: int = 0


class RollbackManager:
    """Snapshot-every-K + NaN/spike detector + bounded rollback.

    `last_snapshot` holds the newest snapshot's bytes and seconds, and
    `last_restore` the newest restore's seconds."""

    def __init__(
        self,
        *,
        every_steps: int,
        max_rollbacks: int = 3,
        loss_spike_factor: Optional[float] = None,
        spike_window: int = 32,
        min_spike_history: int = 5,
    ):
        if every_steps <= 0:
            raise ValueError(f"every_steps must be > 0, got {every_steps}")
        self.every_steps = int(every_steps)
        self.max_rollbacks = int(max_rollbacks)
        self.loss_spike_factor = loss_spike_factor
        self.min_spike_history = int(min_spike_history)
        self._recent: deque = deque(maxlen=int(spike_window))
        self._buffers = HostBuffers()
        self._snap: Optional[tuple] = None  # (step, host tree, live state)
        self.stats = RollbackStats()
        self.first_bad_step: Optional[int] = None
        self.last_snapshot: dict = {}
        self.last_restore: dict = {}

    # -- snapshots ---------------------------------------------------------
    @property
    def snapshot_step(self) -> Optional[int]:
        return self._snap[0] if self._snap is not None else None

    def due(self, step: int) -> bool:
        return self._snap is None or step % self.every_steps == 0

    def snapshot(self, step: int, state: Any) -> None:
        t0 = time.perf_counter()
        host = self._buffers.snapshot(state)
        self._snap = (int(step), host, state)
        self.stats.snapshots += 1
        self.last_snapshot = {
            "step": int(step), "seconds": time.perf_counter() - t0,
            "bytes": self._buffers.nbytes, "pinned_bytes": self._buffers.pinned_bytes}

    # -- detection ---------------------------------------------------------
    def observe(self, step: int, loss: float, nonfinite: bool) -> Optional[str]:
        """Feed one step's outcome; return a rollback reason or None."""
        if nonfinite or not np.isfinite(loss):
            if self.first_bad_step is None:
                self.first_bad_step = int(step)
            return "nonfinite"
        if (
            self.loss_spike_factor is not None
            and len(self._recent) >= self.min_spike_history
            and loss > self.loss_spike_factor * float(np.median(self._recent))
        ):
            if self.first_bad_step is None:
                self.first_bad_step = int(step)
            return "loss_spike"
        self._recent.append(float(loss))
        return None

    # -- recovery ----------------------------------------------------------
    def rollback(self, step: int, reason: str, state: Any = None) -> tuple:
        """Restore the snapshot into `state` (by default the state the
        snapshot was taken of; its tensors are the live ones, updated in
        place since); returns (snapshot_step, restored_state). Raises
        ResilienceError when the restart budget is exhausted."""
        if self._snap is None:
            raise ResilienceError(
                f"rollback requested at step {step} ({reason}) but no "
                "snapshot was ever taken"
            )
        self.stats.rollbacks += 1
        if self.stats.rollbacks > self.max_rollbacks:
            raise ResilienceError(
                f"rollback budget exhausted: {self.stats.rollbacks - 1} "
                f"rollback(s) already spent, still {reason} at step {step} "
                f"(first bad step: {self.first_bad_step}); the run is "
                "diverged beyond auto-recovery"
            )
        snap_step, host, live = self._snap
        wasted = max(0, int(step) - snap_step)
        self.stats.wasted_steps += wasted
        reg = default_registry()
        reg.counter(
            "resilience_rollbacks_total", "rollback restores performed"
        ).inc()
        reg.counter(
            "resilience_wasted_steps_total",
            "train steps redone after rollback",
        ).inc(wasted)
        logger.warning(
            "rolling back: %s at step %d → restoring snapshot from step %d "
            "(%d update(s) discarded; data window is skipped, the stream "
            "continues forward)",
            reason, step, snap_step, step - snap_step,
        )
        t0 = time.perf_counter()
        restored = restore(live if state is None else state, host)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.last_restore = {"step": int(step), "seconds": time.perf_counter() - t0}
        return snap_step, restored
