"""Step scheduler: grad-accum batching, epochs, checkpoint/val cadence.

A copy of `automodel_tpu/training/step_scheduler.py`, which is host-only
Python; the port keeps its own copy so that it never imports the JAX
package. The analog of the reference `StepScheduler`
(reference: nemo_automodel/components/training/step_scheduler.py:56,349):
iterates the dataloader in groups of `grad_acc_steps` microbatches, tracks
epoch/step, decides checkpoint/validation cadence, carries a SIGTERM flag
for checkpoint-and-exit, and is checkpointable (state_dict/load_state_dict).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Iterator, Optional


@dataclasses.dataclass
class StepSchedulerConfig:
    grad_acc_steps: int = 1
    ckpt_every_steps: int = 1000
    val_every_steps: Optional[int] = None
    num_epochs: int = 1
    max_steps: Optional[int] = None

    def build(self, dataloader) -> "StepScheduler":
        return StepScheduler(self, dataloader)


class StepScheduler:
    def __init__(self, config: StepSchedulerConfig, dataloader):
        self.config = config
        self.dataloader = dataloader
        self.step = 0
        self.epoch = 0
        self.sigterm_received = False
        self.sigterm_time: Optional[float] = None  # time.monotonic() at signal

    # -- iteration ---------------------------------------------------------
    def __iter__(self) -> Iterator[list]:
        """Yields lists of `grad_acc_steps` microbatches; increments step."""
        for epoch in range(self.epoch, self.config.num_epochs):
            self.epoch = epoch
            if hasattr(self.dataloader, "set_epoch"):
                self.dataloader.set_epoch(epoch)
            group: list = []
            for batch in self.dataloader:
                group.append(batch)
                if len(group) == self.config.grad_acc_steps:
                    self.step += 1
                    yield group
                    group = []
                    if self.done or self.sigterm_received:
                        return
            # drop ragged tail (matches reference semantics)

    @property
    def done(self) -> bool:
        return self.config.max_steps is not None and self.step >= self.config.max_steps

    # -- cadence -------------------------------------------------------------
    @property
    def is_ckpt_step(self) -> bool:
        return self.step > 0 and self.step % self.config.ckpt_every_steps == 0

    @property
    def is_val_step(self) -> bool:
        return (
            self.config.val_every_steps is not None
            and self.step > 0
            and self.step % self.config.val_every_steps == 0
        )

    # -- SIGTERM → checkpoint-and-exit (reference: signal_handler.py:94) ----
    def install_sigterm_handler(self) -> None:
        def handler(signum, frame):
            self.sigterm_received = True
            # stamp the ARRIVAL: the emergency-checkpoint grace deadline
            # counts from when the orchestrator sent the signal (k8s/SLURM
            # semantics), not from when the current step finished
            if self.sigterm_time is None:
                self.sigterm_time = time.monotonic()

        signal.signal(signal.SIGTERM, handler)

    def grace_remaining(self, grace_s: float) -> float:
        """Seconds left of a `grace_s` window that opened at the SIGTERM."""
        if self.sigterm_time is None:
            return grace_s
        return max(0.0, grace_s - (time.monotonic() - self.sigterm_time))

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "epoch": self.epoch}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.epoch = int(state["epoch"])
