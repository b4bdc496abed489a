"""Typed `resilience:` recipe section (port of
`automodel_tpu/resilience/config.py`: the same fields and defaults).

YAML shape (all fields optional — the defaults give retries + the
nonfinite fail-fast cap, with rollback snapshots opt-in):

    resilience:
      snapshot_every_steps: 50        # 0 disables rollback snapshots
      max_rollbacks: 3
      loss_spike_factor: 4.0          # null disables spike detection
      max_consecutive_nonfinite: 25   # fail-fast cap (0 disables)
      retry_attempts: 3               # 1 disables checkpoint/remote-IO retry
      retry_base_delay_s: 0.05
      retry_max_delay_s: 2.0
      sigterm_grace_s: 30.0           # emergency-save commit deadline
      transfer_guard: false           # a host sync inside the step raises
      faults:                         # chaos testing (see faults.py)
        - {point: checkpoint_write, call: 1, times: 2}
        - {point: nan_grads, step: 7}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from automodel_tpu_torch.resilience.faults import FaultInjector, FaultSpec
from automodel_tpu_torch.resilience.retry import RetryPolicy
from automodel_tpu_torch.resilience.rollback import RollbackManager


def _as_dict(item: Any) -> dict:
    if hasattr(item, "to_dict"):
        return item.to_dict()
    return dict(item)


@dataclasses.dataclass
class ResilienceConfig:
    enabled: bool = True
    # rollback / divergence recovery
    snapshot_every_steps: int = 0
    max_rollbacks: int = 3
    loss_spike_factor: Optional[float] = None
    spike_window: int = 32
    # nonfinite fail-fast cap (applies even without rollback snapshots)
    max_consecutive_nonfinite: int = 25
    # retry (checkpoint save/restore + safetensors I/O)
    retry_attempts: int = 3
    retry_base_delay_s: float = 0.05
    retry_max_delay_s: float = 2.0
    retry_jitter: float = 0.25
    # preemption
    sigterm_grace_s: float = 30.0
    # debug tripwire: run the train step under
    # torch.cuda.set_sync_debug_mode("error") so an unintended host sync
    # inside the step (an .item(), a device-to-host copy) raises on the card
    transfer_guard: bool = False
    # chaos testing
    faults: Any = dataclasses.field(default_factory=list)

    def retry_policy(self, seed: int = 0) -> Optional[RetryPolicy]:
        if not self.enabled or self.retry_attempts <= 1:
            return None
        return RetryPolicy(
            max_attempts=int(self.retry_attempts),
            base_delay_s=float(self.retry_base_delay_s),
            max_delay_s=float(self.retry_max_delay_s),
            jitter=float(self.retry_jitter),
            seed=int(seed),
        )

    def build_injector(self) -> FaultInjector:
        if not self.enabled:
            # enabled:false disarms the WHOLE layer, faults included — a
            # chaos YAML toggled off for a comparison run must not keep
            # firing (with retry also off, nothing would absorb the fault)
            return FaultInjector(())
        specs = [FaultSpec(**_as_dict(f)) for f in (self.faults or [])]
        return FaultInjector(specs)

    def build_rollback(self) -> Optional[RollbackManager]:
        if not self.enabled or self.snapshot_every_steps <= 0:
            return None
        return RollbackManager(
            every_steps=int(self.snapshot_every_steps),
            max_rollbacks=int(self.max_rollbacks),
            loss_spike_factor=(
                float(self.loss_spike_factor)
                if self.loss_spike_factor is not None else None
            ),
            spike_window=int(self.spike_window),
        )
