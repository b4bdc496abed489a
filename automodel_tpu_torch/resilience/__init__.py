"""Fault-tolerance layer: fault injection, retry, rollback, preemption
(port of `automodel_tpu/resilience/`).

- faults.py:     deterministic fault-injection harness (chaos tests on CPU)
- retry.py:      exponential backoff + jitter around checkpoint and HF I/O
- rollback.py:   host-offloaded snapshots + NaN/spike detect + bounded
                 rollback
- preemption.py: emergency-checkpoint grace-deadline wait
- config.py:     the typed `resilience:` recipe section
"""

from automodel_tpu_torch.resilience.config import ResilienceConfig
from automodel_tpu_torch.resilience.faults import (
    FaultCrash,
    FaultError,
    FaultInjector,
    FaultSpec,
    fault_hit,
    get_injector,
    injected,
    install_injector,
)
from automodel_tpu_torch.resilience.preemption import wait_with_deadline
from automodel_tpu_torch.resilience.retry import (
    RetryBudgetExhausted,
    RetryPolicy,
    process_index,
    retry_call,
)
from automodel_tpu_torch.resilience.rollback import (
    ResilienceError,
    RollbackManager,
    RollbackStats,
)

__all__ = [
    "FaultCrash",
    "FaultError",
    "FaultInjector",
    "FaultSpec",
    "ResilienceConfig",
    "ResilienceError",
    "RetryBudgetExhausted",
    "RetryPolicy",
    "RollbackManager",
    "RollbackStats",
    "fault_hit",
    "get_injector",
    "injected",
    "install_injector",
    "process_index",
    "retry_call",
    "wait_with_deadline",
]
