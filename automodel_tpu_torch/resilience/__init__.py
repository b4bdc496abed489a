"""The parts of the JAX package's resilience layer the training recipe uses:
the bounded wait of the SIGTERM path. The `resilience` config section
(faults, retries, rollback) is not ported; the recipes refuse it."""

from automodel_tpu_torch.resilience.preemption import wait_with_deadline

__all__ = ["wait_with_deadline"]
