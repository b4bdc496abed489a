"""Retry with exponential backoff + deterministic jitter (port of
`automodel_tpu/resilience/retry.py`, host-only Python copied so that the
port never imports the JAX package).

Wraps the I/O surfaces (checkpoint save/restore, HF-safetensors
reads/writes) so one flaky read or write no longer kills a run. Budget
exhaustion fails LOUDLY (:class:`RetryBudgetExhausted` chains the last
error): a silent downgrade to "checkpoint skipped" is exactly the failure
mode this layer exists to remove. Every attempt is observable through the
``on_attempt`` callback (the recipe counts them through MetricLogger).

Jitter is deterministic per (seed, point): chaos tests replay the exact
same delay schedule, and a fleet of processes desynchronizes retries
because each folds its rank (`process_index`) into the seed.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
import zlib
from typing import Callable, Optional

import torch

from automodel_tpu_torch.observability.metrics import default_registry

logger = logging.getLogger(__name__)


def process_index() -> int:
    """This process's rank in the `torch.distributed` group when one is
    initialised, else 0: the retry jitter's per-process seed."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def _count_retry() -> None:
    # the central registry is how dashboards see retry pressure
    default_registry().counter(
        "resilience_retries_total", "I/O retries attempted"
    ).inc()


class RetryBudgetExhausted(RuntimeError):
    """All attempts at a retried operation failed."""

    def __init__(self, point: str, attempts: int, last: BaseException):
        super().__init__(
            f"retry budget exhausted at {point!r}: {attempts} attempt(s), "
            f"last error: {last!r}"
        )
        self.point = point
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3        # total attempts (1 = no retry)
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.25         # fraction of the delay added, in [0, jitter]
    seed: int = 0

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Backoff before attempt `attempt`+1 (attempt is 1-based)."""
        d = min(self.max_delay_s, self.base_delay_s * (2.0 ** (attempt - 1)))
        return d * (1.0 + self.jitter * rng.random())

    def rng_for(self, point: str) -> random.Random:
        # crc32, not hash(): str hashing is salted per process and would
        # break the deterministic replay contract
        return random.Random(zlib.crc32(point.encode()) ^ (self.seed & 0xFFFFFFFF))


def retry_call(
    fn: Callable,
    *args,
    policy: Optional[RetryPolicy],
    point: str = "",
    on_attempt: Optional[Callable] = None,  # (point, attempt, exc, delay_s)
    retry_on: tuple = (Exception,),
    no_retry: tuple = (),
    sleep: Callable = time.sleep,
    **kwargs,
):
    """Call `fn(*args, **kwargs)`, retrying `retry_on` failures under
    `policy` (None → one bare attempt, errors propagate untouched).
    `no_retry` lists DETERMINISTIC errors that re-raise untouched even when
    `retry_on` would match them (e.g. FileNotFoundError: retrying cannot
    make a missing checkpoint appear, and callers' except clauses rely on
    the original type). FaultCrash (and any BaseException outside
    `retry_on`) propagates immediately — a crash is not a transient."""
    if policy is None:
        return fn(*args, **kwargs)
    rng = policy.rng_for(point)
    attempts = max(1, policy.max_attempts)
    last: BaseException | None = None
    for attempt in range(1, attempts + 1):
        try:
            return fn(*args, **kwargs)
        except no_retry:
            raise
        except retry_on as e:  # noqa: PERF203 — retry loop by design
            last = e
            _count_retry()
            delay = policy.delay(attempt, rng) if attempt < attempts else 0.0
            if on_attempt is not None:
                on_attempt(point, attempt, e, delay)
            logger.warning(
                "attempt %d/%d at %s failed: %r%s",
                attempt, attempts, point or fn, e,
                f" — retrying in {delay:.3f}s" if attempt < attempts else "",
            )
            if attempt >= attempts:
                break
            sleep(delay)
    raise RetryBudgetExhausted(point or repr(fn), attempts, last) from last
