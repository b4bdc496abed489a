"""Deterministic fault-injection harness (port of
`automodel_tpu/resilience/faults.py`, host-only Python copied so that the
port never imports the JAX package).

Named failure points are compiled into the I/O, trainer and serving hot
paths as `fault_hit("<point>")` probes that are no-ops until an armed
:class:`FaultInjector` is installed (via recipe config
`resilience.faults: [...]` or programmatically in tests). Firing is a pure
function of (point, hit count, caller step), so a chaos run is exactly
reproducible, and the same schedule fires at the same places in both
packages.

Named points wired into the port:

- ``checkpoint_write``   — Checkpointer.save attempt body
- ``checkpoint_restore`` — Checkpointer.restore attempt body
- ``checkpoint_wait``    — Checkpointer.wait (the async-save barrier)
- ``remote_io``          — HFCheckpointReader tensor reads (safetensors I/O)
- ``hf_export_write``    — save_hf_checkpoint per-shard write
- ``hf_export_commit``   — save_hf_checkpoint just before the atomic publish
- ``hf_export_swap``     — save_hf_checkpoint between the two publish renames
- ``nan_grads``          — train loop, before step k (flag: the recipe
  poisons the params so the step's gradients are non-finite)
- ``sigterm``            — train loop, at step k (flag: the recipe raises
  the scheduler's SIGTERM flag, exercising the emergency-checkpoint path)
- ``serve_step``         — serving loop (`ServingEngine.serve_batch`),
  probed once per loop turn; a ``crash`` here exercises the
  observability flight recorder's crash dump
- ``serve_step_run`` / ``serve_step_run.<track>`` — `ServingEngine.run_step`,
  probed before the step counters

The JAX package's router, KV-transfer, plan-wire and handoff points belong
to tiers the port does not have yet (ROADMAP.md queue 1 items 13 and 16).

Modes: ``error`` raises :class:`FaultError` (a retryable transient),
``crash`` raises :class:`FaultCrash` (a BaseException — simulates the
process dying; retry loops and ``except Exception`` must NOT swallow it),
``flag`` just reports firing (for loop-level points the recipe polls with
:meth:`FaultInjector.check`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from collections import Counter
from typing import Iterable, Optional

logger = logging.getLogger(__name__)


class FaultError(RuntimeError):
    """Injected transient fault — retryable (an IOError stand-in)."""


class FaultCrash(BaseException):
    """Injected hard crash. Deliberately a BaseException: retry policies and
    blanket ``except Exception`` handlers must let it propagate, the way a
    SIGKILL/preemption gives no chance to clean up."""


@dataclasses.dataclass
class FaultSpec:
    """One armed failure. Fires when BOTH gates pass (unset gates pass):

    - ``step``: the caller-reported step equals this value
    - ``call``: the point's hit counter has reached this value (1-based)

    and disarms after ``times`` firings.
    """

    point: str
    step: Optional[int] = None
    call: Optional[int] = None
    times: int = 1
    mode: str = "error"  # "error" | "crash" | "flag"
    fired: int = 0       # runtime state

    def __post_init__(self):
        if self.mode not in ("error", "crash", "flag"):
            raise ValueError(
                f"fault mode must be error|crash|flag, got {self.mode!r}"
            )
        if self.step is None and self.call is None:
            # default: fire from the first hit
            self.call = 1


class FaultInjector:
    """Holds armed FaultSpecs and per-point hit counters."""

    def __init__(self, specs: Iterable = ()):
        self.specs = [
            s if isinstance(s, FaultSpec) else FaultSpec(**dict(s)) for s in specs
        ]
        self.calls: Counter = Counter()
        self.fired: Counter = Counter()

    @property
    def armed(self) -> bool:
        return bool(self.specs)

    def check(self, point: str, step: int | None = None) -> Optional[FaultSpec]:
        """Count one hit at `point`; return the spec that fires, if any.
        Non-raising — loop-level "flag" points poll this directly."""
        self.calls[point] += 1
        if not self.specs:
            return None
        n = self.calls[point]
        for s in self.specs:
            if s.point != point or s.fired >= s.times:
                continue
            if s.step is not None and step != s.step:
                continue
            if s.call is not None and n < s.call:
                continue
            s.fired += 1
            self.fired[point] += 1
            logger.warning(
                "fault injected: point=%s step=%s hit=%d mode=%s",
                point, step, n, s.mode,
            )
            return s
        return None

    def hit(self, point: str, step: int | None = None) -> bool:
        """Count one hit; raise per the armed spec's mode (True for flag)."""
        s = self.check(point, step)
        if s is None:
            return False
        if s.mode == "crash":
            raise FaultCrash(f"injected crash at {point} (step={step})")
        if s.mode == "error":
            raise FaultError(f"injected transient fault at {point} (step={step})")
        return True


# -- global installation -----------------------------------------------------
# The I/O layers (checkpoint, hf_adapter) probe the installed injector so no
# fault plumbing rides their signatures; the default injector is disarmed and
# each probe is then two dict lookups.
_DEFAULT = FaultInjector()
_INSTALLED = _DEFAULT


def install_injector(injector: Optional[FaultInjector]) -> FaultInjector:
    """Install `injector` as the process-wide one (None → disarmed)."""
    global _INSTALLED
    _INSTALLED = injector if injector is not None else _DEFAULT
    return _INSTALLED


def get_injector() -> FaultInjector:
    return _INSTALLED


def fault_hit(point: str, step: int | None = None) -> bool:
    """Probe the installed injector at a named failure point."""
    return _INSTALLED.hit(point, step)


@contextlib.contextmanager
def injected(*specs):
    """Context manager for tests: install an injector armed with `specs`
    (FaultSpec or dicts), restore the disarmed default on exit."""
    prev = _INSTALLED
    inj = install_injector(FaultInjector(specs))
    try:
        yield inj
    finally:
        install_injector(prev)
