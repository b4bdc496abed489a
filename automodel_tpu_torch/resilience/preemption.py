"""Preemption-grade emergency checkpointing helpers.

A copy of `automodel_tpu/resilience/preemption.py`, which is host-only
Python; the port keeps its own copy so that it never imports the JAX
package. SIGTERM (SLURM wall-clock, k8s pod preemption) gives the trainer a
bounded grace window; the emergency path forces a checkpoint save and then
waits for it to COMMIT with a deadline: an async save that has not landed
when the grace window closes is the classic source of "resumed from a
checkpoint older than the one we thought we wrote".
"""

from __future__ import annotations

import logging
import threading
import time

logger = logging.getLogger(__name__)

# floor for the probe window: with an already-expired deadline the wait must
# not block meaningfully, but a 0-second wait would race the daemon thread's
# startup and report an already-committed save as missing
_MIN_PROBE_S = 0.25


def wait_with_deadline(waitable, deadline_s: float) -> bool:
    """Block on `waitable.wait()` for at most `deadline_s` seconds.

    Returns True when the wait completed (the save is committed), False
    when the deadline expired first: the caller should log loudly; the
    checkpoint may still land if the process survives a little longer, but
    it must not be COUNTED on. `deadline_s=None` means no deadline; a
    deadline that is already expired (<= 0) still probes for a short floor
    window but never blocks meaningfully.

    `Checkpointer.wait` has no timeout parameter, so the wait runs in a
    daemon thread; an expired deadline abandons the thread (the process is
    about to die anyway: that is the preemption model).
    """
    if deadline_s is None:
        waitable.wait()
        return True
    done = threading.Event()
    err: list = []

    def _wait():
        try:
            waitable.wait()
        except BaseException as e:  # noqa: BLE001 - surfaced to the caller
            err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=_wait, name="emergency-ckpt-wait", daemon=True)
    t0 = time.monotonic()
    t.start()
    finished = done.wait(max(_MIN_PROBE_S, deadline_s))
    if err:
        raise err[0]
    if not finished:
        logger.error(
            "emergency checkpoint wait exceeded the %.1fs grace deadline "
            "(%.1fs elapsed): the save may not have committed",
            deadline_s, time.monotonic() - t0,
        )
    return finished
