"""Training utilities (port of the part of `automodel_tpu/training/utils.py`
the recipes call): `GCController`, Python's garbage collection on a fixed
step cadence. Automatic generation-2 collections in the middle of a step
are host jitter that shows as device idle time; the controller collects
and freezes the warm state, turns automatic collection off, collects every
`every_steps` steps, and `close()` turns it back on (the recipe calls it on
every exit path). The JAX module's EMA, NEFTune and Timers have no caller
in the recipes and are not ported.
"""

from __future__ import annotations

import gc


class GCController:
    def __init__(self, every_steps: int = 100, enabled: bool = True):
        self.every_steps = every_steps
        self.enabled = enabled
        if enabled:
            gc.collect()
            gc.freeze()
            gc.disable()

    def step(self, step_num: int) -> None:
        if self.enabled and self.every_steps > 0 and step_num % self.every_steps == 0:
            gc.collect()

    def close(self) -> None:
        if self.enabled:
            gc.enable()
            gc.unfreeze()
            self.enabled = False
