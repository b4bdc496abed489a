"""Recipe base class with automatic state tracking (port of
`automodel_tpu/recipes/base_recipe.py`).

Any attribute assigned to the recipe that exposes state_dict /
load_state_dict (the dataloader, the step scheduler, the RNG) is
registered by `__setattr__` and rides the checkpoint's JSON side-car; the
train state (params, optimizer state, step) goes through the
`Checkpointer`, which also keeps the latest, retention and best steps.
Restores copy into the live tensors, which keep their device and dtype.
Under PEFT the train state holds the adapters alone (the frozen base is
no tracked state): a resume rebuilds the base as the first run built it,
then fills the adapters and their optimizer state.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from automodel_tpu_torch.checkpoint import Checkpointer, CheckpointingConfig
from automodel_tpu_torch.config import ConfigNode
from automodel_tpu_torch.recipes.typed_config import RecipeConfig

logger = logging.getLogger(__name__)


class BaseRecipe:
    def __init__(self, cfg: ConfigNode):
        object.__setattr__(self, "_state_tracked", {})
        self.cfg = cfg
        self.typed = RecipeConfig(cfg)
        self.checkpointer: Optional[Checkpointer] = None
        self.train_state = None

    def __setattr__(self, name: str, value: Any) -> None:
        if (
            not name.startswith("_")
            and hasattr(value, "state_dict")
            and hasattr(value, "load_state_dict")
        ):
            self._state_tracked[name] = value
        object.__setattr__(self, name, value)

    # -- checkpoint orchestration ---------------------------------------------
    def save_checkpoint(self, step: int, metrics: dict | None = None) -> bool:
        if self.checkpointer is None or self.train_state is None:
            return False
        extra = {name: obj.state_dict() for name, obj in self._state_tracked.items()}
        return self.checkpointer.save(
            step, self.train_state, extra=extra, metrics=metrics)

    def _restore(self, checkpointer: Checkpointer, step: int | None) -> None:
        self.train_state, extra = checkpointer.restore(
            self.train_state, step=step, with_extra=True)
        for name, st in extra.items():
            if name in self._state_tracked:
                self._state_tracked[name].load_state_dict(st)
            else:
                logger.warning("checkpoint extra state '%s' has no consumer", name)

    def load_checkpoint(self, step: int | None = None) -> bool:
        """Resume from the recipe's own checkpoint_dir; False when it holds
        no committed step."""
        if self.checkpointer is None or self.train_state is None:
            return False
        if self.checkpointer.latest_step() is None:
            return False
        self._restore(self.checkpointer, step)
        logger.info("resumed from checkpoint step %s",
                    step if step is not None else self.checkpointer.latest_step())
        return True

    def restore_from(self, checkpoint_dir: str, step: int | None = None) -> None:
        """Restore from an EXPLICIT checkpoint directory (the
        `checkpoint.restore_from` key), distinct from auto-resume, which
        reads the recipe's own checkpoint_dir."""
        src = CheckpointingConfig(checkpoint_dir=checkpoint_dir, async_save=False).build()
        if src.latest_step() is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
        self._restore(src, step)
        logger.info("restored from %s step %s", checkpoint_dir,
                    step if step is not None else src.latest_step())
