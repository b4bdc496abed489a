"""Typed recipe-config facade (port of the sections of
`automodel_tpu/recipes/typed_config.py` that the training recipe reads):
lazy coercion of raw ConfigNode sections into the port's dataclass configs.
Unknown keys inside a section raise, as in the JAX package."""

from __future__ import annotations

import dataclasses

from automodel_tpu_torch.config import ConfigNode


def dataclass_from_node(cls, node, *, strict: bool = True, allow: tuple = (), **extra):
    """ConfigNode/dict section -> dataclass instance. With `strict`, keys the
    dataclass does not declare raise instead of being dropped (`allow` lists
    section keys the recipe reads directly). `extra` keys win over the
    node's raw values."""
    kwargs = dict(extra)
    names = {f.name for f in dataclasses.fields(cls)}
    if node is not None:
        keys = list(node.keys() if hasattr(node, "keys") else [])
        unknown = [k for k in keys if k not in names and k not in allow]
        if strict and unknown:
            raise ValueError(
                f"unknown key(s) {unknown} for {cls.__name__} "
                f"(valid: {sorted(names)})"
            )
        for f in dataclasses.fields(cls):
            if f.name in node and f.name not in kwargs:
                kwargs[f.name] = node.get(f.name)
    return cls(**kwargs)


class RecipeConfig:
    """Lazy typed view over a recipe's raw ConfigNode."""

    def __init__(self, raw: ConfigNode):
        self.raw = raw
        self._cache: dict = {}

    def _section(self, name: str, cls, required: bool = False, allow: tuple = (), **extra):
        key = (name, cls.__name__)
        if key not in self._cache:
            node = self.raw.get(name)
            if node is None and required:
                raise ValueError(f"config section '{name}' is required")
            self._cache[key] = dataclass_from_node(cls, node, allow=allow, **extra)
        return self._cache[key]

    @property
    def optimizer(self):
        from automodel_tpu_torch.optim import OptimizerConfig

        return self._section("optimizer", OptimizerConfig)

    @property
    def lr_scheduler(self):
        from automodel_tpu_torch.optim import LRSchedulerConfig

        return self._section("lr_scheduler", LRSchedulerConfig)

    @property
    def dataloader(self):
        from automodel_tpu_torch.datasets.loader import DataloaderConfig

        return self._section("dataloader", DataloaderConfig)

    @property
    def step_scheduler(self):
        from automodel_tpu_torch.training.step_scheduler import StepSchedulerConfig

        return self._section("step_scheduler", StepSchedulerConfig)
