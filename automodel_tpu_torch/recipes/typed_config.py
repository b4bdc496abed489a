"""Typed recipe-config facade (port of the sections of
`automodel_tpu/recipes/typed_config.py` that the training and serving
recipes read): lazy coercion of raw ConfigNode sections into the port's
dataclass configs. Unknown keys inside a section raise, as in the JAX
package.

The serving sections the port does not run yet (`mesh`, `disaggregation`,
`online`, `speculative`, `resilience`) are parsed into copies of the JAX
package's dataclasses, fields and defaults alone, so a YAML may carry them
at their defaults; `refuse_unported_serving` raises for any that asks for
more than the single-replica offline engine. `serving.observability`, the
top-level `resilience` and `profiling` sections run
(`observability/`, `resilience/`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from automodel_tpu_torch.config import ConfigNode
from automodel_tpu_torch.observability import ObservabilityConfig


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


# -- the serving sections' fields, as the JAX package declares them ----------
@dataclasses.dataclass(frozen=True)
class ServeMeshConfig:
    """`serving.mesh` (JAX `serving/router.py`)."""

    replicas: int = 1
    tp: int = 1
    ep: int = 1


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """`serving.disaggregation.autoscale` (JAX `serving/router.py`)."""

    enabled: bool = False
    grow_ratio: float = 4.0
    shrink_ratio: float = 1.0
    sustain: int = 8
    cooldown: int = 32
    min_decode: int = 1


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """`serving.disaggregation` (JAX `serving/router.py`)."""

    enabled: bool = False
    prefill_replicas: int = 1
    decode_replicas: int = 1
    transfer_pages: int = 8
    prefill_token_budget: Optional[int] = None
    autoscale: AutoscaleConfig = AutoscaleConfig()


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """`serving.online` (JAX `serving/frontend.py`); the recipe itself
    reads `enabled` and `deadline_steps`."""

    stream_buffer: int = 32
    max_waiting: Optional[int] = None
    shed_deadlines: bool = True
    shed_safety: float = 1.0
    itl_decay: float = 0.9
    idle_sleep_s: float = 0.001
    drain: bool = True


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """`serving.speculative` (JAX `speculative/serve_draft.py`)."""

    enabled: bool = False
    draft_source: str = "ngram"
    draft_len: int = 4
    acceptance: str = "greedy"
    adaptive: bool = False
    adaptive_threshold: float = 0.5
    adaptive_decay: float = 0.5
    ngram_max: int = 3
    ngram_min: int = 1
    ngram_window: int = 1024


@dataclasses.dataclass(frozen=True)
class ServeResilienceConfig:
    """`serving.resilience` (JAX `serving/resilience.py`): replica failure
    handling, which the single-replica offline branch ignores."""

    enabled: bool = True
    degrade: bool = True
    degraded_failures: int = 3
    transfer_retry_attempts: int = 3
    transfer_retry_base_delay_s: float = 0.005
    transfer_retry_max_delay_s: float = 0.25
    transfer_retry_jitter: float = 0.25
    retry_seed: int = 0
    ack_every_steps: int = 0
    ack_timeout_ms: int = 10_000


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
    def mesh(self):
        """`distributed` -> MeshConfig (JAX `:60`); unknown keys are ignored,
        as the JAX package ignores them."""
        from automodel_tpu_torch.distributed import MeshConfig

        key = ("distributed", "MeshConfig")
        if key not in self._cache:
            self._cache[key] = MeshConfig.from_config(self.raw.get("distributed"))
        return self._cache[key]

    @property
    def lr_scheduler(self):
        from automodel_tpu_torch.optim import LRSchedulerConfig

        return self._section("lr_scheduler", LRSchedulerConfig)

    @property
    def dataloader(self):
        from automodel_tpu_torch.datasets.loader import DataloaderConfig

        return self._section("dataloader", DataloaderConfig)

    @property
    def checkpoint(self):
        """`checkpoint` -> CheckpointingConfig; the recipe reads
        `restore_from` and `restore_step` itself."""
        from automodel_tpu_torch.checkpoint import CheckpointingConfig

        return self._section(
            "checkpoint", CheckpointingConfig,
            allow=("restore_from", "restore_step"),
        )

    @property
    def step_scheduler(self):
        from automodel_tpu_torch.training.step_scheduler import StepSchedulerConfig

        return self._section("step_scheduler", StepSchedulerConfig)

    @property
    def qat(self):
        from automodel_tpu_torch.ops.quant import QATConfig

        return self._section("qat", QATConfig)

    @property
    def resilience(self):
        from automodel_tpu_torch.resilience.config import ResilienceConfig

        return self._section("resilience", ResilienceConfig)

    @property
    def profiling(self):
        from automodel_tpu_torch.observability.profiler import ProfilingConfig

        return self._section("profiling", ProfilingConfig)

    @property
    def peft(self):
        """`peft` -> LoRAConfig, or None without the section; a YAML list of
        `target_modules` becomes the config's tuple."""
        node = self.raw.get("peft")
        if node is None:
            return None
        from automodel_tpu_torch.peft.lora import LoRAConfig

        key = ("peft", "LoRAConfig")
        if key not in self._cache:
            cfg = dataclass_from_node(LoRAConfig, node)
            if "target_modules" in node:
                cfg = dataclasses.replace(
                    cfg, target_modules=tuple(node.get("target_modules")))
            self._cache[key] = cfg
        return self._cache[key]

    @property
    def packing(self):
        """`packing` -> PackedSequenceConfig, or None without the section."""
        if self.raw.get("packing") is None:
            return None
        from automodel_tpu_torch.datasets.packing import PackedSequenceConfig

        return self._section("packing", PackedSequenceConfig)

    # -- serving ---------------------------------------------------------------
    def _serving(self, name: str, cls, allow: tuple = (), **extra):
        key = ("serving." + name, cls.__name__)
        if key not in self._cache:
            node = self.raw.get("serving")
            sub = node.get(name) if node is not None else None
            self._cache[key] = dataclass_from_node(cls, sub, allow=allow, **extra)
        return self._cache[key]

    @property
    def serving_prefix_cache(self):
        """`serving.prefix_cache` -> PrefixCacheConfig (disabled when absent)."""
        from automodel_tpu_torch.serving.prefix_cache import PrefixCacheConfig

        return self._serving("prefix_cache", PrefixCacheConfig)

    @property
    def serving_mesh(self) -> ServeMeshConfig:
        return self._serving("mesh", ServeMeshConfig)

    @property
    def serving_disaggregation(self) -> DisaggConfig:
        sub = self.raw.get("serving.disaggregation.autoscale")
        extra = {} if sub is None else {"autoscale": dataclass_from_node(AutoscaleConfig, sub)}
        return self._serving("disaggregation", DisaggConfig, **extra)

    @property
    def serving_online(self) -> FrontendConfig:
        return self._serving("online", FrontendConfig, allow=("enabled", "deadline_steps"))

    @property
    def serving_speculative(self) -> SpeculativeConfig:
        return self._serving("speculative", SpeculativeConfig)

    @property
    def serving_resilience(self) -> ServeResilienceConfig:
        return self._serving("resilience", ServeResilienceConfig)

    @property
    def serving_observability(self) -> ObservabilityConfig:
        window = self.raw.get("serving.observability.profile_window")
        extra = {} if window is None else {"profile_window": tuple(window)}
        return self._serving("observability", ObservabilityConfig, **extra)

    def refuse_unported_serving(self) -> None:
        """The port serves through the single-replica offline engine alone.
        A serving section that asks for more raises NotImplementedError
        naming the section and its ROADMAP.md queue 1 item (the
        observability section's `http_port` raises where the engine builds
        its bundle); `serving.resilience` is parsed and, as on the JAX
        package's single-replica branch, has no effect."""
        mesh = self.serving_mesh
        if (mesh.replicas, mesh.tp, mesh.ep) != (1, 1, 1):
            raise NotImplementedError(
                f"serving.mesh={dataclasses.asdict(mesh)}: replicated and sharded "
                "serving are not ported (ROADMAP.md queue 1 item 13)")
        _ = self.serving_online, self.serving_resilience  # parsed: unknown keys raise
        wants = (
            ("disaggregation", self.serving_disaggregation.enabled, 16),
            ("online", bool(self.raw.get("serving.online.enabled", False)), 16),
            ("speculative", self.serving_speculative.enabled, 15),
        )
        for name, enabled, item in wants:
            if enabled:
                raise NotImplementedError(
                    f"serving.{name}.enabled: not ported (ROADMAP.md queue 1 item {item})")
        if self.serving_observability.http_port is not None:
            raise NotImplementedError(
                "serving.observability.http_port: the /metrics endpoint belongs to the "
                "online frontend, which is not ported (ROADMAP.md queue 1 item 16)")
