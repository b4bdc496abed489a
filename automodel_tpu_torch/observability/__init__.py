"""Observability for the serving stack: host-side, off by default (port of
`automodel_tpu/observability/`).

- metrics.py:  typed central registry (counters / gauges / fixed-bucket
               histograms) + Prometheus text snapshot; every serve stat
               lands here.
- trace.py:    span/event tracer, dual step-clock + wall-clock stamps,
               Chrome-trace (Perfetto) + JSONL export, deterministic
               lifecycle digest, flight-recorder ring.
- timeline.py: per-request phase timelines → TTFT/ITL attribution
               (queue vs prefill vs step vs backpressure).
- profiler.py: `torch.profiler` windowed capture for the train and serve
               paths, the serve step's analytic cost → MFU / bandwidth.

The `Observability` bundle is what the engine threads through: metrics
are ALWAYS live (plain float adds), tracing/profiling/flight recording
only when `ObservabilityConfig.enabled`. Nothing here reads a device
tensor: the tracer records host wall clocks and the registry mutates
Python floats, so turning it on adds no synchronisation to a step.
`http_port` (the `/metrics` endpoint of the online frontend) raises
NotImplementedError: the frontend is ROADMAP.md queue 1 item 16.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

from automodel_tpu_torch.observability.metrics import (
    LATENCY_MS_BUCKETS,
    METRIC_CATALOG,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from automodel_tpu_torch.observability.timeline import (
    RequestTimeline,
    attribute_itl,
    attribute_ttft,
    attribution_summary,
    build_timelines,
)
from automodel_tpu_torch.observability.trace import (
    NULL_TRACER,
    NullTracer,
    TraceEvent,
    Tracer,
    validate_chrome_trace,
)
from automodel_tpu_torch.observability.profiler import (
    Profiler,
    ProfilingConfig,
    ServeProfiler,
    annotate,
    card_peaks,
    step_efficiency,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """`serving.observability` YAML section. Everything defaults off;
    with `enabled: false` the serve path is byte-identical to a build
    without this package."""

    enabled: bool = False
    #: trace export prefix: writes <trace_path>.trace.json (Perfetto) and
    #: <trace_path>.trace.jsonl at the end of the run
    trace_path: Optional[str] = None
    #: bounded ring of recent events dumped on crash/stall/SIGTERM
    flight_recorder_len: int = 256
    flight_recorder_path: Optional[str] = None
    #: [start_step, num_steps] window for a serve-path torch.profiler capture
    profile_window: Optional[tuple] = None
    #: alternatively: capture when a step exceeds this many ms
    itl_spike_ms: Optional[float] = None
    profile_dir: Optional[str] = None
    #: serve a tiny HTTP /metrics + /healthz endpoint from OnlineFrontend
    #: (0 picks an ephemeral port; None disables)
    http_port: Optional[int] = None


class Observability:
    """The per-engine observability bundle.

    `registry` is always a real `MetricsRegistry` — counters cost one
    float add, so they stay on unconditionally and offline/online stats
    mirror onto them. `tracer` is the null tracer unless enabled, so the
    hot serve loop pays two attribute lookups when tracing is off.
    """

    def __init__(self, cfg: ObservabilityConfig | None = None, *,
                 registry: MetricsRegistry | None = None, device="cpu"):
        self.cfg = cfg or ObservabilityConfig()
        if self.cfg.http_port is not None:
            raise NotImplementedError(
                "serving.observability.http_port: the /metrics endpoint belongs to the "
                "online frontend, which is not ported (ROADMAP.md queue 1 item 16)")
        self.enabled = bool(self.cfg.enabled)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = (
            Tracer(ring_len=self.cfg.flight_recorder_len)
            if self.enabled else NULL_TRACER
        )
        self.profiler: ServeProfiler | None = None
        if self.enabled and self.cfg.profile_dir and (
            self.cfg.profile_window or self.cfg.itl_spike_ms is not None
        ):
            self.profiler = ServeProfiler(
                self.cfg.profile_dir,
                window=self.cfg.profile_window,
                itl_spike_ms=self.cfg.itl_spike_ms,
                device=device,
            )

    @classmethod
    def build(cls, cfg: ObservabilityConfig | None, device="cpu") -> "Observability":
        return cls(cfg, device=device)

    # -- step hook --------------------------------------------------------

    def observe_step(self, step_idx: int, step_ms: float) -> None:
        self.registry.histogram(
            "serve_step_ms", "device step wall time (ms)"
        ).observe(step_ms)
        if self.profiler is not None:
            self.profiler.observe(step_idx, step_ms)

    # -- exports ----------------------------------------------------------

    def export(self, prefix: Optional[str] = None) -> dict:
        """Write the Chrome + JSONL trace exports; returns written paths."""
        prefix = prefix or self.cfg.trace_path
        if not self.enabled or not prefix or not self.tracer.events:
            return {}
        d = os.path.dirname(prefix)
        if d:
            os.makedirs(d, exist_ok=True)
        chrome, jsonl = prefix + ".trace.json", prefix + ".trace.jsonl"
        self.tracer.export_chrome(chrome)
        self.tracer.export_jsonl(jsonl)
        return {"chrome": chrome, "jsonl": jsonl}

    def flight_dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Dump the flight-recorder ring (crash / stall / SIGTERM). Safe
        to call from except/finally blocks — never raises."""
        if not self.enabled:
            return None
        try:
            path = path or self.cfg.flight_recorder_path
            if path is None:
                base = self.cfg.trace_path or "flight"
                path = f"{base}.flight.{reason}.jsonl"
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            n = self.tracer.dump_ring(path, reason=reason)
            self.registry.counter(
                "flight_recorder_dumps_total",
                "flight-recorder dumps written (labeled by reason)",
                reason=reason,
            ).inc()
            logger.warning("flight recorder: %d events → %s (%s)",
                           n, path, reason)
            return path
        except Exception:  # pragma: no cover - last-resort path
            logger.exception("flight recorder dump failed")
            return None

    def close(self) -> None:
        if self.profiler is not None:
            self.profiler.close()
        self.export()


#: Shared do-nothing bundle for code paths that never configured one.
#: Its registry is real (process-global default), its tracer is null.
NULL_OBSERVABILITY = Observability(None, registry=default_registry())

__all__ = [
    "LATENCY_MS_BUCKETS",
    "METRIC_CATALOG",
    "NULL_OBSERVABILITY",
    "NULL_TRACER",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullTracer",
    "Observability",
    "ObservabilityConfig",
    "Profiler",
    "ProfilingConfig",
    "RequestTimeline",
    "ServeProfiler",
    "TraceEvent",
    "Tracer",
    "annotate",
    "card_peaks",
    "attribute_itl",
    "attribute_ttft",
    "attribution_summary",
    "build_timelines",
    "default_registry",
    "step_efficiency",
    "validate_chrome_trace",
]
