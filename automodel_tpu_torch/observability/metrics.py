"""Typed central metrics registry: counters, gauges, fixed-bucket histograms.

A copy of `automodel_tpu/observability/metrics.py` (host-only Python),
kept here so that the port never imports the JAX package; the catalog is
the JAX package's, name for name.

Every number the serving stack emits (engine `serve_batch` stats,
resilience retry/rollback totals) lands on ONE registry, so a single
snapshot answers "what has this process done so far". Two export faces:

- `snapshot()`   — a flat dict (deterministic key order) for JSONL sinks
                   and test assertions.
- `snapshot_prometheus()` — Prometheus text exposition format.

Histograms use FIXED bucket boundaries declared at registration time
(default `LATENCY_MS_BUCKETS`), never adaptive, so two identical runs
produce byte-identical snapshots.

Everything here is host-side Python over plain floats: nothing reads a
device tensor.
"""

from __future__ import annotations

import bisect
import threading

#: Fixed histogram boundaries for latencies in milliseconds. Deterministic
#: by construction: the same observations always land in the same buckets.
LATENCY_MS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
    50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
)

_KINDS = ("counter", "gauge", "histogram")


class Counter:
    """Monotonic total. `inc` only; decrementing is a bug, not a feature."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Point-in-time value; set/inc/dec freely."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-boundary cumulative histogram (Prometheus bucket semantics:
    bucket i counts observations <= bounds[i], with a +Inf overflow)."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds=LATENCY_MS_BUCKETS) -> None:
        b = tuple(float(x) for x in bounds)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"histogram bounds must strictly increase: {b}")
        self.bounds = b
        self.counts = [0] * (len(b) + 1)  # last slot is +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def percentile(self, q: float) -> float:
        """Deterministic bucket-upper-bound estimate of the q-quantile
        (q in [0, 1]). Overflow observations report the top boundary."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]

    def snapshot(self) -> dict:
        cum, out = 0, []
        for c in self.counts[:-1]:
            cum += c
            out.append(cum)
        return {
            "count": self.count,
            "sum": self.sum,
            "bounds": list(self.bounds),
            "cumulative": out,  # per-bound cumulative counts (le semantics)
        }


def _series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    body = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{body}}}"


class _Family:
    __slots__ = ("kind", "help", "series", "bounds")

    def __init__(self, kind: str, help_: str, bounds=None):
        self.kind = kind
        self.help = help_
        self.series: dict[tuple, object] = {}  # sorted label items -> instrument
        self.bounds = bounds


class MetricsRegistry:
    """Process-local named-metric registry. Thread-safe registration (the
    online frontend's executor thread and the event loop both touch it);
    individual increments are plain float ops under the GIL."""

    def __init__(self) -> None:
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    # -- registration -----------------------------------------------------

    def _get(self, name: str, kind: str, help_: str, labels: dict,
             bounds=None):
        key = tuple(sorted(labels.items()))
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.setdefault(
                    name, _Family(kind, help_, bounds)
                )
        if fam.kind != kind:
            raise TypeError(
                f"metric {name!r} is a {fam.kind}, requested as {kind}"
            )
        inst = fam.series.get(key)
        if inst is None:
            with self._lock:
                if key not in fam.series:
                    if kind == "counter":
                        inst = Counter()
                    elif kind == "gauge":
                        inst = Gauge()
                    else:
                        inst = Histogram(fam.bounds or LATENCY_MS_BUCKETS)
                    fam.series[key] = inst
                inst = fam.series[key]
        return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "", *,
                  buckets=LATENCY_MS_BUCKETS, **labels) -> Histogram:
        return self._get(name, "histogram", help, labels, bounds=buckets)

    def register_catalog(self, catalog=None) -> None:
        """Pre-register every cataloged metric (zero-valued) so snapshots
        expose the full schema even before traffic arrives."""
        for name, kind, help_ in (catalog or METRIC_CATALOG):
            self._get(name, kind, help_, {})

    # -- export -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Flat deterministic dict: scalar metrics map to their value,
        histograms to their bucket snapshot dict."""
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            for key in sorted(fam.series):
                inst = fam.series[key]
                skey = _series_key(name, dict(key))
                if fam.kind == "histogram":
                    out[skey] = inst.snapshot()
                else:
                    out[skey] = inst.value
        return out

    def snapshot_prometheus(self) -> str:
        """Prometheus text exposition format, one family per block."""
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam.series):
                inst = fam.series[key]
                labels = dict(key)
                if fam.kind != "histogram":
                    lines.append(
                        f"{_series_key(name, labels)} {_fmt(inst.value)}"
                    )
                    continue
                cum = 0
                for bound, c in zip(inst.bounds, inst.counts):
                    cum += c
                    lines.append(
                        f"{_series_key(name + '_bucket', {**labels, 'le': _fmt(bound)})}"
                        f" {cum}"
                    )
                cum += inst.counts[-1]
                lines.append(
                    f"{_series_key(name + '_bucket', {**labels, 'le': '+Inf'})}"
                    f" {cum}"
                )
                lines.append(f"{_series_key(name + '_sum', labels)} {_fmt(inst.sum)}")
                lines.append(f"{_series_key(name + '_count', labels)} {cum}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return format(v, ".10g")


#: Every metric the stack emits: the JAX package's catalog, name for name
#: (series of tiers the port does not run yet stay at zero).
METRIC_CATALOG = (
    # engine step loop (incremented inside run_step / absorb)
    ("serve_steps_total", "counter", "jitted serve steps executed"),
    ("serve_plan_tokens_total", "counter", "tokens fed through step plans"),
    ("serve_plan_samples_total", "counter", "sample rows active in step plans"),
    ("serve_step_ms", "histogram", "device step wall time (ms)"),
    # engine serve_batch outcomes
    ("serve_new_tokens_total", "counter", "tokens committed to requests"),
    ("serve_requests_total", "counter", "requests finished by the engine"),
    ("serve_preemptions_total", "counter", "requests preempted and requeued"),
    ("serve_timed_out_total", "counter", "requests expired at their deadline"),
    ("serve_cancelled_total", "counter", "requests cancelled mid-flight"),
    ("serve_free_pages", "gauge", "KV pages currently free"),
    ("serve_compiled_signatures", "gauge", "jit cache entries for the serve step"),
    # prefix cache
    ("serve_prefix_hits_total", "counter", "admissions that matched a cached prefix"),
    ("serve_prefill_skipped_tokens_total", "counter", "prompt tokens skipped via prefix reuse"),
    ("serve_cow_copies_total", "counter", "copy-on-write page copies"),
    # speculative decoding
    ("serve_spec_drafted_total", "counter", "draft tokens proposed"),
    ("serve_spec_accepted_total", "counter", "draft tokens accepted"),
    ("serve_spec_rolled_back_total", "counter", "draft tokens rolled back"),
    ("serve_spec_steps_total", "counter", "verify steps run"),
    # disaggregation + KV movement
    ("serve_handoffs_total", "counter", "prefill→decode handoffs admitted"),
    ("serve_handoff_pages_moved_total", "counter", "handoff pages moved between pools"),
    ("serve_handoff_pages_spliced_total", "counter", "handoff pages spliced via decode-side prefix match"),
    ("serve_handoff_expired_total", "counter", "handoffs expired before decode admission"),
    ("serve_kv_transfer_pages_total", "counter", "KV pages shipped by transfers"),
    ("serve_kv_transfer_chunks_total", "counter", "fixed-size transfer chunks issued"),
    ("serve_kv_transfer_bytes_total", "counter", "KV transfer wire bytes (quantized pools ship int8+scales)"),
    # online frontend
    ("frontend_submitted_total", "counter", "requests submitted to the frontend"),
    ("frontend_finished_total", "counter", "streams finished (any reason)"),
    ("frontend_shed_total", "counter", "requests shed (labeled by reason)"),
    ("frontend_rejected_total", "counter", "submissions rejected at admission"),
    ("frontend_cancelled_total", "counter", "streams cancelled by the caller"),
    ("frontend_running", "gauge", "requests resident in slots"),
    ("frontend_waiting", "gauge", "requests queued for admission"),
    ("frontend_paused", "gauge", "slots paused for stream backpressure"),
    ("frontend_itl_ewma_ms", "gauge", "decayed inter-token latency estimate (ms)"),
    ("request_ttft_ms", "histogram", "time to first token (ms)"),
    ("request_itl_ms", "histogram", "inter-token latency (ms)"),
    # serving resilience (serving/resilience.py: health board, recovery,
    # degraded routing — all host-side)
    ("serve_replica_failures_total", "counter", "replica deaths observed (labeled by class)"),
    ("serve_requests_recovered_total", "counter", "requests requeued onto survivors after a replica death"),
    ("serve_recovery_reprefill_tokens_total", "counter", "known tokens requeued for re-prefill by failure recovery"),
    ("serve_transfer_retries_total", "counter", "KV transfer / plan-wire send retry attempts"),
    ("serve_degraded_mode", "gauge", "1 while disagg routing is collapsed to monolithic"),
    # resilience
    ("resilience_retries_total", "counter", "I/O retries attempted"),
    ("resilience_rollbacks_total", "counter", "rollback restores performed"),
    ("resilience_wasted_steps_total", "counter", "train steps redone after rollback"),
    # observability itself
    ("flight_recorder_dumps_total", "counter", "flight-recorder dumps written (labeled by reason)"),
    # bench environment probes
    ("bench_probe_failures_total", "counter", "failed accelerator probes (labeled by reason)"),
)

#: Process-global registry for components without an engine in hand
#: (resilience counters, bench probes). Engine/router/frontend metrics use
#: the per-`Observability` registry instead so tests stay hermetic.
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
