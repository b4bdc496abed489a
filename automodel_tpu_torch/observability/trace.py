"""Span/event tracer for the serving stack: host-side, dual-clock.

A copy of `automodel_tpu/observability/trace.py` (host-only Python), kept
here so that the port never imports the JAX package.

Every event carries BOTH clocks: wall time (`time.perf_counter`, exported
in microseconds for Perfetto) and the engine step clock (`step`), because
serving questions come in both flavors: "how many milliseconds did the
step take" and "how many steps did this request wait in the admission
queue". Spans (`ph == "X"`) time engine phases (host plan build vs device
step vs absorb); instants (`ph == "i"`) mark request lifecycle
transitions (submit → admit → first_token → commit → done/expire).

Three export faces:

- `export_chrome(path)` — Chrome trace-event JSON, loadable in Perfetto
  (`ui.perfetto.dev`) or `chrome://tracing`; tracks become named threads.
- `export_jsonl(path)`  — one event object per line, greppable.
- `digest()`            — sha1 over the DETERMINISTIC projection of each
  request's lifecycle (event names + integer payloads, never wall times
  or step indices), so two identical runs produce identical digests, and
  so do the JAX engine and the port on the same requests.

The flight recorder is a bounded ring of the most recent events,
maintained alongside the full buffer; `Observability.flight_dump` writes
it on crash / stall so the last moments before a failure are on disk.

Everything here is plain host Python: nothing reads a device tensor.
"""

from __future__ import annotations

import hashlib
import json
import time


class TraceEvent:
    __slots__ = ("name", "ph", "ts", "dur", "step", "track", "rid", "args")

    def __init__(self, name, ph, ts, dur, step, track, rid, args):
        self.name = name
        self.ph = ph          # "X" complete span | "i" instant
        self.ts = ts          # wall seconds (perf_counter epoch)
        self.dur = dur        # span duration, seconds (0.0 for instants)
        self.step = step      # engine step clock (-1 = not step-aligned)
        self.track = track    # logical thread: engine / replica0 / prefill1 ...
        self.rid = rid        # request id (-1 = not request-scoped)
        self.args = args      # small dict of ints/strs; deterministic values only

    def to_dict(self) -> dict:
        d = {
            "name": self.name, "ph": self.ph,
            "ts_us": round(self.ts * 1e6, 1), "step": self.step,
            "track": self.track, "rid": self.rid,
        }
        if self.ph == "X":
            d["dur_us"] = round(self.dur * 1e6, 1)
        if self.args:
            d["args"] = self.args
        return d


class _SpanCtx:
    """Reusable-shape context manager: records one X event on exit."""

    __slots__ = ("_tr", "_name", "_track", "_step", "_rid", "_args", "_t0")

    def __init__(self, tr, name, track, step, rid, args):
        self._tr = tr
        self._name = name
        self._track = track
        self._step = step
        self._rid = rid
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tr._record(TraceEvent(
            self._name, "X", self._t0, t1 - self._t0,
            self._step, self._track, self._rid, self._args,
        ))
        return False


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class NullTracer:
    """The disabled tracer: every call is a constant-time no-op, so the
    instrumented hot loops cost two attribute lookups when tracing is off
    (nothing device-side ever depends on tracing either way)."""

    enabled = False
    events = ()

    def instant(self, name, *, track="engine", step=-1, rid=-1, **args):
        pass

    def span(self, name, *, track="engine", step=-1, rid=-1, **args):
        return _NULL_CTX


NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer: appends to one unbounded buffer. The
    flight-recorder "ring" is virtual — the last `ring_len` events of the
    buffer, materialized only at dump time — so the hot record path is a
    single list.append (atomic under the online frontend's threading
    model: event loop + one executor thread)."""

    enabled = True

    def __init__(self, *, ring_len: int = 256):
        self.events: list[TraceEvent] = []
        self.ring_len = max(1, int(ring_len))

    @property
    def ring(self) -> list:
        return self.events[-self.ring_len:]

    # -- recording --------------------------------------------------------

    def _record(self, ev: TraceEvent) -> None:
        self.events.append(ev)

    def instant(self, name, *, track="engine", step=-1, rid=-1, **args):
        self._record(TraceEvent(
            name, "i", time.perf_counter(), 0.0, step, track, rid, args
        ))

    def span(self, name, *, track="engine", step=-1, rid=-1, **args):
        return _SpanCtx(self, name, track, step, rid, args)

    # -- export -----------------------------------------------------------

    def _chrome_events(self) -> list[dict]:
        tids = {}
        out = []
        for t in sorted({e.track for e in self.events}):
            tids[t] = len(tids)
            out.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tids[t],
                "args": {"name": t},
            })
        for e in self.events:
            d = {
                "name": e.name, "ph": e.ph, "pid": 0, "tid": tids[e.track],
                "ts": round(e.ts * 1e6, 1),
                "args": {"step": e.step, "rid": e.rid, **e.args},
            }
            if e.ph == "X":
                d["dur"] = round(e.dur * 1e6, 1)
            else:
                d["s"] = "t"
            out.append(d)
        return out

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self._chrome_events(),
                       "displayTimeUnit": "ms"}, f)

    def export_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e.to_dict()) + "\n")

    def dump_ring(self, path: str, *, reason: str = "") -> int:
        """Write the flight-recorder ring as JSONL; returns event count."""
        evs = list(self.ring)
        with open(path, "w") as f:
            f.write(json.dumps({"flight_recorder": True, "reason": reason,
                                "events": len(evs)}) + "\n")
            for e in evs:
                f.write(json.dumps(e.to_dict()) + "\n")
        return len(evs)

    # -- determinism ------------------------------------------------------

    def digest(self) -> str:
        """sha1 over each request's lifecycle projected onto deterministic
        fields only: per-rid ordered (name, sorted int/str args), rids
        sorted. Wall clocks, durations, and step indices are excluded
        (idle turns shift those between otherwise identical runs), and so
        are `stream.*` backpressure edges, which depend on consumer read
        timing rather than the request's lifecycle."""
        by_rid: dict[int, list] = {}
        for e in self.events:
            if e.rid < 0 or e.name.startswith("stream."):
                continue
            by_rid.setdefault(e.rid, []).append(
                (e.name, tuple(sorted(e.args.items())))
            )
        h = hashlib.sha1()
        for rid in sorted(by_rid):
            h.update(repr((rid, by_rid[rid])).encode())
        return h.hexdigest()


def validate_chrome_trace(path: str) -> dict:
    """Check helper: parse a Chrome trace export and check per-track span
    sanity — spans sorted by start must properly nest (every span that
    starts inside an open span must also end inside it) and instants must
    carry timestamps. Returns summary stats; raises on violation."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    spans: dict[int, list] = {}
    n_spans = n_instants = 0
    for e in evs:
        if e.get("ph") == "X":
            n_spans += 1
            spans.setdefault(e["tid"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            )
        elif e.get("ph") == "i":
            n_instants += 1
            if "ts" not in e:
                raise ValueError(f"instant without ts: {e}")
    for tid, ss in spans.items():
        ss.sort()
        stack: list[float] = []
        for t0, t1 in ss:
            while stack and stack[-1] <= t0:
                stack.pop()
            if stack and t1 > stack[-1] + 1e-6:
                raise ValueError(
                    f"tid {tid}: span [{t0}, {t1}] overlaps enclosing span "
                    f"ending at {stack[-1]} without nesting"
                )
            stack.append(t1)
    return {"events": len(evs), "spans": n_spans, "instants": n_instants,
            "tracks": len(spans)}
