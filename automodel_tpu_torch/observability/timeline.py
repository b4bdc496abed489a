"""Per-request phase timelines reconstructed from trace events.

A copy of `automodel_tpu/observability/timeline.py` (host-only Python),
kept here so that the port never imports the JAX package. The single
engine emits no handoff markers (disaggregation is not ported), so its
`transfer` phase is 0.

Answers the question the raw stats cannot: *where did this request's TTFT
go?* The tracer records lifecycle markers (submit → admit → handoff
extract → handoff admit → first_token) and engine `step.run` spans; this
module partitions each request's [submit, first_token] wall interval at
those marker boundaries, so the phase components SUM TO TTFT EXACTLY by
construction:

    queue      submit → first admission (waiting for a slot)
    prefill    admission → handoff extract (disagg) or the committing
               step's start (monolithic): prompt chunking time
    transfer   handoff extract → decode-side admission (disagg KV move)
    step       remainder up to first_token: the device step(s) that
               committed the first token, plus absorb
    backpressure  stream-pause overlap, subtracted from its enclosing
               phase and reported separately

ITL attribution splits each inter-commit gap into step time (overlap with
`step.run` spans), backpressure (stream-pause overlap), and scheduling
remainder. `attribution_summary` picks the median-TTFT request so the
reported components sum to the p50 the bench headline already prints.
"""

from __future__ import annotations

import dataclasses

#: lifecycle instants consumed here; emitters live in serving/*.
SUBMIT_EVENTS = ("frontend.submit", "request.submit")


@dataclasses.dataclass
class RequestTimeline:
    rid: int
    t_submit: float | None = None
    t_admit: float | None = None          # first admission anywhere
    t_extract: float | None = None        # disagg: prefill-side extraction
    t_handoff_admit: float | None = None  # disagg: decode-side admission
    t_first: float | None = None          # first committed token
    t_done: float | None = None
    finish_reason: str | None = None
    commits: list = dataclasses.field(default_factory=list)  # (ts, n_tokens)
    pauses: list = dataclasses.field(default_factory=list)   # (t0, t1)

    @property
    def ttft_s(self) -> float | None:
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit


def build_timelines(events) -> dict[int, RequestTimeline]:
    """Fold the event list into per-rid timelines. Only the FIRST
    occurrence of each marker counts (preempted requests re-admit; the
    original admission is what TTFT attribution wants)."""
    tls: dict[int, RequestTimeline] = {}
    open_pause: dict[int, float] = {}
    for e in events:
        if e.rid < 0:
            continue
        tl = tls.get(e.rid)
        if tl is None:
            tl = tls[e.rid] = RequestTimeline(rid=e.rid)
        n = e.name
        if n in SUBMIT_EVENTS:
            if tl.t_submit is None:
                tl.t_submit = e.ts
        elif n == "request.admit":
            if tl.t_admit is None:
                tl.t_admit = e.ts
        elif n == "request.handoff_extract":
            if tl.t_extract is None:
                tl.t_extract = e.ts
        elif n == "request.handoff_admit":
            if tl.t_handoff_admit is None:
                tl.t_handoff_admit = e.ts
        elif n == "request.first_token":
            if tl.t_first is None:
                tl.t_first = e.ts
        elif n == "request.commit":
            tl.commits.append((e.ts, int(e.args.get("n", 1))))
        elif n in ("request.done", "request.shed", "request.cancel",
                   "request.expire"):
            if tl.t_done is None:
                tl.t_done = e.ts
                tl.finish_reason = e.args.get("reason", n.split(".")[1])
        elif n == "stream.pause":
            open_pause.setdefault(e.rid, e.ts)
        elif n == "stream.resume":
            t0 = open_pause.pop(e.rid, None)
            if t0 is not None:
                tl.pauses.append((t0, e.ts))
    return tls


def _step_spans(events) -> list:
    return sorted(
        (e.ts, e.ts + e.dur)
        for e in events
        if e.ph == "X" and e.name == "step.run"
    )


def _overlap(t0: float, t1: float, intervals) -> float:
    s = 0.0
    for a, b in intervals:
        s += max(0.0, min(t1, b) - max(t0, a))
    return s


def attribute_ttft(tl: RequestTimeline, step_spans) -> dict | None:
    """Partition [submit, first_token] at the marker boundaries. Returns
    ms components summing exactly to ttft_ms, or None if the request
    never produced a token."""
    if tl.t_submit is None or tl.t_first is None:
        return None
    t0 = tl.t_submit
    t_admit = min(max(tl.t_admit if tl.t_admit is not None else t0, t0),
                  tl.t_first)
    disagg = tl.t_extract is not None and tl.t_handoff_admit is not None
    if disagg:
        tx0 = min(max(tl.t_extract, t_admit), tl.t_first)
        tx1 = min(max(tl.t_handoff_admit, tx0), tl.t_first)
        step_start = tx1
    else:
        tx0 = tx1 = None
        # the committing step: last step.run span ending at/before t_first
        # that started after admission; its start splits prefill from step
        step_start = t_admit
        for a, b in step_spans:
            if a >= t_admit and b <= tl.t_first + 1e-9:
                step_start = max(step_start, a)
    phases = {
        "queue": (t0, t_admit),
        "prefill": (t_admit, tx0 if disagg else step_start),
        "transfer": (tx0, tx1) if disagg else None,
        "step": (tx1 if disagg else step_start, tl.t_first),
    }
    out = {}
    backpressure = 0.0
    for name, iv in phases.items():
        if iv is None:
            out[f"{name}_ms"] = 0.0
            continue
        a, b = iv
        pause = _overlap(a, b, tl.pauses)
        backpressure += pause
        out[f"{name}_ms"] = (b - a - pause) * 1e3
    out["backpressure_ms"] = backpressure * 1e3
    out["ttft_ms"] = (tl.t_first - t0) * 1e3
    return out


def attribute_itl(tl: RequestTimeline, step_spans) -> dict | None:
    """Split the inter-commit gaps into step / backpressure / scheduling
    components (means over the request's gaps, in ms)."""
    ts = sorted(t for t, _ in tl.commits)
    if len(ts) < 2:
        return None
    step = bp = total = 0.0
    for a, b in zip(ts, ts[1:]):
        p = _overlap(a, b, tl.pauses)
        s = min(_overlap(a, b, step_spans), b - a - p)
        bp += p
        step += s
        total += b - a
    n = len(ts) - 1
    return {
        "gaps": n,
        "itl_mean_ms": total / n * 1e3,
        "step_ms": step / n * 1e3,
        "backpressure_ms": bp / n * 1e3,
        "sched_ms": (total - step - bp) / n * 1e3,
    }


def attribution_summary(events) -> dict:
    """The bench-headline block: TTFT attribution for the MEDIAN-TTFT
    request (components sum to the reported p50 exactly) plus mean ITL
    attribution over every inter-commit gap."""
    tls = build_timelines(events)
    spans = _step_spans(events)
    ttfts = sorted(
        (tl.ttft_s, rid) for rid, tl in tls.items() if tl.ttft_s is not None
    )
    out = {"requests": len(tls), "with_first_token": len(ttfts)}
    if ttfts:
        _, med_rid = ttfts[len(ttfts) // 2]
        att = attribute_ttft(tls[med_rid], spans)
        out["ttft_p50"] = {"rid": med_rid, **att}
    gaps = step = bp = sched = 0
    for tl in tls.values():
        itl = attribute_itl(tl, spans)
        if itl is None:
            continue
        gaps += itl["gaps"]
        step += itl["step_ms"] * itl["gaps"]
        bp += itl["backpressure_ms"] * itl["gaps"]
        sched += itl["sched_ms"] * itl["gaps"]
    if gaps:
        out["itl_mean"] = {
            "gaps": gaps,
            "step_ms": step / gaps,
            "backpressure_ms": bp / gaps,
            "sched_ms": sched / gaps,
            "itl_mean_ms": (step + bp + sched) / gaps,
        }
    return out
