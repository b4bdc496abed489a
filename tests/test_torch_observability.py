"""Port parity of the observability layer (`automodel_tpu_torch/observability/`)
on the CPU, the JAX package beside the port on the same inputs.

- the metrics registry: one sequence of registry operations (the catalog,
  labelled counters, gauges, histograms with an overflow) gives Prometheus
  text byte-equal to the JAX registry's, the same snapshot and the same
  histogram percentiles;
- `attribution_summary` on one event list (monolithic and handoff
  requests, stream pauses, step spans) equals JAX's exactly;
- a tiny Llama served by both engines with observability on: the same
  greedy tokens, the same lifecycle `digest()`, the same counter and gauge
  values and histogram counts; the port's tokens with observability on
  equal those with it off; the Chrome export passes
  `validate_chrome_trace`; an injected `serve_step` crash dumps a flight
  recorder whose last step is the crash's, in both packages;
- the `llm_serve` recipe with `serving.observability` writes the trace,
  `metrics.prom` and the `latency_attribution` record whose TTFT phases
  sum to the median request's TTFT, and captures the profile window;
- `ServingEngine.step_cost` counts one step's GEMMs, paged attention and unembed
  as a hand count does; `http_port` and replica-qualified tracks raise,
  naming their ROADMAP.md items.

The module runs PyTorch on one CPU thread (the tier-1 run's six test
workers share the cores).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.observability import ObservabilityConfig as JObsConfig
from automodel_tpu.observability import metrics as j_metrics
from automodel_tpu.observability import timeline as j_timeline
from automodel_tpu.observability.trace import TraceEvent as JTraceEvent
from automodel_tpu.resilience.faults import FaultCrash as JFaultCrash
from automodel_tpu.resilience.faults import injected as j_injected
from automodel_tpu.serving import Request as JRequest
from automodel_tpu.serving import ServingConfig as JServingConfig
from automodel_tpu.serving import ServingEngine as JServingEngine
from automodel_tpu_torch.config import load_yaml
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.llm.decoder import TransformerConfig
from automodel_tpu_torch.observability import (
    ObservabilityConfig,
    Observability,
    attribution_summary,
    metrics,
    step_efficiency,
    validate_chrome_trace,
)
from automodel_tpu_torch.observability.trace import TraceEvent
from automodel_tpu_torch.recipes.llm.serve import ServeRecipe
from automodel_tpu_torch.resilience import FaultCrash, injected
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the registry ------------------------------------------------------------------
def _registry_ops(mod):
    reg = mod.MetricsRegistry()
    reg.register_catalog()
    reg.counter("serve_steps_total").inc(7)
    reg.counter("frontend_shed_total", reason="deadline").inc(2)
    reg.counter("frontend_shed_total", reason="queue").inc()
    reg.counter("bench_probe_failures_total", "failed probes", reason="x y").inc(0.5)
    reg.gauge("serve_free_pages").set(123)
    reg.gauge("frontend_itl_ewma_ms").set(2.718281828459045)
    reg.gauge("frontend_running").inc(3)
    reg.gauge("frontend_running").dec()
    h = reg.histogram("request_ttft_ms")
    for v in (0.05, 0.07, 3.0, 3.0, 47.5, 999.0, 1e4, 2.5e5, 0.0):
        h.observe(v)
    custom = reg.histogram("custom_ms", "custom buckets", buckets=(1.0, 10.0, 100.0),
                           route="a")
    for v in (0.5, 5.0, 50.0, 500.0):
        custom.observe(v)
    return reg


def test_prometheus_text_and_percentiles_equal_jax():
    got, want = _registry_ops(metrics), _registry_ops(j_metrics)
    assert got.snapshot_prometheus() == want.snapshot_prometheus()  # byte-equal
    assert got.snapshot() == want.snapshot()
    assert metrics.METRIC_CATALOG == j_metrics.METRIC_CATALOG
    for name, labels in (("request_ttft_ms", {}), ("custom_ms", {"route": "a"})):
        for q in np.linspace(0.0, 1.0, 21):
            assert (got.histogram(name, **labels).percentile(q)
                    == want.histogram(name, **labels).percentile(q)), (name, q)
    with pytest.raises(TypeError):
        got.gauge("serve_steps_total")
    with pytest.raises(ValueError):
        got.counter("serve_steps_total").inc(-1)


# -- TTFT / ITL attribution ----------------------------------------------------------
def _events():
    """(name, ph, ts, dur, step, track, rid, args): two monolithic requests,
    one disaggregated one with a handoff, a stream pause, step spans."""
    rows = []
    t = 100.0
    for step in range(12):
        rows.append(("step.run", "X", t + 0.002, 0.006, step, "engine", -1, {}))
        t += 0.01
    rows += [
        ("request.submit", "i", 100.000, 0.0, 0, "engine", 0, {"prompt": 5}),
        ("request.admit", "i", 100.003, 0.0, 0, "engine", 0, {"slot": 0}),
        ("request.first_token", "i", 100.029, 0.0, 2, "engine", 0, {}),
        ("request.commit", "i", 100.029, 0.0, 2, "engine", 0, {"n": 1}),
        ("request.commit", "i", 100.039, 0.0, 3, "engine", 0, {"n": 1}),
        ("stream.pause", "i", 100.041, 0.0, 4, "engine", 0, {}),
        ("stream.resume", "i", 100.046, 0.0, 4, "engine", 0, {}),
        ("request.commit", "i", 100.059, 0.0, 5, "engine", 0, {"n": 2}),
        ("request.done", "i", 100.059, 0.0, 5, "engine", 0, {"reason": "length"}),
        ("frontend.submit", "i", 100.010, 0.0, 1, "engine", 1, {}),
        ("request.admit", "i", 100.021, 0.0, 2, "prefill0", 1, {}),
        ("request.handoff_extract", "i", 100.044, 0.0, 4, "prefill0", 1, {}),
        ("request.handoff_admit", "i", 100.052, 0.0, 5, "decode0", 1, {}),
        ("request.first_token", "i", 100.069, 0.0, 6, "decode0", 1, {}),
        ("request.commit", "i", 100.069, 0.0, 6, "decode0", 1, {"n": 1}),
        ("request.commit", "i", 100.089, 0.0, 8, "decode0", 1, {"n": 1}),
        ("request.submit", "i", 100.030, 0.0, 3, "engine", 2, {}),
        ("request.admit", "i", 100.031, 0.0, 3, "engine", 2, {}),
        ("stream.pause", "i", 100.033, 0.0, 3, "engine", 2, {}),
        ("stream.resume", "i", 100.036, 0.0, 3, "engine", 2, {}),
        ("request.first_token", "i", 100.109, 0.0, 10, "engine", 2, {}),
        ("request.commit", "i", 100.109, 0.0, 10, "engine", 2, {"n": 1}),
        ("request.expire", "i", 100.111, 0.0, 10, "engine", 3, {}),
    ]
    return rows


def test_attribution_summary_equal_to_jax():
    got = attribution_summary([TraceEvent(*r) for r in _events()])
    want = j_timeline.attribution_summary([JTraceEvent(*r) for r in _events()])
    assert got == want
    att = got["ttft_p50"]
    assert att["ttft_ms"] == pytest.approx(
        sum(v for k, v in att.items() if k.endswith("_ms") and k != "ttft_ms"))
    assert got["itl_mean"]["backpressure_ms"] > 0


# -- the engine ------------------------------------------------------------------
CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_layers=2,
           num_heads=4, num_kv_heads=2)
J_CFG = j_decoder.TransformerConfig(**CFG, dtype=jnp.float32, remat_policy="none")
T_CFG = TransformerConfig(**CFG, dtype=torch.float32)
SERVE = dict(page_size=4, num_pages=24, max_slots=3, pages_per_slot=6,
             token_budget=8, prefill_chunk=4)
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(1, 64, (n,))]
           for i, n in enumerate((5, 9, 3, 7, 11))]
ARRIVALS, MAX_NEW = (0, 0, 2, 3, 5), 6


@pytest.fixture(scope="module")
def weights():
    params = j_decoder.init(J_CFG, jax.random.key(0))
    return params, params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _jax_engine(weights, **obs):
    return JServingEngine(weights[0], J_CFG, JServingConfig(
        **SERVE, observability=JObsConfig(**obs)))


def _port_engine(weights, **obs):
    return ServingEngine(weights[1], T_CFG, ServingConfig(
        **SERVE, observability=ObservabilityConfig(**obs) if obs else None), device="cpu")


def _reqs(cls):
    return [cls(prompt=list(p), max_new_tokens=MAX_NEW, arrival=a)
            for p, a in zip(PROMPTS, ARRIVALS)]


def _counts(snapshot: dict) -> dict:
    """Counters and gauges by value; histograms by their counts (their
    sums are wall times)."""
    return {k: (v["count"], v["cumulative"]) if k == "serve_step_ms" else
            (v["count"] if isinstance(v, dict) else v) for k, v in snapshot.items()}


def test_traced_engine_matches_jax_and_serves_the_same_tokens(weights, tmp_path):
    je = _jax_engine(weights, enabled=True)
    want = je.serve_batch(_reqs(JRequest))
    te = _port_engine(weights, enabled=True)
    got = te.serve_batch(_reqs(Request))
    off = _port_engine(weights).serve_batch(_reqs(Request))
    assert got["outputs"] == want["outputs"] == off["outputs"]
    assert te.obs.enabled and te.obs.tracer.events
    assert te.obs.tracer.digest() == je.obs.tracer.digest()
    g, w = te.obs.registry.snapshot(), je.obs.registry.snapshot()
    assert set(g) == set(w)
    # the step-time histogram's buckets hold wall times: its count is equal
    assert g["serve_step_ms"]["count"] == w["serve_step_ms"]["count"] == got["stats"]["steps"]
    g.pop("serve_step_ms"), w.pop("serve_step_ms")
    # the eager port compiles no step program: its stat (and gauge) is 0
    assert (g.pop("serve_compiled_signatures"), w.pop("serve_compiled_signatures")) == (0, 1)
    assert _counts(g) == _counts(w)
    assert g["serve_steps_total"] == got["stats"]["steps"] > 0
    names = [e.name for e in te.obs.tracer.events]
    assert names == [e.name for e in je.obs.tracer.events]
    assert {"step.run", "step.absorb", "step.plan", "request.first_token"} <= set(names)
    paths = te.obs.export(str(tmp_path / "trace" / "serve"))
    summary = validate_chrome_trace(paths["chrome"])
    assert summary["events"] >= len(te.obs.tracer.events)
    assert summary["spans"] == sum(e.ph == "X" for e in te.obs.tracer.events)
    assert len(open(paths["jsonl"]).readlines()) == len(te.obs.tracer.events)


def test_serve_step_crash_dumps_the_flight_recorder(weights, tmp_path):
    last = {}
    for name, engine, ctx, crash, reqs in (
            ("jax", _jax_engine, j_injected, JFaultCrash, _reqs(JRequest)),
            ("port", _port_engine, injected, FaultCrash, _reqs(Request))):
        path = str(tmp_path / f"{name}.flight.jsonl")
        e = engine(weights, enabled=True, flight_recorder_len=16,
                   flight_recorder_path=path)
        with ctx({"point": "serve_step", "step": 6, "mode": "crash"}):
            with pytest.raises(crash):
                e.serve_batch(reqs)
        lines = [json.loads(line) for line in open(path)]
        assert lines[0] == {"flight_recorder": True, "reason": "crash", "events": 16}
        last[name] = [(ev["name"], ev["step"], ev["rid"]) for ev in lines[1:]]
        assert e.obs.registry.snapshot()[
            'flight_recorder_dumps_total{reason="crash"}'] == 1
    assert last["port"] == last["jax"]
    assert max(step for _, step, _ in last["port"]) == 6
    with injected({"point": "serve_step_run", "call": 2, "mode": "error"}):
        e = _port_engine(weights, enabled=True,
                         flight_recorder_path=str(tmp_path / "error.flight.jsonl"))
        with pytest.raises(RuntimeError, match="serve_step_run"):
            e.serve_batch(_reqs(Request))
        assert e.steps_run == 1 and e.obs.registry.snapshot()["serve_steps_total"] == 1
    assert json.loads(open(tmp_path / "error.flight.jsonl").readline())["reason"] == "crash"


ENGINE_SERIES = (
    "serve_steps_total", "serve_plan_tokens_total", "serve_plan_samples_total",
    "serve_step_ms", "serve_new_tokens_total", "serve_requests_total",
    "serve_preemptions_total", "serve_timed_out_total", "serve_cancelled_total",
    "serve_free_pages", "serve_compiled_signatures", "serve_prefix_hits_total",
    "serve_prefill_skipped_tokens_total", "serve_cow_copies_total")


def test_serve_recipe_writes_trace_prometheus_and_attribution(tmp_path):
    node = load_yaml("examples/llm_serve/llama_serve_smoke.yaml")
    node.set("run_dir", str(tmp_path / "run"))
    node.set("serving.observability", {"enabled": True, "profile_window": [2, 2],
                                       "profile_dir": str(tmp_path / "prof")})
    recipe = ServeRecipe(node, device="cpu")
    recipe.setup()
    res = recipe.run_train_validation_loop()
    run = tmp_path / "run"
    validate_chrome_trace(str(run / "serve.trace.json"))
    prom = (run / "metrics.prom").read_text()
    # the catalog's engine series: the step loop's and serve_batch's outcomes
    catalog = {name: kind for name, kind, _ in metrics.METRIC_CATALOG}
    for name in ENGINE_SERIES:
        assert f"# TYPE {name} {catalog[name]}\n" in prom, name
    assert f"serve_steps_total {res['stats']['steps']}\n" in prom
    attr = res["stats"]["latency_attribution"]
    recs = [json.loads(line) for line in open(run / "serving.jsonl")]
    assert any(r.get("metric") == "latency_attribution" for r in recs)
    ttft = sorted(r.ttft_s * 1e3 for r in res["requests"])
    p50 = attr["ttft_p50"]
    assert sum(v for k, v in p50.items() if k.endswith("_ms") and k != "ttft_ms") \
        == pytest.approx(p50["ttft_ms"])
    assert attr["with_first_token"] == len(res["requests"])
    # the attribution's clock (submit to first token) starts before the
    # engine's arrival stamp and ends after its first-token stamp
    assert p50["ttft_ms"] >= sorted(ttft)[len(ttft) // 2] * 0.5
    prof = recipe.engine.obs.profiler
    assert prof.done and prof.triggered_by == "window"
    assert json.load(open(prof.trace_path))["traceEvents"]


def test_step_cost_counts_the_step_as_a_hand_count(weights):
    te = _port_engine(weights)
    sched = te.make_scheduler()
    for r in _reqs(Request):
        sched.submit(r)
    plan = sched.schedule(0)
    cost = te.step_cost(plan)
    rows = int((plan.pos >= 0).sum())
    samples = int((plan.sample_tok >= 0).sum())
    H, I, Hq, Hkv, D = 32, 48, 4, 2, 8
    linear = H * Hq * D + 2 * H * Hkv * D + Hq * D * H + 3 * H * I
    kv = sum(int(p) + 1 for p in plan.pos if p >= 0)
    want = 2 * (2 * rows * linear + kv * Hq * 4 * D) + 2 * samples * H * 64
    assert cost["flops"] == want
    eff = step_efficiency(cost, 0.5)
    assert eff["achieved_gflops_per_s"] == pytest.approx(want / 0.5 / 1e9)
    assert "mfu" not in eff  # no card, no peaks


def test_unported_observability_options_raise(weights):
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        Observability(ObservabilityConfig(enabled=True, http_port=0))
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        ServingEngine(weights[1], T_CFG, ServingConfig(**SERVE), device="cpu",
                      track="replica1")
    assert os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
