"""Port parity of the fault-tolerance layer (`automodel_tpu_torch/resilience/`)
on the CPU, the JAX package beside the port on the same inputs.

- fault schedules over a grid of (point, call, step, times, mode) fire on
  the same hits as JAX's, with the same outcome; retry delays and attempts
  for one seed equal JAX's, exhaustion fails loudly, a `FaultCrash` is
  never retried;
- `RollbackManager` makes JAX's decisions on the same loss sequences (a
  spike, a NaN streak, the budget), and restores the host snapshot into
  the same tensors in place, step counters rewound, its buffers reused;
- the checkpointer and the HF export under faults, as the JAX chaos suite
  (`tests/unit/test_resilience.py`) drives them: a transient write
  retried, exhaustion raising, a missing step never retried, a crash
  before the commit leaving no partial checkpoint or export, a crash in
  the async writer reaching `wait()`, the reader's `remote_io` retries;
- `examples/llm_finetune/tiny_llama_resilient_smoke.yaml` with faults armed
  as in that suite (`checkpoint_write` at call 1 twice, `nan_grads` at
  step 6, `sigterm` at step 9) and a `profiling` window, through both
  recipes from the same initial weights: losses within 1e-4 relative
  (docs/PARITY.md) and the same learning rates, so a rollback that failed
  to rewind the optimizer's step counter (hence the cosine schedule and
  the bias corrections) shows; the same rollback, retry and emergency
  checkpoint records; the port's trace of the window, and its resume
  from the emergency checkpoint;
- the nonfinite cap raises as JAX's does, naming the first bad step, and
  an injected crash in the checkpoint write leaves the recipe uncaught.

`python tests/resilience_mutants.py [OUT_DIR]` runs the mutants on copies.
The module runs PyTorch on one CPU thread.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from automodel_tpu import resilience as jres
from automodel_tpu.config import ConfigNode as JConfigNode
from automodel_tpu.optim import LRSchedulerConfig as JLRSchedulerConfig
from automodel_tpu.optim import OptimizerConfig as JOptimizerConfig
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu_torch import resilience as res
from automodel_tpu_torch.checkpoint import (
    CheckpointingConfig,
    HFCheckpointReader,
    save_hf_checkpoint,
)
from automodel_tpu_torch.config import ConfigNode, load_yaml
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.optim import LRSchedulerConfig, OptimizerConfig
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.training import init_train_state

YAML = "examples/llm_finetune/tiny_llama_resilient_smoke.yaml"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- faults and retry ------------------------------------------------------------
def _outcomes(mod, specs, hits):
    inj = mod.FaultInjector([dict(s) for s in specs])
    out = []
    for point, step in hits:
        try:
            out.append(inj.hit(point, step))
        except mod.FaultError:
            out.append("error")
        except mod.FaultCrash:
            out.append("crash")
    return out, dict(inj.calls), dict(inj.fired)


@pytest.mark.parametrize("mode", ["error", "crash", "flag"])
def test_fault_schedules_equal_jax(mode):
    hits = [(p, s) for s in range(7) for p in ("a", "b", "a")]
    fired = 0
    for step in (None, 2, 5):
        for call in (None, 1, 3, 8):
            for times in (1, 2, 3):
                specs = [{"point": "a", "step": step, "call": call, "times": times,
                          "mode": mode},
                         {"point": "b", "call": 4, "mode": "error"}]
                got = _outcomes(res, specs, hits)
                assert got == _outcomes(jres, specs, hits), specs
                fired += got[2].get("a", 0)
    assert fired > 0
    with pytest.raises(ValueError):
        res.FaultSpec(point="a", mode="boom")
    with res.injected({"point": "p", "mode": mode}) as inj:
        assert res.get_injector() is inj and inj.armed
    assert not res.get_injector().armed


def test_retry_delays_and_attempts_equal_jax():
    for mod in (res, jres):
        assert mod.RetryPolicy().max_attempts == 3
    for seed in (0, 3):
        kw = dict(max_attempts=5, base_delay_s=0.1, max_delay_s=0.3, jitter=0.5, seed=seed)
        trail = {}
        for name, mod in (("port", res), ("jax", jres)):
            p = mod.RetryPolicy(**kw)
            delays, attempts = [], []
            fails = iter(range(3))

            def flaky(mod=mod, fails=fails):
                if next(fails, None) is not None:
                    raise mod.FaultError("transient")
                return "ok"

            assert mod.retry_call(
                flaky, policy=p, point="checkpoint_write", sleep=delays.append,
                on_attempt=lambda *a, attempts=attempts: attempts.append(a[:2] + a[3:]),
            ) == "ok"
            with pytest.raises(mod.RetryBudgetExhausted, match="3 attempt"):
                mod.retry_call(lambda m=mod: (_ for _ in ()).throw(m.FaultError("x")),
                               policy=mod.RetryPolicy(max_attempts=3, seed=seed),
                               point="remote_io", sleep=delays.append)
            trail[name] = (delays, attempts,
                           [p.delay(a, p.rng_for("x")) for a in (1, 2, 3, 4)])
        assert trail["port"] == trail["jax"]
    calls = []

    def crash():
        calls.append(1)
        raise res.FaultCrash("dead")

    with pytest.raises(res.FaultCrash):
        res.retry_call(crash, policy=res.RetryPolicy(max_attempts=5, base_delay_s=0.0))
    assert calls == [1]
    with pytest.raises(FileNotFoundError):
        res.retry_call(lambda: open("/nonexistent/x"), policy=res.RetryPolicy(),
                       no_retry=(FileNotFoundError,), sleep=lambda s: None)
    assert res.process_index() == 0


# -- rollback ----------------------------------------------------------------------
LOSSES = (2.0, 2.1, 1.9, 2.05, 1.95, 2.0, 40.0, 1.9, float("nan"), float("nan"),
          1.8, float("nan"), 2.2, 1.7)


def _decisions(mod, state, restore):
    rb = mod.RollbackManager(every_steps=2, max_rollbacks=3, loss_spike_factor=6.0,
                             spike_window=8)
    out = []
    rb.snapshot(0, state)
    for step, loss in enumerate(LOSSES, start=1):
        reason = rb.observe(step, loss, nonfinite=not np.isfinite(loss))
        if reason is None:
            if rb.due(step):
                rb.snapshot(step, state)
            out.append((step, None, rb.snapshot_step))
            continue
        try:
            snap, restored = rb.rollback(step, reason)
            out.append((step, reason, snap, restore(restored)))
        except mod.ResilienceError as e:
            out.append((step, reason, str(e)))
    return out, dataclasses.asdict(rb.stats), rb.first_bad_step


def test_rollback_decisions_equal_jax():
    j_state = {"w": jnp.arange(4.0), "count": 3}
    t_state = {"w": torch.arange(4.0), "count": 3}
    got = _decisions(res, t_state, lambda s: (s["w"].tolist(), s["count"]))
    want = _decisions(jres, j_state, lambda s: (np.asarray(s["w"]).tolist(), s["count"]))
    assert got == want
    assert [d[1] for d in got[0] if d[1]] == ["loss_spike", "nonfinite", "nonfinite",
                                              "nonfinite"]
    assert "budget exhausted" in got[0][-3][2]


def test_rollback_restores_in_place_and_rewinds_the_counters():
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 4, generator=gen), "b": {"x": torch.randn(5, generator=gen)}}
    tx = OptimizerConfig(name="adamw", lr=1e-2).build()
    state = init_train_state(params, tx)
    rb = res.RollbackManager(every_steps=1)
    rb.snapshot(0, state)
    want = {k: v.detach().clone() for k, v in (("w", params["w"]), ("x", params["b"]["x"]))}
    ptrs = [b.data_ptr() for b in rb._buffers.bufs.values()]
    for _ in range(3):
        tx.update({"w": torch.ones(3, 4), "b": {"x": torch.ones(5)}}, state.opt_state,
                  state.params)
        state = dataclasses.replace(state, step=state.step + 1)
    mu = state.opt_state["mu"]["w"]
    assert state.opt_state["count"] == 3 and mu.abs().sum() > 0
    snap, restored = rb.rollback(3, "nonfinite")
    assert snap == 0 and restored.step == 0 and restored.opt_state["count"] == 0
    assert restored.params["w"] is params["w"] and restored.opt_state["mu"]["w"] is mu
    assert torch.equal(params["w"], want["w"]) and torch.equal(params["b"]["x"], want["x"])
    assert mu.abs().sum() == 0 and params["w"].requires_grad
    rb.snapshot(1, restored)  # the buffers are made once
    assert [b.data_ptr() for b in rb._buffers.bufs.values()] == ptrs
    assert rb.last_snapshot["bytes"] == 3 * 17 * 4 and rb.last_restore["step"] == 3


@pytest.mark.parametrize("okw,skw", [
    (dict(name="adamw", lr=1e-2, weight_decay=0.1),
     dict(style="cosine", warmup_steps=2, decay_steps=6)),
    (dict(name="sgd", lr=5e-2, momentum=0.8), dict(style="linear", decay_steps=6)),
], ids=["adamw_cosine", "sgd_linear"])
def test_skipped_updates_select_as_the_jax_step(okw, skw):
    """`skip_nonfinite_updates`: the port's update selected by a bool
    tensor (`Optimizer.update(..., ok=)`) against the JAX step's
    `where(ok, new, old)` over the params and the whole optax state: a
    skipped step leaves params, moments and the count alone, so the
    schedule of the steps after it is JAX's."""
    rng = np.random.default_rng(3)
    tree = {"layers": {"norm": rng.normal(size=(2, 6)), "w": rng.normal(size=(2, 6, 5))},
            "final_norm": rng.normal(size=(6,))}
    tree = jax.tree.map(lambda x: x.astype(np.float32), tree)
    tx = JOptimizerConfig(**okw).build(JLRSchedulerConfig(**skw).build(okw["lr"]))
    opt = OptimizerConfig(**okw).build(LRSchedulerConfig(**skw).build(okw["lr"]))
    j_params = jax.tree.map(jnp.asarray, tree)
    j_state = tx.init(j_params)
    t_params = params_from_jax(tree, device="cpu")
    t_state = opt.init(t_params)
    oks = [True, False, True, True, False, True]
    for step, ok in enumerate(oks):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), tree)
        if not ok:
            g["layers"]["w"][0, 0, 0] = np.nan
        updates, new_state = tx.update(jax.tree.map(jnp.asarray, g), j_state, j_params)
        new_params = optax.apply_updates(j_params, updates)
        j_ok = jnp.all(jnp.array([jnp.all(jnp.isfinite(x)) for x in jax.tree.leaves(g)]))
        j_params = jax.tree.map(lambda n, o: jnp.where(j_ok, n, o), new_params, j_params)
        j_state = jax.tree.map(lambda n, o: jnp.where(j_ok, n, o) if hasattr(n, "shape")
                               else n, new_state, j_state)
        opt.update(params_from_jax(g, device="cpu"), t_state, t_params,
                   ok=torch.tensor(ok), max_count=step)
        for got, want in zip(jax.tree.leaves(t_params), jax.tree.leaves(j_params)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
        assert torch.is_tensor(t_state["count"]) and int(t_state["count"]) == sum(oks[:step + 1])


# -- the checkpointer and the HF export under faults -------------------------------
def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(3, 4, generator=gen)}
    return init_train_state(params, OptimizerConfig(name="adamw").build())


def _ckpt(tmp_path, **kw):
    ck = CheckpointingConfig(checkpoint_dir=str(tmp_path / "ck"), **kw).build()
    attempts = []
    ck.set_retry(res.RetryPolicy(max_attempts=3, base_delay_s=0.0),
                 on_attempt=lambda *a: attempts.append(a[:2]))
    return ck, attempts


def test_checkpoint_write_and_restore_under_faults(tmp_path):
    ck, attempts = _ckpt(tmp_path, async_save=False)
    with res.injected({"point": "checkpoint_write", "call": 1, "times": 2}):
        assert ck.save(1, _state())
    assert attempts == [("checkpoint_write", 1), ("checkpoint_write", 2)]
    assert ck.all_steps() == [1]
    with res.injected({"point": "checkpoint_restore", "call": 1, "times": 1}):
        ck.restore(_state(1))
    assert attempts[-1] == ("checkpoint_restore", 1)
    with res.injected({"point": "checkpoint_write", "call": 1, "times": 5}):
        with pytest.raises(res.RetryBudgetExhausted):
            ck.save(2, _state())
    n = len(attempts)
    with pytest.raises(FileNotFoundError):
        ck.restore(_state(), step=7)  # deterministic: never retried
    assert len(attempts) == n
    with res.injected({"point": "checkpoint_write", "mode": "crash"}):
        with pytest.raises(res.FaultCrash):
            ck.save(3, _state())
    assert ck.all_steps() == [1] and len(attempts) == n  # a crash is no transient
    with res.injected({"point": "checkpoint_wait", "mode": "error"}):
        with pytest.raises(res.FaultError):
            ck.wait()


def test_async_writer_crash_reaches_wait(tmp_path, monkeypatch):
    ck, _ = _ckpt(tmp_path, async_save=True)

    def crash(obj, path):
        raise res.FaultCrash("killed mid-write")

    monkeypatch.setattr(torch, "save", crash)
    assert ck.save(1, _state())
    with pytest.raises(res.FaultCrash, match="mid-write"):
        ck.wait()
    assert ck.all_steps() == []


def test_hf_export_and_reader_under_faults(tmp_path):
    tensors = {"model.embed_tokens.weight": torch.randn(8, 4),
               "lm_head.weight": torch.randn(8, 4)}
    out = tmp_path / "hf"
    save_hf_checkpoint(iter(tensors.items()), str(out), hf_config={"v": 1})
    for point in ("hf_export_commit", "hf_export_swap"):
        with res.injected({"point": point, "mode": "crash"}):
            with pytest.raises(res.FaultCrash):
                save_hf_checkpoint(iter({k: v * 2 for k, v in tensors.items()}.items()),
                                   str(out), hf_config={"v": 2})
        save_hf_checkpoint(iter(tensors.items()), str(tmp_path / "other"))  # unrelated
        # the old complete export stays (restored from `.old` by the next export)
        save_hf_checkpoint(iter(tensors.items()), str(out), hf_config={"v": 1})
        with HFCheckpointReader(str(out)) as r:
            assert torch.equal(r("lm_head.weight"), tensors["lm_head.weight"])
    attempts = []
    with res.injected({"point": "hf_export_write", "call": 1, "times": 1}):
        save_hf_checkpoint(iter(tensors.items()), str(out),
                           retry_policy=res.RetryPolicy(base_delay_s=0.0),
                           on_retry=lambda *a: attempts.append(a[0]))
    assert attempts == ["hf_export_write"]
    reader = HFCheckpointReader(str(out), retry_policy=res.RetryPolicy(base_delay_s=0.0),
                                on_retry=lambda *a: attempts.append(a[0]))
    with res.injected({"point": "remote_io", "call": 1, "times": 2}):
        assert torch.equal(reader("model.embed_tokens.weight"),
                           tensors["model.embed_tokens.weight"])
    assert attempts[1:] == ["remote_io", "remote_io"]
    with res.injected({"point": "remote_io", "call": 1, "times": 10}):
        with pytest.raises(res.RetryBudgetExhausted):
            reader("lm_head.weight")
    with pytest.raises(KeyError):
        reader("missing")
    reader.close()


# -- the recipe ------------------------------------------------------------------
FAULTS = [{"point": "checkpoint_write", "call": 1, "times": 2},
          {"point": "nan_grads", "step": 6},
          {"point": "sigterm", "step": 9}]


def _node(cls, tmp, name, **over):
    node = cls(load_yaml(YAML).to_dict())
    node.set("run_dir", str(tmp / name))
    node.set("checkpoint.checkpoint_dir", str(tmp / name / "ckpt"))
    for k, v in over.items():
        node.set(k, v)
    return node


def _records(run_dir):
    with open(os.path.join(run_dir, "training.jsonl")) as f:
        return [json.loads(line) for line in f]


def _port(node, init=None):
    recipe = TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu")
    recipe.setup()
    if init is not None:
        recipe.train_state = init_train_state(params_from_jax(init, device="cpu"), recipe.tx)
    recipe.run_train_validation_loop()
    return recipe


@pytest.fixture(scope="module")
def chaos_runs(tmp_path_factory):
    """The armed YAML through the JAX recipe and through the port's from the
    JAX run's initial weights, the port's with a profiling window."""
    tmp = tmp_path_factory.mktemp("chaos")
    j = JRecipe(_node(JConfigNode, tmp, "jax", **{"resilience.faults": FAULTS}))
    j.setup()
    init = jax.tree.map(np.asarray, j.train_state.params)
    j.run_train_validation_loop()
    port = _port(_node(ConfigNode, tmp, "port", **{
        "resilience.faults": FAULTS,
        "profiling": {"trace_dir": str(tmp / "trace"), "start_step": 2, "num_steps": 2}}),
        init)
    return tmp, init, j, port


def test_resilient_yaml_matches_jax_through_the_faults(chaos_runs):
    tmp, _, j, port = chaos_runs
    want, got = _records(tmp / "jax"), _records(tmp / "port")
    steps = [r for r in got if "loss" in r]
    assert [r["step"] for r in steps] == [r["step"] for r in want if "loss" in r] \
        == [1, 2, 3, 4, 5, 7, 8, 9]
    for key, rtol in (("loss", 1e-4), ("lr", 1e-6)):
        w = np.array([r[key] for r in want if "loss" in r])
        g = np.array([r[key] for r in steps])
        np.testing.assert_allclose(g, w, rtol=rtol, err_msg=key)
    strip = ("ts", "seconds")
    events = [[{k: v for k, v in r.items() if k not in strip} for r in recs if "event" in r]
              for recs in (got, want)]
    assert events[0] == events[1]
    assert [e["event"] for e in events[0]] == ["rollback", "emergency_checkpoint"]
    assert events[0][0]["restored_step"] == 4 and events[0][0]["retry_checkpoint_write"] == 2
    assert events[0][1]["committed"] and events[0][1]["step"] == 9
    assert steps[-1]["rollbacks"] == 1 and steps[-1]["wasted_steps"] == 2
    assert dataclasses.asdict(port.rollback.stats) == dataclasses.asdict(j.rollback.stats)
    assert port.checkpointer.all_steps() == [5, 9]


def test_profiling_trace_and_resume_from_the_emergency_checkpoint(chaos_runs):
    tmp, _, _, port = chaos_runs
    trace = json.load(open(port.profiler.trace_path))
    assert port.profiler.trace_path.endswith("trace_step2.json") and trace["traceEvents"]
    resumed = _port(_node(ConfigNode, tmp, "port"))
    recs = _records(tmp / "port")
    assert [r["step"] for r in recs if "loss" in r][-1] == 10
    assert recs[-1]["time_to_resume_s"] > 0 and resumed.rollback.stats.rollbacks == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_nonfinite_cap_fails_fast_as_jax(pkg, tmp_path):
    over = {"resilience": {"max_consecutive_nonfinite": 3,
                           "faults": [{"point": "nan_grads", "step": 3}]},
            "checkpoint.enabled": False}
    if pkg == "jax":
        recipe = JRecipe(_node(JConfigNode, tmp_path, "cap", **over))
        err = jres.ResilienceError
    else:
        recipe = TrainFinetuneRecipeForNextTokenPrediction(
            _node(ConfigNode, tmp_path, "cap", **over), device="cpu")
        err = res.ResilienceError
    recipe.setup()
    with pytest.raises(err, match="3 consecutive non-finite step.*first bad step: 3"):
        recipe.run_train_validation_loop()
    assert [r["step"] for r in _records(tmp_path / "cap") if "loss" in r] == [1, 2, 3, 4]


def test_injected_crash_is_not_caught(tmp_path):
    node = _node(ConfigNode, tmp_path, "crash", **{
        "resilience.faults": [{"point": "checkpoint_write", "mode": "crash"}]})
    recipe = TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu")
    recipe.setup()
    with pytest.raises(res.FaultCrash):
        recipe.run_train_validation_loop()
    assert recipe.checkpointer.all_steps() == []
    assert [r["step"] for r in _records(tmp_path / "crash") if "loss" in r] == [1, 2, 3, 4, 5]
