"""The port's train-state checkpointer (`automodel_tpu_torch/checkpoint/
checkpointer.py`) and the training recipe's resume, SIGTERM and HF export
paths, on the CPU. Every checkpoint is written under `tmp_path`.

- a round trip of a `TrainState` plus the JSON side-car, restored in place
  into the live tensors; retention of the newest steps and the best step;
  an uncommitted `.tmp` step that `latest_step` ignores; an async save
  whose failed write `wait()` re-raises; a remote URI refused;
- `examples/llm_finetune/tiny_llama_mock_smoke.yaml` as written (the
  checkpointer on; only `run_dir` and `checkpoint_dir` moved), from a live
  JAX run's initial weights: the unbroken 10-step run within the
  docs/PARITY.md tolerances of the JAX run (1e-4 relative for steps 1-5,
  5e-3 after); a 5-step run resumed to 10 and a run from
  `checkpoint.restore_from` give the unbroken run's losses bit for bit
  (the same fp32 operations on the same values, in the same order). The
  module runs PyTorch on one CPU thread: with several, the intra-op pool
  splits some reductions by the threads it gets, and two unbroken runs
  already differ in the last bits of a loss;
- a SIGTERM at step 3: the `emergency_checkpoint` record is committed and
  a fresh recipe auto-resumes to the unbroken curve;
- `save_consolidated: final`: the JAX package's `HFCheckpointReader` and
  adapter read the export back bit-equal to the port's final params;
- the DeepSeek-V3 smoke YAML resumed at step 2 of 4: the curve and the
  MoE gate's `e_score_bias` bit-equal to the unbroken run.
"""

import dataclasses
import json
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.checkpoint.hf_adapter import HFCheckpointReader as JReader
from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.config import ConfigNode as JConfigNode
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu_torch.checkpoint import (
    CheckpointingConfig,
    is_remote_path,
)
from automodel_tpu_torch.config import load_yaml
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.optim import OptimizerConfig
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.training import TrainState, init_train_state
from automodel_tpu_torch.training.rng import StatefulRNG

TINY_YAML = "examples/llm_finetune/tiny_llama_mock_smoke.yaml"
MOE_YAML = "examples/llm_finetune/deepseek_v3_smoke.yaml"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _records(run_dir):
    with open(os.path.join(run_dir, "training.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(run_dir):
    return [r["loss"] for r in _records(run_dir) if "loss" in r]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    return {prefix: tree}


def _trees_bitwise_equal(a, b):
    """Same paths, and every leaf equal bit for bit (the key order of two
    param trees may differ: a recipe's own init and `params_from_jax`)."""
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and torch.equal(
            fa[k].detach().reshape(-1).view(torch.uint8),
            fb[k].detach().reshape(-1).view(torch.uint8))
        for k in fa)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Bit-reproducible CPU runs (see the module docstring)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the checkpointer alone ------------------------------------------------------
def _state(seed):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(3, 4, generator=gen), "blk": {"b": torch.randn(5, generator=gen)}}
    tx = OptimizerConfig(name="adamw", lr=1e-2).build()
    state = init_train_state(params, tx)
    grads = {"w": torch.randn(3, 4, generator=gen), "blk": {"b": torch.randn(5, generator=gen)}}
    tx.update(grads, state.opt_state, state.params)
    return dataclasses.replace(state, step=7), tx


def _ckpt(tmp_path, **kw):
    return CheckpointingConfig(checkpoint_dir=str(tmp_path / "ck"), **kw).build()


def test_train_state_round_trip_with_extra(tmp_path):
    state, tx = _state(0)
    ck = _ckpt(tmp_path, async_save=False)
    rng = StatefulRNG(seed=3)
    rng.next_key()
    rng.next_key()
    assert ck.save(7, state, extra={"rng": rng.state_dict()}, metrics={"loss": 1.5})
    assert not ck.save(7, state)  # a committed step is not written again
    assert ck.latest_step() == 7 and sorted(os.listdir(ck.root)) == ["step_7"]

    live, _ = _state(1)  # other values, same tree
    w = live.params["w"]
    restored, extra = ck.restore(live, with_extra=True)
    assert isinstance(restored, TrainState) and restored.step == 7
    assert restored.params["w"] is w and w.requires_grad  # filled in place
    assert _trees_bitwise_equal(restored.params, state.params)
    assert _trees_bitwise_equal(restored.opt_state["mu"], state.opt_state["mu"])
    assert _trees_bitwise_equal(restored.opt_state["nu"], state.opt_state["nu"])
    assert restored.opt_state["count"] == state.opt_state["count"] == 1
    fresh = StatefulRNG(seed=3)
    fresh.load_state_dict(extra["rng"])
    assert fresh.state_dict() == {"seed": 3, "ranked": True, "counter": 2}
    assert fresh.next_key().initial_seed() == rng.next_key().initial_seed()
    with pytest.raises(ValueError, match="seed"):
        StatefulRNG(seed=4).load_state_dict(extra["rng"])
    with pytest.raises(FileNotFoundError):
        ck.restore(live, step=3)
    live.params["w"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="state.params.w"):
        ck.restore(live)


def test_retention_keeps_the_newest_and_the_best(tmp_path):
    state, _ = _state(0)
    ck = _ckpt(tmp_path, async_save=False, max_recent_checkpoints=2,
               best_metric="val_loss", best_mode="min")
    for step, val in ((1, 3.0), (2, 1.0), (3, 2.0), (4, 2.5), (5, 4.0)):
        ck.save(step, state, metrics={"val_loss": val})
    assert ck.all_steps() == [2, 4, 5]
    assert ck.best_step() == 2 and ck.latest_step() == 5
    top = _ckpt(tmp_path / "max", async_save=False, max_recent_checkpoints=1,
                best_metric="acc", best_mode="max")
    for step, acc in ((1, 0.5), (2, 0.9), (3, 0.7)):
        top.save(step, state, metrics={"acc": acc})
    assert top.all_steps() == [2, 3] and top.best_step() == 2
    keep_all = _ckpt(tmp_path / "all", async_save=False, max_recent_checkpoints=None)
    for step in range(1, 7):
        keep_all.save(step, state)
    assert keep_all.all_steps() == [1, 2, 3, 4, 5, 6] and keep_all.best_step() is None


def test_uncommitted_step_is_ignored(tmp_path):
    state, _ = _state(0)
    ck = _ckpt(tmp_path, async_save=False)
    ck.save(3, state)
    # a write cut before its rename, and a directory orbax would name
    os.makedirs(os.path.join(ck.root, "step_9.tmp"))
    torch.save({}, os.path.join(ck.root, "step_9.tmp", "state.pt"))
    os.makedirs(os.path.join(ck.root, "12"))
    assert ck.latest_step() == 3 and ck.all_steps() == [3]
    assert ck.save(9, state)  # the stale .tmp is replaced, then committed
    assert ck.all_steps() == [3, 9]
    assert not os.path.exists(os.path.join(ck.root, "step_9.tmp"))


def test_async_save_and_a_failed_write(tmp_path, monkeypatch):
    state, _ = _state(0)
    ck = _ckpt(tmp_path, async_save=True)
    assert ck.save(1, state)
    # the snapshot was taken on the caller's thread: later updates miss it
    want = state.params["w"].detach().clone()
    with torch.no_grad():
        state.params["w"].add_(1.0)
    ck.wait()
    live, _ = _state(1)
    assert torch.equal(ck.restore(live).params["w"], want)

    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    assert ck.save(2, state)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # the failure is reported once
    assert ck.latest_step() == 1  # nothing half-written was committed


def test_remote_uri_is_refused(tmp_path):
    assert is_remote_path("gs://bucket/run") and not is_remote_path("C:\\ckpt")
    with pytest.raises(NotImplementedError, match="remote URI"):
        CheckpointingConfig(checkpoint_dir="gs://bucket/run").build()
    node = load_yaml(TINY_YAML)
    node.set("run_dir", str(tmp_path / "run"))
    node.set("checkpoint.checkpoint_dir", "gs://bucket/run")
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu").setup()


# -- the recipe ------------------------------------------------------------------
def _tiny_node(tmp_path, run, ckpt, **overrides):
    """The tiny YAML as written, with `run_dir` and `checkpoint_dir` moved."""
    node = load_yaml(TINY_YAML)
    node.set("run_dir", str(tmp_path / run))
    node.set("checkpoint.checkpoint_dir", str(tmp_path / ckpt))
    for key, value in overrides.items():
        node.set(key, value)
    return node


def _port_run(node, init=None, before_loop=None):
    recipe = TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu")
    recipe.setup()
    if init is not None:
        recipe.train_state = init_train_state(params_from_jax(init, device="cpu"),
                                              recipe.tx)
    if before_loop is not None:
        before_loop(recipe)
    recipe.run_train_validation_loop()
    return recipe


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """A live JAX run of the tiny YAML (checkpointer off: it does not change
    the curve) and the port's unbroken 10-step run as written from the same
    initial weights, with the consolidated HF export on."""
    tmp = tmp_path_factory.mktemp("tiny_runs")
    j_node = JConfigNode(load_yaml(TINY_YAML).to_dict())
    j_node.set("checkpoint.enabled", False)
    j_node.set("run_dir", str(tmp / "jax"))
    j_recipe = JRecipe(j_node)
    j_recipe.setup()
    init = _np_tree(j_recipe.train_state.params)
    j_recipe.run_train_validation_loop()
    full = _port_run(_tiny_node(tmp, "full", "ck_full", **{
        "checkpoint.save_consolidated": "final"}), init)
    return tmp, init, full


def test_tiny_yaml_as_written_matches_jax_and_resumes_bitwise(tiny_runs, tmp_path):
    tmp, init, full = tiny_runs
    want = np.array(_losses(tmp / "jax"))
    got = np.array(_losses(tmp / "full"))
    assert len(want) == len(got) == 10
    rel = np.abs(got - want) / np.abs(want)
    assert rel[:5].max() <= 1e-4, rel
    assert rel.max() <= 5e-3, rel
    # ckpt_every_steps 5 and the final save; max_recent_checkpoints 5
    assert full.checkpointer.all_steps() == [5, 10]

    _port_run(_tiny_node(tmp_path, "half", "ck", **{"step_scheduler.max_steps": 5}), init)
    resumed = _port_run(_tiny_node(tmp_path, "half", "ck"))
    recs = _records(tmp_path / "half")
    assert [r["step"] for r in recs] == list(range(1, 11))
    assert _losses(tmp_path / "half") == got.tolist()  # bit for bit
    assert [r["grad_norm"] for r in recs] == [r["grad_norm"] for r in _records(tmp / "full")]
    assert "time_to_resume_s" in recs[5] and "time_to_resume_s" not in recs[4]
    assert resumed.rng.counter == full.rng.counter
    assert _trees_bitwise_equal(resumed.train_state.params, full.train_state.params)


def test_restore_from_an_explicit_checkpoint_dir(tiny_runs, tmp_path):
    """`checkpoint.restore_from` / `restore_step` read another run's
    directory; the recipe's own (empty) one is not consulted."""
    tmp, _, _ = tiny_runs
    _port_run(_tiny_node(tmp_path, "from", "ck_own", **{
        "checkpoint.restore_from": str(tmp / "ck_full"),
        "checkpoint.restore_step": 5}))
    recs = _records(tmp_path / "from")
    assert [r["step"] for r in recs] == list(range(6, 11))
    assert _losses(tmp_path / "from") == _losses(tmp / "full")[5:]
    with pytest.raises(FileNotFoundError):
        _port_run(_tiny_node(tmp_path, "none", "ck_x", **{
            "checkpoint.restore_from": str(tmp_path / "empty")}))


def test_sigterm_commits_an_emergency_checkpoint_and_resumes(tiny_runs, tmp_path):
    tmp, init, _ = tiny_runs
    node = _tiny_node(tmp_path, "pre", "ck", **{"checkpoint.async_save": True})

    def sigterm_at_step_3(recipe):
        run_step = recipe.run_step

        def step_then_signal(microbatches):
            out = run_step(microbatches)
            if recipe.step_scheduler.step == 3:
                os.kill(os.getpid(), signal.SIGTERM)
                time.sleep(0.01)  # the handler runs between bytecodes
            return out

        recipe.run_step = step_then_signal

    previous = signal.getsignal(signal.SIGTERM)
    try:
        pre = _port_run(node, init, before_loop=sigterm_at_step_3)
    finally:
        signal.signal(signal.SIGTERM, previous)
    recs = _records(tmp_path / "pre")
    assert [r["step"] for r in recs] == [1, 2, 3, 3]
    event = recs[-1]
    assert event["event"] == "emergency_checkpoint"
    assert event["saved"] and event["committed"]
    assert pre.checkpointer.all_steps() == [3]
    assert not os.path.exists(tmp_path / "ck" / "hf")  # no export when preempted

    try:
        _port_run(_tiny_node(tmp_path, "pre", "ck"))
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert _losses(tmp_path / "pre") == _losses(tmp / "full")


def test_consolidated_export_reads_back_in_jax_bitwise(tiny_runs):
    tmp, _, full = tiny_runs
    export = tmp / "ck_full" / "hf"
    hf = load_yaml(TINY_YAML).get("model.hf_config").to_dict()
    spec = j_get_model_spec(hf)
    cfg = spec.config_from_hf(hf)
    reader = JReader(str(export))
    assert reader.hf_config() == hf
    params = j_get_adapter(spec.adapter_name, cfg, **spec.adapter_kwargs).from_hf(reader)
    got = {k: torch.from_numpy(np.array(v)) for k, v in _flat(_np_tree(params)).items()}
    assert _trees_bitwise_equal(got, _flat(full.train_state.params))


def _moe_node(tmp_path, run, **overrides):
    node = load_yaml(MOE_YAML)
    node.set("run_dir", str(tmp_path / run))
    node.set("auto_resume", True)
    node.set("checkpoint", {"enabled": True, "checkpoint_dir": str(tmp_path / f"ck_{run}"),
                            "async_save": False})
    node.set("step_scheduler.max_steps", 4)
    node.set("step_scheduler.ckpt_every_steps", 2)
    for key, value in overrides.items():
        node.set(key, value)
    return node


def test_moe_resume_keeps_the_gate_bias_and_the_curve(tmp_path):
    full = _port_run(_moe_node(tmp_path, "full"))
    assert full.is_moe and full.model_cfg.moe.gate_bias_update_speed > 0
    _port_run(_moe_node(tmp_path, "half", **{"step_scheduler.max_steps": 2}))
    resumed = _port_run(_moe_node(tmp_path, "half"))
    bias = ("moe_layers", "moe", "gate", "e_score_bias")

    def get(params):
        for key in bias:
            params = params[key]
        return params

    assert _losses(tmp_path / "half") == _losses(tmp_path / "full")
    assert ([r["moe_load_imbalance"] for r in _records(tmp_path / "half")]
            == [r["moe_load_imbalance"] for r in _records(tmp_path / "full")])
    assert torch.equal(get(resumed.train_state.params), get(full.train_state.params))
    assert not torch.equal(get(full.train_state.params),
                           torch.zeros_like(get(full.train_state.params)))
