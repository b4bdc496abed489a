"""The DSA families' checkpoints and smoke YAMLs through both packages on
the CPU (DeepSeek-V3.2, DeepSeek-V4, GLM-5's `GlmMoeDsaForCausalLM`).

- HF checkpoints both ways, bit for bit: the DeepSeek indexer's
  `self_attn.indexer.{wq,wk,wgate}` and GLM's `{wq_b,wk,k_norm,
  weights_proj}`; an IndexShare "shared" layer writes no indexer keys and
  reads back zeros.
- A V3-style checkpoint (no indexer) read as DeepSeek-V3.2: both
  packages' adapters leave the leaf out, and the port's recipe draws fresh
  indexers of JAX's shapes and trains.
- `deepseek_v32_smoke.yaml`, `deepseek_v4_dsa_smoke.yaml` (5 of its 20
  steps) and `glm_moe_dsa_smoke.yaml` from one HF checkpoint the JAX
  package writes (`model.pretrained_path`; `distributed.ep` 1, the port
  trains on one device): losses within 1e-4 relative (docs/PARITY.md).
"""

import json

import jax
import numpy as np
import pytest
import torch
from test_torch_dsa import _flat, _moe_params, smoke_hf
from test_torch_moe_families import assert_trees_bitwise

from automodel_tpu.checkpoint.hf_adapter import HFCheckpointReader as JReader
from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.checkpoint.hf_adapter import save_hf_checkpoint as j_save
from automodel_tpu.config import parse_args_and_load_config as j_parse
from automodel_tpu.models.llm import mla as j_mla
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu_torch.checkpoint import HFCheckpointReader, get_adapter, save_hf_checkpoint
from automodel_tpu_torch.config import parse_args_and_load_config
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)

# YAML -> its steps here (the YAMLs' own, DeepSeek-V4's cut 20 -> 5)
SMOKE_STEPS = {"deepseek_v32": 2, "deepseek_v4_dsa": 5, "glm_moe_dsa": 3}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: the models are tiny, and under the tier-1
    run's workers several threads per process oversubscribe the cores
    (the recipe cases ran 10-20x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name, seed):
    """The smoke model's HF config, JAX's config and numpy params (norm
    scales, biases and the correction bias at random), an IndexShare
    shared layer's indexer rows zeroed (HF checkpoints carry none)."""
    hf = smoke_hf(name)
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32)
    jcfg = j_get_model_spec(hf).config_from_hf(hf, dtype=np.float32)
    params = _moe_params(tcfg, seed)
    for i, t in enumerate(tcfg.dsa_indexer_types or ()):
        if t == "shared":
            key, li = (("dense_layers", i) if i < tcfg.first_k_dense
                       else ("moe_layers", i - tcfg.first_k_dense))
            for leaf in _flat(params[key]["indexer"]).values():
                leaf[li] = 0.0
    return hf, jcfg, tcfg, params


@pytest.mark.parametrize("name", ("deepseek_v32", "glm_moe_dsa"))
def test_checkpoints_round_trip_bitwise(name, tmp_path):
    hf, jcfg, tcfg, params = _model(name, 1)
    other = _model(name, 2)[3]
    kw = get_model_spec(hf).adapter_kwargs
    assert kw == j_get_model_spec(hf).adapter_kwargs == {"style": "deepseek"}
    j_adapter = j_get_adapter("moe_decoder", jcfg, **kw)
    j_save(j_adapter.to_hf(params), str(tmp_path / "jax"), hf_config=hf)
    adapter = get_adapter("moe_decoder", tcfg, **kw)
    with HFCheckpointReader(str(tmp_path / "jax")) as reader:
        names = sorted(reader.keys())
        got = adapter.from_hf(reader, device="cpu", dtype=torch.float32)
    assert names == sorted(n for n, _ in adapter.to_hf(params_from_jax(params, device="cpu")))
    assert_trees_bitwise(got, params_from_jax(params, device="cpu"))
    save_hf_checkpoint(adapter.to_hf(params_from_jax(other, device="cpu")),
                       str(tmp_path / "port"), hf_config=hf)
    assert_trees_bitwise(j_adapter.from_hf(JReader(str(tmp_path / "port"))), other)
    ix = [n for n in names if ".indexer." in n]
    if name == "glm_moe_dsa":  # layer 1 is "shared": no indexer keys
        assert {n.split(".")[2] for n in ix} == {"0"}
        assert "model.layers.0.self_attn.indexer.weights_proj.weight" in ix
        assert "model.layers.0.self_attn.indexer.k_norm.bias" in ix
    else:
        assert "model.layers.1.self_attn.indexer.wgate.weight" in ix


def test_v3_checkpoint_backfills_fresh_indexers(tmp_path):
    """A checkpoint written as DeepSeek-V3 (no indexer keys) read as
    DeepSeek-V3.2: no indexer leaf from either package's adapter; the
    port's recipe draws fresh ones of the shapes JAX's backfill draws
    (`init_indexer`) and trains."""
    hf, jcfg, tcfg, params = _model("deepseek_v32", 3)
    v3 = {k: v for k, v in hf.items() if not k.startswith("index_")}
    v3["architectures"] = ["DeepseekV3ForCausalLM"]
    no_ix = {k: ({kk: vv for kk, vv in v.items() if kk != "indexer"}
                 if isinstance(v, dict) else v) for k, v in params.items()}
    j_v3 = j_get_model_spec(v3).config_from_hf(v3, dtype=np.float32)
    j_save(j_get_adapter("moe_decoder", j_v3, style="deepseek").to_hf(no_ix),
           str(tmp_path / "ckpt"), hf_config=hf)  # config.json says V3.2
    with HFCheckpointReader(str(tmp_path / "ckpt")) as reader:
        got = get_adapter("moe_decoder", tcfg, style="deepseek").from_hf(
            reader, device="cpu", dtype=torch.float32)
    assert "indexer" not in got["dense_layers"] and "indexer" not in got["moe_layers"]
    j_got = j_get_adapter("moe_decoder", jcfg, style="deepseek").from_hf(
        JReader(str(tmp_path / "ckpt")))
    assert "indexer" not in j_got["dense_layers"] and "indexer" not in j_got["moe_layers"]
    argv = ["examples/llm_finetune/deepseek_v32_smoke.yaml",
            f"--model.pretrained_path={tmp_path / 'ckpt'}", f"--run_dir={tmp_path / 'port'}"]
    recipe = TrainFinetuneRecipeForNextTokenPrediction(parse_args_and_load_config(argv),
                                                       device="cpu")
    recipe.setup()
    recipe.run_train_validation_loop()
    with open(tmp_path / "port" / "training.jsonl") as f:
        assert all(np.isfinite(json.loads(line)["loss"]) for line in f)
    trained = recipe.train_state.params
    for key in ("dense_layers", "moe_layers"):
        L = trained[key]["input_norm"]["scale"].shape[0]
        want = jax.eval_shape(lambda: j_mla.init_indexer(jcfg, jax.random.key(0), L))
        got = {p: tuple(v.shape) for p, v in _flat(trained[key]["indexer"]).items()}
        assert got == {p: v.shape for p, v in _flat(want).items()}, key
    # the rest of the weights are the checkpoint's
    np.testing.assert_array_equal(
        trained["dense_layers"]["q_down_proj"]["kernel"].detach().numpy().shape,
        params["dense_layers"]["q_down_proj"]["kernel"].shape)


@pytest.mark.parametrize("name", sorted(SMOKE_STEPS))
def test_smoke_recipe_loss_curve_matches_live_jax_run(name, tmp_path):
    hf, jcfg, _, params = _model(name, 4)
    spec = j_get_model_spec(hf)
    j_save(j_get_adapter(spec.adapter_name, jcfg, **spec.adapter_kwargs).to_hf(params),
           str(tmp_path / "ckpt"), hf_config=hf)
    losses = {}
    for pkg in ("jax", "port"):
        argv = [f"examples/llm_finetune/{name}_smoke.yaml",
                f"--model.pretrained_path={tmp_path / 'ckpt'}",
                f"--run_dir={tmp_path / pkg}", "--distributed.ep=1",
                f"--step_scheduler.max_steps={SMOKE_STEPS[name]}",
                "--checkpoint.enabled=false"]
        recipe = (JRecipe(j_parse(argv)) if pkg == "jax" else
                  TrainFinetuneRecipeForNextTokenPrediction(
                      parse_args_and_load_config(argv), device="cpu"))
        recipe.setup()
        recipe.run_train_validation_loop()
        with open(tmp_path / pkg / "training.jsonl") as f:
            losses[pkg] = np.array([json.loads(line)["loss"] for line in f])
    assert len(losses["jax"]) == len(losses["port"]) == SMOKE_STEPS[name]
    rel = np.abs(losses["port"] - losses["jax"]) / np.abs(losses["jax"])
    assert rel.max() <= 1e-4, rel
    assert jax.device_count() >= 1
