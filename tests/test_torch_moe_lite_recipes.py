"""The smoke YAMLs of GLM-4.7-Flash (`Glm4MoeLiteForCausalLM`), Mistral-4
and Hy-MT2 through both packages' training recipes on the CPU, from one HF
checkpoint the JAX package writes (`model.pretrained_path`), the YAMLs'
own 2 steps:
losses within 1e-4 relative (docs/PARITY.md), and Hy-MT2's expert bias,
which moves, equal after the run.
"""

import json

import numpy as np
import pytest
from test_torch_moe_lite_families import tiny

from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.checkpoint.hf_adapter import save_hf_checkpoint as j_save
from automodel_tpu.config import parse_args_and_load_config as j_parse
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu_torch.config import parse_args_and_load_config
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)


def _losses(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


STEPS = 2  # the YAMLs' step_scheduler.max_steps


@pytest.mark.parametrize("family", ("glm4_moe_lite", "mistral4", "hy_mt2"))
def test_smoke_recipe_loss_curve_matches_live_jax_run(family, tmp_path):
    """docs/PARITY.md: both training recipes from the JAX package's HF
    checkpoint of the smoke YAML's model, the same YAML and mock batches:
    losses within 1e-4 relative; Hy-MT2's correction bias moves in both."""
    hf, jcfg, params = tiny(family, seed=6)
    spec = j_get_model_spec(hf)
    j_save(j_get_adapter(spec.adapter_name, jcfg, **spec.adapter_kwargs).to_hf(params),
           str(tmp_path / "ckpt"), hf_config=hf)
    losses, recipes = {}, {}
    for name in ("jax", "port"):
        argv = [f"examples/llm_finetune/{family}_smoke.yaml",
                f"--model.pretrained_path={tmp_path / 'ckpt'}",
                f"--run_dir={tmp_path / name}"]
        if name == "jax":
            recipe = JRecipe(j_parse(argv))
        else:
            recipe = TrainFinetuneRecipeForNextTokenPrediction(
                parse_args_and_load_config(argv), device="cpu")
        recipe.setup()
        recipe.run_train_validation_loop()
        losses[name] = np.array(_losses(tmp_path / name / "training.jsonl"))
        recipes[name] = recipe
    assert len(losses["jax"]) == len(losses["port"]) == STEPS
    rel = np.abs(losses["port"] - losses["jax"]) / np.abs(losses["jax"])
    assert rel.max() <= 1e-4, rel
    if family == "hy_mt2":
        want = np.asarray(recipes["jax"].train_state.params["moe_layers"]["moe"]["gate"][
            "e_score_bias"])
        got = recipes["port"].train_state.params["moe_layers"]["moe"]["gate"][
            "e_score_bias"].detach().numpy()
        start = params["moe_layers"]["moe"]["gate"]["e_score_bias"]
        assert np.abs(want - start).max() > 1e-4
        np.testing.assert_allclose(got, want, atol=1e-6)
