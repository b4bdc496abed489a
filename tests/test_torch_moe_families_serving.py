"""Port parity of the GQA MoE families' serving and recipes on the CPU, the
JAX package beside `automodel_tpu_torch` (`device="cpu"`) on the same
weights, requests and YAMLs.

- Qwen3-MoE and gpt-oss (the smoke YAMLs' models, every bias, sink,
  correction bias and norm scale drawn at random, gpt-oss's experts
  scaled past the clamp) served by the JAX `ServingEngine` and the port's
  on the fp and the int8 pool: greedy outputs token for token and the
  engine statistics equal. gpt-oss's prompts are longer than its 16-token
  window; its layers alternate window + sinks and sinks alone.
- GLM-4.5 (rotary on half of each head) on the fp pool, token for token:
  the partial rotary reaches the paged pool; the same engine rotating the
  whole head gives other tokens.
- The smoke YAMLs of Qwen3-MoE (in fp32, its `ep: 2` set to 1), gpt-oss
  and GLM-4.5 through both packages' training recipes from one HF
  checkpoint the JAX package writes (`model.pretrained_path`), 3 steps:
  losses within 1e-4 relative (docs/PARITY.md). gpt-oss's checkpoint has
  its expert kernels scaled so that gate and up values pass the clamp,
  and random sinks: lifting the clamp changes its first loss.
- `qwen3_moe_ep_smoke.yaml` as written (`ep: 2`) is refused by the port.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_moe_families import _tiny, smoke_hf

from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.checkpoint.hf_adapter import save_hf_checkpoint as j_save
from automodel_tpu.config import parse_args_and_load_config as j_parse
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu.serving import Request as JRequest
from automodel_tpu.serving import ServingConfig as JServingConfig
from automodel_tpu.serving import ServingEngine as JServingEngine
from automodel_tpu_torch.config import parse_args_and_load_config
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine

# prompts of 17-29 tokens over gpt-oss's 16-token window, 4-token pages,
# chunked prefill
SERVE = dict(page_size=4, num_pages=64, max_slots=3, pages_per_slot=12,
             token_budget=8, prefill_chunk=4)
PROMPT_LENS, ARRIVALS, MAX_NEW = (17, 29, 21, 18), (0, 0, 2, 5), 8
CLAMP_SCALE = 12.0  # gpt-oss's gate and up kernels: values pass +-7


def _serve(family, kv_cache_dtype, tcfg_fn=None):
    """(JAX outputs and stats, the port's, the port's engine) for the
    family's tiny model on the same requests."""
    hf, jcfg, jp = _tiny(family, seed=3,
                         clamp_scale=CLAMP_SCALE if family == "gpt_oss" else 1.0)
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32)
    if tcfg_fn is not None:
        tcfg = tcfg_fn(tcfg)
    prompts = [[int(t) for t in np.random.default_rng(50 + i).integers(
        1, hf["vocab_size"], (n,))] for i, n in enumerate(PROMPT_LENS)]
    je = JServingEngine(jax.tree.map(jnp.asarray, jp), jcfg,
                        JServingConfig(**SERVE, kv_cache_dtype=kv_cache_dtype))
    want = je.serve_batch([JRequest(prompt=list(p), max_new_tokens=MAX_NEW, arrival=a)
                           for p, a in zip(prompts, ARRIVALS)])
    te = ServingEngine(params_from_jax(jp, device="cpu"), tcfg,
                       ServingConfig(**SERVE, kv_cache_dtype=kv_cache_dtype), device="cpu")
    got = te.serve_batch([Request(prompt=list(p), max_new_tokens=MAX_NEW, arrival=a)
                          for p, a in zip(prompts, ARRIVALS)])
    return want, got, te


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
@pytest.mark.parametrize("family", ["qwen3_moe", "gpt_oss"])
def test_engine_token_equal_to_jax(family, kv_cache_dtype):
    want, got, te = _serve(family, kv_cache_dtype)
    assert got["outputs"] == want["outputs"]
    assert all(len(o) == MAX_NEW for o in got["outputs"])
    for key in ("steps", "new_tokens", "tokens_fed", "preemptions"):
        assert got["stats"][key] == want["stats"][key], key
    if family == "gpt_oss":  # window + sinks, then sinks alone, per layer
        assert te._windows == [16, 0]
        assert all("sinks" in lp for _, _, lp, _ in te._layers)
        assert min(PROMPT_LENS) > 16


def test_partial_rotary_engine_token_equal_to_jax():
    """GLM-4.5 rotates half of each head: the engine's q/k rows in the pool
    carry it (the JAX engine's tokens); rotating every channel gives other
    tokens."""
    want, got, te = _serve("glm4_moe", None)
    assert te.cfg.rope_dim == te.cfg.resolved_head_dim // 2
    assert got["outputs"] == want["outputs"]
    _, whole, _ = _serve("glm4_moe", None, lambda c: dataclasses.replace(
        c, partial_rotary_factor=1.0))
    assert whole["outputs"] != got["outputs"]


def _losses(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


SMOKE = {"qwen3_moe": "qwen3_moe_ep", "gpt_oss": "gpt_oss", "glm4_moe": "glm4_moe"}
STEPS = 3


@pytest.mark.parametrize("family", sorted(SMOKE))
def test_smoke_recipe_loss_curve_matches_live_jax_run(family, tmp_path):
    """docs/PARITY.md: both training recipes from the JAX package's HF
    checkpoint of the smoke YAML's model, the same YAML and mock batches:
    losses within 1e-4 relative."""
    clamp = CLAMP_SCALE if family == "gpt_oss" else 1.0
    hf, jcfg, params = _tiny(family, seed=6, clamp_scale=clamp)
    spec = j_get_model_spec(hf)
    j_save(j_get_adapter(spec.adapter_name, jcfg, **spec.adapter_kwargs).to_hf(params),
           str(tmp_path / "ckpt"), hf_config=hf)
    yaml_path = f"examples/llm_finetune/{SMOKE[family]}_smoke.yaml"
    losses = {}
    for name in ("jax", "port"):
        argv = [yaml_path, f"--model.pretrained_path={tmp_path / 'ckpt'}",
                "--checkpoint.enabled=false", f"--run_dir={tmp_path / name}",
                f"--step_scheduler.max_steps={STEPS}", "--distributed.ep=1",
                "--model.dtype=float32"]
        if name == "jax":
            recipe = JRecipe(j_parse(argv))
        else:
            recipe = TrainFinetuneRecipeForNextTokenPrediction(
                parse_args_and_load_config(argv), device="cpu")
        recipe.setup()
        recipe.run_train_validation_loop()
        losses[name] = np.array(_losses(tmp_path / name / "training.jsonl"))
    assert len(losses["jax"]) == len(losses["port"]) == STEPS
    rel = np.abs(losses["port"] - losses["jax"]) / np.abs(losses["jax"])
    assert rel.max() <= 1e-4, rel
    if family == "gpt_oss":
        # the checkpoint's model reaches the clamp: lifting it moves the loss
        tcfg = recipe.model_cfg
        batch = next(iter(recipe.dataloader))
        ids = torch.from_numpy(np.asarray(batch["input_ids"]).reshape(-1, batch["input_ids"].shape[-1]))
        first = {}
        for limit in (7.0, 1e9):
            cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, swiglu_limit=limit))
            with torch.no_grad():
                first[limit], _ = moe_decoder.forward(params_from_jax(params, device="cpu"),
                                                      cfg, ids)
        assert (first[7.0] - first[1e9]).abs().max() > 1e-3


def test_ep_smoke_yaml_as_written_is_refused():
    """`qwen3_moe_ep_smoke.yaml` sets `ep: 2`: the port trains on one device
    and says so, naming the axis."""
    recipe = TrainFinetuneRecipeForNextTokenPrediction(parse_args_and_load_config(
        ["examples/llm_finetune/qwen3_moe_ep_smoke.yaml", "--checkpoint.enabled=false"]),
        device="cpu")
    with pytest.raises(NotImplementedError, match="distributed.ep=2"):
        recipe.setup()
    assert smoke_hf("qwen3_moe")["num_experts"] == 8
