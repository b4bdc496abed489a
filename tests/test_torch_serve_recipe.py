"""The `llm_serve` recipe, the JAX package's and the port's, on the CPU.

Both recipes read the same HF checkpoint, written by the JAX package's
`save_hf_checkpoint` from its own seeded weights (the two packages draw
random weights from different generators, so a checkpoint is the way to
give both the same model). Then:

- `examples/llm_serve/llama_serve_smoke.yaml` (prefix-cache admission) on
  the fp pool, on the int8 pool and, written here, on a tiny DeepSeek-V3
  decoder (MLA + MoE): `generations.jsonl` equal record for record (greedy,
  fp32), and `serving.jsonl` with the JAX keys, line for line;
- the six other `llama_serve_*_smoke.yaml` raise NotImplementedError
  naming the section the port does not run;
- the training recipe from a checkpoint: the JAX loss curve within 1e-4
  relative over 5 steps (docs/PARITY.md).
"""

import json

import jax
import numpy as np
import pytest
import yaml

from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.checkpoint.hf_adapter import save_hf_checkpoint as j_save_hf_checkpoint
from automodel_tpu.config import parse_args_and_load_config as j_parse
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.recipes.llm.serve import ServeRecipe as JServeRecipe
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JTrainRecipe,
)
from automodel_tpu_torch.cli import app
from automodel_tpu_torch.config import ConfigNode, parse_args_and_load_config
from automodel_tpu_torch.recipes.llm.serve import ServeRecipe
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)

SERVE_YAML = "examples/llm_serve/llama_serve_smoke.yaml"
TRAIN_YAML = "examples/llm_finetune/tiny_llama_mock_smoke.yaml"
TINY_DEEPSEEK = {
    "architectures": ["DeepseekV3ForCausalLM"], "vocab_size": 128,
    "hidden_size": 32, "intermediate_size": 64, "moe_intermediate_size": 16,
    "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4,
    "n_shared_experts": 2, "n_routed_experts": 8, "num_experts_per_tok": 2,
    "n_group": 2, "topk_group": 1, "routed_scaling_factor": 2.446,
    "kv_lora_rank": 16, "q_lora_rank": 12, "qk_rope_head_dim": 8,
    "qk_nope_head_dim": 8, "v_head_dim": 8, "first_k_dense_replace": 1,
    "norm_topk_prob": True, "scoring_func": "sigmoid", "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 256,
    "num_nextn_predict_layers": 0, "tie_word_embeddings": False,
}


def write_jax_checkpoint(hf: dict, out_dir, seed: int = 0) -> dict:
    """JAX-initialised weights of `hf`'s model (fp32), nonzero routing
    correction biases, saved by the JAX package; returns the numpy params."""
    spec = j_get_model_spec(hf)
    cfg = spec.config_from_hf(hf, dtype=jax.numpy.float32)
    params = jax.tree.map(np.asarray, spec.module.init(cfg, jax.random.key(seed)))
    gate = params.get("moe_layers", {}).get("moe", {}).get("gate", {})
    if "e_score_bias" in gate:
        rng = np.random.default_rng(seed)
        gate["e_score_bias"] = rng.normal(0, 0.1, gate["e_score_bias"].shape).astype(np.float32)
    adapter = j_get_adapter(spec.adapter_name, cfg, **spec.adapter_kwargs)
    j_save_hf_checkpoint(adapter.to_hf(params), str(out_dir), hf_config=hf)
    return params


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    llama = yaml.safe_load(open(SERVE_YAML))["model"]["hf_config"]
    train = yaml.safe_load(open(TRAIN_YAML))["model"]["hf_config"]
    write_jax_checkpoint(llama, root / "llama", seed=3)
    write_jax_checkpoint(TINY_DEEPSEEK, root / "deepseek", seed=4)
    write_jax_checkpoint(train, root / "train", seed=5)
    return root


def deepseek_yaml(tmp_path) -> str:
    """The serve smoke YAML with the tiny DeepSeek-V3 model."""
    node = yaml.safe_load(open(SERVE_YAML))
    node["model"]["hf_config"] = TINY_DEEPSEEK
    path = tmp_path / "deepseek_serve_smoke.yaml"
    path.write_text(yaml.safe_dump(node))
    return str(path)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def serve_both(yaml_path, ckpt, tmp_path, extra=()):
    """Run the JAX and the port's serve recipe; return their run dirs."""
    dirs = {}
    for name in ("jax", "port"):
        argv = [yaml_path, f"--model.pretrained_path={ckpt}",
                f"--run_dir={tmp_path / name}", *extra]
        if name == "jax":
            recipe = JServeRecipe(j_parse(argv))
        else:
            recipe = ServeRecipe(parse_args_and_load_config(argv), device="cpu")
        recipe.setup()
        recipe.run_train_validation_loop()
        dirs[name] = tmp_path / name
    return dirs


@pytest.mark.parametrize("case", ["llama_fp_pool", "llama_int8_pool", "deepseek_fp_pool"])
def test_generations_match_jax_recipe(case, checkpoints, tmp_path, capsys):
    if case.startswith("deepseek"):
        yaml_path, ckpt = deepseek_yaml(tmp_path), checkpoints / "deepseek"
    else:
        yaml_path, ckpt = SERVE_YAML, checkpoints / "llama"
    extra = ["--serving.kv_cache_dtype=int8"] if "int8" in case else []
    dirs = serve_both(yaml_path, ckpt, tmp_path, extra)
    want = _records(dirs["jax"] / "generations.jsonl")
    got = _records(dirs["port"] / "generations.jsonl")
    assert len(want) == 6 and all(len(r["generated_ids"]) == 6 for r in want)
    assert got == want
    j_log = _records(dirs["jax"] / "serving.jsonl")
    t_log = _records(dirs["port"] / "serving.jsonl")
    assert [sorted(r) for r in t_log] == [sorted(r) for r in j_log]
    summaries = [json.loads(line) for line in capsys.readouterr().out.splitlines()
                 if line.startswith('{"metric": "serving_decode"')]
    assert len(summaries) == 2 and summaries[0]["new_tokens"] == summaries[1]["new_tokens"]


@pytest.mark.parametrize("name,section", [
    ("online", "serving.online"),
    ("sharded", "serving.mesh"),
    ("disagg", "serving.disaggregation"),
    ("spec", "serving.speculative"),
    ("traced", "serving.online"),
    ("chaos", "serving.mesh"),
])
def test_other_serve_yamls_raise_naming_their_section(name, section, tmp_path):
    cfg = parse_args_and_load_config([f"examples/llm_serve/llama_serve_{name}_smoke.yaml",
                                      f"--run_dir={tmp_path}"])
    assert app.resolve_recipe_class(cfg) is ServeRecipe
    with pytest.raises(NotImplementedError, match=section):
        ServeRecipe(cfg, device="cpu").setup()


def test_serving_sections_parse_defaults_and_refuse_more(tmp_path):
    """Sections at their defaults pass; each one that asks for more than
    the single-replica offline engine raises (observability runs, but its
    `http_port` belongs to the online frontend); unknown keys raise."""
    base = [SERVE_YAML, f"--run_dir={tmp_path}", "--serving.mesh.replicas=1",
            "--serving.online.enabled=false", "--serving.resilience.enabled=true",
            "--serving.observability.flight_recorder_len=64"]
    ServeRecipe(parse_args_and_load_config(base), device="cpu").typed.refuse_unported_serving()
    for override, match in (("--serving.mesh.tp=2", "serving.mesh"),
                            ("--serving.observability.http_port=0",
                             "serving.observability.http_port"),
                            ("--serving.disaggregation.enabled=true",
                             "serving.disaggregation")):
        recipe = ServeRecipe(parse_args_and_load_config(base + [override]), device="cpu")
        with pytest.raises(NotImplementedError, match=match):
            recipe.typed.refuse_unported_serving()
    recipe = ServeRecipe(parse_args_and_load_config(base + ["--serving.online.bogus=1"]),
                         device="cpu")
    with pytest.raises(ValueError, match="bogus"):
        recipe.typed.refuse_unported_serving()


def test_train_recipe_from_checkpoint_matches_jax(checkpoints, tmp_path):
    """docs/PARITY.md: both training recipes start from the same checkpoint;
    losses within 1e-4 relative over 5 steps."""
    losses = {}
    for name in ("jax", "port"):
        argv = [TRAIN_YAML, f"--model.pretrained_path={checkpoints / 'train'}",
                "--checkpoint.enabled=false", f"--run_dir={tmp_path / name}",
                "--step_scheduler.max_steps=5"]
        if name == "jax":
            recipe = JTrainRecipe(j_parse(argv))
        else:
            recipe = TrainFinetuneRecipeForNextTokenPrediction(
                parse_args_and_load_config(argv), device="cpu")
        recipe.setup()
        recipe.run_train_validation_loop()
        losses[name] = np.array([r["loss"] for r in
                                 _records(tmp_path / name / "training.jsonl")])
    assert len(losses["jax"]) == len(losses["port"]) == 5
    rel = np.abs(losses["port"] - losses["jax"]) / np.abs(losses["jax"])
    assert rel.max() <= 1e-4, rel


def test_cli_resolves_llm_serve():
    assert app.resolve_recipe_class(ConfigNode({"recipe": "llm_serve"})) is ServeRecipe
