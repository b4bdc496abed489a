"""Port parity of windowed serving on the CPU: tiny Gemma-2, Gemma-3, Mistral
and Qwen2 (`max_window_layers`) served by the JAX `ServingEngine` and the
port's, on the fp and the int8 pool, with the same weights and requests.

Every prompt is longer than its model's window, so the window masks in
prefill and decode. The JAX engine serves such models on its XLA path (the
Pallas kernels refuse windows); the port's serves every layer through the
paged-attention dispatcher with the layer's own window (0 for a global
layer), which on CPU tensors runs the plain version that the CUDA
kernels are held to. Greedy outputs must match token for token, and the
engine's statistics must agree; the same engine with every layer global
must give other tokens (the windows mask).

The user's path end to end: `examples/llm_finetune/gemma2_smoke.yaml`
trained by the port with the checkpointer on and `save_consolidated:
final`, then both packages' `llm_serve` recipes on that HF export with
prompts longer than the window: equal generations, on both pools.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.config import parse_args_and_load_config as j_parse
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.models.llm import families as j_families
from automodel_tpu.recipes.llm.serve import ServeRecipe as JServeRecipe
from automodel_tpu.serving import Request as JRequest
from automodel_tpu.serving import ServingConfig as JServingConfig
from automodel_tpu.serving import ServingEngine as JServingEngine
from automodel_tpu_torch.config import parse_args_and_load_config
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.llm import decoder, families
from automodel_tpu_torch.recipes.llm.serve import ServeRecipe
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine

SMALL = dict(vocab_size=256, hidden_size=32, intermediate_size=48,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, rms_norm_eps=1e-6, rope_theta=10000.0)
# family -> (HF config, the windows layer_windows gives its 2 layers)
MODELS = {
    "gemma2": (dict(SMALL, sliding_window=7, attn_logit_softcapping=20.0,
                    final_logit_softcapping=15.0, query_pre_attn_scalar=12),
               (7, None)),
    "gemma3": (dict(SMALL, sliding_window=6, sliding_window_pattern=2,
                    rope_local_base_freq=500.0, rope_theta=1000000.0,
                    query_pre_attn_scalar=12, final_logit_softcapping=15.0),
               (6, None)),
    "mistral": (dict(SMALL, sliding_window=5), (5, 5)),
    "qwen2": (dict(SMALL, use_sliding_window=True, sliding_window=6,
                   max_window_layers=1),
              (None, 6)),
}
# prompts of 11-23 tokens over windows of 5-7, 4-token pages, chunked prefill
SERVE = dict(page_size=4, num_pages=48, max_slots=3, pages_per_slot=10,
             token_budget=8, prefill_chunk=4)
PROMPT_LENS, ARRIVALS, MAX_NEW = (11, 23, 17, 14), (0, 0, 2, 5), 8


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    family = request.param
    hf, windows = MODELS[family]
    jcfg = getattr(j_families, f"{family}_config")(hf, dtype=jnp.float32,
                                                   remat_policy="none")
    tcfg = getattr(families, f"{family}_config")(hf, dtype=torch.float32)
    assert decoder.layer_windows(tcfg) == windows
    assert j_decoder.layer_windows(jcfg) == windows
    jp = jax.tree.map(np.asarray, j_decoder.init(jcfg, jax.random.key(3)))
    # nonzero norm scales: zero-centred norms would otherwise all be 1
    rng = np.random.default_rng(3)
    for name, node in jp["layers"].items():
        if name.endswith("norm"):
            node["scale"] = rng.normal(0, 0.3, node["scale"].shape).astype(np.float32)
    return family, jcfg, tcfg, jp, params_from_jax(jp, device="cpu")


def _prompts(vocab):
    return [[int(t) for t in np.random.default_rng(50 + i).integers(1, vocab, (n,))]
            for i, n in enumerate(PROMPT_LENS)]


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_windowed_engine_token_equal_to_jax(model, kv_cache_dtype):
    family, jcfg, tcfg, jp, tp = model
    prompts = _prompts(SMALL["vocab_size"])
    windows = [w for w in MODELS[family][1] if w]
    assert min(PROMPT_LENS) > max(windows)  # the window masks
    je = JServingEngine(jax.tree.map(jnp.asarray, jp), jcfg,
                        JServingConfig(**SERVE, kv_cache_dtype=kv_cache_dtype))
    te = ServingEngine(tp, tcfg, ServingConfig(**SERVE, kv_cache_dtype=kv_cache_dtype),
                       device="cpu")
    assert je._attn_impl == "xla" and te._windows == [w or 0 for w in MODELS[family][1]]
    want = je.serve_batch([JRequest(prompt=list(p), max_new_tokens=MAX_NEW, arrival=a)
                           for p, a in zip(prompts, ARRIVALS)])
    got = te.serve_batch([Request(prompt=list(p), max_new_tokens=MAX_NEW, arrival=a)
                          for p, a in zip(prompts, ARRIVALS)])
    assert got["outputs"] == want["outputs"]
    assert all(len(o) == MAX_NEW for o in got["outputs"])
    for key in ("steps", "new_tokens", "tokens_fed", "preemptions"):
        assert got["stats"][key] == want["stats"][key], key
    # the windows change the tokens: every layer global gives others
    glob = ServingEngine(tp, tcfg, ServingConfig(**SERVE, kv_cache_dtype=kv_cache_dtype),
                         device="cpu")
    glob._windows = [0] * len(glob._windows)
    unwindowed = glob.serve_batch([Request(prompt=list(p), max_new_tokens=MAX_NEW,
                                           arrival=a) for p, a in zip(prompts, ARRIVALS)])
    assert unwindowed["outputs"] != got["outputs"]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def gemma2_export(tmp_path_factory):
    """The Gemma-2 smoke YAML fine-tuned for 2 steps by the port, its
    consolidated HF export written at the end."""
    tmp = tmp_path_factory.mktemp("gemma2_export")
    recipe = TrainFinetuneRecipeForNextTokenPrediction(parse_args_and_load_config([
        "examples/llm_finetune/gemma2_smoke.yaml", f"--run_dir={tmp / 'train'}",
        "--checkpoint.enabled=true", f"--checkpoint.checkpoint_dir={tmp / 'ckpt'}",
        "--checkpoint.save_consolidated=final"]), device="cpu")
    recipe.setup()
    recipe.run_train_validation_loop()
    assert recipe.checkpointer.all_steps() == [2]
    return tmp / "ckpt" / "hf"


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_llm_serve_of_a_finetuned_gemma2_export_matches_jax(gemma2_export, tmp_path,
                                                            kv_cache_dtype):
    """Prompts of 24 tokens over the smoke model's window of 16."""
    gens = {}
    for name in ("jax", "port"):
        argv = ["examples/llm_serve/llama_serve_smoke.yaml",
                f"--model.pretrained_path={gemma2_export}", f"--run_dir={tmp_path / name}",
                "--dataset.seq_len=24", "--serving.pages_per_slot=10"]
        if kv_cache_dtype:
            argv.append(f"--serving.kv_cache_dtype={kv_cache_dtype}")
        if name == "jax":
            recipe = JServeRecipe(j_parse(argv))
        else:
            recipe = ServeRecipe(parse_args_and_load_config(argv), device="cpu")
        recipe.setup()
        if name == "port":
            assert recipe.model_spec.name == "gemma2"
            assert decoder.layer_windows(recipe.model_cfg) == (16, None)
        recipe.run_train_validation_loop()
        gens[name] = _records(tmp_path / name / "generations.jsonl")
    assert len(gens["port"]) == 6
    assert all(len(r["prompt_ids"]) == 24 and len(r["generated_ids"]) == 6
               for r in gens["port"])
    assert gens["port"] == gens["jax"]
