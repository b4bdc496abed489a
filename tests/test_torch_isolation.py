"""The port stands alone: no module of `automodel_tpu_torch`, and not
`chip_smoke.py`, loads JAX or the JAX package; its entry points refuse to
run on the CPU unless asked to."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import automodel_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    automodel_tpu_torch.__path__, "automodel_tpu_torch."))
for m in mods:
    importlib.import_module(m)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "automodel_tpu", "safetensors", "ml_dtypes")
                or m.startswith(("jax.", "jaxlib.", "automodel_tpu.", "safetensors.",
                                 "ml_dtypes.")))
print(json.dumps({"modules": mods, "leaked": leaked}))
"""


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_imports_no_jax():
    out = _run(["-c", _PROBE])
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("serving.engine", "ops.cuda.ragged_paged_attention",
                "ops.cuda.flash_attention", "ops.flash_attention", "cli.app",
                "recipes.llm.train_ft", "config.loader", "training.train_step",
                "loss.linear_ce", "optim.optimizer", "datasets.loader",
                "ops.quant", "ops.cuda.paged_mla_attention", "models.llm.mla",
                "moe.config", "moe.gate", "moe.experts", "moe.layer",
                "models.moe_lm.decoder", "models.moe_lm.families",
                "models.moe_lm.mtp", "models.registry", "inference.generate",
                "checkpoint.safetensors_io",
                "checkpoint.hf_adapter", "recipes.llm.serve", "peft.lora",
                "eval.sampling"):
        assert f"automodel_tpu_torch.{mod}" in res["modules"]
    assert res["leaked"] == []


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from automodel_tpu_torch.convert import params_from_jax
    from automodel_tpu_torch.models.llm import decoder
    from automodel_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = decoder.TransformerConfig(
        vocab_size=32, hidden_size=16, intermediate_size=24, num_layers=1,
        num_heads=2, num_kv_heads=1, dtype=torch.float32)
    params = decoder.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg, ServingConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": params["final_norm"]["scale"].numpy()})
    ServingEngine(params, cfg, ServingConfig(), device="cpu")  # asked for
    from automodel_tpu_torch.config import load_yaml
    from automodel_tpu_torch.recipes.llm.train_ft import (
        TrainFinetuneRecipeForNextTokenPrediction,
    )

    from automodel_tpu_torch.recipes.llm.serve import ServeRecipe

    node = load_yaml(str(ROOT / "examples/llm_finetune/tiny_llama_mock_smoke.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainFinetuneRecipeForNextTokenPrediction(node)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeRecipe(load_yaml(str(ROOT / "examples/llm_serve/llama_serve_smoke.yaml")))
    out = _run(["-m", "automodel_tpu_torch",
                "examples/llm_finetune/tiny_llama_mock_smoke.yaml",
                "--checkpoint.enabled=false"])
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_unported_options_raise():
    """What is still unported raises: speculative decoding, low-precision
    serve linears, a serving mesh and the DSA indexer. A windowed
    model asked onto the kernels reaches them (which refuse CPU tensors).
    int8 KV pages serve."""
    from automodel_tpu_torch.models.llm import decoder
    from automodel_tpu_torch.models.moe_lm.families import deepseek_v3_moe_config
    from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine

    for field, value in (("speculative", object()), ("serve_precision", "fp8")):
        with pytest.raises(NotImplementedError, match=field):
            ServingConfig(**{field: value})
    cfg = decoder.TransformerConfig(
        vocab_size=32, hidden_size=16, intermediate_size=24, num_layers=1,
        num_heads=2, num_kv_heads=1, sliding_window=4, dtype=torch.float32)
    params = decoder.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="mesh"):
        ServingEngine(params, cfg, device="cpu", mesh_ctx=object())
    # a windowed layer goes to the kernel when asked for: K4 takes windows,
    # and refuses CPU tensors
    with pytest.raises(ValueError, match="CUDA tensor"):
        ServingEngine(params, cfg, device="cpu", attn_impl="cuda").serve_batch(
            [Request(prompt=[1, 2, 3], max_new_tokens=2)])
    ServingEngine(params, cfg, device="cpu")
    # int8 KV pages serve
    sc = ServingConfig(page_size=4, num_pages=8, max_slots=1, pages_per_slot=2,
                       token_budget=4, kv_cache_dtype="int8")
    out = ServingEngine(params, cfg, sc, device="cpu").serve_batch(
        [Request(prompt=[1, 2, 3], max_new_tokens=2)])
    assert len(out["outputs"][0]) == 2
    # the DSA indexer; yarn rope (DeepSeek-V3's long-context scaling) builds
    hf = dict(vocab_size=32, hidden_size=16, intermediate_size=24,
              moe_intermediate_size=8, num_hidden_layers=2,
              num_attention_heads=2, n_routed_experts=4,
              num_experts_per_tok=2, kv_lora_rank=8, qk_nope_head_dim=4,
              qk_rope_head_dim=4, v_head_dim=4, first_k_dense_replace=1)
    yarn = deepseek_v3_moe_config(dict(hf, rope_scaling={"type": "yarn", "factor": 4.0}))
    assert yarn.attn_scale > 8 ** -0.5
    mla = deepseek_v3_moe_config(hf, dsa_index_topk=4, dtype=torch.float32)
    from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder

    with pytest.raises(NotImplementedError, match="DSA"):
        moe_decoder.init(mla, torch.Generator().manual_seed(0))


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
