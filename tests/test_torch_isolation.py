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
                if m in ("jax", "jaxlib", "automodel_tpu")
                or m.startswith(("jax.", "jaxlib.", "automodel_tpu.")))
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
    assert "automodel_tpu_torch.serving.engine" in res["modules"]
    assert "automodel_tpu_torch.ops.cuda.ragged_paged_attention" in res["modules"]
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


def test_unported_options_raise():
    from automodel_tpu_torch.models.llm import decoder
    from automodel_tpu_torch.serving import ServingConfig, ServingEngine

    for field, value in (("speculative", object()), ("kv_cache_dtype", "int8"),
                         ("serve_precision", "fp8")):
        with pytest.raises(NotImplementedError, match=field):
            ServingConfig(**{field: value})
    cfg = decoder.TransformerConfig(
        vocab_size=32, hidden_size=16, intermediate_size=24, num_layers=1,
        num_heads=2, num_kv_heads=1, sliding_window=4, dtype=torch.float32)
    params = decoder.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="mesh"):
        ServingEngine(params, cfg, device="cpu", mesh_ctx=object())
    # windows go through the kernel only if asked for the kernel
    with pytest.raises(NotImplementedError, match="windows"):
        ServingEngine(params, cfg, device="cpu", attn_impl="cuda")
    ServingEngine(params, cfg, device="cpu")


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
