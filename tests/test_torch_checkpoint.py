"""HF safetensors checkpoints between the JAX package and the port, on the
CPU at tiny sizes.

- the port's own safetensors reader and writer against the `safetensors`
  package (which the port never imports), both ways, bit for bit, for F32,
  F16, BF16 and F8_E4M3;
- a tiny Llama and a tiny DeepSeek-V3 (MLA + MoE, correction bias, shared
  experts, interleaved rope columns) go both ways bit for bit, in one file
  and sharded with the index: the JAX `save_hf_checkpoint(adapter.to_hf())`
  loaded by the port equals `convert.params_from_jax`, and the port's
  export read back by the JAX reader and adapter equals the JAX params
  (also in bf16);
- fp8 block-scaled weights dequantize as in the JAX reader, bit for bit;
- logits of the loaded port model match JAX within 1e-5 (fp32);
- the unported adapter styles raise; an export replaces an older one.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import safetensors
import safetensors.torch
import torch

from automodel_tpu.checkpoint.hf_adapter import HFCheckpointReader as JReader
from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.checkpoint.hf_adapter import save_hf_checkpoint as j_save
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu_torch.checkpoint import (
    DenseDecoderAdapter,
    HFCheckpointReader,
    MoEDecoderAdapter,
    get_adapter,
    save_hf_checkpoint,
)
from automodel_tpu_torch.checkpoint.safetensors_io import SafetensorsFile, save_file
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.models.registry import get_model_spec

ATOL = 1e-5
LLAMA = {"architectures": ["LlamaForCausalLM"], "vocab_size": 96, "hidden_size": 32,
         "intermediate_size": 48, "num_hidden_layers": 3, "num_attention_heads": 4,
         "num_key_value_heads": 2, "rms_norm_eps": 1e-6}
DEEPSEEK = {
    "architectures": ["DeepseekV3ForCausalLM"], "vocab_size": 64,
    "hidden_size": 32, "intermediate_size": 48, "moe_intermediate_size": 16,
    "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4,
    "n_shared_experts": 2, "n_routed_experts": 8, "num_experts_per_tok": 2,
    "n_group": 2, "topk_group": 1, "routed_scaling_factor": 2.446,
    "kv_lora_rank": 16, "q_lora_rank": 12, "qk_rope_head_dim": 8,
    "qk_nope_head_dim": 8, "v_head_dim": 8, "first_k_dense_replace": 1,
    "scoring_func": "sigmoid", "num_nextn_predict_layers": 0,
}
MODELS = {"llama": LLAMA, "deepseek": DEEPSEEK}
# ~3 layers' worth of the tiny models per shard: several shards and an index
SMALL_SHARD = 24 << 10


def _bits(a) -> np.ndarray:
    """A tensor or array as raw bytes of its values, for bitwise equality."""
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    a = np.ascontiguousarray(a)
    return a.reshape(-1).view(np.uint8)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def assert_trees_bitwise(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert tuple(g[k].shape) == tuple(np.shape(w[k])), k
        np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]), err_msg=str(k))


def jax_model(name, seed=0):
    """(hf config, JAX config, spec, numpy params) with nonzero correction
    biases, so their load is checked too."""
    hf = MODELS[name]
    spec = j_get_model_spec(hf)
    cfg = spec.config_from_hf(hf, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, spec.module.init(cfg, jax.random.key(seed)))
    gate = params.get("moe_layers", {}).get("moe", {}).get("gate", {})
    if "e_score_bias" in gate:
        gate["e_score_bias"] = np.random.default_rng(seed).normal(
            0, 0.1, gate["e_score_bias"].shape).astype(np.float32)
    return hf, cfg, spec, params


def port_adapter(hf):
    spec = get_model_spec(hf)
    cfg = spec.config_from_hf(hf, dtype=torch.float32)
    return cfg, get_adapter(spec.adapter_name, cfg, **spec.adapter_kwargs)


# -- the file format ----------------------------------------------------------
SAMPLE_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float8_e4m3fn]


def _sample(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a.weight": (torch.randn(5, 7, generator=g) * 3).to(dtype),
        "b": torch.randn(3, generator=g).to(dtype),
        "scalar": torch.randn((), generator=g).to(dtype),
        "empty": torch.zeros(0, 4).to(dtype),
        "odd": torch.randn(3, 3, 3, generator=g).to(dtype)[:, 1],  # strided
    }


@pytest.mark.parametrize("dtype", SAMPLE_DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_port_writer_is_read_by_safetensors(dtype, tmp_path):
    tensors = _sample(dtype)
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    with safetensors.safe_open(str(tmp_path / "x.safetensors"), framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert sorted(f.keys()) == sorted(tensors)
        for k, t in tensors.items():
            got = f.get_tensor(k)
            assert got.dtype == dtype and got.shape == t.shape, k
            np.testing.assert_array_equal(_bits(got), _bits(t), err_msg=k)


@pytest.mark.parametrize("dtype", SAMPLE_DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_safetensors_files_are_read_by_the_port(dtype, tmp_path):
    tensors = {k: v.contiguous() for k, v in _sample(dtype, seed=1).items()}
    safetensors.torch.save_file(tensors, str(tmp_path / "x.safetensors"))
    with SafetensorsFile(str(tmp_path / "x.safetensors")) as f:
        got = {k: f.get(k) for k in f.keys()}
    assert sorted(got) == sorted(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == dtype and got[k].shape == t.shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(t), err_msg=k)


# -- checkpoints between the packages ----------------------------------------
@pytest.mark.parametrize("sharded", [False, True], ids=["one_file", "sharded"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_jax_checkpoint_loads_into_the_port_bitwise(model, sharded, tmp_path):
    hf, cfg, spec, params = jax_model(model)
    j_adapter = j_get_adapter(spec.adapter_name, cfg, **spec.adapter_kwargs)
    j_save(j_adapter.to_hf(params), str(tmp_path / "ckpt"), hf_config=hf,
           max_shard_bytes=SMALL_SHARD if sharded else 4 << 30)
    files = os.listdir(tmp_path / "ckpt")
    assert ("model.safetensors.index.json" in files) == sharded
    _, adapter = port_adapter(hf)
    with HFCheckpointReader(str(tmp_path / "ckpt")) as reader:
        assert reader.hf_config() == hf
        got = adapter.from_hf(reader, device="cpu", dtype=torch.float32)
    assert_trees_bitwise(got, params_from_jax(params, device="cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sharded", [False, True], ids=["one_file", "sharded"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_port_checkpoint_loads_into_jax_bitwise(model, sharded, dtype, tmp_path):
    hf, cfg, spec, params = jax_model(model, seed=1)
    port_params = params_from_jax(params, device="cpu", dtype=dtype)
    _, adapter = port_adapter(hf)
    save_hf_checkpoint(adapter.to_hf(port_params), str(tmp_path / "ckpt"), hf_config=hf,
                       max_shard_bytes=SMALL_SHARD if sharded else 4 << 30)
    assert ("model.safetensors.index.json" in os.listdir(tmp_path / "ckpt")) == sharded
    j_adapter = j_get_adapter(spec.adapter_name, cfg, **spec.adapter_kwargs)
    reader = JReader(str(tmp_path / "ckpt"))
    assert reader.hf_config() == hf
    got = j_adapter.from_hf(reader)
    want = params if dtype == "float32" else jax.tree.map(
        lambda a: a.astype(ml_dtypes.bfloat16), params)
    assert_trees_bitwise(got, want)


# the dense adapter's optional entries, as the JAX adapter names them
DENSE_VARIANTS = {
    "attention_bias": dict(attention_bias=True),
    "qk_norm": dict(qk_norm=True),
    "post_norms": dict(use_post_norms=True),
    "o_bias_sinks_tied": dict(o_proj_bias=True, attention_sinks=True,
                              tie_word_embeddings=True),
}


@pytest.mark.parametrize("variant", sorted(DENSE_VARIANTS))
def test_dense_adapter_names_match_jax(variant):
    """Both adapters export the same names and values, and the port's
    import of them rebuilds the JAX params bit for bit."""
    kw = dict(vocab_size=40, hidden_size=16, intermediate_size=24, num_layers=2,
              num_heads=2, num_kv_heads=1, **DENSE_VARIANTS[variant])
    j_cfg = j_decoder.TransformerConfig(**kw, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, j_decoder.init(j_cfg, jax.random.key(0)))
    want = dict(j_get_adapter("dense_decoder", j_cfg).to_hf(params))
    adapter = DenseDecoderAdapter(decoder.TransformerConfig(**kw, dtype=torch.float32))
    got = dict(adapter.to_hf(params_from_jax(params, device="cpu")))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
    loaded = adapter.from_hf(lambda n: torch.tensor(want[n]),
                             device="cpu")
    assert_trees_bitwise(loaded, params_from_jax(params, device="cpu"))


def test_fp8_block_weights_dequantize_as_in_jax(tmp_path):
    """A DeepSeek-V3-style fp8 weight (float8_e4m3fn, one fp32 inverse scale
    per 4 x 8 tile, the grid ragged at both edges)."""
    g = torch.Generator().manual_seed(2)
    w = (torch.randn(10, 20, generator=g) * 4).to(torch.float8_e4m3fn)
    scale = torch.rand(3, 3, generator=g) + 0.5
    os.makedirs(tmp_path / "ckpt")
    safetensors.torch.save_file({"w.weight": w, "w.weight_scale_inv": scale},
                                str(tmp_path / "ckpt" / "model.safetensors"))
    with open(tmp_path / "ckpt" / "config.json", "w") as f:
        json.dump({"quantization_config": {"weight_block_size": [4, 8]}}, f)
    with HFCheckpointReader(str(tmp_path / "ckpt")) as reader:
        got = reader("w.weight")
    want = JReader(str(tmp_path / "ckpt"))("w.weight")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_loaded_port_model_logits_match_jax(tmp_path):
    hf, cfg, spec, params = jax_model("llama", seed=2)
    j_adapter = j_get_adapter(spec.adapter_name, cfg, **spec.adapter_kwargs)
    j_save(j_adapter.to_hf(params), str(tmp_path / "ckpt"), hf_config=hf)
    t_cfg, adapter = port_adapter(hf)
    with HFCheckpointReader(str(tmp_path / "ckpt")) as reader:
        t_params = adapter.from_hf(reader, device="cpu")
    ids = np.random.default_rng(0).integers(0, hf["vocab_size"], (2, 11)).astype(np.int32)
    j_cfg = j_decoder.TransformerConfig(**{**vars(cfg), "attn_impl": "xla",
                                           "remat_policy": "none"})
    want = j_decoder.forward(jax.tree.map(jnp.asarray, params), j_cfg, jnp.asarray(ids))
    got = decoder.forward(t_params, t_cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_unported_adapter_styles_raise():
    t_cfg, _ = port_adapter(LLAMA)
    ds_cfg, _ = port_adapter(DEEPSEEK)
    for style in ("glm4", "baichuan"):
        with pytest.raises(NotImplementedError, match=style):
            DenseDecoderAdapter(t_cfg, style=style)
    for style in ("hy_mt2", "glm4"):
        with pytest.raises(NotImplementedError, match=style):
            MoEDecoderAdapter(ds_cfg, style=style)
    # the GQA MoE families' styles are ported (tests/test_torch_moe_families.py)
    for style in ("bailing", "hunyuan"):
        DenseDecoderAdapter(t_cfg, style=style)
    for style in ("qwen3_moe", "mixtral", "gpt_oss", "minimax", "ernie", "hunyuan",
                  "bailing"):
        MoEDecoderAdapter(ds_cfg, style=style)
    with pytest.raises(NotImplementedError, match="DSA"):
        DenseDecoderAdapter(dataclasses.replace(t_cfg, dsa_index_topk=4))
    with pytest.raises(NotImplementedError, match="het_moe"):
        get_adapter("het_moe", t_cfg)


def test_export_replaces_an_older_one(tmp_path):
    """Publish by rename: a second export replaces the first's shards and
    index, keeps its other files, and leaves no staging directory."""
    hf, _, _, params = jax_model("llama")
    _, adapter = port_adapter(hf)
    tp = params_from_jax(params, device="cpu")
    out = tmp_path / "ckpt"
    save_hf_checkpoint(adapter.to_hf(tp), str(out), hf_config=hf, max_shard_bytes=SMALL_SHARD)
    (out / "tokenizer.json").write_text("{}")
    tp["final_norm"]["scale"] = tp["final_norm"]["scale"] + 1.0
    save_hf_checkpoint(adapter.to_hf(tp), str(out), hf_config=hf)
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    assert sorted(os.listdir(out)) == ["config.json", "model.safetensors", "tokenizer.json"]
    with HFCheckpointReader(str(out)) as reader:
        got = reader("model.norm.weight")
    np.testing.assert_array_equal(got.numpy(), tp["final_norm"]["scale"].numpy())
