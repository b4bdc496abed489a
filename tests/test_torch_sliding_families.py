"""Port parity of the sliding-window dense families (Mistral, Qwen2, Qwen3,
Gemma-2, Gemma-3) on the CPU: the JAX package and `automodel_tpu_torch`
fed the same HF configs, numpy weights, batches and checkpoints.

- `mistral_config`, `qwen2_config` (with `max_window_layers`),
  `qwen3_config`, `gemma2_config` and `gemma3_config` (its default 5:1
  pattern and explicit `layer_types`) against the JAX functions on the same
  HF dicts, google/gemma-2-2b's and google/gemma-3-1b-pt's among them:
  every field equal;
- the decoder `forward` of a tiny Gemma-2 and Gemma-3 (zero-centred norms,
  four norms, q/k norms, `gelu_tanh`, both soft caps, `embed_scale`,
  `query_pre_attn_scalar`, the local rope theta, tied embeddings, windows
  that mask) on packed batches: logits within 1e-5 and every gradient leaf
  within 1e-4 of its largest magnitude (fp32; only the order of operations
  differs), the port with the plain attention and with the flash path
  (whose passes on CPU tensors are K1-K3's plain versions);
- the loss curves of `examples/llm_finetune/{gemma2,gemma3,mistral,qwen2,
  qwen3}_smoke.yaml` through the port's recipe against a live JAX run from
  the same weights, one epoch (4 steps) within 1e-4 relative (docs/PARITY.md);
- HF checkpoints of a tiny Gemma-2 and Gemma-3 (tied head, four norms, q/k
  norms) both ways bit for bit, and the training recipe from the JAX
  package's checkpoint against the JAX loss curve within 1e-4 relative.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.checkpoint.hf_adapter import HFCheckpointReader as JReader
from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.checkpoint.hf_adapter import save_hf_checkpoint as j_save
from automodel_tpu.config import ConfigNode as JConfigNode
from automodel_tpu.config import parse_args_and_load_config as j_parse
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.models.llm import families as j_families
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu_torch.checkpoint import (
    HFCheckpointReader,
    get_adapter,
    save_hf_checkpoint,
)
from automodel_tpu_torch.config import load_yaml, parse_args_and_load_config
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.llm import decoder, families
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.training import init_train_state

FAMILIES = ("mistral", "qwen2", "qwen3", "gemma2", "gemma3")
SMALL = dict(vocab_size=96, hidden_size=32, intermediate_size=48,
             num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, rms_norm_eps=1e-6, rope_theta=10000.0)
# google/gemma-2-2b and google/gemma-3-1b-pt config.json (the numbers
# chip_smoke.py trains at)
GEMMA2_2B = dict(
    architectures=["Gemma2ForCausalLM"], vocab_size=256000, hidden_size=2304,
    intermediate_size=9216, num_hidden_layers=26, num_attention_heads=8,
    num_key_value_heads=4, head_dim=256, sliding_window=4096,
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
    query_pre_attn_scalar=256, rms_norm_eps=1e-6, rope_theta=10000.0,
    max_position_embeddings=8192, hidden_activation="gelu_pytorch_tanh")
GEMMA3_1B = dict(
    architectures=["Gemma3ForCausalLM"], vocab_size=262144, hidden_size=1152,
    intermediate_size=6912, num_hidden_layers=26, num_attention_heads=4,
    num_key_value_heads=1, head_dim=256, sliding_window=512,
    sliding_window_pattern=6, rope_theta=1000000.0,
    rope_local_base_freq=10000.0, query_pre_attn_scalar=256,
    rms_norm_eps=1e-6, max_position_embeddings=32768)
HF_CONFIGS = {
    "mistral_window": ("mistral", dict(SMALL, sliding_window=6)),
    "mistral_global": ("mistral", dict(SMALL)),
    "qwen2_max_window_layers": ("qwen2", dict(SMALL, use_sliding_window=True,
                                              sliding_window=6, max_window_layers=2)),
    "qwen2_no_window": ("qwen2", dict(SMALL, sliding_window=6)),
    "qwen3": ("qwen3", dict(SMALL)),
    "gemma2_alternating": ("gemma2", dict(SMALL, sliding_window=6,
                                          attn_logit_softcapping=50.0,
                                          final_logit_softcapping=30.0,
                                          query_pre_attn_scalar=16)),
    "gemma2_layer_types": ("gemma2", dict(SMALL, sliding_window=6, layer_types=[
        "full_attention", "sliding_attention", "sliding_attention", "full_attention"])),
    "gemma2_2b": ("gemma2", GEMMA2_2B),
    "gemma3_default_pattern": ("gemma3", dict(SMALL, num_hidden_layers=12,
                                              sliding_window=6,
                                              rope_local_base_freq=10000.0,
                                              query_pre_attn_scalar=16)),
    "gemma3_layer_types": ("gemma3", dict(SMALL, sliding_window=6,
                                          final_logit_softcapping=30.0,
                                          layer_types=["sliding_attention"] * 3
                                          + ["full_attention"])),
    "gemma3_1b": ("gemma3", GEMMA3_1B),
}
ARCH = {"mistral": "MistralForCausalLM", "qwen2": "Qwen2ForCausalLM",
        "qwen3": "Qwen3ForCausalLM", "gemma2": "Gemma2ForCausalLM",
        "gemma3": "Gemma3ForCausalLM"}
SMOKE = "examples/llm_finetune/{}_smoke.yaml"
# the smoke YAMLs' one epoch: 32 mock samples in microbatches of 8
STEPS = 4
# tiny Gemma-2 and Gemma-3 of the forward and checkpoint checks: 4 layers,
# a window of 5 that masks in 16-token batches
TINY = {
    "gemma2": dict(SMALL, architectures=["Gemma2ForCausalLM"], sliding_window=5,
                   attn_logit_softcapping=20.0, final_logit_softcapping=15.0,
                   query_pre_attn_scalar=12),
    "gemma3": dict(SMALL, architectures=["Gemma3ForCausalLM"], sliding_window=5,
                   sliding_window_pattern=2, rope_local_base_freq=500.0,
                   rope_theta=1000000.0, query_pre_attn_scalar=12,
                   final_logit_softcapping=15.0),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def assert_trees_bitwise(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert tuple(g[k].shape) == tuple(np.shape(w[k])), k
        np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]), err_msg=str(k))


@pytest.mark.parametrize("case", sorted(HF_CONFIGS))
def test_family_config_matches_jax(case):
    family, hf = HF_CONFIGS[case]
    want = getattr(j_families, f"{family}_config")(hf, dtype=jnp.float32)
    got = getattr(families, f"{family}_config")(hf, dtype=torch.float32)
    for f in dataclasses.fields(got):
        if f.name == "dtype":
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(g):  # rope scaling: the port's fields
            g = dataclasses.asdict(g)
            w = {k: v for k, v in dataclasses.asdict(w).items() if k in g}
        assert g == w, (f.name, g, w)
    if got.sliding_window is not None:
        assert set(decoder.layer_windows(got)) >= {got.sliding_window}
    # the registry hands the architecture to the dense decoder
    spec = get_model_spec(dict(hf, architectures=[ARCH[family]]))
    assert spec.module is decoder and spec.adapter_name == "dense_decoder"
    assert spec.config_from_hf is getattr(families, f"{family}_config")


def test_published_gemma_layer_patterns():
    """Gemma-2-2B: 13 sliding layers of 4096 tokens alternating with 13
    global ones; Gemma-3-1B: 22 sliding layers of 512 tokens, every 6th
    layer global, the local rope theta 10000 beside the global 1e6."""
    g2 = families.gemma2_config(GEMMA2_2B)
    w2 = decoder.layer_windows(g2)
    assert w2 == tuple(4096 if i % 2 == 0 else None for i in range(26))
    assert (g2.attn_soft_cap, g2.logits_soft_cap, g2.attn_scale) == (50.0, 30.0, 1 / 16)
    assert g2.tie_word_embeddings and g2.resolved_head_dim == 256
    g3 = families.gemma3_config(GEMMA3_1B)
    w3 = decoder.layer_windows(g3)
    assert sum(w is not None for w in w3) == 22
    assert [i for i, w in enumerate(w3) if w is None] == [5, 11, 17, 23]
    assert (g3.rope_local_theta, g3.rope_theta) == (10000.0, 1000000.0)
    assert g3.qk_norm and g3.num_kv_heads == 1 and g3.resolved_head_dim == 256


def _packed_batch(B, S, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = [0, *sorted(rng.choice(np.arange(3, S - 2), 1, replace=False)), S]
        for d, (a, e) in enumerate(zip(cuts, cuts[1:])):
            seg[b, a:e] = d
            pos[b, a:e] = np.arange(e - a)
    return ids, seg, pos


def _tiny_params(family, seed=0):
    hf = TINY[family]
    jcfg = getattr(j_families, f"{family}_config")(
        hf, dtype=jnp.float32, remat_policy="none", attn_impl="xla")
    jp = _np_tree(j_decoder.init(jcfg, jax.random.key(seed)))
    # nonzero norm scales: zero-centred norms would otherwise all be 1
    rng = np.random.default_rng(seed)
    for name, node in jp["layers"].items():
        if name.endswith("norm"):
            node["scale"] = rng.normal(0, 0.3, node["scale"].shape).astype(np.float32)
    jp["final_norm"]["scale"] = rng.normal(0, 0.3, jp["final_norm"]["scale"].shape
                                           ).astype(np.float32)
    return hf, jcfg, jp


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("family", ["gemma2", "gemma3"])
def test_gemma_forward_and_gradients_match_jax(family, impl):
    hf, jcfg, jp = _tiny_params(family)
    tcfg = getattr(families, f"{family}_config")(
        hf, dtype=torch.float32, remat_policy="full", attn_impl=impl)
    assert any(w is not None for w in decoder.layer_windows(tcfg))
    assert any(w is None for w in decoder.layer_windows(tcfg))
    ids, seg, pos = _packed_batch(2, 16, hf["vocab_size"], 1)
    cot = np.random.default_rng(2).normal(size=(2, 16, hf["vocab_size"])).astype(np.float32)
    for kw in ({}, {"segment_ids": seg, "positions": pos}):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}

        def j_loss(params):
            logits = j_decoder.forward(params, jcfg, jnp.asarray(ids), **jkw)
            return jnp.sum(logits * cot), logits

        (_, jl), jg = jax.value_and_grad(j_loss, has_aux=True)(
            jax.tree.map(jnp.asarray, jp))
        tp = params_from_jax(jp, device="cpu")
        leaves = {k: v.requires_grad_() for k, v in _flat(tp).items()}
        tl = decoder.forward(tp, tcfg, torch.from_numpy(ids),
                             **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                                   atol=1e-5, rtol=1e-5)
        grads = torch.autograd.grad((tl * torch.from_numpy(cot)).sum(),
                                    list(leaves.values()))
        jflat = _flat(_np_tree(jg))
        for key, g in zip(leaves, grads):
            want = jflat[key]
            err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= 1e-4, (key, err)


def _losses(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


@pytest.mark.parametrize("family", FAMILIES)
def test_smoke_recipe_loss_curve_matches_live_jax_run(family, tmp_path):
    """docs/PARITY.md protocol: the port's recipe from the JAX recipe's
    initial weights, on the same YAML and mock batches, one epoch."""
    runs = {}
    for name in ("jax", "port"):
        node = load_yaml(SMOKE.format(family))
        node.set("checkpoint.enabled", False)
        node.set("run_dir", str(tmp_path / name))
        node.set("step_scheduler.max_steps", STEPS)
        runs[name] = node
    j_recipe = JRecipe(JConfigNode(runs["jax"].to_dict()))
    j_recipe.setup()
    init = _np_tree(j_recipe.train_state.params)
    j_recipe.run_train_validation_loop()
    t_recipe = TrainFinetuneRecipeForNextTokenPrediction(runs["port"], device="cpu")
    t_recipe.setup()
    if family in ("gemma2", "gemma3", "mistral"):
        assert any(w is not None for w in decoder.layer_windows(t_recipe.model_cfg))
    t_recipe.train_state = init_train_state(params_from_jax(init, device="cpu"),
                                            t_recipe.tx)
    t_recipe.run_train_validation_loop()
    want = _losses(tmp_path / "jax" / "training.jsonl")
    got = _losses(tmp_path / "port" / "training.jsonl")
    assert len(want) == len(got) == STEPS
    rel = np.abs(np.array(got) - np.array(want)) / np.abs(want)
    assert rel.max() <= 1e-4, rel


def _jax_checkpoint(family, out_dir, seed=0):
    hf = TINY[family]
    spec = j_get_model_spec(hf)
    cfg = spec.config_from_hf(hf, dtype=jnp.float32)
    _, _, params = _tiny_params(family, seed)
    adapter = j_get_adapter(spec.adapter_name, cfg, **spec.adapter_kwargs)
    j_save(adapter.to_hf(params), str(out_dir), hf_config=hf)
    return hf, cfg, spec, params


@pytest.mark.parametrize("family", ["gemma2", "gemma3"])
def test_gemma_checkpoints_round_trip_bitwise(family, tmp_path):
    """The JAX package's Gemma checkpoint loads into the port bit for bit
    (no lm_head: the head is tied), and the port's export of other weights
    loads into JAX bit for bit."""
    hf, cfg, spec, params = _jax_checkpoint(family, tmp_path / "jax")
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32)
    adapter = get_adapter("dense_decoder", tcfg)
    with HFCheckpointReader(str(tmp_path / "jax")) as reader:
        assert reader.hf_config() == hf
        got = adapter.from_hf(reader, device="cpu", dtype=torch.float32)
    assert "lm_head" not in got
    assert_trees_bitwise(got, params_from_jax(params, device="cpu"))

    _, _, other = _tiny_params(family, seed=1)
    save_hf_checkpoint(adapter.to_hf(params_from_jax(other, device="cpu")),
                       str(tmp_path / "port"), hf_config=hf)
    j_adapter = j_get_adapter(spec.adapter_name, cfg, **spec.adapter_kwargs)
    assert_trees_bitwise(j_adapter.from_hf(JReader(str(tmp_path / "port"))), other)


@pytest.mark.parametrize("family", ["gemma2", "gemma3"])
def test_train_recipe_from_gemma_checkpoint_matches_jax(family, tmp_path):
    """docs/PARITY.md: both training recipes start from the JAX package's
    checkpoint of the smoke YAML's model; losses within 1e-4 relative over
    one epoch."""
    import yaml

    hf = yaml.safe_load(open(SMOKE.format(family)))["model"]["hf_config"]
    spec = j_get_model_spec(hf)
    cfg = spec.config_from_hf(hf, dtype=jnp.float32)
    params = _np_tree(spec.module.init(cfg, jax.random.key(6)))
    j_save(j_get_adapter(spec.adapter_name, cfg).to_hf(params),
           str(tmp_path / "ckpt"), hf_config=hf)
    losses = {}
    for name in ("jax", "port"):
        argv = [SMOKE.format(family), f"--model.pretrained_path={tmp_path / 'ckpt'}",
                "--checkpoint.enabled=false", f"--run_dir={tmp_path / name}",
                f"--step_scheduler.max_steps={STEPS}"]
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
