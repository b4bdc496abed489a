"""Port parity of the remaining dense families (GLM-4, ERNIE-4.5, Hunyuan
dense, Baichuan2, Ministral-3) and the bidirectional Llama and Ministral-3
encoders on the CPU: the JAX package and `automodel_tpu_torch` fed the same
HF configs, numpy weights, batches and checkpoints.

- the seven family configs against the JAX functions on the same HF dicts
  (smoke sizes, and THUDM/GLM-4-9B-0414's, baichuan-inc/Baichuan2-7B-Base's
  and nvidia/llama-3.2-nv-embedqa-1b-v2's published ones): every field
  equal; the eight registry entries with JAX's names, adapters and styles;
- the decoder `forward` of each new architecture (random norm scales and
  q/k/v biases) on plain and packed batches: logits within 1e-5 and every
  gradient leaf within 1e-4 of its largest magnitude (fp32; only the order
  of operations differs, as in test_torch_sliding_families.py), the
  encoders with the plain attention and with the flash path (on CPU
  tensors K1-K3's plain versions, non-causal);
- HF checkpoints in the "glm4" and "baichuan" styles both ways, bit for
  bit; an encoder's checkpoint saved without the `model.` prefix and a
  seq-cls one without `lm_head.weight` load as in JAX;
- the 3-step loss curves of `examples/llm_finetune/{glm4,ernie4_5,
  hunyuan_dense,baichuan,ministral3}_smoke.yaml` through the port's recipe
  against a live JAX run from the same weights, within 1e-4 relative
  (docs/PARITY.md).
"""

import dataclasses
import functools
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
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.models.llm import families as j_families
from automodel_tpu.models.registry import MODEL_ARCH_MAPPING as J_MAPPING
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu_torch.checkpoint import HFCheckpointReader, get_adapter, save_hf_checkpoint
from automodel_tpu_torch.config import load_yaml
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.llm import decoder, families
from automodel_tpu_torch.models.registry import MODEL_ARCH_MAPPING, get_model_spec
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.training import init_train_state

FAMILIES = ("glm4", "ernie4_5", "hunyuan_dense", "baichuan", "ministral3",
            "llama_bidirectional", "ministral_bidirectional")
ARCH = {
    "glm4": "Glm4ForCausalLM",
    "ernie4_5": "Ernie4_5ForCausalLM",
    "hunyuan_dense": "HunYuanDenseV1ForCausalLM",
    "baichuan": "BaichuanForCausalLM",
    "ministral3": "Ministral3ForCausalLM",
    "llama_bidirectional": "LlamaBidirectionalModel",
    "ministral_bidirectional": "Ministral3BidirectionalModel",
}
SMALL = dict(vocab_size=96, hidden_size=32, intermediate_size=48,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             head_dim=8, rms_norm_eps=1e-6, rope_theta=10000.0)
# each family's own fields on top of SMALL
EXTRA = {
    "glm4": dict(partial_rotary_factor=0.5),
    "ernie4_5": dict(use_bias=True),
    "hunyuan_dense": dict(attention_bias=True),
    "baichuan": dict(),
    "ministral3": dict(rope_parameters={"rope_theta": 1000000.0}, sliding_window=5),
    "llama_bidirectional": dict(attention_bias=True),
    "ministral_bidirectional": dict(rope_parameters={"rope_theta": 500000.0}),
}
# published config.json numbers (the widths chip_smoke.py runs at)
GLM4_9B = dict(
    architectures=["Glm4ForCausalLM"], attention_bias=True, head_dim=128,
    hidden_size=4096, intermediate_size=13696, max_position_embeddings=32768,
    num_attention_heads=32, num_hidden_layers=40, num_key_value_heads=2,
    partial_rotary_factor=0.5, rms_norm_eps=1e-5, rope_theta=10000.0,
    tie_word_embeddings=False, vocab_size=151552)
BAICHUAN2_7B = dict(
    architectures=["BaichuanForCausalLM"], hidden_size=4096, intermediate_size=11008,
    max_position_embeddings=4096, num_attention_heads=32, num_hidden_layers=32,
    rms_norm_eps=1e-6, tie_word_embeddings=False, vocab_size=125696)
NV_EMBEDQA_1B = dict(
    architectures=["LlamaBidirectionalModel"], hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8, head_dim=64,
    vocab_size=128256, max_position_embeddings=131072, rope_theta=500000.0,
    rope_scaling={"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                  "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    rms_norm_eps=1e-5, tie_word_embeddings=True, pooling="avg")
CONFIGS = {
    **{f: (f, dict(SMALL, **EXTRA[f])) for f in FAMILIES},
    "glm4_defaults": ("glm4", dict(SMALL)),
    "ernie4_5_untied": ("ernie4_5", dict(SMALL, tie_word_embeddings=False)),
    "glm4_9b": ("glm4", GLM4_9B),
    "baichuan2_7b": ("baichuan", BAICHUAN2_7B),
    "nv_embedqa_1b": ("llama_bidirectional", NV_EMBEDQA_1B),
}
SMOKE = "examples/llm_finetune/{}_smoke.yaml"
SMOKE_FAMILIES = ("glm4", "ernie4_5", "hunyuan_dense", "baichuan", "ministral3")
STEPS = 3


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


def assert_config_fields_equal(got, want):
    for f in dataclasses.fields(got):
        if f.name == "dtype":
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(g):  # rope scaling: the port's fields
            g = dataclasses.asdict(g)
            w = {k: v for k, v in dataclasses.asdict(w).items() if k in g}
        assert g == w, (f.name, g, w)


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_family_config_matches_jax(case):
    family, hf = CONFIGS[case]
    want = getattr(j_families, f"{family}_config")(hf, dtype=jnp.float32)
    got = getattr(families, f"{family}_config")(hf, dtype=torch.float32)
    assert_config_fields_equal(got, want)


def test_published_configs():
    """GLM-4-9B-0414: 9.4 B parameters, rotary on 64 of 128 channels, GQA
    group 16; Baichuan2-7B: MHA with the NormHead; the embedding encoder:
    non-causal, tied, llama3 rope scaling."""
    g = families.glm4_config(GLM4_9B)
    n = (2 * g.vocab_size * g.hidden_size + g.num_layers * (
        g.attn_params_per_layer() + 3 * g.hidden_size * g.intermediate_size))
    assert abs(n / 1e9 - 9.4) < 0.05
    assert (g.rope_dim, g.num_heads // g.num_kv_heads) == (64, 16)
    assert g.rope_interleaved and g.use_post_norms and g.attention_bias
    b = families.baichuan_config(BAICHUAN2_7B)
    assert b.num_kv_heads == b.num_heads == 32 and b.normalized_lm_head
    e = families.llama_bidirectional_config(NV_EMBEDQA_1B)
    assert not e.causal and e.tie_word_embeddings
    assert e.rope_scaling.rope_type == "llama3" and e.resolved_head_dim == 64


@pytest.mark.parametrize("arch", sorted(ARCH.values()) + [
    "LlamaBidirectionalForSequenceClassification"])
def test_registry_entry_matches_jax(arch):
    want, got = J_MAPPING[arch], MODEL_ARCH_MAPPING[arch]
    assert (got.name, got.adapter_name, got.adapter_kwargs) == (
        want.name, want.adapter_name, want.adapter_kwargs)
    assert got.module is decoder
    assert got.config_from_hf.__name__ == want.config_from_hf.__name__
    assert get_model_spec({"architectures": [arch]}) is got


def _tiny(family, seed=0):
    """(hf, jax config, numpy params) of a 2-layer model: the port's draw,
    with random norm scales and q/k/v biases."""
    hf = dict(SMALL, **EXTRA[family], architectures=[ARCH[family]])
    jcfg = getattr(j_families, f"{family}_config")(hf, dtype=jnp.float32,
                                                   remat_policy="none", attn_impl="xla")
    tcfg = getattr(families, f"{family}_config")(hf, dtype=torch.float32)
    params = decoder.init(tcfg, torch.Generator().manual_seed(seed))
    jp = jax.tree.map(lambda t: t.numpy(), params)
    rng = np.random.default_rng(seed)
    for name, node in jp["layers"].items():
        for leaf in ("scale", "bias"):
            if leaf in node and (leaf == "bias" or name.endswith("norm")):
                node[leaf] = rng.normal(0.5 if leaf == "scale" else 0.0, 0.3,
                                        node[leaf].shape).astype(np.float32)
    return hf, jcfg, jp


def _packed_batch(B, S, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = [0, *sorted(rng.choice(np.arange(3, S - 2), 1, replace=False)), S]
        for d, (a, e) in enumerate(zip(cuts, cuts[1:])):
            seg[b, a:e] = d + 1
            pos[b, a:e] = np.arange(e - a)
    return ids, seg, pos


FORWARD_CASES = [(f, "xla") for f in FAMILIES] + [
    (f, "flash") for f in ("glm4", "llama_bidirectional", "ministral_bidirectional")]


@functools.lru_cache(maxsize=None)
def _jax_forward(family):
    """The JAX decoder's logits and gradient leaves on a plain and a packed
    batch (shared by the plain-attention and flash cases)."""
    hf, jcfg, jp = _tiny(family)
    ids, seg, pos = _packed_batch(2, 12, hf["vocab_size"], 1)
    cot = np.random.default_rng(2).normal(size=(2, 12, hf["vocab_size"])).astype(np.float32)
    out = []
    for kw in ({}, {"segment_ids": seg, "positions": pos}):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}

        def j_loss(params):
            logits = j_decoder.forward(params, jcfg, jnp.asarray(ids), **jkw)
            return jnp.sum(logits * cot), logits

        (_, jl), jg = jax.value_and_grad(j_loss, has_aux=True)(
            jax.tree.map(jnp.asarray, jp))
        out.append((kw, np.asarray(jl), _flat(jax.tree.map(np.asarray, jg))))
    return hf, jp, ids, cot, out


@pytest.mark.parametrize("family,impl", FORWARD_CASES)
def test_forward_and_gradients_match_jax(family, impl):
    hf, jp, ids, cot, runs = _jax_forward(family)
    tcfg = getattr(families, f"{family}_config")(
        hf, dtype=torch.float32, remat_policy="full", attn_impl=impl)
    assert tcfg.causal == ("bidirectional" not in family)
    for kw, jl, jflat in runs:
        tp = params_from_jax(jp, device="cpu")
        leaves = {k: v.requires_grad_() for k, v in _flat(tp).items()}
        tl = decoder.forward(tp, tcfg, torch.from_numpy(ids),
                             **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(tl.detach().numpy(), jl, atol=1e-5, rtol=1e-5)
        grads = torch.autograd.grad((tl * torch.from_numpy(cot)).sum(), list(leaves.values()))
        for key, g in zip(leaves, grads):
            want = jflat[key]
            err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= 1e-4, (key, err)


@pytest.mark.parametrize("family", ["glm4", "baichuan", "hunyuan_dense", "ernie4_5"])
def test_checkpoints_round_trip_bitwise(family, tmp_path):
    """The JAX package's checkpoint (GLM-4's fused gate_up and sandwich
    norm names, Baichuan's W_pack) loads into the port bit for bit, and the
    port's export of other weights loads into JAX bit for bit, under the
    same tensor names."""
    hf, jcfg, jp = _tiny(family)
    spec = J_MAPPING[ARCH[family]]
    j_adapter = j_get_adapter(spec.adapter_name, jcfg, **spec.adapter_kwargs)
    j_save(j_adapter.to_hf(jp), str(tmp_path / "jax"), hf_config=hf)
    tspec = get_model_spec(hf)
    tcfg = tspec.config_from_hf(hf, dtype=torch.float32)
    adapter = get_adapter(tspec.adapter_name, tcfg, **tspec.adapter_kwargs)
    with HFCheckpointReader(str(tmp_path / "jax")) as reader:
        names = set(reader.keys())
        got = adapter.from_hf(reader, device="cpu", dtype=torch.float32)
    if family == "glm4":
        assert "model.layers.0.mlp.gate_up_proj.weight" in names
        assert "model.layers.1.post_mlp_layernorm.weight" in names
    if family == "baichuan":
        assert "model.layers.0.self_attn.W_pack.weight" in names
        assert not any("q_proj" in n for n in names)
    assert_trees_bitwise(got, params_from_jax(jp, device="cpu"))

    _, _, other = _tiny(family, seed=1)
    save_hf_checkpoint(adapter.to_hf(params_from_jax(other, device="cpu")),
                       str(tmp_path / "port"), hf_config=hf)
    with HFCheckpointReader(str(tmp_path / "port")) as reader:
        assert set(reader.keys()) == names
    assert_trees_bitwise(j_adapter.from_hf(JReader(str(tmp_path / "port"))), other)


def test_encoder_checkpoint_without_prefix_or_head(tmp_path):
    """A `LlamaBidirectionalModel` saved without the `model.` prefix loads
    as in JAX; a seq-cls checkpoint with no `lm_head.weight` (untied) loads
    with that leaf left out."""
    hf, jcfg, jp = _tiny("llama_bidirectional")
    tcfg = families.llama_bidirectional_config(hf, dtype=torch.float32)
    adapter = get_adapter("dense_decoder", tcfg)
    save_hf_checkpoint(((n.removeprefix("model."), t) for n, t in
                        adapter.to_hf(params_from_jax(jp, device="cpu"))),
                       str(tmp_path / "bare"), hf_config=hf)
    j_adapter = j_get_adapter("dense_decoder", jcfg)
    with HFCheckpointReader(str(tmp_path / "bare")) as reader:
        assert "embed_tokens.weight" in reader.keys()
        got = adapter.from_hf(reader, device="cpu", dtype=torch.float32)
    assert_trees_bitwise(got, j_adapter.from_hf(JReader(str(tmp_path / "bare"))))
    headless = {k: v for k, v in jp.items() if k != "lm_head"}
    save_hf_checkpoint(((n, t) for n, t in adapter.to_hf(params_from_jax(jp, device="cpu"))
                        if n != "lm_head.weight"), str(tmp_path / "cls"), hf_config=hf)
    with HFCheckpointReader(str(tmp_path / "cls")) as reader:
        got = adapter.from_hf(reader, device="cpu", dtype=torch.float32)
    assert "lm_head" not in got
    assert_trees_bitwise(got, params_from_jax(headless, device="cpu"))


def _losses(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


@pytest.mark.parametrize("family", SMOKE_FAMILIES)
def test_smoke_recipe_loss_curve_matches_live_jax_run(family, tmp_path):
    """docs/PARITY.md: the port's recipe from the JAX recipe's initial
    weights, on the same YAML and mock batches, 3 steps."""
    runs = {}
    for name in ("jax", "port"):
        node = load_yaml(SMOKE.format(family))
        node.set("checkpoint.enabled", False)
        node.set("run_dir", str(tmp_path / name))
        node.set("step_scheduler.max_steps", STEPS)
        runs[name] = node
    j_recipe = JRecipe(JConfigNode(runs["jax"].to_dict()))
    j_recipe.setup()
    init = jax.tree.map(np.asarray, j_recipe.train_state.params)
    j_recipe.run_train_validation_loop()
    t_recipe = TrainFinetuneRecipeForNextTokenPrediction(runs["port"], device="cpu")
    t_recipe.setup()
    assert t_recipe.model_spec.name == j_recipe.model_spec.name
    t_recipe.train_state = init_train_state(params_from_jax(init, device="cpu"), t_recipe.tx)
    t_recipe.run_train_validation_loop()
    want = _losses(tmp_path / "jax" / "training.jsonl")
    got = _losses(tmp_path / "port" / "training.jsonl")
    assert len(want) == len(got) == STEPS
    rel = np.abs(np.array(got) - np.array(want)) / np.abs(want)
    assert rel.max() <= 1e-4, rel
