"""Port parity of the GQA MoE families on the CPU: Qwen3-MoE, Mixtral,
gpt-oss, GLM-4.5, ERNIE-4.5-MoE, Hunyuan-MoE, MiniMax-M2 and Ling 2.0
(BailingMoeV2), the JAX package and `automodel_tpu_torch` fed the same HF
configs, numpy weights, batches and checkpoints.

- The eight family configs against the JAX functions on each family's
  smoke-YAML config and on Qwen3-30B-A3B's, gpt-oss-20b's and
  Mixtral-8x7B's published ones (the numbers `chip_smoke.py` runs at):
  every field equal, the MoE config's too; the registry's entry names the
  JAX registry's adapter and style.
- Each family's MoE decoder `forward` (the smoke YAML's model: head dim
  8, 2-3 layers) on packed batches, with every bias, sink, correction
  bias and norm scale drawn at random (they start at 0 or 1): logits
  within 1e-5, the aux loss within 1e-6, every gradient leaf within 1e-4
  of its largest magnitude (fp32: only the order of operations differs);
  gpt-oss also through `flash_attention` (its passes on CPU tensors are
  K1-K3's plain versions, at head dim 8), with its expert kernels scaled
  so that gate and up values pass the 7.0 clamp of its activation.
- gpt-oss's MoE block on inputs whose gate values pass +-7: output and
  gradients against JAX, and the same block with the clamp lifted gives
  another output.
- HF checkpoints of each family both ways, bit for bit: the JAX package
  writes, the port reads; the port writes other weights, JAX reads
  (fused `query_key_value` for Ling, the interleaved `gate_up_proj` and
  its biases for gpt-oss, ERNIE's `moe_statics`, Hunyuan's
  `query_layernorm` / `shared_mlp`, Mixtral's and MiniMax-M2's
  `block_sparse_moe`).

Serving and the recipes are in tests/test_torch_moe_families_serving.py.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from automodel_tpu.checkpoint.hf_adapter import HFCheckpointReader as JReader
from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.checkpoint.hf_adapter import save_hf_checkpoint as j_save
from automodel_tpu.models.moe_lm import decoder as j_moe
from automodel_tpu.models.moe_lm import families as j_families
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.moe import layer as j_layer
from automodel_tpu_torch.checkpoint import (
    HFCheckpointReader,
    get_adapter,
    save_hf_checkpoint,
)
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.moe_lm import families
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.moe.layer import moe_forward

# family -> (config function, smoke YAML)
FAMILIES = {
    "qwen3_moe": ("qwen3_moe_config", "qwen3_moe_ep"),
    "mixtral": ("mixtral_config", "mixtral"),
    "gpt_oss": ("gpt_oss_config", "gpt_oss"),
    "glm4_moe": ("glm4_moe_config", "glm4_moe"),
    "ernie4_5_moe": ("ernie4_5_moe_config", "ernie4_5_moe"),
    "hunyuan_moe": ("hunyuan_moe_config", "hunyuan_moe"),
    "minimax_m2": ("minimax_m2_config", "minimax_m2"),
    "ling_v2": ("bailing_moe_v2_config", "ling_v2"),
}
# Qwen/Qwen3-30B-A3B, openai/gpt-oss-20b and mistralai/Mixtral-8x7B-v0.1
# config.json, as chip_smoke.py serves and trains them
PUBLISHED = {
    "qwen3_30b_a3b": ("qwen3_moe", dict(
        architectures=["Qwen3MoeForCausalLM"], vocab_size=151936, hidden_size=2048,
        intermediate_size=6144, moe_intermediate_size=768, num_hidden_layers=48,
        num_attention_heads=32, num_key_value_heads=4, head_dim=128,
        num_experts=128, num_experts_per_tok=8, norm_topk_prob=True,
        rope_theta=1000000.0, rms_norm_eps=1e-6, max_position_embeddings=40960,
        router_aux_loss_coef=0.001, tie_word_embeddings=False)),
    "gpt_oss_20b": ("gpt_oss", dict(
        architectures=["GptOssForCausalLM"], vocab_size=201088, hidden_size=2880,
        intermediate_size=2880, num_hidden_layers=24, num_attention_heads=64,
        num_key_value_heads=8, head_dim=64, num_local_experts=32,
        num_experts_per_tok=4, sliding_window=128,
        layer_types=["sliding_attention", "full_attention"] * 12,
        attention_bias=True, swiglu_limit=7.0, rope_theta=150000,
        rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                      "beta_slow": 1.0, "truncate": False,
                      "original_max_position_embeddings": 4096},
        rms_norm_eps=1e-5, max_position_embeddings=131072,
        router_aux_loss_coef=0.9, tie_word_embeddings=False)),
    "mixtral_8x7b": ("mixtral", dict(
        architectures=["MixtralForCausalLM"], vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=8, num_local_experts=8, num_experts_per_tok=2,
        rope_theta=1000000.0, rms_norm_eps=1e-5, max_position_embeddings=32768,
        router_aux_loss_coef=0.02, tie_word_embeddings=False)),
}


def smoke_hf(family: str) -> dict:
    """The HF config of `family`'s examples/llm_finetune smoke YAML."""
    path = f"examples/llm_finetune/{FAMILIES[family][1]}_smoke.yaml"
    with open(path) as f:
        return yaml.safe_load(f)["model"]["hf_config"]


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


def _fields_equal(got, want):
    for f in dataclasses.fields(got):
        if f.name == "dtype":
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(g):  # rope scaling, MoE: the port's fields
            g = dataclasses.asdict(g)
            w = {k: v for k, v in dataclasses.asdict(w).items() if k in g}
        assert g == w, (f.name, g, w)


CONFIG_CASES = {**{f"{f}_smoke": (f, None) for f in FAMILIES},
                **{name: (f, hf) for name, (f, hf) in PUBLISHED.items()}}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_family_config_matches_jax(case):
    family, hf = CONFIG_CASES[case]
    hf = hf or smoke_hf(family)
    fn = FAMILIES[family][0]
    want = getattr(j_families, fn)(hf, dtype=jnp.float32)
    got = getattr(families, fn)(hf, dtype=torch.float32)
    _fields_equal(got, want)
    # the registry: the JAX registry's family, the MoE decoder, its adapter
    spec, j_spec = get_model_spec(hf), j_get_model_spec(hf)
    assert spec.config_from_hf is getattr(families, fn)
    assert spec.module is moe_decoder
    assert (spec.name, spec.adapter_name, spec.adapter_kwargs) == (
        j_spec.name, j_spec.adapter_name, j_spec.adapter_kwargs)


def test_published_configs():
    """What the card's phases rely on: Qwen3-30B-A3B's 48 MoE layers of 128
    experts at G 8 x D 128; gpt-oss-20b's alternating 128-token windows,
    sinks, biases and clamped experts, its yarn not folded into the scale
    (as in JAX); Mixtral's top-2 of 8."""
    q = families.qwen3_moe_config(PUBLISHED["qwen3_30b_a3b"][1])
    assert (q.num_moe_layers, q.moe.n_routed_experts, q.moe.experts_per_token) == (48, 128, 8)
    assert q.num_heads // q.num_kv_heads == 8 and q.resolved_head_dim == 128 and q.qk_norm
    g = families.gpt_oss_config(PUBLISHED["gpt_oss_20b"][1])
    assert moe_decoder.layer_windows(g) == (128, None) * 12
    assert g.attention_sinks and g.o_proj_bias and g.attention_bias
    assert (g.moe.expert_activation, g.moe.swiglu_limit) == ("swigluoai", 7.0)
    assert g.moe.router_bias and g.moe.expert_bias
    assert g.rope_scaling.rope_type == "yarn" and g.attn_scale is None
    m = families.mixtral_config(PUBLISHED["mixtral_8x7b"][1])
    assert (m.moe.n_routed_experts, m.moe.experts_per_token, m.resolved_head_dim) == (8, 2, 128)


@functools.lru_cache(maxsize=None)
def _jax_init(family: str, seed: int):
    """JAX's init of the smoke YAML's model (numpy), made once per family
    and seed (eager JAX takes seconds for it)."""
    hf = smoke_hf(family)
    spec = j_get_model_spec(hf)
    jcfg = spec.config_from_hf(hf, dtype=jnp.float32, remat_policy="none",
                               attn_impl="xla")
    return hf, jcfg, _np_tree(spec.module.init(jcfg, jax.random.key(seed)))


def _tiny(family: str, seed: int = 0, clamp_scale: float = 1.0):
    """The smoke YAML's model with JAX's init, every bias, sink, correction
    bias and norm scale drawn at random; gpt-oss's gate and up expert
    kernels times `clamp_scale`."""
    hf, jcfg, jp = _jax_init(family, seed)
    jp = copy.deepcopy(jp)
    rng = np.random.default_rng(seed)
    for path, leaf in _flat(jp).items():
        node = jp
        for p in path[:-1]:
            node = node[p]
        if path[-1] in ("bias", "e_score_bias") or path[-2:] == ("moe_layers", "sinks"):
            node[path[-1]] = rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        elif path[-1] == "scale":
            node[path[-1]] = rng.normal(1.0, 0.3, leaf.shape).astype(np.float32)
    if clamp_scale != 1.0:
        experts = jp["moe_layers"]["moe"]["experts"]
        for proj in ("gate_proj", "up_proj"):
            experts[proj]["kernel"] = experts[proj]["kernel"] * np.float32(clamp_scale)
    return hf, jcfg, jp


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


FORWARD_CASES = [(f, "xla") for f in FAMILIES] + [("gpt_oss", "flash")]


@pytest.mark.parametrize("family, impl", FORWARD_CASES)
def test_forward_and_gradients_match_jax(family, impl):
    clamp = 12.0 if family == "gpt_oss" else 1.0
    hf, jcfg, jp = _tiny(family, clamp_scale=clamp)
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32,
                                             remat_policy="full", attn_impl=impl)
    ids, seg, pos = _packed_batch(2, 16, hf["vocab_size"], 1)
    mask = np.ones((2, 16), bool)
    mask[1, -3:] = False  # pad tokens route nowhere
    cot = np.random.default_rng(2).normal(size=(2, 16, hf["vocab_size"])).astype(np.float32)
    jkw = dict(segment_ids=jnp.asarray(seg), positions=jnp.asarray(pos),
               token_mask=jnp.asarray(mask))

    def j_loss(params):
        logits, aux = j_moe.forward(params, jcfg, jnp.asarray(ids), **jkw)
        return jnp.sum(logits * cot) + 10.0 * aux, (logits, aux)

    (_, (jl, jaux)), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    tp = params_from_jax(jp, device="cpu")
    leaves = {k: v.requires_grad_() for k, v in _flat(tp).items()}
    tl, taux = moe_decoder.forward(tp, tcfg, torch.from_numpy(ids),
                                   segment_ids=torch.from_numpy(seg),
                                   positions=torch.from_numpy(pos),
                                   token_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6)
    grads = torch.autograd.grad((tl * torch.from_numpy(cot)).sum() + 10.0 * taux,
                                list(leaves.values()), allow_unused=True)
    jflat = _flat(_np_tree(jg))
    for key, g in zip(leaves, grads):
        want = jflat[key]
        if g is None:  # the correction bias: JAX's stop_gradient gives it none
            assert key[-1] == "e_score_bias" and not np.abs(want).any(), key
            continue
        err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, (key, err)


def test_gpt_oss_experts_past_the_clamp_match_jax():
    """gpt-oss's MoE block (biased router, biased experts, swiglu-oai
    clamped at 7 with its (up + 1) term) on inputs whose gate and up
    values pass +-7: output and gradients against JAX; lifting the clamp
    changes the output, so the data reaches it."""
    hf = smoke_hf("gpt_oss")
    jcfg = j_families.gpt_oss_config(hf, dtype=jnp.float32).moe
    tcfg = families.gpt_oss_config(hf, dtype=torch.float32).moe
    H = hf["hidden_size"]
    params = _np_tree(j_layer.init_moe(jcfg, H, jax.random.key(3)))
    rng = np.random.default_rng(4)
    for path, leaf in _flat(params).items():
        if path[-1] == "bias":
            node = params
            for p in path[:-1]:
                node = node[p]
            node["bias"] = rng.normal(0, 0.5, leaf.shape).astype(np.float32)
    x = (rng.normal(size=(2, 12, H)) * 8.0).astype(np.float32)
    gate_pre = np.einsum("bsh,ehi->bsei", x, params["experts"]["gate_proj"]["kernel"])
    assert (np.abs(gate_pre) > 7.0).mean() > 0.2  # the data passes the clamp

    def j_fn(p, xx):
        out, aux, _ = j_layer.moe_forward(p, jcfg, xx)
        return jnp.sum(out * out) + aux, out

    (_, jo), (jg, jgx) = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = params_from_jax(params, device="cpu")
    leaves = {k: v.requires_grad_() for k, v in _flat(tp).items()}
    tx = torch.from_numpy(x).requires_grad_()
    to, taux, _ = moe_forward(tp, tcfg, tx)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=1e-4, rtol=1e-5)
    grads = torch.autograd.grad((to * to).sum() + taux, [tx, *leaves.values()])
    jflat = _flat(_np_tree(jg))
    for key, g in zip([("x",), *leaves], grads):
        want = np.asarray(jgx) if key == ("x",) else jflat[key]
        err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, (key, err)
    unclamped, _, _ = moe_forward(tp, dataclasses.replace(tcfg, swiglu_limit=1e9), tx)
    assert (unclamped - to).abs().max() > 1e-2 * to.abs().max()


def _jax_checkpoint(family, out_dir, seed=0):
    hf, jcfg, params = _tiny(family, seed)
    spec = j_get_model_spec(hf)
    j_save(j_get_adapter(spec.adapter_name, jcfg, **spec.adapter_kwargs).to_hf(params),
           str(out_dir), hf_config=hf)
    return hf, jcfg, spec, params


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpoints_round_trip_bitwise(family, tmp_path):
    """The JAX package's checkpoint of the family loads into the port bit
    for bit, and the port's export of other weights into JAX."""
    hf, jcfg, spec, params = _jax_checkpoint(family, tmp_path / "jax")
    tspec = get_model_spec(hf)
    tcfg = tspec.config_from_hf(hf, dtype=torch.float32)
    adapter = get_adapter(tspec.adapter_name, tcfg, **tspec.adapter_kwargs)
    with HFCheckpointReader(str(tmp_path / "jax")) as reader:
        assert sorted(reader.keys()) == sorted(
            name for name, _ in j_get_adapter(spec.adapter_name, jcfg,
                                              **spec.adapter_kwargs).to_hf(params))
        got = adapter.from_hf(reader, device="cpu", dtype=torch.float32)
    assert_trees_bitwise(got, params_from_jax(params, device="cpu"))

    _, _, other = _tiny(family, seed=1)
    save_hf_checkpoint(adapter.to_hf(params_from_jax(other, device="cpu")),
                       str(tmp_path / "port"), hf_config=hf)
    j_adapter = j_get_adapter(spec.adapter_name, jcfg, **spec.adapter_kwargs)
    assert_trees_bitwise(j_adapter.from_hf(JReader(str(tmp_path / "port"))), other)
