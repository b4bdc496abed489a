"""Port parity of the four MoE architectures that reuse the decoder as it is:
Kimi-K2 and GLM-4.7-Flash (`Glm4MoeLiteForCausalLM`), both DeepSeek-V3's
config and names; Mistral-4 (DeepSeek-V3 plus Llama-4's position-dependent
q-rope scaling); Hy-MT2 (GQA with qk-norm, a shared expert of its own
width, a sigmoid router with the expert bias) on the CPU, the JAX package
and `automodel_tpu_torch` fed the same HF configs, numpy weights, batches
and checkpoints.

- The configs against the JAX functions, every field (the MoE config's
  too), on the three smoke YAMLs', Kimi-K2's and GLM-4.7-Flash's published
  ones; the registry's entry names the JAX registry's adapter and style.
- Each smoke model's `forward` (every bias, correction bias and norm scale
  drawn at random) on batches whose positions pass Mistral-4's
  `original_max_position_embeddings` (16) twice: logits within 1e-5, the
  aux loss within 1e-6, every gradient leaf within 1e-5 of its largest
  magnitude (fp32). Mistral-4 with the scaling off must miss JAX's logits.
- HF checkpoints of the three both ways, bit for bit (Hy-MT2's
  `mlp.router.gate`, `shared_mlp`, `mlp.expert_bias`), and the MoE
  adapter's "glm4" style (GLM-4's post-norm names) both ways.

Serving and the smoke recipes are in tests/test_torch_moe_lite_serving.py
and tests/test_torch_moe_lite_recipes.py.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_moe_families import _fields_equal, _flat, _np_tree, assert_trees_bitwise

from automodel_tpu.checkpoint.hf_adapter import HFCheckpointReader as JReader
from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.checkpoint.hf_adapter import save_hf_checkpoint as j_save
from automodel_tpu.models.moe_lm import decoder as j_moe
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu_torch.checkpoint import (
    HFCheckpointReader,
    get_adapter,
    save_hf_checkpoint,
)
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.moe_lm import families
from automodel_tpu_torch.models.registry import get_model_spec

# the families whose smoke YAML is examples/llm_finetune/<name>_smoke.yaml
SMOKE = ("glm4_moe_lite", "mistral4", "hy_mt2")
# zai-org/GLM-4.7-Flash config.json, the widths chip_smoke.py serves
GLM47_FLASH = dict(
    architectures=["Glm4MoeLiteForCausalLM"], vocab_size=154880, hidden_size=2048,
    intermediate_size=10240, moe_intermediate_size=1536, num_hidden_layers=47,
    num_attention_heads=20, num_key_value_heads=20, n_shared_experts=1,
    n_routed_experts=64, routed_scaling_factor=1.8, kv_lora_rank=512,
    q_lora_rank=768, qk_rope_head_dim=64, qk_nope_head_dim=192, v_head_dim=256,
    n_group=1, topk_group=1, num_experts_per_tok=4, first_k_dense_replace=1,
    norm_topk_prob=True, scoring_func="sigmoid", topk_method="noaux_tc",
    rope_theta=1000000, rms_norm_eps=1e-5, max_position_embeddings=202752,
    num_nextn_predict_layers=1, tie_word_embeddings=False)
# moonshotai/Kimi-K2-Instruct config.json under the JAX registry's name
KIMI_K2 = dict(
    architectures=["KimiK2ForCausalLM"], vocab_size=163840, hidden_size=7168,
    intermediate_size=18432, moe_intermediate_size=2048, num_hidden_layers=61,
    num_attention_heads=64, num_key_value_heads=64, n_shared_experts=1,
    n_routed_experts=384, routed_scaling_factor=2.827, kv_lora_rank=512,
    q_lora_rank=1536, qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    n_group=1, topk_group=1, num_experts_per_tok=8, first_k_dense_replace=1,
    norm_topk_prob=True, scoring_func="sigmoid", rope_theta=50000,
    rms_norm_eps=1e-6, max_position_embeddings=131072, num_nextn_predict_layers=0,
    tie_word_embeddings=False,
    rope_scaling={"beta_fast": 1, "beta_slow": 1, "factor": 32, "mscale": 1,
                  "mscale_all_dim": 1, "original_max_position_embeddings": 4096,
                  "type": "yarn"})
# family -> config function
FUNCTIONS = {"glm4_moe_lite": "deepseek_v3_moe_config", "kimi_k2": "deepseek_v3_moe_config",
             "mistral4": "mistral4_config", "hy_mt2": "hy_mt2_config"}


def smoke_hf(family: str) -> dict:
    with open(f"examples/llm_finetune/{family}_smoke.yaml") as f:
        return yaml.safe_load(f)["model"]["hf_config"]


CONFIG_CASES = {
    **{f"{f}_smoke": (f, None) for f in SMOKE},
    "glm47_flash": ("glm4_moe_lite", GLM47_FLASH),
    "kimi_k2": ("kimi_k2", KIMI_K2),
    # Hy-MT2 with the other router and a shared expert of its own width
    "hy_mt2_softmax_shared": ("hy_mt2", None),
}


def _case_hf(case):
    family, hf = CONFIG_CASES[case]
    if case == "hy_mt2_softmax_shared":
        return family, dict(smoke_hf("hy_mt2"), moe_router_use_sigmoid=False,
                            shared_expert_intermediate_size=24, route_norm=False,
                            router_scaling_factor=2.5,
                            moe_router_enable_expert_bias=False)
    return family, hf or smoke_hf(family)


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_family_config_matches_jax(case):
    family, hf = _case_hf(case)
    spec, j_spec = get_model_spec(hf), j_get_model_spec(hf)
    want = j_spec.config_from_hf(hf, dtype=jnp.float32)
    got = spec.config_from_hf(hf, dtype=torch.float32)
    _fields_equal(got, want)
    assert spec.config_from_hf is getattr(families, FUNCTIONS[family])
    assert spec.module is moe_decoder
    assert (spec.name, spec.adapter_name, spec.adapter_kwargs) == (
        j_spec.name, j_spec.adapter_name, j_spec.adapter_kwargs)


def test_published_and_smoke_widths():
    """What the card's phases and the tests below rely on."""
    g = families.deepseek_v3_moe_config(GLM47_FLASH)
    assert (g.attention_type, g.num_heads, g.mla_kv_lora_rank, g.mla_qk_rope_head_dim) == (
        "mla", 20, 512, 64)
    assert (g.mla_qk_nope_head_dim + g.mla_qk_rope_head_dim, g.mla_v_head_dim) == (256, 256)
    assert (g.first_k_dense, g.num_moe_layers, g.moe.n_routed_experts,
            g.moe.experts_per_token) == (1, 46, 64, 4)
    m = families.mistral4_config(smoke_hf("mistral4"))
    assert (m.mla_qpe_scaling_beta, m.mla_qpe_scaling_orig_max) == (0.1, 16)
    assert families.mistral4_config(
        {k: v for k, v in smoke_hf("mistral4").items() if k != "rope_parameters"}
    ).mla_qpe_scaling_beta is None
    h = families.hy_mt2_config(smoke_hf("hy_mt2"))
    assert h.qk_norm and h.attention_type == "gqa" and h.first_k_dense == 1
    assert h.moe.score_func == "sigmoid" and h.moe.gate_bias_update_speed == 0.001
    assert h.moe.shared_expert_intermediate_size == 16


@functools.lru_cache(maxsize=None)
def _init(family: str, seed: int):
    """The smoke YAML's HF config, JAX's config and the port's init as
    numpy (the two packages' trees are key for key the same; the port's
    init spares JAX's eager one, seconds of op compiles)."""
    hf = smoke_hf(family)
    jcfg = j_get_model_spec(hf).config_from_hf(hf, dtype=jnp.float32, remat_policy="none",
                                               attn_impl="xla")
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32)
    params = moe_decoder.init(tcfg, torch.Generator().manual_seed(seed), dtype=torch.float32)
    return hf, jcfg, _to_numpy(params)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def tiny(family: str, seed: int = 0):
    """The smoke YAML's model, every bias, correction bias and norm scale
    drawn at random."""
    hf, jcfg, jp = _init(family, seed)
    jp = copy.deepcopy(jp)
    rng = np.random.default_rng(seed)
    for path, leaf in _flat(jp).items():
        node = jp
        for p in path[:-1]:
            node = node[p]
        if path[-1] in ("bias", "e_score_bias"):
            node[path[-1]] = rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        elif path[-1] == "scale":
            node[path[-1]] = rng.normal(1.0, 0.3, leaf.shape).astype(np.float32)
    return hf, jcfg, jp


def _batch(B, S, vocab, seed):
    """Two rows: one document of S tokens (positions 0..S-1) and two packed
    documents."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    cut = S // 3
    seg[1, cut:] = 1
    pos[1, cut:] = np.arange(S - cut)
    return ids, seg, pos


@pytest.mark.parametrize("family", SMOKE)
def test_forward_and_gradients_match_jax(family):
    hf, jcfg, jp = tiny(family)
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32,
                                             remat_policy="full", attn_impl="xla")
    S = 40  # Mistral-4's positions pass original_max_position_embeddings 16 twice
    ids, seg, pos = _batch(2, S, hf["vocab_size"], 1)
    mask = np.ones((2, S), bool)
    mask[1, -3:] = False
    cot = np.random.default_rng(2).normal(size=(2, S, hf["vocab_size"])).astype(np.float32)
    jkw = dict(segment_ids=jnp.asarray(seg), positions=jnp.asarray(pos),
               token_mask=jnp.asarray(mask))

    def j_loss(params):
        logits, aux = j_moe.forward(params, jcfg, jnp.asarray(ids), **jkw)
        return jnp.sum(logits * cot) + 10.0 * aux, (logits, aux)

    (_, (jl, jaux)), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    tp = params_from_jax(jp, device="cpu")
    leaves = {k: v.requires_grad_() for k, v in _flat(tp).items()}
    tkw = dict(segment_ids=torch.from_numpy(seg), positions=torch.from_numpy(pos),
               token_mask=torch.from_numpy(mask))
    tl, taux = moe_decoder.forward(tp, tcfg, torch.from_numpy(ids), **tkw)
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
        assert err <= 1e-5, (key, err)
    if family == "mistral4":
        assert (pos // tcfg.mla_qpe_scaling_orig_max).max() == 2
        import dataclasses

        off = dataclasses.replace(tcfg, mla_qpe_scaling_beta=None)
        with torch.no_grad():
            ctl, _ = moe_decoder.forward(tp, off, torch.from_numpy(ids), **tkw)
        gap = np.abs(ctl.numpy() - np.asarray(jl)).max()
        assert gap > 1e-3, gap  # the control misses JAX


def _checkpoint_round_trip(hf, jcfg, tcfg, params, other, tmp_path, adapter_kw):
    """JAX writes `params`, the port reads them bit for bit; the port writes
    `other`, JAX reads it bit for bit; both through the MoE adapter with
    `adapter_kw`. Returns the checkpoint's tensor names."""
    j_adapter = j_get_adapter("moe_decoder", jcfg, **adapter_kw)
    j_save(j_adapter.to_hf(params), str(tmp_path / "jax"), hf_config=hf)
    adapter = get_adapter("moe_decoder", tcfg, **adapter_kw)
    with HFCheckpointReader(str(tmp_path / "jax")) as reader:
        names = sorted(reader.keys())
        assert names == sorted(n for n, _ in j_adapter.to_hf(params))
        got = adapter.from_hf(reader, device="cpu", dtype=torch.float32)
    assert_trees_bitwise(got, params_from_jax(params, device="cpu"))
    save_hf_checkpoint(adapter.to_hf(params_from_jax(other, device="cpu")),
                       str(tmp_path / "port"), hf_config=hf)
    assert_trees_bitwise(j_adapter.from_hf(JReader(str(tmp_path / "port"))), other)
    return names


@pytest.mark.parametrize("family", SMOKE)
def test_checkpoints_round_trip_bitwise(family, tmp_path):
    hf, jcfg, params = tiny(family)
    _, _, other = tiny(family, seed=1)
    spec = get_model_spec(hf)
    assert spec.adapter_kwargs == j_get_model_spec(hf).adapter_kwargs
    names = _checkpoint_round_trip(hf, jcfg, spec.config_from_hf(hf, dtype=torch.float32),
                                   params, other, tmp_path, spec.adapter_kwargs)
    if family == "hy_mt2":
        for name in ("model.layers.1.mlp.router.gate.weight",
                     "model.layers.1.mlp.shared_mlp.up_proj.weight",
                     "model.layers.1.mlp.expert_bias",
                     "model.layers.1.self_attn.q_norm.weight"):
            assert name in names, name


def test_moe_glm4_style_round_trips_bitwise(tmp_path):
    """The MoE adapter's "glm4" style: GLM-4's sandwich-norm names from the
    dense adapter on every MoE layer (a model with no dense prefix: as in
    the JAX adapter, the style maps no fused `gate_up_proj` of dense
    layers)."""
    import dataclasses

    hf = dict(smoke_hf("hy_mt2"), first_k_dense_replace=0, num_shared_experts=0)
    jcfg = dataclasses.replace(j_get_model_spec(hf).config_from_hf(hf, dtype=jnp.float32),
                               use_post_norms=True)
    tcfg = dataclasses.replace(families.hy_mt2_config(hf, dtype=torch.float32),
                               use_post_norms=True)
    params = _np_tree(j_moe.init(jcfg, jax.random.key(0)))  # with the post norms
    other = jax.tree.map(lambda x: x + np.float32(0.25), params)
    names = _checkpoint_round_trip(hf, jcfg, tcfg, params, other, tmp_path,
                                   {"style": "glm4"})
    for name in ("model.layers.0.post_self_attn_layernorm.weight",
                 "model.layers.0.post_mlp_layernorm.weight",
                 "model.layers.1.mlp.gate.weight"):
        assert name in names, name
