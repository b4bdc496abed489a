"""Port parity of Gemma-4 MoE (`models/moe_lm/gemma4.py`) on the CPU, the JAX
package and `automodel_tpu_torch` fed the same HF configs, numpy weights,
batches and checkpoints.

- The config field for field (the smoke YAML's and the 26B-A4B widths
  `chip_smoke.py` trains), the registry's entry.
- The smoke model's `forward` with its two trailing KV-shared layers (norm
  scales, router scales and layer scalars drawn at random, one row of two
  packed documents): logits within atol = rtol = 1e-5, every gradient leaf
  within 1e-5 of its largest magnitude (fp32); the shared layers' k/v
  placeholders get zero gradients.
- The router's top-k with tied probabilities: the same experts, in the
  same order, as `jax.lax.top_k`.
- HF checkpoints both ways, bit for bit, in JAX's names (no k/v keys on the
  shared layers).
- The serving engine refuses `HetMoEConfig` and `Gemma4MoEConfig` with
  JAX's NotImplementedError, and `generate()` refuses Gemma-4.
(The smoke YAML's recipe run is in tests/test_torch_het_moe.py.)
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_het_moe import batch, forward_grads_vs_jax
from test_torch_moe_families import _fields_equal, _flat, assert_trees_bitwise

from automodel_tpu.checkpoint.hf_adapter import HFCheckpointReader as JReader
from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.checkpoint.hf_adapter import save_hf_checkpoint as j_save
from automodel_tpu.models.moe_lm import gemma4 as j_gemma4
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu_torch.checkpoint import HFCheckpointReader, get_adapter, save_hf_checkpoint
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.inference.generate import GenerateConfig, generate
from automodel_tpu_torch.models.moe_lm import gemma4, het_families
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.serving import ServingConfig, ServingEngine
from chip_smoke import GEMMA4_26B_A4B


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_hf() -> dict:
    with open("examples/llm_finetune/gemma4_moe_smoke.yaml") as f:
        return yaml.safe_load(f)["model"]["hf_config"]


@pytest.mark.parametrize("case", ("smoke", "published_26b_a4b"))
def test_config_matches_jax(case):
    hf = smoke_hf() if case == "smoke" else GEMMA4_26B_A4B
    spec, j_spec = get_model_spec(hf), j_get_model_spec(hf)
    want = j_spec.config_from_hf(hf, dtype=jnp.float32, remat_policy="none")
    got = spec.config_from_hf(hf, dtype=torch.float32, remat_policy="none")
    _fields_equal(got, want)
    assert spec.module is gemma4 and spec.config_from_hf is gemma4.gemma4_moe_config
    assert (spec.name, spec.adapter_name, spec.adapter_kwargs) == (
        j_spec.name, j_spec.adapter_name, j_spec.adapter_kwargs)


def test_published_widths():
    """The 26B-A4B widths the card trains: 30 layers (5 sliding to 1
    global), 128 experts of 704 (top 8) beside a 2112-wide dense MLP, head
    dim 256 at the query_pre_attn_scalar scale; ~25.1 B parameters, ~3.75 B
    active."""
    c = gemma4.gemma4_moe_config(GEMMA4_26B_A4B)
    assert c.resolved_layer_types().count("global") == 5 and c.num_layers == 30
    assert (c.moe.n_routed_experts, c.moe.experts_per_token, c.head_dim) == (128, 8, 256)
    assert c.attn_scale == 256 ** -0.5
    H, D = c.hidden_size, c.head_dim
    attn = H * D * (2 * c.num_heads + 2 * c.num_kv_heads)
    dense = 3 * H * c.intermediate_size
    expert = 3 * H * c.moe.moe_intermediate_size
    total = c.vocab_size * H + c.num_layers * (
        attn + dense + c.moe.n_routed_experts * (expert + H))
    active = c.vocab_size * H + c.num_layers * (
        attn + dense + c.moe.experts_per_token * expert)
    assert 24.8e9 < total < 25.4e9 and 3.6e9 < active < 3.9e9, (total, active)


@functools.lru_cache(maxsize=None)
def _init(seed: int):
    hf = smoke_hf()
    jcfg = j_get_model_spec(hf).config_from_hf(hf, dtype=jnp.float32, remat_policy="none",
                                               attn_impl="xla")
    tcfg = gemma4.gemma4_moe_config(hf, dtype=torch.float32)
    params = gemma4.init(tcfg, torch.Generator().manual_seed(seed))
    return hf, jcfg, jax.tree.map(lambda t: t.numpy().copy(), params)


def tiny(seed: int = 0):
    """The smoke YAML's model, the zero-centred norm scales, router scales
    and layer scalars drawn at random; the KV-shared layers' k/v/k_norm
    rows zero, as a checkpoint loads them."""
    hf, jcfg, jp = _init(seed)
    jp = copy.deepcopy(jp)
    rng = np.random.default_rng(seed)
    for path, leaf in _flat(jp).items():
        node = jp
        for p in path[:-1]:
            node = node[p]
        if path[-1] == "scale" or path[-1] == "layer_scalar":
            node[path[-1]] = rng.normal(0.0 if path[-1] == "scale" else 1.0, 0.3,
                                        leaf.shape).astype(np.float32)
    n = hf["text_config"]["num_kv_shared_layers"]
    for leaf, sub in (("k_proj", "kernel"), ("v_proj", "kernel"), ("k_norm", "scale")):
        jp["layers"][leaf][sub][-n:] = 0.0
    return hf, jcfg, jp


def test_forward_and_gradients_match_jax():
    hf, jcfg, jp = tiny()
    tcfg = gemma4.gemma4_moe_config(hf, dtype=torch.float32, remat_policy="full",
                                    attn_impl="xla")
    ids, seg, pos = batch(2, 24, hf["text_config"]["vocab_size"], 1)
    errs = forward_grads_vs_jax(gemma4, j_gemma4, hf, jcfg, tcfg, jp, ids, seg, pos)
    assert ("layers", "k_proj", "kernel") in errs  # the full layers' rows


def test_shared_layers_get_zero_kv_gradients():
    """The two KV-shared layers read layers 0 and 1's K/V: their own k/v
    kernel rows get exactly zero gradient (None in torch, filled by the
    unbind's backward), the full layers' rows do not."""
    hf, _, jp = tiny()
    tcfg = gemma4.gemma4_moe_config(hf, dtype=torch.float32, remat_policy="none",
                                    attn_impl="xla")
    tp = params_from_jax(jp, device="cpu")
    k = tp["layers"]["k_proj"]["kernel"].requires_grad_()
    ids, _, _ = batch(2, 16, hf["text_config"]["vocab_size"], 3, packed=False)
    logits, _ = gemma4.forward(tp, tcfg, torch.from_numpy(ids))
    (g,) = torch.autograd.grad(logits.square().mean(), [k])
    assert not g[2:].any() and g[0].abs().max() > 0 and g[1].abs().max() > 0


def test_gate_ties_keep_jax_order():
    """Every router column equal for experts 1-3 (expert 0 lower): the three
    tied experts top-2 are 1 and 2, in that order, in both packages."""
    hf, jcfg, jp = tiny()
    tcfg = gemma4.gemma4_moe_config(hf, dtype=torch.float32)
    lp = {"router": {"proj": {"kernel": np.zeros((32, 4), np.float32)},
                     "scale": np.ones(32, np.float32)}}
    lp["router"]["proj"]["kernel"][:, 0] = -1.0
    x = np.random.default_rng(5).normal(size=(6, 32)).astype(np.float32)
    x[:, :] = np.abs(x)  # the column of -1 scores below the tied zeros
    jw, ji = j_gemma4.gemma4_gate(jnp.asarray(x), jax.tree.map(jnp.asarray, lp), jcfg)
    tw, ti = gemma4.gemma4_gate(torch.from_numpy(x), params_from_jax(lp, device="cpu"), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert (ti.numpy() == [1, 2]).all()


def test_checkpoint_round_trips_bitwise(tmp_path):
    hf, jcfg, params = tiny()
    _, _, other = tiny(seed=1)
    tcfg = gemma4.gemma4_moe_config(hf, dtype=torch.float32)
    j_adapter = j_get_adapter("gemma4_moe", jcfg)
    j_save(j_adapter.to_hf(params), str(tmp_path / "jax"), hf_config=hf)
    adapter = get_adapter("gemma4_moe", tcfg)
    with HFCheckpointReader(str(tmp_path / "jax")) as reader:
        names = sorted(reader.keys())
        assert names == sorted(n for n, _ in j_adapter.to_hf(params))
        got = adapter.from_hf(reader, device="cpu", dtype=torch.float32)
    assert_trees_bitwise(got, params_from_jax(params, device="cpu"))
    save_hf_checkpoint(adapter.to_hf(params_from_jax(other, device="cpu")),
                       str(tmp_path / "port"), hf_config=hf)
    with HFCheckpointReader(str(tmp_path / "port")) as reader:
        assert sorted(reader.keys()) == names
    assert_trees_bitwise(j_adapter.from_hf(JReader(str(tmp_path / "port"))), other)
    for name in ("model.language_model.layers.1.self_attn.k_proj.weight",
                 "model.language_model.layers.0.moe.gate_up_proj",
                 "model.language_model.layers.3.router.scale",
                 "model.language_model.layers.2.layer_scalar"):
        assert name in names, name
    assert "model.language_model.layers.2.self_attn.k_proj.weight" not in names


def test_engine_and_generate_refuse_what_jax_refuses():
    """ServingEngine: JAX's NotImplementedError for a HetMoEConfig (and for
    Gemma-4, which no JAX engine drives); generate(): Gemma-4 has no
    generation path in JAX either."""
    hf = smoke_hf()
    gcfg = gemma4.gemma4_moe_config(hf, dtype=torch.float32)
    gparams = gemma4.init(gcfg, torch.Generator().manual_seed(0))
    with open("examples/llm_finetune/mimo_v2_flash_smoke.yaml") as f:
        mhf = yaml.safe_load(f)["model"]["hf_config"]
    hcfg = het_families.mimo_v2_flash_config(mhf, dtype=torch.float32)
    for cfg, params in ((hcfg, {}), (gcfg, gparams)):
        with pytest.raises(NotImplementedError, match="het engine"):
            ServingEngine(params, cfg, ServingConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="Gemma4MoEConfig"):
        generate(gparams, gcfg, torch.zeros((1, 4), dtype=torch.long), None,
                 GenerateConfig(max_new_tokens=2))
