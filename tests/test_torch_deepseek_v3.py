"""What DeepSeek-V3's and Kimi-K2's published configs need, held to the JAX
package on the CPU with the same numpy weights and batches (fp32 unless a
test says otherwise):

- yarn `rope_frequencies` and `yarn_mscale` for both models' scalings
  (DeepSeek-V3: theta 1e4, factor 40, beta 32 / 1, a ramp over dims 10-23
  of the rope dim 64; Kimi-K2: theta 5e4, factor 32, beta 1 / 1, a
  width-1 step at dims 19-20), element by element to 1e-6;
- `config_from_hf` of both published configs (the model-configs catalog's
  numbers) and of tiny configs of their shape: every field equal to JAX's,
  `attn_scale` (with yarn's mscale² folded in) included;
- `init_mtp`'s keys and shapes; `mtp_hidden` and `mtp_loss` on packed
  batches at positions in the thousands, to 1e-5: the last slot's repeated
  next token, the trailing `IGNORE_INDEX` and the labels whose next token
  lies in another document, which the test data makes the loss depend on;
- the MoE decoder's `forward` with yarn at positions in the thousands;
- `examples/llm_finetune/deepseek_v3_smoke.yaml` with DeepSeek-V3's yarn
  and `num_nextn_predict_layers: 1` against a live JAX run from the same
  weights (docs/PARITY.md: 1e-4 relative over steps 1-5); the MTP leaves'
  gradients of the recipe's loss on a packed batch against `jax.grad`;
  a resume from step 3 bit-equal to the unbroken run (one torch thread),
  and the HF export without the MTP head;
  the recipe runs the capacity dispatcher too (`model.moe_dispatcher`),
  so one JAX run holds all three;
- the capacity dispatcher: `compute_capacity`, `dispatch_tensors` (the
  token-major fill, which the test data tells from a slot-major one) and
  the capacity `moe_forward` in fp32 and bf16, each with pairs dropped;
- a tiny yarn DeepSeek-V3 served token-equal to the JAX engine on the fp
  and int8 pools, and greedy `generate()` token-equal to JAX, with
  prompts of 1100-1300 tokens.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.config import ConfigNode as JConfigNode
from automodel_tpu.inference.generate import GenerateConfig as JGenerateConfig
from automodel_tpu.inference.generate import generate as j_generate
from automodel_tpu.models.moe_lm import decoder as j_moe
from automodel_tpu.models.moe_lm import mtp as j_mtp
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.moe import config as j_moe_config
from automodel_tpu.moe import experts as j_experts
from automodel_tpu.moe import layer as j_layer
from automodel_tpu.ops import rope as j_rope
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu.serving import Request as JRequest
from automodel_tpu.serving import ServingConfig as JServingConfig
from automodel_tpu.serving import ServingEngine as JServingEngine
from automodel_tpu_torch.checkpoint import get_adapter
from automodel_tpu_torch.config import load_yaml
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.inference.generate import GenerateConfig, generate
from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.moe_lm import mtp
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.moe import experts
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.layer import moe_forward
from automodel_tpu_torch.ops import rope
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine
from automodel_tpu_torch.training import init_train_state

ATOL = 1e-5
SMOKE_YAML = "examples/llm_finetune/deepseek_v3_smoke.yaml"

# deepseek-ai/DeepSeek-V3 and moonshotai/Kimi-K2-Instruct config.json, as
# the model-configs catalog gives them (Kimi-K2 names DeepSeek-V3's
# architecture)
DEEPSEEK_V3 = {
    "architectures": ["DeepseekV3ForCausalLM"], "vocab_size": 129280,
    "hidden_size": 7168, "intermediate_size": 18432,
    "moe_intermediate_size": 2048, "num_hidden_layers": 61,
    "num_attention_heads": 128, "num_key_value_heads": 128,
    "n_shared_experts": 1, "n_routed_experts": 256,
    "routed_scaling_factor": 2.5, "kv_lora_rank": 512, "q_lora_rank": 1536,
    "qk_rope_head_dim": 64, "qk_nope_head_dim": 128, "v_head_dim": 128,
    "n_group": 8, "topk_group": 4, "num_experts_per_tok": 8,
    "first_k_dense_replace": 3, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc",
    "rope_theta": 10000, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 163840, "num_nextn_predict_layers": 1,
    "tie_word_embeddings": False,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1,
                     "mscale_all_dim": 1, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
}
KIMI_K2 = {
    "architectures": ["DeepseekV3ForCausalLM"], "vocab_size": 163840,
    "hidden_size": 7168, "intermediate_size": 18432,
    "moe_intermediate_size": 2048, "num_hidden_layers": 61,
    "num_attention_heads": 64, "num_key_value_heads": 64,
    "n_shared_experts": 1, "n_routed_experts": 384,
    "routed_scaling_factor": 2.827, "kv_lora_rank": 512, "q_lora_rank": 1536,
    "qk_rope_head_dim": 64, "qk_nope_head_dim": 128, "v_head_dim": 128,
    "n_group": 1, "topk_group": 1, "num_experts_per_tok": 8,
    "first_k_dense_replace": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc",
    "rope_theta": 50000, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 131072, "num_nextn_predict_layers": 0,
    "tie_word_embeddings": False,
    "rope_scaling": {"beta_fast": 1, "beta_slow": 1, "factor": 32, "mscale": 1,
                     "mscale_all_dim": 1, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
}
PUBLISHED = {"deepseek_v3": DEEPSEEK_V3, "kimi_k2": KIMI_K2}
# each model's yarn ramp over the rope dim 64: dims below `low` keep the
# original frequency, dims from `high` on are divided by the factor
RAMPS = {"deepseek_v3": (10, 23), "kimi_k2": (19, 20)}
# the attention scale: 192^-0.5 times yarn's mscale² (1.874, 1.813)
ATTN_SCALES = {"deepseek_v3": 0.13523, "kimi_k2": 0.13086}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def _smoke_hf(model="deepseek_v3", mtp_layers=1):
    """The smoke YAML's tiny DeepSeek-V3 with a published model's yarn
    scaling and theta (its rope dim 8 ramps over dims 1-3) and the MTP
    head."""
    hf = load_yaml(SMOKE_YAML).get("model.hf_config").to_dict()
    pub = PUBLISHED[model]
    return dict(hf, rope_scaling=dict(pub["rope_scaling"]), rope_theta=pub["rope_theta"],
                num_nextn_predict_layers=mtp_layers)


def _configs(hf, dtype="float32"):
    jcfg = j_get_model_spec(hf).config_from_hf(
        hf, dtype=getattr(jnp, dtype), remat_policy="none", attn_impl="xla")
    tcfg = get_model_spec(hf).config_from_hf(
        hf, dtype=getattr(torch, dtype), remat_policy="none")
    return jcfg, tcfg


def _params(tcfg, seed=0):
    """Random weights drawn by the port (faster than a JAX init on the
    CPU) with a random correction bias: (jax tree, numpy tree)."""
    npp = jax.tree.map(lambda t: t.numpy(), moe_decoder.init(
        tcfg, torch.Generator().manual_seed(seed)))
    gate = npp["moe_layers"]["moe"]["gate"]
    gate["e_score_bias"] = np.random.default_rng(seed + 100).normal(
        0, 0.05, gate["e_score_bias"].shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, npp), npp


def _packed_batch(B, S, vocab, seed, offset=3000):
    """Three documents per row whose positions restart at `offset`, pad
    labels (-100) here and there, next-token labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = [0, *sorted(rng.choice(np.arange(2, S - 2), 2, replace=False)), S]
        for d, (a, e) in enumerate(zip(cuts, cuts[1:])):
            seg[b, a:e] = d
            pos[b, a:e] = offset + np.arange(e - a)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    labels[rng.random((B, S)) < 0.15] = -100
    return ids, seg, pos, labels


# -- yarn -------------------------------------------------------------------------
@pytest.mark.parametrize("model", sorted(PUBLISHED))
def test_yarn_frequencies_and_mscale_match_jax(model):
    hf = PUBLISHED[model]
    theta, scaling = float(hf["rope_theta"]), hf["rope_scaling"]
    j_sc = j_rope.RopeScalingConfig.from_hf(scaling)
    t_sc = rope.RopeScalingConfig.from_hf(scaling)
    assert dataclasses.asdict(t_sc) == dataclasses.asdict(j_sc)
    want = np.asarray(j_rope.rope_frequencies(64, theta, j_sc))
    got = rope.rope_frequencies(64, theta, t_sc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert t_sc.yarn_mscale() == pytest.approx(j_sc.yarn_mscale(), rel=1e-12)
    # the interpolation: unscaled below the ramp, divided by the factor from
    # its top on, in between inside the ramp
    low, high = RAMPS[model]
    plain = rope.rope_frequencies(64, theta, None)
    assert torch.equal(got[:low], plain[:low])
    _close(got[high:], plain[high:] / scaling["factor"], atol=0, rtol=1e-6)
    inner = got[low + 1:high]
    assert ((inner < plain[low + 1:high]) & (inner > plain[low + 1:high] / 40)).all()


@pytest.mark.parametrize("model", sorted(PUBLISHED))
def test_published_and_tiny_configs_match_jax(model):
    """Both published configs and tiny configs of their shape build through
    the registry into the JAX package's config, field for field."""
    for hf in (PUBLISHED[model], _smoke_hf(model, PUBLISHED[model]["num_nextn_predict_layers"])):
        jcfg, tcfg = _configs(hf)
        assert get_model_spec(hf).module is moe_decoder
        for f in dataclasses.fields(tcfg):
            if f.name in ("dtype", "moe", "rope_scaling", "attn_impl"):
                continue
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(jcfg.moe)
        assert dataclasses.asdict(tcfg.rope_scaling) == dataclasses.asdict(jcfg.rope_scaling)
        assert tcfg.attn_scale == jcfg.attn_scale
        assert tcfg.rope_dim == jcfg.rope_dim
    pub = _configs(PUBLISHED[model])[1]
    assert pub.attn_scale == pytest.approx(ATTN_SCALES[model], abs=5e-6)
    assert pub.mtp_num_layers == (1 if model == "deepseek_v3" else 0)
    assert pub.num_heads == (128 if model == "deepseek_v3" else 64)


# -- the MTP head -----------------------------------------------------------------
def test_init_mtp_matches_jax_layout():
    jcfg, tcfg = _configs(_smoke_hf())
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jax.eval_shape(lambda: j_moe.init(jcfg, jax.random.key(0))))
    got = jax.tree.map(lambda t: tuple(t.shape),
                       moe_decoder.init(tcfg, torch.Generator().manual_seed(0)))
    assert "mtp" in got and got == want


@pytest.fixture(scope="module")
def mtp_case():
    """The tiny yarn + MTP model's weights and a packed batch at positions
    of ~3000."""
    jcfg, tcfg = _configs(_smoke_hf())
    jp, npp = _params(tcfg)
    ids, seg, pos, labels = _packed_batch(2, 24, tcfg.vocab_size, seed=3)
    h = np.random.default_rng(4).normal(size=(2, 24, tcfg.hidden_size)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_jax(npp, device="cpu"), ids, seg, pos, labels, h


def test_mtp_hidden_and_loss_match_jax_on_packed_batches(mtp_case):
    jcfg, tcfg, jp, tp, ids, seg, pos, labels, h = mtp_case
    want_h = jax.jit(lambda p, *a: j_mtp.mtp_hidden(p, jcfg, *a, lambda x, axes: x))(
        jp, jnp.asarray(h), jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(seg))
    tt = {k: torch.from_numpy(v) for k, v in
          dict(ids=ids, seg=seg, pos=pos, labels=labels, h=h).items()}
    got_h = mtp.mtp_hidden(tp, tcfg, tt["h"], tt["ids"].long(), tt["pos"], tt["seg"])
    _close(got_h, want_h)
    kernel = moe_decoder.head_kernel(tp, tcfg)
    j_kernel = jp["lm_head"]["kernel"]
    for segs in (None, "seg"):
        want = j_mtp.mtp_loss(want_h, j_kernel, jnp.asarray(labels), chunk_size=16,
                              segment_ids=None if segs is None else jnp.asarray(seg))
        got = mtp.mtp_loss(got_h, kernel, tt["labels"].long(), chunk_size=16,
                           segment_ids=None if segs is None else tt["seg"])
        _close(got[0], want[0])
        assert float(got[1]) == float(want[1])
    # the shifts: the last slot ignored, and in packed rows every label
    # whose next token lies in another document
    shifted = mtp.mtp_labels(tt["labels"].long(), tt["seg"])
    assert (shifted[:, -1] == IGNORE_INDEX).all()
    across = (tt["seg"][:, 1:] != tt["seg"][:, :-1]) & (tt["labels"][:, 1:] != -100)
    assert across.any() and (shifted[:, :-1][across] == IGNORE_INDEX).all()
    unmasked = mtp.mtp_labels(tt["labels"].long())
    assert (unmasked[:, :-1][across] != IGNORE_INDEX).all()


def test_mtp_next_token_embedding_repeats_the_last_slot(mtp_case):
    """`mtp_hidden` at slot t embeds token t+1; the last slot repeats its
    own token: changing the last token changes the last two slots only."""
    _, tcfg, _, tp, ids, _, _, _, h = mtp_case
    ids2 = ids.copy()
    ids2[:, -1] = (ids2[:, -1] % (tcfg.vocab_size - 1)) + 1
    a, b = (mtp.mtp_hidden(tp, tcfg, torch.from_numpy(h), torch.from_numpy(x).long())
            for x in (ids, ids2))
    diff = (a - b).abs().amax(-1)
    assert (diff[:, -2:] > 0).all() and (diff[:, :-2] == 0).all()


def test_moe_forward_with_yarn_matches_jax_at_long_positions(mtp_case):
    jcfg, tcfg, jp, tp, ids, seg, pos, labels, _ = mtp_case
    want, j_aux = jax.jit(lambda p, i, q, g: j_moe.forward(
        p, jcfg, i, positions=q, segment_ids=g))(
            jp, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(seg))
    got, t_aux = moe_decoder.forward(tp, tcfg, torch.from_numpy(ids).long(),
                                     positions=torch.from_numpy(pos),
                                     segment_ids=torch.from_numpy(seg))
    _close(got, want)
    _close(t_aux, j_aux, atol=1e-6)


# -- the recipe with yarn and MTP -------------------------------------------------
def _recipe_node(node, tmp_path, name, steps=5, **sets):
    node.set("checkpoint.enabled", False)
    node.set("run_dir", str(tmp_path / name))
    node.set("step_scheduler.max_steps", steps)
    node.set("step_scheduler.num_epochs", 2)  # 4 batches per epoch
    for key, value in sets.items():
        node.set(key, value)
    return node


def _records(run_dir):
    with open(run_dir / "training.jsonl") as f:
        return [json.loads(line) for line in f if "loss" in line]


def _jax_run(tmp_path, name, **sets):
    """A live JAX recipe run of the smoke YAML with `sets`; returns (its
    initial weights as numpy, the recipe, the records)."""
    node = _recipe_node(JConfigNode(load_yaml(SMOKE_YAML).to_dict()), tmp_path, name, **sets)
    recipe = JRecipe(node)
    recipe.setup()
    init = _np_tree(recipe.train_state.params)
    recipe.run_train_validation_loop()
    return init, recipe, _records(tmp_path / name)


# the smoke YAML with DeepSeek-V3's yarn, the MTP head and the capacity
# dispatcher: one JAX run serves the curve and the gradient tests
RECIPE_SETS = {"model.hf_config.rope_scaling": DEEPSEEK_V3["rope_scaling"],
               "model.hf_config.num_nextn_predict_layers": 1,
               "model.moe_dispatcher": "capacity"}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("jax_recipe"), "jax", **RECIPE_SETS)


def _port_recipe(tmp_path, name, init=None, **sets):
    recipe = TrainFinetuneRecipeForNextTokenPrediction(
        _recipe_node(load_yaml(SMOKE_YAML), tmp_path, name, **sets), device="cpu")
    recipe.setup()
    if init is not None:
        recipe.train_state = init_train_state(params_from_jax(init, device="cpu"),
                                              recipe.tx)
    return recipe


def _curves_match(got, want, steps=5):
    assert len(got) == len(want) == steps
    lw = np.array([r["loss"] for r in want])
    lg = np.array([r["loss"] for r in got])
    assert (np.abs(lg - lw) / np.abs(lw)).max() <= 1e-4, (lg, lw)


def test_recipe_with_yarn_mtp_and_capacity_matches_live_jax_run(jax_run, tmp_path):
    init, j_recipe, want = jax_run
    assert "mtp" in init and j_recipe.model_cfg.mtp_num_layers == 1
    recipe = _port_recipe(tmp_path, "port", init, **RECIPE_SETS)
    cfg = recipe.model_cfg
    assert cfg.rope_scaling.rope_type == "yarn" and cfg.mtp_num_layers == 1
    assert cfg.moe.dispatcher == j_recipe.model_cfg.moe.dispatcher == "capacity"
    recipe.run_train_validation_loop()
    _curves_match(_records(tmp_path / "port"), want)


def test_mtp_recipe_gradients_match_jax_on_a_packed_batch(jax_run, tmp_path):
    """The recipe's loss (CE sum + 0.1 x MTP CE sum + aux) on a packed batch
    at positions of ~3000, from the JAX run's initial weights: every leaf's
    gradient, the MTP head's included, within 1e-5 of its largest
    magnitude."""
    init, j_recipe, _ = jax_run
    recipe = _port_recipe(tmp_path, "grads", init, **RECIPE_SETS)
    ids, seg, pos, labels = _packed_batch(8, 32, 128, seed=8)
    batch = dict(input_ids=ids, segment_ids=seg, positions=pos, labels=labels)
    j_loss = j_recipe._make_loss_fn()
    jp = jax.tree.map(jnp.asarray, init)
    (j_val, _), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    params = params_from_jax(init, device="cpu")
    leaves = {}

    def track(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                track(v, path + (k,))
            else:
                leaves[path + (k,)] = v.requires_grad_()

    track(params)
    tb = {k: torch.from_numpy(v).long() if k in ("input_ids", "labels")
          else torch.from_numpy(v) for k, v in batch.items()}
    t_val, _ = recipe._loss_fn(params, tb, None)
    t_val.backward()
    _close(t_val, j_val, atol=0, rtol=1e-5)
    n_mtp = 0
    for path, leaf in leaves.items():
        want = np.array(_get(j_grads, path))
        got = leaf.grad
        if got is None:  # the correction bias: a stop_gradient in JAX
            assert np.abs(want).max() == 0, path
            continue
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float((got - torch.from_numpy(want)).abs().max()) <= 1e-5 * scale, path
        n_mtp += path[0] == "mtp"
    assert n_mtp == len([p for p in leaves if p[0] == "mtp"]) > 0


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.fixture
def one_thread():
    """Bit-reproducible CPU runs: with several threads the intra-op pool
    splits some reductions by the threads it gets."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mtp_resume_is_bit_equal(tmp_path, one_thread):
    """The checkpoint carries the MTP head and its optimizer state: a run
    resumed from step 3 gives the unbroken run's steps 4-5 and final MTP
    weights bit for bit."""
    def node(run, steps):
        ck = {"enabled": True, "checkpoint_dir": str(tmp_path / f"ck_{run}"),
              "async_save": False}
        n = _recipe_node(load_yaml(SMOKE_YAML), tmp_path, run, steps, **RECIPE_SETS)
        n.set("checkpoint", ck)
        n.set("auto_resume", True)
        n.set("step_scheduler.ckpt_every_steps", 3)
        return n

    runs = {}
    for run, steps in (("full", 5), ("half", 3), ("half", 5)):
        recipe = TrainFinetuneRecipeForNextTokenPrediction(node(run, steps), device="cpu")
        recipe.setup()
        recipe.run_train_validation_loop()
        runs[run] = recipe
    full = [r["loss"] for r in _records(tmp_path / "full")]
    half = [r["loss"] for r in _records(tmp_path / "half")]
    assert half == full and len(full) == 5
    for a, b in zip(*(jax.tree.leaves(jax.tree.map(
            lambda t: t.detach().numpy(), runs[r].train_state.params["mtp"]))
            for r in ("full", "half"))):
        np.testing.assert_array_equal(a, b)
    # the HF export leaves the MTP head out: the same tensors without it
    recipe = runs["full"]
    adapter = get_adapter(recipe.model_spec.adapter_name, recipe.model_cfg,
                          **recipe.model_spec.adapter_kwargs)
    params = recipe.train_state.params
    without = {k: v for k, v in params.items() if k != "mtp"}
    names = [name for name, _ in adapter.to_hf(params)]
    assert names == [name for name, _ in adapter.to_hf(without)]
    assert not any("mtp" in name for name in names)


# -- the capacity dispatcher ------------------------------------------------------
MOE_KW = dict(n_routed_experts=8, n_shared_experts=1, experts_per_token=3,
              moe_intermediate_size=16, score_func="sigmoid", n_groups=2,
              topk_groups=1, route_scale=2.5, gate_bias_update_speed=0.001,
              dispatcher="capacity", capacity_factor=0.6)


def _slot_major_keep(idx, E, capacity):
    """What a fill by slot first (every token's slot 0, then slot 1, ...)
    would keep: the order the JAX dispatcher does not use."""
    T, K = idx.shape
    seen, keep = np.zeros(E, int), np.zeros((T, K), bool)
    for k in range(K):
        for t in range(T):
            e = idx[t, k]
            if e < E:
                keep[t, k] = seen[e] < capacity
                seen[e] += 1
    return keep


def test_compute_capacity_and_dispatch_tensors_match_jax():
    j_cfg = j_moe_config.MoEConfig(**MOE_KW)
    t_cfg = MoEConfig(**MOE_KW)
    for T in (1, 13, 40, 100, 333):
        assert experts.compute_capacity(t_cfg, T) == j_experts.compute_capacity(j_cfg, T)
    rng = np.random.default_rng(5)
    T, K, E = 100, 3, 8
    # skewed routing (experts 0-2 twice as likely), a few masked tokens (E)
    p = np.array([2, 2, 2, 1, 1, 1, 1, 1], float)
    idx = np.stack([rng.choice(E, K, replace=False, p=p / p.sum()) for _ in range(T)])
    idx = idx.astype(np.int32)
    idx[rng.random(T) < 0.1] = E
    w = rng.random((T, K)).astype(np.float32)
    cap = experts.compute_capacity(t_cfg, T)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jd, jc = j_experts.dispatch_tensors(j_cfg, jnp.asarray(idx), jnp.asarray(w), cap,
                                            dtype=jdtype)
        td, tc = experts.dispatch_tensors(t_cfg, torch.from_numpy(idx), torch.from_numpy(w),
                                          cap, dtype=dtype)
        assert td.dtype == dtype
        np.testing.assert_array_equal(td.float().numpy(), np.asarray(jd, np.float32))
        _close(tc, jc, atol=0, rtol=0)
    kept = np.asarray(jd, np.float32).sum()
    routed = int((idx < E).sum())
    assert 0 < kept < routed  # pairs were dropped
    # the fill is token-major over the flattened routing; a slot-major fill
    # would keep other pairs, which these data tell apart
    keep = (td.float().sum(-1).numpy() > 0)  # (T, E): token t kept at expert e
    token_major = np.zeros((T, K), bool)
    for t in range(T):
        for k in range(K):
            if idx[t, k] < E:
                token_major[t, k] = keep[t, idx[t, k]]
    assert (token_major != _slot_major_keep(idx, E, cap)).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capacity_moe_forward_matches_jax_with_drops(dtype):
    """The capacity `moe_forward` (gate, dispatch, batched expert MLP,
    combine, shared expert) on 60 tokens, some masked, with pairs dropped:
    fp32 to 1e-5, bf16 to 2e-2 of the largest output (the two frameworks
    round the bf16 products at other places)."""
    H = 24
    j_cfg = j_moe_config.MoEConfig(**MOE_KW)
    t_cfg = MoEConfig(**MOE_KW)
    params = _np_tree(j_layer.init_moe(j_cfg, H, jax.random.key(2)))
    params["gate"]["e_score_bias"] = np.random.default_rng(3).normal(
        0, 0.1, params["gate"]["e_score_bias"].shape).astype(np.float32)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 30, H)).astype(np.float32)
    mask = rng.random((2, 30)) > 0.1
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, j_aux, jst = jax.jit(lambda p, xx, m: j_layer.moe_forward(
        p, j_cfg, xx, lambda a, ax: a, token_mask=m))(
            jax.tree.map(lambda a: jnp.asarray(a, jdt), params), jnp.asarray(x, jdt),
            jnp.asarray(mask))
    got, t_aux, tst = moe_forward(params_from_jax(params, device="cpu", dtype=tdt),
                                  t_cfg, torch.from_numpy(x).to(tdt),
                                  token_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(tst["indices"].numpy(), np.asarray(jst["indices"]))
    cap = experts.compute_capacity(t_cfg, 60)
    counts = np.bincount(tst["indices"].numpy().reshape(-1), minlength=9)[:8]
    assert (counts > cap).any()  # some expert overflows: pairs dropped
    want = np.asarray(want, np.float32)
    tol = ATOL if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    # and the drops matter: the dropless output differs
    dropless = moe_forward(params_from_jax(params, device="cpu", dtype=tdt),
                           dataclasses.replace(t_cfg, dispatcher="dropless"),
                           torch.from_numpy(x).to(tdt), token_mask=torch.from_numpy(mask))[0]
    assert (dropless.float() - got.float()).abs().max() > 10 * tol


# -- serving and generate() with yarn ---------------------------------------------
PROMPTS = (1100, 1300)
SERVE_KW = dict(page_size=16, num_pages=200, max_slots=2, pages_per_slot=90,
                token_budget=512, prefill_chunk=480)


@pytest.fixture(scope="module")
def yarn_model():
    jcfg, tcfg = _configs(_smoke_hf(mtp_layers=0))
    jp, npp = _params(tcfg, seed=1)
    prompts = [np.random.default_rng(20 + i).integers(1, tcfg.vocab_size, n).tolist()
               for i, n in enumerate(PROMPTS)]
    return jcfg, tcfg, jp, params_from_jax(npp, device="cpu"), prompts


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_yarn_serve_batch_token_equal_to_jax(yarn_model, kv):
    jcfg, tcfg, jp, tp, prompts = yarn_model
    sc = dict(SERVE_KW, kv_cache_dtype=None if kv == "fp" else "int8")
    sc = {k: v for k, v in sc.items() if v is not None}
    want = JServingEngine(jp, jcfg, JServingConfig(**sc)).serve_batch(
        [JRequest(prompt=p, max_new_tokens=4, arrival=i) for i, p in enumerate(prompts)])
    got = ServingEngine(tp, tcfg, ServingConfig(**sc), device="cpu").serve_batch(
        [Request(prompt=p, max_new_tokens=4, arrival=i) for i, p in enumerate(prompts)])
    assert got["outputs"] == want["outputs"]
    assert all(len(o) == 4 for o in got["outputs"])
    for key in ("steps", "new_tokens", "tokens_fed"):
        assert got["stats"][key] == want["stats"][key], key


def test_yarn_greedy_generate_token_equal_to_jax(yarn_model):
    jcfg, tcfg, jp, tp, prompts = yarn_model
    ids = np.asarray([prompts[0]], np.int32)
    want = np.asarray(j_generate(jp, jcfg, jnp.asarray(ids), jax.random.key(0),
                                 JGenerateConfig(max_new_tokens=4)))
    got = generate(tp, tcfg, torch.from_numpy(ids), None, GenerateConfig(max_new_tokens=4))
    np.testing.assert_array_equal(got.numpy(), want)
    # without yarn's interpolation and scale the same weights give other
    # logits at these positions
    plain = dataclasses.replace(tcfg, rope_scaling=rope.RopeScalingConfig(),
                                attn_scale=None)
    ids_t = torch.from_numpy(ids).long()
    a = moe_decoder.forward(tp, tcfg, ids_t)[0][0, -1]
    b = moe_decoder.forward(tp, plain, ids_t)[0][0, -1]
    assert (a - b).abs().max() > 1e-2 * a.abs().max()
    assert math.isfinite(float(a.abs().max()))
