"""Port parity of the heterogeneous MoE engine: Step-3.5, MiMo-V2-Flash and
MiniMax-M3 (`models/moe_lm/het_moe.py`, `het_families.py`) on the CPU, the
JAX package and `automodel_tpu_torch` fed the same HF configs, numpy
weights, batches and checkpoints.

- The configs field for field (the three smoke YAMLs' and MiMo-V2-Flash's
  published one, as `chip_smoke.py` holds it), the registry's entries.
- Each smoke model's `forward` (Step-3.5's with per-layer rotary fractions
  and a NoPE layer; every sink, correction bias and norm scale drawn at
  random; one row of two packed documents): logits within
  atol = rtol = 1e-5, the aux loss within 1e-6, every gradient leaf within
  1e-5 of its largest magnitude (fp32). MiniMax-M3 runs unpacked and
  packed, with more key blocks than `sparse_topk_blocks`.
- `select_sparse_blocks`' keep mask bit for bit with JAX's, with tied
  block scores and forced blocks, so that the order of ties decides.
- HF checkpoints of the three styles both ways, bit for bit, in JAX's
  names.
- The MiMo-V2-Flash and Gemma-4 smoke YAMLs through both training recipes
  from one JAX-written HF checkpoint (`--distributed.ep=1`): losses within
  1e-4 relative, MiMo's expert bias and Gemma-4's KV-shared placeholders
  (exact zeros in both) after the run; the grad norms and the AdamW
  moments within 1e-4 of optax's.
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
from automodel_tpu.config import parse_args_and_load_config as j_parse
from automodel_tpu.models.moe_lm import het_moe as j_het
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu_torch.checkpoint import HFCheckpointReader, get_adapter, save_hf_checkpoint
from automodel_tpu_torch.config import parse_args_and_load_config
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.moe_lm import het_families, het_moe
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.recipes.llm.train_ft import TrainFinetuneRecipeForNextTokenPrediction
from chip_smoke import MIMO_V2_FLASH

SMOKE = ("step3p5", "mimo_v2_flash", "minimax_m3")
FUNCTIONS = {"step3p5": "step3p5_config", "mimo_v2_flash": "mimo_v2_flash_config",
             "minimax_m3": "minimax_m3_text_config"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: the models are tiny, and several threads
    per worker oversubscribe the cores under the tier-1 run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_hf(family: str) -> dict:
    with open(f"examples/llm_finetune/{family}_smoke.yaml") as f:
        return yaml.safe_load(f)["model"]["hf_config"]


# the models the forward, checkpoint and generate tests run: the smoke
# YAMLs' with Step-3.5's per-layer rotary fractions and a NoPE layer added,
# as tests/unit/test_model_pins.py pins it
MODEL_EXTRA = {"step3p5": dict(partial_rotary_factors=[1.0, 0.5, 0.5, 1.0],
                               use_rope_layers=[True, True, False, True])}


def model_hf(family: str) -> dict:
    return dict(smoke_hf(family), **MODEL_EXTRA.get(family, {}))


CONFIG_CASES = {**{f"{f}_smoke": (f, None) for f in SMOKE},
                "step3p5_nope": ("step3p5", "model"),
                "mimo_v2_flash_published": ("mimo_v2_flash", MIMO_V2_FLASH)}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_family_config_matches_jax(case):
    family, hf = CONFIG_CASES[case]
    hf = model_hf(family) if hf == "model" else hf or smoke_hf(family)
    spec, j_spec = get_model_spec(hf), j_get_model_spec(hf)
    want = j_spec.config_from_hf(hf, dtype=jnp.float32)
    got = spec.config_from_hf(hf, dtype=torch.float32)
    _fields_equal(got, want)
    assert spec.config_from_hf is getattr(het_families, FUNCTIONS[family])
    assert spec.module is het_moe
    assert (spec.name, spec.adapter_name, spec.adapter_kwargs) == (
        j_spec.name, j_spec.adapter_name, j_spec.adapter_kwargs)


def test_published_mimo_widths():
    """What the card's MiMo phases rely on: the first two layers are one
    global (dense MLP) and one sliding layer with sinks (MoE), at q/k 192,
    v 128, G 16 and G 8, window 128, 64 rotary channels."""
    c = het_families.mimo_v2_flash_config(MIMO_V2_FLASH)
    assert c.layer_types[:2] == ("global", "sliding") and c.mlp_kinds[:2] == ("dense", "moe")
    g, s = c.global_attn, c.sliding_attn
    assert (g.head_dim, g.vd, g.num_heads // g.num_kv_heads, g.sinks) == (192, 128, 16, False)
    assert (s.head_dim, s.vd, s.num_heads // s.num_kv_heads, s.sinks) == (192, 128, 8, True)
    assert s.sliding_window == 128
    assert int(s.head_dim * c.partial_rotary[1]) // 2 * 2 == 64


@functools.lru_cache(maxsize=None)
def _init(family: str, seed: int):
    hf = model_hf(family)
    jcfg = j_get_model_spec(hf).config_from_hf(hf, dtype=jnp.float32, remat_policy="none",
                                               attn_impl="xla")
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32)
    params = het_moe.init(tcfg, torch.Generator().manual_seed(seed))
    return hf, jcfg, _to_numpy(params)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def tiny(family: str, seed: int = 0):
    """The smoke YAML's model, every sink, correction bias and norm scale
    drawn at random (sinks around 1: a sink takes a share of the mass; norm
    weights around 1, zero-centred ones stored around 0)."""
    hf, jcfg, jp = _init(family, seed)
    jp = copy.deepcopy(jp)
    rng = np.random.default_rng(seed)
    norm_center = 0.0 if jcfg.zero_centered_norm else 1.0  # stored as scale - 1
    for path, leaf in _flat(jp).items():
        node = jp
        for p in path[:-1]:
            node = node[p]
        if path[-1] in ("bias", "e_score_bias", "sinks"):
            node[path[-1]] = rng.normal(1.0 if path[-1] == "sinks" else 0.0, 0.5,
                                        leaf.shape).astype(np.float32)
        elif path[-1] == "scale":
            node[path[-1]] = rng.normal(norm_center, 0.3, leaf.shape).astype(np.float32)
    return hf, jcfg, jp


def batch(B, S, vocab, seed, packed=True):
    """Row 0 one document of S tokens; with `packed`, row 1 two packed
    documents (segment ids, positions restarting at the cut)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, S)).astype(np.int32)
    if not packed:
        return ids, None, None
    seg = np.zeros((B, S), np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    cut = S // 3
    seg[1, cut:] = 1
    pos[1, cut:] = np.arange(S - cut)
    return ids, seg, pos


def forward_grads_vs_jax(module, j_module, hf, jcfg, tcfg, jp, ids, seg, pos):
    """The port's logits, aux and gradients against JAX's (fp32), under a
    random cotangent on the logits plus 10 x aux, one row masked at its
    end. Returns {leaf path: relative gradient error}."""
    B, S = ids.shape
    mask = np.ones((B, S), bool)
    mask[1, -3:] = False
    cot = np.random.default_rng(2).normal(size=(B, S, hf_vocab(hf))).astype(np.float32)
    jkw = dict(token_mask=jnp.asarray(mask))
    tkw = dict(token_mask=torch.from_numpy(mask))
    if seg is not None:
        jkw.update(segment_ids=jnp.asarray(seg), positions=jnp.asarray(pos))
        tkw.update(segment_ids=torch.from_numpy(seg), positions=torch.from_numpy(pos))

    def j_loss(params):
        logits, aux = j_module.forward(params, jcfg, jnp.asarray(ids), **jkw)
        return jnp.sum(logits * cot) + 10.0 * aux, (logits, aux)

    (_, (jl, jaux)), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    tp = params_from_jax(jp, device="cpu")
    leaves = {k: v.requires_grad_() for k, v in _flat(tp).items()}
    tl, taux = module.forward(tp, tcfg, torch.from_numpy(ids), **tkw)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6)
    grads = torch.autograd.grad((tl * torch.from_numpy(cot)).sum() + 10.0 * taux,
                                list(leaves.values()), allow_unused=True)
    jflat = _flat(_np_tree(jg))
    errs = {}
    for key, g in zip(leaves, grads):
        want = jflat[key]
        if g is None:
            # the correction bias (stop_gradient in JAX) and rows no layer
            # reads (an unused geometry's): zero gradients in JAX
            assert not np.abs(want).any(), key
            continue
        errs[key] = float(np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-30))
        assert errs[key] <= 1e-5, (key, errs[key])
    return errs


def hf_vocab(hf):
    return (hf.get("text_config") or hf)["vocab_size"]


FORWARD_CASES = {"step3p5": ("step3p5", True), "mimo_v2_flash": ("mimo_v2_flash", True),
                 "minimax_m3": ("minimax_m3", False),
                 "minimax_m3_packed": ("minimax_m3", True)}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_and_gradients_match_jax(case):
    family, packed = FORWARD_CASES[case]
    hf, jcfg, jp = tiny(family)
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32,
                                             remat_policy="full", attn_impl="xla")
    S = 40  # MiniMax-M3's 10 key blocks of 4 against its top 3
    ids, seg, pos = batch(2, S, hf["vocab_size"], 1, packed)
    errs = forward_grads_vs_jax(het_moe, j_het, hf, jcfg, tcfg, jp, ids, seg, pos)
    if family == "minimax_m3":
        assert -(-S // tcfg.sparse_block_size) > tcfg.sparse_topk_blocks
        assert ("indexer", "index_q_proj", "kernel") not in errs  # selection only
    if family == "mimo_v2_flash":
        assert ("s_attn", "sinks") in errs  # the sinks learn


def _keep_pair(idx_q, idx_k, rows, **kw):
    want = np.asarray(j_het.select_sparse_blocks(
        jnp.asarray(idx_q), jnp.asarray(idx_k), jnp.asarray(rows), **kw))
    got = het_moe.select_sparse_blocks(
        torch.from_numpy(idx_q), torch.from_numpy(idx_k), torch.from_numpy(rows), **kw)
    return got.numpy(), want


@pytest.mark.parametrize("score_type", ("max", "lse"))
@pytest.mark.parametrize("scores", ("tied", "random"))
def test_select_sparse_blocks_bitwise_with_ties(score_type, scores):
    """Block scores all equal (one index key row repeated) or random, the
    first block and the query's own forced, more causal blocks than the
    top-k: the keep masks must be equal bit for bit. With ties, which
    unforced blocks win is decided by the order of ties alone (the lowest
    block index in both)."""
    rng = np.random.default_rng(3)
    B, S, Hi, Di = 2, 29, 2, 8
    idx_q = rng.normal(size=(B, S, Hi, Di)).astype(np.float32)
    idx_k = rng.normal(size=(B, S, Di)).astype(np.float32)
    if scores == "tied":
        idx_k[:] = idx_k[:, :1]
    rows = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kw = dict(block_size=4, topk_blocks=3, init_blocks=1, local_blocks=1,
              score_type=score_type)
    got, want = _keep_pair(idx_q, idx_k, rows, **kw)
    np.testing.assert_array_equal(got, want)
    if scores == "tied":
        # the last query (block 7) keeps blocks 0 and 7 (forced) and block 1,
        # the lowest of the six tied ones
        kept = sorted({t // 4 for t in np.flatnonzero(got[0, 0, S - 1])})
        assert kept == [0, 1, 7], kept


def _adapter_round_trip(family, tmp_path):
    hf, jcfg, params = tiny(family)
    _, _, other = tiny(family, seed=1)
    spec = get_model_spec(hf)
    tcfg = spec.config_from_hf(hf, dtype=torch.float32)
    kw = spec.adapter_kwargs
    j_adapter = j_get_adapter("het_moe", jcfg, **kw)
    j_save(j_adapter.to_hf(params), str(tmp_path / "jax"), hf_config=hf)
    adapter = get_adapter("het_moe", tcfg, **kw)
    with HFCheckpointReader(str(tmp_path / "jax")) as reader:
        names = sorted(reader.keys())
        assert names == sorted(n for n, _ in j_adapter.to_hf(params))
        got = adapter.from_hf(reader, device="cpu", dtype=torch.float32)
    unused = [k for k, lt in (("g_attn", "global"), ("s_attn", "sliding"))
              if lt not in tcfg.layer_types]
    strip = lambda t: {k: v for k, v in t.items() if k not in unused}  # noqa: E731
    assert_trees_bitwise(strip(got), params_from_jax(strip(params), device="cpu"))
    save_hf_checkpoint(adapter.to_hf(params_from_jax(other, device="cpu")),
                       str(tmp_path / "port"), hf_config=hf)
    with HFCheckpointReader(str(tmp_path / "port")) as reader:
        assert sorted(reader.keys()) == names
    assert_trees_bitwise(strip(j_adapter.from_hf(JReader(str(tmp_path / "port")))),
                         strip(other))
    return names


@pytest.mark.parametrize("family", SMOKE)
def test_checkpoints_round_trip_bitwise(family, tmp_path):
    names = _adapter_round_trip(family, tmp_path)
    expect = {
        "step3p5": ("model.layers.1.moe.gate_proj.weight", "model.layers.1.moe.router_bias",
                    "model.layers.1.share_expert.up_proj.weight",
                    "model.layers.0.self_attn.g_proj.weight"),
        "mimo_v2_flash": ("model.layers.1.self_attn.attention_sink_bias",
                          "model.layers.1.mlp.experts.3.down_proj.weight",
                          "model.layers.1.mlp.gate.e_score_correction_bias",
                          "model.layers.1.mlp.shared_experts.gate_proj.weight"),
        "minimax_m3": ("model.layers.1.self_attn.index_q_proj.weight",
                       "model.layers.1.block_sparse_moe.experts.0.w1.weight",
                       "model.layers.1.block_sparse_moe.e_score_correction_bias",
                       "model.layers.2.block_sparse_moe.shared_experts.down_proj.weight"),
    }[family]
    for name in expect:
        assert name in names, name


def test_gate_bias_update_matches_jax():
    hf, jcfg, jp = tiny("mimo_v2_flash")
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32)
    tpe = np.random.default_rng(4).integers(0, 9, (3, 4)).astype(np.float32)
    want = j_het.apply_gate_bias_update(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(tpe))
    tp = params_from_jax(jp, device="cpu")
    het_moe.apply_gate_bias_update(tp, tcfg, torch.from_numpy(tpe))
    np.testing.assert_array_equal(tp["moe"]["gate"]["e_score_bias"].numpy(),
                                  np.asarray(want["moe"]["gate"]["e_score_bias"]))


# --- the training recipes ---------------------------------------------------
def _losses(path, key="loss"):
    import json

    with open(path) as f:
        return [json.loads(line)[key] for line in f]


def _adam_moments(opt_state):
    """optax's ScaleByAdamState (mu, nu) out of a chained state."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu")):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node.mu, node.nu
    raise AssertionError("no adam state")


@pytest.mark.parametrize("family", ("mimo_v2_flash", "gemma4_moe"))
def test_smoke_recipe_matches_live_jax_run(family, tmp_path):
    """Both training recipes from the JAX package's HF checkpoint of the
    smoke YAML's model (the port's init, biases drawn at random), the same
    YAML with `--distributed.ep=1` and the same mock batches: losses
    within 1e-4 relative, grad norms likewise; after the run MiMo's
    correction bias (moved) equal to 1e-6, Gemma-4's KV-shared k/v
    placeholders exact zeros in both, and the AdamW moments of every leaf
    within 1e-4 of the leaf's largest (the placeholders' moments zero)."""
    if family == "gemma4_moe":
        from test_torch_gemma4 import tiny as tiny_gemma4

        hf, jcfg, params = tiny_gemma4(seed=6)
    else:
        hf, jcfg, params = tiny(family, seed=6)
    spec = j_get_model_spec(hf)
    j_save(j_get_adapter(spec.adapter_name, jcfg, **spec.adapter_kwargs).to_hf(params),
           str(tmp_path / "ckpt"), hf_config=hf)
    recipes, records = {}, {}
    for name in ("jax", "port"):
        argv = [f"examples/llm_finetune/{family}_smoke.yaml",
                f"--model.pretrained_path={tmp_path / 'ckpt'}",
                f"--run_dir={tmp_path / name}", "--distributed.ep=1",
                "--step_scheduler.max_steps=3"]
        if name == "jax":
            recipe = JRecipe(j_parse(argv))
        else:
            recipe = TrainFinetuneRecipeForNextTokenPrediction(
                parse_args_and_load_config(argv), device="cpu")
        recipe.setup()
        recipe.run_train_validation_loop()
        recipes[name] = recipe
        records[name] = {k: np.array(_losses(tmp_path / name / "training.jsonl", k))
                         for k in ("loss", "grad_norm")}
    for k in ("loss", "grad_norm"):
        assert len(records["jax"][k]) == len(records["port"][k]) == 3
        rel = np.abs(records["port"][k] - records["jax"][k]) / np.abs(records["jax"][k])
        assert rel.max() <= 1e-4, (k, rel)
    jp = recipes["jax"].train_state.params
    tp = recipes["port"].train_state.params
    mu, nu = _adam_moments(recipes["jax"].train_state.opt_state)
    t_state = recipes["port"].train_state.opt_state
    for tree_j, tree_t in ((mu, t_state["mu"]), (nu, t_state["nu"])):
        fj, ft = _flat(_np_tree(tree_j)), _flat(tree_t)
        assert sorted(fj) == sorted(ft)
        for key, want in fj.items():
            got = ft[key].detach().numpy()
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= 1e-4 or np.abs(want).max() < 1e-12, (key, err)
    if family == "mimo_v2_flash":
        want = np.asarray(jp["moe"]["gate"]["e_score_bias"])
        got = tp["moe"]["gate"]["e_score_bias"].detach().numpy()
        assert np.abs(want - params["moe"]["gate"]["e_score_bias"]).max() > 1e-4
        np.testing.assert_allclose(got, want, atol=1e-6)
    else:
        shared = slice(hf["text_config"]["num_hidden_layers"]
                       - hf["text_config"]["num_kv_shared_layers"], None)
        for leaf in ("k_proj", "v_proj"):
            for tree in (np.asarray(jp["layers"][leaf]["kernel"]),
                         tp["layers"][leaf]["kernel"].detach().numpy()):
                assert not tree[shared].any(), leaf
            assert not t_state["mu"]["layers"][leaf]["kernel"][shared].any()
