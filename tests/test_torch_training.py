"""Port parity of the training slice: the JAX package and
`automodel_tpu_torch` fed the same numpy weights and batches on the CPU.

- decoder `forward` hidden states and logits, within 1e-5 (fp32; only the
  order of operations differs);
- `fused_linear_cross_entropy` sum, count and gradients, within 1e-5;
- AdamW / Adam / SGD and every LR style against optax over 5 steps with
  weight decay on, which covers the `ndim >= 2` decay mask of the stacked
  layout (the (L, H) norm scales are decayed);
- `make_train_step` with accumulation and clipping: losses and grad norms
  within 1e-4 relative over 5 steps;
- the recipe end to end on `tiny_llama_mock_smoke.yaml`: the port's
  training.jsonl losses against a live JAX run from the same weights,
  within 1e-4 relative for steps 1-5 and 5e-3 through step 10 (the
  docs/PARITY.md protocol);
- the bf16 `unembed` repair: fp32 logits from bf16 operands, as JAX's
  `preferred_element_type=float32` gives them.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from automodel_tpu.config import ConfigNode as JConfigNode
from automodel_tpu.loss import fused_linear_cross_entropy as j_flce
from automodel_tpu.loss import masked_cross_entropy as j_masked_ce
from automodel_tpu.loss.utils import combine_losses as j_combine_losses
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.optim import LRSchedulerConfig as JLRSchedulerConfig
from automodel_tpu.optim import OptimizerConfig as JOptimizerConfig
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu.training import init_train_state as j_init_train_state
from automodel_tpu.training import make_train_step as j_make_train_step
from automodel_tpu.training.train_step import TrainStepConfig as JTrainStepConfig
from automodel_tpu_torch.cli import app
from automodel_tpu_torch.config import ConfigNode, load_yaml
from automodel_tpu_torch.config.loader import _resolve_target
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.distributed import MeshConfig, MeshContext
from automodel_tpu_torch.loss import fused_linear_cross_entropy, masked_cross_entropy
from automodel_tpu_torch.loss.utils import combine_losses
from automodel_tpu_torch.models.common.layers import maybe_remat
from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.optim import LRSchedulerConfig, OptimizerConfig
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.training import (
    TrainStepConfig,
    init_train_state,
    make_train_step,
)

ATOL = 1e-5
TINY_YAML = "examples/llm_finetune/tiny_llama_mock_smoke.yaml"

CFG = dict(vocab_size=96, hidden_size=32, intermediate_size=48, num_layers=2,
           num_heads=4, num_kv_heads=2)
VARIANTS = {
    "llama": {},
    "qknorm_softcap_window": dict(qk_norm=True, attn_soft_cap=20.0,
                                  logits_soft_cap=30.0, sliding_window=5),
}


def _cfgs(**kw):
    j = j_decoder.TransformerConfig(**CFG, **kw, dtype=jnp.float32,
                                    remat_policy="none", attn_impl="xla")
    t = decoder.TransformerConfig(**CFG, **kw, dtype=torch.float32,
                                  remat_policy="full", attn_impl="auto")
    return j, t


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(jcfg, seed=0):
    jp = j_decoder.init(jcfg, jax.random.key(seed))
    return jp, params_from_jax(_np_tree(jp), device="cpu")


def _close(got, want, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def _packed_batch(B, S, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = [0, *sorted(rng.choice(np.arange(1, S), 2, replace=False)), S]
        for d, (a, e) in enumerate(zip(cuts, cuts[1:])):
            seg[b, a:e] = d
            pos[b, a:e] = np.arange(e - a)
    return ids, seg, pos


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decoder_forward_hidden_and_logits(variant):
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    jp, tp = _params(jcfg)
    ids, seg, pos = _packed_batch(2, 16, CFG["vocab_size"], 1)
    for kw in ({}, {"segment_ids": seg, "positions": pos}):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
        jh = j_decoder.forward(jp, jcfg, jnp.asarray(ids), return_hidden=True, **jkw)
        th = decoder.forward(tp, tcfg, torch.from_numpy(ids), return_hidden=True, **tkw)
        _close(th, jh)
        jl = j_decoder.forward(jp, jcfg, jnp.asarray(ids), **jkw)
        tl = decoder.forward(tp, tcfg, torch.from_numpy(ids), **tkw)
        assert tl.dtype == torch.float32
        _close(tl, jl)


def test_remat_full_matches_none_and_other_policies_raise():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    ids = torch.from_numpy(_packed_batch(2, 12, CFG["vocab_size"], 2)[0])
    grads = []
    # the selective policies run too (tests/test_torch_remat_policies.py
    # holds them to JAX); a name JAX does not know raises
    for policy in ("full", "none", "dots"):
        w = tp["layers"]["gate_proj"]["kernel"].clone().requires_grad_()
        p = dict(tp, layers=dict(tp["layers"], gate_proj={"kernel": w}))
        cfg = dataclasses.replace(tcfg, remat_policy=policy)
        (g,) = torch.autograd.grad(decoder.forward(p, cfg, ids).square().mean(), [w])
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(grads[2], grads[0], rtol=0, atol=1e-6)
    with pytest.raises(KeyError, match="dots_saveable"):
        maybe_remat(lambda x: x, "dots_saveable")
    # a mesh runs (tests/test_torch_mesh.py); context parallelism is item 12b
    with pytest.raises(NotImplementedError, match="12b"):
        decoder.forward(tp, tcfg, ids, mesh_ctx=MeshContext(MeshConfig(cp=2, dp_shard=1)))


@pytest.mark.parametrize("chunk,soft_cap,weighted", [
    (24, None, False), (7, 15.0, True), (1024, None, False),
])
def test_fused_linear_cross_entropy(chunk, soft_cap, weighted):
    rng = np.random.default_rng(3)
    B, S, H, V = 2, 20, 16, 40
    h = rng.normal(size=(B, S, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, :5] = -100
    tw = rng.uniform(0.5, 2.0, (B, S)).astype(np.float32) if weighted else None
    kw = dict(chunk_size=chunk, logits_soft_cap=soft_cap)

    def j_loss(h, w):
        return j_flce(h, w, jnp.asarray(labels), token_weights=None if tw is None
                      else jnp.asarray(tw), **kw)

    (j_sum, j_n), j_vjp = jax.vjp(j_loss, jnp.asarray(h), jnp.asarray(w))
    j_dh, j_dw = j_vjp((jnp.float32(1.0), jnp.float32(0.0)))
    th = torch.from_numpy(h).requires_grad_()
    tw_ = torch.from_numpy(w).requires_grad_()
    t_sum, t_n = fused_linear_cross_entropy(
        th, tw_, torch.from_numpy(labels),
        token_weights=None if tw is None else torch.from_numpy(tw), **kw)
    t_sum.backward()
    _close(t_sum, j_sum)
    assert float(t_n) == float(j_n) == B * S - 5
    _close(th.grad, j_dh)
    _close(tw_.grad, j_dw)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_masked_cross_entropy_and_combine_losses(reduction):
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[1, 2:] = -100
    want = j_masked_ce(jnp.asarray(logits), jnp.asarray(labels), reduction=reduction)
    got = masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                               reduction=reduction)
    _close(got, want)
    j_total, _ = j_combine_losses(want, jnp.float32(16.0), jnp.float32(0.25))
    t_total, _ = combine_losses(got, torch.tensor(16.0), torch.tensor(0.25))
    _close(t_total, j_total)


OPT_CASES = {
    "adamw_cosine_warmup": (dict(name="adamw", lr=1e-2, weight_decay=0.1),
                            dict(style="cosine", warmup_steps=2, decay_steps=4,
                                 min_lr_ratio=0.1)),
    "adamw_linear": (dict(name="adamw", lr=1e-2, weight_decay=0.2),
                     dict(style="linear", decay_steps=4, min_lr_ratio=0.2)),
    "adamw_constant": (dict(name="adamw", lr=3e-3, weight_decay=0.1, eps=1e-6),
                       dict(style="constant")),
    "adamw_wsd": (dict(name="adamw", lr=1e-2, weight_decay=0.1),
                  dict(style="wsd", warmup_steps=1, stable_steps=2, decay_steps=3)),
    "adam": (dict(name="adam", lr=1e-2, weight_decay=0.1), dict(style="cosine",
                                                                 decay_steps=5)),
    "sgd": (dict(name="sgd", lr=5e-2, momentum=0.8), dict(style="constant")),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_and_schedules_match_optax(case):
    okw, skw = OPT_CASES[case]
    rng = np.random.default_rng(4)
    # the stacked layout: an (L, H) norm scale is decayed, a (H,) one is not
    tree = {"layers": {"norm": rng.normal(size=(2, 6)), "w": rng.normal(size=(2, 6, 5))},
            "final_norm": rng.normal(size=(6,))}
    tree = jax.tree.map(lambda x: x.astype(np.float32), tree)
    j_sched = JLRSchedulerConfig(**skw).build(okw["lr"])
    t_sched = LRSchedulerConfig(**skw).build(okw["lr"])
    tx = JOptimizerConfig(**okw).build(j_sched)
    opt = OptimizerConfig(**okw).build(t_sched)
    j_params = jax.tree.map(jnp.asarray, tree)
    j_state = tx.init(j_params)
    t_params = params_from_jax(tree, device="cpu")
    t_state = opt.init(t_params)
    for step in range(5):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), tree)
        updates, j_state = tx.update(jax.tree.map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.update(params_from_jax(g, device="cpu"), t_state, t_params)
        assert t_sched(step) == pytest.approx(float(j_sched(step)), rel=1e-6, abs=1e-9)
        for got, want in zip(jax.tree.leaves(t_params), jax.tree.leaves(j_params)):
            _close(got, want, atol=1e-6, rtol=1e-5)


def _loss_fns(jcfg, tcfg, chunk=16):
    def j_loss(params, mb, rng):
        h = j_decoder.forward(params, jcfg, mb["input_ids"], return_hidden=True,
                              segment_ids=mb["segment_ids"], positions=mb["positions"])
        return j_flce(h, j_decoder.head_kernel(params, jcfg), mb["labels"],
                      chunk_size=chunk)

    def t_loss(params, mb, rng):
        h = decoder.forward(params, tcfg, mb["input_ids"], return_hidden=True,
                            segment_ids=mb["segment_ids"], positions=mb["positions"])
        return fused_linear_cross_entropy(h, decoder.head_kernel(params, tcfg),
                                          mb["labels"], chunk_size=chunk)

    return j_loss, t_loss


def test_train_step_accumulation_and_clipping():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=5)
    okw = dict(name="adamw", lr=5e-3, weight_decay=0.1)
    skw = dict(style="cosine", warmup_steps=1, decay_steps=6)
    j_sched = JLRSchedulerConfig(**skw).build(okw["lr"])
    t_sched = LRSchedulerConfig(**skw).build(okw["lr"])
    tx = JOptimizerConfig(**okw).build(j_sched)
    opt = OptimizerConfig(**okw).build(t_sched)
    j_loss, t_loss = _loss_fns(jcfg, tcfg)
    # a norm bound well under the gradients' norm: clipping engages
    j_step = jax.jit(j_make_train_step(j_loss, tx, j_sched, JTrainStepConfig(max_grad_norm=0.3)))
    t_step = make_train_step(t_loss, opt, t_sched, TrainStepConfig(max_grad_norm=0.3))
    j_state = j_init_train_state(jp, tx)
    t_state = init_train_state(tp, opt)
    for step in range(5):
        ids, seg, pos = _packed_batch(6, 12, CFG["vocab_size"], 10 + step)
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = -100
        batch = {"input_ids": ids, "labels": labels, "segment_ids": seg, "positions": pos}
        batch = {k: v.reshape(3, 2, 12) for k, v in batch.items()}  # accum 3
        j_state, jm = j_step(j_state, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
        t_state, tm = t_step(t_state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(jm["grad_norm"]) > 0.3
        for key in ("loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-4)
        assert float(tm["num_label_tokens"]) == float(jm["num_label_tokens"])
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6, abs=1e-12)
    assert t_state.step == 5


def _recipe_node(node, tmp_path, name):
    node.set("checkpoint.enabled", False)
    node.set("run_dir", str(tmp_path / name))
    return node


def _losses(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


def test_recipe_loss_curve_matches_live_jax_run(tmp_path):
    """docs/PARITY.md protocol: the port's recipe from the JAX recipe's
    initial weights, on the same YAML and mock batches."""
    j_node = _recipe_node(JConfigNode(load_yaml(TINY_YAML).to_dict()), tmp_path, "jax")
    j_recipe = JRecipe(j_node)
    j_recipe.setup()
    init = _np_tree(j_recipe.train_state.params)
    j_recipe.run_train_validation_loop()

    t_recipe = TrainFinetuneRecipeForNextTokenPrediction(
        _recipe_node(load_yaml(TINY_YAML), tmp_path, "port"), device="cpu")
    t_recipe.setup()
    t_recipe.train_state = init_train_state(params_from_jax(init, device="cpu"),
                                            t_recipe.tx)
    t_recipe.run_train_validation_loop()

    want = _losses(tmp_path / "jax" / "training.jsonl")
    got = _losses(tmp_path / "port" / "training.jsonl")
    assert len(want) == len(got) == 10
    rel = np.abs(np.array(got) - np.array(want)) / np.abs(want)
    assert rel[:5].max() <= 1e-4, rel
    assert rel.max() <= 5e-3, rel
    with open(tmp_path / "port" / "training.jsonl") as f:
        rec = json.loads(f.readline())
    for key in ("step", "epoch", "loss", "grad_norm", "lr", "num_label_tokens",
                "tps", "tps_per_device", "tflops_per_device", "mfu_pct"):
        assert key in rec


def test_recipe_and_cli_refuse_what_is_not_ported(tmp_path):
    node = load_yaml(TINY_YAML)  # checkpoint.enabled: true, to a remote URI
    node.set("run_dir", str(tmp_path / "remote"))
    node.set("checkpoint.checkpoint_dir", "gs://bucket/tiny")
    with pytest.raises(NotImplementedError, match="remote URI"):
        TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu").setup()
    node = _recipe_node(load_yaml(TINY_YAML), tmp_path, "x")
    node.set("distributed.cp", 2)
    with pytest.raises(NotImplementedError, match="distributed.cp=2.*12b"):
        TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu").setup()
    # one process (no launcher) cannot hold tp: 2 (4 gloo ranks run it in
    # tests/test_torch_mesh.py)
    node = _recipe_node(load_yaml(TINY_YAML), tmp_path, "x2")
    node.set("distributed.tp", 2)
    with pytest.raises(ValueError, match=r"1 devices not divisible by pp\*dp_replicate\*ep\*cp\*tp=2"):
        TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu").setup()
    node = _recipe_node(load_yaml(TINY_YAML), tmp_path, "y")
    node.set("model.hf_config.architectures", ["Qwen3NextForCausalLM"])
    with pytest.raises(NotImplementedError, match="Qwen3NextForCausalLM"):
        TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu").setup()
    with pytest.raises(NotImplementedError, match="llm_kd"):
        app.resolve_recipe_class(ConfigNode({"recipe": "llm_kd"}))
    assert (app.resolve_recipe_class(ConfigNode({"recipe": "llm_pretrain"}))
            is TrainFinetuneRecipeForNextTokenPrediction)
    # JAX-package targets map to the port; a missing counterpart names itself
    from automodel_tpu_torch.datasets.mock import MockDatasetConfig

    assert _resolve_target("automodel_tpu.datasets.mock.MockDatasetConfig") is MockDatasetConfig
    with pytest.raises(ImportError, match="automodel_tpu.datasets.vlm.VLMConfig"):
        _resolve_target("automodel_tpu.datasets.vlm.VLMConfig")
    with pytest.raises(ImportError, match="JAX"):
        _resolve_target("optax.adamw")


def test_unembed_bf16_has_fp32_result():
    """JAX multiplies bf16 operands with an fp32 result; the port used to
    round the product to bf16 and widen it after, which is off by up to a
    bf16 ulp of the logits (~0.06 here)."""
    cfg_kw = dict(vocab_size=200, hidden_size=256, intermediate_size=64,
                  num_layers=1, num_heads=4, num_kv_heads=2)
    jcfg = j_decoder.TransformerConfig(**cfg_kw, dtype=jnp.bfloat16)
    tcfg = decoder.TransformerConfig(**cfg_kw, dtype=torch.bfloat16)
    rng = np.random.default_rng(6)
    h = rng.normal(size=(2, 5, 256)).astype(np.float32)
    w = rng.normal(size=(256, 200)).astype(np.float32)
    want = j_decoder.unembed({"lm_head": {"kernel": jnp.asarray(w, jnp.bfloat16)}},
                             jcfg, jnp.asarray(h, jnp.bfloat16))
    got = decoder.unembed({"lm_head": {"kernel": torch.from_numpy(w).bfloat16()}},
                          tcfg, torch.from_numpy(h).bfloat16())
    assert got.dtype == torch.float32
    assert np.abs(np.asarray(want)).max() > 16  # where a bf16 ulp is 0.125
    _close(got, want, atol=1e-4, rtol=1e-6)
