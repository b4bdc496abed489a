"""Port parity of MLA + MoE training (DeepSeek-V3 / Moonlight-style) on the
CPU: the same numpy weights and batches go through the JAX package and
`automodel_tpu_torch`, in fp32 unless a test says otherwise.

- `mla_attention_block` (q-lora, direct q, the mistral4 rope-slice scaling)
  with packed segments: output and every gradient within 1e-5 of JAX's
  (only the order of operations differs), through the plain attention and
  through `flash_attention`, whose passes on CPU tensors are the plain
  versions of K1-K3 at q/k 24 and v 8;
- the MoE decoder's `forward` (one dense and two MoE layers, grouped
  sigmoid routing with the correction bias, the aux loss on, pad tokens
  masked): logits within 1e-5, the aux loss within 1e-6, tokens per expert
  equal; under "full" and "none" remat;
- the gradients of the recipe's loss (CE sum + aux x label tokens) against
  `jax.grad`: every leaf within 1e-5 of its largest magnitude; the
  correction bias gets none, as JAX's stop_gradient gives it none;
- `make_train_step` with 2 accumulated microbatches: loss and grad norm
  within 1e-5 relative of JAX's step over 3 steps, the summed tokens per
  expert equal;
- `apply_gate_bias_update` equal to JAX's; AdamW decays the stacked
  `(Lm, E)` correction bias as optax does (the JAX decay mask, ndim >= 2);
- `params_from_jax` carries every key of the training tree;
- `flops_per_token` of the MoE config equal to JAX's (the MFU numerator);
- the `examples/llm_finetune/deepseek_v3_smoke.yaml` recipe against a live
  JAX run from the same weights (docs/PARITY.md: 1e-4 relative for steps
  1-5), with the gate-bias update on: final correction bias within 1e-6;
- the bf16 dropless MoE backward runs `torch._grouped_mm`'s own autograd,
  reads nothing to the host, takes an expanded cotangent, and keeps what
  the grouped product leaves past its last group out of every gradient;
- what is not ported raises NotImplementedError naming itself.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_mla_moe import _OpLog, _expert_inputs

from automodel_tpu.config import ConfigNode as JConfigNode
from automodel_tpu.loss import fused_linear_cross_entropy as j_flce
from automodel_tpu.loss.utils import combine_losses as j_combine_losses
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.models.llm import mla as j_mla
from automodel_tpu.models.moe_lm import decoder as j_moe
from automodel_tpu.models.moe_lm.families import (
    deepseek_v3_moe_config as j_deepseek_v3_moe_config,
)
from automodel_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu_torch.config import load_yaml
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.distributed import MeshConfig, MeshContext
from automodel_tpu_torch.loss import fused_linear_cross_entropy
from automodel_tpu_torch.loss.utils import combine_losses
from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.models.llm.mla import mla_attention_block
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.moe_lm.families import deepseek_v3_moe_config
from automodel_tpu_torch.moe.experts import experts_forward_dropless
from automodel_tpu_torch.ops.rope import rope_frequencies
from automodel_tpu_torch.optim import OptimizerConfig
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.training import init_train_state
from automodel_tpu_torch.utils.tree import tree_leaves

ATOL = 1e-5
SMOKE_YAML = "examples/llm_finetune/deepseek_v3_smoke.yaml"

# a tiny DeepSeek-V3: 1 dense + 2 MoE layers, MLA with a q rank, grouped
# sigmoid routing with the correction bias, a shared expert, the aux loss on
HF = dict(
    architectures=["DeepseekV3ForCausalLM"], vocab_size=64, hidden_size=32,
    intermediate_size=48, num_hidden_layers=3, num_attention_heads=4,
    n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
    moe_intermediate_size=16, first_k_dense_replace=1, kv_lora_rank=16,
    q_lora_rank=12, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=8,
    n_group=2, topk_group=1, aux_loss_alpha=0.01, routed_scaling_factor=1.5,
)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
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
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    labels[rng.random((B, S)) < 0.15] = -100  # pad labels: masked tokens
    return ids, seg, pos, labels


def _configs(hf=HF, remat="none", attn_impl="auto", dtype="float32"):
    j = j_deepseek_v3_moe_config(hf, dtype=getattr(jnp, dtype),
                                 remat_policy="none", attn_impl="xla")
    t = deepseek_v3_moe_config(hf, dtype=getattr(torch, dtype),
                               remat_policy=remat, attn_impl=attn_impl)
    return j, t


def _moe_params(jcfg, seed=0):
    """JAX init with a random correction bias; (jax tree, numpy tree)."""
    jp = j_moe.init(jcfg, jax.random.key(seed))
    gate = jp["moe_layers"]["moe"]["gate"]
    rng = np.random.default_rng(seed + 100)
    gate["e_score_bias"] = jnp.asarray(
        rng.normal(0, 0.05, gate["e_score_bias"].shape).astype(np.float32))
    return jp, _np_tree(jp)


# -- the MLA block ------------------------------------------------------------
MLA_VARIANTS = {
    "q_lora": dict(mla_q_lora_rank=12),
    "direct_q": dict(mla_q_lora_rank=None),
    "qpe_scaling": dict(mla_q_lora_rank=None, mla_qpe_scaling_beta=0.3,
                        mla_qpe_scaling_orig_max=4),
}


@pytest.mark.parametrize("impl", ["torch", "flash"])
@pytest.mark.parametrize("variant", sorted(MLA_VARIANTS))
def test_mla_attention_block_matches_jax(variant, impl):
    kw = dict(vocab_size=32, hidden_size=32, intermediate_size=48, num_layers=1,
              num_heads=4, num_kv_heads=4, attention_type="mla",
              mla_kv_lora_rank=16, mla_qk_nope_head_dim=16,
              mla_qk_rope_head_dim=8, mla_v_head_dim=8, **MLA_VARIANTS[variant])
    jcfg = j_decoder.TransformerConfig(**kw, dtype=jnp.float32, attn_impl="xla")
    tcfg = decoder.TransformerConfig(**kw, dtype=torch.float32, attn_impl=impl)
    lp = jax.tree.map(lambda a: a[0], j_mla.init_mla_layers(jcfg, jax.random.key(3), 1))
    rng = np.random.default_rng(4)
    for name in ("input_norm", "kv_norm"):  # non-trivial norm scales
        lp[name]["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, lp[name]["scale"].shape)
                                        .astype(np.float32))
    h = rng.normal(size=(2, 24, 32)).astype(np.float32)
    _, seg, pos, _ = _packed_batch(2, 24, 32, 5)
    ct = rng.normal(size=h.shape).astype(np.float32)
    j_inv = j_rope_frequencies(jcfg.rope_dim, jcfg.rope_theta, jcfg.rope_scaling)

    def j_fn(h, lp):
        return j_mla.mla_attention_block(h, lp, jcfg, jnp.asarray(pos),
                                         jnp.asarray(seg), j_inv, lambda x, a: x, None)

    want, vjp = jax.vjp(j_fn, jnp.asarray(h), lp)
    j_dh, j_dlp = vjp(jnp.asarray(ct))

    t_h = torch.from_numpy(h).requires_grad_()
    t_lp = params_from_jax(_np_tree(lp), device="cpu")
    leaves = tree_leaves(t_lp)
    for p in leaves:
        p.requires_grad_()
    t_inv = rope_frequencies(tcfg.rope_dim, tcfg.rope_theta, tcfg.rope_scaling)
    got = mla_attention_block(t_h, t_lp, tcfg, torch.from_numpy(pos),
                              torch.from_numpy(seg), t_inv, None)
    # post_attn_norm belongs to the MLP half: no gradient on either side
    grads = torch.autograd.grad(got, [t_h, *leaves], torch.from_numpy(ct),
                                allow_unused=True, materialize_grads=True)
    _close(got, want)
    _close(grads[0], j_dh)
    for g, w in zip(grads[1:], jax.tree.leaves(j_dlp)):
        _close(g, w)


# -- the MoE decoder forward --------------------------------------------------
@pytest.mark.parametrize("remat", ["none", "full"])
def test_moe_forward_matches_jax(remat):
    """Logits, the aux loss and the (Lm, E) tokens per expert, with pad
    tokens masked out of routing and packed segments."""
    jcfg, tcfg = _configs(remat=remat)
    jp, np_params = _moe_params(jcfg)
    tp = params_from_jax(np_params, device="cpu")
    ids, seg, pos, labels = _packed_batch(2, 16, HF["vocab_size"], 1)
    mask = labels != -100
    jkw = dict(segment_ids=jnp.asarray(seg), positions=jnp.asarray(pos),
               token_mask=jnp.asarray(mask))
    tkw = dict(segment_ids=torch.from_numpy(seg), positions=torch.from_numpy(pos),
               token_mask=torch.from_numpy(mask))
    j_logits, j_aux, j_stats = j_moe.forward(jp, jcfg, jnp.asarray(ids),
                                             return_stats=True, **jkw)
    t_logits, t_aux, t_stats = moe_decoder.forward(tp, tcfg, torch.from_numpy(ids),
                                                   return_stats=True, **tkw)
    _close(t_logits, j_logits)
    assert float(j_aux) > 0
    np.testing.assert_allclose(float(t_aux), float(j_aux), atol=1e-6, rtol=1e-6)
    tpe = t_stats["tokens_per_expert"]
    assert tpe.shape == (tcfg.num_moe_layers, HF["n_routed_experts"])
    np.testing.assert_array_equal(tpe.numpy(), np.asarray(j_stats["tokens_per_expert"]))
    # every unmasked token took K slots in every MoE layer
    assert (tpe.sum(-1) == mask.sum() * HF["num_experts_per_tok"]).all()
    j_hidden, _ = j_moe.forward(jp, jcfg, jnp.asarray(ids), return_hidden=True, **jkw)
    t_hidden, _ = moe_decoder.forward(tp, tcfg, torch.from_numpy(ids),
                                      return_hidden=True, **tkw)
    _close(t_hidden, j_hidden)


def _j_loss(jcfg, ids, seg, pos, labels):
    def loss(params):
        h, aux, _ = j_moe.forward(params, jcfg, jnp.asarray(ids), return_hidden=True,
                                  return_stats=True, segment_ids=jnp.asarray(seg),
                                  positions=jnp.asarray(pos),
                                  token_mask=jnp.asarray(labels != -100))
        ce, n = j_flce(h, j_decoder.head_kernel(params, jcfg), jnp.asarray(labels),
                       chunk_size=16)
        total, n = j_combine_losses(ce, n, aux)
        return total / n
    return loss


def _t_loss(tparams, tcfg, ids, seg, pos, labels):
    h, aux, _ = moe_decoder.forward(
        tparams, tcfg, torch.from_numpy(ids), return_hidden=True,
        return_stats=True, segment_ids=torch.from_numpy(seg),
        positions=torch.from_numpy(pos), token_mask=torch.from_numpy(labels != -100))
    ce, n = fused_linear_cross_entropy(h, moe_decoder.head_kernel(tparams, tcfg),
                                       torch.from_numpy(labels), chunk_size=16)
    total, n = combine_losses(ce, n, aux)
    return total / n


@pytest.mark.parametrize("remat", ["none", "full"])
def test_moe_loss_gradients_match_jax(remat):
    """The recipe's loss (CE sum + aux x label tokens, over label tokens):
    every gradient leaf within 1e-5 of its largest magnitude; no gradient
    reaches the correction bias."""
    jcfg, tcfg = _configs(remat=remat)
    jp, np_params = _moe_params(jcfg, seed=2)
    ids, seg, pos, labels = _packed_batch(2, 16, HF["vocab_size"], 3)
    j_val, j_grads = jax.value_and_grad(_j_loss(jcfg, ids, seg, pos, labels))(jp)
    tp = params_from_jax(np_params, device="cpu")
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_()
    t_val = _t_loss(tp, tcfg, ids, seg, pos, labels)
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=1e-6)
    j_leaves = jax.tree.leaves(j_grads)
    assert len(j_leaves) == len(leaves)
    bias = tp["moe_layers"]["moe"]["gate"]["e_score_bias"]
    assert bias.grad is None  # selection only
    for p, w in zip(leaves, j_leaves):
        w = np.asarray(w)
        g = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g.numpy() - w).max() <= ATOL * max(scale, 1.0), p.shape
    gate_w = tp["moe_layers"]["moe"]["gate"]["weight"].grad
    assert gate_w is not None and gate_w.abs().max() > 0  # the router learns


def test_train_step_sums_moe_stats_over_microbatches():
    """`make_train_step` with 2 accumulated microbatches, AdamW and
    clipping, 3 steps: loss and grad norm within 1e-5 relative of JAX's
    step (steps 2-3 read the updated masters), the summed (Lm, E) tokens
    per expert equal."""
    from automodel_tpu.optim import OptimizerConfig as JOptimizerConfig
    from automodel_tpu.training import init_train_state as j_init_train_state
    from automodel_tpu.training import make_train_step as j_make_train_step
    from automodel_tpu.training.train_step import TrainStepConfig as JTrainStepConfig
    from automodel_tpu_torch.training import TrainStepConfig, make_train_step

    jcfg, tcfg = _configs(remat="full")
    jp, np_params = _moe_params(jcfg, seed=7)

    def j_loss(params, mb, rng):
        h, aux, st = j_moe.forward(params, jcfg, mb["input_ids"], return_hidden=True,
                                   return_stats=True, token_mask=mb["labels"] != -100)
        ce, n = j_flce(h, j_decoder.head_kernel(params, jcfg), mb["labels"],
                       chunk_size=16)
        total, n = j_combine_losses(ce, n, aux)
        return total, {"num_label_tokens": n,
                       "tokens_per_expert": st["tokens_per_expert"]}

    def t_loss(params, mb, rng):
        h, aux, st = moe_decoder.forward(params, tcfg, mb["input_ids"],
                                         return_hidden=True, return_stats=True,
                                         token_mask=mb["labels"] != -100)
        ce, n = fused_linear_cross_entropy(h, moe_decoder.head_kernel(params, tcfg),
                                           mb["labels"], chunk_size=16)
        total, n = combine_losses(ce, n, aux)
        return total, {"num_label_tokens": n,
                       "tokens_per_expert": st["tokens_per_expert"]}

    okw = dict(name="adamw", lr=5e-3, weight_decay=0.1)
    tx = JOptimizerConfig(**okw).build()
    j_step = jax.jit(j_make_train_step(j_loss, tx, None, JTrainStepConfig(max_grad_norm=0.5)))
    j_state = j_init_train_state(jp, tx)
    opt = OptimizerConfig(**okw).build()
    t_step = make_train_step(t_loss, opt, None, TrainStepConfig(max_grad_norm=0.5))
    t_state = init_train_state(params_from_jax(np_params, device="cpu"), opt)
    for step in range(3):
        ids, _, _, labels = _packed_batch(4, 16, HF["vocab_size"], 20 + step)
        batch = {"input_ids": ids.reshape(2, 2, 16), "labels": labels.reshape(2, 2, 16)}
        j_state, jm = j_step(j_state, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
        t_state, tm = t_step(t_state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5)
        np.testing.assert_array_equal(tm["tokens_per_expert"].numpy(),
                                      np.asarray(jm["tokens_per_expert"]))
        # both microbatches' unmasked tokens, K slots each, per MoE layer
        assert (tm["tokens_per_expert"].sum(-1)
                == (labels != -100).sum() * HF["num_experts_per_tok"]).all()


# -- bias update, optimizer, conversion, FLOPs -------------------------------
def test_apply_gate_bias_update_matches_jax():
    jcfg, tcfg = _configs()
    jp, np_params = _moe_params(jcfg, seed=4)
    rng = np.random.default_rng(5)
    tpe = rng.integers(0, 6, (tcfg.num_moe_layers, HF["n_routed_experts"]))
    tpe[0] = 3  # a layer at its mean everywhere: sign(0) moves nothing
    tpe = tpe.astype(np.float32)
    want = j_moe.apply_gate_bias_update(jp, jcfg, jnp.asarray(tpe))
    tp = params_from_jax(np_params, device="cpu")
    bias = tp["moe_layers"]["moe"]["gate"]["e_score_bias"]
    got = moe_decoder.apply_gate_bias_update(tp, tcfg, torch.from_numpy(tpe))
    assert got["moe_layers"]["moe"]["gate"]["e_score_bias"] is bias  # in place
    np.testing.assert_array_equal(
        bias.numpy(), np.asarray(want["moe_layers"]["moe"]["gate"]["e_score_bias"]))
    assert tcfg.moe.gate_bias_update_speed == 0.001  # the DeepSeek default


def test_adamw_decays_the_stacked_correction_bias_as_optax():
    """The JAX decay mask (ndim >= 2) decays the (Lm, E) correction bias,
    whose gradient is 0: AdamW moves it by -lr * wd * p alone."""
    rng = np.random.default_rng(6)
    params = {"e_score_bias": rng.normal(0, 0.1, (2, 8)).astype(np.float32),
              "scale": rng.normal(size=(8,)).astype(np.float32)}
    grads = {"e_score_bias": np.zeros((2, 8), np.float32),
             "scale": rng.normal(size=(8,)).astype(np.float32)}
    tx = optax.adamw(1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                     mask=lambda p: jax.tree.map(lambda x: x.ndim >= 2, p))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = OptimizerConfig(name="adamw", lr=1e-2, weight_decay=0.1).build()
    ostate = opt.init(tp)
    for _ in range(3):
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, ostate, tp)
    for k in params:
        _close(tp[k], jp[k], atol=1e-7, rtol=1e-6)
    assert not np.allclose(tp["e_score_bias"].numpy(), params["e_score_bias"])


def test_params_from_jax_covers_the_training_tree():
    jcfg, tcfg = _configs()
    _, np_params = _moe_params(jcfg)
    tp = params_from_jax(np_params, device="cpu")
    own = moe_decoder.init(tcfg, torch.Generator().manual_seed(0))

    def by_path(tree, pre=()):
        if isinstance(tree, dict):
            return {p: x for k, v in tree.items() for p, x in by_path(v, pre + (k,)).items()}
        return {pre: tree}

    got, ref, mine = by_path(tp), by_path(np_params), by_path(own)
    assert got.keys() == ref.keys() == mine.keys()
    assert ("moe_layers", "moe", "gate", "e_score_bias") in got
    for path, a in got.items():
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), ref[path])
        assert a.shape == mine[path].shape, path


def test_moe_flops_per_token_matches_jax():
    """The MFU numerator: Moonlight-16B-A3B's config.json and the tiny one."""
    moonlight = dict(
        architectures=["DeepseekV3ForCausalLM"], vocab_size=163840,
        hidden_size=2048, intermediate_size=11264, moe_intermediate_size=1408,
        num_hidden_layers=27, num_attention_heads=16, num_key_value_heads=16,
        n_shared_experts=2, n_routed_experts=64, routed_scaling_factor=2.446,
        kv_lora_rank=512, q_lora_rank=None, qk_rope_head_dim=64, v_head_dim=128,
        qk_nope_head_dim=128, num_experts_per_tok=6, first_k_dense_replace=1)
    for hf in (HF, moonlight):
        jcfg, tcfg = _configs(hf)
        assert tcfg.flops_per_token(4096) == jcfg.flops_per_token(4096)


# -- the recipe ---------------------------------------------------------------
def _recipe_node(node, tmp_path, name, steps):
    node.set("checkpoint.enabled", False)
    node.set("run_dir", str(tmp_path / name))
    node.set("step_scheduler.max_steps", steps)
    node.set("step_scheduler.num_epochs", 2)  # 4 batches per epoch
    return node


def test_smoke_recipe_loss_curve_and_gate_bias_match_live_jax_run(tmp_path):
    """docs/PARITY.md protocol on the DeepSeek-V3 smoke YAML (5 steps, the
    gate-bias update on): the port's recipe from the JAX recipe's initial
    weights, on the same mock batches."""
    steps = 5
    j_node = _recipe_node(JConfigNode(load_yaml(SMOKE_YAML).to_dict()), tmp_path,
                          "jax", steps)
    j_recipe = JRecipe(j_node)
    j_recipe.setup()
    init = _np_tree(j_recipe.train_state.params)
    j_recipe.run_train_validation_loop()
    j_bias = np.asarray(j_recipe.train_state.params["moe_layers"]["moe"]["gate"]
                        ["e_score_bias"])

    t_recipe = TrainFinetuneRecipeForNextTokenPrediction(
        _recipe_node(load_yaml(SMOKE_YAML), tmp_path, "port", steps), device="cpu")
    t_recipe.setup()
    assert t_recipe.is_moe and t_recipe.model_cfg.moe.gate_bias_update_speed > 0
    t_recipe.train_state = init_train_state(params_from_jax(init, device="cpu"),
                                            t_recipe.tx)
    t_recipe.run_train_validation_loop()
    t_bias = t_recipe.train_state.params["moe_layers"]["moe"]["gate"]["e_score_bias"]

    def records(name):
        with open(tmp_path / name / "training.jsonl") as f:
            return [json.loads(line) for line in f]

    want, got = records("jax"), records("port")
    assert len(want) == len(got) == steps
    lw = np.array([r["loss"] for r in want])
    lg = np.array([r["loss"] for r in got])
    assert (np.abs(lg - lw) / np.abs(lw)).max() <= 1e-4, (lg, lw)
    for a, b in zip(got, want):
        assert a["moe_load_imbalance"] == pytest.approx(b["moe_load_imbalance"],
                                                        rel=1e-6)
    # the bias moved by the sign updates (and AdamW's decay), as in JAX
    assert np.abs(j_bias - init["moe_layers"]["moe"]["gate"]["e_score_bias"]).max() > 0
    _close(t_bias, j_bias, atol=1e-6, rtol=0)


# -- the dropless experts' backward -------------------------------------------
def test_experts_backward_bf16_grouped_mm_matches_fp32_and_reads_nothing():
    """bf16 runs `_grouped_mm`'s own backward, with no host read, from an
    expanded cotangent (`.sum()`); its gradients agree with the fp32
    every-expert route within bf16 rounding (3e-2 of the largest)."""
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        t_cfg, experts, x, w, idx = _expert_inputs(dtype)
        x.requires_grad_()
        w.requires_grad_()
        leaves = tree_leaves(experts)
        for p in leaves:
            p.requires_grad_()
        with _OpLog() as log:
            out = experts_forward_dropless(experts, t_cfg, x, w, idx)
            out.float().sum().backward()
        assert "aten._local_scalar_dense" not in log.ops
        if dtype == torch.bfloat16:
            assert log.ops.count("aten._grouped_mm") == 3 + 6  # fwd + (da, db) x 3
        grads[dtype] = [t.grad.float() for t in (x, w, *leaves)]
    for lo, hi in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert torch.isfinite(lo).all()
        assert (lo - hi).abs().max() <= 3e-2 * hi.abs().max()


def test_experts_backward_keeps_rows_past_the_last_group_out(monkeypatch):
    """Rows past the last group (the masked pairs') poisoned with NaN in the
    grouped products' outputs: every gradient stays finite and equal to the
    clean run's."""
    def run():
        t_cfg, experts, x, w, idx = _expert_inputs(torch.bfloat16)
        x.requires_grad_()
        w.requires_grad_()
        leaves = tree_leaves(experts)
        for p in leaves:
            p.requires_grad_()
        out = experts_forward_dropless(experts, t_cfg, x, w, idx)
        out.float().sum().backward()
        return [t.grad for t in (x, w, *leaves)]

    clean = run()
    grouped_mm = torch._grouped_mm

    def poisoned(a, b, offs):
        y = grouped_mm(a, b, offs=offs)
        return torch.cat([y[:int(offs[-1])],
                          torch.full_like(y[int(offs[-1]):], float("nan"))])

    monkeypatch.setattr(torch, "_grouped_mm", poisoned)
    for got, want in zip(run(), clean):
        assert torch.isfinite(got).all()
        assert torch.equal(got, want)


# -- refusals -------------------------------------------------------------------
def test_moe_training_refuses_what_is_not_ported(tmp_path):
    _, tcfg = _configs()
    params = moe_decoder.init(tcfg, torch.Generator().manual_seed(0))
    ids = torch.zeros((1, 4), dtype=torch.int64)
    for kw, name in ((dict(mesh_ctx=MeshContext(MeshConfig(cp=2, dp_shard=1))), "12b"),
                     (dict(return_aux_hidden=(0,)), "aux-hidden"),
                     (dict(inputs_embeds=torch.zeros(1)), "inputs_embeds"),
                     (dict(rope_angles=torch.zeros(1)), "rope_angles"),
                     (dict(deepstack_embeds=torch.zeros(1)), "deepstack")):
        with pytest.raises(NotImplementedError, match=name):
            moe_decoder.forward(params, tcfg, ids, **kw)
    # routing replay and DSA run (their parity: tests/test_torch_routing_replay.py,
    # tests/test_torch_dsa.py)
    _, _, stats = moe_decoder.forward(params, tcfg, ids, return_stats=True,
                                      return_routing=True)
    moe_decoder.forward(params, tcfg, ids, routing_override=stats["routing"])
    dsa = dataclasses.replace(tcfg, dsa_index_topk=2)
    moe_decoder.forward(moe_decoder.init(dsa, torch.Generator().manual_seed(0)), dsa, ids)
    # the capacity dispatcher and the MTP head run (their parity:
    # tests/test_torch_deepseek_v3.py); PEFT with the MTP head raises
    moe_decoder.forward(params, dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, dispatcher="capacity")), ids)
    assert "mtp" in moe_decoder.init(
        deepseek_v3_moe_config(dict(HF, num_nextn_predict_layers=1)), torch.Generator())
    node = _recipe_node(load_yaml(SMOKE_YAML), tmp_path, "mtp_peft", 1)
    node.set("model.hf_config.num_nextn_predict_layers", 1)
    node.set("model.hf_config.bias_update_speed", 0.0)
    node.set("peft", {"target_modules": ["q_proj"], "r": 2})
    with pytest.raises(NotImplementedError, match="MTP"):
        TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu").setup()
