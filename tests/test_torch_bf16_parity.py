"""bf16 parity of the port's serving engines with the JAX engine, on the
CPU, on the two pools whose bf16 kernels take the split-KV tensor-core
routes on the card: the tiny dense Llama on the int8 pool (K5) and the tiny
DeepSeek-style MLA + MoE decoder on the fp pool (K6).

The same numpy weights go to three engines: the JAX engine in bf16, the
same JAX engine in fp32, and the port's engine in bf16 (both packages cast
the fp32 weights to the config's dtype). Their schedulers take the same
stream and, every step, the fp32 engine's greedy tokens, so all three run
the same StepPlans (checked) and no near tie in bf16 can part them.

Tolerance. Per step, the gap of the port's bf16 logits to the JAX bf16
logits (max absolute difference over the step's rows) is held to the JAX
bf16 engine's own gap to its fp32 run: no more than it at the median step,
and no more than twice it at any step. The two frameworks round bf16 at
other places op by op (`F.silu` rounds once where `jax.nn.silu` rounds the
sigmoid and the product; XLA and PyTorch sum products in other orders), so
single steps of a faultless port land at 0.3-1.5x the JAX gap (0.7x at the
median over 4 models x 3 seeds, this test's streams). A fault of the kind
the bf16 `unembed` rounding was (0.122 against a ~0.03 gap) lands far
above 2x.

The training step is held the same way: one forward and backward of the
recipe's loss (CE sum + aux loss x label tokens, over label tokens) from
the same fp32 masters and batch, in JAX bf16, JAX fp32 and the port's bf16
(attention through `flash_attention`, whose passes on the CPU are the plain
versions of K1-K3). The quantities are the step's logits and every
gradient leaf (largest absolute difference each); the median ratio must
be <= 1 and every ratio <= 2. The scalar loss is left out: it is a mean
whose rounding errors cancel, so JAX's own bf16 gap on it comes near 0 on
some batches (ratios of 3-4 on faultless runs). The DeepSeek model routes
with the balanced gate: top-k selection is discontinuous, and bf16 rounding
placement can move a near-tie token-slot to another expert (seen: 2 slots
of 92 in one layer), a difference of routing and not of arithmetic; the
routed experts, shared experts, MLA and the aux-loss path run as usual.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mla_moe import _plan_fields, _prompts, deepseek_configs, engine_params
from test_torch_quant_serving import LLAMA

from automodel_tpu.loss import fused_linear_cross_entropy as j_flce
from automodel_tpu.loss.utils import combine_losses as j_combine_losses
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.models.moe_lm import decoder as j_moe_decoder
from automodel_tpu.serving import Request as JRequest
from automodel_tpu.serving import ServingConfig as JServingConfig
from automodel_tpu.serving import ServingEngine as JServingEngine
from automodel_tpu.serving import engine as j_engine
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.loss import fused_linear_cross_entropy
from automodel_tpu_torch.loss.utils import combine_losses
from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.models.llm.decoder import TransformerConfig
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine
from automodel_tpu_torch.utils.tree import tree_leaves


def _llama_cfgs(jdt, tdt):
    return (j_decoder.TransformerConfig(**LLAMA, dtype=jdt, remat_policy="none"),
            TransformerConfig(**LLAMA, dtype=tdt))


def _deepseek_cfgs(jdt, tdt):
    j_cfg, t_cfg = deepseek_configs()
    return (j_cfg.__class__(**{**vars(j_cfg), "dtype": jdt}),
            t_cfg.__class__(**{**vars(t_cfg), "dtype": tdt}))


# (configs, serving config, prompts, arrivals, max_new): the streams of
# tests/test_torch_quant_serving.py (llama) and tests/test_torch_mla_moe.py
# (deepseek)
CASES = {
    "llama_int8_pool": (_llama_cfgs, dict(page_size=4, num_pages=24, max_slots=3,
                                          pages_per_slot=6, token_budget=8,
                                          prefill_chunk=4, kv_cache_dtype="int8"),
                        _prompts([5, 9, 3]), [0, 0, 2], 5),
    "deepseek_fp_pool": (_deepseek_cfgs, dict(page_size=4, num_pages=16,
                                              max_slots=2, pages_per_slot=4,
                                              token_budget=6, prefill_chunk=3),
                         _prompts([5, 7], seed0=40), [0, 1], 4),
}


def bf16_gaps(cfgs, sc, prompts, arrivals, max_new, monkeypatch):
    """Per step: (port bf16 vs JAX bf16, JAX bf16 vs JAX fp32), the largest
    absolute logit differences over the step's rows."""
    import jax.numpy as jnp

    j16, t16 = cfgs(jnp.bfloat16, torch.bfloat16)
    j32, _ = cfgs(jnp.float32, torch.float32)
    params = engine_params(j32)
    engines = {
        "jax_bf16": JServingEngine(params, j16, JServingConfig(**sc)),
        "jax_fp32": JServingEngine(params, j32, JServingConfig(**sc)),
    }
    port = ServingEngine(params_from_jax(jax.tree.map(np.asarray, params),
                                         device="cpu"),
                         t16, ServingConfig(**sc), device="cpu")
    scheds = {k: e.make_scheduler() for k, e in engines.items()}
    scheds["port"] = port.make_scheduler()
    for k, s in scheds.items():
        cls = Request if k == "port" else JRequest
        for p, a in zip(prompts, arrivals):
            s.submit(cls(prompt=list(p), max_new_tokens=max_new, arrival=a))
    seen = []
    real_unembed = j_engine.unembed

    def spy(params, cfg, h):
        # the jitted steps call this while tracing; the callback hands each
        # run's concrete logits back
        logits = real_unembed(params, cfg, h)
        jax.debug.callback(lambda x: seen.append(np.asarray(x, np.float32)),
                           logits[0])
        return logits

    monkeypatch.setattr(j_engine, "unembed", spy)
    gaps, step = [], 0
    while scheds["jax_fp32"].has_work:
        plans = {k: s.schedule(step) for k, s in scheds.items()}
        if plans["jax_fp32"] is None:
            assert all(p is None for p in plans.values())
            step += 1
            continue
        want = _plan_fields(plans["jax_fp32"])
        for k in ("jax_bf16", "port"):
            for name, value in _plan_fields(plans[k]).items():
                np.testing.assert_array_equal(value, want[name],
                                              err_msg=f"{k} {name}")
        logits = {}
        for k, e in engines.items():
            e.pool, _, _ = e._step(e.params, e.pool, e._plan_batch(plans[k]))
            jax.effects_barrier()
            logits[k] = seen[-1]
        logits["port"] = port.step_logits(plans["port"]).float().numpy()
        tokens = logits["jax_fp32"].argmax(-1).astype(np.int32)
        for k, s in scheds.items():
            s.update(plans[k], tokens, step)
        gaps.append((np.abs(logits["port"] - logits["jax_bf16"]).max(),
                     np.abs(logits["jax_bf16"] - logits["jax_fp32"]).max()))
        step += 1
    assert len(gaps) > 3 and not any(s.has_work for s in scheds.values())
    return np.array(gaps).T


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_engine_gap_to_jax_within_jax_own_bf16_gap(case, monkeypatch):
    port_gap, jax_gap = bf16_gaps(*CASES[case], monkeypatch)
    assert (jax_gap > 0).all()  # the bf16 engine does round
    ratio = port_gap / jax_gap
    assert np.median(ratio) <= 1.0, ratio
    assert (ratio <= 2.0).all(), ratio


# -- one training step ---------------------------------------------------------
def _train_models():
    """(JAX fp32 config, JAX module, port module, port fp32 config): the
    tiny dense Llama and a tiny DeepSeek-V3 (1 dense + 2 MoE layers, MLA
    with a q rank, the aux loss on, the balanced gate)."""
    j_llama, t_llama = _llama_cfgs(jnp.float32, torch.float32)
    j_ds, t_ds = deepseek_configs(num_layers=3, aux_loss_coeff=0.01,
                                  fake_balanced_gate=True)
    return {"llama": (j_llama, j_decoder, decoder, t_llama),
            "deepseek": (j_ds, j_moe_decoder, moe_decoder, t_ds)}


def _step_batch(seed, B=2, S=24, vocab=64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    return ids, labels


def _jax_step(cfg, module, params, ids, labels):
    """[logits, *gradient leaves] of one step of the recipe's loss."""
    moe = isinstance(cfg, j_moe_decoder.MoETransformerConfig)

    def loss(p):
        aux = None
        if moe:
            h, aux, _ = module.forward(p, cfg, jnp.asarray(ids), return_hidden=True,
                                       return_stats=True,
                                       token_mask=jnp.asarray(labels != -100))
        else:
            h = module.forward(p, cfg, jnp.asarray(ids), return_hidden=True)
        ce, n = j_flce(h, j_decoder.head_kernel(p, cfg), jnp.asarray(labels),
                       chunk_size=16)
        total, n = j_combine_losses(ce, n, aux)
        return total / n, module.unembed(p, cfg, h)

    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return [np.asarray(x, np.float32) for x in (logits, *jax.tree.leaves(grads))]


def _port_step(cfg, module, np_params, ids, labels):
    moe = isinstance(cfg, moe_decoder.MoETransformerConfig)
    params = params_from_jax(np_params, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    ids_t, labels_t = torch.from_numpy(ids), torch.from_numpy(labels)
    aux = None
    if moe:
        h, aux, _ = module.forward(params, cfg, ids_t, return_hidden=True,
                                   return_stats=True, token_mask=labels_t != -100)
    else:
        h = module.forward(params, cfg, ids_t, return_hidden=True)
    ce, n = fused_linear_cross_entropy(h, module.head_kernel(params, cfg), labels_t,
                                       chunk_size=16)
    total, n = combine_losses(ce, n, aux)
    (total / n).backward()
    logits = module.unembed(params, cfg, h).detach()
    return [logits.float().numpy()] + [
        np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        for p in leaves]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("model", ["llama", "deepseek"])
def test_bf16_train_step_gap_to_jax_within_jax_own_bf16_gap(model, seed):
    j32, j_mod, t_mod, t32 = _train_models()[model]
    j16 = dataclasses.replace(j32, dtype=jnp.bfloat16)
    t16 = dataclasses.replace(t32, dtype=torch.bfloat16, remat_policy="full",
                              attn_impl="flash")
    params = engine_params(j32, seed)
    ids, labels = _step_batch(seed + 10)
    want32 = _jax_step(j32, j_mod, params, ids, labels)
    want16 = _jax_step(j16, j_mod, params, ids, labels)
    got16 = _port_step(t16, t_mod, jax.tree.map(np.asarray, params), ids, labels)
    assert len(got16) == len(want16) == len(want32)
    ratios = []
    for got, w16, w32 in zip(got16, want16, want32):
        jax_gap = np.abs(w16 - w32).max()
        if jax_gap == 0:  # a leaf no gradient reaches (the correction bias)
            assert np.abs(got - w16).max() == 0
            continue
        ratios.append(np.abs(got - w16).max() / jax_gap)
    ratios = np.array(ratios)
    assert np.median(ratios) <= 1.0, ratios
    assert (ratios <= 2.0).all(), ratios
