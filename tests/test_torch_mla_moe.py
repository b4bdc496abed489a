"""Port parity of the MLA + MoE serving slice (fp32 on the CPU unless a test
says otherwise; the same numpy inputs and weights go to both packages).

- K6/K7's plain version `ragged_paged_mla_attention_ref` against the JAX
  XLA reference `ragged_paged_mla_attention_xla` and the Pallas kernels
  `paged_mla_attention_kernel` / `paged_mla_attention_quant_kernel`
  (interpret mode off the TPU): fp32 within atol 1e-5; bf16 within 2e-2 of
  the largest magnitude (the plain version and the XLA reference round
  probabilities and dequantized pages to bf16, the Pallas kernels keep
  fp32; 2e-2 is about two bf16 ulps at the largest value);
- `gate_forward`: equal indices, weights within 1e-6 (sigmoid with the
  correction bias and group-limited routing, softmax, the masked-token
  sentinel, routing replay); `moe_forward` and `mla_absorbed_inputs`
  within 1e-5;
- `experts_forward_dropless` reads nothing to the host (no
  `aten._local_scalar_dense`, which `.item()` and `.tolist()` dispatch to),
  runs bf16 as one `_grouped_mm` per projection, and masked pairs add
  exactly 0 even where the grouped product leaves NaN;
- the engine: an MLA decoder and a DeepSeek-V3-style MLA + MoE decoder
  (one dense and one MoE layer, `q_lora_rank` set) serve the same request
  streams as the JAX engine, in lockstep: equal StepPlans, sample-row
  logits within 1e-4, greedy tokens equal token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from automodel_tpu.inference import generate as j_generate
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.models.moe_lm import decoder as j_moe_decoder
from automodel_tpu.moe import config as j_moe_config
from automodel_tpu.moe import gate as j_gate
from automodel_tpu.moe import layer as j_layer
from automodel_tpu.ops.paged_attention import ragged_paged_mla_attention_xla
from automodel_tpu.ops.pallas.ragged_paged_attention import (
    paged_mla_attention_kernel,
    paged_mla_attention_quant_kernel,
)
from automodel_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from automodel_tpu.serving import Request as JRequest
from automodel_tpu.serving import ServingConfig as JServingConfig
from automodel_tpu.serving import ServingEngine as JServingEngine
from automodel_tpu.serving import engine as j_engine
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.distributed import MeshConfig, MeshContext
from automodel_tpu_torch.inference.generate import mla_absorbed_inputs
from automodel_tpu_torch.models.llm.decoder import TransformerConfig
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.moe_lm.families import deepseek_v3_moe_config
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.experts import experts_forward_dropless
from automodel_tpu_torch.moe.gate import gate_forward
from automodel_tpu_torch.moe.layer import moe_forward
from automodel_tpu_torch.ops.paged_attention import (
    ragged_paged_mla_attention,
    ragged_paged_mla_attention_ref,
)
from automodel_tpu_torch.ops.rope import rope_frequencies
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine

ATOL = 1e-5          # fp32 ops on both sides
BF16_REL = 2e-2      # bf16: of the largest magnitude
LOGITS_ATOL = 1e-4   # engine logits, fp32, 2 layers + unembed
GATE_ATOL = 1e-6     # routing weights: one fp32 sigmoid/softmax apart


# -- paged MLA attention (K6, K7) --------------------------------------------
def mla_batch(seed=0, n=4, r=32, dr=16, ps=4, P=5, N=16, quant=False):
    """A ragged batch as the engine builds it: 3 requests on permuted pages,
    trash-padded tables; decode rows, a row of one token (pos 0), rows on a
    page boundary (pos ps-1, ps) and 2 pad rows (pos -1)."""
    rng = np.random.default_rng(seed)
    perm = iter(rng.permutation(N))
    lens = [ps * P, 2 * ps + 1, 3]
    tables = []
    for L in lens:
        pages = [int(next(perm)) for _ in range(-(-L // ps))]
        tables.append(pages + [N] * (P - len(pages)))
    rows = [(0, lens[0] - 1), (1, lens[1] - 1), (2, 0), (2, 2), (0, ps - 1),
            (0, ps), (1, 4), (0, 11), (0, -1), (2, -1)]
    pt = np.asarray([tables[i] for i, _ in rows], np.int32)
    pos = np.asarray([p for _, p in rows], np.int32)
    T = len(rows)
    q_abs = rng.normal(size=(T, n, r)).astype(np.float32)
    q_rope = rng.normal(size=(T, n, dr)).astype(np.float32)
    if quant:
        c = rng.integers(-127, 128, (N + 1, ps, r)).astype(np.int8)
        kr = rng.integers(-127, 128, (N + 1, ps, dr)).astype(np.int8)
        cs = rng.uniform(0.002, 0.02, (N + 1, ps)).astype(np.float32)
        krs = rng.uniform(0.002, 0.02, (N + 1, ps)).astype(np.float32)
        return q_abs, q_rope, c, kr, pt, pos, cs, krs
    c = rng.normal(size=(N + 1, ps, r)).astype(np.float32)
    kr = rng.normal(size=(N + 1, ps, dr)).astype(np.float32)
    return q_abs, q_rope, c, kr, pt, pos


def _check_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())


def _jax_in(a, dtype):
    a = jnp.asarray(a)
    return a.astype(dtype) if a.dtype == jnp.float32 else a


def _torch_in(a, dtype):
    t = torch.from_numpy(a)
    return t.to(dtype) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["k6", "k7"])
def test_plain_mla_attention_matches_jax_xla_and_pallas(dtype, quant):
    arrays = mla_batch(seed=3 + quant, quant=quant)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    scale = 24 ** -0.5
    t_args = [_torch_in(a, td) for a in arrays]
    j_args = [_jax_in(a, jd) for a in arrays]
    if quant:
        got = ragged_paged_mla_attention_ref(
            *t_args[:6], scale=scale, c_scales=t_args[6], kr_scales=t_args[7])
        want_xla = ragged_paged_mla_attention_xla(
            *j_args[:6], scale=scale, c_scales=j_args[6], kr_scales=j_args[7])
        qa, qr, c, kr, pt, pos, cs, krs = j_args
        want_pallas = paged_mla_attention_quant_kernel(
            qa, qr, c, kr, cs, krs, pt, pos, scale=scale)
    else:
        got = ragged_paged_mla_attention_ref(*t_args, scale=scale)
        want_xla = ragged_paged_mla_attention_xla(*j_args, scale=scale)
        want_pallas = paged_mla_attention_kernel(*j_args, scale=scale)
    assert got.dtype == td
    got = got.float().numpy()
    _check_close(got, want_xla, dtype)
    _check_close(got, want_pallas, dtype)
    assert not got[arrays[5] < 0].any()  # pad rows are exactly zero


def test_mla_dispatch_on_cpu_tensors():
    """impl="auto" takes the plain version for CPU tensors; impl="cuda"
    raises for them; windows never reach the kernels."""
    args = [torch.from_numpy(a) for a in mla_batch(seed=5)]
    want = ragged_paged_mla_attention_ref(*args, scale=0.2)
    assert torch.equal(ragged_paged_mla_attention(*args, scale=0.2), want)
    assert torch.equal(
        ragged_paged_mla_attention(*args, scale=0.2, impl="torch"), want)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ragged_paged_mla_attention(*args, scale=0.2, impl="cuda")
    with pytest.raises(NotImplementedError, match="window"):
        ragged_paged_mla_attention(*args, scale=0.2, window=4, impl="cuda")
    with pytest.raises(ValueError, match="Unknown"):
        ragged_paged_mla_attention(*args, scale=0.2, impl="pallas")


# -- gate, experts, MoE block ------------------------------------------------
MOE_KW = dict(n_routed_experts=8, n_shared_experts=2, experts_per_token=3,
              moe_intermediate_size=16)
GATES = {
    # DeepSeek-V3 / Moonlight routing: sigmoid, correction bias, groups
    "sigmoid_bias_groups": dict(score_func="sigmoid", n_groups=4, topk_groups=2,
                                route_scale=2.446, gate_bias_update_speed=0.001),
    "sigmoid_bias": dict(score_func="sigmoid", route_scale=2.446,
                         gate_bias_update_speed=0.001),
    "softmax": dict(score_func="softmax", norm_topk_prob=False),
    "softmax_router_bias": dict(score_func="softmax", router_bias=True,
                                expert_activation="swigluoai"),
    "fake_balanced": dict(fake_balanced_gate=True),
}


def _moe_params(kw, H=24, seed=0):
    """Random MoE-block weights (numpy), the selection bias included."""
    cfg = j_moe_config.MoEConfig(**MOE_KW, **kw)
    params = j_layer.init_moe(cfg, H, jax.random.key(seed))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 1)
    for name in ("e_score_bias", "bias"):
        if name in params["gate"]:
            params["gate"][name] = rng.normal(0, 0.1, params["gate"][name].shape
                                              ).astype(np.float32)
    return cfg, MoEConfig(**MOE_KW, **kw), params


@pytest.mark.parametrize("kind", sorted(GATES))
def test_gate_forward_matches_jax(kind):
    j_cfg, t_cfg, params = _moe_params(GATES[kind])
    x = np.random.default_rng(7).normal(size=(40, 24)).astype(np.float32)
    mask = np.arange(40) % 7 != 3  # masked tokens take the sentinel index E
    forced = np.random.default_rng(8).integers(0, 9, (40, 3)).astype(np.int32)
    tp = params_from_jax(params["gate"], device="cpu")
    for tm, fi in ((None, None), (mask, None), (None, forced)):
        jw, ji, jaux, jst = j_gate.gate_forward(
            jax.tree.map(jnp.asarray, params["gate"]), j_cfg, jnp.asarray(x),
            None if tm is None else jnp.asarray(tm),
            None if fi is None else jnp.asarray(fi))
        tw, ti, taux, tst = gate_forward(
            tp, t_cfg, torch.from_numpy(x),
            None if tm is None else torch.from_numpy(tm),
            None if fi is None else torch.from_numpy(fi))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=GATE_ATOL, rtol=0)
        np.testing.assert_allclose(float(taux), float(jaux), atol=GATE_ATOL)
        for key in ("tokens_per_expert", "mean_prob"):
            np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                       atol=GATE_ATOL, rtol=0)
    if tm is not None:
        assert (ti.numpy()[~mask] == t_cfg.n_routed_experts).all()


@pytest.mark.parametrize("kind", ["sigmoid_bias_groups", "softmax_router_bias"])
def test_moe_forward_matches_jax(kind):
    j_cfg, t_cfg, params = _moe_params(GATES[kind], seed=2)
    x = np.random.default_rng(9).normal(size=(2, 13, 24)).astype(np.float32)
    want, _, jst = j_layer.moe_forward(
        jax.tree.map(jnp.asarray, params), j_cfg, jnp.asarray(x), lambda a, ax: a)
    got, _, tst = moe_forward(params_from_jax(params, device="cpu"), t_cfg,
                              torch.from_numpy(x))
    np.testing.assert_array_equal(tst["indices"].numpy(), np.asarray(jst["indices"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_moe_forward_refuses_what_is_not_ported():
    """A context-parallel mesh raises (ROADMAP.md item 12b; expert
    parallelism runs: tests/test_torch_mesh.py); the capacity dispatcher
    runs (its parity: tests/test_torch_deepseek_v3.py)."""
    _, t_cfg, params = _moe_params(GATES["softmax"])
    tp = params_from_jax(params, device="cpu")
    x = torch.zeros(1, 2, 24)
    out, _, _ = moe_forward(tp, dataclasses.replace(t_cfg, dispatcher="capacity"), x)
    assert out.shape == x.shape
    with pytest.raises(NotImplementedError, match="12b"):
        moe_forward(tp, t_cfg, x, mesh_ctx=MeshContext(MeshConfig(cp=2, dp_shard=1)))


class _OpLog(TorchDispatchMode):
    """Records the name of every aten op dispatched while active."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _expert_inputs(dtype, seed=3, T=40):
    """Routed expert weights, tokens and a selection in which every 5th
    token is masked (index E on all its slots) and every 7th from token 3
    on keeps its first slot alone."""
    _, t_cfg, params = _moe_params(GATES["sigmoid_bias"], seed=seed)
    experts = params_from_jax(params["experts"], device="cpu", dtype=dtype)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(T, 24)).astype(np.float32)).to(dtype)
    K, E = t_cfg.experts_per_token, t_cfg.n_routed_experts
    idx = np.stack([rng.permutation(E)[:K] for _ in range(T)]).astype(np.int32)
    idx[::5] = E
    idx[3::7, 1:] = E
    w = torch.from_numpy(rng.uniform(0.1, 1.0, (T, K)).astype(np.float32))
    return t_cfg, experts, x, w, torch.from_numpy(idx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_experts_dropless_reads_nothing_to_the_host(dtype):
    t_cfg, experts, x, w, idx = _expert_inputs(dtype)
    with _OpLog() as log:
        experts_forward_dropless(experts, t_cfg, x, w, idx)
    assert "aten._local_scalar_dense" not in log.ops, log.ops
    assert "aten.bincount" not in log.ops
    assert (log.ops.count("aten._grouped_mm") == 3) == (dtype == torch.bfloat16)


def test_experts_dropless_masked_pairs_add_exactly_zero(monkeypatch):
    """The grouped product writes no row past the last group; those rows
    (the masked pairs') are poisoned with NaN here and must not leak."""
    t_cfg, experts, x, w, idx = _expert_inputs(torch.bfloat16)
    clean = experts_forward_dropless(experts, t_cfg, x, w, idx)
    grouped_mm = torch._grouped_mm

    def poisoned(a, b, offs):
        y = grouped_mm(a, b, offs=offs)
        y[int(offs[-1]):] = float("nan")
        return y

    monkeypatch.setattr(torch, "_grouped_mm", poisoned)
    got = experts_forward_dropless(experts, t_cfg, x, w, idx)
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)
    assert (got[::5] == 0).all()  # every slot of these tokens is masked
    # masked slots add nothing: the token equals its live slot alone
    one = dataclasses.replace(t_cfg, experts_per_token=1)
    alone = experts_forward_dropless(experts, one, x[3:4], w[3:4, :1], idx[3:4, :1])
    assert torch.equal(got[3:4], alone)


# -- MLA projections ---------------------------------------------------------
MLA_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_layers=2,
              num_heads=4, num_kv_heads=4, attention_type="mla",
              mla_kv_lora_rank=16, mla_qk_nope_head_dim=8,
              mla_qk_rope_head_dim=8, mla_v_head_dim=8)


@pytest.mark.parametrize("extra", [
    dict(mla_q_lora_rank=12), dict(mla_q_lora_rank=None),
    dict(mla_q_lora_rank=12, mla_qpe_scaling_beta=0.1, mla_qpe_scaling_orig_max=4),
], ids=["q_lora", "q_proj", "qpe_scaling"])
def test_mla_absorbed_inputs_match_jax(extra):
    j_cfg = j_decoder.TransformerConfig(**MLA_KW, **extra, dtype=jnp.float32)
    t_cfg = TransformerConfig(**MLA_KW, **extra, dtype=torch.float32)
    params = jax.tree.map(np.asarray, j_decoder.init(j_cfg, jax.random.key(1)))
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    x = np.random.default_rng(4).normal(size=(2, 7, 32)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32) * 3, (2, 1))
    want = j_generate.mla_absorbed_inputs(
        jnp.asarray(x), jax.tree.map(jnp.asarray, lp), j_cfg, jnp.asarray(pos),
        j_rope_frequencies(j_cfg.rope_dim, j_cfg.rope_theta, j_cfg.rope_scaling))
    got = mla_absorbed_inputs(
        torch.from_numpy(x), params_from_jax(lp, device="cpu"), t_cfg,
        torch.from_numpy(pos),
        rope_frequencies(t_cfg.rope_dim, t_cfg.rope_theta, t_cfg.rope_scaling))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    assert t_cfg.resolved_head_dim == j_cfg.resolved_head_dim == 16
    assert t_cfg.rope_dim == j_cfg.rope_dim == 8
    assert t_cfg.attn_params_per_layer() == j_cfg.attn_params_per_layer()


def test_init_matches_jax_layout():
    """The port's MLA + MoE init builds the JAX tree key for key, shape for
    shape, so converted weights drop in unchanged."""
    j_cfg, t_cfg = deepseek_configs()
    want = jax.tree.map(lambda a: tuple(a.shape),
                        j_moe_decoder.init(j_cfg, jax.random.key(0)))
    got = moe_decoder.init(t_cfg, torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda t: tuple(t.shape), got)
    assert got == want


# -- the engine --------------------------------------------------------------
def deepseek_configs(num_layers=2, **moe_over):
    """A DeepSeek-V3-style decoder at a tiny size: one dense and one MoE
    layer, MLA with q_lora_rank, sigmoid routing with the correction bias
    over 2 groups, 2 shared experts, routed scaling factor."""
    moe = dict(n_routed_experts=8, n_shared_experts=2, experts_per_token=2,
               n_groups=2, topk_groups=1, score_func="sigmoid",
               route_scale=2.446, moe_intermediate_size=16,
               gate_bias_update_speed=0.001, **moe_over)
    kw = dict(MLA_KW, num_layers=num_layers, mla_q_lora_rank=12, first_k_dense=1)
    j_cfg = j_moe_decoder.MoETransformerConfig(
        **kw, moe=j_moe_config.MoEConfig(**moe), dtype=jnp.float32,
        remat_policy="none")
    t_cfg = moe_decoder.MoETransformerConfig(
        **kw, moe=MoEConfig(**moe), dtype=torch.float32)
    return j_cfg, t_cfg


def _prompts(lens, seed0=0):
    return [
        [int(t) for t in np.random.default_rng(seed0 + i).integers(1, 64, (L,))]
        for i, L in enumerate(lens)
    ]


def _plan_fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
            if getattr(plan, f.name) is not None}


def run_lockstep(je, te, prompts, arrivals, max_new, monkeypatch):
    """Both engines' schedulers fed the same stream: equal StepPlans at
    every step, sample-row logits within LOGITS_ATOL, equal greedy tokens.
    Returns the generated tokens."""
    js, ts = je.make_scheduler(), te.make_scheduler()
    for p, a in zip(prompts, arrivals):
        js.submit(JRequest(prompt=list(p), max_new_tokens=max_new, arrival=a))
        ts.submit(Request(prompt=list(p), max_new_tokens=max_new, arrival=a))
    seen = []
    real_unembed = j_engine.unembed

    def spy(params, cfg, h):
        # the engine's jitted step calls this while tracing; the callback
        # hands each run's concrete logits back
        logits = real_unembed(params, cfg, h)
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), logits[0])
        return logits

    monkeypatch.setattr(j_engine, "unembed", spy)
    step, n_steps = 0, 0
    while js.has_work:
        jp, tp = js.schedule(step), ts.schedule(step)
        if jp is None:
            assert tp is None
            step += 1
            continue
        j_fields, t_fields = _plan_fields(jp), _plan_fields(tp)
        assert j_fields.keys() - {"verify_rows", "spec_len"} == t_fields.keys()
        for name, value in t_fields.items():
            np.testing.assert_array_equal(value, j_fields[name], err_msg=name)
        pool, j_tok, _ = je._step(je.params, je.pool, je._plan_batch(jp))
        jax.effects_barrier()
        je.pool = pool
        t_logits = te.step_logits(tp)
        np.testing.assert_allclose(t_logits.numpy(), seen[-1],
                                   atol=LOGITS_ATOL, rtol=0)
        t_tok, _ = te._sample(t_logits, tp)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        js.update(jp, np.asarray(j_tok), step)
        ts.update(tp, t_tok.numpy(), step)
        step += 1
        n_steps += 1
    assert not ts.has_work and n_steps > 0
    outs = [r.generated for r in ts.finished]
    assert outs == [r.generated for r in js.finished]
    assert all(len(o) == max_new for o in outs)
    return outs


def random_bias(params, seed=5):
    """Nonzero correction biases, so the selection differs from the
    weights' ranking (a fresh init has zeros)."""
    b = params["moe_layers"]["moe"]["gate"]["e_score_bias"]
    params["moe_layers"]["moe"]["gate"]["e_score_bias"] = jnp.asarray(
        np.random.default_rng(seed).normal(0, 0.05, b.shape).astype(np.float32))
    return params


# (JAX config, port config, serving config, prompts, arrivals, max_new)
def engine_cases():
    j_mla = j_decoder.TransformerConfig(**MLA_KW, mla_q_lora_rank=12,
                                        dtype=jnp.float32, remat_policy="none")
    t_mla = TransformerConfig(**MLA_KW, mla_q_lora_rank=12, dtype=torch.float32)
    j_ds, t_ds = deepseek_configs()
    return {
        # tests/unit/test_serving_engine.py::test_mla_parity_ragged_stream_compiles_once
        "mla_ragged": (j_mla, t_mla, dict(page_size=4, num_pages=20, max_slots=3,
                                          pages_per_slot=5, token_budget=6,
                                          prefill_chunk=3),
                       _prompts([6, 9, 4, 8], seed0=10), [0, 1, 2, 4], 5),
        # tests/unit/test_serving_engine.py::test_moe_decoder_parity geometry
        "deepseek": (j_ds, t_ds, dict(page_size=4, num_pages=16, max_slots=2,
                                      pages_per_slot=4, token_budget=6,
                                      prefill_chunk=3),
                     _prompts([5, 7], seed0=40), [0, 1], 4),
    }


def engine_params(j_cfg, seed=0):
    if isinstance(j_cfg, j_moe_decoder.MoETransformerConfig):
        return random_bias(j_moe_decoder.init(j_cfg, jax.random.key(seed)))
    return j_decoder.init(j_cfg, jax.random.key(seed))


@pytest.mark.parametrize("case", ["mla_ragged", "deepseek"])
def test_engine_lockstep_matches_jax(case, monkeypatch):
    j_cfg, t_cfg, sc, prompts, arrivals, max_new = engine_cases()[case]
    params = engine_params(j_cfg)
    je = JServingEngine(params, j_cfg, JServingConfig(**sc))
    te = ServingEngine(params_from_jax(jax.tree.map(np.asarray, params),
                                       device="cpu"),
                       t_cfg, ServingConfig(**sc), device="cpu")
    run_lockstep(je, te, prompts, arrivals, max_new, monkeypatch)


def test_deepseek_serve_batch_matches_jax():
    """serve_batch end to end on a 3-layer DeepSeek-style decoder (one
    dense, two MoE layers): equal greedy outputs and step counts."""
    j_cfg, t_cfg = deepseek_configs(num_layers=3)
    params = engine_params(j_cfg, seed=1)
    sc = dict(page_size=4, num_pages=16, max_slots=2, pages_per_slot=4,
              token_budget=6, prefill_chunk=3)
    prompts, arrivals = _prompts([5, 7], seed0=40), [0, 1]
    want = JServingEngine(params, j_cfg, JServingConfig(**sc)).serve_batch(
        [JRequest(prompt=p, max_new_tokens=4, arrival=a)
         for p, a in zip(prompts, arrivals)])
    te = ServingEngine(params_from_jax(jax.tree.map(np.asarray, params),
                                       device="cpu"),
                       t_cfg, ServingConfig(**sc), device="cpu")
    got = te.serve_batch([Request(prompt=p, max_new_tokens=4, arrival=a)
                          for p, a in zip(prompts, arrivals)])
    assert got["outputs"] == want["outputs"]
    for key in ("steps", "new_tokens", "tokens_fed"):
        assert got["stats"][key] == want["stats"][key], key


def test_moonlight_config_and_registry():
    """moonshotai/Moonlight-16B-A3B's config.json fields map to the same
    config as the JAX adapter; with yarn rope too."""
    from automodel_tpu.models.moe_lm.families import (
        deepseek_v3_moe_config as j_deepseek_v3_moe_config,
    )
    from automodel_tpu_torch.models.registry import get_model_spec

    hf = dict(
        architectures=["DeepseekV3ForCausalLM"], vocab_size=163840,
        hidden_size=2048, intermediate_size=11264, moe_intermediate_size=1408,
        num_hidden_layers=27, num_attention_heads=16, num_key_value_heads=16,
        n_shared_experts=2, n_routed_experts=64, routed_scaling_factor=2.446,
        kv_lora_rank=512, q_lora_rank=None, qk_rope_head_dim=64,
        v_head_dim=128, qk_nope_head_dim=128, n_group=1, topk_group=1,
        num_experts_per_tok=6, first_k_dense_replace=1, norm_topk_prob=True,
        scoring_func="sigmoid", rope_theta=50000.0, rms_norm_eps=1e-5,
        max_position_embeddings=8192, num_nextn_predict_layers=0,
        tie_word_embeddings=False,
    )
    spec = get_model_spec(hf)
    assert spec.module is moe_decoder
    got = spec.config_from_hf(hf, dtype=torch.bfloat16)
    want = j_deepseek_v3_moe_config(hf)
    for f in dataclasses.fields(got):
        if f.name not in ("dtype", "moe", "rope_scaling", "attn_impl", "remat_policy"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
    assert got.attention_type == "mla" and got.first_k_dense == 1
    assert got.num_moe_layers == 26 and got.mla_q_lora_rank is None
    yarn_hf = dict(hf, rope_scaling={"type": "yarn", "factor": 40, "mscale_all_dim": 1.0})
    got = deepseek_v3_moe_config(yarn_hf)
    assert got.attn_scale == j_deepseek_v3_moe_config(yarn_hf).attn_scale
    # the MoE decoder trains, with the MTP head and the capacity dispatcher
    # too, and DSA (its parity: tests/test_torch_dsa.py)
    tiny = deepseek_v3_moe_config(dict(
        hf, vocab_size=32, hidden_size=16, intermediate_size=24,
        moe_intermediate_size=8, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=2, n_routed_experts=4, num_experts_per_tok=2,
        kv_lora_rank=8, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8),
        dtype=torch.float32, remat_policy="none")
    params = moe_decoder.init(tiny, torch.Generator().manual_seed(0))
    ids = torch.zeros((1, 4), dtype=torch.int64)
    logits, aux = spec.module.forward(params, tiny, ids)
    assert logits.shape == (1, 4, 32) and aux.shape == ()
    assert "mtp" in moe_decoder.init(dataclasses.replace(tiny, mtp_num_layers=1),
                                     torch.Generator())
    dsa = dataclasses.replace(tiny, dsa_index_topk=2)
    logits, aux = spec.module.forward(
        moe_decoder.init(dsa, torch.Generator().manual_seed(0)), dsa, ids)
    assert logits.shape == (1, 4, 32) and float(aux) > 0
    logits, _ = spec.module.forward(params, dataclasses.replace(
        tiny, moe=dataclasses.replace(tiny.moe, dispatcher="capacity")), ids)
    assert logits.shape == (1, 4, 32)
