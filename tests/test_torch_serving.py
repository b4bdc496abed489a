"""Port parity of the serving slice: the JAX `ServingEngine` and the port's
serve the same request streams with the same weights (fp32, on the CPU).

- greedy outputs match token for token (serve_batch, three streams: the
  ragged stream and the forced-preemption stream of
  tests/unit/test_serving_engine.py, and a shared-prefix stream through the
  prefix cache's copy-on-write path);
- run in lockstep, the two schedulers emit equal StepPlans at every step
  and the engines' sample-row logits agree to atol 1e-4 (fp32; only the
  order of operations differs, across 2 layers and the unembed);
- the engine-lifetime prefix cache serves warm after a pool defrag, in
  both engines alike;
- sampling is deterministic per (seed, position) and top_k=1 is greedy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.serving import PrefixCacheConfig as JPrefixCacheConfig
from automodel_tpu.serving import Request as JRequest
from automodel_tpu.serving import ServingConfig as JServingConfig
from automodel_tpu.serving import ServingEngine as JServingEngine
from automodel_tpu.serving import engine as j_engine
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.llm.decoder import TransformerConfig
from automodel_tpu_torch.serving import (
    PrefixCacheConfig,
    Request,
    ServingConfig,
    ServingEngine,
)

LOGITS_ATOL = 1e-4

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_layers=2,
           num_heads=4, num_kv_heads=2, qk_norm=True)
J_CFG = j_decoder.TransformerConfig(**CFG, dtype=jnp.float32, remat_policy="none")
T_CFG = TransformerConfig(**CFG, dtype=torch.float32)


def _ragged_prompts(lens, vocab=64, seed0=0):
    return [
        [int(t) for t in np.random.default_rng(seed0 + i).integers(1, vocab, (l,))]
        for i, l in enumerate(lens)
    ]


def _shared_prefix_prompts():
    system = _ragged_prompts([9], seed0=40)[0]
    return [system + tail for tail in _ragged_prompts([3, 5, 2], seed0=41)]


# (serving config, prompts, arrivals, max_new_tokens)
STREAMS = {
    # tests/unit/test_serving_engine.py::test_gqa_parity_ragged_stream_compiles_once
    "ragged": (dict(page_size=4, num_pages=24, max_slots=3, pages_per_slot=6,
                    token_budget=8, prefill_chunk=4),
               _ragged_prompts([5, 9, 3, 7, 11]), [0, 0, 2, 3, 5], 6),
    # tests/unit/test_serving_engine.py::test_preempt_and_requeue_parity
    "preempt": (dict(page_size=2, num_pages=8, max_slots=3, pages_per_slot=6,
                     token_budget=6, prefill_chunk=3),
                _ragged_prompts([4, 4, 4], seed0=20), [0, 0, 0], 5),
    "prefix": (dict(page_size=4, num_pages=24, max_slots=2, pages_per_slot=6,
                    token_budget=8, prefill_chunk=4, prefix="on"),
               _shared_prefix_prompts(), [0, 3, 6], 4),
}


@pytest.fixture(scope="module")
def weights():
    params = j_decoder.init(J_CFG, jax.random.key(0))
    return params, params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _engines(weights, sc):
    sc = dict(sc)
    prefix = sc.pop("prefix", None)
    j_sc = JServingConfig(**sc, prefix_cache=(
        JPrefixCacheConfig(enabled=True) if prefix else None))
    t_sc = ServingConfig(**sc, prefix_cache=(
        PrefixCacheConfig(enabled=True) if prefix else None))
    j_params, t_params = weights
    return (JServingEngine(j_params, J_CFG, j_sc),
            ServingEngine(t_params, T_CFG, t_sc, device="cpu"))


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_serve_batch_greedy_parity(weights, stream):
    sc, prompts, arrivals, max_new = STREAMS[stream]
    je, te = _engines(weights, sc)
    want = je.serve_batch([JRequest(prompt=list(p), max_new_tokens=max_new,
                                    arrival=a) for p, a in zip(prompts, arrivals)])
    got = te.serve_batch([Request(prompt=list(p), max_new_tokens=max_new,
                                  arrival=a) for p, a in zip(prompts, arrivals)])
    assert got["outputs"] == want["outputs"]
    assert set(got["stats"]) == set(want["stats"])
    for key in ("steps", "new_tokens", "tokens_fed", "preemptions",
                "prefix_hits", "cow_copies"):
        assert got["stats"].get(key) == want["stats"].get(key), key
    if stream == "preempt":
        assert got["stats"]["preemptions"] >= 1
    if stream == "prefix":
        assert got["stats"]["cow_copies"] >= 1


def test_warm_prefix_cache_after_defrag(weights):
    """Engine-lifetime prefix cache: serve, evict two cached pages (holes
    in the pool), compact the pool (defrag moves the cached pages and the
    radix tree follows), serve the same prompts again from the warm cache —
    both engines alike, outputs unchanged."""
    sc, prompts, arrivals, max_new = STREAMS["prefix"]
    je, te = _engines(weights, sc)
    outs = {"jax": [], "torch": []}
    for name, engine, req in (("jax", je, JRequest), ("torch", te, Request)):
        for round_ in range(2):
            res = engine.serve_batch([
                req(prompt=list(p), max_new_tokens=max_new, arrival=a)
                for p, a in zip(prompts, arrivals)])
            outs[name].append((res["outputs"], res["stats"]["prefix_hits"]))
            if round_ == 0:
                assert engine.prefix.reclaim(2) == 2
                assert engine.defrag(engine.make_scheduler())
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0][0] == outs["torch"][1][0]
    assert outs["torch"][1][1] > outs["torch"][0][1]  # the second run is warm


def _plan_fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
            if getattr(plan, f.name) is not None}


@pytest.mark.parametrize("stream", ["ragged", "preempt"])
def test_lockstep_plans_and_logits(weights, stream, monkeypatch):
    """Both schedulers fed the same stream emit equal StepPlans; every
    step's sample-row logits agree (the first step included)."""
    sc, prompts, arrivals, max_new = STREAMS[stream]
    je, te = _engines(weights, sc)
    js, ts = je.make_scheduler(), te.make_scheduler()
    for p, a in zip(prompts, arrivals):
        js.submit(JRequest(prompt=list(p), max_new_tokens=max_new, arrival=a))
        ts.submit(Request(prompt=list(p), max_new_tokens=max_new, arrival=a))
    seen = []
    real_unembed = j_engine.unembed

    def spy(params, cfg, h):
        logits = real_unembed(params, cfg, h)
        seen.append(np.asarray(logits[0]))
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
        # the JAX step run eagerly, so the spy sees concrete logits
        pool, j_tok, _ = je._step_impl(je.params, je.pool, je._plan_batch(jp))
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
    assert [r.generated for r in ts.finished] == [r.generated for r in js.finished]


def test_sampling_is_deterministic_per_seed_and_position(weights):
    _, t_params = weights
    sc = dict(page_size=4, num_pages=24, max_slots=3, pages_per_slot=6,
              token_budget=8)

    def serve(seed, temperature=1.0, top_k=None):
        te = ServingEngine(t_params, T_CFG, ServingConfig(**sc, top_k=top_k),
                           device="cpu")
        reqs = [Request(prompt=p, max_new_tokens=8, temperature=temperature,
                        seed=seed + i)
                for i, p in enumerate(_ragged_prompts([5, 3], seed0=50))]
        return te.serve_batch(reqs)["outputs"]

    assert serve(0) == serve(0)
    assert serve(0) != serve(100)
    assert serve(0, top_k=1) == serve(0, temperature=0.0)
