"""Serving parity of GLM-4 (rotary on half of each head, interleaved, with
sandwich norms) and Baichuan2 (MHA, NormHead) on the CPU: the JAX
`ServingEngine` and the port's on the same weights and requests, on the fp
and the int8 pool, greedy outputs token for token and the engine
statistics equal; `generate()` greedy-equal to JAX's and to the forward's
argmax. The same GLM-4 engine rotating whole heads, and Baichuan's without
the NormHead, give other tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense_families import _tiny

from automodel_tpu.inference.generate import GenerateConfig as JGenerateConfig
from automodel_tpu.inference.generate import generate as j_generate
from automodel_tpu.serving import Request as JRequest
from automodel_tpu.serving import ServingConfig as JServingConfig
from automodel_tpu.serving import ServingEngine as JServingEngine
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.inference.generate import GenerateConfig, generate
from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine

SERVE = dict(page_size=4, num_pages=48, max_slots=3, pages_per_slot=10,
             token_budget=8, prefill_chunk=4)
PROMPT_LENS, ARRIVALS, MAX_NEW = (13, 21, 9), (0, 0, 2), 8
# what each family's engine must need: the field, and its value switched off
CONTROL = {"glm4": dict(partial_rotary_factor=1.0),
           "baichuan": dict(normalized_lm_head=False)}


def _prompts(vocab):
    return [[int(t) for t in np.random.default_rng(60 + i).integers(1, vocab, (n,))]
            for i, n in enumerate(PROMPT_LENS)]


def _port_serve(tp, tcfg, prompts, kv_cache_dtype):
    te = ServingEngine(tp, tcfg, ServingConfig(**SERVE, kv_cache_dtype=kv_cache_dtype),
                       device="cpu")
    return te.serve_batch([Request(prompt=list(p), max_new_tokens=MAX_NEW, arrival=a)
                           for p, a in zip(prompts, ARRIVALS)])


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
@pytest.mark.parametrize("family", ["glm4", "baichuan"])
def test_engine_token_equal_to_jax(family, kv_cache_dtype):
    hf, jcfg, jp = _tiny(family, seed=3)
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32)
    prompts = _prompts(hf["vocab_size"])
    je = JServingEngine(jax.tree.map(jnp.asarray, jp), jcfg,
                        JServingConfig(**SERVE, kv_cache_dtype=kv_cache_dtype))
    want = je.serve_batch([JRequest(prompt=list(p), max_new_tokens=MAX_NEW, arrival=a)
                           for p, a in zip(prompts, ARRIVALS)])
    tp = params_from_jax(jp, device="cpu")
    got = _port_serve(tp, tcfg, prompts, kv_cache_dtype)
    assert got["outputs"] == want["outputs"]
    assert all(len(o) == MAX_NEW for o in got["outputs"])
    for key in ("steps", "new_tokens", "tokens_fed", "preemptions"):
        assert got["stats"][key] == want["stats"][key], key
    if kv_cache_dtype is None:
        other = _port_serve(tp, dataclasses.replace(tcfg, **CONTROL[family]), prompts, None)
        assert other["outputs"] != got["outputs"]


@pytest.mark.parametrize("family", ["glm4", "baichuan"])
def test_greedy_generate_token_equal_to_jax(family):
    hf, jcfg, jp = _tiny(family, seed=4)
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32)
    tp = params_from_jax(jp, device="cpu")
    ids = np.random.default_rng(70).integers(1, hf["vocab_size"], (2, 10)).astype(np.int32)
    want = np.asarray(j_generate(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(ids),
                                 jax.random.key(0), JGenerateConfig(max_new_tokens=MAX_NEW)))
    got = generate(tp, tcfg, torch.from_numpy(ids), None,
                   GenerateConfig(max_new_tokens=MAX_NEW)).numpy()
    np.testing.assert_array_equal(got, want)
    ref = torch.from_numpy(ids).long()
    for _ in range(MAX_NEW):  # the teacher-forced forward's argmax
        ref = torch.cat([ref, decoder.forward(tp, tcfg, ref)[:, -1].argmax(-1, keepdim=True)], 1)
    np.testing.assert_array_equal(got, ref.numpy())
