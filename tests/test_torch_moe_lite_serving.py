"""Port parity of GLM-4.7-Flash's (`Glm4MoeLiteForCausalLM`), Mistral-4's
and Hy-MT2's serving on the CPU, the JAX package beside
`automodel_tpu_torch` (`device="cpu"`) on the same weights, requests and
YAMLs.

- The smoke YAMLs' models (every bias, correction bias and norm scale
  drawn at random) served by the JAX `ServingEngine` and the port's, greedy
  outputs token for token and the engine statistics equal: Hy-MT2 on the
  fp pool, GLM-4.7-Flash's MLA on the int8 latent pool (the pools
  themselves are held for every family in the earlier serving tests),
  Mistral-4 on the fp pool with prompts of 37-61 tokens, so the q-rope
  scale (original_max_position_embeddings 16) takes five values; the same
  engine with the scaling off gives other tokens.

The smoke YAMLs' recipes are in tests/test_torch_moe_lite_recipes.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_moe_lite_families import tiny

from automodel_tpu.serving import Request as JRequest
from automodel_tpu.serving import ServingConfig as JServingConfig
from automodel_tpu.serving import ServingEngine as JServingEngine
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine

SERVE = dict(page_size=4, num_pages=96, max_slots=3, pages_per_slot=20,
             token_budget=8, prefill_chunk=4)
PROMPT_LENS, ARRIVALS, MAX_NEW = (37, 61, 44, 23), (0, 0, 2, 5), 8


def _serve(family, kv_cache_dtype):
    """(JAX's serve result, the port's, a function serving the port's
    engine under another config) on the same weights and requests."""
    hf, jcfg, jp = tiny(family, seed=3)
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32)
    prompts = [[int(t) for t in np.random.default_rng(70 + i).integers(
        1, hf["vocab_size"], (n,))] for i, n in enumerate(PROMPT_LENS)]
    je = JServingEngine(jax.tree.map(jnp.asarray, jp), jcfg,
                        JServingConfig(**SERVE, kv_cache_dtype=kv_cache_dtype))
    want = je.serve_batch([JRequest(prompt=list(p), max_new_tokens=MAX_NEW, arrival=a)
                           for p, a in zip(prompts, ARRIVALS)])

    def port(cfg):
        te = ServingEngine(params_from_jax(jp, device="cpu"), cfg,
                           ServingConfig(**SERVE, kv_cache_dtype=kv_cache_dtype),
                           device="cpu")
        return te.serve_batch([Request(prompt=list(p), max_new_tokens=MAX_NEW, arrival=a)
                               for p, a in zip(prompts, ARRIVALS)])

    return want, port(tcfg), lambda fn: port(fn(tcfg))


@pytest.mark.parametrize("family, kv_cache_dtype", [
    ("hy_mt2", None), ("glm4_moe_lite", "int8"), ("mistral4", None)])
def test_engine_token_equal_to_jax(family, kv_cache_dtype):
    want, got, port = _serve(family, kv_cache_dtype)
    assert got["outputs"] == want["outputs"]
    assert all(len(o) == MAX_NEW for o in got["outputs"])
    for key in ("steps", "new_tokens", "tokens_fed", "preemptions"):
        assert got["stats"][key] == want["stats"][key], key
    if family == "mistral4":
        # positions 0..67 against original_max_position_embeddings 16: the
        # scale takes five values; without it the tokens differ
        assert (max(PROMPT_LENS) + MAX_NEW - 1) // 16 == 4
        off = port(lambda c: dataclasses.replace(c, mla_qpe_scaling_beta=None))
        assert off["outputs"] != got["outputs"]
