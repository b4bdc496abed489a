"""Port parity of `inference/het_generate.py`, the heterogeneous MoE engine's
KV-cache generation, against the JAX package's on the CPU (fp32, the smoke
YAMLs' models with random sinks, biases and norm scales):

- greedy tokens equal to JAX's for Step-3.5 (NoPE layer, head gate),
  MiMo-V2-Flash (sinks, q/k 16 and v 8 on the sliding layers) and
  MiniMax-M3 (block-sparse decode over the cached index keys, prompts
  long enough that the top-k drops blocks), and to the argmax of the
  port's own full `forward` at every step;
- EOS: a sequence that emits it keeps emitting it, as in JAX;
- sampling (temperature, top-k, top-p): the RNGs differ, so each sampled
  token must lie in the filtered support of the forward's logits;
- `generate()` dispatches a `HetMoEConfig` here, and the validation
  sampling eval (`eval/sampling.py`) reaches it with JAX's metrics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_het_moe import tiny

from automodel_tpu.eval.sampling import run_sampling_eval as j_sampling_eval
from automodel_tpu.inference.generate import GenerateConfig as JGen
from automodel_tpu.inference.generate import generate as j_generate
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.eval.sampling import run_sampling_eval
from automodel_tpu_torch.inference import het_generate as het_gen_module
from automodel_tpu_torch.inference.generate import GenerateConfig, generate
from automodel_tpu_torch.inference.sampling import filter_logits
from automodel_tpu_torch.models.moe_lm import het_moe
from automodel_tpu_torch.models.registry import get_model_spec

FAMILIES = ("step3p5", "mimo_v2_flash", "minimax_m3")
PROMPT, NEW = 18, 10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(family):
    hf, _, jp = tiny(family, seed=2)
    jcfg = j_get_model_spec(hf).config_from_hf(hf, dtype=jnp.float32, remat_policy="none")
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32, remat_policy="none")
    return hf, jcfg, tcfg, jp


def _prompts(vocab, seed=0, B=2, S=PROMPT):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(np.int32)


def _forward_argmax(tp, tcfg, ids):
    """The port's full forward re-run for every new token (the oracle)."""
    toks = torch.from_numpy(ids[:, :PROMPT]).long()
    for _ in range(ids.shape[1] - PROMPT):
        logits, _ = het_moe.forward(tp, tcfg, toks)
        toks = torch.cat([toks, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
    return toks.numpy()


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_tokens_equal_jax(family):
    hf, jcfg, tcfg, jp = _model(family)
    ids = _prompts(hf["vocab_size"])
    want = np.asarray(j_generate(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(ids),
                                 jax.random.key(0), JGen(max_new_tokens=NEW)))
    tp = params_from_jax(jp, device="cpu")
    got = generate(tp, tcfg, torch.from_numpy(ids).long(), None,
                   GenerateConfig(max_new_tokens=NEW)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _forward_argmax(tp, tcfg, got))
    if family == "minimax_m3":
        # the last decode step sees more causal key blocks than its top-k
        assert -(-(PROMPT + NEW) // tcfg.sparse_block_size) > tcfg.sparse_topk_blocks


def test_eos_pads_as_jax():
    """EOS is the token MiMo's greedy run emits third in row 0: from there
    row 0 repeats it, as JAX's does."""
    hf, jcfg, tcfg, jp = _model("mimo_v2_flash")
    ids = _prompts(hf["vocab_size"], seed=1)
    tp = params_from_jax(jp, device="cpu")
    free = generate(tp, tcfg, torch.from_numpy(ids).long(), None,
                    GenerateConfig(max_new_tokens=NEW)).numpy()
    eos = int(free[0, PROMPT + 2])
    want = np.asarray(j_generate(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(ids),
                                 jax.random.key(0), JGen(max_new_tokens=NEW, eos_token_id=eos)))
    got = generate(tp, tcfg, torch.from_numpy(ids).long(), None,
                   GenerateConfig(max_new_tokens=NEW, eos_token_id=eos)).numpy()
    np.testing.assert_array_equal(got, want)
    first = PROMPT + int(np.argmax(got[0, PROMPT:] == eos))
    assert (got[0, first:] == eos).all() and first <= PROMPT + 2


@pytest.mark.parametrize("family", ("mimo_v2_flash", "minimax_m3"))
def test_sampled_tokens_stay_in_the_filtered_support(family):
    hf, _, tcfg, jp = _model(family)
    tp = params_from_jax(jp, device="cpu")
    gen = GenerateConfig(max_new_tokens=6, temperature=0.8, top_k=5, top_p=0.9)
    ids = torch.from_numpy(_prompts(hf["vocab_size"], seed=4)).long()
    rng = torch.Generator().manual_seed(0)
    out = het_gen_module.het_generate(tp, tcfg, ids, rng, gen)
    for t in range(PROMPT, out.shape[1]):
        logits, _ = het_moe.forward(tp, tcfg, out[:, :t])
        allowed = filter_logits(logits[:, -1] / gen.temperature, gen.top_k, gen.top_p) > -1e30
        assert allowed.gather(1, out[:, t:t + 1]).all(), t
        assert (allowed.sum(-1) <= gen.top_k).all()


def test_sampling_eval_reaches_het_generate():
    """`run_sampling_eval` (the recipe's validation generation) on a MiMo
    model: the same metrics as the JAX function's."""
    hf, jcfg, tcfg, jp = _model("mimo_v2_flash")
    rng = np.random.default_rng(7)
    ids = rng.integers(1, hf["vocab_size"], (2, 24)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100, np.int32)], axis=1)
    labels[1, 20:] = -100
    mbs = [{"input_ids": ids, "labels": labels}]
    kw = dict(prompt_len=12, max_new_tokens=8, max_batches=1)
    want = j_sampling_eval(jax.tree.map(jnp.asarray, jp), jcfg, iter(mbs), **kw)
    got = run_sampling_eval(params_from_jax(jp, device="cpu"), tcfg, iter(mbs), **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(float(want[k])), k
