"""The port's batch-synchronous `generate()` (`automodel_tpu_torch/inference/
generate.py`) and sampling eval (`eval/sampling.py`) against the JAX
package's, on the CPU in fp32, with the same numpy weights and prompts.

Greedy tokens must be equal, token for token, for five tiny models:

- a dense Llama (GQA);
- a Gemma-2 (a window of 5 on alternate layers, attention and final soft
  caps, zero-centred norms);
- a Gemma-3 (a window of 5 on its sliding layer, which rotates with the
  local rope theta);
- a Llama with learned attention sinks (random, not the zeros init gives)
  and a window of 5 on every layer;
- `examples/llm_finetune/deepseek_v3_smoke.yaml`'s DeepSeek-V3 (MLA over
  the absorbed latent cache, one dense and one MoE layer, dropless).

Prompts (8-12 tokens) plus 6 new tokens exceed every window, so the windows
mask in prefill and decode; each windowed model is also run with every
layer global, which must change its tokens. Greedy tokens also equal the
teacher-forced `decoder.forward` argmax loop. Then: one new token; EOS
padding; sampled tokens by property (in the vocabulary, top-k 1 equal to
greedy, two generators giving different draws; `torch.multinomial` and
`jax.random.categorical` draw different streams, so sampled tokens are not
compared across packages); `run_sampling_eval` equal to the JAX function's
on the same batches, built so that about half the continuation tokens hit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.eval.sampling import run_sampling_eval as j_run_sampling_eval
from automodel_tpu.inference.generate import GenerateConfig as JGenerateConfig
from automodel_tpu.inference.generate import generate as j_generate
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.models.llm import families as j_families
from automodel_tpu.models.moe_lm.families import (
    deepseek_v3_moe_config as j_deepseek_v3_moe_config,
)
from automodel_tpu_torch.config import load_yaml
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.eval.sampling import run_sampling_eval
from automodel_tpu_torch.inference.generate import GenerateConfig, generate
from automodel_tpu_torch.models.llm import decoder, families
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.moe_lm.families import deepseek_v3_moe_config

SMALL = dict(vocab_size=96, hidden_size=32, intermediate_size=48,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             head_dim=8, rms_norm_eps=1e-6, rope_theta=10000.0)
WINDOW = 5
# name -> (family, HF config, extra config fields, the windows of its layers)
MODELS = {
    "llama": ("llama", SMALL, {}, (None, None)),
    "gemma2": ("gemma2", dict(SMALL, sliding_window=WINDOW, attn_logit_softcapping=5.0,
                              final_logit_softcapping=8.0, query_pre_attn_scalar=8),
               {}, (WINDOW, None)),
    "gemma3": ("gemma3", dict(SMALL, sliding_window=WINDOW, sliding_window_pattern=2,
                              rope_local_base_freq=100.0, rope_theta=1000000.0,
                              query_pre_attn_scalar=8), {}, (WINDOW, None)),
    "sinks": ("llama", SMALL, {"attention_sinks": True, "sliding_window": WINDOW},
              (WINDOW, WINDOW)),
    "deepseek_v3": ("deepseek_v3", None, {}, (None, None)),
}
PROMPT_LENS, MAX_NEW = (8, 12), 6


def _np_init(module, tcfg):
    """Random params drawn by the port (faster than a JAX init on the
    CPU), as the numpy tree both packages then take."""
    params = module.init(tcfg, torch.Generator().manual_seed(5))
    return jax.tree.map(lambda t: t.numpy(), params)


def _build(name):
    """(jax config, port config, numpy params) of a tiny model."""
    family, hf, extra, windows = MODELS[name]
    rng = np.random.default_rng(11)
    if family == "deepseek_v3":
        hf = load_yaml("examples/llm_finetune/deepseek_v3_smoke.yaml").get(
            "model.hf_config").to_dict()
        jcfg = j_deepseek_v3_moe_config(hf, dtype=jnp.float32, remat_policy="none",
                                        attn_impl="xla")
        tcfg = deepseek_v3_moe_config(hf, dtype=torch.float32, remat_policy="none")
        jp = _np_init(moe_decoder, tcfg)
        gate = jp["moe_layers"]["moe"]["gate"]
        gate["e_score_bias"] = rng.normal(0, 0.05, gate["e_score_bias"].shape).astype(
            np.float32)
        return jcfg, tcfg, jp
    jcfg = getattr(j_families, f"{family}_config")(hf, dtype=jnp.float32,
                                                   remat_policy="none")
    tcfg = getattr(families, f"{family}_config")(hf, dtype=torch.float32)
    jcfg, tcfg = dataclasses.replace(jcfg, **extra), dataclasses.replace(tcfg, **extra)
    assert decoder.layer_windows(tcfg) == j_decoder.layer_windows(jcfg) == windows
    jp = _np_init(decoder, tcfg)
    for key, node in jp["layers"].items():
        if key.endswith("norm"):  # zero-centred norms would all be 1
            node["scale"] = rng.normal(0, 0.3, node["scale"].shape).astype(np.float32)
    if "sinks" in jp["layers"]:  # the init's zero sinks
        jp["layers"]["sinks"] = rng.normal(0, 1.0, jp["layers"]["sinks"].shape).astype(
            np.float32)
    return jcfg, tcfg, jp


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    jcfg, tcfg, jp = _build(request.param)
    return request.param, jcfg, tcfg, jp, params_from_jax(jp, device="cpu")


def _prompt(n, vocab, seed):
    return np.random.default_rng(seed).integers(1, vocab, (1, n)).astype(np.int32)


def _forward_argmax(module, tp, tcfg, ids, n):
    """The teacher-forced reference: the full forward for every new token."""
    ids = torch.from_numpy(ids).long()
    for _ in range(n):
        out = module.forward(tp, tcfg, ids)
        logits = out[0] if isinstance(out, tuple) else out
        ids = torch.cat([ids, logits[:, -1].argmax(-1, keepdim=True)], 1)
    return ids.numpy()


def test_greedy_generate_token_equal_to_jax(model):
    name, jcfg, tcfg, jp, tp = model
    module = moe_decoder if name == "deepseek_v3" else decoder
    windows = [w for w in MODELS[name][3] if w]
    glob = dataclasses.replace(tcfg, sliding_window=None, layer_types=None)
    changed = False
    for i, n in enumerate(PROMPT_LENS):
        assert not windows or n + MAX_NEW > max(windows)  # the windows mask
        ids = _prompt(n, tcfg.vocab_size, 40 + i)
        want = np.asarray(j_generate(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(ids),
                                     jax.random.key(0), JGenerateConfig(max_new_tokens=MAX_NEW)))
        got = generate(tp, tcfg, torch.from_numpy(ids), None,
                       GenerateConfig(max_new_tokens=MAX_NEW)).numpy()
        assert got.shape == (1, n + MAX_NEW)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _forward_argmax(module, tp, tcfg, ids, MAX_NEW))
        if windows:
            unwindowed = generate(tp, glob, torch.from_numpy(ids), None,
                                  GenerateConfig(max_new_tokens=MAX_NEW)).numpy()
            changed |= bool((unwindowed != got).any())
    assert changed or not windows  # every layer global gives other tokens


@pytest.fixture(scope="module")
def llama():
    jcfg, tcfg, jp = _build("llama")
    return jcfg, tcfg, jp, params_from_jax(jp, device="cpu")


def test_single_new_token_and_batch_rows(llama):
    """One new token; and a batch of two prompts equals each alone."""
    jcfg, tcfg, jp, tp = llama
    ids = np.concatenate([_prompt(7, 96, 1), _prompt(7, 96, 2)])
    one = generate(tp, tcfg, torch.from_numpy(ids), None, GenerateConfig(max_new_tokens=1))
    want = j_generate(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(ids), jax.random.key(0),
                      JGenerateConfig(max_new_tokens=1))
    np.testing.assert_array_equal(one.numpy(), np.asarray(want))
    np.testing.assert_array_equal(one.numpy(), _forward_argmax(decoder, tp, tcfg, ids, 1))
    both = generate(tp, tcfg, torch.from_numpy(ids), None, GenerateConfig(max_new_tokens=5))
    for b in range(2):
        alone = generate(tp, tcfg, torch.from_numpy(ids[b:b + 1]), None,
                         GenerateConfig(max_new_tokens=5))
        np.testing.assert_array_equal(both[b:b + 1].numpy(), alone.numpy())


def test_eos_pads_after_done(llama):
    """The second greedy token declared EOS: from its first emission on,
    every token is EOS, as in the JAX function."""
    jcfg, tcfg, jp, tp = llama
    ids = _prompt(5, 96, 3)
    probe = generate(tp, tcfg, torch.from_numpy(ids), None, GenerateConfig(max_new_tokens=4))
    eos = int(probe[0, 6])
    g = GenerateConfig(max_new_tokens=8, eos_token_id=eos)
    out = generate(tp, tcfg, torch.from_numpy(ids), None, g).numpy()[0, 5:]
    first = np.flatnonzero(out == eos)[0]
    assert first <= 1 and (out[first:] == eos).all()
    want = j_generate(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(ids), jax.random.key(0),
                      JGenerateConfig(max_new_tokens=8, eos_token_id=eos))
    np.testing.assert_array_equal(out, np.asarray(want)[0, 5:])


def test_sampling_properties(llama):
    _, tcfg, _, tp = llama
    ids = torch.from_numpy(_prompt(4, 96, 5))

    def sample(seed, **kw):
        g = GenerateConfig(max_new_tokens=8, temperature=1.0, **kw)
        return generate(tp, tcfg, ids, torch.Generator().manual_seed(seed), g)

    a, b = sample(6), sample(7)
    assert ((a >= 0) & (a < tcfg.vocab_size)).all()
    assert not torch.equal(a, b)  # the generators differ
    assert torch.equal(sample(6), a)  # the same generator, the same draws
    greedy = generate(tp, tcfg, ids, None, GenerateConfig(max_new_tokens=8))
    assert torch.equal(sample(6, top_k=1), greedy)  # top-k 1 is greedy
    assert torch.equal(sample(8, top_p=0.0), greedy)  # top-p 0 keeps the best
    nucleus = sample(9, top_k=3, top_p=0.9)
    assert ((nucleus >= 0) & (nucleus < tcfg.vocab_size)).all()


def test_run_sampling_eval_equal_to_jax(llama):
    """Batches whose continuations are the model's own greedy tokens on
    alternate rows (random elsewhere), with some labels masked: accuracy
    and prefix length between 0 and 1, equal in both packages."""
    jcfg, tcfg, jp, tp = llama
    prompt_len, max_new = 6, 5
    batches = []
    for bi in range(3):
        ids = np.random.default_rng(60 + bi).integers(1, 96, (4, 14)).astype(np.int32)
        greedy = generate(tp, tcfg, torch.from_numpy(ids[:, :prompt_len]), None,
                          GenerateConfig(max_new_tokens=max_new)).numpy()
        ids[::2, prompt_len:prompt_len + max_new] = greedy[::2, prompt_len:]
        ids[0, prompt_len + 3] = (ids[0, prompt_len + 3] + 1) % 96  # a miss mid-way
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = -100
        labels[1, prompt_len:prompt_len + 2] = -100
        batches.append({"input_ids": ids, "labels": labels})
    kw = dict(prompt_len=prompt_len, max_new_tokens=max_new, max_batches=2, seed=3)
    want = j_run_sampling_eval(jax.tree.map(jnp.asarray, jp), jcfg, iter(batches), **kw)
    got = run_sampling_eval(tp, tcfg, iter(batches), **kw)
    assert got == want
    assert 0.3 < got["gen_token_accuracy"] < 0.8 and got["gen_samples"] == 8
    assert 0 < got["gen_prefix_len"] < max_new
    assert not any(k.startswith("tool_") for k in got)  # no tokenizer given


class _CharTokenizer:
    """Token t is the character chr(31 + t): ids 1-95 spell printable ASCII."""

    def encode(self, text):
        return [ord(c) - 31 for c in text]

    def decode(self, ids):
        return "".join(chr(31 + int(t)) for t in ids)


def test_run_sampling_eval_tool_calls_equal_to_jax(llama):
    """With a tokenizer, the continuations are decoded and scored as tool
    calls where the references carry `<tool_call>` blocks: both packages
    give the same metrics. Rows whose reference holds no call count as
    matches when the prediction holds none either, so the accuracies lie
    between 0 and 1."""
    jcfg, tcfg, jp, tp = llama
    tok = _CharTokenizer()
    calls = ['<tool_call>{"name": "get_weather", "arguments": {"city": "Oslo"}}</tool_call>',
             '<tool_call>{"name": "f", "arguments": {"x": 1}}</tool_call>',
             "no call in this reference, only words and more words here",
             '```json {"name": "g", "arguments": "{\\"k\\": 2}"} ```']
    prompt_len = 6
    max_new = max(len(c) for c in calls)
    batches = []
    for bi in range(2):
        rows = []
        for ri, call in enumerate(calls):
            prompt = list(_prompt(prompt_len, 96, 80 + 4 * bi + ri)[0])
            body = tok.encode(call.ljust(max_new))
            rows.append(prompt + body)
        ids = np.asarray(rows, np.int32)
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = -100
        batches.append({"input_ids": ids, "labels": labels})
    kw = dict(prompt_len=prompt_len, max_new_tokens=max_new, max_batches=2, seed=3,
              tokenizer=tok)
    want = j_run_sampling_eval(jax.tree.map(jnp.asarray, jp), jcfg, iter(batches), **kw)
    got = run_sampling_eval(tp, tcfg, iter(batches), **kw)
    assert got == want
    assert got["tool_num_examples"] == 8
    assert got["tool_name_accuracy"] == 0.25  # the rows with no call on either side


def test_unported_arguments_raise(llama):
    _, tcfg, _, tp = llama
    ids = torch.from_numpy(_prompt(4, 96, 5))
    with pytest.raises(NotImplementedError, match="VLM"):
        generate(tp, tcfg, ids, None, GenerateConfig(max_new_tokens=2),
                 prompt_embeds=torch.zeros(1, 4, 32))

    @dataclasses.dataclass(frozen=True)
    class HetMoEConfig(decoder.TransformerConfig):
        pass

    with pytest.raises(NotImplementedError, match="heterogeneous"):
        generate(tp, HetMoEConfig(**dataclasses.asdict(tcfg)), ids, None,
                 GenerateConfig(max_new_tokens=2))
