"""Port parity of the serving slice's ops and layer pieces.

The same numpy inputs go through the JAX package and through
`automodel_tpu_torch`; everything runs in fp32 on the CPU, where only the
order of operations differs, so outputs must agree to atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.inference import generate as j_generate
from automodel_tpu.inference import sampling as j_sampling
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.models.llm import families as j_families
from automodel_tpu.ops import norms as j_norms
from automodel_tpu.ops import rope as j_rope
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.inference import generate, sampling
from automodel_tpu_torch.models.llm import decoder, families
from automodel_tpu_torch.ops import norms, rope

ATOL = 1e-5  # fp32 on both sides


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), atol=atol, rtol=0
    )


@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm(zero_centered):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    w = rng.normal(size=(48,)).astype(np.float32)
    want = j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, zero_centered)
    got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, zero_centered)
    _close(got, want)


ROPE_CASES = {
    "default": (dict(), False, 64),
    "llama3": (dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                    high_freq_factor=4.0, original_max_position_embeddings=512),
               False, 64),
    "linear": (dict(rope_type="linear", factor=4.0), False, 64),
    "interleaved": (dict(), True, 64),
    "partial": (dict(), False, 32),  # rotate 32 of 64 channels
}


@pytest.mark.parametrize("case", sorted(ROPE_CASES))
def test_rope(case):
    kw, interleaved, rot_dim = ROPE_CASES[case]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    # positions up to the slice's serving context (1024): XLA rounds the
    # llama3 blend one fp32 ulp differently in a few bands, and an angle
    # pos * inv_freq carries that ulp times pos (< 2e-6 rad here)
    pos = rng.integers(0, 1024, (2, 7)).astype(np.int32)
    j_inv = j_rope.rope_frequencies(
        rot_dim, 500000.0, j_rope.RopeScalingConfig(**kw))
    t_inv = rope.rope_frequencies(rot_dim, 500000.0, rope.RopeScalingConfig(**kw))
    np.testing.assert_allclose(t_inv.numpy(), np.asarray(j_inv), rtol=1e-6, atol=0)
    want = j_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), j_inv, interleaved)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), t_inv, interleaved)
    _close(got, want)


def test_rope_scaling_from_hf():
    hf = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}
    got = rope.RopeScalingConfig.from_hf(hf)
    want = j_rope.RopeScalingConfig.from_hf(hf)
    assert dataclasses.asdict(got) == {
        k: v for k, v in dataclasses.asdict(want).items()
        if k in dataclasses.asdict(got)
    }


LAYER_CASES = {
    "llama": dict(),
    "qk_norm_bias": dict(qk_norm=True, attention_bias=True, o_proj_bias=True),
    "post_norms_gelu_tied": dict(use_post_norms=True, activation="gelu",
                                 tie_word_embeddings=True, zero_centered_norm=True,
                                 logits_soft_cap=5.0, embed_scale=2.0),
    "qk_norm_flat_interleaved": dict(qk_norm_flat=True, rope_interleaved=True,
                                     partial_rotary_factor=0.5),
}


def _cfgs(**kw):
    base = dict(vocab_size=96, hidden_size=64, intermediate_size=80,
                num_layers=2, num_heads=4, num_kv_heads=2, **kw)
    return (
        j_decoder.TransformerConfig(**base, dtype=jnp.float32, remat_policy="none"),
        decoder.TransformerConfig(**base, dtype=torch.float32),
    )


def _randomize(params, seed):
    """Numpy copy of `params` whose constant leaves (norm scales of ones,
    zero biases and sinks) become random around their init value, so they
    are exercised too; the random kernels keep their fan-in scale."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        p = np.asarray(p)
        if np.all(p == p.flat[0]):
            return (p + 0.1 * rng.normal(size=p.shape)).astype(np.float32)
        return p

    return jax.tree.map(leaf, params)


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_pieces_on_converted_weights(case):
    """project_qkv, _dense_mlp, _embed and unembed of one layer, on weights
    converted key for key by params_from_jax."""
    jcfg, tcfg = _cfgs(**LAYER_CASES[case])
    np_params = _randomize(j_decoder.init(jcfg, jax.random.key(0)), 2)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_jax(np_params, device="cpu")
    j_lp = jax.tree.map(lambda a: a[1], jp["layers"])
    t_lp = {k: ({kk: vv[1] for kk, vv in v.items()} if isinstance(v, dict) else v[1])
            for k, v in tp["layers"].items()}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 6, 64)).astype(np.float32)
    pos = rng.integers(0, 300, (1, 6)).astype(np.int32)
    j_inv = j_rope.rope_frequencies(jcfg.rope_dim, jcfg.rope_theta)
    t_inv = rope.rope_frequencies(tcfg.rope_dim, tcfg.rope_theta)

    want = j_decoder.project_qkv(jnp.asarray(x), j_lp, jcfg, jnp.asarray(pos), j_inv)
    got = decoder.project_qkv(torch.from_numpy(x), t_lp, tcfg, torch.from_numpy(pos), t_inv)
    for g, w in zip(got, want):
        _close(g, w)
    _close(generate._dense_mlp(torch.from_numpy(x), t_lp, tcfg),
           j_generate._dense_mlp(jnp.asarray(x), j_lp, jcfg))
    ids = rng.integers(0, 96, (1, 6)).astype(np.int32)
    _close(generate._embed(tp, tcfg, torch.from_numpy(ids).long()),
           j_generate._embed(jp, jcfg, jnp.asarray(ids)))
    _close(decoder.unembed(tp, tcfg, torch.from_numpy(x)),
           j_decoder.unembed(jp, jcfg, jnp.asarray(x)))


def test_init_layout_matches_jax():
    """The port's init builds the JAX tree: same keys, same shapes."""
    jcfg, tcfg = _cfgs(qk_norm=True, attention_bias=True, attention_sinks=True)
    want = jax.tree.map(lambda a: tuple(a.shape),
                        j_decoder.init(jcfg, jax.random.key(0)))
    got = decoder.init(tcfg, torch.Generator().manual_seed(0))
    flat = jax.tree.map(lambda a: tuple(a.shape), got)
    assert flat == want


@pytest.mark.parametrize("top_k,top_p", [(None, None), (5, None), (None, 0.7),
                                         (7, 0.5), (None, 0.0)])
def test_filter_logits(top_k, top_p):
    logits = np.random.default_rng(4).normal(size=(3, 40)).astype(np.float32)
    want = j_sampling.filter_logits(jnp.asarray(logits), top_k, top_p)
    got = sampling.filter_logits(torch.from_numpy(logits), top_k, top_p)
    _close(got, want)


def test_llama_config_and_windows():
    hf = {"vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
          "num_hidden_layers": 32, "num_attention_heads": 32,
          "num_key_value_heads": 8, "rope_theta": 500000.0,
          "rope_scaling": {"rope_type": "llama3", "factor": 8.0}}
    got = dataclasses.asdict(families.llama_config(hf))
    want = dataclasses.asdict(j_families.llama_config(hf))
    for k, v in got.items():
        if k == "rope_scaling":
            assert all(want[k][kk] == vv for kk, vv in v.items())
        elif k != "dtype":
            assert want[k] == v, k
    for kw in (dict(), dict(sliding_window=8),
               dict(sliding_window=8, layer_types=("sliding", "global"))):
        jcfg, tcfg = _cfgs(**kw)
        assert decoder.layer_windows(tcfg) == j_decoder.layer_windows(jcfg)
