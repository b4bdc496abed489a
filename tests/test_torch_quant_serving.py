"""Port parity of int8 KV pages (serving kv_cache_dtype="int8"), fp32 on the
CPU; the same numpy inputs and weights go to both packages.

- `quantize_kv_rows`: equal int8 payloads, scales within 1e-7 relative;
- K5's plain version (`ragged_paged_attention_ref` with `k_scales`/
  `v_scales`) against the JAX XLA reference and the Pallas kernel
  `paged_attention_quant_kernel` (interpret mode): fp32 within atol 1e-5,
  bf16 within 2e-2 of the largest magnitude (the plain version and the XLA
  reference dequantize to bf16 and round p to bf16, the Pallas kernel keeps
  fp32);
- int8 pools are 4-leaf (int8 payloads + (L, N+1, ps) fp32 scale planes at
  1.0), and the scale planes move with their pages under copy-on-write and
  defrag;
- the int8 engines (the tiny dense Llama, the MLA decoder and the
  DeepSeek-style MLA + MoE decoder) against the JAX int8 engine
  (`kv_cache_dtype="int8"`, fp linears): equal StepPlans, logits within
  1e-4, greedy tokens equal; a prefix-cache stream (shared quantized pages,
  COW) gives the JAX engine's outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mla_moe import (
    MLA_KW,
    _check_close,
    _jax_in,
    _prompts,
    _torch_in,
    deepseek_configs,
    engine_params,
    run_lockstep,
)

from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.ops.paged_attention import ragged_paged_attention_xla
from automodel_tpu.ops.pallas.ragged_paged_attention import (
    paged_attention_quant_kernel,
)
from automodel_tpu.ops.quant import quantize_kv_rows as j_quantize_kv_rows
from automodel_tpu.serving import PrefixCacheConfig as JPrefixCacheConfig
from automodel_tpu.serving import Request as JRequest
from automodel_tpu.serving import ServingConfig as JServingConfig
from automodel_tpu.serving import ServingEngine as JServingEngine
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.llm.decoder import TransformerConfig
from automodel_tpu_torch.ops.paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_ref,
)
from automodel_tpu_torch.ops.quant import dequantize_kv, quantize_kv_rows
from automodel_tpu_torch.serving import (
    PrefixCacheConfig,
    Request,
    ServingConfig,
    ServingEngine,
)
from automodel_tpu_torch.serving.kv_pages import apply_defrag, init_pool

SCALE_RTOL = 1e-7

LLAMA = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_layers=2,
             num_heads=4, num_kv_heads=2, qk_norm=True)


# -- quantize_kv_rows --------------------------------------------------------
@pytest.mark.parametrize("shape", [(9, 2, 16), (9, 16), (5, 3, 4, 8)])
def test_quantize_kv_rows_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * rng.uniform(0.01, 10, shape[:1]).reshape(
        (-1,) + (1,) * (len(shape) - 1))).astype(np.float32)
    x[0] = 0.0  # an all-zero row: scale 1e-12, payload 0
    q, s = quantize_kv_rows(torch.from_numpy(x))
    jq, js = j_quantize_kv_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=SCALE_RTOL, atol=0)
    back = dequantize_kv(q, s).numpy()
    assert np.abs(back - x).max() <= np.asarray(js).max() / 2 + 1e-6


# -- K5's plain version ------------------------------------------------------
def gqa_quant_batch(seed=0, Hkv=2, G=2, D=16, ps=4, P=5, N=16):
    """int8 pages with per-row scales; decode rows, a row of one token, rows
    on a page boundary and 2 pad rows, on trash-padded permuted tables."""
    rng = np.random.default_rng(seed)
    perm = iter(rng.permutation(N))
    lens = [ps * P, 2 * ps + 1, 3]
    tables = []
    for L in lens:
        pages = [int(next(perm)) for _ in range(-(-L // ps))]
        tables.append(pages + [N] * (P - len(pages)))
    rows = [(0, lens[0] - 1), (1, lens[1] - 1), (2, 0), (2, 2), (0, ps - 1),
            (0, ps), (1, 4), (0, -1), (1, -1)]
    pt = np.asarray([tables[i] for i, _ in rows], np.int32)
    pos = np.asarray([p for _, p in rows], np.int32)
    q = rng.normal(size=(len(rows), Hkv * G, D)).astype(np.float32)
    kp = rng.integers(-127, 128, (N + 1, ps, Hkv, D)).astype(np.int8)
    vp = rng.integers(-127, 128, (N + 1, ps, Hkv, D)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, (N + 1, ps)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, (N + 1, ps)).astype(np.float32)
    return q, kp, vp, pt, pos, ks, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,soft_cap", [(1, None), (4, 8.0)])
def test_plain_k5_matches_jax_xla_and_pallas(dtype, G, soft_cap):
    arrays = gqa_quant_batch(seed=G, G=G)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(scale=16 ** -0.5, soft_cap=soft_cap)
    q, kp, vp, pt, pos, ks, vs = [_torch_in(a, td) for a in arrays]
    got = ragged_paged_attention_ref(q, kp, vp, pt, pos, k_scales=ks,
                                     v_scales=vs, **kw)
    assert got.dtype == td
    jq, jk, jv, jpt, jpos, jks, jvs = [_jax_in(a, jd) for a in arrays]
    want_xla = ragged_paged_attention_xla(jq, jk, jv, jpt, jpos, k_scales=jks,
                                          v_scales=jvs, **kw)
    want_pallas = paged_attention_quant_kernel(jq, jk, jv, jks, jvs, jpt, jpos, **kw)
    got = got.float().numpy()
    _check_close(got, want_xla, dtype)
    _check_close(got, want_pallas, dtype)
    assert not got[arrays[4] < 0].any()
    # the dispatcher routes scales to the plain version on CPU tensors, and
    # hands windows to K5, which refuses CPU tensors
    assert np.array_equal(ragged_paged_attention(
        q, kp, vp, pt, pos, k_scales=ks, v_scales=vs, **kw).float().numpy(), got)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ragged_paged_attention(q, kp, vp, pt, pos, k_scales=ks, v_scales=vs,
                               window=3, impl="cuda", **kw)


# -- pools -------------------------------------------------------------------
def _t_cfgs():
    return (TransformerConfig(**LLAMA, dtype=torch.float32),
            TransformerConfig(**MLA_KW, mla_q_lora_rank=12, dtype=torch.float32))


def test_int8_pool_shapes_and_dtypes():
    gqa, mla = _t_cfgs()
    (k, v, ks, vs), = init_pool(gqa, [2], 8, 4, "cpu", "int8")
    assert k.shape == v.shape == (2, 9, 4, 2, 8)
    assert k.dtype == v.dtype == torch.int8
    assert ks.shape == vs.shape == (2, 9, 4) and ks.dtype == torch.float32
    assert bool((ks == 1.0).all()) and bool((vs == 1.0).all())
    (c, kr, cs, krs), = init_pool(mla, [2], 8, 4, "cpu", "int8")
    assert c.shape == (2, 9, 4, 16) and kr.shape == (2, 9, 4, 8)
    assert c.dtype == kr.dtype == torch.int8 and cs.shape == krs.shape == (2, 9, 4)
    (c, kr), = init_pool(mla, [2], 8, 4, "cpu")
    assert c.dtype == torch.float32 and c.shape == (2, 9, 4, 16)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ServingConfig(kv_cache_dtype="int4")


def test_defrag_moves_scales_with_pages():
    gqa, _ = _t_cfgs()
    (k, v, ks, vs), = init_pool(gqa, [2], 4, 2, "cpu", "int8")
    k[:, 3] = 7
    ks[:, 3] = 0.25
    (k2, _, ks2, _), = apply_defrag([(k, v, ks, vs)], torch.tensor([3, 1, 2, 0]))
    assert bool((k2[:, 0] == 7).all()) and bool((ks2[:, 0] == 0.25).all())
    assert bool((ks2[:, 1:] == 1.0).all())  # trash page and the rest untouched


@pytest.mark.parametrize("which", ["gqa", "mla"])
def test_step_cow_copies_scale_rows(which):
    """The engine's COW copy moves every pool leaf along the page axis: the
    destination page's int8 payload and scale rows equal the source's."""
    cfg = dict(zip(("gqa", "mla"), _t_cfgs()))[which]
    from automodel_tpu_torch.models.llm import decoder

    params = decoder.init(cfg, torch.Generator().manual_seed(0))
    eng = ServingEngine(params, cfg, ServingConfig(
        page_size=4, num_pages=16, max_slots=2, pages_per_slot=4,
        token_budget=8, kv_cache_dtype="int8"), device="cpu")
    a, b, sa, sb = eng.pool[0]
    a[:, 2] = 9
    sa[:, 2] = 0.125
    sb[:, 2] = 0.5

    class Plan:
        cow_src = np.asarray([2, 16], np.int32)
        cow_dst = np.asarray([5, 16], np.int32)

    eng._cow(Plan)
    a2, _, sa2, sb2 = eng.pool[0]
    assert bool((a2[:, 5] == 9).all())
    assert bool((sa2[:, 5] == 0.125).all()) and bool((sb2[:, 5] == 0.5).all())


# -- int8 engines against the JAX int8 engine --------------------------------
def _llama():
    j_cfg = j_decoder.TransformerConfig(**LLAMA, dtype=jnp.float32,
                                        remat_policy="none")
    return j_cfg, TransformerConfig(**LLAMA, dtype=torch.float32)


def _mla():
    j_cfg = j_decoder.TransformerConfig(**MLA_KW, mla_q_lora_rank=12,
                                        dtype=jnp.float32, remat_policy="none")
    return j_cfg, TransformerConfig(**MLA_KW, mla_q_lora_rank=12,
                                    dtype=torch.float32)


INT8_CASES = {
    # tests/unit/test_serving_engine.py ragged stream (the tiny Llama)
    "llama": (_llama, dict(page_size=4, num_pages=24, max_slots=3,
                           pages_per_slot=6, token_budget=8, prefill_chunk=4),
              _prompts([5, 9, 3]), [0, 0, 2], 5),
    # tests/unit/test_quant_serving.py::test_quant_mla_stream_compiles_once
    "mla": (_mla, dict(page_size=4, num_pages=20, max_slots=3, pages_per_slot=5,
                       token_budget=6, prefill_chunk=3),
            _prompts([6, 9, 4], seed0=10), [0, 1, 2], 5),
    "deepseek": (deepseek_configs, dict(page_size=4, num_pages=16, max_slots=2,
                                        pages_per_slot=4, token_budget=6,
                                        prefill_chunk=3),
                 _prompts([5, 7], seed0=40), [0, 1], 4),
}


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_engine_lockstep_matches_jax(case, monkeypatch):
    cfgs, sc, prompts, arrivals, max_new = INT8_CASES[case]
    j_cfg, t_cfg = cfgs()
    params = engine_params(j_cfg)
    je = JServingEngine(params, j_cfg, JServingConfig(**sc, kv_cache_dtype="int8"))
    te = ServingEngine(params_from_jax(jax.tree.map(np.asarray, params),
                                       device="cpu"),
                       t_cfg, ServingConfig(**sc, kv_cache_dtype="int8"),
                       device="cpu")
    assert len(te.pool[0]) == 4 and te.pool[0][0].dtype == torch.int8
    run_lockstep(je, te, prompts, arrivals, max_new, monkeypatch)


def test_int8_prefix_cache_cow_matches_jax():
    """tests/unit/test_quant_serving.py::test_quant_prefix_cache_cow_parity:
    radix hits adopt shared quantized pages (their scale rows with them) and
    COW splits them; both engines give the same outputs and counters."""
    j_cfg, t_cfg = _llama()
    params = j_decoder.init(j_cfg, jax.random.key(0))
    rng = np.random.default_rng(1)
    system = [int(t) for t in rng.integers(1, 64, (8,))]
    prompts = [system + [int(t) for t in rng.integers(1, 64, (3,))],
               system + [int(t) for t in rng.integers(1, 64, (2,))]]
    geo = dict(page_size=4, num_pages=32, max_slots=2, pages_per_slot=8,
               token_budget=8, prefill_chunk=4, kv_cache_dtype="int8")
    want = JServingEngine(params, j_cfg, JServingConfig(
        **geo, prefix_cache=JPrefixCacheConfig(enabled=True))).serve_batch(
        [JRequest(prompt=p, max_new_tokens=6, arrival=a)
         for p, a in zip(prompts, (0, 2))])
    te = ServingEngine(
        params_from_jax(jax.tree.map(np.asarray, params), device="cpu"), t_cfg,
        ServingConfig(**geo, prefix_cache=PrefixCacheConfig(enabled=True)),
        device="cpu")
    got = te.serve_batch([Request(prompt=p, max_new_tokens=6, arrival=a)
                          for p, a in zip(prompts, (0, 2))])
    assert got["outputs"] == want["outputs"]
    for key in ("steps", "prefix_hits", "cow_copies", "prefill_skipped_tokens"):
        assert got["stats"][key] == want["stats"][key], key
    assert got["stats"]["prefix_hits"] >= 1
    assert te.alloc.num_free + te.prefix.cached_pages == te.serve_cfg.num_pages
