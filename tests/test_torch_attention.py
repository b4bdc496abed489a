"""Port parity of the attention ops of the training slice.

The same numpy inputs go through the JAX package and `automodel_tpu_torch`,
in fp32 on the CPU:

- `make_attention_mask` and `xla_attention` over the mask zoo, to 1e-5
  (only the order of operations differs);
- the port's `flash_attention`, whose passes on CPU tensors are the plain
  versions of K1-K3 (`flash_attention_ref`, `flash_attention_bwd_ref`),
  against the JAX Pallas kernels run in interpret mode: out, lse, dq, dk, dv
  and d(sinks) within 2e-4, the tolerance of the JAX package's own kernel
  tests;
- the dispatcher raises where the JAX one falls back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops import attention as j_attn
from automodel_tpu.ops import norms as j_norms
from automodel_tpu.ops.pallas import flash_attention as j_flash
from automodel_tpu_torch.ops import attention, norms
from automodel_tpu_torch.ops import flash_attention as fa
from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

ATOL = 1e-5
FLASH_TOL = 2e-4  # tests/unit/test_flash_attention.py's rtol/atol
BLOCKS = j_flash.BlockSizes(block_q=128, block_kv=128, block_q_dq=128,
                            block_kv_dkv=128)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=atol)


def _packed(S, cuts):
    seg = np.zeros((1, S), np.int32)
    pos = np.zeros((1, S), np.int32)
    bounds = [0, *cuts, S]
    for d, (a, b) in enumerate(zip(bounds, bounds[1:])):
        seg[0, a:b] = d
        pos[0, a:b] = np.arange(b - a)
    return seg, pos


MASK_CASES = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "window": dict(causal=True, sliding_window=5),
    "noncausal_window": dict(causal=False, sliding_window=4),
    "segments": dict(causal=True, packed=True),
    "softcap": dict(causal=True, logits_soft_cap=3.0),
    "sinks": dict(causal=True, sinks=True),
    "gqa4_scale": dict(causal=True, scale=0.3, Hkv=1),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_mask_and_xla_attention(case):
    kw = dict(MASK_CASES[case])
    packed = kw.pop("packed", False)
    use_sinks = kw.pop("sinks", False)
    Hkv = kw.pop("Hkv", 2)
    B, S, Hq, D = 2, 24, 4, 16
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    sinks = rng.normal(size=(Hq,)).astype(np.float32) if use_sinks else None
    seg = pos = None
    if packed:
        seg, pos = _packed(S, (7, 15))
    mkw = dict(causal=kw["causal"], sliding_window=kw.get("sliding_window"))
    jm = j_attn.make_attention_mask(
        S, S, q_segment_ids=None if seg is None else jnp.asarray(seg),
        kv_segment_ids=None if seg is None else jnp.asarray(seg),
        q_positions=None if pos is None else jnp.asarray(pos),
        kv_positions=None if pos is None else jnp.asarray(pos), **mkw)
    tm = attention.make_attention_mask(
        S, S, q_segment_ids=None if seg is None else _t(seg),
        kv_segment_ids=None if seg is None else _t(seg),
        q_positions=None if pos is None else _t(pos),
        kv_positions=None if pos is None else _t(pos), **mkw)
    if jm is None:
        assert tm is None
    else:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    akw = dict(scale=kw.get("scale"), logits_soft_cap=kw.get("logits_soft_cap"))
    want = j_attn.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm,
        sinks=None if sinks is None else jnp.asarray(sinks), **akw)
    got = attention.xla_attention(
        _t(q), _t(k), _t(v), mask=tm,
        sinks=None if sinks is None else _t(sinks), **akw)
    _close(got, want)


def test_layer_norm():
    rng = np.random.default_rng(3)
    x, w, b = (rng.normal(size=s).astype(np.float32) for s in ((3, 7, 32), (32,), (32,)))
    want = j_norms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    _close(norms.layer_norm(_t(x), _t(w), _t(b), 1e-5), want)


FLASH_CASES = {
    # S, Hq, Hkv, D, extra flash_attention kwargs (Dv: v's head dim, else D)
    "causal_gqa": (128, 4, 2, 64, {}),
    "packed_segments": (128, 4, 4, 64, {"packed": True}),
    "softcap_sinks_lse": (128, 4, 2, 64, {"logits_soft_cap": 5.0, "sinks": True}),
    # MLA's heads: q/k 192, v 128 (the Pallas kernel pads q/k to 256 lanes)
    "mla_dv_packed": (128, 2, 2, 192, {"Dv": 128, "packed": True}),
    "mla_dv_gqa_sinks": (128, 4, 2, 192, {"Dv": 128, "sinks": True}),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_pallas(case):
    """out, lse and every gradient (with cotangents on both out and lse) of
    the port's flash attention on CPU tensors against the Pallas kernels."""
    S, Hq, Hkv, D, kw = FLASH_CASES[case]
    kw = dict(kw)
    Dv = kw.pop("Dv", D)
    B = 1
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, Dv)).astype(np.float32)
    dout = rng.normal(size=(B, S, Hq, Dv)).astype(np.float32)
    dlse = rng.normal(size=(B, Hq, S)).astype(np.float32)
    sinks = rng.normal(size=(Hq,)).astype(np.float32) if kw.pop("sinks", False) else None
    call = dict(logits_soft_cap=kw.get("logits_soft_cap"))
    jcall, tcall = dict(call), dict(call)
    if kw.get("packed"):
        seg, pos = _packed(S, (40, 41, 90))
        jcall.update(segment_ids=jnp.asarray(seg), positions=jnp.asarray(pos))
        tcall.update(segment_ids=_t(seg), positions=_t(pos))

    def j_fn(q, k, v, s):
        return j_flash.flash_attention(q, k, v, sinks=s, block_sizes=BLOCKS,
                                       return_lse=True, **jcall)

    j_in = [jnp.asarray(x) for x in (q, k, v)] + [
        None if sinks is None else jnp.asarray(sinks)]
    (j_out, j_lse), vjp = jax.vjp(j_fn, *j_in)
    j_grads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))

    t_in = [_t(x).requires_grad_() for x in (q, k, v)] + [
        None if sinks is None else _t(sinks).requires_grad_()]
    t_out, t_lse = fa.flash_attention(*t_in[:3], sinks=t_in[3], return_lse=True,
                                      **tcall)
    leaves = [x for x in t_in if x is not None]
    t_grads = torch.autograd.grad((t_out, t_lse), leaves, (_t(dout), _t(dlse)))
    _close(t_out, j_out, FLASH_TOL)
    _close(t_lse, j_lse, FLASH_TOL)
    for got, want in zip(t_grads, [g for g in j_grads if g is not None]):
        _close(got, want, FLASH_TOL)


def test_fully_masked_rows_follow_the_pallas_conventions():
    """A row that sees no key: zero output, NEG_INF public lse, EMPTY_LSE
    from the plain K1, and zero gradients."""
    B, S, H, D = 1, 8, 2, 16
    rng = np.random.default_rng(2)
    q, k, v = (_t(rng.normal(size=(B, S, H, D)).astype(np.float32)) for _ in range(3))
    qp = torch.arange(S)[None] + S
    out, lse = fa.flash_attention(q, k, v, positions=torch.arange(S)[None],
                                  kv_positions=qp, return_lse=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert (lse == fa.NEG_INF).all()
    mask = torch.zeros((B, S, S), dtype=torch.bool)
    _, lse_raw = fa.flash_attention_ref(q, k, v, mask, scale=0.25)
    assert (lse_raw == fa.EMPTY_LSE).all()
    grads = fa.flash_attention_bwd_ref(q, k, v, q, lse_raw, lse_raw * 0, mask,
                                       scale=0.25)
    assert all(torch.equal(g, torch.zeros_like(g)) for g in grads)


def test_dispatcher_raises_instead_of_falling_back():
    q = torch.zeros(1, 16, 2, 32)
    k = torch.zeros(1, 16, 2, 16)
    # the JAX dispatcher catches this NotImplementedError and runs "xla"
    with pytest.raises(NotImplementedError, match="head_dim"):
        attention.dot_product_attention(q, k, k, impl="flash")
    with pytest.raises(ValueError, match="Unknown attention impl"):
        attention.dot_product_attention(q, q, q, impl="pallas")
    # what the kernels refuse, they refuse before looking at the device:
    # head-dim pairs outside HEAD_DIMS (they take every mask)
    with pytest.raises(NotImplementedError, match="head dims"):
        fa_cuda.check_supported(q, q, k)
    with pytest.raises(NotImplementedError, match="head dim 32"):
        fa_cuda.check_supported(q, q, q)
    q96 = torch.zeros(1, 16, 2, 96)
    with pytest.raises(NotImplementedError, match="head dim 96"):
        fa_cuda.check_supported(q96, q96, q96)
    # the kernel wrappers refuse it first, with a window too: no fallback
    with pytest.raises(NotImplementedError, match="head dim 96"):
        fa_cuda.flash_fwd_cuda(q96, q96, q96, scale=0.1, sliding_window=8)
    for d in (16, 64, 128, 256):
        x = torch.zeros(1, 16, 2, d)
        fa_cuda.check_supported(x, x, x)
    # "auto" on CPU tensors is the plain path, which covers windows
    out = attention.dot_product_attention(q, q, q, sliding_window=4)
    assert out.shape == q.shape
