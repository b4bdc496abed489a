"""Port parity of K1-K3's masks for the sliding-window families, on the CPU.

The port's `flash_attention` on CPU tensors (whose passes are the plain
versions of K1-K3, `flash_attention_ref` and `flash_attention_bwd_ref`)
against the JAX Pallas kernels run in interpret mode, on the same numpy
inputs in fp32: out, lse, dq, dk and dv with cotangents on both out and
lse, within 2e-4 (the tolerance of the JAX package's own kernel tests).
Cases: a one-sided window, a two-sided window (not causal), a window over
packed documents whose positions restart, causal masking by position with
kv positions and segment ids of their own and T != S (some q rows see no
key), and Gemma's head dim 256 with a window and soft cap and with GQA 4.
Every window here masks pairs the causal mask keeps. The kernels
themselves are held to the same plain versions in
tests/test_torch_flash_emulated_*.py and, on the card, tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops.pallas import flash_attention as j_flash
from automodel_tpu_torch.ops import flash_attention as fa

FLASH_TOL = 2e-4  # tests/unit/test_flash_attention.py's rtol/atol
BLOCKS = j_flash.BlockSizes(block_q=128, block_kv=128, block_q_dq=128,
                            block_kv_dkv=128)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FLASH_TOL, rtol=FLASH_TOL)


def _packed(S, cuts):
    seg = np.zeros((1, S), np.int32)
    pos = np.zeros((1, S), np.int32)
    bounds = [0, *cuts, S]
    for d, (a, b) in enumerate(zip(bounds, bounds[1:])):
        seg[0, a:b] = d
        pos[0, a:b] = np.arange(b - a)
    return seg, pos


CASES = {
    # S, T, Hq, Hkv, D, flash_attention keyword arguments (numpy int arrays
    # for the positions and segment ids)
    "window_one_sided": (256, 256, 4, 2, 64, dict(sliding_window=40)),
    "window_two_sided": (128, 128, 2, 1, 64, dict(causal=False, sliding_window=20,
                                                  logits_soft_cap=5.0)),
    "window_packed": (256, 256, 4, 2, 64, "packed"),
    "position_causal_t_ne_s": (128, 256, 4, 2, 64, "ring"),
    "d256_window_softcap": (128, 128, 4, 2, 256, dict(sliding_window=48,
                                                      logits_soft_cap=50.0,
                                                      scale=256 ** -0.5)),
    "d256_gqa4": (128, 128, 4, 1, 256, dict(sliding_window=64)),
}


def _case_kwargs(S, T, spec):
    if spec == "packed":
        seg, pos = _packed(S, (50, 51, 200))
        return dict(sliding_window=30, segment_ids=seg, positions=pos)
    if spec == "ring":
        # the q block at positions 20.., the kv block at 64.. whose first
        # 20 rows are another document's: causal by position, the q rows
        # below position 84 see no key, the others part of the kv block
        kv_seg = (np.arange(T) < 20).astype(np.int32)[None]
        return dict(positions=(np.arange(S) + 20).astype(np.int32)[None],
                    kv_positions=(np.arange(T) + 64).astype(np.int32)[None],
                    segment_ids=np.zeros((1, S), np.int32),
                    kv_segment_ids=kv_seg)
    return dict(spec)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_masks_match_pallas(case):
    """out, lse and every gradient of the port's flash attention on CPU
    tensors against the interpreted Pallas kernels."""
    S, T, Hq, Hkv, D, spec = CASES[case]
    kw = _case_kwargs(S, T, spec)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(1, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(1, T, Hkv, D)).astype(np.float32)
    dout = rng.normal(size=(1, S, Hq, D)).astype(np.float32)
    dlse = rng.normal(size=(1, Hq, S)).astype(np.float32)
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    tkw = {n: _t(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}

    if kw.get("sliding_window"):  # the window masks pairs the causal mask keeps
        qp = kw.get("positions", np.arange(S)[None])[0]
        assert (qp >= kw["sliding_window"]).any()

    def j_fn(q, k, v):
        return j_flash.flash_attention(q, k, v, block_sizes=BLOCKS,
                                       return_lse=True, **jkw)

    (j_out, j_lse), vjp = jax.vjp(j_fn, *(jnp.asarray(x) for x in (q, k, v)))
    j_grads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    t_out, t_lse = fa.flash_attention(*leaves, return_lse=True, **tkw)
    t_grads = torch.autograd.grad((t_out, t_lse), leaves, (_t(dout), _t(dlse)))
    if spec == "ring":
        assert (t_lse == fa.NEG_INF).any()  # rows that see no key
    _close(t_out, j_out)
    _close(t_lse, j_lse)
    for got, want in zip(t_grads, j_grads):
        _close(got, want)
