"""Port parity of ragged paged attention.

`ragged_paged_attention_ref` (the plain PyTorch version the CUDA kernel is
held to on the card) against the JAX package's XLA reference
`ragged_paged_attention_xla` and its Pallas kernel `paged_attention_kernel`
(interpret mode off the TPU), on the same numpy inputs in fp32: atol 1e-5.
Windows and sinks, which the Pallas kernel does not cover, are checked
against the XLA reference only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops.paged_attention import ragged_paged_attention_xla
from automodel_tpu.ops.pallas.ragged_paged_attention import paged_attention_kernel
from automodel_tpu_torch.ops.paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_ref,
    ragged_paged_mla_attention,
)

ATOL = 1e-5  # fp32 on both sides


def _paged_batch(seed=0, Hkv=2, G=2, D=16, Dv=None, ps=4, P=5, N=16):
    """A ragged batch as the engine builds it: 3 requests whose pages come
    from a permuted pool, each row's table a dense prefix padded with the
    trash page N; decode rows, a prefill run and 2 pad rows (pos -1)."""
    rng = np.random.default_rng(seed)
    Dv = Dv or D
    perm = iter(rng.permutation(N))
    lens = [ps * P, 2 * ps + 1, 3]  # tokens held by each request
    tables = []
    for n in lens:
        pages = [int(next(perm)) for _ in range(-(-n // ps))]
        tables.append(pages + [N] * (P - len(pages)))
    rows = [(0, lens[0] - 1), (1, lens[1] - 1), (2, 0), (2, 1), (2, 2),
            (0, 7), (0, 8), (1, 4), (0, -1), (1, -1)]
    pt = np.asarray([tables[r] for r, _ in rows], np.int32)
    pos = np.asarray([p for _, p in rows], np.int32)
    T = len(rows)
    q = rng.normal(size=(T, Hkv * G, D)).astype(np.float32)
    kp = rng.normal(size=(N + 1, ps, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(N + 1, ps, Hkv, Dv)).astype(np.float32)
    return q, kp, vp, pt, pos


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("G,D,soft_cap", [
    (1, 16, None), (2, 16, 8.0), (4, 16, None),
    (1, 64, 8.0), (2, 64, None), (4, 64, 5.0),
])
def test_ref_matches_jax_xla_and_pallas(G, D, soft_cap):
    """GQA groups 1/2/4, D=64 (not a multiple of the TPU lane width) and
    soft cap; permuted pages, trash-padded tables, pad rows."""
    q, kp, vp, pt, pos = _paged_batch(seed=G + D, G=G, D=D)
    kw = dict(scale=D ** -0.5, soft_cap=soft_cap)
    got = ragged_paged_attention_ref(*_torch(q, kp, vp, pt, pos), **kw).numpy()
    j_args = [jnp.asarray(a) for a in (q, kp, vp, pt, pos)]
    np.testing.assert_allclose(
        got, np.asarray(ragged_paged_attention_xla(*j_args, **kw)),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(paged_attention_kernel(*j_args, **kw)),
        atol=ATOL, rtol=0)
    assert not got[pos < 0].any()  # pad rows are exactly zero


@pytest.mark.parametrize("window,sinks", [(5, False), (0, False), (None, True),
                                          (3, True)])
def test_ref_window_and_sinks_match_jax_xla(window, sinks):
    q, kp, vp, pt, pos = _paged_batch(seed=7, G=2, D=16, Dv=8)
    s = np.linspace(-0.5, 0.5, q.shape[1]).astype(np.float32) if sinks else None
    got = ragged_paged_attention_ref(
        *_torch(q, kp, vp, pt, pos), scale=0.25, soft_cap=10.0,
        window=window, sinks=None if s is None else torch.from_numpy(s),
    ).numpy()
    want = ragged_paged_attention_xla(
        *[jnp.asarray(a) for a in (q, kp, vp, pt, pos)], scale=0.25,
        soft_cap=10.0, window=None if window is None else jnp.int32(window),
        sinks=None if s is None else jnp.asarray(s),
    )
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    assert not got[pos < 0].any()  # sinks must not leak mass into pad rows


def test_dispatch_on_cpu_tensors():
    """impl="auto" takes the plain version for CPU tensors; impl="cuda"
    raises for them, windows and sinks included (K4 and K5 take both);
    K6/K7 refuse windows (no MLA family has one)."""
    args = _torch(*_paged_batch(seed=9))
    want = ragged_paged_attention_ref(*args, scale=0.25)
    assert torch.equal(ragged_paged_attention(*args, scale=0.25), want)
    assert torch.equal(ragged_paged_attention(*args, scale=0.25, impl="torch"), want)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ragged_paged_attention(*args, scale=0.25, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ragged_paged_attention(*args, scale=0.25, window=4, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ragged_paged_attention(
            *args, scale=0.25, sinks=torch.zeros(args[0].shape[1]), impl="cuda")
    q, kp, _, pt, pos = args
    with pytest.raises(NotImplementedError, match="window"):
        ragged_paged_mla_attention(q, q, kp[:, :, 0], kp[:, :, 0], pt, pos,
                                   scale=0.25, window=4, impl="cuda")
    with pytest.raises(ValueError, match="Unknown"):
        ragged_paged_attention(*args, scale=0.25, impl="xla")
