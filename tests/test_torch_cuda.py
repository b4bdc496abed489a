"""The port's hand-written kernels on the card, against their plain PyTorch
versions. Needs a CUDA device and nvcc, and skips without them. This file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import shutil

import numpy as np
import pytest
import torch

from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.ops.cuda import _build
from automodel_tpu_torch.ops.cuda.ragged_paged_attention import (
    ragged_paged_attention_cuda,
)
from automodel_tpu_torch.ops.paged_attention import ragged_paged_attention_ref
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine

pytestmark = pytest.mark.cuda

# fp32: summation order only; bf16: the plain version rounds probabilities
# and the value product to bf16, the kernel rounds once (~2 ulps at |out|~1)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        _build.nvcc()
    except FileNotFoundError:
        pytest.skip("needs nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(card, dtype, G, D, Dv, ps, seed=0):
    rng = np.random.default_rng(seed)
    Hkv, N, P = 2, 40, 6
    perm = iter(rng.permutation(N))
    tables, pos = [], []
    for n in (P * ps, ps + 3, 1):
        pages = [int(next(perm)) for _ in range(-(-n // ps))]
        tables.append(pages + [N] * (P - len(pages)))
        pos.append(n - 1)
    tables += [tables[0]] * 4 + [tables[1]] * 2
    pos += [0, ps - 1, ps, 2 * ps + 1, -1, -1]
    gen = torch.Generator(device=card).manual_seed(seed)
    T = len(pos)
    q = torch.randn(T, Hkv * G, D, generator=gen, device=card).to(dtype)
    kp = torch.randn(N + 1, ps, Hkv, D, generator=gen, device=card).to(dtype)
    vp = torch.randn(N + 1, ps, Hkv, Dv, generator=gen, device=card).to(dtype)
    pt = torch.tensor(tables, dtype=torch.int32, device=card)
    return q, kp, vp, pt, torch.tensor(pos, dtype=torch.int32, device=card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D,Dv,ps,soft_cap", [
    (1, 64, 64, 16, None), (4, 128, 128, 16, 30.0), (2, 64, 32, 8, None),
    (8, 128, 128, 32, None),
])
def test_k4_matches_plain_version(card, dtype, G, D, Dv, ps, soft_cap):
    args = _batch(card, dtype, G, D, Dv, ps)
    n0 = ragged_paged_attention_cuda.launches
    got = ragged_paged_attention_cuda(*args, scale=D ** -0.5, soft_cap=soft_cap)
    torch.cuda.synchronize()
    assert ragged_paged_attention_cuda.launches == n0 + 1
    want = ragged_paged_attention_ref(*args, scale=D ** -0.5, soft_cap=soft_cap)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert not got[args[4] < 0].any()


def test_k4_rejects_what_it_does_not_take(card):
    q, kp, vp, pt, pos = _batch(card, torch.float32, 2, 64, 64, 16)
    with pytest.raises(TypeError):
        ragged_paged_attention_cuda(q, kp, vp, pt.long(), pos, scale=0.1)
    with pytest.raises(TypeError):
        ragged_paged_attention_cuda(q.half(), kp.half(), vp.half(), pt, pos, scale=0.1)
    with pytest.raises(ValueError):
        ragged_paged_attention_cuda(q[:, :3], kp, vp, pt, pos, scale=0.1)
    with pytest.raises(ValueError):
        ragged_paged_attention_cuda(q.cpu(), kp, vp, pt, pos, scale=0.1)


def test_engine_kernel_matches_plain_version(card):
    cfg = decoder.TransformerConfig(
        vocab_size=256, hidden_size=128, intermediate_size=192, num_layers=2,
        num_heads=4, num_kv_heads=2, dtype=torch.float32)
    params = decoder.init(cfg, torch.Generator(device=card).manual_seed(0))
    sc = ServingConfig(page_size=4, num_pages=32, max_slots=3,
                       pages_per_slot=8, token_budget=8, prefill_chunk=4)
    outs = []
    for impl in ("cuda", "torch"):
        engine = ServingEngine(params, cfg, sc, attn_impl=impl)
        reqs = [Request(prompt=list(range(1 + i, 9 + 3 * i)), max_new_tokens=5,
                        arrival=i) for i in range(4)]
        outs.append(engine.serve_batch(reqs)["outputs"])
    assert outs[0] == outs[1]
