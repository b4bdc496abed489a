"""The port's hand-written kernels on the card, against their plain PyTorch
versions. Needs a CUDA device and nvcc, and skips without them. This file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.ops.cuda import _build
from automodel_tpu_torch.ops.cuda.ragged_paged_attention import (
    ragged_paged_attention_cuda,
)
from automodel_tpu_torch.ops.paged_attention import (
    ragged_paged_attention_ref,
    ragged_paged_mla_attention_ref,
)
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


# G, D, Dv, page size, soft cap: D = Dv = 256 as in dense families with
# 256-wide heads, G 20 over two 16-head tiles of the bf16 route
K4_CASES = [
    (1, 64, 64, 16, None), (4, 128, 128, 16, 30.0), (2, 64, 32, 8, None),
    (8, 128, 128, 32, None), (2, 256, 256, 16, 30.0), (20, 64, 64, 8, 30.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D,Dv,ps,soft_cap", K4_CASES)
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
    # a bf16 shape the split route cannot launch (16 query rows of 8192
    # columns, K and V, are past shared memory) raises; nothing else runs
    # in its place
    q, kp, vp, pt, pos = _batch(card, torch.bfloat16, 16, 4096, 4096, 16)
    n0 = ragged_paged_attention_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ragged_paged_attention_cuda(q, kp, vp, pt, pos, scale=0.1)
    assert ragged_paged_attention_cuda.launches == n0


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


# K5-K7 against their plain versions, as a share of the largest magnitude of
# the plain result. fp32: summation order only. bf16: the plain versions
# round dequantized pages, probabilities and the value product to bf16; K5
# and K7 keep fp32 and round once (K6 rounds p to bf16 as its plain
# version does); 2e-2 is about two bf16 ulps at the largest value.
PAGED_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _paged_rows(card, ps, N=40, P=6, seed=0):
    """Page tables and positions of a ragged batch: three requests (a full
    table, a page and a bit, one token), decode rows, page-boundary rows
    and two pad rows."""
    rng = np.random.default_rng(seed)
    perm = iter(rng.permutation(N))
    tables, pos = [], []
    for n in (P * ps, ps + 3, 1):
        pages = [int(next(perm)) for _ in range(-(-n // ps))]
        tables.append(pages + [N] * (P - len(pages)))
        pos.append(n - 1)
    tables += [tables[0]] * 4 + [tables[1]] * 2
    pos += [0, ps - 1, ps, 2 * ps + 1, -1, -1]
    return (torch.tensor(tables, dtype=torch.int32, device=card),
            torch.tensor(pos, dtype=torch.int32, device=card))


def _int8_pages(gen, card, *shape):
    pages = torch.randint(-127, 128, shape, generator=gen, device=card,
                          dtype=torch.int32).to(torch.int8)
    scales = 0.002 + 0.03 * torch.rand(shape[:2], generator=gen, device=card)
    return pages, scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D,ps,soft_cap", [
    (1, 64, 16, None), (4, 128, 16, 30.0), (8, 128, 32, None),
    (20, 64, 8, 30.0),
])
def test_k5_matches_plain_version(card, dtype, G, D, ps, soft_cap):
    from automodel_tpu_torch.ops.cuda.ragged_paged_attention import (
        ragged_paged_attention_quant_cuda,
    )

    pt, pos = _paged_rows(card, ps)
    gen = torch.Generator(device=card).manual_seed(1)
    Hkv, N = 2, 40
    q = torch.randn(len(pos), Hkv * G, D, generator=gen, device=card).to(dtype)
    kp, ks = _int8_pages(gen, card, N + 1, ps, Hkv, D)
    vp, vs = _int8_pages(gen, card, N + 1, ps, Hkv, D)
    kw = dict(scale=D ** -0.5, soft_cap=soft_cap)
    n0 = ragged_paged_attention_quant_cuda.launches
    got = ragged_paged_attention_quant_cuda(q, kp, vp, ks, vs, pt, pos, **kw)
    torch.cuda.synchronize()
    assert ragged_paged_attention_quant_cuda.launches == n0 + 1
    assert got.dtype == dtype
    want = ragged_paged_attention_ref(q, kp, vp, pt, pos, k_scales=ks,
                                      v_scales=vs, **kw)
    assert _rel_err(got, want) <= PAGED_TOL[dtype]
    assert not got[pos < 0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["k6", "k7"])
@pytest.mark.parametrize("n,r,dr,ps", [
    (16, 512, 64, 16),   # Moonlight / DeepSeek-V3 latent widths
    (4, 32, 16, 8), (8, 128, 32, 4), (2, 16, 8, 16),
])
def test_k6_k7_match_plain_version(card, dtype, quant, n, r, dr, ps):
    from automodel_tpu_torch.ops.cuda import paged_mla_attention as mla

    pt, pos = _paged_rows(card, ps, seed=2)
    gen = torch.Generator(device=card).manual_seed(3)
    N, T = 40, len(pos)
    q_abs = torch.randn(T, n, r, generator=gen, device=card).to(dtype)
    q_rope = torch.randn(T, n, dr, generator=gen, device=card).to(dtype)
    scale = (r // 4 + dr) ** -0.5
    if quant:
        c, cs = _int8_pages(gen, card, N + 1, ps, r)
        kr, krs = _int8_pages(gen, card, N + 1, ps, dr)
        fn, extra = mla.paged_mla_attention_quant_cuda, (cs, krs)
        want = ragged_paged_mla_attention_ref(q_abs, q_rope, c, kr, pt, pos,
                                              scale=scale, c_scales=cs,
                                              kr_scales=krs)
    else:
        c = torch.randn(N + 1, ps, r, generator=gen, device=card).to(dtype)
        kr = torch.randn(N + 1, ps, dr, generator=gen, device=card).to(dtype)
        fn, extra = mla.paged_mla_attention_cuda, ()
        want = ragged_paged_mla_attention_ref(q_abs, q_rope, c, kr, pt, pos,
                                              scale=scale)
    n0 = fn.launches
    got = fn(q_abs, q_rope, c, kr, *extra, pt, pos, scale=scale)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1 and got.dtype == dtype
    assert _rel_err(got, want) <= PAGED_TOL[dtype]
    assert not got[pos < 0].any()


def _moonlight_split_case(card, context, quant):
    """bf16 queries at Moonlight's widths (n 16, r 512, dr 64, 16-token
    pages, 64-page tables) over int8 (K7) or bf16 (K6) pages: a context as
    a decode row, a prefill row halfway and a row on the last page's first
    kv, beside a pad row. Returns (kernel output, plain output, positions)."""
    from automodel_tpu_torch.ops.cuda import paged_mla_attention as mla

    n, r, dr, ps, P, N = 16, 512, 64, 16, 64, 200
    rng = np.random.default_rng(context)
    pages = [int(x) for x in rng.permutation(N)[: -(-context // ps)]]
    pt = torch.tensor([pages + [N] * (P - len(pages))] * 4, dtype=torch.int32,
                      device=card)
    pos = torch.tensor([context - 1, (context - 1) // 2,
                        (context - 1) // ps * ps, -1], dtype=torch.int32,
                       device=card)
    gen = torch.Generator(device=card).manual_seed(5)
    q_abs = torch.randn(4, n, r, generator=gen, device=card).bfloat16()
    q_rope = torch.randn(4, n, dr, generator=gen, device=card).bfloat16()
    scale = (128 + 64) ** -0.5
    if quant:
        c, cs = _int8_pages(gen, card, N + 1, ps, r)
        kr, krs = _int8_pages(gen, card, N + 1, ps, dr)
        got = mla.paged_mla_attention_quant_cuda(q_abs, q_rope, c, kr, cs, krs,
                                                 pt, pos, scale=scale)
        plain = dict(c_scales=cs, kr_scales=krs)
    else:
        c = torch.randn(N + 1, ps, r, generator=gen, device=card).bfloat16()
        kr = torch.randn(N + 1, ps, dr, generator=gen, device=card).bfloat16()
        got = mla.paged_mla_attention_cuda(q_abs, q_rope, c, kr, pt, pos,
                                           scale=scale)
        plain = {}
    torch.cuda.synchronize()
    want = ragged_paged_mla_attention_ref(q_abs, q_rope, c, kr, pt, pos,
                                          scale=scale, **plain)
    return got, want, pos


@pytest.mark.parametrize("context", [16, 128, 63 * 16],
                         ids=["one_page", "one_split", "63_pages"])
def test_k7_split_kernel_at_moonlight_widths(card, context):
    """bf16 K7 (split-KV on the tensor cores) at Moonlight's widths: a
    context of one page, of exactly one split (128 kv) and of 63 pages."""
    got, want, pos = _moonlight_split_case(card, context, quant=True)
    assert _rel_err(got, want) <= PAGED_TOL[torch.bfloat16]
    assert not got[pos < 0].any()


@pytest.mark.parametrize("context", [16, 128, 63 * 16],
                         ids=["one_page", "one_split", "63_pages"])
def test_k6_split_kernel_at_moonlight_widths(card, context):
    """bf16 K6 (the split kernel over bf16 pages) at Moonlight's widths."""
    got, want, pos = _moonlight_split_case(card, context, quant=False)
    assert _rel_err(got, want) <= PAGED_TOL[torch.bfloat16]
    assert not got[pos < 0].any()


@pytest.mark.parametrize("quant", [False, True], ids=["k6", "k7"])
@pytest.mark.parametrize("n", [64, 128], ids=["kimi_k2", "deepseek_v3"])
def test_split_route_takes_many_heads(card, n, quant):
    """The bf16 route of K6 and K7 tiles heads by 16 over the grid: 64 and
    128 heads x r 512, dr 64 (n * r past the fp32 route's 16384)."""
    from automodel_tpu_torch.ops.cuda import paged_mla_attention as mla

    pt, pos = _paged_rows(card, 16, seed=7)
    gen = torch.Generator(device=card).manual_seed(8)
    T, r, dr, N = len(pos), 512, 64, 40
    q_abs = torch.randn(T, n, r, generator=gen, device=card).bfloat16()
    q_rope = torch.randn(T, n, dr, generator=gen, device=card).bfloat16()
    scale = (128 + 64) ** -0.5
    if quant:
        c, cs = _int8_pages(gen, card, N + 1, 16, r)
        kr, krs = _int8_pages(gen, card, N + 1, 16, dr)
        got = mla.paged_mla_attention_quant_cuda(q_abs, q_rope, c, kr, cs, krs,
                                                 pt, pos, scale=scale)
        plain = dict(c_scales=cs, kr_scales=krs)
    else:
        c = torch.randn(N + 1, 16, r, generator=gen, device=card).bfloat16()
        kr = torch.randn(N + 1, 16, dr, generator=gen, device=card).bfloat16()
        got = mla.paged_mla_attention_cuda(q_abs, q_rope, c, kr, pt, pos,
                                           scale=scale)
        plain = {}
    torch.cuda.synchronize()
    want = ragged_paged_mla_attention_ref(q_abs, q_rope, c, kr, pt, pos,
                                          scale=scale, **plain)
    assert _rel_err(got, want) <= PAGED_TOL[torch.bfloat16]
    assert not got[pos < 0].any()


def _kernel_names(kernels) -> set:
    """Every device-kernel name of a module's `KERNELS` (route -> names, or
    kernel -> route -> names)."""
    if isinstance(kernels, dict):
        return {n for v in kernels.values() for n in _kernel_names(v)}
    return set(kernels)


def _profiled_names(fn) -> list:
    """The device-kernel names of one call of `fn` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def _route_names(fn, want, attempts: int = 3) -> list:
    """The device-kernel names of a profiled call of `fn` in which each of
    `want` shows up once. torch.profiler now and then loses the device
    events of a session, most often the first of a process: one warm-up
    session is thrown away, then up to `attempts` sessions are taken and
    the first complete one kept (the last one if none is)."""
    _profiled_names(fn)  # warm-up session
    for _ in range(attempts):
        names = _profiled_names(fn)
        if all(sum(kernel in name for name in names) == 1 for kernel in want):
            break
    return names


def _assert_route(fn, want, kernels):
    """`fn()` launches the device kernels `want` names, once each, and none
    of the others in `kernels` (the module's `KERNELS`)."""
    fn()  # the build
    names = _route_names(fn, want)
    for kernel in want:
        assert sum(kernel in name for name in names) == 1, (kernel, names)
    for kernel in _kernel_names(kernels) - set(want):
        assert not any(kernel in name for name in names), (kernel, names)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k7_route_follows_dtype(card, dtype):
    """K7 launches the device kernels that `route(dtype)` names and none of
    the other route's."""
    from automodel_tpu_torch.ops.cuda import paged_mla_attention as mla

    pt, pos = _paged_rows(card, 16, seed=2)
    gen = torch.Generator(device=card).manual_seed(6)
    q_abs = torch.randn(len(pos), 16, 512, generator=gen, device=card).to(dtype)
    q_rope = torch.randn(len(pos), 16, 64, generator=gen, device=card).to(dtype)
    c, cs = _int8_pages(gen, card, 41, 16, 512)
    kr, krs = _int8_pages(gen, card, 41, 16, 64)
    args = (q_abs, q_rope, c, kr, cs, krs, pt, pos)
    _assert_route(lambda: mla.paged_mla_attention_quant_cuda(*args, scale=0.07),
                  mla.KERNELS[mla.route(dtype)], mla.KERNELS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_route_follows_dtype(card, dtype):
    from automodel_tpu_torch.ops.cuda import paged_mla_attention as mla

    pt, pos = _paged_rows(card, 16, seed=2)
    gen = torch.Generator(device=card).manual_seed(6)
    q_abs = torch.randn(len(pos), 16, 512, generator=gen, device=card).to(dtype)
    q_rope = torch.randn(len(pos), 16, 64, generator=gen, device=card).to(dtype)
    c = torch.randn(41, 16, 512, generator=gen, device=card).to(dtype)
    kr = torch.randn(41, 16, 64, generator=gen, device=card).to(dtype)
    _assert_route(lambda: mla.paged_mla_attention_cuda(
        q_abs, q_rope, c, kr, pt, pos, scale=0.07),
        mla.KERNELS[mla.route(dtype)], mla.KERNELS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_route_follows_dtype(card, dtype):
    from automodel_tpu_torch.ops.cuda import ragged_paged_attention as rpa

    pt, pos = _paged_rows(card, 16, seed=2)
    gen = torch.Generator(device=card).manual_seed(6)
    q = torch.randn(len(pos), 32, 128, generator=gen, device=card).to(dtype)
    kp, ks = _int8_pages(gen, card, 41, 16, 8, 128)
    vp, vs = _int8_pages(gen, card, 41, 16, 8, 128)
    _assert_route(lambda: rpa.ragged_paged_attention_quant_cuda(
        q, kp, vp, ks, vs, pt, pos, scale=0.09),
        rpa.KERNELS["K5"][rpa.route(dtype)], rpa.KERNELS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,D,Dv,ps,soft_cap", K4_CASES)
def test_k4_route_follows_dtype(card, dtype, G, D, Dv, ps, soft_cap):
    """bf16 K4 launches the split kernel and its combine over bf16 pages,
    fp32 K4 the CUDA-core kernel, and none of K5's kernels."""
    from automodel_tpu_torch.ops.cuda import ragged_paged_attention as rpa

    args = _batch(card, dtype, G, D, Dv, ps)
    _assert_route(lambda: rpa.ragged_paged_attention_cuda(
        *args, scale=D ** -0.5, soft_cap=soft_cap),
        rpa.KERNELS["K4"][rpa.route(dtype)], rpa.KERNELS)


def test_k5_k6_k7_reject_what_they_do_not_take(card):
    from automodel_tpu_torch.ops.cuda import paged_mla_attention as mla
    from automodel_tpu_torch.ops.cuda.ragged_paged_attention import (
        ragged_paged_attention_quant_cuda,
    )

    pt, pos = _paged_rows(card, 16)
    gen = torch.Generator(device=card).manual_seed(4)
    q = torch.randn(len(pos), 4, 64, device=card)
    kp, ks = _int8_pages(gen, card, 41, 16, 2, 64)
    with pytest.raises(TypeError):  # fp pages on the int8 kernel
        ragged_paged_attention_quant_cuda(q, kp.float(), kp.float(), ks, ks,
                                          pt, pos, scale=0.1)
    with pytest.raises(ValueError):  # scales of the wrong shape
        ragged_paged_attention_quant_cuda(q, kp, kp, ks[:, :8].contiguous(), ks,
                                          pt, pos, scale=0.1)
    with pytest.raises(TypeError):
        ragged_paged_attention_quant_cuda(q, kp, kp, ks.double(), ks, pt, pos,
                                          scale=0.1)
    qa = torch.randn(len(pos), 4, 32, device=card)
    qr = torch.randn(len(pos), 4, 16, device=card)
    c = torch.randn(41, 16, 32, device=card)
    kr = torch.randn(41, 16, 16, device=card)
    with pytest.raises(TypeError):
        mla.paged_mla_attention_cuda(qa, qr.bfloat16(), c, kr, pt, pos, scale=0.1)
    with pytest.raises(ValueError):
        mla.paged_mla_attention_cuda(qa, qr, c, kr[..., :8].contiguous(), pt,
                                     pos, scale=0.1)
    with pytest.raises(NotImplementedError):  # n * r past the accumulators
        big = torch.zeros(len(pos), 128, 512, device=card)
        mla.paged_mla_attention_cuda(big, torch.zeros(len(pos), 128, 16, device=card),
                                     torch.zeros(41, 16, 512, device=card), kr,
                                     pt, pos, scale=0.1)


def _tiny_deepseek(card):
    from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
    from automodel_tpu_torch.moe.config import MoEConfig

    cfg = moe_decoder.MoETransformerConfig(
        vocab_size=256, hidden_size=128, intermediate_size=192, num_layers=2,
        num_heads=4, num_kv_heads=4, attention_type="mla", mla_q_lora_rank=48,
        mla_kv_lora_rank=64, mla_qk_nope_head_dim=32, mla_qk_rope_head_dim=16,
        mla_v_head_dim=32, first_k_dense=1, dtype=torch.float32,
        moe=MoEConfig(n_routed_experts=8, n_shared_experts=2,
                      experts_per_token=2, score_func="sigmoid",
                      route_scale=2.446, moe_intermediate_size=32,
                      gate_bias_update_speed=0.001))
    return cfg, moe_decoder.init(cfg, torch.Generator(device=card).manual_seed(0))


@pytest.mark.parametrize("model", ["deepseek", "llama"])
@pytest.mark.parametrize("kv", [None, "int8"])
def test_engines_kernels_match_plain_versions(card, model, kv):
    """The MLA + MoE engine (K6 / K7) and the dense engine (K4 / K5) on the
    card: greedy outputs with the kernels equal those with the plain
    versions, and the right kernel launched."""
    from automodel_tpu_torch.ops.cuda import paged_mla_attention as mla
    from automodel_tpu_torch.ops.cuda import ragged_paged_attention as rpa

    if model == "deepseek":
        cfg, params = _tiny_deepseek(card)
        counter = mla.paged_mla_attention_quant_cuda if kv else mla.paged_mla_attention_cuda
    else:
        cfg = decoder.TransformerConfig(
            vocab_size=256, hidden_size=128, intermediate_size=192, num_layers=2,
            num_heads=4, num_kv_heads=2, dtype=torch.float32)
        params = decoder.init(cfg, torch.Generator(device=card).manual_seed(0))
        counter = rpa.ragged_paged_attention_quant_cuda if kv else rpa.ragged_paged_attention_cuda
    sc = ServingConfig(page_size=4, num_pages=32, max_slots=3, pages_per_slot=8,
                       token_budget=8, prefill_chunk=4, kv_cache_dtype=kv)
    outs = []
    for impl in ("cuda", "torch"):
        engine = ServingEngine(params, cfg, sc, attn_impl=impl)
        reqs = [Request(prompt=list(range(1 + i, 9 + 3 * i)), max_new_tokens=5,
                        arrival=i) for i in range(4)]
        n0 = counter.launches
        res = engine.serve_batch(reqs)
        outs.append(res["outputs"])
        launched = counter.launches - n0
        assert launched == (cfg.num_layers * res["stats"]["steps"] if impl == "cuda" else 0)
    assert outs[0] == outs[1]


# K1-K3. fp32: summation order only (the kernels sum tiles online, the plain
# version in one pass). bf16: both round probabilities (K1) and ds to bf16
# before their products; K3 also rounds p for dv, which the plain version
# keeps in fp32; outputs and gradients round once to bf16; 2e-2 of the
# largest magnitude is about two bf16 ulps there.
FA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

FA_CASES = {
    # B, S, T, Hq, Hkv, D, causal, packed segments, soft cap (q is scaled so
    # that the cap bends the logits: `_capped_q`) (D: q/k and v alike, or a
    # (q/k, v) pair), masks: a window on positions, "ring" (kv positions and
    # segment ids of their own: causal by position)
    "causal_gqa_ragged": (2, 200, 200, 4, 2, 64, True, False, None, {}),
    "causal_d128_segments": (1, 192, 192, 8, 2, 128, True, True, None, {}),
    "bidirectional_softcap": (1, 96, 96, 2, 1, 64, False, False, 20.0, {}),
    "causal_s_gt_t": (1, 130, 70, 4, 4, 128, True, False, None, {}),
    "causal_d16_batch8": (8, 128, 128, 4, 2, 16, True, False, None, {}),
    # many 64-row tiles with a ragged tail, GQA 4
    "causal_d128_s1000_gqa4": (1, 1000, 1000, 8, 2, 128, True, False, None, {}),
    "causal_softcap": (1, 300, 300, 4, 2, 64, True, False, 30.0, {}),
    "causal_s_lt_t_d64": (1, 200, 330, 4, 2, 64, True, False, None, {}),
    # MLA's heads (Moonlight, DeepSeek-V3): q/k 192, v 128
    "mla_causal_segments": (1, 700, 700, 16, 16, (192, 128), True, True, None, {}),
    "mla_causal_gqa2_ragged": (2, 333, 333, 4, 2, (192, 128), True, False, None, {}),
    "mla_softcap_s_gt_t": (1, 200, 130, 2, 1, (192, 128), True, False, 25.0, {}),
    "mla_window": (1, 400, 400, 4, 2, (192, 128), True, False, None, {"window": 100}),
    # sliding windows (Mistral's 128 heads; two-sided when not causal; packed
    # documents whose positions restart)
    "window_causal_d128_gqa4": (1, 1000, 1000, 8, 2, 128, True, False, None,
                                {"window": 200}),
    "window_two_sided_softcap": (1, 300, 300, 4, 2, 64, False, False, 20.0,
                                 {"window": 64}),
    "window_packed_d64": (1, 700, 700, 4, 4, 64, True, True, None, {"window": 100}),
    # causal by position, T != S, kv segment ids of its own (ring-attention
    # shaped: the first q rows see no key)
    "ring_position_causal": (2, 200, 330, 4, 2, 64, True, False, None, {"ring": True}),
    # Gemma's head dim 256: window and soft cap (Gemma-2), GQA 4 (Gemma-3),
    # causal by position
    "d256_window_softcap": (1, 600, 600, 8, 4, 256, True, False, 50.0,
                            {"window": 128}),
    "d256_gqa4_ragged": (1, 500, 500, 4, 1, 256, True, False, None, {}),
    "d256_ring": (1, 300, 400, 2, 1, 256, True, False, None, {"ring": True}),
}


def _fa_inputs(card, dtype, B, S, T, Hq, Hkv, D, packed, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=card).to(dtype)

    D, Dv = D if isinstance(D, tuple) else (D, D)
    q, k, v = randn(B, S, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, Dv)
    dout = randn(B, S, Hq, Dv)
    seg = None
    if packed:
        cuts = torch.tensor([0, S // 3, S // 3 + 1, S - 5], device=card)
        seg = (torch.arange(S, device=card)[:, None] >= cuts).sum(-1) - 1
        seg = seg.to(torch.int32)[None].expand(B, S).contiguous()
    return q, k, v, dout, seg


def _fa_masks(card, B, S, T, causal, seg, masks):
    """The wrappers' mask keywords of a case and the plain versions' mask:
    packed documents restart their positions; a ring case puts the q rows
    at positions 40.., the kv rows at 70.. with the first 9 in a document
    of their own."""
    from automodel_tpu_torch.ops import flash_attention as fa

    return fa.mask_case(B, S, T, device=card, causal=causal, segment_ids=seg,
                        sliding_window=masks.get("window"),
                        ring=(40, 70, 9) if masks.get("ring") else None)


def _capped_q(q, cap):
    """q scaled by cap / 4 under a soft cap: the unit-variance logits at
    scale D^-0.5 then spread over a quarter of the cap, so the largest reach
    it and the cap bends them (1 - tanh^2 falls to ~0.26), far past the
    tolerance."""
    return q if cap is None else (q.float() * (cap / 4)).to(q.dtype)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_kernels_match_plain_versions(card, dtype, case):
    from automodel_tpu_torch.ops import flash_attention as fa
    from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

    B, S, T, Hq, Hkv, D, causal, packed, cap, masks = FA_CASES[case]
    q, k, v, dout, seg = _fa_inputs(card, dtype, B, S, T, Hq, Hkv, D, packed)
    q = _capped_q(q, cap)
    scale = q.shape[-1] ** -0.5
    mkw, mask = _fa_masks(card, B, S, T, causal, seg, masks)
    if masks.get("ring"):
        assert not mask.any(-1).all()  # some q rows see no key
    n = (fa_cuda.launches_fwd, fa_cuda.launches_dq, fa_cuda.launches_dkv)
    kw = dict(scale=scale, soft_cap=cap, **mkw)
    out, lse = fa_cuda.flash_fwd_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    out_ref, lse_ref = fa.flash_attention_ref(q, k, v, mask, scale=scale, soft_cap=cap)
    assert _rel_err(out, out_ref) <= FA_TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= FA_TOL[dtype]

    delta = (dout.float() * out_ref.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa_cuda.flash_dq_cuda(q, k, v, dout, lse_ref, delta, **kw)
    dk, dv = fa_cuda.flash_dkv_cuda(q, k, v, dout, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_ref(q, k, v, dout, lse_ref, delta, mask,
                                      scale=scale, soft_cap=cap)
    for got, ref in zip((dq, dk, dv), want):
        assert _rel_err(got, ref) <= FA_TOL[dtype]
    assert (fa_cuda.launches_fwd, fa_cuda.launches_dq, fa_cuda.launches_dkv) == (
        n[0] + 1, n[1] + 1, n[2] + 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_route_follows_dtype(card, dtype):
    """K1-K3 launch the device kernels that `route(dtype)` names, none of
    the other route's, and each wrapper counts its launch."""
    from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

    q, k, v, dout, _ = _fa_inputs(card, dtype, 1, 128, 128, 4, 2, 64, False)
    lse = torch.zeros((1, 4, 128), device=card)
    delta = torch.zeros_like(lse)
    kw = dict(scale=0.125)

    def k1_k3():
        fa_cuda.flash_fwd_cuda(q, k, v, **kw)
        fa_cuda.flash_dq_cuda(q, k, v, dout, lse, delta, **kw)
        fa_cuda.flash_dkv_cuda(q, k, v, dout, lse, delta, **kw)

    k1_k3()  # the build
    n = (fa_cuda.launches_fwd, fa_cuda.launches_dq, fa_cuda.launches_dkv)
    k1_k3()
    assert (fa_cuda.launches_fwd, fa_cuda.launches_dq, fa_cuda.launches_dkv) == (
        n[0] + 1, n[1] + 1, n[2] + 1)
    want = fa_cuda.KERNELS[fa_cuda.route(dtype)]
    names = _route_names(k1_k3, want)
    other = {n for r in fa_cuda.KERNELS.values() for n in r} - set(want)
    for kernel in want:
        assert sum(kernel in name for name in names) == 1, (kernel, names)
    for kernel in other:
        assert not any(kernel in name for name in names), (kernel, names)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_256_kernels_launch_through_autograd(card, dtype):
    """At head dim 256 with a window, the autograd path launches the
    <256, 256> instantiations of the dtype's route, forward and backward,
    once each."""
    from automodel_tpu_torch.ops.attention import dot_product_attention
    from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

    q, k, v, dout, _ = _fa_inputs(card, dtype, 1, 256, 256, 4, 2, 256, False)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def step():
        out = dot_product_attention(*leaves, sliding_window=64, logits_soft_cap=50.0)
        torch.autograd.grad(out, leaves, dout)

    step()  # the build
    # the tensor-core kernels' instantiation with the position code
    dims = "256, 256, true>" if dtype == torch.bfloat16 else "float, 256, 256>"
    want = [name + dims for name in fa_cuda.KERNELS[fa_cuda.route(dtype)]]
    names = _route_names(step, want)
    for kernel in want:
        assert sum(kernel in name for name in names) == 1, (kernel, names)


def test_flash_attention_on_card_matches_plain_attention(card):
    """The autograd path on the card (K1-K3, sinks and the lse cotangent in
    torch) against autograd through the plain einsum attention."""
    from automodel_tpu_torch.ops.attention import dot_product_attention
    from automodel_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, dout, seg = _fa_inputs(card, torch.float32, 2, 160, 160, 8, 2, 64, True)
    sinks = torch.linspace(-1.0, 1.0, 8, device=card)
    grads = []
    for impl in ("flash", "xla"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, sinks)]
        out = dot_product_attention(*leaves[:3], segment_ids=seg, sinks=leaves[3],
                                    impl=impl)
        grads.append((out, torch.autograd.grad(out, leaves, dout)))
    (out_f, g_f), (out_x, g_x) = grads
    assert _rel_err(out_f, out_x) <= 1e-4
    for a, b in zip(g_f, g_x):
        assert _rel_err(a, b) <= 1e-4
    # the lse output is differentiable too
    qq = q.clone().requires_grad_()
    _, lse = flash_attention(qq, k, v, return_lse=True)
    (g,) = torch.autograd.grad(lse.sum(), qq)
    assert torch.isfinite(g).all()


def test_flash_kernels_refuse_what_they_do_not_cover(card):
    from automodel_tpu_torch.ops.attention import dot_product_attention
    from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

    q, k, v, _, _ = _fa_inputs(card, torch.bfloat16, 1, 64, 64, 4, 2, 64, False)
    # windows run on the kernels; head dims outside HEAD_DIMS are refused
    out = dot_product_attention(q, k, v, sliding_window=16)
    assert out.shape == (1, 64, 4, 64)
    with pytest.raises(NotImplementedError, match="head dim"):
        dot_product_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                              v[..., :48].contiguous())
    with pytest.raises(TypeError):
        fa_cuda.flash_fwd_cuda(q.half(), k.half(), v.half(), scale=0.1)
    with pytest.raises(ValueError):
        fa_cuda.flash_fwd_cuda(q.cpu(), k, v, scale=0.1)
    with pytest.raises(ValueError, match="sliding_window"):
        fa_cuda.flash_fwd_cuda(q, k, v, scale=0.1, sliding_window=0)
    # MLA's (192, 128) pair is taken, windowed too, but no other pair with
    # Dv != D
    q, k, v, _, _ = _fa_inputs(card, torch.bfloat16, 1, 64, 64, 4, 2, (192, 128), False)
    out = dot_product_attention(q, k, v, sliding_window=16)
    assert out.shape == (1, 64, 4, 128)
    with pytest.raises(NotImplementedError, match="head dims q/k 192, v 64"):
        fa_cuda.flash_fwd_cuda(q, k, v[..., :64].contiguous(), scale=0.1)
    out = dot_product_attention(q, k, v)
    assert out.shape == (1, 64, 4, 128)


def test_flash_launch_error_raises(card):
    """A launch the card refuses (grid.y > 65535 query heads) raises instead
    of returning garbage."""
    from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

    q = torch.zeros(1, 1, 65536, 64, device=card)
    k = torch.zeros(1, 1, 1, 64, device=card)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa_cuda.flash_fwd_cuda(q, k, k, scale=0.125)


# -- the MoE layer without host reads; HF checkpoints on the card -------------
# MoE outputs against the same block run otherwise. bf16: a per-expert loop
# of the same three products through cuBLAS rounds at the same three
# points; only the order of the fp32 accumulation (and of index_add_'s
# atomic adds) differs, ~2 bf16 ulps of the largest value. fp32: summation
# order alone.
GROUPED_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _moonlight_moe(card, dtype, T=64, seed=0):
    """One Moonlight-16B-A3B MoE block (64 experts, top-6, H 2048, I 1408,
    2 shared experts, sigmoid routing with the correction bias) and T
    tokens, one in 8 masked."""
    from automodel_tpu_torch.moe.config import MoEConfig
    from automodel_tpu_torch.moe.layer import init_moe

    cfg = MoEConfig(n_routed_experts=64, n_shared_experts=2, experts_per_token=6,
                    score_func="sigmoid", route_scale=2.446, moe_intermediate_size=1408,
                    gate_bias_update_speed=0.001)
    gen = torch.Generator(device=card).manual_seed(seed)
    params = init_moe(cfg, 2048, gen, dtype)
    params["gate"]["e_score_bias"].normal_(0, 0.1, generator=gen)
    x = torch.randn(1, T, 2048, device=card, generator=gen).to(dtype)
    mask = (torch.arange(T, device=card) % 8 != 5)[None]
    return cfg, params, x, mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_layer_makes_no_host_read_at_moonlight_width(card, dtype):
    """Routing, the grouped (bf16) or batched (fp32) expert products, the
    shared experts and the combine queue without waiting for the device."""
    from automodel_tpu_torch.moe.layer import moe_forward

    cfg, params, x, mask = _moonlight_moe(card, dtype)
    want, _, _ = moe_forward(params, cfg, x, mask)  # warm-up: handles, workspaces
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _, _ = moe_forward(params, cfg, x, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # index_add_ on the card adds each token's rows in no fixed order
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GROUPED_TOL[dtype] * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_layer_backward_makes_no_host_read_at_moonlight_width(card, dtype):
    """The training path: the block's forward and backward (the gate's
    gradient, `_grouped_mm`'s own backward in bf16, the batched products'
    in fp32, index_add_ and the gathers) queue without a host read; every
    gradient is finite, the correction bias gets none."""
    from automodel_tpu_torch.moe.layer import moe_forward
    from automodel_tpu_torch.utils.tree import tree_leaves

    cfg, params, x, mask = _moonlight_moe(card, dtype, T=256)
    cfg = dataclasses.replace(cfg, aux_loss_coeff=0.01)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    x.requires_grad_()

    def step():
        out, aux, _ = moe_forward(params, cfg, x, mask)
        (out.float().square().mean() + aux).backward()

    step()  # warm-up: handles, workspaces
    torch.cuda.synchronize()
    for p in (*leaves, x):
        p.grad = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert params["gate"]["e_score_bias"].grad is None  # selection only
    for p in leaves:
        if p is not params["gate"]["e_score_bias"]:
            assert p.grad is not None and torch.isfinite(p.grad).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_expert_product_matches_per_expert_loop(card, dtype):
    import torch.nn.functional as F

    from automodel_tpu_torch.moe.experts import experts_forward_dropless
    from automodel_tpu_torch.moe.gate import gate_forward

    cfg, params, x, mask = _moonlight_moe(card, dtype, T=200, seed=1)
    flat = x[0]
    w, idx, _, _ = gate_forward(params["gate"], cfg, flat, mask[0])
    got = experts_forward_dropless(params["experts"], cfg, flat, w, idx)
    ex = params["experts"]
    want = torch.zeros_like(flat, dtype=torch.float32)
    for e in range(cfg.n_routed_experts):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            rows = flat[tok]
            h = F.silu(rows @ ex["gate_proj"]["kernel"][e]) * (rows @ ex["up_proj"]["kernel"][e])
            y = h @ ex["down_proj"]["kernel"][e]
            want.index_add_(0, tok, y.float() * w[tok, slot, None])
    err = (got.float() - want).abs().max().item()
    assert err <= GROUPED_TOL[dtype] * want.abs().max().item(), err
    assert (got[~mask[0]] == 0).all()


def test_llama_checkpoint_round_trip_on_the_card(card, tmp_path):
    """A 2-layer bf16 Llama written from the card and read back onto it:
    every tensor bit for bit."""
    from automodel_tpu_torch.checkpoint import (
        DenseDecoderAdapter,
        HFCheckpointReader,
        save_hf_checkpoint,
    )

    cfg = decoder.TransformerConfig(vocab_size=1024, hidden_size=512, intermediate_size=1408,
                                    num_layers=2, num_heads=8, num_kv_heads=2,
                                    dtype=torch.bfloat16)
    params = decoder.init(cfg, torch.Generator(device=card).manual_seed(0), torch.bfloat16)
    adapter = DenseDecoderAdapter(cfg)
    save_hf_checkpoint(adapter.to_hf(params), str(tmp_path / "ckpt"), max_shard_bytes=4 << 20)
    with HFCheckpointReader(str(tmp_path / "ckpt")) as reader:
        got = adapter.from_hf(reader, device=card, dtype=torch.bfloat16)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)])

    want = dict(leaves(params))
    have = dict(leaves(got))
    assert sorted(have) == sorted(want)
    for k, v in want.items():
        assert have[k].device.type == "cuda" and have[k].dtype == v.dtype, k
        assert torch.equal(have[k].view(torch.int16), v.view(torch.int16)), k
