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
    kernel_launches,
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
    # Qwen3-30B-A3B's heads on 16-token pages
    (8, 128, 128, 16, None),
    # the dense families' groups at D 128: Qwen2.5-7B's G 7, GLM-4-9B's G 16
    # (the split kernel's whole M tile), Baichuan2-7B's MHA (G 1)
    (7, 128, 128, 16, None), (16, 128, 128, 16, None), (1, 128, 128, 16, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D,Dv,ps,soft_cap", K4_CASES)
def test_k4_matches_plain_version(card, dtype, G, D, Dv, ps, soft_cap):
    args = _batch(card, dtype, G, D, Dv, ps)
    n0 = kernel_launches()["K4"]
    got = ragged_paged_attention_cuda(*args, scale=D ** -0.5, soft_cap=soft_cap)
    torch.cuda.synchronize()
    assert kernel_launches()["K4"] == n0 + 1
    want = ragged_paged_attention_ref(*args, scale=D ** -0.5, soft_cap=soft_cap)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert not got[args[4] < 0].any()


# kernel, G, D, Dv, page size, soft cap, window, sinks: windows that start
# mid-split and mid-page (no multiple of the page or of the 128-kv split),
# sinks alone and with a window and the cap; Gemma-2-2B's heads (G 2, D 256)
# and gpt-oss-20b's (G 8, D 64, window 128, sinks)
K45_WINDOW_CASES = {
    "k4_window_mid_split": ("K4", 4, 128, 128, 16, None, 100, False),
    "k4_window_ps8_cap": ("K4", 1, 64, 64, 8, 30.0, 77, False),
    "k4_sinks": ("K4", 8, 64, 64, 16, None, 0, True),
    "k4_gemma2_window_cap": ("K4", 2, 256, 256, 16, 50.0, 129, False),
    "k4_gpt_oss_window_sinks": ("K4", 8, 64, 64, 16, None, 128, True),
    "k5_window_sinks_cap": ("K5", 3, 72, 40, 16, 20.0, 129, True),
    "k5_window_mid_split": ("K5", 4, 128, 128, 16, None, 100, False),
    "k5_qwen3_moe": ("K5", 8, 128, 128, 16, None, 0, False),
}


def _window_batch(card, dtype, G, D, Dv, ps, quant, seed=0):
    """Three requests of 333, 150 and 1 tokens, each with a decode row and a
    row halfway, and a pad row; int8 pages with per-row scales for K5."""
    rng = np.random.default_rng(seed)
    Hkv, contexts = 2, (333, 150, 1)
    P = -(-max(contexts) // ps)
    N = P * len(contexts)
    perm = iter(rng.permutation(N))
    tables, pos = [], []
    for n in contexts:
        pages = [int(next(perm)) for _ in range(-(-n // ps))]
        tables += [pages + [N] * (P - len(pages))] * 2
        pos += [n - 1, (n - 1) // 2]
    tables.append(tables[0])
    pos.append(-1)
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(len(pos), Hkv * G, D, generator=gen, device=card).to(dtype)
    pt = torch.tensor(tables, dtype=torch.int32, device=card)
    pos = torch.tensor(pos, dtype=torch.int32, device=card)
    if not quant:
        kp = torch.randn(N + 1, ps, Hkv, D, generator=gen, device=card).to(dtype)
        vp = torch.randn(N + 1, ps, Hkv, Dv, generator=gen, device=card).to(dtype)
        return (q, kp, vp, pt, pos), {}
    pages = [torch.randint(-127, 128, (N + 1, ps, Hkv, d), generator=gen, device=card,
                           dtype=torch.int32).to(torch.int8) for d in (D, Dv)]
    scales = [0.002 + 0.03 * torch.rand(N + 1, ps, generator=gen, device=card)
              for _ in range(2)]
    return (q, *pages, pt, pos), dict(k_scales=scales[0], v_scales=scales[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(K45_WINDOW_CASES))
def test_k4_k5_windows_and_sinks_match_plain_version(card, dtype, case):
    from automodel_tpu_torch.ops.cuda.ragged_paged_attention import (
        ragged_paged_attention_quant_cuda,
    )

    kernel, G, D, Dv, ps, soft_cap, window, with_sinks = K45_WINDOW_CASES[case]
    args, scales = _window_batch(card, dtype, G, D, Dv, ps, kernel == "K5")
    q, kp, vp, pt, pos = args
    sinks = (torch.randn(q.shape[1], generator=torch.Generator(device=card).manual_seed(1),
                         device=card) + 3.0) if with_sinks else None
    kw = dict(scale=D ** -0.5, soft_cap=soft_cap, window=window or None, sinks=sinks)
    fn, call_args = (ragged_paged_attention_cuda, args) if kernel == "K4" else (
        ragged_paged_attention_quant_cuda,
        (q, kp, vp, scales["k_scales"], scales["v_scales"], pt, pos))
    n0 = kernel_launches()[kernel]
    got = fn(*call_args, **kw)
    torch.cuda.synchronize()
    assert kernel_launches()[kernel] == n0 + 1
    want = ragged_paged_attention_ref(*args, **kw, **scales).float()
    # held to the plain result's own largest value and root mean square (an
    # output averaged over many kv rows is small), and the plain version
    # without the window, or the sinks, lies well outside that
    tol = PAGED_TOL[dtype]
    diff = got.float() - want
    assert diff.abs().max().item() <= tol * want.abs().max().item()
    assert diff.norm().item() <= tol * want.norm().item()
    for knob in [k for k, on in (("window", window), ("sinks", with_sinks)) if on]:
        off = ragged_paged_attention_ref(*args, **dict(kw, **{knob: None}), **scales)
        assert (off.float() - want).norm().item() > 3 * tol * want.norm().item(), knob
    assert not got[pos < 0].any()
    with pytest.raises(ValueError, match="window"):
        fn(*call_args, **dict(kw, window=0))


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
    n0 = kernel_launches()["K4"]
    with pytest.raises(RuntimeError, match="launch failed"):
        ragged_paged_attention_cuda(q, kp, vp, pt, pos, scale=0.1)
    assert kernel_launches()["K4"] == n0


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
    # GLM-4-9B's G 16 and Qwen2.5-7B's G 7 on its int8 pool
    (16, 128, 16, None), (7, 128, 16, None),
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
    n0 = kernel_launches()["K5"]
    got = ragged_paged_attention_quant_cuda(q, kp, vp, ks, vs, pt, pos, **kw)
    torch.cuda.synchronize()
    assert kernel_launches()["K5"] == n0 + 1
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
    kernel = "K7" if quant else "K6"
    n0 = mla.kernel_launches()[kernel]
    got = fn(q_abs, q_rope, c, kr, *extra, pt, pos, scale=scale)
    torch.cuda.synchronize()
    assert mla.kernel_launches()[kernel] == n0 + 1 and got.dtype == dtype
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


def _many_heads_case(card, n, quant, dtype):
    """K6 (quant False) or K7 at n heads x r 512, dr 64, queries in `dtype`:
    (kernel output, plain output, positions)."""
    from automodel_tpu_torch.ops.cuda import paged_mla_attention as mla

    pt, pos = _paged_rows(card, 16, seed=7)
    gen = torch.Generator(device=card).manual_seed(8)
    T, r, dr, N = len(pos), 512, 64, 40
    q_abs = torch.randn(T, n, r, generator=gen, device=card).to(dtype)
    q_rope = torch.randn(T, n, dr, generator=gen, device=card).to(dtype)
    scale = (128 + 64) ** -0.5
    if quant:
        c, cs = _int8_pages(gen, card, N + 1, 16, r)
        kr, krs = _int8_pages(gen, card, N + 1, 16, dr)
        got = mla.paged_mla_attention_quant_cuda(q_abs, q_rope, c, kr, cs, krs,
                                                 pt, pos, scale=scale)
        plain = dict(c_scales=cs, kr_scales=krs)
    else:
        c = torch.randn(N + 1, 16, r, generator=gen, device=card).to(dtype)
        kr = torch.randn(N + 1, 16, dr, generator=gen, device=card).to(dtype)
        got = mla.paged_mla_attention_cuda(q_abs, q_rope, c, kr, pt, pos,
                                           scale=scale)
        plain = {}
    torch.cuda.synchronize()
    want = ragged_paged_mla_attention_ref(q_abs, q_rope, c, kr, pt, pos,
                                          scale=scale, **plain)
    return got, want, pos


@pytest.mark.parametrize("quant", [False, True], ids=["k6", "k7"])
@pytest.mark.parametrize("n", [64, 128], ids=["kimi_k2", "deepseek_v3"])
def test_split_route_takes_many_heads(card, n, quant):
    """The bf16 route of K6 and K7 tiles heads by 16 over the grid: 64 and
    128 heads x r 512, dr 64."""
    got, want, pos = _many_heads_case(card, n, quant, torch.bfloat16)
    assert _rel_err(got, want) <= PAGED_TOL[torch.bfloat16]
    assert not got[pos < 0].any()


@pytest.mark.parametrize("quant", [False, True], ids=["k6", "k7"])
@pytest.mark.parametrize("n", [64, 128], ids=["kimi_k2", "deepseek_v3"])
def test_fp32_route_takes_many_heads(card, n, quant):
    """The fp32 route of K6 and K7 tiles heads by 16384 / r over the grid:
    64 and 128 heads x r 512 take 2 and 4 blocks a row."""
    from automodel_tpu_torch.ops.cuda import paged_mla_attention as mla

    assert -(-n // mla.head_tile(n, 512)) == n // 32
    got, want, pos = _many_heads_case(card, n, quant, torch.float32)
    assert _rel_err(got, want) <= PAGED_TOL[torch.float32]
    assert not got[pos < 0].any()


def _launched(fn, counts) -> dict:
    """The device kernels one call of `fn` launched, with how often, as the
    library's C dispatch counts them (`counts`: the module's
    `launch_counts`). The first call builds the library and is not read."""
    fn()  # the build
    before = counts()
    fn()
    after = counts()
    return {name: n - before[name] for name, n in after.items() if n != before[name]}


def _assert_route(fn, want, counts):
    """`fn()` launches the device kernels `want` names, once each, and none
    of the others that `counts` (the module's `launch_counts`) keys."""
    assert _launched(fn, counts) == dict.fromkeys(want, 1)


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
                  mla.KERNELS["K7"][mla.route(dtype)], mla.launch_counts)


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
        mla.KERNELS["K6"][mla.route(dtype)], mla.launch_counts)


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
        rpa.KERNELS["K5"][rpa.route(dtype)], rpa.launch_counts)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,D,Dv,ps,soft_cap", K4_CASES)
def test_k4_route_follows_dtype(card, dtype, G, D, Dv, ps, soft_cap):
    """bf16 K4 launches the split kernel and its combine over bf16 pages,
    fp32 K4 the CUDA-core kernel, and none of K5's kernels."""
    from automodel_tpu_torch.ops.cuda import ragged_paged_attention as rpa

    args = _batch(card, dtype, G, D, Dv, ps)
    _assert_route(lambda: rpa.ragged_paged_attention_cuda(
        *args, scale=D ** -0.5, soft_cap=soft_cap),
        rpa.KERNELS["K4"][rpa.route(dtype)], rpa.launch_counts)


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
    with pytest.raises(NotImplementedError):  # one head's r past a block
        wide = 2 * 16384
        mla.paged_mla_attention_cuda(torch.zeros(len(pos), 1, wide, device=card),
                                     torch.zeros(len(pos), 1, 16, device=card),
                                     torch.zeros(41, 16, wide, device=card), kr,
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
        launches, kernel = mla.kernel_launches, "K7" if kv else "K6"
    else:
        cfg = decoder.TransformerConfig(
            vocab_size=256, hidden_size=128, intermediate_size=192, num_layers=2,
            num_heads=4, num_kv_heads=2, dtype=torch.float32)
        params = decoder.init(cfg, torch.Generator(device=card).manual_seed(0))
        launches, kernel = rpa.kernel_launches, "K5" if kv else "K4"
    sc = ServingConfig(page_size=4, num_pages=32, max_slots=3, pages_per_slot=8,
                       token_budget=8, prefill_chunk=4, kv_cache_dtype=kv)
    outs = []
    for impl in ("cuda", "torch"):
        engine = ServingEngine(params, cfg, sc, attn_impl=impl)
        reqs = [Request(prompt=list(range(1 + i, 9 + 3 * i)), max_new_tokens=5,
                        arrival=i) for i in range(4)]
        n0 = launches()[kernel]
        res = engine.serve_batch(reqs)
        outs.append(res["outputs"])
        launched = launches()[kernel] - n0
        assert launched == (cfg.num_layers * res["stats"]["steps"] if impl == "cuda" else 0)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("sinks", [False, True])
@pytest.mark.parametrize("kv", [None, "int8"])
def test_windowed_engine_kernels_match_plain_version(card, kv, sinks):
    """A tiny Gemma-2 engine (one sliding layer with a window of 5, one
    global; soft caps) on the card, fp32, prompts longer than the window,
    with sink logits added to its layers or not: greedy outputs with K4 / K5
    equal those with the plain version, and every layer of every step
    launched the kernel (the global layer too, with no window)."""
    from automodel_tpu_torch.models.llm.families import gemma2_config
    from automodel_tpu_torch.ops.cuda import ragged_paged_attention as rpa

    cfg = gemma2_config(dict(
        vocab_size=256, hidden_size=128, intermediate_size=192, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=32, sliding_window=5,
        attn_logit_softcapping=20.0, final_logit_softcapping=15.0,
        query_pre_attn_scalar=32), dtype=torch.float32)
    assert decoder.layer_windows(cfg) == (5, None)
    gen = torch.Generator(device=card).manual_seed(0)
    params = decoder.init(cfg, gen)
    if sinks:
        params["layers"]["sinks"] = torch.randn(2, 4, generator=gen, device=card)
    kernel = "K5" if kv else "K4"
    sc = ServingConfig(page_size=4, num_pages=48, max_slots=3, pages_per_slot=10,
                       token_budget=8, prefill_chunk=4, kv_cache_dtype=kv)
    outs = []
    for impl in ("cuda", "torch"):
        engine = ServingEngine(params, cfg, sc, attn_impl=impl)
        reqs = [Request(prompt=list(range(1 + i, 12 + 3 * i)), max_new_tokens=6,
                        arrival=i) for i in range(4)]
        n0 = rpa.kernel_launches()[kernel]
        res = engine.serve_batch(reqs)
        outs.append(res["outputs"])
        launched = rpa.kernel_launches()[kernel] - n0
        assert launched == (cfg.num_layers * res["stats"]["steps"] if impl == "cuda" else 0)
    assert outs[0] == outs[1]


def test_checkpointer_pins_within_its_limit_and_frees_on_close(card, tmp_path,
                                                                monkeypatch):
    """An async save of a state on the card copies into host buffers that
    are page-locked up to the process's limit and pageable past it; the
    step restores bit-equal, and `close()` frees the buffers and their
    share of the limit."""
    from automodel_tpu_torch.checkpoint import CheckpointingConfig
    from automodel_tpu_torch.utils import host_buffers

    ck = CheckpointingConfig(checkpoint_dir=str(tmp_path), async_save=True).build()
    in_use = host_buffers.pinned_in_use()
    # room for one of the two tensors
    monkeypatch.setattr(host_buffers, "PINNED_LIMIT", in_use + 4096)
    gen = torch.Generator(device=card).manual_seed(0)
    state = {k: torch.randn(1024, generator=gen, device=card) for k in ("a", "b")}
    assert ck.save(1, state)
    ck.wait()
    assert sorted(b.is_pinned() for b in ck._buffers.bufs.values()) == [False, True]
    assert ck.last_save["pinned_bytes"] == 4096
    assert host_buffers.pinned_in_use() == in_use + 4096
    live = {k: torch.zeros_like(v) for k, v in state.items()}
    restored = ck.restore(live, step=1)
    assert all(torch.equal(restored[k], state[k]) and restored[k].is_cuda for k in state)
    ck.close()
    assert not ck._buffers.bufs and host_buffers.pinned_in_use() == in_use


def test_rollback_and_checkpointer_share_one_pinned_budget(card, tmp_path, monkeypatch):
    """The rollback manager's snapshots and the checkpointer's saves draw on
    one page-locked budget: with room for one tensor, the snapshot pins
    and the save that follows stays pageable; the snapshot restores in
    place."""
    from automodel_tpu_torch.checkpoint import CheckpointingConfig
    from automodel_tpu_torch.resilience import RollbackManager
    from automodel_tpu_torch.utils import host_buffers

    monkeypatch.setattr(host_buffers, "PINNED_LIMIT", host_buffers.pinned_in_use() + 4096)
    gen = torch.Generator(device=card).manual_seed(0)
    state = {"w": torch.randn(1024, generator=gen, device=card)}
    want = state["w"].clone()
    rb = RollbackManager(every_steps=1)
    rb.snapshot(0, state)
    assert rb.last_snapshot["pinned_bytes"] == 4096
    ck = CheckpointingConfig(checkpoint_dir=str(tmp_path), async_save=False).build()
    assert ck.save(1, state)
    assert ck.last_save["pinned_bytes"] == 0
    assert [b.is_pinned() for b in ck._buffers.bufs.values()] == [False]
    state["w"].add_(1.0)
    _, restored = rb.rollback(1, "nonfinite")
    assert restored["w"] is state["w"] and torch.equal(state["w"], want)


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
    # the bidirectional encoder's heads (G 4 x D 64) with no mask at all, and
    # over pad segments; Qwen2.5-7B's causal G 7 at D 128
    "bidirectional_gqa4_d64": (4, 512, 512, 8, 2, 64, False, False, None, {}),
    "bidirectional_gqa4_segments": (2, 300, 300, 8, 2, 64, False, True, None, {}),
    "causal_gqa7_d128": (1, 600, 600, 7, 1, 128, True, False, None, {}),
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
    n = fa_cuda.kernel_launches()
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
    assert fa_cuda.kernel_launches() == {k: c + 1 for k, c in n.items()}


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
    n = fa_cuda.kernel_launches()
    k1_k3()
    assert fa_cuda.kernel_launches() == {k: c + 1 for k, c in n.items()}
    _assert_route(k1_k3, fa_cuda.KERNELS[fa_cuda.route(dtype)], fa_cuda.launch_counts)


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

    launched = _launched(step, lambda: fa_cuda.launch_counts(by_head_dims=True))
    assert launched == {(name, (256, 256)): 1
                        for name in fa_cuda.KERNELS[fa_cuda.route(dtype)]}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dims", [(8, 8), (32, 32), (96, 96), (64, 96)])
def test_flash_padded_head_dims_match_plain_attention(card, dtype, dims):
    """Head dims K1-K3 are not instantiated for run zero-padded to the
    smallest pair that holds them (8 -> 16, 32 -> 64, 96 -> 128, (64, 96)
    -> (128, 128)), with a window, sinks and packed segments: output and
    gradients against autograd through the plain einsum attention in fp32,
    and one launch of each of the route's kernels at the padded pair."""
    from automodel_tpu_torch.ops.attention import dot_product_attention
    from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

    q, k, v, dout, seg = _fa_inputs(card, dtype, 1, 150, 150, 8, 2, dims, True)
    positions = _fa_masks(card, 1, 150, 150, True, seg, {"window": 40})[0]["positions"]
    sinks = torch.linspace(-1.0, 1.0, 8, device=card)
    grads = []
    for impl in ("flash", "xla"):
        leaves = [t.float().clone().requires_grad_() if impl == "xla"
                  else t.clone().requires_grad_() for t in (q, k, v, sinks)]
        out = dot_product_attention(*leaves[:3], segment_ids=seg,
                                    positions=positions, sliding_window=40,
                                    sinks=leaves[3], impl=impl)
        grads.append((out, torch.autograd.grad(out, leaves, dout.to(out.dtype))))
    (out_f, g_f), (out_x, g_x) = grads
    assert out_f.shape == (1, 150, 8, dims[1])
    assert _rel_err(out_f, out_x) <= FA_TOL[dtype]
    for a, b in zip(g_f, g_x):
        assert a.shape == b.shape and _rel_err(a, b) <= FA_TOL[dtype]

    def step():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = dot_product_attention(*leaves, sliding_window=40)
        torch.autograd.grad(out, leaves, dout)

    launched = _launched(step, lambda: fa_cuda.launch_counts(by_head_dims=True))
    padded = fa_cuda.padded_head_dims(*dims)
    assert launched == {(name, padded): 1
                        for name in fa_cuda.KERNELS[fa_cuda.route(dtype)]}


# the heterogeneous MoE engine's and Gemma-4's attention calls: B, S, Hq,
# Hkv, (q/k, v) head dims, window, sinks, explicit scale
HET_FA_CASES = {
    # MiMo-V2-Flash's sliding layers: G 8, q/k 192, v 128, window 128, sinks
    "mimo_sliding": (1, 400, 16, 2, (192, 128), 128, True, None),
    # its global layers: G 16, no window, no sinks
    "mimo_global": (1, 300, 16, 1, (192, 128), None, False, None),
    # Gemma-4 26B-A4B's heads (16 / 8 of 256) at the query_pre_attn_scalar
    # scale, and a window
    "gemma4_sliding": (1, 300, 16, 8, (256, 256), 128, False, 256 ** -0.5),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(HET_FA_CASES))
def test_flash_het_geometries_match_plain_attention(card, dtype, case):
    """K1-K3 through the autograd path at the geometries of MiMo's and
    Gemma-4's layers (packed documents, positions restarting): output and
    the q, k, v and sinks gradients against autograd through the plain
    einsum attention in fp32, and one launch of each of the route's
    kernels at the pair's own instantiation (no padding)."""
    from automodel_tpu_torch.ops.attention import dot_product_attention
    from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

    B, S, Hq, Hkv, dims, window, with_sinks, scale = HET_FA_CASES[case]
    q, k, v, dout, seg = _fa_inputs(card, dtype, B, S, S, Hq, Hkv, dims, True)
    positions = _fa_masks(card, B, S, S, True, seg, {"window": window})[0]["positions"]
    # sinks around 1: each takes a share of its row's mass
    sinks = torch.linspace(0.0, 2.0, Hq, device=card) if with_sinks else None
    kw = dict(segment_ids=seg, positions=positions, sliding_window=window, scale=scale)
    grads = []
    for impl in ("flash", "xla"):
        leaves = [t.float().clone().requires_grad_() if impl == "xla"
                  else t.clone().requires_grad_() for t in (q, k, v)]
        if sinks is not None:
            leaves.append(sinks.clone().requires_grad_())
        out = dot_product_attention(*leaves[:3], sinks=leaves[3] if sinks is not None
                                    else None, impl=impl, **kw)
        grads.append((out, torch.autograd.grad(out, leaves, dout.to(out.dtype))))
    (out_f, g_f), (out_x, g_x) = grads
    assert out_f.shape == (B, S, Hq, dims[1])
    assert _rel_err(out_f, out_x) <= FA_TOL[dtype]
    for a, b in zip(g_f, g_x):
        assert a.shape == b.shape and _rel_err(a, b) <= FA_TOL[dtype]

    def step():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = dot_product_attention(*leaves, sinks=sinks, **kw)
        torch.autograd.grad(out, leaves, dout)

    assert fa_cuda.padded_head_dims(*dims) == dims
    launched = _launched(step, lambda: fa_cuda.launch_counts(by_head_dims=True))
    assert launched == {(name, dims): 1 for name in fa_cuda.KERNELS[fa_cuda.route(dtype)]}


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
    # windows run on the kernels; a head dim outside HEAD_DIMS runs padded
    # (48 at 64), and the wrappers themselves take only HEAD_DIMS; above 256
    # the attention refuses
    out = dot_product_attention(q, k, v, sliding_window=16)
    assert out.shape == (1, 64, 4, 64)
    out = dot_product_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                v[..., :48].contiguous())
    assert out.shape == (1, 64, 4, 48)
    with pytest.raises(NotImplementedError, match="head dim 48"):
        fa_cuda.flash_fwd_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                               v[..., :48].contiguous(), scale=0.1)
    wide = torch.zeros((1, 64, 4, 320), dtype=q.dtype, device=card)
    with pytest.raises(NotImplementedError, match="head dims q/k 320, v 320"):
        dot_product_attention(wide, wide, wide)
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


def test_train_state_checkpoint_round_trip_on_the_card(card, tmp_path):
    """An async save of a train state on the card (snapshot into reused
    page-locked buffers, written in the background), then a restore into
    live tensors that keep their device and dtype."""
    from automodel_tpu_torch.checkpoint import CheckpointingConfig
    from automodel_tpu_torch.optim import OptimizerConfig
    from automodel_tpu_torch.training import init_train_state

    gen = torch.Generator(device=card).manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=gen, device=card),
              "e": torch.randn(16, generator=gen, device=card).to(torch.bfloat16)}
    state = init_train_state(params, OptimizerConfig(name="adamw").build())
    ck = CheckpointingConfig(checkpoint_dir=str(tmp_path / "ck"), async_save=True).build()
    assert ck.save(1, state)
    want = {k: v.detach().clone() for k, v in state.params.items()}
    with torch.no_grad():
        state.params["w"].add_(1.0)  # after the snapshot: not in step 1
    ck.wait()
    buffers = {k: v.data_ptr() for k, v in ck._buffers.bufs.items()}
    assert all(v.is_pinned() for v in ck._buffers.bufs.values())
    assert ck.save(2, state)
    ck.wait()
    assert {k: v.data_ptr() for k, v in ck._buffers.bufs.items()} == buffers
    restored = ck.restore(state, step=1)
    for k, v in restored.params.items():
        assert v.device == want[k].device and v.dtype == want[k].dtype
        assert torch.equal(v, want[k])


# -- PEFT and generate() on the card --------------------------------------------
def _lora_inputs(card, quantize=None, dora=False, L=2, H=256, O=384):
    """A stacked kernel whose columns are scaled apart, and adapters with
    nonzero b (and DoRA m off the column norm)."""
    from automodel_tpu_torch.peft import LoRAConfig, init_lora

    gen = torch.Generator(device=card).manual_seed(0)
    w = torch.randn(L, H, O, generator=gen, device=card) * torch.linspace(
        0.25, 4.0, O, device=card)
    base = {"layers": {"q_proj": {"kernel": w}}}
    cfg = LoRAConfig(r=8, alpha=16.0, target_modules=("q_proj",), dora=dora,
                     quantize_base=quantize)
    lora = init_lora(base, cfg, gen)
    for ab in lora.values():
        ab["b"].normal_(0.0, 0.1, generator=gen)
        if "m" in ab:
            ab["m"].mul_(torch.empty_like(ab["m"]).uniform_(0.5, 1.5, generator=gen))
    return base, lora, cfg


@pytest.mark.parametrize("variant", ["lora", "dora", "qlora"])
def test_lora_merge_on_card_matches_cpu(card, variant):
    """merge_lora on the card against the same merge on the CPU (fp32; the
    card's einsum and norm sum in other orders), QLoRA int8 values equal."""
    from automodel_tpu_torch.peft import merge_lora, quantize_base
    from automodel_tpu_torch.utils.tree import tree_map

    base, lora, cfg = _lora_inputs(card, quantize="int8" if variant == "qlora" else None,
                                   dora=variant == "dora")
    qb = quantize_base(base, cfg)
    cpu = lambda t: tree_map(lambda x: x.cpu(), t)
    qb_cpu = quantize_base(cpu(base), cfg)
    if variant == "qlora":
        assert torch.equal(qb["layers"]["q_proj"]["kernel"]["q8"].cpu(),
                           qb_cpu["layers"]["q_proj"]["kernel"]["q8"])
    got = merge_lora(qb, lora, cfg)["layers"]["q_proj"]["kernel"]
    want = merge_lora(qb_cpu, cpu(lora), cfg)["layers"]["q_proj"]["kernel"]
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    assert (got.cpu() - base["layers"]["q_proj"]["kernel"].cpu()).abs().max() > 1e-3


def test_generate_on_card_matches_teacher_forcing_and_engine(card):
    """Greedy generate() of a 2-layer fp32 model on the card: the same
    tokens as the forward argmax over the generated sequence (K1) and as
    serve_batch (K4)."""
    from automodel_tpu_torch.inference.generate import GenerateConfig, generate

    cfg = decoder.TransformerConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                                    num_layers=2, num_heads=4, num_kv_heads=2,
                                    head_dim=64, dtype=torch.float32)
    params = decoder.init(cfg, torch.Generator(device=card).manual_seed(3))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, n).tolist() for n in (40, 77, 130)]
    outs = [generate(params, cfg, torch.tensor([p], device=card), None,
                     GenerateConfig(max_new_tokens=12))[0, len(p):].tolist() for p in prompts]
    for p, o in zip(prompts, outs):
        logits = decoder.forward(params, cfg, torch.tensor([p + o], device=card))
        assert logits[0, len(p) - 1:-1].argmax(-1).tolist() == o
    served = ServingEngine(params, cfg, ServingConfig(page_size=16, num_pages=64)).serve_batch(
        [Request(prompt=list(p), max_new_tokens=12) for p in prompts])["outputs"]
    assert served == outs


def test_qlora_step_holds_less_memory_than_lora(card):
    """One training step of a 4-layer model with int8 base kernels peaks
    below the same step over the fp32 base (both measured from a cleared
    peak, the base already on the card)."""
    from automodel_tpu_torch.peft import LoRAConfig, init_lora, merge_lora, quantize_base
    from automodel_tpu_torch.loss import fused_linear_cross_entropy
    from automodel_tpu_torch.training import accumulate_grads

    cfg = decoder.TransformerConfig(vocab_size=4096, hidden_size=1024, intermediate_size=3072,
                                    num_layers=4, num_heads=8, num_kv_heads=2,
                                    dtype=torch.bfloat16)
    params = decoder.init(cfg, torch.Generator(device=card).manual_seed(5))
    ids = torch.randint(1, 4096, (1, 2, 512), device=card)
    batch = {"input_ids": ids, "labels": torch.roll(ids, -1, -1)}
    peaks = {}
    for name, quant in (("lora", None), ("qlora", "int8")):
        lcfg = LoRAConfig(quantize_base=quant)
        lora = init_lora(params, lcfg, torch.Generator(device=card).manual_seed(6))
        for ab in lora.values():
            ab["a"].requires_grad_()
            ab["b"].requires_grad_()
        base = quantize_base(params, lcfg)
        if quant:
            del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()

        def loss_fn(ad, mb, rng, base=base, lcfg=lcfg):
            h = decoder.forward(base, cfg, mb["input_ids"], return_hidden=True,
                                lora=ad, lora_cfg=lcfg)
            head = decoder.head_kernel(merge_lora(base, ad, lcfg, skip=("layers",)), cfg)
            return fused_linear_cross_entropy(h, head, mb["labels"])

        ce, _ = accumulate_grads(loss_fn, lora, batch)
        assert torch.isfinite(ce)
        peaks[name] = (start, torch.cuda.max_memory_allocated())
        del base, lora
    assert peaks["qlora"][1] < peaks["lora"][1], peaks


# -- quantized linears: the fp8 (_scaled_mm) and int8 (_int_mm) routes ---------
@pytest.mark.parametrize("M", [7, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("precision", ["fp8", "int8"])
def test_quantized_matmul_routes_match_plain(card, precision, dtype, M):
    """The CUDA route against the plain version on the card, the same
    operands: the forward within a rounding of the output dtype (both sum
    exact products, in another order), the bf16 backward equal, one GEMM
    launch for the route and none for the plain version. M 7 pads rows."""
    from automodel_tpu_torch.ops import quant

    gen = torch.Generator(device=card).manual_seed(1)
    K, N = 96, 48
    x = torch.randn(2, M, K, generator=gen, device=card).to(dtype)
    w = (torch.randn(K, N, generator=gen, device=card) * K ** -0.5).to(dtype)
    x[0, 0, :4] = torch.tensor([447.9, 448.0, 448.1, -448.1])
    x[0, 1, 3] = float("inf")
    cot = torch.randn(2, M, N, generator=gen, device=card)
    res = {}
    for impl in ("cuda", "torch"):
        xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
        quant.reset_launches()
        out = quant.quantized_matmul(xi, wi, precision, impl=impl)
        (out.float() * cot).sum().backward()
        res[impl] = (out.detach().float(), xi.grad, wi.grad, quant.LAUNCHES[precision])
    (got, gx, gw, n), (want, wx, ww, n_plain) = res["cuda"], res["torch"]
    assert (n, n_plain) == (1, 0) and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert (got - want).abs().max() <= tol * want.abs().max()
    assert torch.equal(gx, wx) and torch.equal(gw, ww)
    # a kernel quantized once gives the same numbers
    qk = quant.quantize_kernel(w, precision)
    assert torch.equal(quant.quantized_matmul(x, qk, precision, impl="cuda").float(), got)


def test_quantized_matmul_refuses_what_its_routes_do_not_take(card):
    from automodel_tpu_torch.ops import quant

    x = torch.randn(32, 24, device=card, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="multiples of 16"):
        quant.quantized_matmul(x, torch.randn(24, 32, device=card, dtype=torch.bfloat16),
                               "fp8")
    with pytest.raises(NotImplementedError, match="multiples of 8"):
        quant.quantized_matmul(x[:, :20], torch.randn(20, 32, device=card,
                                                      dtype=torch.bfloat16), "int8")
    with pytest.raises(ValueError, match="CUDA tensors"):
        quant.quantized_matmul(x.cpu(), torch.randn(24, 32), "int8", impl="cuda")


# -- DSA: the chunked path against the oracle in fp32 on the card ---------------
@pytest.mark.parametrize("style", ["deepseek", "glm"])
def test_dsa_chunked_matches_oracle_fp32_on_card(card, style):
    """A tiny DSA layer at S 256, top-k 24 (below the admissible count of
    most queries), two packed documents: the chunked path (query block 32)
    against the oracle, output within 1e-5 of its largest magnitude, the aux
    within 1e-5, the same keys, and the indexer's gradient only through the
    KL."""
    from automodel_tpu_torch.models.llm.decoder import TransformerConfig, init_attention_layers
    from automodel_tpu_torch.models.llm.mla import mla_sparse_attention_block
    from automodel_tpu_torch.ops.rope import rope_frequencies
    from automodel_tpu_torch.utils.tree import tree_leaves, tree_map

    extra = (dict(dsa_indexer_style="glm", dsa_index_n_heads=2) if style == "glm"
             else dict(dsa_index_n_heads=4))
    base = TransformerConfig(
        vocab_size=64, hidden_size=64, num_layers=1, num_heads=4, attention_type="mla",
        mla_q_lora_rank=32, mla_kv_lora_rank=32, mla_qk_nope_head_dim=16,
        mla_qk_rope_head_dim=16, mla_v_head_dim=16, dsa_index_topk=24,
        dsa_index_head_dim=32, dtype=torch.float32, **extra)
    gen = torch.Generator(device=card).manual_seed(2)
    lp0 = tree_map(lambda t: t[0], init_attention_layers(base, gen, 1))
    S = 256
    h = torch.randn(1, S, 64, generator=gen, device=card)
    pos = torch.cat([torch.arange(100), torch.arange(S - 100)]).to(card, torch.int32)[None]
    seg = (torch.arange(S, device=card) >= 100).to(torch.int32)[None]
    inv = rope_frequencies(base.rope_dim, base.rope_theta).to(card)
    out = {}
    for impl in ("oracle", "chunked"):
        cfg = dataclasses.replace(base, dsa_impl=impl, dsa_query_block=32)
        lp = tree_map(lambda t: t.clone().requires_grad_(), lp0)
        o, aux, sel = mla_sparse_attention_block(h, lp, cfg, pos, seg, inv)
        aux.backward()
        out[impl] = (o.detach(), aux.item(), sel, lp)
    (o_o, a_o, sel, lp_o), (o_c, a_c, idx, lp_c) = out["oracle"], out["chunked"]
    assert (o_c - o_o).abs().max() <= 1e-5 * o_o.abs().max()
    assert abs(a_c - a_o) <= 1e-5 * abs(a_o) and a_o > 0
    valid = torch.gather(sel, -1, idx)
    picked = torch.zeros_like(sel).scatter(-1, idx, valid)
    assert torch.equal(picked, sel) and int(sel.sum(-1).max()) == 24
    # the KL's target is detached: the main attention's own weights get none
    for key in ("indexer", "kv_up_proj", "o_proj"):
        g = [p.grad for p in tree_leaves(lp_c[key]) if p.grad is not None]
        assert (sum(float(t.abs().sum()) for t in g) > 0) == (key == "indexer")


# -- observability and the transfer guard on the card ---------------------------
def test_observability_on_and_off_serve_the_same_tokens(card, tmp_path):
    """A traced engine (spans, lifecycle instants, counters, a profile
    window) serves the greedy tokens of an untraced one on the card."""
    from automodel_tpu_torch.observability import ObservabilityConfig, validate_chrome_trace

    cfg = decoder.TransformerConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                                    num_layers=2, num_heads=4, num_kv_heads=2,
                                    dtype=torch.bfloat16)
    params = decoder.init(cfg, torch.Generator(device=card).manual_seed(0),
                          dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 256, (n,))] for n in (40, 9, 70, 23)]
    sc = ServingConfig(page_size=16, num_pages=64, max_slots=4, pages_per_slot=8,
                       token_budget=32)
    outs = {}
    for traced in (False, True):
        obs = ObservabilityConfig(enabled=True, profile_window=(2, 2),
                                  profile_dir=str(tmp_path / "prof")) if traced else None
        engine = ServingEngine(params, cfg, dataclasses.replace(sc, observability=obs))
        outs[traced] = engine.serve_batch([
            Request(prompt=p, max_new_tokens=12, arrival=i) for i, p in enumerate(prompts)])
    assert outs[True]["outputs"] == outs[False]["outputs"]
    reg = engine.obs.registry.snapshot()
    assert reg["serve_steps_total"] == outs[True]["stats"]["steps"]
    assert engine.obs.profiler.done
    validate_chrome_trace(engine.obs.export(str(tmp_path / "serve"))["chrome"])


@pytest.mark.parametrize("skip_nonfinite", [False, True])
def test_transfer_guard_passes_the_real_step_and_raises_on_a_planted_sync(
        card, tmp_path, skip_nonfinite):
    """`resilience.transfer_guard`: the tiny YAML's train step (K1-K3, the
    chunked CE, clipping, AdamW; with `skip_nonfinite_updates`, the update
    selected on the card and the count kept there) makes no host sync; a
    step with non-finite gradients is skipped, count included; the same
    step with an `.item()` planted inside raises."""
    from automodel_tpu_torch.config import load_yaml
    from automodel_tpu_torch.recipes.llm.train_ft import (
        TrainFinetuneRecipeForNextTokenPrediction,
    )

    node = load_yaml("examples/llm_finetune/tiny_llama_mock_smoke.yaml")
    node.set("run_dir", str(tmp_path / "run"))
    node.set("checkpoint.enabled", False)
    node.set("step_scheduler.max_steps", 3)
    node.set("skip_nonfinite_updates", skip_nonfinite)
    node.set("resilience", {"transfer_guard": True})
    recipe = TrainFinetuneRecipeForNextTokenPrediction(node)
    recipe.setup()
    batches = iter(recipe.step_scheduler)
    metrics = recipe.run_step(next(batches))  # guarded: no sync inside
    assert np.isfinite(float(metrics["loss"]))
    if skip_nonfinite:
        assert float(metrics["skipped_nonfinite"]) == 0.0
        opt = recipe.train_state.opt_state
        assert opt["count"].is_cuda and int(opt["count"]) == 1
        before = [t.clone() for t in (opt["mu"]["embed"]["embedding"],
                                      recipe.train_state.params["embed"]["embedding"])]
        with torch.no_grad():
            recipe.train_state.params["final_norm"]["scale"][0] = float("nan")
        metrics = recipe.run_step(next(batches))  # non-finite: skipped, guarded
        assert float(metrics["skipped_nonfinite"]) == 1.0 and int(opt["count"]) == 1
        assert torch.equal(opt["mu"]["embed"]["embedding"], before[0])
        assert torch.equal(recipe.train_state.params["embed"]["embedding"], before[1])
    step = recipe._train_step

    def with_item(state, batch, rng):
        state, metrics = step(state, batch, rng)
        metrics["loss"].item()
        return state, metrics

    recipe._train_step = with_item
    with pytest.raises(RuntimeError, match="synchroniz"):
        recipe.run_step(next(batches))
    assert torch.cuda.get_sync_debug_mode() == 0
