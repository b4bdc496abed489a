"""K6's and K7's CUDA source (`automodel_tpu_torch/csrc/
paged_mla_attention.cu` with `paged_split.cuh`) compiled for the CPU with
g++ against `tests/cuda_emulation/cuda_emulation.h` and held to the plain
version (`ragged_paged_mla_attention_ref`, with scales for K7) on the same
inputs: the split-KV tensor-core kernel and its combine for bf16 queries
(over int8 pages for K7, bf16 pages for K6), the CUDA-core kernel for fp32
queries (K7). The cases cover rows that span several splits, a split
boundary inside a page table, contexts that end mid-page, one-page and pad
rows, 8- and 16-token pages, zero-padded and odd widths, a latent rank
wider than one block's columns and its shared memory, Moonlight's widths,
and Kimi-K2's 64 and DeepSeek-V3's 128 heads (several head tiles).
Skips without g++."""

import ctypes
import shutil

import numpy as np
import pytest
import torch
from cuda_emulation import rewrite

from automodel_tpu_torch.ops.cuda import _build
from automodel_tpu_torch.ops.paged_attention import ragged_paged_mla_attention_ref

# as on the card (tests/test_torch_cuda.py), a share of the largest value:
# fp32 differs by summation order; bf16 by where the plain version rounds
# dequantized pages and probabilities and the kernel rounds p * cs (K7), by
# the order of sums and where each rounds its output (K6)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CASES = {
    # n, r, dr, page size, table width P, contexts (one request each)
    "multi_split_ps16": (4, 64, 16, 16, 24, (300, 16, 1)),
    "split_inside_table_ps8": (4, 32, 16, 8, 40, (203, 129, 128, 8)),
    "padded_n4_r72_dr24": (4, 72, 24, 16, 12, (150, 17)),
    "moonlight_widths": (16, 512, 64, 16, 16, (200, 1)),
    # wider than one block's columns (4 column groups, a second combine
    # pass) and than 32 kv rows of shared memory (16-row steps)
    "wide_r2048": (2, 2048, 16, 16, 12, (150, 17)),
    # row widths of no 4-byte multiple: byte-wise page copies
    "odd_widths_n3_r30_dr10": (3, 30, 10, 8, 12, (70, 9)),
}
# the bf16 route tiles heads by 16 over the grid: no bound on n * r
MANY_HEADS = {
    "kimi_k2_n64": (64, 512, 64, 16, 12, (150,)),
    "deepseek_v3_n128": (128, 512, 64, 16, 4, (40,)),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = rewrite.build(gxx, _build.CSRC / "paged_mla_attention.cu",
                       tmp_path_factory.mktemp("mla_emulated"))
    lib = ctypes.CDLL(str(so))
    lib.mla_split_workspace_floats.argtypes = [ctypes.c_int] * 6
    lib.mla_split_workspace_floats.restype = ctypes.c_longlong
    lib.mla_quant_split_forward.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p])
    lib.mla_quant_forward.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.mla_split_forward.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _inputs(case, dtype, seed=0, quant=True):
    """A ragged batch: for each request a decode row at its last position
    and a row halfway, then a pad row; int8 pages (or, without `quant`,
    pages in `dtype`) in permuted order."""
    n, r, dr, ps, P, contexts = {**CASES, **MANY_HEADS}[case]
    rng = np.random.default_rng(seed)
    N = P * len(contexts)
    perm = iter(rng.permutation(N))
    tables, pos = [], []
    for c in contexts:
        pages = [int(next(perm)) for _ in range(-(-c // ps))]
        row = pages + [N] * (P - len(pages))
        tables += [row, row]
        pos += [c - 1, (c - 1) // 2]
    tables.append(tables[0])
    pos.append(-1)
    T = len(pos)
    q_abs = torch.from_numpy(rng.standard_normal((T, n, r), np.float32)).to(dtype)
    q_rope = torch.from_numpy(rng.standard_normal((T, n, dr), np.float32)).to(dtype)
    if not quant:
        c = torch.from_numpy(rng.standard_normal((N + 1, ps, r), np.float32))
        kr = torch.from_numpy(rng.standard_normal((N + 1, ps, dr), np.float32))
        return (q_abs, q_rope, c.to(dtype), kr.to(dtype), None, None,
                torch.tensor(tables, dtype=torch.int32),
                torch.tensor(pos, dtype=torch.int32))
    c = torch.from_numpy(rng.integers(-127, 128, (N + 1, ps, r), np.int8))
    kr = torch.from_numpy(rng.integers(-127, 128, (N + 1, ps, dr), np.int8))
    cs = torch.from_numpy(rng.uniform(0.002, 0.032, (N + 1, ps)).astype(np.float32))
    krs = torch.from_numpy(rng.uniform(0.002, 0.032, (N + 1, ps)).astype(np.float32))
    return (q_abs, q_rope, c, kr, cs, krs,
            torch.tensor(tables, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32))


def _run(lib, case, dtype, quant):
    """The kernel and the plain version on `case`'s inputs: the error as a
    share of the plain result's largest magnitude (at least 1), and the
    kernel's output of the pad rows."""
    q_abs, q_rope, c, kr, cs, krs, pt, pos = _inputs(case, dtype, quant=quant)
    T, n, r = q_abs.shape
    dr, ps, P = q_rope.shape[-1], c.shape[1], pt.shape[1]
    scale = (r // 4 + dr) ** -0.5
    # garbage where the kernel must write: outputs and workspace start NaN
    out = torch.full((T, n, r), float("nan"), dtype=dtype)
    ws = torch.full((lib.mla_split_workspace_floats(T, n, r, dr, ps, P),),
                    float("nan"))
    scales = (cs, krs) if quant else ()
    ptrs = [x.data_ptr() for x in (q_abs, q_rope, c, kr, *scales, pt, pos, out)]
    if not quant:
        err = lib.mla_split_forward(*ptrs, ws.data_ptr(), T, n, r, dr, ps, P,
                                    scale, None)
    elif dtype == torch.bfloat16:
        err = lib.mla_quant_split_forward(*ptrs, ws.data_ptr(), T, n, r, dr,
                                          ps, P, scale, None)
    else:
        err = lib.mla_quant_forward(*ptrs, T, n, r, dr, ps, P, scale, 0, None)
    assert err == 0
    want = ragged_paged_mla_attention_ref(
        q_abs, q_rope, c, kr, pt, pos, scale=scale,
        **(dict(c_scales=cs, kr_scales=krs) if quant else {}))
    rel = ((out.float() - want.float()).abs().max()
           / want.float().abs().max().clamp(min=1.0)).item()
    return rel, out[pos < 0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_k7_matches_plain_version(lib, case, dtype):
    rel, pad = _run(lib, case, dtype, quant=True)
    assert rel <= TOL[dtype]
    assert not pad.any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_k6_matches_plain_version(lib, case):
    """bf16 K6: the split kernel instantiated for bf16 pages."""
    rel, pad = _run(lib, case, torch.bfloat16, quant=False)
    assert rel <= TOL[torch.bfloat16]
    assert not pad.any()


@pytest.mark.parametrize("quant", [False, True], ids=["k6", "k7"])
@pytest.mark.parametrize("case", sorted(MANY_HEADS))
def test_emulated_split_route_takes_many_heads(lib, case, quant):
    rel, pad = _run(lib, case, torch.bfloat16, quant=quant)
    assert rel <= TOL[torch.bfloat16]
    assert not pad.any()
