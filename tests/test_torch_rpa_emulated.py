"""K5's CUDA source (`automodel_tpu_torch/csrc/ragged_paged_attention.cu`
with `paged_split.cuh`) compiled for the CPU with g++ against
`tests/cuda_emulation/cuda_emulation.h` and held to the plain version
(`ragged_paged_attention_ref` with `k_scales`/`v_scales`) on the same
inputs: the split-KV tensor-core kernel and its combine for bf16 queries,
the CUDA-core kernel for fp32 queries. The cases cover rows that span
several splits, a split boundary inside a page table, contexts that end
mid-page, one-page and pad rows, 8- and 16-token pages, G 1, 3, 4, 8 and
20 (two head tiles), D 64 and 128, Dv != D, zero-padded and odd widths,
and the soft cap on and off. Skips without g++."""

import ctypes
import shutil

import numpy as np
import pytest
import torch
from cuda_emulation import rewrite

from automodel_tpu_torch.ops.cuda import _build
from automodel_tpu_torch.ops.paged_attention import ragged_paged_attention_ref

# as on the card (tests/test_torch_cuda.py), a share of the largest value:
# fp32 differs by summation order; bf16 by where the plain version rounds
# dequantized pages, probabilities and the value product and the kernel
# rounds p * vs
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CASES = {
    # Hkv, G, D, Dv, page size, table width P, contexts, soft cap
    "multi_split_ps16_g4_d128": (2, 4, 128, 128, 16, 24, (300, 16, 1), None),
    "split_inside_table_ps8_g1_cap": (2, 1, 64, 64, 8, 40, (203, 129, 128, 8),
                                      30.0),
    "g8_dv64_d128_cap": (1, 8, 128, 64, 16, 12, (150, 17), 20.0),
    "padded_g3_d72_dv40": (2, 3, 72, 40, 16, 12, (150, 17), None),
    # row slices of no 4-byte multiple: byte-wise page copies
    "odd_widths_g2_d30_dv10": (2, 2, 30, 10, 8, 12, (70, 9), None),
    "g20_two_head_tiles": (1, 20, 64, 64, 16, 12, (150, 1), 30.0),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = rewrite.build(gxx, _build.CSRC / "ragged_paged_attention.cu",
                       tmp_path_factory.mktemp("rpa_emulated"))
    lib = ctypes.CDLL(str(so))
    lib.rpa_split_workspace_floats.argtypes = [ctypes.c_int] * 7
    lib.rpa_split_workspace_floats.restype = ctypes.c_longlong
    lib.rpa_gqa_quant_split_forward.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    lib.rpa_gqa_quant_forward.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


def _inputs(case, dtype, seed=0):
    """A ragged batch: for each request a decode row at its last position
    and a row halfway, then a pad row; int8 pages in permuted order."""
    Hkv, G, D, Dv, ps, P, contexts, _ = CASES[case]
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
    q = torch.from_numpy(rng.standard_normal((T, Hkv * G, D), np.float32)).to(dtype)
    k = torch.from_numpy(rng.integers(-127, 128, (N + 1, ps, Hkv, D), np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (N + 1, ps, Hkv, Dv), np.int8))
    ks = torch.from_numpy(rng.uniform(0.002, 0.032, (N + 1, ps)).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.002, 0.032, (N + 1, ps)).astype(np.float32))
    return (q, k, v, ks, vs, torch.tensor(tables, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_k5_matches_plain_version(lib, case, dtype):
    q, k, v, ks, vs, pt, pos = _inputs(case, dtype)
    soft_cap = CASES[case][-1]
    T, Hq, D = q.shape
    _, ps, Hkv, Dv = v.shape
    P = pt.shape[1]
    scale = D ** -0.5
    # garbage where the kernel must write: outputs and workspace start NaN
    out = torch.full((T, Hq, Dv), float("nan"), dtype=dtype)
    ptrs = [x.data_ptr() for x in (q, k, v, ks, vs, pt, pos, out)]
    cap = soft_cap or 0.0
    if dtype == torch.bfloat16:
        ws = torch.full((lib.rpa_split_workspace_floats(T, Hq, Hkv, D, Dv, ps, P),),
                        float("nan"))
        err = lib.rpa_gqa_quant_split_forward(*ptrs, ws.data_ptr(), T, Hq, Hkv,
                                              D, Dv, ps, P, scale, cap, None)
    else:
        err = lib.rpa_gqa_quant_forward(*ptrs, T, Hq, Hkv, D, Dv, ps, P, scale,
                                        cap, 0, None)
    assert err == 0
    want = ragged_paged_attention_ref(q, k, v, pt, pos, scale=scale,
                                      soft_cap=soft_cap, k_scales=ks,
                                      v_scales=vs)
    rel = ((out.float() - want.float()).abs().max()
           / want.float().abs().max().clamp(min=1.0)).item()
    assert rel <= TOL[dtype]
    assert not out[pos < 0].any()
