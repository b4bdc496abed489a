"""K4's and K5's CUDA source (`automodel_tpu_torch/csrc/ragged_paged_attention.cu`
with `paged_split.cuh`) compiled for the CPU with g++ against
`tests/cuda_emulation/cuda_emulation.h` and held to the plain version
(`ragged_paged_attention_ref`; with `k_scales`/`v_scales` for K5) on the
same inputs. Each kernel on both routes: the split-KV tensor-core kernel
and its combine for bf16 queries (K4 over bf16 pages, K5 over int8
pages), the CUDA-core kernel for fp32 queries. The cases cover rows that
span several splits, a split boundary inside a page table, contexts that
end mid-page, one-page and pad rows, 8- and 16-token pages, G 1, 3, 4, 8
and 20 (two head tiles), D 64 and 128, Dv != D, zero-padded and odd
widths, and the soft cap on and off; K4 also D = Dv = 256 (1040-byte tile
rows).

Sliding windows and sinks, on both routes of both kernels: windows that
mask and start mid-split and mid-page (sizes that are no multiple of the
page or of the split), sinks alone, and sinks with a window and the soft
cap. Two cases show what the window skips: every page wholly below a row's
window filled with NaN (K5: its scales), and the split workspace filled
with large values before the launch; both must still give the plain
version's output on the clean pages, which fails if a page below the
window is read or if the combine reads a split that exited without
writing. `tests/cuda_emulation/window_sink_mutants.py` shows that these
cases fail when the window or the sink is dropped at any of its sites.
Skips without g++."""

import ctypes
import shutil

import numpy as np
import pytest
import torch
from cuda_emulation import rewrite

from automodel_tpu_torch.ops.cuda import _build
from automodel_tpu_torch.ops.cuda import ragged_paged_attention as rpa_cuda
from automodel_tpu_torch.ops.paged_attention import ragged_paged_attention_ref

# as on the card (tests/test_torch_cuda.py), a share of the largest value:
# fp32 differs by summation order; bf16 by where the plain version rounds
# dequantized pages (K5) and the value product and the kernel rounds p * vs
# (K5), and by the order of the sums (both round p to bf16 in K4)
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
    # Qwen3-30B-A3B's heads: G 8 x D 128
    "g8_d128_dv128": (1, 8, 128, 128, 16, 12, (150, 17), None),
    # the dense families' groups: Qwen2.5-7B's G 7, GLM-4-9B's G 16 (the
    # whole M tile) and Baichuan2-7B's MHA, G 1, all at D 128
    "g7_d128_qwen25": (2, 7, 128, 128, 16, 12, (150, 17), None),
    "g16_d128_glm4": (1, 16, 128, 128, 16, 12, (150, 17), None),
    "g1_d128_baichuan": (3, 1, 128, 128, 16, 12, (150, 17), None),
}
# K4 also at the widest heads of dense families
K4_CASES = {**CASES,
            "d256_dv256_g2_cap": (2, 2, 256, 256, 16, 12, (150, 17), 30.0)}


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
    tail = [ctypes.c_float, ctypes.c_float, ctypes.c_int]  # scale, cap, window
    lib.rpa_gqa_quant_split_forward.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + tail + [ctypes.c_void_p])
    lib.rpa_gqa_quant_forward.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + tail
        + [ctypes.c_int, ctypes.c_void_p])
    lib.rpa_gqa_split_forward.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + tail + [ctypes.c_void_p])
    lib.rpa_gqa_forward.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + tail
        + [ctypes.c_int, ctypes.c_void_p])
    return lib


def _inputs(case, dtype, seed=0, cases=CASES):
    """A ragged batch: for each request a decode row at its last position
    and a row halfway, then a pad row; int8 pages with per-row scales in
    permuted order."""
    Hkv, G, D, Dv, ps, P, contexts, _ = cases[case]
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


def _launch(lib, kernel, q, k, v, pt, pos, soft_cap, window=0, sinks=None,
            scales=None, ws_fill=float("nan")):
    """One launch of `kernel` on the route of q's dtype; the output and the
    split route's workspace start as garbage (NaN, or `ws_fill`) where the
    kernel must write."""
    T, Hq, D = q.shape
    _, ps, Hkv, Dv = v.shape
    P = pt.shape[1]
    out = torch.full((T, Hq, Dv), float("nan"), dtype=q.dtype)
    pages = (q, k, v) + (scales if kernel == "K5" else ())
    ptrs = [x.data_ptr() for x in pages + (pt, pos)]
    ptrs += [None if sinks is None else sinks.data_ptr(), out.data_ptr()]
    args = (T, Hq, Hkv, D, Dv, ps, P, D ** -0.5, soft_cap or 0.0, window)
    quant = "quant_" if kernel == "K5" else ""
    before = rpa_cuda.launch_counts(lib)
    if q.dtype == torch.bfloat16:
        ws = torch.full((lib.rpa_split_workspace_floats(T, Hq, Hkv, D, Dv, ps, P),),
                        ws_fill)
        err = getattr(lib, f"rpa_gqa_{quant}split_forward")(
            *ptrs, ws.data_ptr(), *args, None)
    else:
        err = getattr(lib, f"rpa_gqa_{quant}forward")(*ptrs, *args, 0, None)
    assert err == 0
    # the C dispatch counted one launch of each of the route's device kernels
    after = rpa_cuda.launch_counts(lib)
    assert {name: n - before[name] for name, n in after.items() if n != before[name]} == (
        dict.fromkeys(rpa_cuda.KERNELS[kernel][rpa_cuda.route(q.dtype)], 1))
    return out


def _rel_err(out, want):
    return ((out.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_k5_matches_plain_version(lib, case, dtype):
    q, k, v, ks, vs, pt, pos = _inputs(case, dtype)
    soft_cap = CASES[case][-1]
    out = _launch(lib, "K5", q, k, v, pt, pos, soft_cap, scales=(ks, vs))
    want = ragged_paged_attention_ref(q, k, v, pt, pos, scale=q.shape[-1] ** -0.5,
                                      soft_cap=soft_cap, k_scales=ks,
                                      v_scales=vs)
    assert _rel_err(out, want) <= TOL[dtype]
    assert not out[pos < 0].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_emulated_k4_matches_plain_version(lib, case, dtype):
    """K4 over pages of the query dtype: bf16 on the split route
    (`rpa_gqa_split_forward`), fp32 on the CUDA-core one (`rpa_gqa_forward`,
    dtype 0)."""
    q, k8, v8, _, _, pt, pos = _inputs(case, dtype, cases=K4_CASES)
    rng = np.random.default_rng(1)
    k, v = (torch.from_numpy(rng.standard_normal(x.shape, np.float32)).to(dtype)
            for x in (k8, v8))
    soft_cap = K4_CASES[case][-1]
    out = _launch(lib, "K4", q, k, v, pt, pos, soft_cap)
    want = ragged_paged_attention_ref(q, k, v, pt, pos, scale=q.shape[-1] ** -0.5,
                                      soft_cap=soft_cap)
    assert _rel_err(out, want) <= TOL[dtype]
    assert not out[pos < 0].any()


# Hkv, G, D, Dv, page size, table width P, contexts, soft cap, window, sinks.
# 16-token pages make 128-kv splits, 8-token pages 128 too (16 pages).
WINDOW_CASES = {
    # lo = 299 - 100 + 1 = 200: mid-split (split 1 is 128-255), mid-page
    "window_mid_split_ps16": (2, 4, 64, 64, 16, 24, (300, 41, 1), None, 100, False),
    # a window of no multiple of 8 or 128 over 8-token pages, G 1
    "window_ps8_g1_cap": (2, 1, 64, 64, 8, 40, (290, 203, 9), 30.0, 77, False),
    "sinks_g8": (1, 8, 64, 64, 16, 12, (150, 17, 1), None, 0, True),
    "window_sinks_cap_g3": (2, 3, 72, 40, 16, 24, (333, 130), 20.0, 129, True),
    # gpt-oss-20b's heads: G 8 x D 64, a window of 128 with sinks
    "window_128_sinks_g8": (1, 8, 64, 64, 16, 24, (300, 130, 1), None, 128, True),
}


def _window_inputs(case, dtype, kernel, last_rows_only=False):
    """`_inputs` for a window case (K4: pages of the query dtype), its
    window and sink logits; with `last_rows_only`, only each request's
    decode row and the pad row."""
    Hkv, G, D, Dv, ps, P, contexts, cap, window, sinks = WINDOW_CASES[case]
    cases = {case: (Hkv, G, D, Dv, ps, P, contexts, cap)}
    q, k, v, ks, vs, pt, pos = _inputs(case, dtype, cases=cases)
    if kernel == "K4":
        rng = np.random.default_rng(1)
        k, v = (torch.from_numpy(rng.standard_normal(x.shape, np.float32)).to(dtype)
                for x in (k, v))
    if last_rows_only:
        keep = torch.tensor(list(range(0, len(pos) - 1, 2)) + [len(pos) - 1])
        q, pt, pos = q[keep].contiguous(), pt[keep].contiguous(), pos[keep].contiguous()
    s = (torch.from_numpy(np.random.default_rng(2).normal(3, 1, Hkv * G)
                          .astype(np.float32)) if sinks else None)
    return q, k, v, ks, vs, pt, pos, cap, window, s


def _window_ref(q, k, v, ks, vs, pt, pos, cap, window, sinks, kernel):
    scales = dict(k_scales=ks, v_scales=vs) if kernel == "K5" else {}
    return ragged_paged_attention_ref(q, k, v, pt, pos, scale=q.shape[-1] ** -0.5,
                                      soft_cap=cap, window=window, sinks=sinks,
                                      **scales)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_emulated_window_and_sinks_match_plain_version(lib, case, kernel, dtype):
    q, k, v, ks, vs, pt, pos, cap, window, sinks = _window_inputs(case, dtype, kernel)
    if window:  # every live row's window masks
        assert (pos[pos >= 0] >= window).any()
    out = _launch(lib, kernel, q, k, v, pt, pos, cap, window, sinks, (ks, vs))
    want = _window_ref(q, k, v, ks, vs, pt, pos, cap, window, sinks, kernel)
    assert _rel_err(out, want) <= TOL[dtype]
    assert not out[pos < 0].any()
    # the window and the sinks each change the result well past the tolerance
    if window:
        assert _rel_err(_window_ref(q, k, v, ks, vs, pt, pos, cap, 0, sinks, kernel),
                        want) > 3 * TOL[dtype]
    if sinks is not None:
        assert _rel_err(_window_ref(q, k, v, ks, vs, pt, pos, cap, window, None,
                                    kernel), want) > 3 * TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_emulated_window_reads_no_page_below_it(lib, kernel, dtype):
    """Every page wholly below its row's window holds NaN (K5: NaN scales
    and extreme values): the output is still the plain version's on the
    clean pages. One row per request, so no other row reads those pages."""
    case = "window_mid_split_ps16"
    q, k, v, ks, vs, pt, pos, cap, window, sinks = _window_inputs(
        case, dtype, kernel, last_rows_only=True)
    want = _window_ref(q, k, v, ks, vs, pt, pos, cap, window, sinks, kernel)
    ps = k.shape[1]
    k, v, ks, vs = k.clone(), v.clone(), ks.clone(), vs.clone()
    poisoned = 0
    for row, p in zip(pt.tolist(), pos.tolist()):
        if p < 0:
            continue
        for page in row[: max(p - window + 1, 0) // ps]:
            if kernel == "K5":
                k[page], v[page] = 127, -127
                ks[page], vs[page] = float("nan"), float("nan")
            else:
                k[page], v[page] = float("nan"), float("nan")
            poisoned += 1
    assert poisoned >= 12  # lo = 200 on 16-token pages
    out = _launch(lib, kernel, q, k, v, pt, pos, cap, window, sinks, (ks, vs))
    assert _rel_err(out, want) <= TOL[dtype]


@pytest.mark.parametrize("kernel", ["K4", "K5"])
@pytest.mark.parametrize("case", ["window_mid_split_ps16", "window_sinks_cap_g3"])
def test_emulated_combine_reads_no_exited_split(lib, case, kernel):
    """The split route's workspace starts full of large values: a combine
    that read the slots of the splits below the window would take them
    for the largest max."""
    q, k, v, ks, vs, pt, pos, cap, window, sinks = _window_inputs(
        case, torch.bfloat16, kernel)
    out = _launch(lib, kernel, q, k, v, pt, pos, cap, window, sinks, (ks, vs),
                  ws_fill=3.0e4)
    want = _window_ref(q, k, v, ks, vs, pt, pos, cap, window, sinks, kernel)
    assert _rel_err(out, want) <= TOL[torch.bfloat16]
