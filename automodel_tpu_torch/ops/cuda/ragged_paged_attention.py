"""Wrappers of K4 and K5, the ragged paged GQA attention kernels over fp
pages (K4) and over int8 pages with per-row scales (K5)
(`csrc/ragged_paged_attention.cu`; they replace
`automodel_tpu/ops/pallas/ragged_paged_attention.py:_gqa_kernel` and
`:_gqa_quant_kernel`).

K4 runs the CUDA-core `gqa_kernel` for both dtypes. K5 takes one of two
routes by the query dtype, `route(dtype)`: bfloat16 queries run the
split-KV kernel on the tensor cores and its combine (`gqa_split_kernel`,
`gqa_combine_kernel`), float32 queries the CUDA-core `gqa_kernel`.
`KERNELS` names each of K5's routes' device kernels, as a profiler shows
them.

The plain version of both is
`automodel_tpu_torch.ops.paged_attention.ragged_paged_attention_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from automodel_tpu_torch.ops.cuda._build import load_library

SOURCE = "ragged_paged_attention.cu"

#: the C interface's dtype argument for q (and, for K4, the pages)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_ROUTES = {torch.bfloat16: "mma", torch.float32: "fma"}
#: K5's device kernels on each route
KERNELS = {
    "mma": ("gqa_split_kernel", "gqa_combine_kernel"),
    "fma": ("gqa_kernel",),
}


def route(dtype: torch.dtype) -> str:
    """K5's route for queries of `dtype`: "mma" (tensor cores, bfloat16) or
    "fma" (CUDA cores, float32)."""
    return _ROUTES[dtype]


def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if lib.rpa_gqa_forward.argtypes is None:
        lib.rpa_gqa_forward.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.rpa_gqa_forward.restype = ctypes.c_int
        lib.rpa_gqa_quant_forward.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.rpa_gqa_quant_forward.restype = ctypes.c_int
        lib.rpa_gqa_quant_split_forward.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        )
        lib.rpa_gqa_quant_split_forward.restype = ctypes.c_int
        lib.rpa_split_workspace_floats.argtypes = [ctypes.c_int] * 7
        lib.rpa_split_workspace_floats.restype = ctypes.c_longlong
        lib.rpa_split_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.rpa_split_smem_bytes.restype = ctypes.c_int
        lib.rpa_error_string.argtypes = [ctypes.c_int]
        lib.rpa_error_string.restype = ctypes.c_char_p
    return lib


def split_smem_bytes(Hq: int, Hkv: int, D: int, Dv: int, ps: int,
                     P: int) -> int:
    """Dynamic shared memory (bytes) of K5's bfloat16 route's split kernel
    at this shape."""
    return _lib().rpa_split_smem_bytes(Hq, Hkv, D, Dv, ps, P)


def check_on_card(q, **tensors) -> None:
    """Every tensor is a contiguous CUDA tensor on q's device."""
    for name, x in dict(q=q, **tensors).items():
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {x.device})")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(q, k_pages, v_pages, page_tables, positions, page_dtype):
    check_on_card(q, k_pages=k_pages, v_pages=v_pages,
                  page_tables=page_tables, positions=positions)
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} is not float32 or bfloat16")
    if k_pages.dtype != page_dtype or v_pages.dtype != page_dtype:
        raise TypeError(f"k_pages and v_pages must be {page_dtype}")
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("page_tables and positions must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError("q must be (T, Hq, D), pages (N, ps, Hkv, D[v])")
    T, Hq, D = q.shape
    N, ps, Hkv, Dk = k_pages.shape
    if Dk != D or v_pages.shape[:3] != (N, ps, Hkv):
        raise ValueError(
            f"page shapes {tuple(k_pages.shape)} / {tuple(v_pages.shape)} "
            f"do not match q {tuple(q.shape)}"
        )
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if page_tables.dim() != 2 or page_tables.shape[0] != T:
        raise ValueError("page_tables must be (T, P)")
    if positions.shape != (T,):
        raise ValueError("positions must be (T,)")


def check_scales(pages, scales, name: str) -> None:
    """(N, ps) fp32 per-row scales beside (N, ps, ...) int8 pages."""
    if scales.dtype != torch.float32:
        raise TypeError(f"{name} must be float32")
    if tuple(scales.shape) != tuple(pages.shape[:2]):
        raise ValueError(
            f"{name} {tuple(scales.shape)} does not match pages "
            f"{tuple(pages.shape[:2])}"
        )


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.rpa_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def ragged_paged_attention_cuda(
    q, k_pages, v_pages, page_tables, positions,
    *,
    scale: float,
    soft_cap: float | None = None,
) -> torch.Tensor:
    """K4 on CUDA tensors: q (T, Hq, D), pages (N+1, ps, Hkv, D[v]) in
    float32 or bfloat16, page_tables (T, P) and positions (T,) int32.
    Returns (T, Hq, Dv) in q's dtype. Page-table entries must index the
    pool (the kernel does not bound-check them)."""
    _check(q, k_pages, v_pages, page_tables, positions, q.dtype)
    if soft_cap is not None and soft_cap <= 0:
        raise ValueError(f"soft_cap must be positive (got {soft_cap})")
    T, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    Dv = v_pages.shape[-1]
    out = torch.empty((T, Hq, Dv), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.rpa_gqa_forward(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            T, Hq, Hkv, D, Dv, ps, page_tables.shape[1],
            float(scale), float(soft_cap or 0.0), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(lib, err, "ragged paged attention")
    ragged_paged_attention_cuda.launches += 1
    return out


ragged_paged_attention_cuda.launches = 0


def ragged_paged_attention_quant_cuda(
    q, k_pages, v_pages, k_scales, v_scales, page_tables, positions,
    *,
    scale: float,
    soft_cap: float | None = None,
) -> torch.Tensor:
    """K5 on CUDA tensors, on `route(q.dtype)`: q (T, Hq, D) float32 or
    bfloat16, int8 pages (N+1, ps, Hkv, D[v]) with (N+1, ps) float32 per-row
    scales, page_tables (T, P) and positions (T,) int32. Returns (T, Hq, Dv)
    in q's dtype. The bfloat16 route takes an fp32 workspace for its split
    partials from the caching allocator."""
    _check(q, k_pages, v_pages, page_tables, positions, torch.int8)
    check_on_card(q, k_scales=k_scales, v_scales=v_scales)
    check_scales(k_pages, k_scales, "k_scales")
    check_scales(v_pages, v_scales, "v_scales")
    if soft_cap is not None and soft_cap <= 0:
        raise ValueError(f"soft_cap must be positive (got {soft_cap})")
    T, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    Dv = v_pages.shape[-1]
    P = page_tables.shape[1]
    out = torch.empty((T, Hq, Dv), dtype=q.dtype, device=q.device)
    lib = _lib()
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), page_tables.data_ptr(),
            positions.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route(q.dtype) == "mma":
            ws = torch.empty(
                lib.rpa_split_workspace_floats(T, Hq, Hkv, D, Dv, ps, P),
                dtype=torch.float32, device=q.device)
            err = lib.rpa_gqa_quant_split_forward(
                *ptrs, ws.data_ptr(), T, Hq, Hkv, D, Dv, ps, P, float(scale),
                float(soft_cap or 0.0), stream)
        else:
            err = lib.rpa_gqa_quant_forward(
                *ptrs, T, Hq, Hkv, D, Dv, ps, P, float(scale),
                float(soft_cap or 0.0), DTYPE_CODES[q.dtype], stream)
    _raise_on(lib, err, "quantized ragged paged attention")
    ragged_paged_attention_quant_cuda.launches += 1
    return out


ragged_paged_attention_quant_cuda.launches = 0
