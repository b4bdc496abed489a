"""Wrappers of K6 and K7, the ragged paged absorbed-MLA attention kernels
over fp latent pages (K6) and over int8 latent pages with per-row scales
(K7) (`csrc/paged_mla_attention.cu`; they replace
`automodel_tpu/ops/pallas/ragged_paged_attention.py:_mla_kernel` and
`:_mla_quant_kernel`).

K6 and K7 each take one of two routes by the query dtype, `route(dtype)`:
bfloat16 queries run the split-KV kernel on the tensor cores and its
combine (`mla_split_kernel`, `mla_combine_kernel`; instantiated for bf16
pages in K6, int8 pages in K7), float32 queries the CUDA-core `mla_kernel`,
whose blocks each take `head_tile(n, r)` heads of a row (all n up to
n * r = 16384; DeepSeek-V3's 128 heads at r 512 take 4 blocks a row).
`KERNELS` names each route's device kernels, as a profiler shows them.

The plain version of both is
`automodel_tpu_torch.ops.paged_attention.ragged_paged_mla_attention_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from automodel_tpu_torch.ops.cuda._build import load_library
from automodel_tpu_torch.ops.cuda.ragged_paged_attention import (
    DTYPE_CODES,
    check_on_card,
    check_scales,
)

SOURCE = "paged_mla_attention.cu"

_ROUTES = {torch.bfloat16: "mma", torch.float32: "fma"}
#: K6's and K7's device kernels on each route: substrings of the names a
#: profiler shows
KERNELS = {
    "mma": ("mla_split_kernel<", "mla_combine_kernel<"),
    "fma": ("mla_kernel<",),
}


def route(dtype: torch.dtype) -> str:
    """K6's and K7's route for queries of `dtype`: "mma" (tensor cores,
    bfloat16) or "fma" (CUDA cores, float32)."""
    return _ROUTES[dtype]


def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if lib.mla_forward.argtypes is None:
        lib.mla_forward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.mla_forward.restype = ctypes.c_int
        lib.mla_quant_forward.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.mla_quant_forward.restype = ctypes.c_int
        lib.mla_quant_split_forward.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.mla_quant_split_forward.restype = ctypes.c_int
        lib.mla_split_forward.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.mla_split_forward.restype = ctypes.c_int
        lib.mla_split_workspace_floats.argtypes = [ctypes.c_int] * 6
        lib.mla_split_workspace_floats.restype = ctypes.c_longlong
        lib.mla_split_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.mla_split_smem_bytes.restype = ctypes.c_int
        lib.mla_head_tile.argtypes = [ctypes.c_int] * 2
        lib.mla_head_tile.restype = ctypes.c_int
        lib.mla_error_string.argtypes = [ctypes.c_int]
        lib.mla_error_string.restype = ctypes.c_char_p
    return lib


def head_tile(n: int, r: int) -> int:
    """Heads per block of the float32 route at n heads of latent rank r: a
    row takes ceil(n / head_tile(n, r)) blocks, each reading its pages."""
    return _lib().mla_head_tile(n, r)


def split_smem_bytes(n: int, r: int, dr: int, ps: int, P: int,
                     page_dtype: torch.dtype) -> int:
    """Dynamic shared memory (bytes) of the bfloat16 route's split kernel at
    this shape, over int8 (K7) or bfloat16 (K6) pages."""
    return _lib().mla_split_smem_bytes(n, r, dr, ps, P, page_dtype.itemsize)


def _check(q_abs, q_rope, c_pages, kr_pages, page_tables, positions,
           page_dtype):
    check_on_card(q_abs, q_rope=q_rope, c_pages=c_pages, kr_pages=kr_pages,
                  page_tables=page_tables, positions=positions)
    if q_abs.dtype not in DTYPE_CODES or q_rope.dtype != q_abs.dtype:
        raise TypeError(
            f"q_abs/q_rope dtypes {q_abs.dtype}/{q_rope.dtype}: both must be "
            "float32 or both bfloat16")
    if c_pages.dtype != page_dtype or kr_pages.dtype != page_dtype:
        raise TypeError(f"c_pages and kr_pages must be {page_dtype}")
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("page_tables and positions must be int32")
    if q_abs.dim() != 3 or q_rope.dim() != 3 or c_pages.dim() != 3 \
            or kr_pages.dim() != 3:
        raise ValueError(
            "q_abs must be (T, n, r), q_rope (T, n, dr), c_pages (N, ps, r), "
            "kr_pages (N, ps, dr)")
    T, n, r = q_abs.shape
    N, ps, _ = c_pages.shape
    dr = q_rope.shape[-1]
    if q_rope.shape[:2] != (T, n) or c_pages.shape[-1] != r \
            or tuple(kr_pages.shape) != (N, ps, dr):
        raise ValueError(
            f"shapes q_abs {tuple(q_abs.shape)}, q_rope {tuple(q_rope.shape)}, "
            f"c_pages {tuple(c_pages.shape)}, kr_pages {tuple(kr_pages.shape)} "
            "do not match")
    if route(q_abs.dtype) == "fma" and head_tile(n, r) < 1:
        raise NotImplementedError(
            f"the fp32 MLA kernel holds at most 16384 accumulators per block: "
            f"one head of rank {r} does not fit")
    if page_tables.dim() != 2 or page_tables.shape[0] != T:
        raise ValueError("page_tables must be (T, P)")
    if positions.shape != (T,):
        raise ValueError("positions must be (T,)")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.mla_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def paged_mla_attention_cuda(
    q_abs, q_rope, c_pages, kr_pages, page_tables, positions, *, scale: float,
) -> torch.Tensor:
    """K6 on CUDA tensors, on `route(q_abs.dtype)`: q_abs (T, n, r), q_rope
    (T, n, dr), c_pages (N+1, ps, r) and kr_pages (N+1, ps, dr), all float32
    or all bfloat16; page_tables (T, P) and positions (T,) int32. Returns
    the latent-space output (T, n, r) in q's dtype. The bfloat16 route
    takes an fp32 workspace for its split partials from the caching
    allocator."""
    _check(q_abs, q_rope, c_pages, kr_pages, page_tables, positions,
           q_abs.dtype)
    T, n, r = q_abs.shape
    ps, dr = c_pages.shape[1], q_rope.shape[-1]
    P = page_tables.shape[1]
    out = torch.empty((T, n, r), dtype=q_abs.dtype, device=q_abs.device)
    lib = _lib()
    ptrs = (q_abs.data_ptr(), q_rope.data_ptr(), c_pages.data_ptr(),
            kr_pages.data_ptr(), page_tables.data_ptr(), positions.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(q_abs.device):
        stream = torch.cuda.current_stream(q_abs.device).cuda_stream
        if route(q_abs.dtype) == "mma":
            ws = torch.empty(lib.mla_split_workspace_floats(T, n, r, dr, ps, P),
                             dtype=torch.float32, device=q_abs.device)
            err = lib.mla_split_forward(
                *ptrs, ws.data_ptr(), T, n, r, dr, ps, P, float(scale), stream)
        else:
            err = lib.mla_forward(
                *ptrs, T, n, r, dr, ps, P, float(scale),
                DTYPE_CODES[q_abs.dtype], stream)
    _raise_on(lib, err, "paged MLA attention")
    paged_mla_attention_cuda.launches += 1
    return out


paged_mla_attention_cuda.launches = 0


def paged_mla_attention_quant_cuda(
    q_abs, q_rope, c_pages, kr_pages, c_scales, kr_scales, page_tables,
    positions, *, scale: float,
) -> torch.Tensor:
    """K7 on CUDA tensors, on `route(q_abs.dtype)`: q_abs (T, n, r) and
    q_rope (T, n, dr) float32 or bfloat16; int8 c_pages (N+1, ps, r) and
    kr_pages (N+1, ps, dr) with (N+1, ps) float32 per-row scales;
    page_tables (T, P) and positions (T,) int32. Returns (T, n, r) in q's
    dtype. The bfloat16 route takes an fp32 workspace for its split
    partials from the caching allocator."""
    _check(q_abs, q_rope, c_pages, kr_pages, page_tables, positions,
           torch.int8)
    check_on_card(q_abs, c_scales=c_scales, kr_scales=kr_scales)
    check_scales(c_pages, c_scales, "c_scales")
    check_scales(kr_pages, kr_scales, "kr_scales")
    T, n, r = q_abs.shape
    ps, dr = c_pages.shape[1], q_rope.shape[-1]
    out = torch.empty((T, n, r), dtype=q_abs.dtype, device=q_abs.device)
    P = page_tables.shape[1]
    lib = _lib()
    ptrs = (q_abs.data_ptr(), q_rope.data_ptr(), c_pages.data_ptr(),
            kr_pages.data_ptr(), c_scales.data_ptr(), kr_scales.data_ptr(),
            page_tables.data_ptr(), positions.data_ptr(), out.data_ptr())
    with torch.cuda.device(q_abs.device):
        stream = torch.cuda.current_stream(q_abs.device).cuda_stream
        if route(q_abs.dtype) == "mma":
            ws = torch.empty(lib.mla_split_workspace_floats(T, n, r, dr, ps, P),
                             dtype=torch.float32, device=q_abs.device)
            err = lib.mla_quant_split_forward(
                *ptrs, ws.data_ptr(), T, n, r, dr, ps, P, float(scale), stream)
        else:
            err = lib.mla_quant_forward(
                *ptrs, T, n, r, dr, ps, P, float(scale),
                DTYPE_CODES[q_abs.dtype], stream)
    _raise_on(lib, err, "quantized paged MLA attention")
    paged_mla_attention_quant_cuda.launches += 1
    return out


paged_mla_attention_quant_cuda.launches = 0
