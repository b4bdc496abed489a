"""Wrapper of K4, the ragged paged GQA attention kernel
(`csrc/ragged_paged_attention.cu`; replaces
`automodel_tpu/ops/pallas/ragged_paged_attention.py:_gqa_kernel`).

The plain version of the same function is
`automodel_tpu_torch.ops.paged_attention.ragged_paged_attention_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from automodel_tpu_torch.ops.cuda._build import load_library

SOURCE = "ragged_paged_attention.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if lib.rpa_gqa_forward.argtypes is None:
        lib.rpa_gqa_forward.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.rpa_gqa_forward.restype = ctypes.c_int
        lib.rpa_error_string.argtypes = [ctypes.c_int]
        lib.rpa_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_pages, v_pages, page_tables, positions):
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                   page_tables=page_tables, positions=positions)
    for name, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {x.device})")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} is not float32 or bfloat16")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q, k_pages and v_pages must share one dtype")
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
    _check(q, k_pages, v_pages, page_tables, positions)
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
            float(scale), float(soft_cap or 0.0), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = lib.rpa_error_string(err).decode()
        raise RuntimeError(f"ragged paged attention launch failed: {msg}")
    ragged_paged_attention_cuda.launches += 1
    return out


ragged_paged_attention_cuda.launches = 0
