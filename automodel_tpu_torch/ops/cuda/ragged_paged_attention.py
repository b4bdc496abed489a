"""Wrappers of K4 and K5, the ragged paged GQA attention kernels over fp
pages (K4) and over int8 pages with per-row scales (K5)
(`csrc/ragged_paged_attention.cu`; they replace
`automodel_tpu/ops/pallas/ragged_paged_attention.py:_gqa_kernel` and
`:_gqa_quant_kernel`).

Each takes one of two routes by the query dtype, `route(dtype)`: bfloat16
queries run the split-KV kernel on the tensor cores and its combine
(`gqa_split_kernel`, `gqa_combine_kernel`; instantiated for bf16 pages in
K4, int8 pages in K5), float32 queries the CUDA-core `gqa_kernel`. K4's
bfloat16 route rounds the probabilities to bf16 for the value product, as
the Pallas kernel does (`p.astype(v.dtype)`): it has no rounding deviation
from it. Both routes take a sliding window (`window`, a positive int, or
None for none) and sinks (`sinks`, a (Hq,) float32 logit per query head),
which the Pallas kernels refuse: the split route skips the splits and pages
wholly below the window and folds the sinks into its combine. `KERNELS`
names each kernel's device kernels on each route, as a profiler shows them;
`launch_counts()` gives the launches of each, as the library's C dispatch
counts them.

The plain version of both is
`automodel_tpu_torch.ops.paged_attention.ragged_paged_attention_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from automodel_tpu_torch.ops.cuda._build import load_library, read_counts
from automodel_tpu_torch.parallel.sharding import refuse_dtensor

SOURCE = "ragged_paged_attention.cu"

#: the C interface's dtype argument for q (and, for K4, the pages)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_ROUTES = {torch.bfloat16: "mma", torch.float32: "fma"}
#: K4's and K5's device kernels on each route: substrings of the names a
#: profiler shows, template arguments included (the two kernels share the
#: templates and differ in the page type)
KERNELS = {
    "K4": {
        "mma": ("gqa_split_kernel<__nv_bfloat16,",
                "gqa_combine_kernel<__nv_bfloat16>"),
        "fma": ("gqa_kernel<float, float>",),
    },
    "K5": {
        "mma": ("gqa_split_kernel<signed char,",
                "gqa_combine_kernel<signed char>"),
        "fma": ("gqa_kernel<float, signed char>",),
    },
}


# the kernels of the C dispatch's launch counters, in their order
_COUNTED = (KERNELS["K4"]["fma"][0], KERNELS["K5"]["fma"][0],
            *KERNELS["K4"]["mma"], *KERNELS["K5"]["mma"])


def launch_counts(lib=None) -> dict:
    """Launches of each device kernel since the counters were last reset,
    as the library's C dispatch counts them (each launch issued without
    error), keyed as `KERNELS` names the kernels. `lib`: the library to
    read (the built one by default, built on first use)."""
    return dict(zip(_COUNTED, read_counts((lib or _lib()).rpa_launch_counts)))


def kernel_launches(lib=None) -> dict:
    """K4's and K5's launches since the counters were last reset, from
    `launch_counts()`: each call launches its route's first device kernel
    once."""
    counts = launch_counts(lib)
    return {name: sum(counts[r[0]] for r in routes.values())
            for name, routes in KERNELS.items()}


def reset_launch_counts(lib=None) -> None:
    """Sets `launch_counts()`'s counters to 0."""
    (lib or _lib()).rpa_reset_launch_counts()


def route(dtype: torch.dtype) -> str:
    """K4's and K5's route for queries of `dtype`: "mma" (tensor cores,
    bfloat16) or "fma" (CUDA cores, float32)."""
    return _ROUTES[dtype]


def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if lib.rpa_gqa_forward.argtypes is None:
        tail = [ctypes.c_float, ctypes.c_float, ctypes.c_int]  # scale, cap, window
        lib.rpa_gqa_forward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + tail
            + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.rpa_gqa_forward.restype = ctypes.c_int
        lib.rpa_gqa_quant_forward.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + tail
            + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.rpa_gqa_quant_forward.restype = ctypes.c_int
        lib.rpa_gqa_quant_split_forward.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + tail + [ctypes.c_void_p]
        )
        lib.rpa_gqa_quant_split_forward.restype = ctypes.c_int
        lib.rpa_gqa_split_forward.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + tail + [ctypes.c_void_p]
        )
        lib.rpa_gqa_split_forward.restype = ctypes.c_int
        lib.rpa_split_workspace_floats.argtypes = [ctypes.c_int] * 7
        lib.rpa_split_workspace_floats.restype = ctypes.c_longlong
        lib.rpa_split_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.rpa_split_smem_bytes.restype = ctypes.c_int
        lib.rpa_error_string.argtypes = [ctypes.c_int]
        lib.rpa_error_string.restype = ctypes.c_char_p
    return lib


def split_smem_bytes(Hq: int, Hkv: int, D: int, Dv: int, ps: int, P: int,
                     page_dtype: torch.dtype) -> int:
    """Dynamic shared memory (bytes) of the bfloat16 route's split kernel at
    this shape, over bfloat16 (K4) or int8 (K5) pages."""
    return _lib().rpa_split_smem_bytes(Hq, Hkv, D, Dv, ps, P,
                                       page_dtype.itemsize)


def check_on_card(q, **tensors) -> None:
    """Every tensor is a contiguous local CUDA tensor on q's device."""
    refuse_dtensor("paged attention kernels", q=q, **tensors)
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


def check_window_and_sinks(q, window, sinks) -> int:
    """The C interface's window (0: none) after checking `window` (None or a
    positive int) and `sinks` (None or a (Hq,) float32 CUDA tensor on q's
    device)."""
    if window is not None and (isinstance(window, bool) or not isinstance(window, int)
                               or window <= 0):
        raise ValueError(f"window must be a positive int or None (got {window!r})")
    if sinks is not None:
        check_on_card(q, sinks=sinks)
        if sinks.dtype != torch.float32 or tuple(sinks.shape) != (q.shape[1],):
            raise ValueError(
                f"sinks must be ({q.shape[1]},) float32 (got {tuple(sinks.shape)} "
                f"{sinks.dtype})")
    return window or 0


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.rpa_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def _split_workspace(lib, q, T, Hq, Hkv, D, Dv, ps, P) -> torch.Tensor:
    """The bfloat16 route's fp32 workspace for its split partials, from the
    caching allocator."""
    return torch.empty(
        lib.rpa_split_workspace_floats(T, Hq, Hkv, D, Dv, ps, P),
        dtype=torch.float32, device=q.device)


def ragged_paged_attention_cuda(
    q, k_pages, v_pages, page_tables, positions,
    *,
    scale: float,
    soft_cap: float | None = None,
    window: int | None = None,
    sinks: torch.Tensor | None = None,
) -> torch.Tensor:
    """K4 on CUDA tensors, on `route(q.dtype)`: q (T, Hq, D), pages
    (N+1, ps, Hkv, D[v]), all float32 or all bfloat16; page_tables (T, P)
    and positions (T,) int32; a sliding `window` (a positive int, None for
    none) and `sinks` ((Hq,) float32 sink logits). Returns (T, Hq, Dv) in
    q's dtype. Page-table entries must index the pool (the kernel does not
    bound-check them). A shape the bfloat16 route cannot launch raises."""
    _check(q, k_pages, v_pages, page_tables, positions, q.dtype)
    if soft_cap is not None and soft_cap <= 0:
        raise ValueError(f"soft_cap must be positive (got {soft_cap})")
    win = check_window_and_sinks(q, window, sinks)
    T, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    Dv = v_pages.shape[-1]
    P = page_tables.shape[1]
    out = torch.empty((T, Hq, Dv), dtype=q.dtype, device=q.device)
    lib = _lib()
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), positions.data_ptr(),
            None if sinks is None else sinks.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route(q.dtype) == "mma":
            ws = _split_workspace(lib, q, T, Hq, Hkv, D, Dv, ps, P)
            err = lib.rpa_gqa_split_forward(
                *ptrs, ws.data_ptr(), T, Hq, Hkv, D, Dv, ps, P, float(scale),
                float(soft_cap or 0.0), win, stream)
        else:
            err = lib.rpa_gqa_forward(
                *ptrs, T, Hq, Hkv, D, Dv, ps, P, float(scale),
                float(soft_cap or 0.0), win, DTYPE_CODES[q.dtype], stream)
    _raise_on(lib, err, "ragged paged attention")
    return out



def ragged_paged_attention_quant_cuda(
    q, k_pages, v_pages, k_scales, v_scales, page_tables, positions,
    *,
    scale: float,
    soft_cap: float | None = None,
    window: int | None = None,
    sinks: torch.Tensor | None = None,
) -> torch.Tensor:
    """K5 on CUDA tensors, on `route(q.dtype)`: q (T, Hq, D) float32 or
    bfloat16, int8 pages (N+1, ps, Hkv, D[v]) with (N+1, ps) float32 per-row
    scales, page_tables (T, P) and positions (T,) int32; `window` and
    `sinks` as for K4. Returns (T, Hq, Dv) in q's dtype."""
    _check(q, k_pages, v_pages, page_tables, positions, torch.int8)
    check_on_card(q, k_scales=k_scales, v_scales=v_scales)
    check_scales(k_pages, k_scales, "k_scales")
    check_scales(v_pages, v_scales, "v_scales")
    if soft_cap is not None and soft_cap <= 0:
        raise ValueError(f"soft_cap must be positive (got {soft_cap})")
    win = check_window_and_sinks(q, window, sinks)
    T, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    Dv = v_pages.shape[-1]
    P = page_tables.shape[1]
    out = torch.empty((T, Hq, Dv), dtype=q.dtype, device=q.device)
    lib = _lib()
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), page_tables.data_ptr(),
            positions.data_ptr(), None if sinks is None else sinks.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route(q.dtype) == "mma":
            ws = _split_workspace(lib, q, T, Hq, Hkv, D, Dv, ps, P)
            err = lib.rpa_gqa_quant_split_forward(
                *ptrs, ws.data_ptr(), T, Hq, Hkv, D, Dv, ps, P, float(scale),
                float(soft_cap or 0.0), win, stream)
        else:
            err = lib.rpa_gqa_quant_forward(
                *ptrs, T, Hq, Hkv, D, Dv, ps, P, float(scale),
                float(soft_cap or 0.0), win, DTYPE_CODES[q.dtype], stream)
    _raise_on(lib, err, "quantized ragged paged attention")
    return out

