"""Wrappers of K1-K3, the flash attention kernels (`csrc/flash_attention.cu`;
replace `automodel_tpu/ops/pallas/flash_attention.py:_fwd_kernel`,
`_dq_kernel` and `_dkv_kernel`).

Each kernel is instantiated for the pairs of head dims in `HEAD_DIMS`: q/k
and v alike at 16, 64 and 128, and MLA's q/k 192 with v 128 (DeepSeek-V3
and Moonlight: qk_nope 128 + qk_rope 64).

The input dtype picks the route, `route(dtype)`: bfloat16 runs K1-K3 on the
tensor cores (`mma.sync`), float32 on the CUDA cores, whose fp32 products
keep the fp32 results within ~1e-6 of the plain versions (an fp32 `mma`
would be TF32). `KERNELS` names each route's device kernels, as a profiler
shows them.

The plain versions of the same functions are
`automodel_tpu_torch.ops.flash_attention.flash_attention_ref` (forward) and
`flash_attention_bwd_ref` (backward). Each wrapper counts its launches in a
module-level integer: `launches_fwd`, `launches_dq`, `launches_dkv`.
"""

from __future__ import annotations

import ctypes

import torch

from automodel_tpu_torch.ops.cuda._build import load_library

SOURCE = "flash_attention.cu"
# (q/k head dim, v head dim) of each instantiation: the tiny recipe's,
# TinyLlama's, Llama-3's, and MLA's (Moonlight, DeepSeek-V3)
HEAD_DIMS = ((16, 16), (64, 64), (128, 128), (192, 128))

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {torch.bfloat16: "mma", torch.float32: "fma"}
# the device kernels of K1, K2 and K3 on each route: substrings of the
# names a profiler shows
KERNELS = {
    "mma": ("fwd_mma_kernel<", "dq_mma_kernel<", "dkv_mma_kernel<"),
    "fma": ("fwd_kernel<", "dq_kernel<", "dkv_kernel<"),
}

launches_fwd = 0
launches_dq = 0
launches_dkv = 0


def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if lib.fa_forward.argtypes is None:
        tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float] + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.fa_forward.argtypes = [ctypes.c_void_p] * 7 + tail
        lib.fa_backward_dq.argtypes = [ctypes.c_void_p] * 9 + tail
        lib.fa_backward_dkv.argtypes = [ctypes.c_void_p] * 10 + tail
        for fn in (lib.fa_forward, lib.fa_backward_dq, lib.fa_backward_dkv):
            fn.restype = ctypes.c_int
        lib.fa_mma_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.fa_mma_smem_bytes.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [ctypes.c_int]
        lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def route(dtype: torch.dtype) -> str:
    """K1-K3's route for inputs of `dtype`: "mma" (tensor cores, bfloat16)
    or "fma" (CUDA cores, float32)."""
    return _ROUTES[dtype]


def mma_smem_bytes(which: int, D: int, Dv: int) -> int:
    """Dynamic shared memory (bytes) of the tensor-core K1 (`which` 0), K3
    (`which` 1) or K2 (`which` 2) at q/k head dim D and v head dim Dv."""
    return _lib().fa_mma_smem_bytes(which, D, Dv)


def check_supported(q, k, v, *, sliding_window=None, position_causal=False):
    """Raise NotImplementedError for what K1-K3 do not cover: windows,
    position-causal masking, q and k head dims that differ, and (q/k, v)
    head dims that are not an instantiated pair. Called before any device
    check, so the refusal is the same on every device."""
    if sliding_window is not None:
        raise NotImplementedError(
            "flash attention kernels: sliding windows are not supported")
    if position_causal:
        raise NotImplementedError(
            "flash attention kernels: position-causal masking (independent "
            "kv positions or segment ids) is not supported")
    D, Dk, Dv = q.shape[-1], k.shape[-1], v.shape[-1]
    if D != Dk:
        raise NotImplementedError(
            f"flash attention kernels: head dims q {D}, k {Dk}, v {Dv} differ")
    if (D, Dv) not in HEAD_DIMS:
        what = f"head dim {D}" if D == Dv else f"head dims q/k {D}, v {Dv}"
        raise NotImplementedError(
            f"flash attention kernels: {what} is not one of the instantiated "
            f"(q/k, v) pairs {HEAD_DIMS}")


def _check(tensors: dict, q, segment_ids):
    for name, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {x.device})")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} is not float32 or bfloat16")
    for name in ("k", "v", "dout"):
        if name in tensors and tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} must have q's dtype {q.dtype}")
    for name in ("lse", "delta"):
        if name in tensors and tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
    k, v = tensors["k"], tensors["v"]
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError("q must be (B, S, Hq, D), k (B, T, Hkv, D) and v "
                         "(B, T, Hkv, Dv)")
    B, S, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if "dout" in tensors and tensors["dout"].shape != (B, S, Hq, v.shape[3]):
        raise ValueError(f"dout must be (B, S, Hq, Dv) = {(B, S, Hq, v.shape[3])}")
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[2]}")
    if S == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if segment_ids is not None:
        if segment_ids.dtype != torch.int32 or segment_ids.shape != (B, S):
            raise TypeError("segment_ids must be int32 (B, S)")
        if k.shape[1] != S:
            raise ValueError("segment ids need S == T")
    for name in ("lse", "delta"):
        if name in tensors and tensors[name].shape != (B, Hq, S):
            raise ValueError(f"{name} must be (B, Hq, S)")


def _aligned(*tensors):
    """The tensors, each copied if it does not start on a 16-byte boundary
    (a view at an offset): the tensor-core route copies rows in 16-byte
    chunks."""
    return [x if x.data_ptr() % 16 == 0 else x.clone() for x in tensors]


def _common(q, k, v, segment_ids, scale, soft_cap, causal):
    if soft_cap is not None and soft_cap <= 0:
        raise ValueError(f"soft_cap must be positive (got {soft_cap})")
    B, S, Hq, D = q.shape
    seg = 0 if segment_ids is None else segment_ids.data_ptr()
    dims = (B, S, k.shape[1], Hq, k.shape[2], D, v.shape[3], float(scale),
            float(soft_cap or 0.0), int(bool(causal)), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    return seg, dims


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        msg = lib.fa_error_string(err).decode()
        raise RuntimeError(f"flash attention {what} launch failed: {msg}")


def flash_fwd_cuda(q, k, v, segment_ids=None, *, scale: float,
                   soft_cap: float | None = None, causal: bool = True):
    """K1 on `route(q.dtype)`. q (B, S, Hq, D), k (B, T, Hkv, D), v
    (B, T, Hkv, Dv), float32 or bfloat16, (D, Dv) in `HEAD_DIMS`;
    segment_ids (B, S) int32 or None (then S == T). Returns out
    (B, S, Hq, Dv) in q's dtype and lse (B, Hq, S) fp32, EMPTY_LSE on fully
    masked rows."""
    global launches_fwd
    check_supported(q, k, v)
    _check(dict(q=q, k=k, v=v), q, segment_ids)
    seg, dims = _common(q, k, v, segment_ids, scale, soft_cap, causal)
    if route(q.dtype) == "mma":
        q, k, v = _aligned(q, k, v)
    B, S, Hq, _ = q.shape
    out = torch.empty((B, S, Hq, v.shape[3]), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg, seg,
                             out.data_ptr(), lse.data_ptr(), *dims)
    _raise_on(err, lib, "forward")
    launches_fwd += 1
    return out, lse


def flash_dq_cuda(q, k, v, dout, lse, delta, segment_ids=None, *,
                  scale: float, soft_cap: float | None = None,
                  causal: bool = True):
    """K2 on `route(q.dtype)`: dq (B, S, Hq, D) in q's dtype from dout
    (B, S, Hq, Dv) in q's dtype and the fp32 (B, Hq, S) lse and delta."""
    global launches_dq
    check_supported(q, k, v)
    _check(dict(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta), q, segment_ids)
    seg, dims = _common(q, k, v, segment_ids, scale, soft_cap, causal)
    if route(q.dtype) == "mma":
        q, k, v, dout = _aligned(q, k, v, dout)
    dq = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.fa_backward_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), seg, seg, dq.data_ptr(), *dims)
    _raise_on(err, lib, "dq")
    launches_dq += 1
    return dq


def flash_dkv_cuda(q, k, v, dout, lse, delta, segment_ids=None, *,
                   scale: float, soft_cap: float | None = None,
                   causal: bool = True):
    """K3 on `route(q.dtype)`: (dk, dv), (B, T, Hkv, D) and (B, T, Hkv, Dv)
    in k's dtype; inputs as K2's."""
    global launches_dkv
    check_supported(q, k, v)
    _check(dict(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta), q, segment_ids)
    seg, dims = _common(q, k, v, segment_ids, scale, soft_cap, causal)
    if route(q.dtype) == "mma":
        q, k, v, dout = _aligned(q, k, v, dout)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.fa_backward_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), seg, seg, dk.data_ptr(),
            dv.data_ptr(), *dims)
    _raise_on(err, lib, "dk/dv")
    launches_dkv += 1
    return dk, dv
