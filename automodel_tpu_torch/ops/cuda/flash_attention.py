"""Wrappers of K1-K3, the flash attention kernels (`csrc/flash_attention.cu`;
replace `automodel_tpu/ops/pallas/flash_attention.py:_fwd_kernel`,
`_dq_kernel` and `_dkv_kernel`).

Each kernel is instantiated for the pairs of head dims in `HEAD_DIMS`: q/k
and v alike at 16, 64, 128 and 256 (Gemma-2, Gemma-3), and MLA's q/k 192
with v 128 (DeepSeek-V3 and Moonlight: qk_nope 128 + qk_rope 64).

Masks, as the Pallas kernels take them: causal by index, or by position
when the kv side has positions or segment ids of its own (`kv_positions`,
`kv_segment_ids`; then T may differ from S); segment ids; a sliding window
on positions (two-sided without causal masking); a logit soft cap. Under a
window or position-causal masking each wrapper hands its kernel the
positions and their min and max per 32-row granule (`granule_ranges`,
computed on the device), from which the kernel skips the tile pairs that
hold no allowed pair; `mask_args` makes these once for a caller that runs
K1-K3 on the same masks.

The input dtype picks the route, `route(dtype)`: bfloat16 runs K1-K3 on the
tensor cores (`mma.sync`), float32 on the CUDA cores, whose fp32 products
keep the fp32 results within ~1e-6 of the plain versions (an fp32 `mma`
would be TF32). `KERNELS` names each route's device kernels, as a profiler
shows them; `launch_counts()` gives the launches of each, as the library's
C dispatch counts them.

The plain versions of the same functions are
`automodel_tpu_torch.ops.flash_attention.flash_attention_ref` (forward) and
`flash_attention_bwd_ref` (backward).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from automodel_tpu_torch.ops.cuda._build import load_library, read_counts

SOURCE = "flash_attention.cu"
# (q/k head dim, v head dim) of each instantiation: the tiny recipe's,
# TinyLlama's, Llama-3's and Mistral's, MLA's (Moonlight, DeepSeek-V3), and
# Gemma-2's and Gemma-3's
HEAD_DIMS = ((16, 16), (64, 64), (128, 128), (192, 128), (256, 256))
# rows per granule of the position ranges (the kernels' kGran)
GRANULE = 32

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {torch.bfloat16: "mma", torch.float32: "fma"}
# the device kernels of K1, K2 and K3 on each route: substrings of the
# names a profiler shows
KERNELS = {
    "mma": ("fwd_mma_kernel<", "dq_mma_kernel<", "dkv_mma_kernel<"),
    "fma": ("fwd_kernel<", "dq_kernel<", "dkv_kernel<"),
}

# the kernels of the C dispatch's launch counters, in their order (K1, K3,
# K2 on the tensor cores, then on the CUDA cores), each at every HEAD_DIMS pair
_COUNTED = (KERNELS["mma"][0], KERNELS["mma"][2], KERNELS["mma"][1],
            KERNELS["fma"][0], KERNELS["fma"][2], KERNELS["fma"][1])


def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if lib.fa_forward.argtypes is None:
        tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float] + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.fa_forward.argtypes = [ctypes.c_void_p] * 11 + tail
        lib.fa_backward_dq.argtypes = [ctypes.c_void_p] * 13 + tail
        lib.fa_backward_dkv.argtypes = [ctypes.c_void_p] * 14 + tail
        for fn in (lib.fa_forward, lib.fa_backward_dq, lib.fa_backward_dkv):
            fn.restype = ctypes.c_int
        lib.fa_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.fa_smem_bytes.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [ctypes.c_int]
        lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def launch_counts(by_head_dims: bool = False, lib=None) -> dict:
    """Launches of each device kernel since the counters were last reset,
    as the library's C dispatch counts them (each launch issued without
    error), keyed as `KERNELS` names the kernels; with `by_head_dims`,
    keyed (name, (D, Dv)) for every pair of `HEAD_DIMS`. `lib`: the
    library to read (the built one by default, built on first use)."""
    counts = read_counts((lib or _lib()).fa_launch_counts)
    keyed = {(name, dims): counts[i * len(HEAD_DIMS) + j]
             for i, name in enumerate(_COUNTED) for j, dims in enumerate(HEAD_DIMS)}
    if by_head_dims:
        return keyed
    return {name: sum(counts[i * len(HEAD_DIMS):(i + 1) * len(HEAD_DIMS)])
            for i, name in enumerate(_COUNTED)}


def kernel_launches(lib=None) -> dict:
    """K1's, K2's and K3's launches since the counters were last reset, on
    either route and at every head-dim pair, from `launch_counts()`."""
    counts = launch_counts(lib=lib)
    return {name: counts[KERNELS["mma"][i]] + counts[KERNELS["fma"][i]]
            for i, name in enumerate(("K1", "K2", "K3"))}


def reset_launch_counts(lib=None) -> None:
    """Sets `launch_counts()`'s counters to 0."""
    (lib or _lib()).fa_reset_launch_counts()


def route(dtype: torch.dtype) -> str:
    """K1-K3's route for inputs of `dtype`: "mma" (tensor cores, bfloat16)
    or "fma" (CUDA cores, float32)."""
    return _ROUTES[dtype]


# smem_bytes' kernel codes: (route, kernel) -> which
SMEM_WHICH = {("mma", "fwd"): 0, ("mma", "dkv"): 1, ("mma", "dq"): 2,
              ("fma", "fwd"): 3, ("fma", "dkv"): 4, ("fma", "dq"): 5}


def smem_bytes(route_name: str, kernel: str, D: int, Dv: int) -> int:
    """Dynamic shared memory (bytes) of K1 ("fwd"), K2 ("dq") or K3 ("dkv")
    on `route_name` ("mma" or "fma") at q/k head dim D and v head dim Dv."""
    return _lib().fa_smem_bytes(SMEM_WHICH[route_name, kernel], D, Dv)


def check_supported(q, k, v):
    """Raise NotImplementedError for the head dims K1-K3 do not cover: q and
    k head dims that differ, and (q/k, v) head dims that are not an
    instantiated pair. Called before any device check, so the refusal is
    the same on every device."""
    D, Dk, Dv = q.shape[-1], k.shape[-1], v.shape[-1]
    if D != Dk:
        raise NotImplementedError(
            f"flash attention kernels: head dims q {D}, k {Dk}, v {Dv} differ")
    if (D, Dv) not in HEAD_DIMS:
        what = f"head dim {D}" if D == Dv else f"head dims q/k {D}, v {Dv}"
        raise NotImplementedError(
            f"flash attention kernels: {what} is not one of the instantiated "
            f"(q/k, v) pairs {HEAD_DIMS}")


def padded_head_dims(D: int, Dv: int) -> tuple:
    """The instantiated (q/k, v) pair that K1-K3 run a (D, Dv) head at: the
    smallest with q/k >= D and v >= Dv (8 -> 16, 32 -> 64, 96 -> 128,
    (64, 96) -> (128, 128)). The caller zero-pads q and k to the first, v
    to the second, as the Pallas entry pads every head dim to 128 lanes:
    the pad lanes add zero logits and zero value columns. Raises
    NotImplementedError above 256."""
    fits = [p for p in HEAD_DIMS if p[0] >= D and p[1] >= Dv]
    if not fits:
        raise NotImplementedError(
            f"flash attention kernels: head dims q/k {D}, v {Dv} exceed every "
            f"instantiated (q/k, v) pair {HEAD_DIMS}")
    return min(fits, key=sum)


def pad_head_dim(x: torch.Tensor, n: int) -> torch.Tensor:
    """x zero-padded on its last dim to n (x itself when it is n wide)."""
    return x if x.shape[-1] == n else F.pad(x, (0, n - x.shape[-1])).contiguous()


def _check(tensors: dict, q):
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
    for name in ("lse", "delta"):
        if name in tensors and tensors[name].shape != (B, Hq, S):
            raise ValueError(f"{name} must be (B, Hq, S)")


def granule_ranges(pos: torch.Tensor) -> torch.Tensor:
    """(B, ceil(N / GRANULE), 2) int32: the min and max of each GRANULE-row
    granule of the (B, N) int32 positions, on their device (no host read)."""
    B, N = pos.shape
    pad = (-N) % GRANULE
    lim = torch.iinfo(torch.int32)
    lo = F.pad(pos, (0, pad), value=lim.max).view(B, -1, GRANULE).amin(-1)
    hi = F.pad(pos, (0, pad), value=lim.min).view(B, -1, GRANULE).amax(-1)
    return torch.stack((lo, hi), -1).contiguous()


class Masks(NamedTuple):
    """The kernels' mask arguments: the causal code (0 none, 1 by index, 2
    by position), the window (0 none) and the int32 tensors (q_seg, kv_seg,
    q_pos, kv_pos, q_rng, kv_rng), each None where the masks do not read
    it."""
    code: int
    window: int
    ints: tuple


def mask_args(q, k, *, causal=True, segment_ids=None, kv_segment_ids=None,
              positions=None, kv_positions=None, sliding_window=None) -> Masks:
    """The kernels' `Masks` for the wrappers' mask keywords, the Pallas
    entry's contract: causal by position when the kv side has positions or
    segment ids of its own. The int32 tensors must lie on q's device; the
    granule ranges are computed there. A caller that runs K1-K3 on the same
    masks makes them once and hands them to each wrapper as `masks`."""
    B, S, T = q.shape[0], q.shape[1], k.shape[1]
    asym = kv_positions is not None or kv_segment_ids is not None
    code = 0 if not causal else (2 if asym else 1)
    window = 0
    if sliding_window is not None:
        window = int(sliding_window)
        if window < 1:
            raise ValueError(f"sliding_window must be positive (got {window})")

    def ints(x, n, name):
        if x.dtype != torch.int32 or tuple(x.shape) != (B, n):
            raise TypeError(f"{name} must be int32 (B, {n}) = {(B, n)}")
        if x.device != q.device:
            raise ValueError(f"{name} must be on q's device {q.device}")
        return x.contiguous()

    def zeros(n):
        return torch.zeros((B, n), dtype=torch.int32, device=q.device)

    qs = ks = qp = kp = qr = kr = None
    if segment_ids is not None or kv_segment_ids is not None:
        qs = zeros(S) if segment_ids is None else ints(segment_ids, S, "segment_ids")
        if asym:
            ks = zeros(T) if kv_segment_ids is None else ints(
                kv_segment_ids, T, "kv_segment_ids")
        elif S != T:
            raise ValueError("segment ids without kv_segment_ids need S == T")
        else:
            ks = qs
    if window or code == 2:
        qp = (torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S)
              .contiguous() if positions is None else ints(positions, S, "positions"))
        if kv_positions is not None:
            kp = ints(kv_positions, T, "kv_positions")
        elif S == T:
            kp = qp
        else:
            raise ValueError("positions without kv_positions need S == T")
        qr = granule_ranges(qp)
        kr = qr if kp is qp else granule_ranges(kp)
    return Masks(code, window, (qs, ks, qp, kp, qr, kr))


def _aligned(*tensors):
    """The tensors, each copied if it does not start on a 16-byte boundary
    (a view at an offset): the tensor-core route copies rows in 16-byte
    chunks."""
    return [x if x.data_ptr() % 16 == 0 else x.clone() for x in tensors]


def _common(q, k, v, scale, soft_cap, code, window):
    if soft_cap is not None and soft_cap <= 0:
        raise ValueError(f"soft_cap must be positive (got {soft_cap})")
    B, S, Hq, D = q.shape
    return (B, S, k.shape[1], Hq, k.shape[2], D, v.shape[3], float(scale),
            float(soft_cap or 0.0), code, window, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _ptrs(ints) -> list:
    return [0 if x is None else x.data_ptr() for x in ints]


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        msg = lib.fa_error_string(err).decode()
        raise RuntimeError(f"flash attention {what} launch failed: {msg}")


def flash_fwd_cuda(q, k, v, segment_ids=None, *, scale: float,
                   soft_cap: float | None = None, causal: bool = True,
                   kv_segment_ids=None, positions=None, kv_positions=None,
                   sliding_window: int | None = None, masks: Masks | None = None):
    """K1 on `route(q.dtype)`. q (B, S, Hq, D), k (B, T, Hkv, D), v
    (B, T, Hkv, Dv), float32 or bfloat16, (D, Dv) in `HEAD_DIMS`. The masks
    take the Pallas entry's keywords: segment_ids (B, S) and kv_segment_ids
    (B, T), positions (B, S) and kv_positions (B, T), int32 on the card or
    None; causal masking is by position when the kv side has positions or
    segment ids of its own, else by index; sliding_window None or a
    positive int, on positions (arange when not given). Returns out
    (B, S, Hq, Dv) in q's dtype and lse (B, Hq, S) fp32, EMPTY_LSE on fully
    masked rows. `masks`, when given (`mask_args`'s), replaces the mask
    keywords."""
    check_supported(q, k, v)
    _check(dict(q=q, k=k, v=v), q)
    code, window, ints = masks or mask_args(
        q, k, causal=causal, segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
        positions=positions, kv_positions=kv_positions, sliding_window=sliding_window)
    dims = _common(q, k, v, scale, soft_cap, code, window)
    if route(q.dtype) == "mma":
        q, k, v = _aligned(q, k, v)
    B, S, Hq, _ = q.shape
    out = torch.empty((B, S, Hq, v.shape[3]), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             *_ptrs(ints), out.data_ptr(), lse.data_ptr(), *dims)
    _raise_on(err, lib, "forward")
    return out, lse


def flash_dq_cuda(q, k, v, dout, lse, delta, segment_ids=None, *,
                  scale: float, soft_cap: float | None = None,
                  causal: bool = True, kv_segment_ids=None, positions=None,
                  kv_positions=None, sliding_window: int | None = None,
                  masks: Masks | None = None):
    """K2 on `route(q.dtype)`: dq (B, S, Hq, D) in q's dtype from dout
    (B, S, Hq, Dv) in q's dtype and the fp32 (B, Hq, S) lse and delta."""
    check_supported(q, k, v)
    _check(dict(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta), q)
    code, window, ints = masks or mask_args(
        q, k, causal=causal, segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
        positions=positions, kv_positions=kv_positions, sliding_window=sliding_window)
    dims = _common(q, k, v, scale, soft_cap, code, window)
    if route(q.dtype) == "mma":
        q, k, v, dout = _aligned(q, k, v, dout)
    dq = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.fa_backward_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *_ptrs(ints), dq.data_ptr(),
            *dims)
    _raise_on(err, lib, "dq")
    return dq


def flash_dkv_cuda(q, k, v, dout, lse, delta, segment_ids=None, *,
                   scale: float, soft_cap: float | None = None,
                   causal: bool = True, kv_segment_ids=None, positions=None,
                   kv_positions=None, sliding_window: int | None = None,
                   masks: Masks | None = None):
    """K3 on `route(q.dtype)`: (dk, dv), (B, T, Hkv, D) and (B, T, Hkv, Dv)
    in k's dtype; inputs as K2's."""
    check_supported(q, k, v)
    _check(dict(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta), q)
    code, window, ints = masks or mask_args(
        q, k, causal=causal, segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
        positions=positions, kv_positions=kv_positions, sliding_window=sliding_window)
    dims = _common(q, k, v, scale, soft_cap, code, window)
    if route(q.dtype) == "mma":
        q, k, v, dout = _aligned(q, k, v, dout)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.fa_backward_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *_ptrs(ints), dk.data_ptr(),
            dv.data_ptr(), *dims)
    _raise_on(err, lib, "dk/dv")
    return dk, dv
