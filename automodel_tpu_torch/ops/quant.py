"""FP8 / INT8 quantized matmul, QAT fake-quant and the paged-KV int8 rows
(port of `automodel_tpu/ops/quant.py`).

- `quantized_matmul`: x (..., K) @ w (K, N) with per-channel dynamic scales
  (one per row of x over K, one per column of w): quantize, multiply in the
  low-precision type with an fp32 result, rescale by `sx * sw`, cast to x's
  dtype. The backward runs in bf16 on the ORIGINAL operands, as the JAX
  custom vjp does: dx is rounded through bf16, dw has an fp32 result. The
  decoders' linears opt in with `linear_precision = "fp8" | "int8"`
  (`matmul`), the serving engine with `serve_precision`.
- `fake_quantize` / `QATConfig.make_param_transform`: straight-through
  quantize-dequantize of the weight kernels inside the train step, on once
  `step >= start_step`.
- `quantize_kv_rows` / `dequantize_kv`: the int8 KV pages' rows.

The low-precision product (`_qproduct`) has one route per device. On CUDA
tensors it is the library GEMM the matrix product maps to (the JAX package
computes it in XLA, outside Pallas): fp8 through `torch._scaled_mm` (e4m3
operands, unit scales, an fp32 result; rows are padded to a multiple of
16), int8 through `torch._int_mm` (exact int32 sums; rows padded to at
least 32, a multiple of 16); the second operand column-major for both.
The product is then rescaled as JAX does, `acc * (sx * sw)` in fp32, and
cast: `_scaled_mm`'s own row-wise scaling applies `acc * sx` first, which
overflows fp32 for an inf-adjacent row whose scaled result is finite. A
shape the route does not take (K or N not a multiple of 16 for fp8, of 8
for int8) raises NotImplementedError; nothing falls back. On CPU tensors the
quantized operands are widened to fp32 (exact) and multiplied there: the
plain version, which runs on the card only when the caller passes
`impl="torch"`. `LAUNCHES` counts the CUDA routes' GEMM launches.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # float8_e4m3fn
INT8_MAX = 127.0

_F32 = torch.finfo(torch.float32)

# GEMM launches of the CUDA routes, by precision
LAUNCHES = {"fp8": 0, "int8": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _qparams(precision: str):
    if precision == "int8":
        return torch.int8, INT8_MAX
    if precision == "fp8":
        return torch.float8_e4m3fn, FP8_MAX
    raise ValueError(f"Unknown quantization precision '{precision}' (int8|fp8)")


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """`amax / qmax + 1e-12` as XLA computes it in every jitted JAX program
    (the recipe's train step, the engine's step): the division by the
    constant becomes a product with its fp32 reciprocal, fused with the add
    into one rounding. Formed in float64, where the product of two fp32
    values is exact, then rounded once, so every device gives the same
    bits."""
    r = float(torch.tensor(1.0 / qmax, dtype=torch.float32))
    return (amax.double() * r + float(torch.tensor(1e-12, dtype=torch.float32))).float()


def _quantize(x: torch.Tensor, qdtype, qmax: float, dim=None):
    """dim=None: one scale for the tensor; else per channel, reduced over
    `dim` (kept), the scale `amax / qmax + 1e-12` (`_scale`). Every other
    intermediate is fp32: x is clipped to the fp32 range before the
    division and clamped to ±qmax before the cast, so an inf-adjacent input
    saturates to the grid's edge instead of riding inf/inf = NaN, and
    e4m3fn (no inf) never sees an out-of-range value. Returns (q, fp32
    scale)."""
    with torch.no_grad():  # in place on its own fp32 copy of x
        xf = x.float()
        if xf.data_ptr() == x.data_ptr():
            xf = xf.clone()
        xf.clamp_(_F32.min, _F32.max)
        if dim is None:
            amax = torch.linalg.vector_norm(xf, float("inf"))
        else:
            amax = torch.linalg.vector_norm(xf, float("inf"), dim=dim, keepdim=True)
        scale = _scale(amax, qmax)
        q = xf.div_(scale)
        if qdtype == torch.int8:
            q.round_()
        return q.clamp_(-qmax, qmax).to(qdtype), scale


@dataclasses.dataclass(frozen=True)
class QuantizedKernel:
    """A (K, N) weight quantized once, for a caller whose weights do not
    change (the serving engine): `w` the original (the backward's
    operand), `qw` the quantized (K, N) kernel (column-major on the card,
    as the GEMMs take it), `sw` its (1, N) fp32 column scales. The
    scales are a function of `w` alone, so these are the numbers
    `quantized_matmul` would compute in every call."""

    w: torch.Tensor
    qw: torch.Tensor
    sw: torch.Tensor
    precision: str


def quantize_kernel(w: torch.Tensor, precision: str) -> QuantizedKernel:
    qdtype, qmax = _qparams(precision)
    qw, sw = _quantize(w, qdtype, qmax, dim=0)
    if w.is_cuda:  # the GEMMs' second operand column-major
        qw = qw.t().contiguous().t()
    return QuantizedKernel(w, qw, sw, precision)


def _pad_rows(a: torch.Tensor, multiple: int, minimum: int = 0) -> torch.Tensor:
    M = a.shape[0]
    Mp = max(-(-M // multiple) * multiple, minimum)
    return F.pad(a, (0, 0, 0, Mp - M)) if Mp != M else a


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"Unknown quantized matmul impl '{impl}'")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl


def _qproduct(qx, sx, qw, sw, precision: str, out_dtype, impl: str = "auto") -> torch.Tensor:
    """(M, K) x (K, N) low-precision product rescaled by sx (M, 1) * sw
    (1, N), in `out_dtype`; the route follows the device unless `impl`
    names one (module docstring)."""
    M = qx.shape[0]
    K, N = qw.shape
    if _resolve(impl, qx) == "torch":
        out = (qx.float() @ qw.float()) * (sx * sw)
        return out.to(out_dtype)
    if precision == "fp8" and (K % 16 or N % 16):
        raise NotImplementedError(
            f"fp8 route: K and N must be multiples of 16 (got K={K}, N={N})")
    if precision == "int8" and (K % 8 or N % 8):
        raise NotImplementedError(
            f"int8 route: K and N must be multiples of 8 (got K={K}, N={N})")
    if qw.stride(0) != 1:
        qw = qw.t().contiguous().t()
    LAUNCHES[precision] += 1
    if precision == "fp8":
        one = torch.ones((), dtype=torch.float32, device=qx.device)
        acc = torch._scaled_mm(_pad_rows(qx, 16), qw, scale_a=one, scale_b=one,
                               out_dtype=torch.float32)
    else:
        acc = torch._int_mm(_pad_rows(qx, 16, minimum=32), qw)
    # int32 * fp32 promotes to fp32: JAX's fp32 product times (sx * sw)
    return (acc[:M] * (sx * sw)).to(out_dtype)


class _QuantizedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, precision, kernel, impl):
        qdtype, qmax = _qparams(precision)
        x2 = x.reshape(-1, x.shape[-1])
        qx, sx = _quantize(x2, qdtype, qmax, dim=-1)   # (M, 1)
        if kernel is None:
            kernel = quantize_kernel(w, precision)
        out = _qproduct(qx, sx, kernel.qw, kernel.sw, precision, x.dtype, impl)
        ctx.save_for_backward(x, w)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        # bf16 on the ORIGINAL operands: dynamic-scaling fp8 training
        # quantizes forward only; the gradients stay high precision
        from automodel_tpu_torch.ops.matmul import matmul_fp32

        x, w = ctx.saved_tensors
        gf = g.reshape(-1, g.shape[-1]).to(torch.bfloat16)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (gf @ w.to(torch.bfloat16).T).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
            dw = matmul_fp32(xb.T.contiguous(), gf).to(w.dtype)
        return dx, dw, None, None, None


def quantized_matmul(x: torch.Tensor, w, precision: str = "fp8",
                     impl: str = "auto") -> torch.Tensor:
    """x (..., K) @ w (K, N) with per-channel dynamic quantization: one
    scale per row of x (over K) and per column of w. `w` may be a
    `QuantizedKernel` (quantized once by the caller). impl: "auto" (the
    CUDA route for CUDA tensors, the plain version for CPU tensors) |
    "cuda" | "torch"."""
    if isinstance(w, QuantizedKernel):
        if w.precision != precision:
            raise ValueError(f"kernel quantized {w.precision}, asked {precision}")
        return _QuantizedMatmul.apply(x, w.w, precision, w, impl)
    return _QuantizedMatmul.apply(x, w, precision, None, impl)


def matmul(x: torch.Tensor, kernel, precision: str | None = None) -> torch.Tensor:
    """Precision-dispatching matmul used by the decoders' linears."""
    if precision in ("fp8", "int8"):
        return quantized_matmul(x, kernel, precision)
    if precision is not None:
        raise ValueError(f"Unknown linear precision '{precision}'")
    return x @ kernel


# ---------------------------------------------------------------------------
# Paged-KV quantization (the int8 pools of serving/kv_pages.py)
# ---------------------------------------------------------------------------
def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """New-token KV cache rows → (int8 rows, per-row fp32 scales).

    `x` is (T, ...): one cache row per leading index (a GQA (Hkv, D) K or V
    row, an MLA (r,) latent or (dr,) rope row); everything behind the
    leading dim shares ONE scale, the granularity of the pool's (L, N+1, ps)
    scale planes. fp32 clip first, `+ 1e-12` on the scale, and rounding half
    to even (`torch.round`, as `jnp.round`)."""
    xf = torch.clamp(x.float(), _F32.min, _F32.max)
    red = tuple(range(1, x.dim()))
    scale = torch.amax(torch.abs(xf), dim=red) / INT8_MAX + 1e-12
    sb = scale.reshape(scale.shape + (1,) * (x.dim() - 1))
    q = torch.clamp(torch.round(xf / sb), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_kv_rows` over gathered page views: `scale`'s dims
    align with `q`'s leading dims and broadcast over the rest. Returns fp32."""
    sb = scale.reshape(scale.shape + (1,) * (q.dim() - scale.dim()))
    return q.float() * sb


# ---------------------------------------------------------------------------
# QAT
# ---------------------------------------------------------------------------
def fake_quantize(x: torch.Tensor, precision: str = "int8") -> torch.Tensor:
    """Straight-through quantize-dequantize: the forward sees the quantized
    grid, the gradient passes through unchanged (STE). Per-channel scales
    over the last (output) dim: reduced over the second-to-last, so stacked
    (L, in, out) kernels get per-layer-per-column scales."""
    qdtype, qmax = _qparams(precision)
    dim = -2 if x.dim() >= 2 else None
    q, scale = _quantize(x, qdtype, qmax, dim=dim)
    qdq = (q.float() * scale).to(x.dtype)
    return x + (qdq - x).detach()


@dataclasses.dataclass(frozen=True)
class QATConfig:
    """Quantization-aware training: fake-quant the weight kernels inside the
    train step; `start_step` delays it (train in high precision first)."""

    enabled: bool = False
    precision: str = "int8"  # int8 | fp8
    start_step: int = 0

    def make_param_transform(self):
        """(params, step) -> params with every leaf named 'kernel'
        fake-quantized once step >= start_step (embeddings, norms and biases
        stay high precision); None when disabled."""
        if not self.enabled:
            return None

        def transform(params, step):
            if step < self.start_step:
                return params

            def walk(node):
                return {k: (walk(v) if isinstance(v, dict)
                            else fake_quantize(v, self.precision) if k == "kernel"
                            else v)
                        for k, v in node.items()}

            return walk(params)

        return transform
