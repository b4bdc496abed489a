"""A matrix product with an fp32 result from operands of any float dtype:
the port's counterpart of `jnp.einsum(..., preferred_element_type=float32)`,
which the JAX package asks of XLA for the logits (`models/llm/decoder.py`
`unembed`) and the chunked loss (`loss/linear_ce.py`).

On CUDA a bf16 product goes through the aten `mm.dtype` overload
(`torch.mm(a, b, out_dtype=torch.float32)`): the card accumulates in fp32 and
the logits are never rounded to bf16. The CPU has no kernel for that
overload, so there the operands are widened to fp32 first, which gives the
same exact products. `mm.dtype` has no derivative, so the product is one
`torch.autograd.Function`; its backward rounds the fp32 cotangent to the
operands' dtype and multiplies in it, as a bf16 layer's backward does.
`bmm_fp32` is the batched form (aten `bmm.dtype` on CUDA), for the DSA
einsums that ask XLA for fp32 results.
"""

from __future__ import annotations

import torch


class _Fp32Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.dtype == torch.float32:
            return a @ b
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = g @ b.T if ctx.needs_input_grad[0] else None
        db = a.T @ g if ctx.needs_input_grad[1] else None
        return da, db


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) -> (..., N) in fp32; a and b share one dtype."""
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} and {b.dtype}")
    lead = a.shape[:-1]
    out = _Fp32Product.apply(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*lead, b.shape[-1])


class _Fp32BatchedProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.dtype == torch.float32:
            return torch.bmm(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = torch.bmm(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        db = torch.bmm(a.transpose(1, 2), g) if ctx.needs_input_grad[1] else None
        return da, db


def bmm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Bt, M, K) @ (Bt, K, N) -> (Bt, M, N) in fp32; a and b share one dtype."""
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} and {b.dtype}")
    return _Fp32BatchedProduct.apply(a, b)
