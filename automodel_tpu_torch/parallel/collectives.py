"""The collectives of the SPMD path as autograd functions, over
`torch.distributed` process groups (NCCL on the card, gloo on the CPU).

Where JAX's GSPMD inserts collectives from the sharding annotations, the
port calls them by name, each with the adjoint the layout needs:

- `gather_cast(x, dim, group, dtype)`: FSDP's unshard. Casts this rank's
  shard to the compute dtype and all-gathers it along `dim`; the backward
  widens the cotangent to the shard's dtype and reduce-scatters it (a sum
  over the group), so each rank keeps its shard of the summed gradient.
- `copy_to(x, group)` / `reduce_from(x, group)`: tensor parallelism's pair
  (Megatron's f and g). `copy_to` is the identity forward and all-reduces
  the cotangent (the input of column-parallel products, whose gradients
  are partial per rank); `reduce_from` all-reduces a row-parallel
  product's partial sums and passes the cotangent through.
- `all_reduce_sum(x, group)`: a sum over ranks whose cotangents are
  partial too (each rank's objective differs): the backward all-reduces.
  The MoE gate's global statistics use it.
- `all_to_all(x, out_splits, in_splits, group)`: the expert-parallel
  exchange with per-rank row counts; the backward exchanges the
  cotangents with the splits swapped.

A `group` of None stands for no axes: every function is then the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _gather_dim0(x: torch.Tensor, group) -> torch.Tensor:
    n = group_size(group)
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _scatter_dim0(x: torch.Tensor, group) -> torch.Tensor:
    n = group_size(group)
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along `dim` (no autograd)."""
    if dim == 0:
        return _gather_dim0(x, group)
    return _gather_dim0(x.movedim(dim, 0), group).movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum over the group and keep this rank's block of `dim` (no autograd)."""
    if dim == 0:
        return _scatter_dim0(x, group)
    return _scatter_dim0(x.movedim(dim, 0), group).movedim(0, dim)


class _GatherCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, dtype):
        ctx.dim, ctx.group, ctx.in_dtype = dim, group, x.dtype
        return all_gather_dim(x.to(dtype), dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g.to(ctx.in_dtype), ctx.dim, ctx.group), None, None, None


def gather_cast(x: torch.Tensor, dim, group, dtype: torch.dtype | None = None):
    """`x` cast to `dtype` (None: its own) and all-gathered along `dim`
    over `group`; the backward reduce-scatters in `x`'s dtype. `dim` None
    (the tensor is not split on the group) only casts."""
    dtype = x.dtype if dtype is None or not x.is_floating_point() else dtype
    if dim is None or group is None:
        return x.to(dtype)
    if not x.is_floating_point():  # int8 QLoRA bases: no gradient to carry
        return all_gather_dim(x, dim, group)
    return _GatherCast.apply(x, dim, group, dtype)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group, no gradient."""
    return x if group is None else _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def _exchange(x: torch.Tensor, out_splits: list, in_splits: list, group) -> torch.Tensor:
    out = torch.empty((sum(out_splits), *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x.contiguous(), out_splits, in_splits, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group):
        ctx.splits, ctx.group = (out_splits, in_splits), group
        return _exchange(x, out_splits, in_splits, group)

    @staticmethod
    def backward(ctx, g):
        out_splits, in_splits = ctx.splits
        return _exchange(g, in_splits, out_splits, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, out_splits: list, in_splits: list, group) -> torch.Tensor:
    """Rows `x` split by `in_splits` (rows for each rank, in rank order) go
    to their ranks; returns the `sum(out_splits)` rows received, by source
    rank. Differentiable in `x`."""
    if x.requires_grad:
        return _AllToAll.apply(x, out_splits, in_splits, group)
    return _exchange(x, out_splits, in_splits, group)
