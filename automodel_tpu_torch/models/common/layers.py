"""Initializers, the compute-dtype cast, remat and the layer loop (port of
`automodel_tpu/models/common/layers.py`).

Random draws come from an explicit `torch.Generator`; they do not reproduce
`jax.random`'s numbers, so parity tests hand both packages the same numpy
weights instead.

The JAX package scans one compiled layer body over weights stacked on a
leading `(L, ...)` dim, under `jax.checkpoint`. Here the same stacked
weights are split into per-layer views once (`unstack_layers`: one
`unbind`, whose backward stacks the L layer gradients in one pass) and a
Python loop runs the layers, each under `torch.utils.checkpoint` when the
remat policy is "full". The carry may be any nesting of tuples of tensors,
as JAX's scan carry: the MoE decoder's holds the hidden state, the summed
aux loss and a tuple of the MoE layers' tokens per expert.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from automodel_tpu_torch.utils.tree import tree_leaves, tree_map

# "none" saves every activation; "full" recomputes each layer in backward
# (jax.checkpoint_policies.nothing_saveable). The JAX package's selective
# policies ("dots", "dots_with_no_batch_dims", "checkpoint_dots") are not
# ported.
REMAT_POLICIES = ("none", "full")


def maybe_remat(fn: Callable, policy_name: str | None) -> Callable:
    if policy_name is None or policy_name == "none":
        return fn
    if policy_name != "full":
        raise NotImplementedError(
            f"remat policy {policy_name!r} is not ported (ported: {REMAT_POLICIES})"
        )

    def remat(*args):
        return checkpoint(fn, *args, use_reentrant=False)

    return remat


def unstack_layers(stacked) -> list:
    """A nested dict of (L, ...) tensors -> L dicts of per-layer views."""
    if isinstance(stacked, dict):
        per_key = {k: unstack_layers(v) for k, v in stacked.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(stacked, 0))


def scan_layers(layer_fn: Callable, carry, stacked_params, *,
                remat_policy: str | None = "full"):
    """Run `layer_fn(carry, layer_params) -> carry` over stacked weights."""
    fn = maybe_remat(layer_fn, remat_policy)
    for lp in unstack_layers(stacked_params):
        carry = fn(carry, lp)
    return carry


def scan_layers_windowed(layer_fn: Callable, carry, stacked_params,
                         windows: tuple, *, remat_policy: str | None = "full"):
    """`layer_fn(carry, layer_params, window) -> carry` over stacked weights
    whose static sliding windows differ per layer."""
    fn = maybe_remat(layer_fn, remat_policy)
    layers = unstack_layers(stacked_params)
    if len(layers) != len(windows):
        raise ValueError(f"{len(windows)} windows for {len(layers)} layers")
    for lp, w in zip(layers, windows):
        carry = fn(carry, lp, w)
    return carry


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (±3 std) fan-in init on the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    return _trunc_normal(gen, shape, std, dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               std: float = 0.02) -> torch.Tensor:
    return _trunc_normal(gen, shape, std, dtype)


#: a leaf of more elements than this in a narrower dtype than fp32 is drawn
#: in blocks of whole slices along dim 0, each of at most this many elements
#: where a slice fits, so its fp32 draw never exists whole (a Moonlight
#: expert stack is 4.8 G elements: 19 GB in fp32) and a wide table takes a
#: few draws, not one per row (Qwen3-30B-A3B's embedding has 151936 rows)
_CHUNKED_DRAW = 1 << 27


def _trunc_normal(gen, shape, std, dtype):
    shape = tuple(shape)
    if dtype != torch.float32 and math.prod(shape) > _CHUNKED_DRAW and len(shape) > 1:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        rows = max(1, _CHUNKED_DRAW // math.prod(shape[1:]))
        for i in range(0, shape[0], rows):
            n = min(rows, shape[0] - i)
            block = _trunc_normal(gen, (n, *shape[1:]) if rows > 1 else shape[1:], std, dtype)
            out[i:i + n] = block.reshape(n, *shape[1:])
        return out
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, std, -3.0 * std, 3.0 * std, generator=gen)
    return x.to(dtype)


def init_fns(gen: torch.Generator, dtype: torch.dtype = torch.float32):
    """(ones, zeros, dense) leaf makers on the generator's device in `dtype`:
    `dense(*shape)` is `dense_init` (fan-in std from shape[-2])."""
    dev = gen.device

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def dense(*shape):
        return dense_init(gen, shape, dtype)

    return ones, zeros, dense


def cast_params(params, dtype: torch.dtype, device=None):
    """Compute-dtype cast of a nested dict of tensors (floating leaves only),
    optionally moving every leaf to `device`. A leaf already in place is
    returned as is, not copied. Differentiable: the fp32 masters of a
    training forward get their gradients through it."""
    return tree_map(
        lambda p: p.to(device=device, dtype=dtype) if p.is_floating_point()
        else p.to(device), params)


def count_params(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))
