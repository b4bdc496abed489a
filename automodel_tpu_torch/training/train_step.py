"""The optimizer step: grad accumulation, global-token normalization, grad
clipping, parameter update (port of `automodel_tpu/training/train_step.py`).

The JAX step is one jitted pure function with the microbatches in a
`lax.scan`. Here the microbatches run in a Python loop, each with its own
backward, and autograd sums their gradients into the fp32 masters' `.grad`;
then, once, the sum is divided by the global number of label tokens, clipped
by the global norm and handed to the optimizer, which updates the masters in
place. The loss function's aux dict is summed over the microbatches, key by
key, as the JAX scan sums it: the MoE decoder's (num_moe_layers, E) tokens
per expert come out of the step as the whole batch's counts.

`param_transform(params, step)` (QAT fake-quant) runs inside each
microbatch's differentiated function, on the step's count of optimizer
steps taken: the straight-through estimator routes the gradients of the
transformed tree to the fp32 masters unchanged.

On a mesh (`mesh_ctx`) each rank runs its slice of the global batch and
the params are DTensors (`parallel/`); the step then does what GSPMD does
to the JAX step:

- the label-token count and the CE sum are summed over the batch axes
  (`dp_replicate`, `dp_shard`, `ep`): the gradients are divided by the
  GLOBAL count;
- each gradient is summed over the batch axes its layout does not already
  reduce: the FSDP gather's backward reduce-scattered it over `dp_shard`
  when the leaf is split there, the expert all-to-all brought every `ep`
  rank's tokens to an expert split over `ep`; the rest (`dp_replicate`
  always: HSDP) is an all-reduce;
- the global norm sums each leaf's squared local norm over the axes the
  leaf is split on, and no others, so a replicated leaf counts once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from automodel_tpu_torch.distributed.mesh import MeshAxisName
from automodel_tpu_torch.optim.optimizer import Optimizer
from automodel_tpu_torch.parallel.sharding import is_dtensor, layout_of
from automodel_tpu_torch.utils.tree import tree_leaves, tree_map

_BATCH_AXES = ("dp_replicate", "dp_shard", "ep")


@dataclasses.dataclass
class TrainState:
    step: int   # optimizer steps taken
    params: Any  # nested dict of fp32 master tensors (requires_grad)
    opt_state: Any


def init_train_state(params, tx: Optimizer) -> TrainState:
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(step=0, params=params, opt_state=tx.init(params))


@dataclasses.dataclass
class TrainStepConfig:
    max_grad_norm: Optional[float] = 1.0
    # skip the optimizer update when gradients are non-finite
    skip_nonfinite_updates: bool = False


def accumulate_grads(loss_fn: Callable, params, batch: dict, rng=None,
                     param_transform: Callable | None = None, step: int = 0):
    """Forward and backward over the microbatches of `batch` (leaves
    (accum, microbatch, ...)); gradients of the SUM losses add up in the
    params' `.grad`. `param_transform(params, step)` is applied inside each
    microbatch's forward. Returns (summed loss, summed aux dict)."""
    accum = next(iter(batch.values())).shape[0]
    ce_sum, aux_sum = None, {}
    for i in range(accum):
        mb = {k: v[i] for k, v in batch.items()}
        p = param_transform(params, step) if param_transform is not None else params
        ce, aux = loss_fn(p, mb, rng)
        if not isinstance(aux, dict):
            aux = {"num_label_tokens": aux}
        ce.backward()
        ce = ce.detach()
        ce_sum = ce if ce_sum is None else ce_sum + ce
        for k, v in aux.items():
            v = v.detach() if torch.is_tensor(v) else v
            aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
    return ce_sum, aux_sum


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    norms = torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    return torch.linalg.vector_norm(norms)


class MeshGradSync:
    """The mesh's reductions for one param tree: each leaf's gradient sum
    over the batch axes its layout leaves unreduced, and its squared norm
    summed over the axes it is split on. The groups are the mesh's own
    (`MeshContext.build` made them all); they are looked up here once, in
    leaf order."""

    def __init__(self, mesh_ctx, params):
        self.batch = mesh_ctx.group("batch")
        self.reduce_groups, self.norm_axes = [], []
        for p in tree_leaves(params):
            split = set(layout_of(p).sharded_axes) if is_dtensor(p) else set()
            self.reduce_groups.append(
                mesh_ctx.group(tuple(a for a in _BATCH_AXES if a not in split)))
            self.norm_axes.append(tuple(a for a in MeshAxisName.ALL if a in split))
        self.norm_groups = {axes: mesh_ctx.group(axes) for axes in self.norm_axes}
        # no leaf split on a multi-rank axis: the one-device norm, the same
        # arithmetic
        self.split = any(g is not None for g in self.norm_groups.values())

    def sum_over_batch(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().clone()
        if self.batch is not None:
            dist.all_reduce(x, group=self.batch)
        return x

    def reduce_grads(self, grads: list) -> None:
        """In place on the local shards."""
        for g, group in zip(grads, self.reduce_groups):
            if group is not None:
                dist.all_reduce(g, group=group)

    def global_norm(self, grads: list) -> torch.Tensor:
        if not self.split:
            return global_norm(grads)
        sums: dict = {}  # by axes, in leaf order: the same on every rank
        for g, axes in zip(grads, self.norm_axes):
            sq = torch.linalg.vector_norm(g.float()) ** 2
            sums[axes] = sq if axes not in sums else sums[axes] + sq
        total = None
        for axes, sq in sums.items():
            group = self.norm_groups[axes]
            if group is not None:
                sq = sq.clone()
                dist.all_reduce(sq, group=group)
            total = sq if total is None else total + sq
        return torch.sqrt(total)


def make_train_step(
    loss_fn: Callable,  # (params, microbatch, rng) -> (loss_sum, aux)
    tx: Optimizer,
    lr_schedule: Callable | None = None,
    config: TrainStepConfig | None = None,
    param_transform: Callable | None = None,  # (params, step) -> params (QAT)
    mesh_ctx=None,
) -> Callable:
    """Build `train_step(state, batch, rng) -> (state, metrics)`. Loss
    functions return a SUM loss plus `aux`: the valid-token count, or a dict
    holding "num_label_tokens" and other per-step sums. With `mesh_ctx`,
    `batch` is this rank's slice and `state.params` DTensors."""
    config = config or TrainStepConfig()
    sync: list = []

    def train_step(state: TrainState, batch: dict, rng=None):
        params = tree_leaves(state.params)
        for p in params:
            p.grad = None
        ce_sum, aux_sum = accumulate_grads(loss_fn, state.params, batch, rng,
                                           param_transform, state.step)
        n_tokens = aux_sum["num_label_tokens"]
        if mesh_ctx is not None:
            if not sync:
                sync.append(MeshGradSync(mesh_ctx, state.params))
            n_tokens = sync[0].sum_over_batch(n_tokens)
            ce_sum = sync[0].sum_over_batch(ce_sum)
            aux_sum["num_label_tokens"] = n_tokens
        # normalize by the global number of label tokens, in place in .grad
        denom = torch.clamp(n_tokens.float(), min=1.0)
        with torch.no_grad():
            grads = tree_map(
                lambda p: (p.grad if p.grad is not None else torch.zeros_like(p)),
                state.params)
            local = [g.to_local() if is_dtensor(g) else g for g in tree_leaves(grads)]
            if mesh_ctx is not None:
                sync[0].reduce_grads(local)
            for g in local:
                g.div_(denom)
            grad_norm = (sync[0].global_norm(local) if mesh_ctx is not None
                         else global_norm(local))
            if config.max_grad_norm is not None:
                scale = torch.clamp(config.max_grad_norm / (grad_norm + 1e-6), max=1.0)
                for g in local:
                    g.mul_(scale)
        if config.skip_nonfinite_updates:
            # kept on the device, as the JAX step keeps it: the update is
            # selected by it, and nothing is read to the host
            ok = torch.isfinite(grad_norm) & torch.isfinite(ce_sum)
            tx.update(grads, state.opt_state, state.params, ok=ok, max_count=state.step)
        else:
            tx.update(grads, state.opt_state, state.params)
        del grads
        for p in params:
            p.grad = None
        metrics = {"loss": ce_sum / denom, "grad_norm": grad_norm, **aux_sum}
        if config.skip_nonfinite_updates:
            metrics["skipped_nonfinite"] = 1.0 - ok.float()
        if lr_schedule is not None:
            metrics["lr"] = lr_schedule(state.step)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step
