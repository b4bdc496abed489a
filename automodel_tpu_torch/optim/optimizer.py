"""Optimizer and learning-rate schedule configs (port of
`automodel_tpu/optim/optimizer.py`).

The JAX package builds optax transforms; here the same update rules run on a
nested dict of fp32 master tensors, in place, one leaf at a time (so the
temporaries stay the size of one leaf):

- adamw: p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), with
  m_hat, v_hat bias-corrected at the incremented count (optax.adamw);
- adam: the same without weight decay (optax.adam);
- sgd: t <- g + momentum * t, p <- p - lr * t (optax.sgd with momentum).

The learning rate is the schedule at the count before the increment, as
optax's `scale_by_learning_rate` reads it. `update(..., ok=...)` applies
the update only where a bool tensor on the card holds, as the JAX step's
`skip_nonfinite_updates` selects `jnp.where(ok, new, old)` over the params
and the whole optimizer state, count included; it reads nothing to the
host, so the count lives on the card and the learning rate is looked up
there in a table of the schedule's values. Weight decay applies where the
mask is true; the default mask is `ndim >= 2` on the stacked-layer layout,
so per-layer norm scales, stacked as (L, H), are decayed, as in the JAX
package, and so is the MoE gate's stacked (Lm, E) correction bias
`e_score_bias`, whose gradient is 0: AdamW moves it by -lr * wd * p
besides the aux-free sign updates.

On a mesh the params, gradients and moments are DTensors: the update runs
on their local shards (`to_local()`, in place), elementwise, so sharding
changes nothing of the rule; the decay mask reads each leaf's dims, which a
shard keeps (the global `ndim >= 2`).

`param_groups` (JAX `optax.multi_transform`): each group is a `pattern`,
searched as a regex in the slash-joined path of every leaf
("layers/q_proj/kernel"), with an `lr_mult` on the schedule and a
`weight_decay`; a leaf takes the first group that matches, else the
default one. Every group runs the same rule with its own hyperparameters,
so one rule with per-leaf multipliers and decays is the same update.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Optional

import torch

from automodel_tpu_torch.parallel.sharding import local_tree
from automodel_tpu_torch.utils.tree import tree_leaves, tree_map


def default_weight_decay_mask(params) -> dict:
    """Decay leaves with ndim >= 2 (matrices, and stacked (L, H) scales)."""
    return tree_map(lambda p: p.dim() >= 2, params)


class Optimizer:
    """An optax-equivalent update rule: `init(params) -> state`, then
    `update(grads, state, params)` updates params and state in place."""

    def __init__(self, name: str, lr, *, betas=(0.9, 0.95), eps=1e-8,
                 weight_decay=0.0, momentum=0.9, mask_fn=None, groups_fn=None):
        self.name = name
        self.lr = lr if callable(lr) else (lambda count, v=float(lr): v)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.momentum = float(momentum)
        self.mask_fn = mask_fn or default_weight_decay_mask
        # params -> one (lr multiplier, weight decay) per leaf; None: (1, wd)
        self.groups_fn = groups_fn
        self._table: Optional[torch.Tensor] = None  # the schedule by count

    def _leaf_hparams(self, params, n: int) -> list:
        if self.groups_fn is None:
            return [(1.0, self.weight_decay)] * n
        return self.groups_fn(params)

    def init(self, params) -> dict:
        if self.name == "sgd":
            return {"count": 0, "trace": tree_map(torch.zeros_like, params)}
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads, state: dict, params, ok: Optional[torch.Tensor] = None,
               max_count: int = 0) -> None:
        """Update params and state in place. With `ok` (a 0-dim bool tensor
        on the params' device) see `_update_where`; `max_count` bounds the
        count there (the steps taken)."""
        view = {k: (v if k == "count" else local_tree(v)) for k, v in state.items()}
        self._update(local_tree(grads), view, local_tree(params), ok, max_count)
        state["count"] = view["count"]

    def _update(self, grads, state: dict, params, ok, max_count: int) -> None:
        if ok is not None:
            self._update_where(grads, state, params, ok, max_count)
            return
        count = state["count"]
        lr = float(self.lr(count))
        ps, gs = tree_leaves(params), tree_leaves(grads)
        hp = self._leaf_hparams(params, len(ps))
        if self.name == "sgd":
            for p, g, t, (mult, _) in zip(ps, gs, tree_leaves(state["trace"]), hp):
                t.mul_(self.momentum).add_(g)
                p.add_(t, alpha=-lr * mult)
            state["count"] = count + 1
            return
        n = count + 1
        bc1, bc2 = 1.0 - self.b1 ** n, 1.0 - self.b2 ** n
        decay = tree_leaves(self.mask_fn(params))
        for p, g, m, v, d, (mult, wd) in zip(ps, gs, tree_leaves(state["mu"]),
                                             tree_leaves(state["nu"]), decay, hp):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            if d and wd:
                u.add_(p, alpha=wd)
            p.add_(u, alpha=-lr * mult)
        state["count"] = n

    def _lr_table(self, size: int, device: torch.device) -> torch.Tensor:
        """The schedule's values at counts 0.. (at least `size` of them) on
        `device`, in float64: made on the host, sent without waiting, and
        made anew at twice the length when a count passes it."""
        table = self._table
        if table is None or table.numel() < size or table.device != device:
            n = max(size, 2 * table.numel() if table is not None else 1024)
            host = torch.tensor([float(self.lr(c)) for c in range(n)], dtype=torch.float64)
            if device.type == "cuda":
                host = host.pin_memory()
            table = self._table = host.to(device, non_blocking=True)
        return table

    def _update_where(self, grads, state: dict, params, ok: torch.Tensor,
                      max_count: int) -> None:
        """The update where `ok` holds; otherwise params, moments and count
        keep their values. Nothing is read to the host: the count becomes
        an int64 tensor on `ok`'s device, and the learning rate is the
        schedule at it, from `_lr_table` over counts 0..`max_count`."""
        count = state["count"]
        if not torch.is_tensor(count) or count.device != ok.device:
            count = state["count"] = torch.full((), int(count), dtype=torch.int64,
                                                device=ok.device)
        # index_select, not table[count]: indexing by a tensor reads it
        lr = self._lr_table(max_count + 1, ok.device).index_select(0, count.view(1))[0]
        ps, gs = tree_leaves(params), tree_leaves(grads)
        hp = self._leaf_hparams(params, len(ps))

        def keep(live, new):
            live.copy_(torch.where(ok, new, live))

        if self.name == "sgd":
            for p, g, t, (mult, _) in zip(ps, gs, tree_leaves(state["trace"]), hp):
                t_new = t.mul(self.momentum).add_(g)
                keep(p, p + t_new * (lr * -mult))
                keep(t, t_new)
        else:
            n = (count + 1).double()
            bc1, bc2 = 1.0 - self.b1 ** n, 1.0 - self.b2 ** n
            decay = tree_leaves(self.mask_fn(params))
            for p, g, m, v, d, (mult, wd) in zip(ps, gs, tree_leaves(state["mu"]),
                                                 tree_leaves(state["nu"]), decay, hp):
                m_new = m.mul(self.b1).add_(g, alpha=1.0 - self.b1)
                v_new = v.mul(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                u = (m_new / bc1).div_((v_new / bc2).sqrt_().add_(self.eps))
                if d and wd:
                    u.add_(p, alpha=wd)
                keep(p, p + u.mul_(lr * -mult))
                keep(m, m_new)
                keep(v, v_new)
        count.add_(ok.to(count.dtype))


_ADAMW = ("adamw", "fused_adamw", "flash_adamw")
_ADAM = ("adam", "fused_adam")


@dataclasses.dataclass
class OptimizerConfig:
    """The JAX config's fields, so the same YAML sections load; `adamw`,
    `adam` and `sgd` are ported (with `param_groups`), other names raise."""

    name: str = "adamw"
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9  # sgd only
    adamw_lr: float = 3e-4  # muon/dion only
    dion_rank: int = 16     # dion only
    decay_mask: Optional[Callable] = dataclasses.field(default=None, repr=False)
    param_groups: tuple = ()

    def build(self, lr_schedule: "float | Callable" = None) -> Optimizer:
        lr = lr_schedule if lr_schedule is not None else self.lr
        groups_fn = self._groups_fn() if self.param_groups else None
        if self.name in _ADAMW or self.name in _ADAM:
            wd = self.weight_decay if self.name in _ADAMW else 0.0
            return Optimizer("adamw", lr, betas=self.betas, eps=self.eps,
                             weight_decay=wd, mask_fn=self.decay_mask,
                             groups_fn=groups_fn)
        if self.name == "sgd":
            return Optimizer("sgd", lr, momentum=self.momentum, groups_fn=groups_fn)
        raise NotImplementedError(
            f"optimizer '{self.name}' is not ported (ported: adamw, adam, sgd)")

    def _groups_fn(self) -> Callable:
        """params -> each leaf's (lr multiplier, weight decay) from the first
        group whose pattern its path matches (adam decays no group)."""
        groups = [g.to_dict() if hasattr(g, "to_dict") else dict(g)
                  for g in self.param_groups]
        for g in groups:
            if not g.get("pattern"):
                raise ValueError(
                    "optimizer.param_groups entries require a non-empty "
                    f"'pattern' (got {g})")
        decays = self.name in _ADAMW
        default = (1.0, self.weight_decay if decays else 0.0)
        hparams = [(float(g.get("lr_mult", 1.0)),
                    float(g.get("weight_decay", self.weight_decay)) if decays else 0.0)
                   for g in groups]

        def leaf_hparams(params) -> list:
            out = []
            for name in _leaf_paths(params):
                match = next((i for i, g in enumerate(groups)
                              if re.search(str(g["pattern"]), name)), None)
                out.append(default if match is None else hparams[match])
            return out

        return leaf_hparams


def _leaf_paths(tree, prefix: str = "") -> list:
    """Slash-joined key paths of the leaves, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, f"{prefix}/{k}" if prefix else str(k))]
    return [prefix]


def constant_schedule(value: float) -> Callable:
    return lambda count: value


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable:
    def schedule(count):
        c = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable:
    def schedule(count):
        c = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1.0 - c / transition_steps) + end_value
    return schedule


def join_schedules(schedules: list, boundaries: list) -> Callable:
    """optax.join_schedules: past each boundary, the next schedule runs on
    the count minus that boundary."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return schedule


@dataclasses.dataclass
class LRSchedulerConfig:
    """Warmup + decay schedule: cosine | linear | constant | wsd."""

    warmup_steps: int = 0
    decay_steps: int = 1000
    style: str = "cosine"
    min_lr_ratio: float = 0.0
    stable_steps: int = 0  # wsd only

    def build(self, peak_lr: float) -> Callable:
        floor = peak_lr * self.min_lr_ratio
        steps = max(self.decay_steps, 1)
        if self.style == "constant":
            sched = constant_schedule(peak_lr)
        elif self.style == "cosine":
            sched = cosine_decay_schedule(peak_lr, steps, alpha=self.min_lr_ratio)
        elif self.style == "linear":
            sched = linear_schedule(peak_lr, floor, steps)
        elif self.style == "wsd":
            # warmup handled below; stable then linear decay to floor
            sched = join_schedules(
                [constant_schedule(peak_lr), linear_schedule(peak_lr, floor, steps)],
                [self.stable_steps],
            )
        else:
            raise ValueError(f"Unknown LR style '{self.style}'")
        if self.warmup_steps > 0:
            warmup = linear_schedule(0.0, peak_lr, self.warmup_steps)
            return join_schedules([warmup, sched], [self.warmup_steps])
        return sched
