"""Logical-axis sharding rules, and the parameter tree as DTensors on the
mesh (port of `automodel_tpu/parallel/sharding.py`).

Every parameter carries a tuple of LOGICAL axis names, one per dim (each
model's `param_specs`), and the rule table maps them to mesh axes, as in
the JAX package: `embed` -> `dp_shard` (the FSDP dim), `heads`,
`kv_heads`, `mlp`, `vocab` -> `tp`, `expert` -> `ep`, `expert_embed` ->
`dp_shard`. `logical_to_shardings` turns a tree of logical specs into a
tree of `Layout`s (per-dim mesh axes and the DTensor placements), with the
JAX divisibility fallback: a dim whose size the product of its mesh axes
does not divide is replicated, with a warning.

`distribute_params` makes each leaf a DTensor holding this rank's box of
the full tensor (`DTensor.from_local` over the slice: no communication),
so the same seed gives the same global tensors on every mesh. Where JAX's
GSPMD inserts the collectives, the port's model code runs on the local
shards (`to_local()`) and makes them explicit (`parallel/spmd.py`).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Sequence

import torch

from automodel_tpu_torch.distributed.mesh import MeshAxisName, MeshContext
from automodel_tpu_torch.utils.tree import tree_map

logger = logging.getLogger(__name__)

#: Default rule table. First match wins per logical axis. Mesh axis entries
#: may be a single axis, a tuple, an alias from MeshAxisName.ALIASES, or None.
DEFAULT_RULES: tuple[tuple[str, Any], ...] = (
    # activations
    ("act_batch", "batch"),
    ("act_seq", "cp"),
    ("act_embed", None),
    ("act_heads", "tp"),
    ("act_kv_heads", "tp"),
    ("act_mlp", "tp"),
    ("act_vocab", "tp"),
    ("act_expert", "ep"),
    # parameters: the FSDP dim times the tp dim
    ("vocab", "tp"),
    ("embed", "dp_shard"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("mlp", "tp"),
    ("expert", "ep"),
    ("expert_embed", "dp_shard"),
    ("expert_mlp", "tp"),
    ("layers", "pp"),
    ("norm", None),
    # the serving pool (item 13)
    ("pages", None),
    ("mla_latent", "tp"),
)


@dataclasses.dataclass
class AxisRules:
    """Ordered (logical axis -> mesh axes) table with overrides."""

    rules: tuple[tuple[str, Any], ...] = DEFAULT_RULES

    def with_overrides(self, *overrides: tuple[str, Any]) -> "AxisRules":
        return AxisRules(rules=tuple(overrides) + self.rules)

    def lookup(self, logical: str) -> Any:
        for name, mesh_axes in self.rules:
            if name == logical:
                return mesh_axes
        raise KeyError(f"No sharding rule for logical axis '{logical}'")

    def spec(self, logical_axes: Sequence[Any], mesh_ctx: MeshContext) -> tuple:
        """Logical spec -> per-dim mesh axes (aliases resolved). A mesh axis
        is claimed by at most one dim of an array: the first keeps it."""
        used: set[str] = set()
        parts: list = []
        for ax in logical_axes:
            if ax is None:
                parts.append(None)
                continue
            mesh_axes = tuple(a for a in mesh_ctx.resolve_axes(self.lookup(ax))
                              if a not in used)
            used.update(mesh_axes)
            parts.append(None if not mesh_axes else
                         mesh_axes[0] if len(mesh_axes) == 1 else mesh_axes)
        return tuple(parts)


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a tensor lives on the mesh: `dims[d]` is the tuple of mesh axes
    (in mesh order) that split dim d. Size-1 axes are kept: the layout is the
    same on every topology."""

    dims: tuple

    def axes_of(self, d: int) -> tuple:
        return self.dims[d] if d < len(self.dims) else ()

    def dim_of(self, axis: str):
        """The dim `axis` splits, or None."""
        for d, axes in enumerate(self.dims):
            if axis in axes:
                return d
        return None

    @property
    def sharded_axes(self) -> tuple:
        return tuple(a for a in MeshAxisName.ALL if self.dim_of(a) is not None)

    def placements(self, mesh_ctx: MeshContext) -> list:
        """DTensor placements over the mesh's DeviceMesh dims; an axis of
        size 1 splits nothing, so it has no dim there."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for a in mesh_ctx.mesh_axes:
            d = self.dim_of(a) if mesh_ctx.sizes[a] > 1 else None
            out.append(Replicate() if d is None else Shard(d))
        return out

    def box(self, shape: Sequence[int], sizes: dict, coords: dict):
        """(offsets, sizes) of the block of a tensor of global `shape` at
        mesh `coords` (axis -> coordinate; `sizes` axis -> size; an axis
        missing from both is of size 1)."""
        offs, lens = [], []
        for d, n in enumerate(shape):
            idx, parts = 0, 1
            for a in self.axes_of(d):
                idx = idx * sizes.get(a, 1) + coords.get(a, 0)
                parts *= sizes.get(a, 1)
            offs.append(idx * (n // parts))
            lens.append(n // parts)
        return tuple(offs), tuple(lens)

    def is_primary(self, coords: dict) -> bool:
        """True on the one rank of each replica set that owns its block:
        coordinate 0 on every axis that does not split the tensor."""
        split = set(self.sharded_axes)
        return all(c == 0 for a, c in coords.items() if a not in split)


def layout_from_spec(pspec: tuple, shape: Sequence[int] | None,
                     mesh_ctx: MeshContext) -> Layout:
    """Per-dim mesh axes in mesh order, with the divisibility fallback when
    `shape` is given."""
    sizes = mesh_ctx.sizes
    ndim = len(shape) if shape is not None else len(pspec)
    parts = list(pspec) + [None] * (ndim - len(pspec))
    dims = []
    for d, entry in enumerate(parts):
        axes = tuple(a for a in MeshAxisName.ALL if a in _axes(entry))
        if shape is not None and axes:
            prod = math.prod(sizes[a] for a in axes)
            if shape[d] % prod != 0:
                logger.warning("dim of size %d not divisible by mesh axes %s (=%d); "
                               "replicating", shape[d], axes, prod)
                axes = ()
        dims.append(axes)
    return Layout(tuple(dims))


def _is_logical_spec(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _map_specs(fn, specs, *rest):
    if _is_logical_spec(specs):
        return fn(specs, *rest)
    return {k: _map_specs(fn, v, *(r[k] for r in rest)) for k, v in specs.items()}


def logical_to_shardings(logical_specs: Any, mesh_ctx: MeshContext,
                         rules: AxisRules | None = None, shapes: Any = None) -> Any:
    """A tree of logical specs -> a tree of `Layout`s. With `shapes` (a
    matching tree of shapes) the divisibility fallback applies."""
    rules = rules or AxisRules()

    def one(spec, shape=None):
        return layout_from_spec(rules.spec(spec, mesh_ctx), shape, mesh_ctx)

    if shapes is None:
        return _map_specs(one, logical_specs)
    return _map_specs(one, logical_specs, shapes)


# -- DTensor trees -------------------------------------------------------------
def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def refuse_dtensor(where: str, **tensors) -> None:
    """Kernel wrappers take each rank's local tensors: a DTensor raises
    TypeError, never drops to another implementation."""
    for name, x in tensors.items():
        if x is not None and is_dtensor(x):
            raise TypeError(f"{where}: {name} is a DTensor; pass this rank's local "
                            "shard (`to_local()`, e.g. its tp heads)")


def local(x):
    """A DTensor's local shard (differentiable), anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def local_tree(tree):
    return tree_map(local, tree)


def dtensor_box(x) -> tuple:
    """(offsets, sizes, primary) of this rank's block of DTensor `x`."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    coords = dict(zip(names, mesh.get_coordinate()))
    layout = layout_of(x)
    offs, lens = layout.box(x.shape, sizes, coords)
    return offs, lens, layout.is_primary(coords)


def layout_of(x) -> Layout:
    """The `Layout` of a DTensor from its placements (a plain tensor is
    replicated everywhere)."""
    dims: list[list[str]] = [[] for _ in range(x.dim())]
    if is_dtensor(x):
        names = x.device_mesh.mesh_dim_names
        for name, p in zip(names, x.placements):
            if p.is_shard():
                dims[p.dim].append(name)
    return Layout(tuple(tuple(a for a in MeshAxisName.ALL if a in axes) for axes in dims))


def slice_box(full: torch.Tensor, offs, lens) -> torch.Tensor:
    out = full
    for d, (o, n) in enumerate(zip(offs, lens)):
        if n != full.shape[d]:
            out = out.narrow(d, o, n)
    return out


def distribute_leaf(full: torch.Tensor, layout: Layout, mesh_ctx: MeshContext):
    """This rank's block of `full` as a DTensor with `layout`."""
    from torch.distributed.tensor import DTensor

    offs, lens = layout.box(full.shape, mesh_ctx.sizes, mesh_ctx.coords())
    shard = slice_box(full, offs, lens).detach().clone()
    return DTensor.from_local(shard, mesh_ctx.mesh, layout.placements(mesh_ctx),
                              run_check=False)


def distribute_params(params, layouts, mesh_ctx: MeshContext):
    """Every leaf of `params` (full tensors, the same on every rank) as the
    DTensor of its layout (a DTensor leaf is kept); leaves without a layout
    (a tree the specs do not cover) raise."""
    return tree_map(lambda p, lay: p if is_dtensor(p) else distribute_leaf(p, lay, mesh_ctx),
                    params, layouts)


def full_tree(tree, to_cpu_on_rank0: bool = False):
    """Every DTensor leaf gathered whole (a collective: every rank calls).
    With `to_cpu_on_rank0`, rank 0 keeps host copies and other ranks None
    leaves, one leaf on the card at a time."""
    import torch.distributed as dist

    def one(x):
        if not is_dtensor(x):
            return x
        full = x.full_tensor()
        if not to_cpu_on_rank0:
            return full
        return full.cpu() if dist.get_rank() == 0 else None

    return tree_map(one, tree)


def with_logical_constraint(x, logical_axes: Sequence[Any], mesh_ctx: MeshContext,
                            rules: AxisRules | None = None):
    """The activation-layout constraint: a DTensor is redistributed to the
    layout the rules give `logical_axes`; a local tensor, whose layout the
    SPMD code keeps explicit, comes back unchanged."""
    if not is_dtensor(x):
        return x
    rules = rules or AxisRules()
    layout = layout_from_spec(rules.spec(logical_axes, mesh_ctx), tuple(x.shape), mesh_ctx)
    return x.redistribute(x.device_mesh, layout.placements(mesh_ctx))
