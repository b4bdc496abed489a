"""The device mesh: one source of truth for the parallel layout (port of
`automodel_tpu/distributed/mesh.py`).

The same six axes as the JAX package, outermost first:

    (pp, dp_replicate, dp_shard, ep, cp, tp)

- `dp_replicate` HSDP replication groups;
- `dp_shard`     FSDP parameter and optimizer-state sharding;
- `ep`           expert parallelism; it also shards the batch outside the
                 MoE blocks;
- `cp`, `pp`     context and pipeline parallelism (not ported yet: sizes
                 above 1 raise NotImplementedError naming ROADMAP.md item
                 12b);
- `tp`           tensor parallelism.

Where JAX builds one `jax.sharding.Mesh`, `MeshContext.build` makes a
`torch.distributed` `DeviceMesh` over the ranks of the process group
(`init_device_mesh`, row-major: rank r sits at the row-major unravel of r
over the six sizes) and, on demand, one process group per set of axes, the
flattened aliases (`dp`, `batch`, ...) included. The DeviceMesh has a dim
for each axis of size above 1 only (`dp_shard` alone when every size is
1): DTensor's sharding propagation grows exponentially with the mesh's
dims, and a size-1 dim splits nothing. An axis of size 1 has no group
either: `group()` returns None for a set of axes whose sizes multiply to
1, and the collectives skip it. Group creation is collective: every rank
must create the same groups in the same order, so `build` makes every
group the mesh can need at once, in `group_keys()` order, and `group()`
only looks them up (no rank ever creates one on first use, in an order
its own code path or its hash seed could change).

`MeshConfig` holds the sizes; `resolve(n)` infers `dp_shard: -1` and checks
that the sizes multiply to the number of ranks, with the JAX package's
errors, and needs no process group.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


class MeshAxisName:
    """Canonical axis names and the flattened aliases (JAX `mesh.py:40-60`)."""

    PP = "pp"
    DP_REPLICATE = "dp_replicate"
    DP_SHARD = "dp_shard"
    EP = "ep"
    CP = "cp"
    TP = "tp"

    ALL = (PP, DP_REPLICATE, DP_SHARD, EP, CP, TP)

    ALIASES = {
        "dp": (DP_REPLICATE, DP_SHARD),
        "dp_shard_cp": (DP_SHARD, CP),
        "dp_cp": (DP_REPLICATE, DP_SHARD, CP),
        "dp_shard_cp_ep": (DP_SHARD, CP, EP),
        "batch": (DP_REPLICATE, DP_SHARD, EP),
        "batch_cp": (DP_REPLICATE, DP_SHARD, EP, CP),
        "ep_shard": (DP_REPLICATE, DP_SHARD),
    }


#: the axes whose ports are still to come (ROADMAP.md queue 1 item 12b)
UNPORTED_AXES = {"cp": "parallel/cp.py (ring, load-balanced and blockdiag layouts)",
                 "pp": "parallel/pp.py (GPipe, 1F1B, interleaved, ZB-H1)"}


def refuse_unported_axes(sizes: dict) -> None:
    """`cp` or `pp` above 1 raises NotImplementedError naming item 12b."""
    for axis, what in UNPORTED_AXES.items():
        if int(sizes.get(axis, 1)) > 1:
            raise NotImplementedError(
                f"distributed.{axis}={sizes[axis]}: {what} is not ported yet "
                "(ROADMAP.md queue 1 item 12b)")


@dataclasses.dataclass
class MeshConfig:
    """Parallelism sizes; -1 on dp_shard means "the ranks left over"."""

    pp: int = 1
    dp_replicate: int = 1
    dp_shard: int = -1
    ep: int = 1
    cp: int = 1
    tp: int = 1

    def resolve(self, n: int) -> "MeshConfig":
        """The sizes for `n` ranks: `dp_shard: -1` inferred; a product other
        than `n` raises ValueError (the JAX messages)."""
        fixed = self.pp * self.dp_replicate * self.ep * self.cp * self.tp
        dp_shard = self.dp_shard
        if dp_shard == -1:
            if n % fixed != 0:
                raise ValueError(
                    f"{n} devices not divisible by pp*dp_replicate*ep*cp*tp={fixed}")
            dp_shard = n // fixed
        if fixed * dp_shard != n:
            raise ValueError(
                f"Mesh sizes pp={self.pp} dp_replicate={self.dp_replicate} "
                f"dp_shard={dp_shard} ep={self.ep} cp={self.cp} tp={self.tp} "
                f"multiply to {fixed * dp_shard}, but there are {n} devices")
        return dataclasses.replace(self, dp_shard=dp_shard)

    def build(self, device_type: str = "cuda") -> "MeshContext":
        """The mesh over the process group's ranks (the group must be up)."""
        from torch.distributed.device_mesh import init_device_mesh

        cfg = self.resolve(dist.get_world_size())
        refuse_unported_axes(dataclasses.asdict(cfg))
        ctx = MeshContext(config=cfg)
        axes = ctx.mesh_axes
        ctx.mesh = init_device_mesh(device_type, tuple(ctx.sizes[a] for a in axes),
                                    mesh_dim_names=axes)
        for key in ctx.group_keys():
            ctx._groups[key] = ctx._new_group(key)
        return ctx

    @property
    def shape(self) -> tuple:
        return tuple(getattr(self, a) for a in MeshAxisName.ALL)

    @classmethod
    def from_config(cls, node: Any) -> "MeshConfig":
        """From a ConfigNode/dict `distributed:` section (unknown keys are
        ignored, as in the JAX package)."""
        kwargs = {}
        for f in dataclasses.fields(cls):
            if node is not None and f.name in node:
                kwargs[f.name] = int(node.get(f.name) if hasattr(node, "get") else node[f.name])
        return cls(**kwargs)


@dataclasses.dataclass
class MeshContext:
    """Resolved sizes, the `DeviceMesh` (None for a layout-only context, as
    the unit tests and the checkpoint's planning use) and the groups."""

    config: MeshConfig
    mesh: Any = None
    _groups: dict = dataclasses.field(default_factory=dict, repr=False)

    # -- sizes ---------------------------------------------------------------
    @property
    def sizes(self) -> dict:
        return {a: int(getattr(self.config, a)) for a in MeshAxisName.ALL}

    def axis_size(self, name) -> int:
        return int(math.prod(self.sizes[a] for a in self.resolve_axes(name)))

    @property
    def mesh_axes(self) -> tuple:
        """The DeviceMesh's dims: the axes of size above 1, in mesh order."""
        return tuple(a for a in MeshAxisName.ALL if self.sizes[a] > 1) or (MeshAxisName.DP_SHARD,)

    @property
    def num_devices(self) -> int:
        return int(math.prod(self.config.shape))

    @property
    def dp_size(self) -> int:
        return self.axis_size("dp")

    @property
    def batch_size_divisor(self) -> int:
        """The global batch must divide by this (the token-sharding axes)."""
        return self.axis_size("batch")

    # -- axes ----------------------------------------------------------------
    def resolve_axes(self, axes) -> tuple:
        """Expand aliases; `axes` is a str, a tuple of str, or None."""
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        out: list[str] = []
        for a in axes:
            if a in MeshAxisName.ALIASES:
                out.extend(MeshAxisName.ALIASES[a])
            elif a in MeshAxisName.ALL:
                out.append(a)
            else:
                raise ValueError(f"Unknown mesh axis '{a}'")
        return tuple(out)

    def spec(self, *dim_axes) -> tuple:
        """Per-dimension mesh axes with aliases resolved (the PartitionSpec
        analog): each entry None, an axis, or a tuple of axes."""
        parts = []
        for axes in dim_axes:
            resolved = self.resolve_axes(axes)
            parts.append(None if not resolved else
                         resolved[0] if len(resolved) == 1 else resolved)
        return tuple(parts)

    # -- this rank -------------------------------------------------------------
    @property
    def rank(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    def coords(self, rank: int | None = None) -> dict:
        """Each axis's coordinate of `rank` (this one by default)."""
        r = self.rank if rank is None else rank
        return dict(zip(MeshAxisName.ALL,
                        (int(c) for c in np.unravel_index(r, self.config.shape))))

    def axis_index(self, axes) -> int:
        """This rank's row-major index along the flattened `axes`."""
        c = self.coords()
        idx = 0
        for a in self.resolve_axes(axes):
            idx = idx * self.sizes[a] + c[a]
        return idx

    def _key(self, axes) -> tuple:
        names = set(self.resolve_axes(axes))
        return tuple(a for a in MeshAxisName.ALL if a in names and self.sizes[a] > 1)

    def group_keys(self) -> list:
        """Every set of axes of size above 1 (in mesh order), each a key of
        `group()`, in the one order in which `build` creates their groups:
        by count of axes, then lexicographically over the mesh order."""
        axes = [a for a in MeshAxisName.ALL if self.sizes[a] > 1]
        return [key for n in range(1, len(axes) + 1)
                for key in itertools.combinations(axes, n)]

    def _new_group(self, key: tuple):
        if len(key) == 1:
            return self.mesh.get_group(key[0])
        grid = np.arange(self.num_devices).reshape(self.config.shape)
        dims = [MeshAxisName.ALL.index(a) for a in key]
        moved = np.moveaxis(grid, dims, range(-len(dims), 0))
        parts = moved.reshape(-1, int(math.prod(self.sizes[a] for a in key)))
        group, _ = dist.new_subgroups_by_enumeration(parts.tolist())
        return group

    def group(self, axes):
        """The process group over the flattened `axes` holding this rank
        (None when their sizes multiply to 1), made by `build`."""
        key = self._key(axes)
        if not key:
            return None
        if key not in self._groups:
            raise RuntimeError(
                f"no process group for {key}: a layout-only MeshContext has none "
                "(MeshConfig.build makes them)")
        return self._groups[key]

    def describe(self) -> dict:
        return {"world": self.num_devices, **self.sizes}
