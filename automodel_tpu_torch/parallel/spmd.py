"""What the models run on a mesh: the explicit form of what GSPMD does to
the JAX package's layer scan.

`Spmd(mesh_ctx)` holds the process groups the forward needs and:

- `layer_stack(stacked)`: a stacked `(L, ...)` tree of DTensors as its
  local shards (`to_local()`, the autograd link to the DTensor leaves) and
  a function that unshards ONE layer's slice inside the layer loop:
  `gather_cast` over `dp_shard` on the dim FSDP split, the compute-dtype
  cast first, so the whole stack is never gathered at once; under remat
  the gather runs again in the backward (FSDP's reshard after forward),
  and its backward reduce-scatters the layer's gradient.
- `gather_tree(tree)`: the same for leaves outside the layer stacks (the
  embeddings, the head, the MTP head), in their own dtype.
- `tp_of(layout, dim)`: the `tp` group when `dim` of a leaf is split on
  `tp` (else None: the divisibility fallback replicated it), which turns
  the attention and MLP blocks' tensor parallelism on.
- `embed(table, ids)`: the embedding lookup, vocab-parallel over `tp`
  when the table's rows are split there (masked local lookup, partial sums
  reduced over `tp`).
- `batch_sum(x)`: a differentiable sum over the batch axes
  (`dp_replicate`, `dp_shard`, `ep`), for statistics JAX computes over the
  global batch (the MoE gate's); `batch_offset(T)`: the index of this
  rank's first token in the global batch.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.distributed.mesh import MeshContext, refuse_unported_axes
from automodel_tpu_torch.parallel import collectives as C
from automodel_tpu_torch.parallel.sharding import Layout, is_dtensor, layout_of
from automodel_tpu_torch.utils.tree import tree_map


class Spmd:
    def __init__(self, mesh_ctx: MeshContext):
        refuse_unported_axes(mesh_ctx.sizes)
        self.mesh_ctx = mesh_ctx
        self.fsdp = mesh_ctx.group("dp_shard")
        self.tp = mesh_ctx.group("tp")
        self.ep = mesh_ctx.group("ep")
        self.batch = mesh_ctx.group("batch")
        self.tp_size = mesh_ctx.sizes["tp"]
        self.ep_size = mesh_ctx.sizes["ep"]

    # -- parameters -------------------------------------------------------------
    def layer_stack(self, stacked):
        """(local stacked tree, unshard(layer_slice, dtype) -> local tree)."""
        dims = tree_map(lambda p: layout_of(p).dim_of("dp_shard"), stacked)
        local = tree_map(lambda p: p.to_local() if is_dtensor(p) else p, stacked)

        def unshard(lp, dtype=None):
            return tree_map(
                lambda x, d: C.gather_cast(x, None if d is None else d - 1, self.fsdp, dtype),
                lp, dims)

        return local, unshard

    def gather_tree(self, tree):
        """Every DTensor leaf of `tree` unsharded over `dp_shard` (other
        splits kept), in its own dtype."""
        def one(p):
            if not is_dtensor(p):
                return p
            return C.gather_cast(p.to_local(), layout_of(p).dim_of("dp_shard"), self.fsdp)

        return tree_map(one, tree)

    def tp_of(self, leaf, dim: int):
        """The tp group when `dim` of `leaf` (a DTensor) is split on tp."""
        if self.tp_size == 1 or not is_dtensor(leaf):
            return None
        return self.tp if "tp" in layout_of(leaf).axes_of(dim % leaf.dim()) else None

    def lora_tp_flags(self, stacked) -> dict:
        """For a layer stack `{"base", "lora"}`: which adapter factors are
        whole on every tp rank while their kernel is split on tp. Each rank's
        merged slice then sees only part of such a factor's gradient, so the
        factor enters through `copy_to` (its gradient summed over tp). DoRA's
        column norm spans the kernel's `in` dim: where tp splits that dim
        (`o_proj`, `down_proj`) it raises."""
        flags: dict = {}
        for path, ab in stacked.get("lora", {}).items():
            kernel = stacked["base"]
            for k in path.split("/"):
                kernel = kernel[k]
            kernel = kernel["q8"] if isinstance(kernel, dict) else kernel
            layout = layout_of(kernel)
            split = self.tp_size > 1 and "tp" in layout.sharded_axes
            if split and "m" in ab and "tp" in layout.axes_of(kernel.dim() - 2):
                raise NotImplementedError(
                    f"DoRA on {path} under tp > 1: the kernel's in dim is split")
            flags[path] = {n: split and "tp" not in layout_of(x).sharded_axes
                           for n, x in ab.items()}
        return flags

    def tp_rank(self) -> int:
        return self.mesh_ctx.coords()["tp"]

    # -- activations ------------------------------------------------------------
    def embed(self, table_dt, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Rows of the (V, H) embedding DTensor for `ids`, cast to `dtype`
        (the lookup in the table's dtype first, as the plain path does)."""
        tp = self.tp_of(table_dt, 0)
        table = C.gather_cast(table_dt.to_local(), layout_of(table_dt).dim_of("dp_shard"),
                              self.fsdp, None)
        if tp is None:
            return table[ids].to(dtype)
        rows = table.shape[0]
        start = self.tp_rank() * rows
        inside = (ids >= start) & (ids < start + rows)
        local_ids = torch.where(inside, ids - start, 0)
        h = torch.where(inside[..., None], table[local_ids], 0.0)
        return C.reduce_from(h, tp).to(dtype)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        return C.all_reduce_sum(x, self.batch)

    def batch_offset(self, tokens: int) -> int:
        """Global index of this rank's first token when each batch rank
        holds `tokens` of them."""
        return self.mesh_ctx.axis_index("batch") * tokens


def local_cfg(cfg, tp_size: int, mlp_tp: bool):
    """The layer config each tp rank runs: its heads and, with `mlp_tp`,
    its slice of the MLP (JAX `_pp_layer_setup`'s manual mode)."""
    import dataclasses

    if cfg.num_heads % tp_size or cfg.num_kv_heads % tp_size:
        raise ValueError(
            f"tp={tp_size} needs num_heads={cfg.num_heads} and "
            f"num_kv_heads={cfg.num_kv_heads} divisible by it")
    over = dict(num_heads=cfg.num_heads // tp_size,
                num_kv_heads=cfg.num_kv_heads // tp_size,
                head_dim=cfg.resolved_head_dim)
    if mlp_tp:
        over["intermediate_size"] = cfg.intermediate_size // tp_size
    return dataclasses.replace(cfg, **over)


__all__ = ["Layout", "Spmd", "local_cfg"]
