"""Weights from the JAX package into the port.

Both packages keep the same parameter layout (stacked `(L, ...)` layer
weights, `(in, out)` kernels, the same dict keys), so conversion is a
key-for-key copy, of any depth: dense `layers`, the MoE decoder's
`dense_layers` and `moe_layers` (`moe.gate` with its correction bias,
`(L, E, H, I)` expert kernels, `moe.shared`), the MLA `kv_*`/`q_*`
projections and the DSA `indexer` subtree (DeepSeek's `wq`/`wk`/`wgate`,
GLM's with `k_norm`) alike, the heterogeneous MoE engine's per-geometry
and per-kind stacks (`g_attn`, `s_attn`, `dense_mlp`, `moe`, `shared_mlp`,
`indexer`), Gemma-4's one `layers` stack with its router and experts, and
the PEFT trees: the adapters keyed by path
(`{"layers/q_proj/kernel": {"a", "b"[, "m"]}}`) and a QLoRA base, whose
`{"q8", "sc"}` leaves keep their int8 and fp32 dtypes (`dtype` casts
floating leaves only). The JAX side hands its tree over as numpy arrays
(`jax.tree.map(np.asarray, params)`), so this module never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from automodel_tpu_torch.utils.device import resolve_device, torch_dtype


def params_from_jax(tree, device=None, dtype=None):
    """Nested dict of numpy arrays → the same dict of torch tensors on
    `device` (None means CUDA). Floating leaves are cast to `dtype` when it
    is given (a torch dtype or a name), else kept at their own precision;
    bfloat16 arrays (ml_dtypes) pass through float32, which holds them
    exactly."""
    dev = resolve_device(device)
    want = torch_dtype(dtype) if dtype is not None else None

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.tensor(a)  # a copy: JAX hands over read-only buffers
        if want is not None and t.is_floating_point():
            t = t.to(want)
        return t.to(dev)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)
