"""LoRA, DoRA and the QLoRA int8 base as a parameter transform (port of
`automodel_tpu/peft/lora.py`).

The adapters are a tree of their own, keyed by the adapted kernel's path
(`"layers/q_proj/kernel": {"a", "b"[, "m"]}`); the base tree is frozen
(its tensors need no gradient) and stays outside the optimizer. The
effective weights are

    merged = base + einsum("...ir,...ro->...io", a, b) * alpha / r

then, for DoRA, `m * merged / max(||merged||_col, 1e-8)` (the norm over the
input axis, -2); a QLoRA base leaf is `{"q8", "sc"}` (int8, absmax per
output channel) and is dequantized to the LoRA dtype first.

The JAX recipe merges the whole tree inside its jitted loss, where XLA fuses
the merge into the compute-dtype cast. Eagerly that would hold a merged
copy of every adapted kernel (for QLoRA, a dequantized copy of every
kernel) at once, so the decoders merge one layer at a time inside their
layer loop, under its remat (`layer_stack`), and the recipe merges the
leaves outside the layer stacks (the head) where it uses them. The
arithmetic is the JAX package's, leaf for leaf. `lora_param_shardings`
lays the adapters out on a mesh beside their kernels.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

import torch

# the top-level keys of the decoders' stacked layer trees
LAYER_STACKS = ("layers", "dense_layers", "moe_layers")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """The JAX config's fields and defaults; `dtype` is a torch dtype."""

    r: int = 16
    alpha: float = 32.0
    target_modules: tuple = ("q_proj", "k_proj", "v_proj", "o_proj")
    # a regex over the parameter path, in place of target_modules
    match_pattern: str | None = None
    dtype: Any = torch.float32
    # DoRA: W' = m * (W + dW) / ||W + dW||_col, m trainable (init ||W||_col)
    dora: bool = False
    # QLoRA: the frozen base kernels stored int8 (absmax per output channel)
    quantize_base: str | None = None  # None | "int8"

    @property
    def scale(self) -> float:
        return self.alpha / self.r

    def __post_init__(self):
        if self.quantize_base not in (None, "int8"):
            raise ValueError(
                f"quantize_base must be None or 'int8', got {self.quantize_base}")
        if isinstance(self.dtype, str):
            from automodel_tpu_torch.utils.device import torch_dtype

            object.__setattr__(self, "dtype", torch_dtype(self.dtype))


def _is_q8(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q8", "sc"}


def _leaves_with_path(tree, prefix: str = ""):
    """(path, leaf) pairs in sorted key order (the order of JAX's flatten),
    a QLoRA `{"q8", "sc"}` node counting as one leaf."""
    if isinstance(tree, dict) and not _is_q8(tree):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _map_with_path(fn: Callable, tree, prefix: str = ""):
    if isinstance(tree, dict) and not _is_q8(tree):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def _matches(cfg: LoRAConfig, path_s: str, leaf) -> bool:
    if getattr(leaf, "ndim", 0) < 2:
        return False
    if not path_s.endswith("kernel"):
        return False
    if cfg.match_pattern is not None:
        return re.search(cfg.match_pattern, path_s) is not None
    return any(t in path_s.split("/") for t in cfg.target_modules)


@torch.no_grad()
def init_lora(base_params: dict, cfg: LoRAConfig, gen: torch.Generator) -> dict:
    """The adapter tree: for each matched kernel (..., in, out), `a`
    (..., in, r) gaussian times in**-0.5 and `b` (..., r, out) zeros (so the
    merged model starts exactly at the base), plus DoRA's `m`, the base
    kernel's per-output column norm; each beside its kernel."""
    lora: dict = {}
    for ps, leaf in _leaves_with_path(base_params):
        if not _matches(cfg, ps, leaf):
            continue
        *lead, fan_in, fan_out = leaf.shape
        a = torch.randn((*lead, fan_in, cfg.r), generator=gen, dtype=cfg.dtype,
                        device=gen.device) * fan_in ** -0.5
        b = torch.zeros((*lead, cfg.r, fan_out), dtype=cfg.dtype, device=leaf.device)
        lora[ps] = {"a": a.to(leaf.device), "b": b}
        if cfg.dora:
            lora[ps]["m"] = torch.linalg.vector_norm(
                leaf.float(), dim=-2).to(cfg.dtype)
    if not lora:
        raise ValueError(
            f"LoRA matched no parameters (targets={cfg.target_modules}, "
            f"pattern={cfg.match_pattern})")
    return lora


def _quantize(leaf: torch.Tensor) -> dict:
    """int8 absmax per output channel over axis -2; a stacked leaf goes one
    slice of its leading dim at a time (the same values, smaller
    temporaries)."""
    if leaf.ndim > 2:
        parts = [_quantize(x) for x in leaf]
        return {"q8": torch.stack([p["q8"] for p in parts]),
                "sc": torch.stack([p["sc"] for p in parts])}
    x = leaf.float()
    absmax = torch.amax(x.abs(), dim=-2, keepdim=True)
    sc = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / sc), -127, 127).to(torch.int8)
    return {"q8": q, "sc": sc}


@torch.no_grad()
def quantize_base(base_params: dict, cfg: LoRAConfig) -> dict:
    """QLoRA base storage: every ndim >= 2 `kernel` becomes {"q8", "sc"}:
    int8 round-half-even(w / sc) clipped to +-127, sc = max|w| / 127 per
    output channel (fp32, shape (..., 1, out)). Other leaves pass through."""
    if cfg.quantize_base is None:
        return base_params

    def walk(ps, leaf):
        if getattr(leaf, "ndim", 0) < 2 or not ps.endswith("kernel"):
            return leaf
        return _quantize(leaf)

    return _map_with_path(walk, base_params)


def dequantize(leaf, dtype: torch.dtype):
    """A QLoRA leaf as `dtype` (q8 * sc in fp32, then the cast); any other
    leaf as it is."""
    if _is_q8(leaf):
        return (leaf["q8"].float() * leaf["sc"]).to(dtype)
    return leaf


def _merge_leaf(leaf: torch.Tensor, ab: dict, cfg: LoRAConfig) -> torch.Tensor:
    delta = torch.einsum("...ir,...ro->...io", ab["a"], ab["b"]) * cfg.scale
    merged = leaf + delta.to(leaf.dtype)
    if cfg.dora:
        norm = torch.linalg.vector_norm(merged.float(), dim=-2, keepdim=True)
        merged = (ab["m"][..., None, :] * merged
                  / torch.clamp(norm, min=1e-8)).to(leaf.dtype)
    return merged


def merge_lora(base_params: dict, lora: dict, cfg: LoRAConfig, *,
               skip: tuple = (), dtype: torch.dtype | None = None) -> dict:
    """base + scale * a @ b for every adapted kernel (stacked leading dims
    kept), QLoRA leaves dequantized, DoRA renormalized: the JAX
    `merge_lora`, differentiable in the adapters. Top-level keys in `skip`
    pass through unmerged. With `dtype`, each floating leaf is cast to it
    as it is made (generate's compute-dtype cast, with no full-precision
    copy of the whole merged tree)."""

    def walk(ps, leaf):
        if ps.split("/", 1)[0] in skip:
            return leaf
        leaf = dequantize(leaf, cfg.dtype)
        if ps in lora:
            leaf = _merge_leaf(leaf, lora[ps], cfg)
        if dtype is not None and leaf.is_floating_point():
            leaf = leaf.to(dtype)
        return leaf

    return _map_with_path(walk, base_params)


@torch.no_grad()
def merged_state_dict(base_params: dict, lora: dict, cfg: LoRAConfig) -> dict:
    """The merged weights, detached (for the consolidated HF export, which
    moves them to the host shard by shard). Leaves with nothing to merge are
    the base's own tensors."""
    return merge_lora(base_params, lora, cfg)


def lora_param_shardings(lora: dict, base_layouts: Any, mesh_ctx=None) -> dict:
    """The adapters' `Layout`s (`parallel/sharding.py`): each shards like
    its base kernel on the non-rank dims, the rank dim replicated (r is
    tiny): `a` (..., in, r) keeps the kernel's `in` split, `b` (..., r, out)
    and DoRA's `m` (..., out) its `out` split (JAX `lora_param_shardings`)."""
    from automodel_tpu_torch.parallel.sharding import Layout

    flat = dict(_leaves_with_path(base_layouts))
    out: dict = {}
    for ps, ab in lora.items():
        base = flat[ps]
        dims = (base["q8"] if isinstance(base, dict) else base).dims
        lead, in_ax, out_ax = dims[:-2], dims[-2], dims[-1]
        out[ps] = {"a": Layout(lead + (in_ax, ())), "b": Layout(lead + ((), out_ax))}
        if "m" in ab:
            out[ps]["m"] = Layout(lead + (out_ax,))
    return out


def layer_stack(params: dict, key: str, lora: dict | None,
                cfg: LoRAConfig | None):
    """A decoder's layer stack `params[key]` with its adapters, for the
    layer loop: (the stacked tree to unstack, a function from one layer's
    slice of it to that layer's merged, dequantized params). With no
    adapter tree at all, the base stack and the identity."""
    if lora is None:
        return params[key], lambda lp: lp
    pre = key + "/"
    adapters = {k[len(pre):]: v for k, v in lora.items() if k.startswith(pre)}
    stacked = {"base": params[key], "lora": adapters} if adapters else {"base": params[key]}
    return stacked, lambda lp: merge_lora(lp["base"], lp.get("lora", {}), cfg)
