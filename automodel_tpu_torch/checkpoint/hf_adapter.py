"""HF safetensors checkpoints <-> the port's stacked parameter trees (port of
`DenseDecoderAdapter`, `MoEDecoderAdapter`, `save_hf_checkpoint` and
`HFCheckpointReader` from `automodel_tpu/checkpoint/hf_adapter.py`).

Key transforms, as in the JAX package:

- HF `nn.Linear.weight` is (out, in); the port's kernels are (in, out), so
  they are transposed.
- Per-layer HF tensors `model.layers.{i}.…` are one stacked tensor's dim 0.
- Per-expert HF tensors `…experts.{e}.…` are the (L, E, …) grouped tensors.
- DeepSeek checkpoints store the MLA rope columns in interleaved pair order;
  the port rotates the half-split way, so those columns are permuted once at
  load and back at export.

Loading fills each stacked tensor on the target device one layer (or one
expert) slice at a time, the transpose done there, so host memory peaks at
one HF tensor. The files are read and written by the port's own
`safetensors_io` (no `safetensors` or `ml_dtypes` import).

Ported styles: dense "llama" (GQA or MLA attention), "hunyuan"
(`query_layernorm` / `key_layernorm`), "glm4" (GLM-4: the fused
`mlp.gate_up_proj`, first half gate and second half up, and the
`post_self_attn_layernorm` / `post_mlp_layernorm` sandwich norms),
"baichuan" (the fused `self_attn.W_pack`, rows [Q|K|V]) and "bailing"
(Ling 2.0: fused `attention.query_key_value`, `attention.dense`,
`word_embeddings`); MoE
"deepseek", "qwen3_moe" (also GLM-4.5's), "mixtral", "minimax", "gpt_oss"
(the fused, interleaved `gate_up_proj` with its biases, the router bias),
"ernie" (the correction bias under `moe_statics` with a leading dim of 1),
"hunyuan" (`gate.wg`, `shared_mlp`), "hy_mt2" (`mlp.router.gate`,
`shared_mlp`, `mlp.expert_bias`), "bailing" (`gate.expert_bias`) and
"glm4" (GLM-4's attention and norm names from the dense adapter; as in the
JAX adapter, the fused `gate_up_proj` of its first-k dense layers is not
mapped).
The DSA indexer maps in both styles: DeepSeek's uncompressed
`self_attn.indexer.{wq,wk,wgate}` and GLM-5's `self_attn.indexer.{wq_b,wk,
k_norm,weights_proj}`; IndexShare "shared" layers own no indexer keys (their
stack rows load as zeros and are not exported), and a checkpoint with no
indexer at all (a V3-style one) loads without the leaf, which the training
recipe then draws fresh. A dense checkpoint saved
without the CausalLM wrapper (a `LlamaBidirectionalModel`) may drop the
`model.` prefix, and one with a swapped head (`...ForSequenceClassification`)
may carry no `lm_head.weight`: that leaf is then left out, as the JAX
adapter does, and the seq-cls and retrieval recipes add their own head.
The heterogeneous MoE engine's "het_moe" adapter
(`models/moe_lm/het_families.py`) and Gemma-4's "gemma4_moe"
(`models/moe_lm/gemma4.py`) live with their models and join `ADAPTERS` when
those modules load.

`retry_policy` (resilience/retry.py) retries transient tensor reads of the
reader and shard writes of `save_hf_checkpoint`; the fault probes
`remote_io`, `hf_export_write`, `hf_export_commit` and `hf_export_swap`
sit where the JAX package puts them.
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import json
import logging
import os
import shutil
from typing import Any, Callable, Iterator, Mapping

import torch

from automodel_tpu_torch.checkpoint.safetensors_io import SafetensorsFile, save_file
from automodel_tpu_torch.resilience.faults import fault_hit
from automodel_tpu_torch.resilience.retry import retry_call
from automodel_tpu_torch.utils.device import resolve_device

Reader = Callable[[str], torch.Tensor]

logger = logging.getLogger(__name__)


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.T if x.dim() == 2 else x


def _rope_perm(dr: int, inverse: bool) -> torch.Tensor:
    """DeepSeek's interleaved rope pairs ((0,1),(2,3),…) -> the port's
    half-split order ([evens…, odds…]), or back with `inverse`."""
    deinter = torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)])
    if not inverse:
        return deinter
    inv = torch.empty(dr, dtype=torch.long)
    inv[deinter] = torch.arange(dr)
    return inv


def _permute_q_rope(kernel: torch.Tensor, n_heads: int, dn: int, dr: int,
                    inverse: bool) -> torch.Tensor:
    """kernel (…, in, n_heads*(dn+dr)): permute each head's rope columns."""
    *lead, fan_in, out = kernel.shape
    k = kernel.reshape(*lead, fan_in, n_heads, dn + dr)
    perm = _rope_perm(dr, inverse).to(kernel.device)
    k = torch.cat([k[..., :dn], k[..., dn:][..., perm]], dim=-1)
    return k.reshape(*lead, fan_in, out)


def _permute_k_rope(kernel: torch.Tensor, kv_rank: int, dr: int,
                    inverse: bool) -> torch.Tensor:
    """kv_down kernel (…, in, kv_rank+dr): permute the trailing rope cols."""
    perm = _rope_perm(dr, inverse).to(kernel.device)
    return torch.cat([kernel[..., :kv_rank], kernel[..., kv_rank:][..., perm]], dim=-1)


def _stack(shape: tuple, name_of: Callable[..., str], load: Callable[[str], torch.Tensor],
           dtype: torch.dtype, device) -> torch.Tensor:
    """One (*shape, *tensor shape) tensor on `device`, filled slice by slice
    from the HF tensors `name_of(*index)` for every index of `shape`."""
    out = None
    for idx in itertools.product(*map(range, shape)):
        x = load(name_of(*idx))
        if out is None:
            out = torch.empty((*shape, *x.shape), dtype=dtype, device=device)
        out[idx].copy_(x)
    return out


def _stack_zero_fill(L: int, name_of: Callable[[int], str], load: Callable[[str], torch.Tensor],
                     dtype: torch.dtype, device, absent: Callable[[int], bool]) -> torch.Tensor:
    """As `_stack` over L layers, with the layers `absent` declares keyless
    (IndexShare "shared" layers own no indexer) filled with zeros. A key
    missing on any other layer raises KeyError: a checkpoint without the
    leaf, which the caller skips, never silent zeros."""
    vals = {}
    for i in range(L):
        try:
            vals[i] = load(name_of(i))
        except KeyError:
            if not absent(i):
                raise
    if not vals:
        raise KeyError(name_of(0))
    ref = next(iter(vals.values()))
    out = torch.zeros((L, *ref.shape), dtype=dtype, device=device)
    for i, x in vals.items():
        out[i].copy_(x)
    return out


@dataclasses.dataclass
class DenseDecoderAdapter:
    """Llama-style names <-> `models/llm/decoder` params (GQA or MLA);
    `style` "hunyuan", "glm4", "baichuan" and "bailing" rename or fuse
    tensors (the module docstring lists them)."""

    cfg: Any  # TransformerConfig
    style: str = "llama"

    STYLES = ("llama", "hunyuan", "glm4", "baichuan", "bailing")

    def __post_init__(self):
        if self.style not in self.STYLES:
            raise NotImplementedError(
                f"dense adapter style {self.style!r} is not ported; ported: {self.STYLES}")

    # -- name tables ---------------------------------------------------------
    def _layer_entries(self) -> list[tuple]:
        """(hf_suffix, param_path, transpose, transform) per layer."""
        cfg = self.cfg
        if cfg.attention_type == "mla":
            return self._mla_layer_entries()
        e = []
        if self._fused_qkv_name() is None:
            e += [(f"self_attn.{p}.weight", (p, "kernel"), True)
                  for p in ("q_proj", "k_proj", "v_proj")]
        o_name = ("attention.dense.weight" if self.style == "bailing"
                  else "self_attn.o_proj.weight")
        e += [
            (o_name, ("o_proj", "kernel"), True),
            ("mlp.down_proj.weight", ("down_proj", "kernel"), True),
            ("input_layernorm.weight", ("input_norm", "scale"), False),
        ]
        if self.style != "glm4":  # glm4 fuses these into mlp.gate_up_proj
            e += [(f"mlp.{p}.weight", (p, "kernel"), True) for p in ("gate_proj", "up_proj")]
        if cfg.use_post_norms and self.style == "glm4":
            e += [
                ("post_self_attn_layernorm.weight", ("post_attn_out_norm", "scale"), False),
                ("post_attention_layernorm.weight", ("post_attn_norm", "scale"), False),
                ("post_mlp_layernorm.weight", ("post_mlp_norm", "scale"), False),
            ]
        elif cfg.use_post_norms:  # gemma2's four norms
            e += [
                ("post_attention_layernorm.weight", ("post_attn_out_norm", "scale"), False),
                ("pre_feedforward_layernorm.weight", ("post_attn_norm", "scale"), False),
                ("post_feedforward_layernorm.weight", ("post_mlp_norm", "scale"), False),
            ]
        else:
            e.append(("post_attention_layernorm.weight", ("post_attn_norm", "scale"), False))
        if cfg.attention_bias:
            e += [(f"self_attn.{p}.bias", (p, "bias"), False)
                  for p in ("q_proj", "k_proj", "v_proj")]
        if cfg.qk_norm or cfg.qk_norm_flat:
            q_name, k_name = {
                "hunyuan": ("self_attn.query_layernorm", "self_attn.key_layernorm"),
                "bailing": ("attention.query_layernorm", "attention.key_layernorm"),
            }.get(self.style, ("self_attn.q_norm", "self_attn.k_norm"))
            e += [(f"{q_name}.weight", ("q_norm", "scale"), False),
                  (f"{k_name}.weight", ("k_norm", "scale"), False)]
        if cfg.o_proj_bias:
            e.append(("self_attn.o_proj.bias", ("o_proj", "bias"), False))
        if cfg.attention_sinks:
            e.append(("self_attn.sinks", ("sinks",), False))
        return [(*entry, None) for entry in e]

    def _mla_layer_entries(self) -> list[tuple]:
        e = [
            ("input_layernorm.weight", ("input_norm", "scale"), False, None),
            ("post_attention_layernorm.weight", ("post_attn_norm", "scale"), False, None),
            ("self_attn.kv_a_proj_with_mqa.weight", ("kv_down_proj", "kernel"), True, "k_rope"),
            ("self_attn.kv_a_layernorm.weight", ("kv_norm", "scale"), False, None),
            ("self_attn.kv_b_proj.weight", ("kv_up_proj", "kernel"), True, None),
            ("self_attn.o_proj.weight", ("o_proj", "kernel"), True, None),
        ]
        if self.cfg.mla_q_lora_rank:
            e += [
                ("self_attn.q_a_proj.weight", ("q_down_proj", "kernel"), True, None),
                ("self_attn.q_a_layernorm.weight", ("q_norm", "scale"), False, None),
                ("self_attn.q_b_proj.weight", ("q_up_proj", "kernel"), True, "q_rope"),
            ]
        else:
            e.append(("self_attn.q_proj.weight", ("q_proj", "kernel"), True, "q_rope"))
        if self.cfg.dsa_index_topk is not None:
            ix = "self_attn.indexer."
            if self.cfg.dsa_indexer_style == "glm":
                # GLM-5.x: queries from the q-lora residual (wq_b), LayerNorm'd keys
                e += [
                    (ix + "wq_b.weight", ("indexer", "wq", "kernel"), True, None),
                    (ix + "wk.weight", ("indexer", "wk", "kernel"), True, None),
                    (ix + "k_norm.weight", ("indexer", "k_norm", "scale"), False, None),
                    (ix + "k_norm.bias", ("indexer", "k_norm", "bias"), False, None),
                    (ix + "weights_proj.weight", ("indexer", "wgate", "kernel"), True, None),
                ]
            else:
                # the uncompressed DeepSeek lightning indexer, the JAX names
                e += [(ix + f"{w}.weight", ("indexer", w, "kernel"), True, None)
                      for w in ("wq", "wk", "wgate")]
        # MLA models pair with the MoE adapter; these MLP entries are the
        # first-k dense layers'
        e += [(f"mlp.{p}.weight", (p, "kernel"), True, None)
              for p in ("gate_proj", "up_proj", "down_proj")]
        return e

    def _fused_qkv_name(self) -> str | None:
        """HF key suffix of the fused q/k/v (row order [Q|K|V]) of the
        "baichuan" and "bailing" styles, else None."""
        return {
            "baichuan": "self_attn.W_pack.weight",
            "bailing": "attention.query_key_value.weight",
        }.get(self.style)

    def _qkv_cols(self) -> dict:
        """Column range of q, k and v in the transposed fused kernel."""
        D = self.cfg.resolved_head_dim
        qd, kd = self.cfg.num_heads * D, self.cfg.num_kv_heads * D
        return {"q_proj": (0, qd), "k_proj": (qd, qd + kd),
                "v_proj": (qd + kd, qd + 2 * kd)}

    def _fuse_qkv(self, layers: Mapping, i: int) -> torch.Tensor:
        """Layer i's q/k/v kernels as the HF fused (q+k+v, H) weight."""
        return _t(torch.cat([layers[p]["kernel"][i]
                             for p in ("q_proj", "k_proj", "v_proj")], dim=1))

    def _load_fused_qkv(self, out: dict, key: str, read: Reader, first: int,
                        n: int, dtype, device) -> None:
        """Split layers first..first+n of the fused q/k/v into
        out[key][p]["kernel"]."""
        for p, (a, b) in self._qkv_cols().items():
            _set(out, (key, p, "kernel"), _stack(
                (n,), lambda j: f"model.layers.{first + j}.{self._fused_qkv_name()}",
                lambda name, a=a, b=b: _t(read(name).to(device))[:, a:b], dtype, device))

    def _top_entries(self) -> list[tuple]:
        embed_name = ("model.word_embeddings.weight" if self.style == "bailing"
                      else "model.embed_tokens.weight")
        e = [
            (embed_name, ("embed", "embedding"), False, None),
            ("model.norm.weight", ("final_norm", "scale"), False, None),
        ]
        if not self.cfg.tie_word_embeddings:
            e.append(("lm_head.weight", ("lm_head", "kernel"), True, None))
        return e

    def _indexer_absent(self, layer_idx: int) -> bool:
        """IndexShare "shared" layers own no indexer in HF checkpoints."""
        t = self.cfg.dsa_indexer_types
        return t is not None and t[layer_idx] == "shared"

    def _load_stack(self, out: dict, key: str, entry, first: int, L: int,
                    load, dtype, device) -> None:
        """One layer-stacked leaf, out[key][path], from layers first..first+L;
        an indexer leaf zero-fills IndexShare's keyless layers and is left
        out when the checkpoint has none (a V3-style checkpoint)."""
        suffix, path, transpose, tr = entry
        name_of = lambda i: f"model.layers.{first + i}.{suffix}"  # noqa: E731
        one = lambda n: load(n, transpose, tr)  # noqa: E731
        if path[0] != "indexer":
            _set(out, (key,) + path, _stack((L,), name_of, one, dtype, device))
            return
        try:
            _set(out, (key,) + path, _stack_zero_fill(
                L, name_of, one, dtype, device,
                lambda i: self._indexer_absent(first + i)))
        except KeyError:
            logger.warning("checkpoint has no %s; leaf omitted", suffix)

    def _transform(self, x: torch.Tensor, tname: str | None, inverse: bool) -> torch.Tensor:
        cfg = self.cfg
        if tname is None:
            return x
        if tname == "q_rope":
            return _permute_q_rope(x, cfg.num_heads, cfg.mla_qk_nope_head_dim,
                                   cfg.mla_qk_rope_head_dim, inverse)
        if tname == "k_rope":
            return _permute_k_rope(x, cfg.mla_kv_lora_rank, cfg.mla_qk_rope_head_dim, inverse)
        raise KeyError(tname)

    def _export(self, x: torch.Tensor, transpose: bool, tr) -> torch.Tensor:
        x = self._transform(x, tr, inverse=True)
        return _t(x) if transpose else x

    def _loader(self, read: Reader, device) -> Callable:
        def load(name, transpose, tr):
            x = read(name).to(device)
            return self._transform(_t(x) if transpose else x, tr, inverse=False)
        return load

    # -- export --------------------------------------------------------------
    def to_hf(self, params: Mapping) -> Iterator[tuple[str, torch.Tensor]]:
        """Yield (hf_name, tensor), the layer stacks unstacked. Tensors stay
        on the params' device, as views where no permutation applies."""
        for name, path, transpose, tr in self._top_entries():
            yield name, self._export(_get(params, path), transpose, tr)
        layers = params["layers"]
        for i in range(self.cfg.num_layers):
            for suffix, path, transpose, tr in self._layer_entries():
                if path[0] == "indexer" and self._indexer_absent(i):
                    continue
                yield (f"model.layers.{i}.{suffix}",
                       self._export(_get(layers, path)[i], transpose, tr))
            if self.style == "glm4":
                yield (f"model.layers.{i}.mlp.gate_up_proj.weight",
                       _t(torch.cat([layers["gate_proj"]["kernel"][i],
                                     layers["up_proj"]["kernel"][i]], dim=1)))
            if self._fused_qkv_name() is not None:
                yield f"model.layers.{i}.{self._fused_qkv_name()}", self._fuse_qkv(layers, i)

    # -- import --------------------------------------------------------------
    def from_hf(self, read: Reader, device=None, dtype: torch.dtype = torch.float32,
                place=None) -> dict:
        """The params tree on `device` (None means CUDA) in `dtype` (values
        as the checkpoint holds them, cast once). A name missing with its
        `model.` prefix is read without it, and a missing `lm_head.weight`
        leaves that leaf out (the module docstring says when). With
        `place(path, tensor)` (a mesh: the leaf's block on this rank, a
        DTensor) each leaf is placed as soon as it is read, so no rank ever
        holds the whole tree."""
        device = resolve_device(device)

        def read_any(name):
            try:
                return read(name)
            except KeyError:
                if name.startswith("model."):
                    return read(name[len("model."):])
                raise

        load = self._loader(read_any, device)
        out = _new_tree(place)
        for name, path, transpose, tr in self._top_entries():
            try:
                _set(out, path, _stack((), lambda: name, lambda n: load(n, transpose, tr),
                                       dtype, device))
            except KeyError:
                if path != ("lm_head", "kernel"):
                    raise
                logger.warning("checkpoint has no lm_head.weight; leaf omitted")
        L = self.cfg.num_layers
        for entry in self._layer_entries():
            self._load_stack(out, "layers", entry, 0, L, load, dtype, device)
        if self.style == "glm4":
            I = self.cfg.intermediate_size
            for p, cols in (("gate_proj", slice(0, I)), ("up_proj", slice(I, 2 * I))):
                _set(out, ("layers", p, "kernel"), _stack(
                    (L,), lambda i: f"model.layers.{i}.mlp.gate_up_proj.weight",
                    lambda n, cols=cols: load(n, True, None)[:, cols], dtype, device))
        if self._fused_qkv_name() is not None:
            self._load_fused_qkv(out, "layers", read_any, 0, L, dtype, device)
        return dict(out)


@dataclasses.dataclass
class MoEDecoderAdapter:
    """MoE decoder names <-> `models/moe_lm/decoder` params: per-expert HF
    weights split and merged into the (L, E, in, out) grouped kernels, the
    router (and its bias), the correction bias and the shared experts, in
    the naming of `style` (the module docstring lists them)."""

    cfg: Any  # MoETransformerConfig
    style: str = "qwen3_moe"

    STYLES = ("qwen3_moe", "deepseek", "mixtral", "minimax", "gpt_oss", "ernie",
              "hunyuan", "hy_mt2", "bailing", "glm4")

    def __post_init__(self):
        if self.style not in self.STYLES:
            raise NotImplementedError(
                f"MoE adapter style {self.style!r} is not ported; ported: {self.STYLES}")
        # the styles whose attention and norms the dense adapter renames
        self.dense = DenseDecoderAdapter(
            self.cfg,
            style=self.style if self.style in ("glm4", "hunyuan", "bailing") else "llama")

    def _expert_name(self, i: int, e: int, proj: str) -> str:
        if self.style in ("mixtral", "minimax"):
            w = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}[proj]
            return f"model.layers.{i}.block_sparse_moe.experts.{e}.{w}.weight"
        return f"model.layers.{i}.mlp.experts.{e}.{proj}.weight"

    def _gate_name(self, i: int) -> str:
        return {
            "mixtral": f"model.layers.{i}.block_sparse_moe.gate.weight",
            "minimax": f"model.layers.{i}.block_sparse_moe.gate.weight",
            "gpt_oss": f"model.layers.{i}.mlp.router.weight",
            "hunyuan": f"model.layers.{i}.mlp.gate.wg.weight",
            "hy_mt2": f"model.layers.{i}.mlp.router.gate.weight",
        }.get(self.style, f"model.layers.{i}.mlp.gate.weight")

    def _escore_name(self, i: int) -> str:
        # ernie's carries a leading groups dim of 1 (Ernie4_5_MoeStatics)
        return {
            "ernie": f"model.layers.{i}.mlp.moe_statics.e_score_correction_bias",
            "minimax": f"model.layers.{i}.block_sparse_moe.e_score_correction_bias",
            "bailing": f"model.layers.{i}.mlp.gate.expert_bias",
            "hy_mt2": f"model.layers.{i}.mlp.expert_bias",
        }.get(self.style, f"model.layers.{i}.mlp.gate.e_score_correction_bias")

    def _shared_name(self, i: int, proj: str) -> str:
        base = "shared_mlp" if self.style in ("hunyuan", "hy_mt2") else "shared_experts"
        return f"model.layers.{i}.mlp.{base}.{proj}.weight"

    def _gpt_oss_name(self, i: int, what: str) -> str:
        """gpt-oss's per-layer expert tensors: `gate_up_proj` (E, H, 2I) with
        gate in the even and up in the odd columns, `down_proj` (E, I, H),
        both (in, out) as the port stores them, and their `_bias`."""
        return f"model.layers.{i}.mlp.experts.{what}"

    def _attn_entries(self):
        mlp_keys = ("gate_proj", "up_proj", "down_proj")
        return [e for e in self.dense._layer_entries() if e[1][0] not in mlp_keys]

    def to_hf(self, params: Mapping) -> Iterator[tuple[str, torch.Tensor]]:
        cfg, dense = self.cfg, self.dense
        fused_qkv = dense._fused_qkv_name()
        for name, path, transpose, tr in dense._top_entries():
            yield name, dense._export(_get(params, path), transpose, tr)
        fk = cfg.first_k_dense
        for i in range(fk):
            for suffix, path, transpose, tr in dense._layer_entries():
                if path[0] == "indexer" and dense._indexer_absent(i):
                    continue
                yield (f"model.layers.{i}.{suffix}",
                       dense._export(_get(params["dense_layers"], path)[i], transpose, tr))
            if fused_qkv is not None:
                yield f"model.layers.{i}.{fused_qkv}", dense._fuse_qkv(params["dense_layers"], i)
        moe_layers = params["moe_layers"]
        for li in range(cfg.num_moe_layers):
            i = fk + li
            for suffix, path, transpose, tr in self._attn_entries():
                if path[0] == "indexer" and dense._indexer_absent(i):
                    continue
                yield (f"model.layers.{i}.{suffix}",
                       dense._export(_get(moe_layers, path)[li], transpose, tr))
            if fused_qkv is not None:
                yield f"model.layers.{i}.{fused_qkv}", dense._fuse_qkv(moe_layers, li)
            moe = moe_layers["moe"]
            yield self._gate_name(i), _t(moe["gate"]["weight"][li])
            if "bias" in moe["gate"]:
                yield self._gate_name(i).replace(".weight", ".bias"), moe["gate"]["bias"][li]
            if self.style == "gpt_oss":
                ek = moe["experts"]
                for leaf, sfx in (("kernel", ""), ("bias", "_bias")):
                    g, u = ek["gate_proj"][leaf][li], ek["up_proj"][leaf][li]
                    fused = g.new_empty((*g.shape[:-1], 2 * g.shape[-1]))
                    fused[..., ::2] = g
                    fused[..., 1::2] = u
                    yield self._gpt_oss_name(i, "gate_up_proj" + sfx), fused
                    yield self._gpt_oss_name(i, "down_proj" + sfx), ek["down_proj"][leaf][li]
                continue
            if "e_score_bias" in moe["gate"]:
                b = moe["gate"]["e_score_bias"][li]
                yield self._escore_name(i), (b[None] if self.style == "ernie" else b)
            for e in range(cfg.moe.n_routed_experts):
                for proj in ("gate_proj", "up_proj", "down_proj"):
                    yield (self._expert_name(i, e, proj),
                           _t(moe["experts"][proj]["kernel"][li, e]))
            if cfg.moe.n_shared_experts > 0:
                for proj in ("gate_proj", "up_proj", "down_proj"):
                    yield self._shared_name(i, proj), _t(moe["shared"][proj]["kernel"][li])

    def from_hf(self, read: Reader, device=None, dtype: torch.dtype = torch.float32,
                place=None) -> dict:
        """As `DenseDecoderAdapter.from_hf`."""
        cfg, dense = self.cfg, self.dense
        device = resolve_device(device)
        load = dense._loader(read, device)
        out = _new_tree(place)
        for name, path, transpose, tr in dense._top_entries():
            _set(out, path, _stack((), lambda: name, lambda n: load(n, transpose, tr),
                                   dtype, device))
        fk, Lm = cfg.first_k_dense, cfg.num_moe_layers
        for entry in dense._layer_entries() if fk else ():
            dense._load_stack(out, "dense_layers", entry, 0, fk, load, dtype, device)
        for entry in self._attn_entries():
            dense._load_stack(out, "moe_layers", entry, fk, Lm, load, dtype, device)
        if dense._fused_qkv_name() is not None:
            if fk:
                dense._load_fused_qkv(out, "dense_layers", read, 0, fk, dtype, device)
            dense._load_fused_qkv(out, "moe_layers", read, fk, Lm, dtype, device)
        moe_path = ("moe_layers", "moe")
        plain = lambda n: load(n, False, None)  # noqa: E731
        _set(out, moe_path + ("gate", "weight"), _stack(
            (Lm,), lambda li: self._gate_name(fk + li),
            lambda n: load(n, True, None), dtype, device))
        if cfg.moe.router_bias:
            _set(out, moe_path + ("gate", "bias"), _stack(
                (Lm,), lambda li: self._gate_name(fk + li).replace(".weight", ".bias"),
                plain, dtype, device))
        if self.style == "gpt_oss":
            experts = moe_path + ("experts",)
            for leaf, sfx in (("kernel", ""), ("bias", "_bias")):
                for proj, cols in (("gate_proj", slice(0, None, 2)),
                                   ("up_proj", slice(1, None, 2))):
                    _set(out, experts + (proj, leaf), _stack(
                        (Lm,), lambda li, sfx=sfx: self._gpt_oss_name(fk + li, "gate_up_proj" + sfx),
                        lambda n, cols=cols: plain(n)[..., cols], dtype, device))
                _set(out, experts + ("down_proj", leaf), _stack(
                    (Lm,), lambda li, sfx=sfx: self._gpt_oss_name(fk + li, "down_proj" + sfx),
                    plain, dtype, device))
            return dict(out)
        if cfg.moe.gate_bias_update_speed > 0:
            def escore(name):
                # checkpoints trained without aux-free balancing carry none
                try:
                    return plain(name).reshape(-1)
                except KeyError:
                    return torch.zeros(cfg.moe.n_routed_experts, device=device)

            _set(out, moe_path + ("gate", "e_score_bias"), _stack(
                (Lm,), lambda li: self._escore_name(fk + li), escore, dtype, device))
        for proj in ("gate_proj", "up_proj", "down_proj"):
            _set(out, moe_path + ("experts", proj, "kernel"), _stack(
                (Lm, cfg.moe.n_routed_experts),
                lambda li, e: self._expert_name(fk + li, e, proj),
                lambda n: load(n, True, None), dtype, device))
        if cfg.moe.n_shared_experts > 0:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                _set(out, moe_path + ("shared", proj, "kernel"), _stack(
                    (Lm,), lambda li: self._shared_name(fk + li, proj),
                    lambda n: load(n, True, None), dtype, device))
        return dict(out)


ADAPTERS = {
    "dense_decoder": DenseDecoderAdapter,
    "moe_decoder": MoEDecoderAdapter,
}


def get_adapter(adapter_name: str, cfg, **kw):
    if adapter_name not in ADAPTERS:
        # the family modules with adapters of their own ("het_moe",
        # "gemma4_moe") register them when they are imported
        import automodel_tpu_torch.models.registry  # noqa: F401
    if adapter_name not in ADAPTERS:
        raise NotImplementedError(
            f"checkpoint adapter {adapter_name!r} is not ported; ported: {sorted(ADAPTERS)}")
    return ADAPTERS[adapter_name](cfg, **kw)


# ---------------------------------------------------------------------------
# safetensors shard I/O
# ---------------------------------------------------------------------------
def save_hf_checkpoint(
    named_tensors: Iterator[tuple[str, torch.Tensor]],
    out_dir: str,
    hf_config: dict | None = None,
    max_shard_bytes: int = 4 << 30,
    retry_policy=None,
    on_retry=None,
) -> None:
    """Write `model.safetensors`, or `model-XXXXX-of-YYYYY.safetensors`
    shards of at most `max_shard_bytes` (a larger tensor gets a shard of its
    own) with `model.safetensors.index.json`, plus `config.json`.

    Everything is staged in a sibling `<out_dir>.staging-<pid>` directory
    and published with one rename, so a crash mid-export never leaves a
    loadable-looking but truncated `out_dir`. A previous export at `out_dir`
    is moved to `<out_dir>.old` first; its files other than shards and
    index (a tokenizer, say) move into the new export. A shard holds
    references to its tensors until it is written, which moves each to the
    host in turn. `retry_policy` retries a shard write that fails
    transiently; the `hf_export_write` / `hf_export_commit` /
    `hf_export_swap` fault points make each path chaos-testable."""
    if "://" in out_dir:
        raise NotImplementedError(f"HF export writes local files; {out_dir!r} is a URI")
    out_dir = os.path.abspath(out_dir).rstrip(os.sep)
    old_dir = f"{out_dir}.old"
    # a crash between the two publish renames leaves the old export at
    # `.old` and no out_dir: restore it before staging
    if os.path.isdir(old_dir):
        if not os.path.isdir(out_dir):
            os.rename(old_dir, out_dir)
        else:
            shutil.rmtree(old_dir, ignore_errors=True)
    for stale in glob.glob(f"{out_dir}.staging-*"):
        shutil.rmtree(stale, ignore_errors=True)
    stage_dir = f"{out_dir}.staging-{os.getpid()}"
    os.makedirs(stage_dir)
    shards: list[list[str]] = []
    shard: list = []
    size = total = 0

    def flush():
        nonlocal shard, size
        if shard:
            tmp = os.path.join(stage_dir, f"__tmp_shard_{len(shards):05d}")

            def write():
                fault_hit("hf_export_write")
                save_file(shard, tmp, metadata={"format": "pt"})

            retry_call(write, policy=retry_policy, point="hf_export_write",
                       on_attempt=on_retry)
            shards.append([name for name, _ in shard])
            shard, size = [], 0

    try:
        for name, tensor in named_tensors:
            nbytes = tensor.numel() * tensor.element_size()
            if size + nbytes > max_shard_bytes and shard:
                flush()
            shard.append((name, tensor))
            size += nbytes
            total += nbytes
        flush()
        n = len(shards)
        weight_map = {}
        for idx, keys in enumerate(shards, 1):
            fname = "model.safetensors" if n == 1 else f"model-{idx:05d}-of-{n:05d}.safetensors"
            os.replace(os.path.join(stage_dir, f"__tmp_shard_{idx - 1:05d}"),
                       os.path.join(stage_dir, fname))
            weight_map.update(dict.fromkeys(keys, fname))
        if n > 1:
            with open(os.path.join(stage_dir, "model.safetensors.index.json"), "w") as f:
                json.dump({"metadata": {"total_size": total}, "weight_map": weight_map},
                          f, indent=2)
        if hf_config is not None:
            with open(os.path.join(stage_dir, "config.json"), "w") as f:
                json.dump(hf_config, f, indent=2)
        # -- atomic publish
        fault_hit("hf_export_commit")
        if os.path.isdir(out_dir):
            os.rename(out_dir, old_dir)
            fault_hit("hf_export_swap")
            os.rename(stage_dir, out_dir)
            for name in os.listdir(old_dir):
                if name.endswith(".safetensors") or name == "model.safetensors.index.json":
                    continue
                if not os.path.exists(os.path.join(out_dir, name)):
                    os.rename(os.path.join(old_dir, name), os.path.join(out_dir, name))
            shutil.rmtree(old_dir, ignore_errors=True)
        else:
            os.rename(stage_dir, out_dir)
    except Exception:
        # an ordinary failure cleans its staging tree; a crash (a
        # BaseException) leaves it, which no reader takes for an export
        shutil.rmtree(stage_dir, ignore_errors=True)
        raise


def _dequant_fp8_block(w: torch.Tensor, scale_inv: torch.Tensor,
                       block: tuple = (128, 128)) -> torch.Tensor:
    """DeepSeek-V3 fp8 weights: float8_e4m3fn with one fp32 inverse scale per
    (bm x bn) tile, to fp32, one block row at a time (no weight-sized scale
    temporary)."""
    M, N = w.shape
    bm, bn = block
    s = scale_inv.float()
    expect = (-(-M // bm), -(-N // bn))
    if tuple(s.shape) != expect:
        raise ValueError(
            f"fp8 scale_inv grid {tuple(s.shape)} does not match weight {tuple(w.shape)} "
            f"at block size {block} (expected {expect}); check "
            "quantization_config.weight_block_size in config.json")
    out = torch.empty((M, N), dtype=torch.float32, device=w.device)
    for bi in range(expect[0]):
        r0, r1 = bi * bm, min((bi + 1) * bm, M)
        out[r0:r1] = w[r0:r1].float() * s[bi].repeat_interleave(bn)[:N]
    return out


class HFCheckpointReader:
    """Lazy per-tensor reader over a local HF checkpoint directory: the
    sharded `model.safetensors.index.json` or one `model.safetensors`.
    Calling it with a name returns that tensor on the host, fp8 weights
    with a `_scale_inv` companion dequantized to fp32. Close it (or use it
    as a context manager) to unmap the files.

    `retry_policy` retries transient read failures (OSError, RuntimeError)
    with backoff; the `remote_io` fault point fires inside each attempt so
    the retry path is chaos-testable. A missing tensor (KeyError) is never
    retried."""

    def __init__(self, ckpt_dir: str, retry_policy=None, on_retry=None):
        self._dir = ckpt_dir
        self.retry_policy = retry_policy
        self.on_retry = on_retry
        self._files: dict[str, SafetensorsFile] = {}
        self._fp8_block_cache: tuple | None = None
        index_path = os.path.join(ckpt_dir, "model.safetensors.index.json")
        if os.path.exists(index_path):
            with open(index_path) as f:
                self._weight_map = json.load(f)["weight_map"]
        else:
            single = "model.safetensors"
            self._weight_map = dict.fromkeys(self._file(single).keys(), single)

    def _file(self, fname: str) -> SafetensorsFile:
        if fname not in self._files:
            self._files[fname] = SafetensorsFile(os.path.join(self._dir, fname))
        return self._files[fname]

    def keys(self):
        return self._weight_map.keys()

    def _read_raw(self, name: str) -> torch.Tensor:
        return self._file(self._weight_map[name]).get(name)

    def __call__(self, name: str) -> torch.Tensor:
        if name not in self._weight_map:
            raise KeyError(name)

        def attempt():
            fault_hit("remote_io")
            t = self._read_raw(name)
            scale_name = f"{name}_scale_inv"
            if scale_name in self._weight_map:
                t = _dequant_fp8_block(t, self._read_raw(scale_name), self._fp8_block())
            return t

        return retry_call(attempt, policy=self.retry_policy, point="remote_io",
                          on_attempt=self.on_retry, retry_on=(OSError, RuntimeError))

    def _fp8_block(self) -> tuple:
        """Block size of fp8 checkpoints, from config.json's
        quantization_config.weight_block_size (DeepSeek-V3: [128, 128])."""
        if self._fp8_block_cache is None:
            cfg = self.hf_config() or {}
            bs = (cfg.get("quantization_config") or {}).get("weight_block_size")
            self._fp8_block_cache = (int(bs[0]), int(bs[1])) if bs else (128, 128)
        return self._fp8_block_cache

    def hf_config(self) -> dict | None:
        p = os.path.join(self._dir, "config.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# tree path helpers
# ---------------------------------------------------------------------------
def _get(tree, path: tuple):
    for p in path:
        tree = tree[p]
    return tree


class _PlacedTree(dict):
    """The root of a tree `from_hf` fills, whose leaves `place(path,
    tensor)` turns into this rank's blocks as each is made."""

    def __init__(self, place):
        super().__init__()
        self.place = place


def _set(tree: dict, path: tuple, value) -> None:
    place = getattr(tree, "place", None)
    if place is not None:
        value = place(path, value)
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _new_tree(place) -> dict:
    return {} if place is None else _PlacedTree(place)
