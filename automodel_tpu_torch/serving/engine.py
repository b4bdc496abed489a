"""Continuous-batching serving engine (port of `automodel_tpu/serving/engine.py`:
dense and MoE decoders, GQA or MLA attention, fp or int8 KV pages).

Requests of any length join and leave a running batch freely. Every engine
step runs one fixed-shape `StepPlan` the scheduler packs — a flat
`token_budget`-row ragged batch of decode rows interleaved with chunked-
prefill rows — through the decoder over the paged KV pool
(`kv_pages.py`): copy-on-write page splits, embed, per layer the attention
projections, the scatter of the new rows into the pool and ragged paged
attention (`ops/paged_attention.py`: the hand-written CUDA kernels on the
card, the plain versions on the CPU), then the MLP; final norm, unembed and
the greedy/sampled tail.

- GQA: q/k/v projections, K/V rows into the pool, K4 (fp pages) or K5.
- MLA (DeepSeek latent attention): the absorbed projections
  (`inference/generate.mla_absorbed_inputs`), the kv latent and the shared
  rope row into the latent pool, K6 (fp pages) or K7 over the latent pages,
  then the value half of the kv up-projection and o_proj.
- MoE decoders run the dense prefix stack (`dense_layers`, gated MLP) and
  then the MoE stack (`moe_layers`, dropless routed + shared experts); each
  stack has its own pool tuple.
- kv_cache_dtype="int8": the new rows quantize at scatter time
  (`ops/quant.quantize_kv_rows`, one fp32 scale per row into the pool's
  scale planes) and attention dequantizes inside the kernel.

What differs from the JAX engine:

- PyTorch runs eagerly: there is no jitted step and nothing compiles, so
  the `compiled_signatures` stat is 0. The layer scan is a Python loop.
- The pool is updated IN PLACE (`self.pool` is written by index), not
  returned as a donated copy and rebound.
- Sampling draws Gumbel noise from a `torch.Generator` seeded from
  (request seed, position of the new token): deterministic per request,
  independent of batching and stable across preemption, like the JAX
  engine's fold_in(key(seed), position) — but a different draw, so sampled
  tokens match JAX in distribution, not bit for bit. Greedy decoding
  matches token for token.
- Sliding-window and sinked layers stay on the kernels: each layer hands
  K4/K5 its own window (0 for a global layer) and sink logits. The JAX
  engine routes every layer of such a model to its XLA path, because the
  Pallas kernels refuse windows and sinks.
- `serve_precision` ("fp8" / "int8") is one config replace of the model's
  `linear_precision`, as in JAX: the linears `generate.py` quantizes go
  through `ops/quant.quantized_matmul` (`_scaled_mm` / `_int_mm` on the
  card). The weights never change while serving, so each such kernel is
  quantized once when the engine is built (`quant.quantize_kernel`): the
  same numbers, as its scales are a function of the weight alone. The MoE
  expert products stay unquantized (the JAX `moe/` never reads the
  precision).
- DSA models (DeepSeek-V3.2/V4, GLM-5) decode with dense MLA over the
  latent pool, as the JAX engine does: the indexer is not read.
- Observability (`serving.observability`, `automodel_tpu_torch/observability/`)
  is wired where the JAX engine wires it: the step counters and the
  `step.run` / `step.absorb` / `step.plan` spans, the scheduler's lifecycle
  instants, the step-time histogram and the profiler window, and the
  flight-recorder dump on any abnormal exit of `serve_batch`; the fault
  probes `serve_step`, `serve_step_run` and `serve_step_run.<track>` too.
  The step time is the wall time of `run_step`, which ends in its `.cpu()`
  read of the sampled tokens; observability adds no synchronisation.
- Not ported yet (they raise NotImplementedError): speculative decoding,
  a serving mesh (tp, ep) and the router's replica-qualified tracks.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from automodel_tpu_torch.inference.generate import (
    _dense_mlp,
    _embed,
    _moe_mlp,
    mla_absorbed_inputs,
)
from automodel_tpu_torch.inference.sampling import filter_logits
from automodel_tpu_torch.models.common.layers import cast_params
from automodel_tpu_torch.models.llm.decoder import (
    _dense,
    layer_windows,
    project_qkv,
    unembed,
)
from automodel_tpu_torch.observability import Observability, ObservabilityConfig
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.paged_attention import (
    ragged_paged_attention,
    ragged_paged_mla_attention,
)
from automodel_tpu_torch.ops.quant import matmul as _mm, quantize_kernel, quantize_kv_rows
from automodel_tpu_torch.ops.rope import rope_frequencies
from automodel_tpu_torch.resilience.faults import fault_hit
from automodel_tpu_torch.serving.kv_pages import (
    PageAllocator,
    apply_defrag,
    init_pool,
)
from automodel_tpu_torch.serving.prefix_cache import PrefixCache, PrefixCacheConfig
from automodel_tpu_torch.serving.scheduler import Request, Scheduler, StepPlan
from automodel_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Static engine geometry + engine-wide sampling filters (per-request
    temperature/eos/seed live on the Request)."""

    page_size: int = 16
    num_pages: int = 128
    max_slots: int = 8          # concurrent requests resident on device
    pages_per_slot: int = 16    # max context = pages_per_slot * page_size
    token_budget: int = 32      # rows per step (decode + prefill chunks)
    prefill_chunk: int | None = None  # ≤ token_budget; None → token_budget
    top_k: int | None = None
    top_p: float | None = None
    # prefix sharing (serving/prefix_cache.py): refcounted COW pages + a
    # radix tree over known tokens
    prefix_cache: PrefixCacheConfig | None = None
    admission_policy: str = "fifo"  # "fifo" | "prefix-hit"
    # int8 KV pages + per-row fp32 scales: None (model dtype) | "int8"
    kv_cache_dtype: str | None = None
    # low-precision serve-step linears: None | "int8" | "fp8"
    serve_precision: str | None = None
    # JAX-engine option this port does not cover yet: setting it raises
    speculative: object | None = None
    # host-side tracing/metrics/profiling (automodel_tpu_torch/observability/);
    # None/disabled → the null tracer, and the serve loop pays two
    # attribute lookups per probe
    observability: ObservabilityConfig | None = None

    def __post_init__(self):
        if not (self.page_size >= 1 and self.num_pages >= 1):
            raise ValueError("page_size and num_pages must be >= 1")
        if not (self.max_slots >= 1 and self.token_budget >= 1):
            raise ValueError("max_slots and token_budget must be >= 1")
        if self.pages_per_slot < 1:
            raise ValueError("pages_per_slot must be >= 1")
        if self.prefill_chunk is not None and not (
            1 <= self.prefill_chunk <= self.token_budget
        ):
            raise ValueError("prefill_chunk must be in [1, token_budget]")
        if self.admission_policy not in ("fifo", "prefix-hit"):
            raise ValueError(f"unknown admission_policy {self.admission_policy!r}")
        if self.admission_policy == "prefix-hit" and not (
            self.prefix_cache is not None and self.prefix_cache.enabled
        ):
            raise ValueError("admission_policy='prefix-hit' needs the prefix cache")
        if self.kv_cache_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_cache_dtype must be None or 'int8' (got {self.kv_cache_dtype!r})")
        if self.serve_precision not in (None, "int8", "fp8"):
            raise ValueError(
                f"serve_precision must be None, 'int8' or 'fp8' (got {self.serve_precision!r})")
        if self.speculative is not None:
            raise NotImplementedError("serving.speculative is not ported yet")


def _percentiles_ms(samples: list) -> tuple:
    """(p50, p95) of a millisecond sample list, or (None, None)."""
    if not samples:
        return None, None
    return (
        round(float(np.percentile(samples, 50)), 4),
        round(float(np.percentile(samples, 95)), 4),
    )


def _stamp_arrivals(requests, step_idx: int, watch: list) -> None:
    """Mark every request whose arrival window just opened with the wall
    clock, and put it on the TTFT watch list."""
    now = time.perf_counter()
    for r in requests:
        if r.arrival <= step_idx and r.arrived_t < 0:
            r.arrived_t = now
            watch.append(r)


def _resolve_ttft(watch: list) -> list:
    """Stamp time-to-first-token on every watched request that committed
    its first token; returns the still-waiting remainder."""
    now = time.perf_counter()
    still = []
    for r in watch:
        if r.generated:
            r.ttft_s = now - r.arrived_t
        else:
            still.append(r)
    return still


def _sample_seed(seed: int, position: int) -> int:
    """A 63-bit generator seed mixed from (request seed, token position)."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(position)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _layer_slice(stacked, i: int):
    """Layer `i`'s view of a nested dict of (L, ...) tensors."""
    if isinstance(stacked, dict):
        return {k: _layer_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


def _linear_cost(tree: dict, moe, path: tuple = ()) -> tuple[float, float, float]:
    """(elements each token multiplies with, bytes held, bytes of the
    routed experts) of one layer's linear kernels: a token reaches top-k of
    the E routed experts. A kernel quantized at build counts its quantized
    weight and its scales."""
    per_token = held = experts = 0.0
    for k, v in tree.items():
        if isinstance(v, dict):
            t, h, e = _linear_cost(v, moe, path + (k,))
            per_token, held, experts = per_token + t, held + h, experts + e
            continue
        if k != "kernel":
            continue
        w = getattr(v, "qw", v)
        nbytes = float(w.numel() * w.element_size())
        if hasattr(v, "sw"):
            nbytes += v.sw.numel() * v.sw.element_size()
        n = float(w.numel())
        held += nbytes
        if "experts" in path and moe is not None:
            n *= moe.num_experts_per_tok / moe.n_routed_experts
            experts += nbytes
        per_token += n
    return per_token, held, experts


class ServingEngine:
    """Paged-cache continuous-batching engine for the dense decoder
    (`models/llm/decoder.TransformerConfig`) and the MoE decoder
    (`models/moe_lm/decoder.MoETransformerConfig`), GQA or MLA.

    `device=None` means CUDA and raises without a CUDA device; tests pass
    `device="cpu"`. `attn_impl` is handed to the paged attention ops:
    "auto" runs the CUDA kernels on the card and the plain versions on the
    CPU; "torch" asks for the plain versions on any device."""

    def __init__(
        self,
        params,
        cfg,
        serve_cfg: ServingConfig = ServingConfig(),
        *,
        mesh_ctx=None,
        device=None,
        attn_impl: str = "auto",
        obs: Observability | None = None,
        track: str = "engine",
    ):
        from automodel_tpu_torch.models.moe_lm.gemma4 import Gemma4MoEConfig
        from automodel_tpu_torch.models.moe_lm.het_moe import HetMoEConfig

        if isinstance(cfg, (HetMoEConfig, Gemma4MoEConfig)):
            # as the JAX engine refuses a HetMoEConfig; neither JAX engine
            # drives Gemma-4 MoE
            raise NotImplementedError(
                "ServingEngine drives the layer-scan decoders; the het "
                "engine's per-layer python loop needs its own step function "
                f"({type(cfg).__name__})")
        if cfg.attention_type not in ("gqa", "mla"):
            raise NotImplementedError(
                f"attention_type {cfg.attention_type!r} is not ported yet"
            )
        if mesh_ctx is not None:
            raise NotImplementedError("a serving mesh is not ported yet")
        if track != "engine":
            raise NotImplementedError(
                f"track {track!r}: replica-qualified tracks belong to the replica "
                "router, which is not ported (ROADMAP.md queue 1 item 13)")
        if attn_impl not in ("auto", "cuda", "torch"):
            raise ValueError(f"Unknown paged attention impl '{attn_impl}'")
        self.device = resolve_device(device)
        self.obs = obs if obs is not None else Observability(
            serve_cfg.observability, device=self.device)
        self.track = track
        if serve_cfg.serve_precision is not None:
            cfg = dataclasses.replace(cfg, linear_precision=serve_cfg.serve_precision)
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.is_mla = cfg.attention_type == "mla"
        self._kv_quant = serve_cfg.kv_cache_dtype is not None
        self.params = cast_params(params, cfg.dtype, self.device)

        # stacks mirror the JAX engine: a dense decoder has one; an MoE
        # decoder a dense prefix stack, then the MoE stack
        if getattr(cfg, "moe", None) is not None:
            stacks = []
            if cfg.first_k_dense > 0:
                stacks.append(("dense_layers", _dense_mlp, cfg.first_k_dense))
            stacks.append(("moe_layers", _moe_mlp, cfg.num_moe_layers))
        else:
            L = self.params["layers"]["input_norm"]["scale"].shape[0]
            stacks = [("layers", _dense_mlp, L)]
        # one entry per layer, in order: (stack index, index in the stack,
        # the layer's weights, its MLP)
        self._layers = [
            (si, li, _layer_slice(self.params[key], li), mlp_fn)
            for si, (key, mlp_fn, L) in enumerate(stacks)
            for li in range(L)
        ]
        n_layers = len(self._layers)
        # sink logits in float32 once, as the kernels take them
        for _, _, lp, _ in self._layers:
            if "sinks" in lp:
                lp["sinks"] = lp["sinks"].float().contiguous()
            if cfg.linear_precision is not None:
                self._quantize_linears(lp)

        # each layer's window, 0 for a global layer
        self._windows = [w or 0 for w in layer_windows(cfg, n_layers)]
        self._any_window = any(self._windows)
        self._attn_impl = attn_impl
        inv_freq = rope_frequencies(
            cfg.rope_dim, cfg.rope_theta, cfg.rope_scaling
        ).to(self.device)
        if cfg.rope_local_theta is not None:
            inv_local = rope_frequencies(
                cfg.rope_dim, cfg.rope_local_theta, None
            ).to(self.device)
            self._freqs = [inv_local if w > 0 else inv_freq for w in self._windows]
        else:
            self._freqs = [inv_freq] * n_layers

        self.pool = init_pool(
            cfg, [L for _, _, L in stacks], serve_cfg.num_pages,
            serve_cfg.page_size, self.device, serve_cfg.kv_cache_dtype,
        )
        # engine-lifetime prefix cache: with the cache enabled, one
        # allocator + radix tree serve every scheduler this engine makes, so
        # a prompt cached during one serve_batch call serves later calls
        pc = serve_cfg.prefix_cache
        if pc is not None and pc.enabled:
            self.alloc = PageAllocator(serve_cfg.num_pages, serve_cfg.page_size)
            self.prefix = PrefixCache(self.alloc, serve_cfg.page_size, pc)
        else:
            self.alloc = None
            self.prefix = None
        self.steps_run = 0

    # the linears the step sends through quant.matmul: a GQA layer's o_proj
    # goes through `_dense` unquantized, as in the JAX engine
    _QUANT_LINEARS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "down_proj",
                      "q_down_proj", "q_up_proj", "kv_down_proj")

    def _quantize_linears(self, lp: dict) -> None:
        """Quantize layer lp's low-precision kernels once, in place."""
        keys = self._QUANT_LINEARS + (("o_proj",) if self.is_mla else ())
        for key in keys:
            if key in lp:
                lp[key] = {**lp[key], "kernel": quantize_kernel(
                    lp[key]["kernel"], self.cfg.linear_precision)}

    # -- device step --------------------------------------------------------
    def _write_rows(self, cache, li, b, rows) -> tuple:
        """Scatter the step's new cache rows (one tensor per pool payload:
        K and V, or the latent and rope rows) into layer li of a stack's
        pool tuple, in place. fp pools take the rows in the pool dtype; int8
        pools quantize each row (`quantize_kv_rows`) and write its scale
        into the payload's scale plane. Returns layer li's two scale planes
        for the attention op, (None, None) for fp pools."""
        page, off = b["page"], b["off"]
        if not self._kv_quant:
            for pool_x, x in zip(cache, rows):
                pool_x[li][page, off] = x.to(pool_x.dtype)
            return None, None
        planes = cache[len(rows):]
        for pool_x, plane, x in zip(cache, planes, rows):
            qx, row_scales = quantize_kv_rows(x)
            pool_x[li][page, off] = qx
            plane[li][page, off] = row_scales
        return tuple(plane[li] for plane in planes)

    def _attn(self, h, i, li, lp, cache, b, pt_tok, rope_pos):
        """Layer i's attention sub-block (layer li of its stack, whose pool
        tuple is `cache`): write the new rows into the pool in place, attend
        over the pages. h is (1, T, H)."""
        cfg = self.cfg
        x = rms_norm(h, lp["input_norm"]["scale"], cfg.rms_norm_eps,
                     cfg.zero_centered_norm)
        window = self._windows[i] if self._any_window else None
        if self.is_mla:
            n, dv = cfg.num_heads, cfg.mla_v_head_dim
            q_abs, q_rope, c_kv, k_rope, w_uv = mla_absorbed_inputs(
                x, lp, cfg, rope_pos, self._freqs[i]
            )
            c_scales, kr_scales = self._write_rows(cache, li, b, (c_kv[0], k_rope[0]))
            scale = (
                cfg.attn_scale if cfg.attn_scale is not None
                else (cfg.mla_qk_nope_head_dim + cfg.mla_qk_rope_head_dim) ** -0.5
            )
            out_lat = ragged_paged_mla_attention(
                q_abs[0].contiguous(), q_rope[0].contiguous(), cache[0][li],
                cache[1][li], pt_tok, b["pos"], scale=scale, window=window,
                impl=self._attn_impl, c_scales=c_scales, kr_scales=kr_scales,
            )
            attn = torch.einsum("tnr,rnd->tnd", out_lat, w_uv)
            return h + _mm(attn.reshape(1, -1, n * dv), lp["o_proj"]["kernel"],
                           cfg.linear_precision)
        q, k, v = project_qkv(x, lp, cfg, rope_pos, self._freqs[i])
        k_scales, v_scales = self._write_rows(cache, li, b, (k[0], v[0]))
        scale = (
            cfg.attn_scale if cfg.attn_scale is not None
            else cfg.resolved_head_dim ** -0.5
        )
        attn = ragged_paged_attention(
            q[0].contiguous(), cache[0][li], cache[1][li], pt_tok, b["pos"],
            scale=scale, window=window,
            soft_cap=cfg.attn_soft_cap, sinks=lp.get("sinks"),
            impl=self._attn_impl, k_scales=k_scales, v_scales=v_scales,
        )
        T = attn.shape[0]
        attn_out = _dense(attn.reshape(1, T, -1), lp["o_proj"])
        if cfg.use_post_norms:
            attn_out = rms_norm(
                attn_out, lp["post_attn_out_norm"]["scale"],
                cfg.rms_norm_eps, cfg.zero_centered_norm,
            )
        return h + attn_out

    @torch.no_grad()
    def _forward(self, b) -> torch.Tensor:
        """One step's decoder pass over the pool; returns the (S, V) fp32
        logits of each slot's sample row (a junk row where sample_tok < 0)."""
        cfg = self.cfg
        # per-token page-table rows: pads index slot 0's table but their
        # position is -1, so they attend to nothing
        pt_tok = b["page_tables"][b["slot"].clamp(min=0).long()]
        rope_pos = b["pos"].clamp(min=0)[None]  # (1, T); pads clamped
        h = _embed(self.params, cfg, b["tok"][None].long())  # (1, T, H)
        for i, (si, li, lp, mlp_fn) in enumerate(self._layers):
            h = self._attn(h, i, li, lp, self.pool[si], b, pt_tok, rope_pos)
            h = mlp_fn(h, lp, cfg)
        h = rms_norm(h, self.params["final_norm"]["scale"], cfg.rms_norm_eps,
                     cfg.zero_centered_norm)
        idx = b["sample_tok"].clamp(0, h.shape[1] - 1).long()
        return unembed(self.params, cfg, h[0, idx][None])[0]

    def _cow(self, plan: StepPlan) -> None:
        """Copy-on-write page splits (≤ 1 per slot): a slot about to append
        into a page someone else still reads gets a private copy. Entries
        with src == dst (trash onto trash) are no-ops and are skipped."""
        live = plan.cow_src != plan.cow_dst
        if not live.any():
            return
        src = torch.from_numpy(plan.cow_src[live].astype(np.int64)).to(self.device)
        dst = torch.from_numpy(plan.cow_dst[live].astype(np.int64)).to(self.device)
        for stack in self.pool:
            for a in stack:
                a[:, dst] = a[:, src]

    def _sample(self, logits, plan: StepPlan):
        """Greedy where a slot's temperature <= 0, else a top-k/top-p
        filtered categorical draw (Gumbel-max) with noise from a generator
        seeded from (slot seed, position of the new token)."""
        tokens = torch.argmax(logits, dim=-1)
        sampled = np.nonzero(plan.temp > 0.0)[0]
        if len(sampled):
            sc = self.serve_cfg
            rows = torch.from_numpy(sampled).to(self.device)
            temp = torch.from_numpy(plan.temp[sampled]).to(self.device)
            filtered = filter_logits(
                logits[rows] / torch.clamp(temp, min=1e-6)[:, None],
                sc.top_k, sc.top_p,
            )
            idx = np.clip(plan.sample_tok[sampled], 0, len(plan.pos) - 1)
            next_pos = np.maximum(plan.pos[idx], 0) + 1
            noise = []
            for s, p in zip(plan.seed[sampled], next_pos):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(_sample_seed(s, p))
                u = torch.rand(logits.shape[-1], generator=gen, device=self.device)
                noise.append(-torch.log(-torch.log(u)))
            tokens[rows] = torch.argmax(filtered + torch.stack(noise), dim=-1)
        logprobs = torch.log_softmax(logits, dim=-1)
        lp_tok = torch.gather(logprobs, -1, tokens[:, None])[:, 0]
        return tokens.to(torch.int32), lp_tok

    # -- host API -----------------------------------------------------------
    def _plan_batch(self, plan: StepPlan) -> dict:
        """StepPlan → the step's batch dict of device tensors (the one
        host→device upload per step)."""
        keys = ("tok", "slot", "pos", "page", "off", "page_tables",
                "sample_tok", "temp", "seed")
        b = {k: torch.from_numpy(getattr(plan, k)).to(self.device) for k in keys}
        b["page"] = b["page"].long()
        b["off"] = b["off"].long()
        return b

    def step_logits(self, plan: StepPlan) -> torch.Tensor:
        """Run one StepPlan (COW splits, pool writes, decoder pass) and
        return the (S, V) fp32 logits of its sample rows."""
        self._cow(plan)
        return self._forward(self._plan_batch(plan))

    def step_cost(self, plan: StepPlan) -> dict:
        """FLOPs and bytes one step needs for `plan`, counted from the
        weights and the plan's rows and positions (observability's
        `step_efficiency` joins them with a measured step time). FLOPs: the
        GEMMs of the live rows over each layer's active linear weights, each
        layer's paged attention over the kv indices its rows attend to (by
        the formulas of K4-K7's bounds), and the unembed of the sample rows.
        Bytes: every weight the step reads, once (the routed experts: the
        share that top-k of the live rows can reach, at most all of them),
        every distinct page each layer reads, once, the new cache rows, the
        head and the sample rows' logits."""
        cfg, ps = self.cfg, self.serve_cfg.page_size
        elt = torch.empty((), dtype=cfg.dtype).element_size()
        rows = int((plan.pos >= 0).sum())
        samples = int((plan.sample_tok >= 0).sum())
        moe = getattr(cfg, "moe", None)
        if self.is_mla:
            row = cfg.mla_kv_lora_rank + cfg.mla_qk_rope_head_dim
            ops_per_kv = cfg.num_heads * (4 * cfg.mla_kv_lora_rank
                                          + 2 * cfg.mla_qk_rope_head_dim)
        else:
            row = 2 * cfg.num_kv_heads * cfg.resolved_head_dim
            ops_per_kv = cfg.num_heads * 4 * cfg.resolved_head_dim
        # one page of one layer's pool, scale planes included
        page_bytes = (ps * row + 2 * ps * 4 if self.serve_cfg.kv_cache_dtype == "int8"
                      else ps * row * elt)
        flops = nbytes = 0.0
        for (_si, _li, lp, _mlp), window in zip(self._layers, self._windows):
            per_token, held, experts = _linear_cost(lp, moe)
            if experts:
                reach = min(1.0, rows * moe.num_experts_per_tok / moe.n_routed_experts)
                held -= experts * (1.0 - reach)
            # every kv index a row attends to, and every page that meets a
            # row's window, once
            pages, kv = set(), 0
            for p, s in zip(plan.pos, plan.slot):
                if p < 0:
                    continue
                lo = max(int(p) - window + 1, 0) if window else 0
                kv += int(p) + 1 - lo
                pages.update(int(x) for x in plan.page_tables[s][lo // ps: int(p) // ps + 1])
            flops += 2.0 * rows * per_token + kv * ops_per_kv
            nbytes += held + (len(pages) + rows / ps) * page_bytes
        H, V = cfg.hidden_size, cfg.vocab_size
        flops += 2.0 * samples * H * V
        nbytes += H * V * elt + samples * V * 4
        return {"flops": flops, "bytes_accessed": nbytes}

    def run_step(self, plan: StepPlan):
        """Run one StepPlan; returns numpy (tokens (S,), logprobs (S,)).
        The fault probes come before the step counters, so an injected
        fault leaves the counters and the pool as they were."""
        fault_hit("serve_step_run", self.steps_run)
        fault_hit(f"serve_step_run.{self.track}", self.steps_run)
        reg = self.obs.registry
        reg.counter("serve_steps_total").inc()
        reg.counter("serve_plan_tokens_total").inc(plan.n_tokens)
        reg.counter("serve_plan_samples_total").inc(plan.n_samples)
        with self.obs.tracer.span(
            "step.run", track=self.track, step=self.steps_run,
            n_tokens=plan.n_tokens, n_samples=plan.n_samples,
        ):
            tokens, lps = self._sample(self.step_logits(plan), plan)
            self.steps_run += 1
            return tokens.cpu().numpy(), lps.cpu().numpy()

    def run_and_absorb(
        self, sched: Scheduler, plan: StepPlan, step_idx: int,
    ) -> tuple[int, float]:
        """One engine step + scheduler absorption. Returns (tokens
        committed, step seconds); the time covers run_step only (upload,
        step, readback, which waits for the device)."""
        t0 = time.perf_counter()
        out = self.run_step(plan)
        dt = time.perf_counter() - t0
        self.obs.observe_step(self.steps_run, dt * 1e3)
        with self.obs.tracer.span(
            "step.absorb", track=self.track, step=self.steps_run
        ):
            n_new = self.absorb_outputs(sched, plan, out, step_idx)
        return n_new, dt

    def absorb_outputs(
        self, sched: Scheduler, plan: StepPlan, out, step_idx: int,
    ) -> int:
        """Feed one run_step output tuple back into the scheduler."""
        tokens, _lps = out
        return sched.update(plan, tokens, step_idx)

    def run_one_step(
        self, sched: Scheduler, step_idx: int,
    ) -> tuple[StepPlan | None, int, float]:
        """ONE reentrant serve step: schedule → run → absorb. Returns
        (plan, tokens committed, step seconds) with plan=None when nothing
        could be packed this step."""
        with self.obs.tracer.span(
            "step.plan", track=self.track, step=self.steps_run
        ):
            plan = sched.schedule(step_idx)
        if plan is None:
            return None, 0, 0.0
        n_new, dt = self.run_and_absorb(sched, plan, step_idx)
        return plan, n_new, dt

    def make_scheduler(self) -> Scheduler:
        sc = self.serve_cfg
        if self.alloc is not None:
            # a prior serve_batch cut short (max_steps budget) may have
            # left slot tables behind in the engine-lifetime allocator —
            # release them so only the radix tree's own references carry
            # into the fresh scheduler
            for slot in list(self.alloc._tables):
                self.alloc.free_slot(slot)
        return Scheduler(
            num_pages=sc.num_pages, page_size=sc.page_size,
            max_slots=sc.max_slots, pages_per_slot=sc.pages_per_slot,
            token_budget=sc.token_budget, prefill_chunk=sc.prefill_chunk,
            prefix_cache=sc.prefix_cache,
            admission_policy=sc.admission_policy,
            alloc=self.alloc, prefix=self.prefix,
            tracer=self.obs.tracer, track=self.track,
        )

    def _mirror_stats(self, stats: dict, sched: Scheduler) -> None:
        """Land one serve_batch call's outcome counters on the central
        registry (per-call deltas — the registry keeps lifetime totals).
        The port's scheduler cancels nothing (the online frontend is not
        ported), so `serve_cancelled_total` moves by 0."""
        reg = self.obs.registry
        for name, key in (
            ("serve_new_tokens_total", "new_tokens"),
            ("serve_requests_total", "requests"),
            ("serve_preemptions_total", "preemptions"),
            ("serve_timed_out_total", "timed_out"),
            ("serve_prefix_hits_total", "prefix_hits"),
            ("serve_prefill_skipped_tokens_total", "prefill_skipped_tokens"),
            ("serve_cow_copies_total", "cow_copies"),
        ):
            if key in stats:
                reg.counter(name).inc(stats[key])
        reg.counter("serve_cancelled_total").inc(0)
        reg.gauge("serve_compiled_signatures").set(stats["compiled_signatures"])
        reg.gauge("serve_free_pages").set(sched.alloc.num_free)

    def reset_prefix_cache(self) -> int:
        """Drop the engine-lifetime radix tree; returns nodes evicted."""
        return self.prefix.reset() if self.prefix is not None else 0

    def defrag(self, scheduler: Scheduler) -> bool:
        """Compact live pages to a dense pool prefix; returns whether a
        compaction ran."""
        plan = scheduler.alloc.defrag_plan()
        if plan is None:
            return False
        src, _n_live = plan
        self.pool = apply_defrag(self.pool, src)
        return True

    def serve_batch(
        self,
        requests: list[Request],
        *,
        metric_logger=None,
        max_steps: int | None = None,
        log_every: int = 0,
    ) -> dict:
        """Offline continuous-batching run: drive steps until every request
        finished. Returns {"outputs": [generated ids per request, submission
        order], "requests": finished Request objects, "stats": counters}.
        `metric_logger` is anything with a `log(dict)` method.

        On any abnormal exit the observability flight recorder dumps its
        ring of recent trace events (reason "stall" for the pool-deadlock
        RuntimeError, "crash" for everything else — an injected FaultCrash,
        a BaseException, included) before re-raising."""
        try:
            return self._serve_batch(
                requests, metric_logger=metric_logger,
                max_steps=max_steps, log_every=log_every,
            )
        except RuntimeError as e:
            self.obs.flight_dump(
                "stall" if str(e).startswith("serving stalled") else "crash"
            )
            raise
        except BaseException:
            self.obs.flight_dump("crash")
            raise

    def _serve_batch(
        self,
        requests: list[Request],
        *,
        metric_logger=None,
        max_steps: int | None = None,
        log_every: int = 0,
    ) -> dict:
        sched = self.make_scheduler()
        for r in requests:
            sched.submit(r)
        budget = max_steps if max_steps is not None else 10_000_000
        t_start = time.perf_counter()
        decode_s = 0.0
        n_sampled = 0
        n_tokens_fed = 0
        n_steps = 0  # this call only (self.steps_run is engine-lifetime)
        itl_ms: list = []     # per-step ms per committed token
        ttft_watch: list = []  # arrived requests awaiting their first token
        step_idx = 0
        while sched.has_work and step_idx < budget:
            # chaos probe ("serve_step"): disarmed it is two dict lookups; an
            # injected crash exercises the flight recorder's crash dump
            fault_hit("serve_step", step_idx)
            _stamp_arrivals(sched.waiting, step_idx, ttft_watch)
            plan, n_new, dt = self.run_one_step(sched, step_idx)
            if plan is None:
                if not sched.has_work:
                    break  # deadline expiry drained the last request(s)
                arrivals = [
                    r.arrival for r in sched.waiting if r.arrival > step_idx
                ]
                nd = sched.next_deadline
                if nd is not None and nd > step_idx:
                    # a pending deadline will evict the blocker — jump
                    # ahead, but never past a servable arrival
                    step_idx = min([nd] + arrivals)
                    continue
                if not arrivals:
                    blocked = (
                        sched.waiting[0] if sched.waiting
                        else next(iter(sched.running.values()), None)
                    )
                    raise RuntimeError(
                        "serving stalled: request "
                        f"rid={getattr(blocked, 'rid', '?')} needs more pages "
                        f"than the pool can ever free ({sched.alloc.num_free} "
                        f"free of {sched.alloc.num_pages}, "
                        f"{len(sched.running)} running, "
                        f"{len(sched.waiting)} waiting)"
                    )
                step_idx += 1  # nothing runnable yet (future arrivals)
                continue
            n_steps += 1
            n_tokens_fed += plan.n_tokens
            if plan.n_samples:
                decode_s += dt
                n_sampled += n_new
                if n_new:
                    itl_ms.append(dt * 1e3 / n_new)
            if ttft_watch:
                ttft_watch = _resolve_ttft(ttft_watch)
            if metric_logger is not None and log_every and (
                self.steps_run % log_every == 0
            ):
                metric_logger.log({
                    "step": self.steps_run,
                    "serving_step_ms": round(dt * 1e3, 3),
                    "tokens_fed": plan.n_tokens,
                    "tokens_sampled": n_new,
                    "running": len(sched.running),
                    "waiting": len(sched.waiting),
                    "free_pages": sched.alloc.num_free,
                })
            step_idx += 1
        elapsed = time.perf_counter() - t_start
        if sched.has_work and max_steps is None:
            raise RuntimeError("serving stalled with work left")
        by_rid = sorted(sched.finished, key=lambda r: r.rid)
        ttft_p50, ttft_p95 = _percentiles_ms(
            [r.ttft_s * 1e3 for r in by_rid if r.ttft_s >= 0]
        )
        itl_p50, itl_p95 = _percentiles_ms(itl_ms)
        stats = {
            "steps": n_steps,
            "requests": len(by_rid),
            "new_tokens": n_sampled,
            "tokens_fed": n_tokens_fed,
            "elapsed_s": round(elapsed, 4),
            "decode_tokens_per_sec": round(n_sampled / max(decode_s, 1e-9), 2),
            "ms_per_token": round(1e3 * decode_s / max(n_sampled, 1), 4),
            "ttft_p50_ms": ttft_p50,
            "ttft_p95_ms": ttft_p95,
            "itl_p50_ms": itl_p50,
            "itl_p95_ms": itl_p95,
            "preemptions": sched.n_preemptions,
            "timed_out": sched.n_timed_out,
            "compiled_signatures": 0,  # eager PyTorch compiles no step program
        }
        if sched.prefix is not None:
            stats.update({
                "prefix_hits": sched.n_prefix_hits,
                "prefill_skipped_tokens": sched.prefill_skipped,
                "cow_copies": sched.n_cow,
                "prefix_cached_pages": sched.prefix.cached_pages,
                "prefix_evicted_pages": sched.prefix.n_evicted,
            })
        self._mirror_stats(stats, sched)
        if metric_logger is not None:
            metric_logger.log({"step": self.steps_run, **{
                f"serve_{k}": v for k, v in stats.items()
            }})
        return {
            "outputs": [list(r.generated) for r in by_rid],
            "requests": by_rid,
            "stats": stats,
        }
