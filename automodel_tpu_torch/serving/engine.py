"""Continuous-batching serving engine (port of `automodel_tpu/serving/engine.py`,
the plain GQA path).

Requests of any length join and leave a running batch freely. Every engine
step runs one fixed-shape `StepPlan` the scheduler packs — a flat
`token_budget`-row ragged batch of decode rows interleaved with chunked-
prefill rows — through the decoder over the paged KV pool
(`kv_pages.py`): copy-on-write page splits, embed, per layer the q/k/v
projections, the K/V scatter into the pool and ragged paged attention
(`ops/paged_attention.py`: the hand-written CUDA kernel on the card, the
plain version on the CPU), then the MLP; final norm, unembed and the
greedy/sampled tail.

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
- Not ported yet (they raise NotImplementedError): speculative decoding,
  int8 KV pages, low-precision serve linears, a serving mesh, MLA and MoE
  decoders, and sliding windows or sinks through the CUDA kernel (pass
  `attn_impl="torch"` to serve them with the plain version).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from automodel_tpu_torch.inference.generate import _dense_mlp, _embed
from automodel_tpu_torch.inference.sampling import filter_logits
from automodel_tpu_torch.models.common.layers import cast_params
from automodel_tpu_torch.models.llm.decoder import (
    _dense,
    layer_windows,
    project_qkv,
    unembed,
)
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.paged_attention import ragged_paged_attention
from automodel_tpu_torch.ops.rope import rope_frequencies
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
    # JAX-engine options this port does not cover yet: setting one raises
    speculative: object | None = None
    kv_cache_dtype: str | None = None
    serve_precision: str | None = None

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
        for name in ("speculative", "kv_cache_dtype", "serve_precision"):
            if getattr(self, name) is not None:
                raise NotImplementedError(f"serving.{name} is not ported yet")


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


class ServingEngine:
    """Paged-cache continuous-batching engine for the dense GQA decoder
    (`models/llm/decoder.TransformerConfig`).

    `device=None` means CUDA and raises without a CUDA device; tests pass
    `device="cpu"`. `attn_impl` is handed to `ragged_paged_attention`:
    "auto" runs the CUDA kernel on the card and the plain version on the
    CPU; "torch" asks for the plain version on any device."""

    def __init__(
        self,
        params,
        cfg,
        serve_cfg: ServingConfig = ServingConfig(),
        *,
        mesh_ctx=None,
        device=None,
        attn_impl: str = "auto",
    ):
        if getattr(cfg, "moe", None) is not None:
            raise NotImplementedError("MoE decoders are not ported yet")
        if cfg.attention_type != "gqa":
            raise NotImplementedError(
                f"attention_type {cfg.attention_type!r} is not ported yet"
            )
        if mesh_ctx is not None:
            raise NotImplementedError("a serving mesh is not ported yet")
        if attn_impl not in ("auto", "cuda", "torch"):
            raise ValueError(f"Unknown paged attention impl '{attn_impl}'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.params = cast_params(params, cfg.dtype, self.device)
        L = self.params["layers"]["input_norm"]["scale"].shape[0]
        self._layers = [_layer_slice(self.params["layers"], i) for i in range(L)]

        self._windows = [w or 0 for w in layer_windows(cfg, L)]
        self._any_window = any(self._windows)
        has_sinks = "sinks" in self.params["layers"]
        uses_kernel = attn_impl == "cuda" or (
            attn_impl == "auto" and self.device.type == "cuda"
        )
        if uses_kernel and (self._any_window or has_sinks):
            raise NotImplementedError(
                "the CUDA paged attention kernel covers neither sliding "
                "windows nor sinks; pass attn_impl='torch' for the plain version"
            )
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
            self._freqs = [inv_freq] * L

        self.pool = init_pool(
            cfg, [L], serve_cfg.num_pages, serve_cfg.page_size, self.device
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

    # -- device step --------------------------------------------------------
    def _attn(self, h, i, lp, b, pt_tok, rope_pos):
        """Layer i's attention sub-block: write the new rows' K/V into the
        pool in place, attend over the pages. h is (1, T, H)."""
        cfg = self.cfg
        x = rms_norm(h, lp["input_norm"]["scale"], cfg.rms_norm_eps,
                     cfg.zero_centered_norm)
        q, k, v = project_qkv(x, lp, cfg, rope_pos, self._freqs[i])
        pool_k, pool_v = self.pool[0]
        pool_k[i][b["page"], b["off"]] = k[0].to(pool_k.dtype)
        pool_v[i][b["page"], b["off"]] = v[0].to(pool_v.dtype)
        scale = (
            cfg.attn_scale if cfg.attn_scale is not None
            else cfg.resolved_head_dim ** -0.5
        )
        attn = ragged_paged_attention(
            q[0].contiguous(), pool_k[i], pool_v[i], pt_tok, b["pos"],
            scale=scale,
            window=self._windows[i] if self._any_window else None,
            soft_cap=cfg.attn_soft_cap, sinks=lp.get("sinks"),
            impl=self._attn_impl,
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
        for i, lp in enumerate(self._layers):
            h = self._attn(h, i, lp, b, pt_tok, rope_pos)
            h = _dense_mlp(h, lp, cfg)
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

    def run_step(self, plan: StepPlan):
        """Run one StepPlan; returns numpy (tokens (S,), logprobs (S,))."""
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
        return self.absorb_outputs(sched, plan, out, step_idx), dt

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
        )

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
        `metric_logger` is anything with a `log(dict)` method."""
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
        if metric_logger is not None:
            metric_logger.log({"step": self.steps_run, **{
                f"serve_{k}": v for k, v in stats.items()
            }})
        return {
            "outputs": [list(r.generated) for r in by_rid],
            "requests": by_rid,
            "stats": stats,
        }
