#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`automodel_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds every hand-written kernel of the port from `automodel_tpu_torch/csrc/`
and runs four phases, printing one JSON line each:

1. device: the card as `nvidia-smi` names it, with its power limit;
2. kernel: K4 (ragged paged attention) against its plain PyTorch version on
   the card, in bf16 and fp32, at Llama-3-8B's attention shapes, timed
   beside its memory bound;
3. serve: the serving engine's main path (`ServingEngine.serve_batch`) at
   the full width and depth of Llama-3-8B with random weights: 16 requests
   of 64-900 prompt tokens, 32 greedy tokens each; every layer of every
   step must have launched K4. A profile of 10 more steps of the same
   traffic follows (device time by kernel, idle share);
4. engine: at the same width but 2 layers in fp32, the same step plans run
   through the engine with the kernel and with the plain version, whose
   logits and greedy tokens must agree.

Then it prints the `{"kernels": [...]}` line and, last, the
`{"ok": true, "device": {...}}` line. Any failed check raises and the exit
code is not 0. Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.models.llm.families import llama_config
from automodel_tpu_torch.ops.cuda import _build
from automodel_tpu_torch.ops.cuda.ragged_paged_attention import (
    SOURCE as K4_SOURCE,
    ragged_paged_attention_cuda,
)
from automodel_tpu_torch.ops.paged_attention import ragged_paged_attention_ref
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine
from automodel_tpu_torch.serving.kv_pages import pages_for

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, operations/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Llama-3-8B (examples/llm_pretrain/llama3_8b_mock_bf16.yaml)
LLAMA3_8B = {
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "rope_theta": 500000.0,
    "max_position_embeddings": 8192,
}
# the llm_serve recipe's default ServingConfig (recipes/llm/serve.py)
SERVE = ServingConfig(
    page_size=16, num_pages=2048, max_slots=16, pages_per_slot=64,
    token_budget=64, prefill_chunk=48,
)

# K4 tolerances against the plain version on the same inputs.
# fp32: both sum in fp32; only the order (online vs two-pass softmax, the
# kernel's warp reductions) differs, which moves outputs by ~1e-6.
# bf16: the plain version rounds the probabilities and the value product to
# bf16, the kernel accumulates in fp32 and rounds once; 2e-2 is about two
# bf16 ulps at |out| ~ 1.
K4_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# fp32 logits of the 2-layer engine, kernel vs plain version: attention
# differences of ~1e-6 pass through 2 layers and a 4096-wide unembed
ENGINE_LOGITS_TOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of one call, each call after an L2 flush (the
    serve loop reads every layer's pages cold)."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k4_inputs(dtype, seed: int = 0):
    """A serve step's K4 call at Llama-3-8B's attention shapes: T=64 rows
    (12 decode rows of 12 requests, one request's 48-row prefill chunk,
    4 pad rows), Hq 32 / Hkv 8 / D 128, 16-token pages, N+1 = 2049 pages in
    permuted order, 64-page tables padded with the trash page."""
    ps, N, P, Hq, Hkv, D = 16, 2048, 64, 32, 8, 128
    rng = np.random.default_rng(seed)
    perm = iter(rng.permutation(N))
    ctx = [int(c) for c in rng.integers(64, 1000, 12)] + [448]
    tables = []
    for c in ctx:
        pages = [next(perm) for _ in range(pages_for(c, ps))]
        tables.append(pages + [N] * (P - len(pages)))
    rows_pt = [tables[r] for r in range(12)] + [tables[12]] * 48 + [tables[0]] * 4
    rows_pos = [c - 1 for c in ctx[:12]] + list(range(400, 448)) + [-1] * 4
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(64, Hq, D, generator=gen, device=dev).to(dtype)
    kp = torch.randn(N + 1, ps, Hkv, D, generator=gen, device=dev).to(dtype)
    vp = torch.randn(N + 1, ps, Hkv, D, generator=gen, device=dev).to(dtype)
    pt = torch.tensor(rows_pt, dtype=torch.int32, device=dev)
    pos = torch.tensor(rows_pos, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, pos


def k4_bound(q, kp, vp, pt, pos):
    """Least time for this call's work: the larger of (bytes it must move
    over HBM bandwidth) and (operations over the peak rate of the dtype).
    Bytes: every distinct page any row needs (K and V of all kv heads),
    q, out, page tables and positions, each once. Operations: for each live
    row, each attended kv index and each query head, 2*D for the score and
    2*Dv for the value product."""
    ps, Hkv, D = kp.shape[1], kp.shape[2], kp.shape[3]
    Dv = vp.shape[-1]
    elt = kp.element_size()
    pos_h = pos.cpu().numpy()
    pt_h = pt.cpu().numpy()
    pages = set()
    for p, row in zip(pos_h, pt_h):
        if p >= 0:
            pages.update(int(x) for x in row[: p // ps + 1])
    nbytes = (
        len(pages) * ps * Hkv * (D + Dv) * elt
        + q.numel() * elt + q.shape[0] * q.shape[1] * Dv * elt
        + pt.numel() * 4 + pos.numel() * 4
    )
    ops = sum(int(p) + 1 for p in pos_h if p >= 0) * q.shape[1] * 2 * (D + Dv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def kernel_phase(flush) -> dict:
    """K4 against its plain version in bf16 and fp32; returns the bf16
    (main-path dtype) entry for the kernels line."""
    checks = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, pt, pos = k4_inputs(dtype)
        scale = q.shape[-1] ** -0.5
        got = ragged_paged_attention_cuda(q, kp, vp, pt, pos, scale=scale)
        torch.cuda.synchronize()
        want = ragged_paged_attention_ref(q, kp, vp, pt, pos, scale=scale)
        err = (got.float() - want.float()).abs().max().item()
        pad_zero = bool((got[pos < 0] == 0).all().item())
        capped = ragged_paged_attention_cuda(
            q, kp, vp, pt, pos, scale=scale, soft_cap=30.0)
        capped_ref = ragged_paged_attention_ref(
            q, kp, vp, pt, pos, scale=scale, soft_cap=30.0)
        err_cap = (capped.float() - capped_ref.float()).abs().max().item()
        ms = time_ms(lambda: ragged_paged_attention_cuda(
            q, kp, vp, pt, pos, scale=scale), 30, flush)
        plain_ms = time_ms(lambda: ragged_paged_attention_ref(
            q, kp, vp, pt, pos, scale=scale), 5, flush)
        bound_ms, bound_by, nbytes, ops = k4_bound(q, kp, vp, pt, pos)
        tol = K4_TOL[dtype]
        entry = {
            "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
            "max_abs_err_soft_cap": err_cap, "tol": tol,
            "pad_rows_zero": pad_zero, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "operations": ops,
        }
        emit({"phase": "kernel", "kernel": "K4", **entry})
        if not (err <= tol and err_cap <= tol and pad_zero):
            raise AssertionError(f"K4 disagrees with its plain version: {entry}")
        checks[dtype] = entry
    return checks[torch.bfloat16]


def serve_phase(card: str) -> tuple[int, dict]:
    """The main path at Llama-3-8B width and depth; returns (K4 launches
    during serve_batch, stats)."""
    cfg = llama_config(LLAMA3_8B, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = decoder.init(cfg, gen, dtype=torch.bfloat16)
    engine = ServingEngine(params, cfg, SERVE)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            prompt=[int(t) for t in rng.integers(1, cfg.vocab_size, (int(n),))],
            max_new_tokens=32, arrival=2 * i,
        )
        for i, n in enumerate(rng.integers(64, 901, 16))
    ]
    torch.cuda.reset_peak_memory_stats()
    ragged_paged_attention_cuda.launches = 0
    res = engine.serve_batch(reqs)
    launches = ragged_paged_attention_cuda.launches
    stats = res["stats"]
    emit({
        "phase": "serve", "card": card, "model": "Llama-3-8B widths, 32 layers, bf16",
        "setup_s": setup_s, "stats": stats, "k4_launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    if len(res["outputs"]) != 16 or any(len(o) != 32 for o in res["outputs"]):
        raise AssertionError("not every request finished with 32 tokens")
    if any(not 0 <= t < cfg.vocab_size for o in res["outputs"] for t in o):
        raise AssertionError("a generated token is outside the vocabulary")
    if launches != cfg.num_layers * stats["steps"]:
        raise AssertionError(
            f"K4 launched {launches} times in {stats['steps']} steps of "
            f"{cfg.num_layers} layers"
        )
    profile_steps(engine, cfg, card)
    del engine
    torch.cuda.empty_cache()
    return launches, stats


def profile_steps(engine, cfg, card: str) -> None:
    """Where a serve step's time goes: the same traffic again, 40 steps to
    reach a mix of prefill and decode, then 10 steps under torch.profiler.
    Prints device busy time per step by kernel and the device's idle share
    of the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    sched = engine.make_scheduler()
    for i, n in enumerate(rng.integers(64, 901, 16)):
        sched.submit(Request(
            prompt=[int(t) for t in rng.integers(1, cfg.vocab_size, (int(n),))],
            max_new_tokens=32, arrival=2 * i,
        ))
    for step in range(30):
        engine.run_one_step(sched, step)
    # steps 30-39 unprofiled: the profiler's own host cost inflates the
    # profiled window's wall time, so the idle share is also given against
    # this window's (similar steps, no profiler)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(30, 40):
        engine.run_one_step(sched, step)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    n_steps, rows = 10, 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(40, 40 + n_steps):
            plan, _, _ = engine.run_one_step(sched, step)
            rows += plan.n_tokens if plan is not None else 0
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    k4_ms = sum(v for k, v in by_name.items() if "gqa_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({
        "phase": "profile", "card": card, "steps": n_steps,
        "rows_per_step": rows / n_steps,
        "wall_ms_per_step": wall_ms / n_steps,
        "unprofiled_wall_ms_per_step": plain_wall_ms / n_steps,
        "device_busy_ms_per_step": busy_ms / n_steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_idle_share_vs_unprofiled": 1.0 - busy_ms / plain_wall_ms,
        "k4_ms_per_step": k4_ms / n_steps,
        "k4_share_of_busy": k4_ms / busy_ms if busy_ms else None,
        "top_kernels_ms_per_step": [[k[:80], v / n_steps] for k, v in top],
    })


def engine_phase() -> None:
    """2-layer fp32 engine: identical step plans through the kernel and the
    plain version; logits within ENGINE_LOGITS_TOL, greedy tokens equal."""
    cfg = dataclasses.replace(
        llama_config(LLAMA3_8B), num_layers=2, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = decoder.init(cfg, gen)
    sc = dataclasses.replace(SERVE, num_pages=256)
    e_cuda = ServingEngine(params, cfg, sc, attn_impl="cuda")
    e_torch = ServingEngine(params, cfg, sc, attn_impl="torch")
    sched = e_cuda.make_scheduler()
    rng = np.random.default_rng(1)
    for n in (100, 60, 30):
        sched.submit(Request(
            prompt=[int(t) for t in rng.integers(1, cfg.vocab_size, (n,))],
            max_new_tokens=4,
        ))
    worst, steps = 0.0, 0
    while sched.has_work:
        plan = sched.schedule(steps)
        # every slot's row is compared, the junk rows of slots that sample
        # nothing this step included: both engines compute them alike
        got = e_cuda.step_logits(plan)
        want = e_torch.step_logits(plan)
        worst = max(worst, (got - want).abs().max().item())
        tokens = got.argmax(-1)
        if not torch.equal(tokens, want.argmax(-1)):
            raise AssertionError(f"greedy tokens differ at step {steps}")
        sched.update(plan, tokens.to(torch.int32).cpu().numpy(), steps)
        steps += 1
    emit({"phase": "engine", "layers": 2, "dtype": "float32", "steps": steps,
          "max_abs_logit_err": worst, "tol": ENGINE_LOGITS_TOL})
    if worst > ENGINE_LOGITS_TOL:
        raise AssertionError("engine logits differ between kernel and plain")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    (lib,) = _build.build(K4_SOURCE)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [l.strip() for l in lib.with_suffix(".log").read_text()
                    .splitlines() if "registers" in l or "spill" in l]})

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    k4 = kernel_phase(flush)
    del flush
    launches, _stats = serve_phase(card)
    engine_phase()

    emit({"kernels": [{
        "name": "ragged_paged_attention_gqa",
        "route": "cuda",
        "source": "automodel_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "automodel_tpu/ops/pallas/ragged_paged_attention.py:42",
        "launches": launches,
        "max_abs_err": k4["max_abs_err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": None,
        "library_why": "no single PyTorch call attends over per-row page "
                       "tables; scaled_dot_product_attention needs each "
                       "row's KV gathered dense first",
        "card": card,
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
