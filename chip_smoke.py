#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`automodel_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds every hand-written kernel of the port from `automodel_tpu_torch/csrc/`
(one nvcc per source, all started together) and runs these phases, printing
one JSON line each:

1. device: the card as `nvidia-smi` names it, with its power limit;
2. kernel: K4 (ragged paged attention) against its plain PyTorch version on
   the card, in bf16 and fp32, at Llama-3-8B's attention shapes, timed
   beside its memory bound;
3. flash: K1-K3 (flash attention forward, dq, dk/dv) against their plain
   versions at the training shapes (B 1, S 4096, Hq 32, Hkv 8, D 128,
   causal) in bf16 and fp32, plus a packed-segment case and an S that is
   not a multiple of the tile; timed beside their operations bound, the
   plain versions and `scaled_dot_product_attention` as a yardstick;
4. serve: the serving engine's main path (`ServingEngine.serve_batch`) at
   the full width and depth of Llama-3-8B with random weights: 16 requests
   of 64-900 prompt tokens, 32 greedy tokens each; every layer of every
   step must have launched K4. A profile of 10 more steps of the same
   traffic follows (device time by kernel, idle share);
5. engine: at the same width but 2 layers in fp32, the same step plans run
   through the engine with the kernel and with the plain version, whose
   logits and greedy tokens must agree;
6. train: the training CLI (`python -m automodel_tpu_torch`, run in this
   process) on `examples/llm_pretrain/llama3_8b_mock_bf16.yaml` at its
   published width, bf16 and full remat, cut to 8 layers, 2 microbatches
   of 4096 tokens per step, 5 steps: every loss and grad norm finite, the
   first loss near ln(vocab), K1 launched 2 x layers x microbatches x steps
   times (forward and remat recompute), K2 and K3 half that; then one more
   step under torch.profiler;
7. train check: the same width, 2 layers, fp32, one accumulated step from
   the same weights and batch with the kernels and with the plain
   attention: losses and gradients must agree;
8. train paths: `examples/llm_finetune/tiny_llama_mock_smoke.yaml` (fp32,
   head dim 16) for its 10 steps through the CLI with the kernels and
   through the recipe class called directly with the plain attention:
   the loss curves must agree.

Then it prints the `{"kernels": [...]}` line and, last, the
`{"ok": true, "device": {...}}` line. Any failed check raises and the exit
code is not 0. Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from automodel_tpu_torch.cli.app import main as cli_main
from automodel_tpu_torch.config import parse_args_and_load_config
from automodel_tpu_torch.datasets.loader import make_global_batch, stack_microbatches
from automodel_tpu_torch.datasets.mock import MockDatasetConfig
from automodel_tpu_torch.loss import fused_linear_cross_entropy
from automodel_tpu_torch.models.common.layers import count_params
from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.models.llm.families import llama_config
from automodel_tpu_torch.ops import flash_attention as fa
from automodel_tpu_torch.ops.cuda import _build
from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda
from automodel_tpu_torch.ops.cuda.ragged_paged_attention import (
    SOURCE as K4_SOURCE,
    ragged_paged_attention_cuda,
)
from automodel_tpu_torch.ops.paged_attention import ragged_paged_attention_ref
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine
from automodel_tpu_torch.serving.kv_pages import pages_for
from automodel_tpu_torch.training import accumulate_grads
from automodel_tpu_torch.utils.tree import tree_leaves, tree_map

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

# K1-K3 against their plain versions, as a share of the largest magnitude of
# the plain result. fp32: only the summation order differs (online tiles vs
# one pass over 4096 keys). bf16: the plain versions round probabilities and
# ds to bf16 before their products, the kernels keep fp32, and both round
# their outputs once; 2e-2 is about two bf16 ulps at the largest value.
FA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the training shapes: one 4096-token microbatch of Llama-3-8B attention
FA_SHAPE = dict(B=1, S=4096, Hq=32, Hkv=8, D=128)

TRAIN_YAML = "examples/llm_pretrain/llama3_8b_mock_bf16.yaml"
TRAIN_LAYERS, TRAIN_ACCUM, TRAIN_STEPS = 8, 2, 5
# train check (fp32, 2 layers, kernels vs plain attention, same weights and
# batch): the loss to 1e-5 relative; each gradient leaf to 1e-3 of its
# largest magnitude (attention differences of ~1e-6 pass through the
# backward of 2 layers and a 128256-wide head)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-3
# the CPU-sized recipe, through the CLI (kernels) and the recipe class
# (plain attention) from the same weights: docs/PARITY.md's loss-curve
# tolerances, 1e-4 relative for steps 1-5 and 5e-3 after
TINY_YAML = "examples/llm_finetune/tiny_llama_mock_smoke.yaml"


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


def fa_inputs(dtype, B, S, Hq, Hkv, D, packed: bool, seed: int = 0):
    """Random q, k, v, dO on the card (S == T) and packed segment ids
    (four documents) or None."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v = randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    dout = randn(B, S, Hq, D)
    seg = None
    if packed:
        cuts = torch.tensor([S // 5, S // 2, S // 2 + 7], device="cuda")
        seg = ((torch.arange(S, device="cuda")[:, None] >= cuts).sum(-1)
               .to(torch.int32)[None].expand(B, S).contiguous())
    return q, k, v, dout, seg


def fa_mask(B, S, seg):
    zeros = torch.zeros((B, S), dtype=torch.int32, device="cuda")
    qs = seg if seg is not None else zeros
    return fa.flash_mask(B, S, S, causal_mode="index", qpos=None, qwin=None,
                         qseg=qs, kpos=None, kseg=qs, has_window=False)


def fa_bound(kernel: str, q, k, pairs: int):
    """Least time of one K1/K2/K3 call: the larger of its bytes over HBM
    bandwidth (each input read once, each output written once) and its
    operations over the dtype's peak. Per unmasked (q, k) pair and query
    head: K1 does 4 D flops (QK^T and PV), K2 6 D (QK^T, dO V^T, ds K), K3
    8 D (QK^T, dO V^T, p^T dO, ds^T Q)."""
    B, S, Hq, D = q.shape
    elt = q.element_size()
    q_bytes = q.numel() * elt          # q, out, dO and dq share one shape
    kv_bytes = k.numel() * elt          # k, v, dk and dv share one shape
    row_bytes = B * Hq * S * 4          # lse and delta, fp32
    nbytes, flops_per_pair = {
        "K1": (2 * q_bytes + 2 * kv_bytes + row_bytes, 4),
        "K2": (3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 6),
        "K3": (2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 8),
    }[kernel]
    ops = flops_per_pair * D * pairs * Hq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def fa_check_case(dtype, S, packed, flush, timed: bool) -> dict:
    """K1-K3 against their plain versions on one input; with `timed`, also
    their times, the plain versions' and scaled_dot_product_attention's."""
    sh = dict(FA_SHAPE, S=S)
    B, Hq, D = sh["B"], sh["Hq"], sh["D"]
    q, k, v, dout, seg = fa_inputs(dtype, B, S, Hq, sh["Hkv"], D, packed)
    scale = D ** -0.5
    mask = fa_mask(B, S, seg)
    kw = dict(scale=scale, causal=True)
    out, lse = fa_cuda.flash_fwd_cuda(q, k, v, seg, **kw)
    torch.cuda.synchronize()
    out_ref, lse_ref = fa.flash_attention_ref(q, k, v, mask, scale=scale)
    delta = (dout.float() * out_ref.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa_cuda.flash_dq_cuda(q, k, v, dout, lse_ref, delta, seg, **kw)
    dk, dv = fa_cuda.flash_dkv_cuda(q, k, v, dout, lse_ref, delta, seg, **kw)
    torch.cuda.synchronize()
    grads_ref = fa.flash_attention_bwd_ref(q, k, v, dout, lse_ref, delta, mask,
                                           scale=scale)
    tol = FA_TOL[dtype]
    errs = {}
    for name, got, want in (("out", out, out_ref), ("lse", lse, lse_ref),
                            ("dq", dq, grads_ref[0]), ("dk", dk, grads_ref[1]),
                            ("dv", dv, grads_ref[2])):
        err = (got.float() - want.float()).abs().max().item()
        ref_max = want.float().abs().max().item()
        errs[name] = {"max_abs_err": err, "ref_max": ref_max}
        if not err <= tol * max(1.0, ref_max):
            raise AssertionError(
                f"K1-K3 {name} disagrees with its plain version ({dtype}, "
                f"S={S}, packed={packed}): {err} > {tol} x {max(1.0, ref_max)}")
    entry = {"phase": "flash", "dtype": str(dtype).removeprefix("torch."),
             "shape": sh, "packed_segments": packed, "tol": tol, "errors": errs}
    if timed:
        pairs = int(mask.sum().item())  # unmasked (q, k) pairs per head
        del grads_ref, out_ref
        entry["times"] = fa_times(q, k, v, dout, lse, delta, seg, mask, scale,
                                  pairs, flush)
    emit(entry)
    return entry


def fa_times(q, k, v, dout, lse, delta, seg, mask, scale, pairs, flush) -> dict:
    kw = dict(scale=scale, causal=True)
    times = {
        "K1": time_ms(lambda: fa_cuda.flash_fwd_cuda(q, k, v, seg, **kw), 10, flush),
        "K2": time_ms(lambda: fa_cuda.flash_dq_cuda(
            q, k, v, dout, lse, delta, seg, **kw), 10, flush),
        "K3": time_ms(lambda: fa_cuda.flash_dkv_cuda(
            q, k, v, dout, lse, delta, seg, **kw), 10, flush),
    }
    plain_fwd = time_ms(lambda: fa.flash_attention_ref(q, k, v, mask, scale=scale), 3, flush)
    plain_bwd = time_ms(lambda: fa.flash_attention_bwd_ref(
        q, k, v, dout, lse, delta, mask, scale=scale), 3, flush)
    # the yardstick: PyTorch's fused attention on the same inputs, (B, H, S, D)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    sdpa_fwd = time_ms(sdpa, 10, flush)
    o = sdpa()
    dot = dout.transpose(1, 2)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                                   retain_graph=True), 10, flush)
    out = {}
    for name in ("K1", "K2", "K3"):
        bound_ms, bound_by, nbytes, ops = fa_bound(name, q, k, pairs)
        out[name] = {
            "ms": times[name], "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "operations": ops,
            "tflops": ops / times[name] / 1e9,
            # the plain backward computes dq, dk and dv in one call
            "plain_ms": plain_fwd if name == "K1" else plain_bwd,
            "library_ms": sdpa_fwd if name == "K1" else sdpa_bwd,
            "library_call": (
                "scaled_dot_product_attention forward" if name == "K1" else
                "scaled_dot_product_attention backward (dq, dk and dv in one call)"),
        }
    out["sdpa_fwd_bwd_ms"] = sdpa_fwd + sdpa_bwd
    return out


def flash_phase(flush) -> dict:
    """K1-K3 against their plain versions: the training shapes in bf16
    (timed) and fp32, a packed-segment case and a ragged S; returns the bf16
    entries for the kernels line."""
    main = fa_check_case(torch.bfloat16, FA_SHAPE["S"], False, flush, timed=True)
    fa_check_case(torch.float32, FA_SHAPE["S"], False, flush, timed=False)
    fa_check_case(torch.bfloat16, FA_SHAPE["S"], True, flush, timed=False)
    fa_check_case(torch.bfloat16, FA_SHAPE["S"] - 96 - 5, False, flush, timed=False)
    torch.cuda.empty_cache()
    errs = main["errors"]
    return {
        "K1": dict(main["times"]["K1"], max_abs_err=max(
            errs["out"]["max_abs_err"], errs["lse"]["max_abs_err"])),
        "K2": dict(main["times"]["K2"], max_abs_err=errs["dq"]["max_abs_err"]),
        "K3": dict(main["times"]["K3"], max_abs_err=max(
            errs["dk"]["max_abs_err"], errs["dv"]["max_abs_err"])),
    }


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


def device_ms_by_kernel(prof) -> dict:
    """Device time (ms) of each kernel name in a torch.profiler window."""
    from torch.autograd import DeviceType

    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def train_phase(card: str) -> dict:
    """The training CLI at Llama-3-8B width, 8 layers, 5 steps; returns K1-K3
    launches of that run."""
    from torch.profiler import ProfilerActivity, profile

    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    argv = [
        TRAIN_YAML,
        f"--model.hf_config.num_hidden_layers={TRAIN_LAYERS}",
        "--dataloader.microbatch_size=1",
        f"--dataloader.grad_acc_steps={TRAIN_ACCUM}",
        f"--step_scheduler.max_steps={TRAIN_STEPS}",
        "--checkpoint.enabled=false",
        f"--run_dir={run_dir}",
    ]
    torch.cuda.reset_peak_memory_stats()
    fa_cuda.launches_fwd = fa_cuda.launches_dq = fa_cuda.launches_dkv = 0
    t0 = time.perf_counter()
    recipe = cli_main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"K1": fa_cuda.launches_fwd, "K2": fa_cuda.launches_dq,
                "K3": fa_cuda.launches_dkv}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    records = [json.loads(l) for l in
               (Path(run_dir) / "training.jsonl").read_text().splitlines()]
    cfg = recipe.model_cfg
    n = TRAIN_LAYERS * TRAIN_ACCUM * TRAIN_STEPS
    steady = records[1:]  # step 1 carries the first-call set-up
    tokens_per_step = TRAIN_ACCUM * int(recipe.cfg.get("dataset.seq_len"))
    tps = statistics.median(r["tps"] for r in steady)

    # one more step under the profiler: device time by kernel
    it = iter(recipe.dataloader)
    mbs = [next(it) for _ in range(TRAIN_ACCUM)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        recipe.run_step(mbs)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    by_name = device_ms_by_kernel(prof)
    busy_ms = sum(by_name.values())
    fa_ms = sum(v for k, v in by_name.items()
                if any(f in k for f in ("fwd_kernel<", "dq_kernel<", "dkv_kernel<")))
    top = [[k[:80], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]]
    emit({
        "phase": "train", "card": card,
        "model": f"Llama-3-8B widths, {cfg.num_layers} layers, {cfg.dtype}, "
                 f"remat {cfg.remat_policy}",
        "params": count_params(recipe.train_state.params),
        "steps": len(records), "tokens_per_step": tokens_per_step,
        "losses": [r["loss"] for r in records],
        "grad_norms": [r["grad_norm"] for r in records],
        "ms_per_step": tokens_per_step / tps * 1e3, "tokens_per_s": tps,
        "mfu_pct": statistics.median(r["mfu_pct"] for r in steady),
        "tflops_per_device": statistics.median(r["tflops_per_device"] for r in steady),
        "wall_s_with_setup": wall_s, "peak_mem_gib": peak_gib,
        "launches": launches,
        "expected_launches": {"K1": 2 * n, "K2": n, "K3": n},
        "profiled_step": {"wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
                          "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
                          "flash_kernels_ms": fa_ms,
                          "top_kernels_ms": top},
    })
    if len(records) != TRAIN_STEPS:
        raise AssertionError(f"{len(records)} training records, not {TRAIN_STEPS}")
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"non-finite loss or grad norm: {r}")
    if abs(records[0]["loss"] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(
            f"step-1 loss {records[0]['loss']} is not near ln(V) = "
            f"{math.log(cfg.vocab_size)}")
    if launches != {"K1": 2 * n, "K2": n, "K3": n}:
        raise AssertionError(f"K1-K3 launches {launches} on {n} layer-microbatches")
    del recipe, prof
    torch.cuda.empty_cache()
    return launches


def train_check_phase() -> None:
    """fp32, 2 layers at full width: one accumulated step (2 microbatches of
    4096 tokens) from the same weights and batch with attn_impl "flash" (the
    kernels) and "torch" (the plain attention)."""
    base = llama_config(LLAMA3_8B, num_layers=2, dtype=torch.float32,
                        remat_policy="full")
    params0 = decoder.init(base, torch.Generator(device="cuda").manual_seed(2))
    ds = MockDatasetConfig(num_samples=4, seq_len=4096, vocab_size=base.vocab_size,
                           seed=3).build()
    batch = make_global_batch(stack_microbatches(
        [{k: v[None] for k, v in ds[i].items()} for i in range(2)]), "cuda")
    results = {}
    for impl in ("flash", "torch"):
        cfg = dataclasses.replace(base, attn_impl=impl)

        def loss_fn(params, mb, rng, cfg=cfg):
            h = decoder.forward(params, cfg, mb["input_ids"], return_hidden=True)
            return fused_linear_cross_entropy(
                h, decoder.head_kernel(params, cfg), mb["labels"], chunk_size=2048)

        params = tree_map(lambda t: t.clone().requires_grad_(), params0)
        leaves = tree_leaves(params)
        fa_cuda.launches_fwd = 0
        ce, aux = accumulate_grads(loss_fn, params, batch)
        results[impl] = (float(ce / aux["num_label_tokens"]),
                         [t.grad for t in leaves], fa_cuda.launches_fwd)
        del params, leaves
        torch.cuda.empty_cache()
    (loss_f, g_f, n_f), (loss_t, g_t, n_t) = results["flash"], results["torch"]
    grad_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                   for a, b in zip(g_f, g_t))
    loss_rel = abs(loss_f - loss_t) / abs(loss_t)
    emit({"phase": "train_check", "layers": 2, "dtype": "float32",
          "loss_flash": loss_f, "loss_torch": loss_t, "loss_rel_err": loss_rel,
          "loss_rtol": TRAIN_LOSS_RTOL, "grad_max_rel_err": grad_err,
          "grad_tol": TRAIN_GRAD_TOL, "k1_launches": [n_f, n_t]})
    if n_f == 0 or n_t != 0:
        raise AssertionError("attn_impl did not select the kernels / plain path")
    if loss_rel > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_TOL:
        raise AssertionError("training step differs between kernels and plain")


def train_paths_phase() -> None:
    """The tiny recipe for 10 steps: the CLI (attention on K1-K3) and the
    recipe class called directly with `model.attn_impl=torch`."""
    losses, k1 = {}, {}
    for way, impl in (("cli", "auto"), ("recipe", "torch")):
        run_dir = tempfile.mkdtemp(prefix=f"chip_smoke_tiny_{way}_")
        argv = [TINY_YAML, "--checkpoint.enabled=false", f"--run_dir={run_dir}",
                f"--model.attn_impl={impl}"]
        fa_cuda.launches_fwd = 0
        if way == "cli":
            cli_main(argv)
        else:
            recipe = TrainFinetuneRecipeForNextTokenPrediction(
                parse_args_and_load_config(argv))
            recipe.setup()
            recipe.run_train_validation_loop()
        k1[way] = fa_cuda.launches_fwd
        losses[way] = [json.loads(l)["loss"] for l in
                       (Path(run_dir) / "training.jsonl").read_text().splitlines()]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cli"], losses["recipe"])]
    emit({"phase": "train_paths", "yaml": TINY_YAML, "losses": losses,
          "max_rel_err_steps_1_5": max(rel[:5]), "max_rel_err": max(rel),
          "k1_launches": k1})
    if len(rel) != 10 or not all(math.isfinite(x) for x in losses["cli"]):
        raise AssertionError("the tiny recipe did not train 10 finite steps")
    if k1["cli"] == 0 or k1["recipe"] != 0:
        raise AssertionError(f"tiny recipe: K1 launches {k1} do not follow attn_impl")
    if max(rel[:5]) > 1e-4 or max(rel) > 5e-3:
        raise AssertionError("tiny recipe: kernel and plain loss curves differ")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = _build.build(K4_SOURCE, fa_cuda.SOURCE)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {lib.stem: [l.strip() for l in lib.with_suffix(".log").read_text()
                               .splitlines() if "registers" in l or "spill" in l]
                    for lib in libs}})

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    k4 = kernel_phase(flush)
    flash = flash_phase(flush)
    del flush
    launches, _stats = serve_phase(card)
    engine_phase()
    torch.cuda.empty_cache()
    train_launches = train_phase(card)
    train_check_phase()
    train_paths_phase()

    kernels = [{
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
    }]
    for name, replaces in (("K1", ":140"), ("K2", ":238"), ("K3", ":283")):
        e = flash[name]
        kernels.append({
            "name": {"K1": "flash_attention_fwd", "K2": "flash_attention_dq",
                     "K3": "flash_attention_dkv"}[name],
            "route": "cuda",
            "source": "automodel_tpu_torch/csrc/flash_attention.cu",
            "replaces": "automodel_tpu/ops/pallas/flash_attention.py" + replaces,
            "launches": train_launches[name],
            "max_abs_err": e["max_abs_err"],
            "ms": e["ms"],
            "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"],
            "library_ms": e["library_ms"],
            "library_call": e["library_call"],
            "card": card,
        })
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
