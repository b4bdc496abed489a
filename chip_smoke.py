#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`automodel_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds every hand-written kernel of the port from `automodel_tpu_torch/csrc/`
(one nvcc per source, all started together) and runs these phases, printing
one JSON line each:

1. device: the card as `nvidia-smi` names it, with its power limit;
2. kernel: the paged-attention kernels against their plain PyTorch versions
   on the card, in bf16 and fp32, at one full serve step's rows (64 rows,
   contexts up to 999 tokens, pad rows), each timed beside its bound: K4
   (fp pages) and K5 (int8 pages) at Llama-3-8B's heads (32/8, D 128), K6
   (fp latent pages) and K7 (int8) at Moonlight's MLA widths (16 heads,
   r 512, dr 64); bf16 K5, K6 and K7 are split-KV kernels on the tensor
   cores and their combines, K4 and fp32 K5-K7 the CUDA-core kernels;
3. flash: K1-K3 (flash attention forward, dq, dk/dv) against their plain
   versions at the training shapes (B 1, S 4096, Hq 32, Hkv 8, D 128,
   causal) in bf16 (K1-K3 on the tensor cores) and fp32 (CUDA cores),
   plus a packed-segment case, an S that is not a multiple of the tile and
   head dim 64 in bf16; timed beside their operations bound, the plain
   versions and `scaled_dot_product_attention` as a yardstick;
4. serve / serve_int8: the dense main path (`ServingEngine.serve_batch`) at
   the full width and depth of Llama-3-8B with random weights: 16 requests
   of 64-900 prompt tokens arriving every 2 steps, 32 greedy tokens each,
   on the fp pool (every layer of every step launches K4) and on the int8
   pool with the same weights (K5), with the greedy agreement between the
   two; a profile of 10 more steps of the same traffic follows each
   (device time by kernel, idle share);
5. serve_mla / serve_mla_int8: the MLA + MoE main path, Moonlight-16B-A3B
   at full width and all 27 layers, bf16, random weights from seed 0, on
   the same traffic, on the fp pool (K6) and on the int8 pool (K7), each
   with its profile;
6. engine / engine_mla: 2-layer fp32 engines at Llama-3-8B width (K4) and
   at Moonlight width (one dense, one MoE layer; K6 on the fp pool, K7 on
   the int8 pool): the same step plans run through the engine with the
   kernels and with the plain versions, whose logits and greedy tokens
   must agree; then the same engines in bf16 on the tensor-core routes
   (Llama on the int8 pool, K5; Moonlight on the fp pool, K6, and on the
   int8 pool, K7), on the kernels and on the plain versions, each held to
   the same model in fp32: the kernels' logits no farther from it than
   the plain version's plus the bf16 tolerance, every kernel call within
   `PAGED_TOL` of its plain version on the same inputs, greedy agreements
   reported;
7. train: the training CLI (`python -m automodel_tpu_torch`, run in this
   process) on `examples/llm_pretrain/llama3_8b_mock_bf16.yaml` at its
   published width, bf16 and full remat, cut to 8 layers, 2 microbatches
   of 4096 tokens per step, 5 steps: every loss and grad norm finite, the
   first loss near ln(vocab), K1 launched 2 x layers x microbatches x steps
   times (forward and remat recompute), K2 and K3 half that; then one more
   step under torch.profiler;
8. train check: the same width, 2 layers, fp32, one accumulated step from
   the same weights and batch with the kernels and with the plain
   attention: losses and gradients must agree;
9. train paths: `examples/llm_finetune/tiny_llama_mock_smoke.yaml` (fp32,
   head dim 16) for its 10 steps through the CLI with the kernels and
   through the recipe class called directly with the plain attention:
   the loss curves must agree.

The build line carries ptxas's registers and spills of every kernel, and of
the tensor-core K1-K3 and K5-K7 kernels by name with their dynamic shared
memory. Then it
prints the `{"kernels": [...]}` line and, last, the
`{"ok": true, "device": {...}}` line. Any failed check raises and the exit
code is not 0. Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
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
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.moe_lm.families import deepseek_v3_moe_config
from automodel_tpu_torch.ops import flash_attention as fa
from automodel_tpu_torch.ops.cuda import _build
from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda
from automodel_tpu_torch.ops.cuda import paged_mla_attention as mla_cuda
from automodel_tpu_torch.ops.cuda import ragged_paged_attention as rpa_cuda
from automodel_tpu_torch.ops.cuda.paged_mla_attention import (
    SOURCE as MLA_SOURCE,
    paged_mla_attention_cuda,
    paged_mla_attention_quant_cuda,
)
from automodel_tpu_torch.ops.cuda.ragged_paged_attention import (
    SOURCE as K4_SOURCE,
    ragged_paged_attention_cuda,
    ragged_paged_attention_quant_cuda,
)
from automodel_tpu_torch.ops.paged_attention import (
    ragged_paged_attention_ref,
    ragged_paged_mla_attention_ref,
)
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine
from automodel_tpu_torch.serving import engine as serving_engine
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
# Moonlight-16B-A3B (moonshotai/Moonlight-16B-A3B, config.json, as the
# model-configs catalog gives it): DeepseekV3ForCausalLM, MLA + MoE, no yarn
MOONLIGHT = {
    "architectures": ["DeepseekV3ForCausalLM"], "vocab_size": 163840,
    "hidden_size": 2048, "intermediate_size": 11264,
    "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "n_shared_experts": 2, "n_routed_experts": 64,
    "routed_scaling_factor": 2.446, "kv_lora_rank": 512, "q_lora_rank": None,
    "qk_rope_head_dim": 64, "qk_nope_head_dim": 128, "v_head_dim": 128,
    "n_group": 1, "topk_group": 1, "num_experts_per_tok": 6,
    "first_k_dense_replace": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc",
    "rope_theta": 50000.0, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 8192, "num_nextn_predict_layers": 0,
    "tie_word_embeddings": False,
}
# Moonlight's absorbed-MLA widths: heads, latent rank, rope dim
MOONLIGHT_MLA = (16, 512, 64)
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
# fp32 logits of the 2-layer engines, kernel vs plain version: attention
# differences of ~1e-6 pass through 2 layers and the unembed
ENGINE_LOGITS_TOL = 1e-3
# the same on the int8 pool: the second layer's new rows are quantized from
# hidden states that differ by ~1e-6, so now and then a value sits on a
# rounding half-step and lands one int8 step (~1% of its row's largest
# value) apart in the two engines
ENGINE_INT8_LOGITS_TOL = 2e-2
# the bf16 2-layer engine on the kernels may stray from the same model in
# fp32 by the plain version's own bf16 error plus this share of the largest
# fp32 logit (at least 1): the kernels' own bf16 tolerance
ENGINE_BF16_LOGITS_TOL = 2e-2
# K5-K7 against their plain versions, as a share of the plain result's
# largest magnitude. fp32: only the order of sums differs. bf16: the plain
# versions round dequantized pages, probabilities and the value product to
# bf16; K5 and K7 round p times the value scale to bf16 for the value
# product and their output once (K6 rounds p to bf16 as its plain version
# does); 2e-2 is about two bf16 ulps at the largest value.
PAGED_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# every paged-attention kernel's wrapper, whose `launches` the serve runs read
PAGED_KERNELS = {
    "K4": ragged_paged_attention_cuda,
    "K5": ragged_paged_attention_quant_cuda,
    "K6": paged_mla_attention_cuda,
    "K7": paged_mla_attention_quant_cuda,
}

# K1-K3 against their plain versions, as a share of the largest magnitude of
# the plain result. fp32: only the summation order differs (online tiles vs
# one pass over 4096 keys). bf16: the plain versions round probabilities
# (K1) and ds to bf16 before their products, as the kernels do, but keep p
# in fp32 for dv, which K3 rounds to bf16; the orders of the sums differ,
# and both round their outputs once; 2e-2 is about two bf16 ulps at the
# largest value.
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


def step_rows(seed: int = 0):
    """The rows of one full serve step: T=64 (12 decode rows of 12 requests
    with contexts of 64-999 tokens, one request's 48-row prefill chunk at
    positions 400-447, 4 pad rows), 16-token pages of a 2048-page pool in
    permuted order, 64-page tables padded with the trash page. Returns
    (page_tables, positions) on the card, (N, ps)."""
    ps, N, P = 16, 2048, 64
    rng = np.random.default_rng(seed)
    perm = iter(rng.permutation(N))
    ctx = [int(c) for c in rng.integers(64, 1000, 12)] + [448]
    tables = []
    for c in ctx:
        pages = [next(perm) for _ in range(pages_for(c, ps))]
        tables.append(pages + [N] * (P - len(pages)))
    rows_pt = [tables[r] for r in range(12)] + [tables[12]] * 48 + [tables[0]] * 4
    rows_pos = [c - 1 for c in ctx[:12]] + list(range(400, 448)) + [-1] * 4
    pt = torch.tensor(rows_pt, dtype=torch.int32, device="cuda")
    pos = torch.tensor(rows_pos, dtype=torch.int32, device="cuda")
    return pt, pos, N, ps


def k4_inputs(dtype, seed: int = 0):
    """A serve step's K4 call at Llama-3-8B's attention shapes (`step_rows`;
    Hq 32 / Hkv 8 / D 128)."""
    pt, pos, N, ps = step_rows(seed)
    Hq, Hkv, D = 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(64, Hq, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(N + 1, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(N + 1, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    return q, kp, vp, pt, pos


def paged_bound(pt, pos, ps: int, page_bytes: int, io_bytes: int,
                ops_per_kv: int, dtype):
    """Least time of one paged-attention call: the larger of (bytes it must
    move over HBM bandwidth) and (operations over the peak rate of the
    query dtype). Bytes: every distinct page any live row needs, once
    (`page_bytes` each, scales included), plus `io_bytes` (queries, output)
    and the page tables and positions. Operations: `ops_per_kv` for each
    kv index each live row attends to."""
    pos_h = pos.cpu().numpy()
    pt_h = pt.cpu().numpy()
    pages = set()
    for p, row in zip(pos_h, pt_h):
        if p >= 0:
            pages.update(int(x) for x in row[: p // ps + 1])
    nbytes = len(pages) * page_bytes + io_bytes + pt.numel() * 4 + pos.numel() * 4
    ops = sum(int(p) + 1 for p in pos_h if p >= 0) * ops_per_kv
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def k4_bound(q, kp, vp, pt, pos):
    """K4's bound: K and V of all kv heads of each needed page; q and out;
    per attended kv index and query head, 2*D for the score and 2*Dv for
    the value product."""
    ps, Hkv, D = kp.shape[1], kp.shape[2], kp.shape[3]
    Dv = vp.shape[-1]
    elt = kp.element_size()
    io = q.numel() * elt + q.shape[0] * q.shape[1] * Dv * elt
    return paged_bound(pt, pos, ps, ps * Hkv * (D + Dv) * elt, io,
                       q.shape[1] * 2 * (D + Dv), q.dtype)


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


def int8_pages(gen, *shape):
    """Random int8 pages and (N+1, ps) fp32 per-row scales on the card."""
    pages = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
    scales = 0.002 + 0.03 * torch.rand(shape[:2], generator=gen, device="cuda")
    return pages, scales


def k5_case(dtype, seed: int = 0):
    """K5 at Llama-3-8B's attention shapes over int8 pages."""
    pt, pos, N, ps = step_rows(seed)
    Hq, Hkv, D = 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(64, Hq, D, generator=gen, device="cuda").to(dtype)
    kp, ks = int8_pages(gen, N + 1, ps, Hkv, D)
    vp, vs = int8_pages(gen, N + 1, ps, Hkv, D)
    kw = dict(scale=D ** -0.5)
    elt = q.element_size()
    bound = paged_bound(pt, pos, ps, ps * Hkv * 2 * D + 2 * ps * 4,
                        2 * q.numel() * elt, Hq * 4 * D, dtype)
    return (
        lambda: ragged_paged_attention_quant_cuda(q, kp, vp, ks, vs, pt, pos, **kw),
        lambda: ragged_paged_attention_ref(q, kp, vp, pt, pos, k_scales=ks,
                                           v_scales=vs, **kw),
        pos, bound,
    )


def k67_case(dtype, quant: bool, seed: int = 0):
    """K6 (fp pages) or K7 (int8 pages) at Moonlight's latent widths: n 16
    heads, r 512, dr 64, scale (128 + 64)^-0.5."""
    pt, pos, N, ps = step_rows(seed)
    n, r, dr = MOONLIGHT_MLA
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q_abs = torch.randn(64, n, r, generator=gen, device="cuda").to(dtype)
    q_rope = torch.randn(64, n, dr, generator=gen, device="cuda").to(dtype)
    scale = (128 + 64) ** -0.5
    elt = q_abs.element_size()
    io = (q_abs.numel() * 2 + q_rope.numel()) * elt
    ops = n * (4 * r + 2 * dr)
    if quant:
        c, cs = int8_pages(gen, N + 1, ps, r)
        kr, krs = int8_pages(gen, N + 1, ps, dr)
        bound = paged_bound(pt, pos, ps, ps * (r + dr) + 2 * ps * 4, io, ops, dtype)
        return (
            lambda: paged_mla_attention_quant_cuda(q_abs, q_rope, c, kr, cs, krs,
                                                   pt, pos, scale=scale),
            lambda: ragged_paged_mla_attention_ref(q_abs, q_rope, c, kr, pt, pos,
                                                   scale=scale, c_scales=cs,
                                                   kr_scales=krs),
            pos, bound,
        )
    c = torch.randn(N + 1, ps, r, generator=gen, device="cuda").to(dtype)
    kr = torch.randn(N + 1, ps, dr, generator=gen, device="cuda").to(dtype)
    bound = paged_bound(pt, pos, ps, ps * (r + dr) * elt, io, ops, dtype)
    return (
        lambda: paged_mla_attention_cuda(q_abs, q_rope, c, kr, pt, pos, scale=scale),
        lambda: ragged_paged_mla_attention_ref(q_abs, q_rope, c, kr, pt, pos,
                                               scale=scale),
        pos, bound,
    )


def paged_kernels_phase(flush) -> dict:
    """K5, K6 and K7 against their plain versions in bf16 and fp32 at the
    serve step's shapes, timed (median of 10 launches, each after an L2
    flush) beside their bound; returns the bf16 entries for the kernels
    line."""
    cases = {
        "K5": lambda dtype: k5_case(dtype),
        "K6": lambda dtype: k67_case(dtype, quant=False),
        "K7": lambda dtype: k67_case(dtype, quant=True),
    }
    out = {}
    for name, make in cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            kernel, plain, pos, bound = make(dtype)
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            err = (got.float() - want.float()).abs().max().item()
            ref_max = want.float().abs().max().item()
            pad_zero = bool((got[pos < 0] == 0).all().item())
            tol = PAGED_TOL[dtype]
            bound_ms, bound_by, nbytes, ops = bound
            entry = {
                "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
                "ref_max": ref_max, "tol": tol, "pad_rows_zero": pad_zero,
                "ms": time_ms(kernel, 10, flush),
                "plain_ms": time_ms(plain, 5, flush),
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                "operations": ops,
            }
            emit({"phase": "kernel", "kernel": name, **entry})
            if not (err <= tol * max(1.0, ref_max) and pad_zero):
                raise AssertionError(f"{name} disagrees with its plain version: {entry}")
            if dtype == torch.bfloat16:
                out[name] = entry
            del got, want
        torch.cuda.empty_cache()
    return out


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


def fa_check_case(dtype, S, packed, flush, timed: bool, D=FA_SHAPE["D"]) -> dict:
    """K1-K3 against their plain versions on one input; with `timed`, also
    their times, the plain versions' and scaled_dot_product_attention's."""
    sh = dict(FA_SHAPE, S=S, D=D)
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
                f"S={S}, D={D}, packed={packed}): {err} > {tol} x {max(1.0, ref_max)}")
    entry = {"phase": "flash", "dtype": str(dtype).removeprefix("torch."),
             "route": fa_cuda.route(dtype), "shape": sh, "packed_segments": packed,
             "tol": tol, "errors": errs}
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
            "bound_share": bound_ms / times[name],
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
    fa_check_case(torch.bfloat16, FA_SHAPE["S"], False, flush, timed=False, D=64)
    torch.cuda.empty_cache()
    errs = main["errors"]
    return {
        "K1": dict(main["times"]["K1"], max_abs_err=max(
            errs["out"]["max_abs_err"], errs["lse"]["max_abs_err"])),
        "K2": dict(main["times"]["K2"], max_abs_err=errs["dq"]["max_abs_err"]),
        "K3": dict(main["times"]["K3"], max_abs_err=max(
            errs["dk"]["max_abs_err"], errs["dv"]["max_abs_err"])),
    }


def serve_traffic(vocab_size: int, seed: int = 0) -> list:
    """16 requests of 64-900 prompt tokens arriving every 2 steps, 32 greedy
    tokens each."""
    rng = np.random.default_rng(seed)
    return [
        Request(
            prompt=[int(t) for t in rng.integers(1, vocab_size, (int(n),))],
            max_new_tokens=32, arrival=2 * i,
        )
        for i, n in enumerate(rng.integers(64, 901, 16))
    ]


def serve_run(engine, cfg, card: str, phase: str, model: str, kernel: str,
              setup_s: float) -> tuple[int, dict]:
    """One main-path run: `serve_batch` on `serve_traffic`, with every
    kernel's launch count set to 0 just before and read just after. Every
    layer of every step must have launched `kernel` and no other paged
    kernel. Returns (launches of `kernel`, the serve result)."""
    reqs = serve_traffic(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    for fn in PAGED_KERNELS.values():
        fn.launches = 0
    res = engine.serve_batch(reqs)
    launches = {name: fn.launches for name, fn in PAGED_KERNELS.items()}
    stats = res["stats"]
    emit({
        "phase": phase, "card": card, "model": model, "setup_s": setup_s,
        "kv_cache_dtype": engine.serve_cfg.kv_cache_dtype, "stats": stats,
        "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    if len(res["outputs"]) != 16 or any(len(o) != 32 for o in res["outputs"]):
        raise AssertionError(f"{phase}: not every request finished with 32 tokens")
    if any(not 0 <= t < cfg.vocab_size for o in res["outputs"] for t in o):
        raise AssertionError(f"{phase}: a generated token is outside the vocabulary")
    want = {name: 0 for name in PAGED_KERNELS}
    want[kernel] = cfg.num_layers * stats["steps"]
    if launches != want:
        raise AssertionError(
            f"{phase}: paged kernels launched {launches} in {stats['steps']} "
            f"steps of {cfg.num_layers} layers; expected {want}")
    return launches[kernel], res


def serve_phase(card: str) -> dict:
    """The dense main path at Llama-3-8B width and depth, on the fp pool
    (K4) and then on the int8 pool (K5) with the same weights; returns the
    launches of K4 and K5."""
    cfg = llama_config(LLAMA3_8B, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = decoder.init(cfg, gen, dtype=torch.bfloat16)
    engine = ServingEngine(params, cfg, SERVE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = "Llama-3-8B widths, 32 layers, bf16"
    k4, fp = serve_run(engine, cfg, card, "serve", model, "K4", setup_s)
    profile_steps(engine, cfg, card, "serve", ("gqa_kernel",))
    del engine
    torch.cuda.empty_cache()

    engine = ServingEngine(params, cfg, dataclasses.replace(SERVE, kv_cache_dtype="int8"))
    k5, q8 = serve_run(engine, cfg, card, "serve_int8", model, "K5", 0.0)
    # greedy agreement with the fp pool, position by position (as the JAX
    # package's test_quant_vs_fp_greedy_agreement_confident_model counts
    # it); reported, not asserted: random weights have small top-1 margins
    pairs = [(a, b) for o1, o2 in zip(fp["outputs"], q8["outputs"])
             for a, b in zip(o1, o2)]
    first = [next((i for i, (a, b) in enumerate(zip(o1, o2)) if a != b), len(o1))
             for o1, o2 in zip(fp["outputs"], q8["outputs"])]
    emit({"phase": "serve_int8_agreement", "card": card,
          "greedy_agreement": sum(a == b for a, b in pairs) / len(pairs),
          "tokens": len(pairs), "first_divergence_per_request": first})
    # bf16 queries: K5 is the split kernel and its combine
    profile_steps(engine, cfg, card, "serve_int8",
                  rpa_cuda.KERNELS[rpa_cuda.route(torch.bfloat16)])
    del engine, params
    torch.cuda.empty_cache()
    return {"K4": k4, "K5": k5}


def serve_mla_phase(card: str) -> dict:
    """The MLA + MoE main path: Moonlight-16B-A3B at full width and all 27
    layers, bf16, random weights from seed 0, on the fp pool (K6) and then
    on the int8 pool (K7); returns the launches of K6 and K7."""
    cfg = deepseek_v3_moe_config(MOONLIGHT, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = moe_decoder.init(cfg, gen, dtype=torch.bfloat16)
    n_params = count_params(params)
    engine = ServingEngine(params, cfg, SERVE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = (f"Moonlight-16B-A3B, {cfg.num_layers} layers ({cfg.first_k_dense} "
             f"dense + {cfg.num_moe_layers} MoE), bf16, {n_params} params")
    launches = {}
    launches["K6"], _ = serve_run(engine, cfg, card, "serve_mla", model, "K6", setup_s)
    # bf16 queries: K6 is the split kernel and its combine over bf16 pages
    profile_steps(engine, cfg, card, "serve_mla",
                  mla_cuda.KERNELS[mla_cuda.route(torch.bfloat16)])
    del engine
    torch.cuda.empty_cache()
    engine = ServingEngine(params, cfg, dataclasses.replace(SERVE, kv_cache_dtype="int8"))
    launches["K7"], _ = serve_run(engine, cfg, card, "serve_mla_int8", model, "K7", 0.0)
    # bf16 queries: K7 is the split kernel and its combine
    profile_steps(engine, cfg, card, "serve_mla_int8",
                  mla_cuda.KERNELS[mla_cuda.route(torch.bfloat16)])
    del engine, params
    torch.cuda.empty_cache()
    return launches


def profile_steps(engine, cfg, card: str, phase: str,
                  kernel_keys: tuple[str, ...]) -> None:
    """Where a serve step's time goes: the same traffic again, 40 steps to
    reach a mix of prefill and decode, then 10 steps under torch.profiler.
    Prints device busy time per step by kernel and the device's idle share
    of the window's wall time. `kernel_keys` name the attention kernel's
    device kernels (one template each: `name<`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sched = engine.make_scheduler()
    for r in serve_traffic(cfg.vocab_size, seed=1):
        sched.submit(r)
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
    attn_launches = {k: 0 for k in kernel_keys}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            for k in kernel_keys:
                attn_launches[k] += (k + "<") in e.name
    busy_ms = sum(by_name.values())
    attn_ms = sum(v for k, v in by_name.items()
                  if any(key + "<" in k for key in kernel_keys))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({
        "phase": "profile", "of": phase, "card": card, "steps": n_steps,
        "rows_per_step": rows / n_steps,
        "wall_ms_per_step": wall_ms / n_steps,
        "unprofiled_wall_ms_per_step": plain_wall_ms / n_steps,
        "device_busy_ms_per_step": busy_ms / n_steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_idle_share_vs_unprofiled": 1.0 - busy_ms / plain_wall_ms,
        "attn_kernels": list(kernel_keys),
        "attn_kernel_launches_per_step": {k: v / n_steps for k, v in attn_launches.items()},
        "attn_kernel_ms_per_step": attn_ms / n_steps,
        "attn_kernel_share_of_busy": attn_ms / busy_ms if busy_ms else None,
        "top_kernels_ms_per_step": [[k[:80], v / n_steps] for k, v in top],
    })


def submit_engine_requests(sched, cfg) -> None:
    rng = np.random.default_rng(1)
    for n in (100, 60, 30):
        sched.submit(Request(
            prompt=[int(t) for t in rng.integers(1, cfg.vocab_size, (n,))],
            max_new_tokens=4,
        ))


def engine_check(phase: str, cfg, params, sc, tol: float) -> None:
    """Identical step plans through an engine on the kernels and one on the
    plain versions (same weights, fp32): every step's logits within `tol`,
    greedy tokens equal."""
    e_cuda = ServingEngine(params, cfg, sc, attn_impl="cuda")
    e_torch = ServingEngine(params, cfg, sc, attn_impl="torch")
    sched = e_cuda.make_scheduler()
    submit_engine_requests(sched, cfg)
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
            raise AssertionError(f"{phase}: greedy tokens differ at step {steps}")
        sched.update(plan, tokens.to(torch.int32).cpu().numpy(), steps)
        steps += 1
    emit({"phase": phase, "layers": cfg.num_layers, "dtype": "float32",
          "kv_cache_dtype": sc.kv_cache_dtype, "steps": steps,
          "max_abs_logit_err": worst, "tol": tol})
    if worst > tol:
        raise AssertionError(f"{phase}: engine logits differ between kernels and plain")


# the engine's dispatcher of each kernel that engine_bf16_check holds
PAGED_DISPATCH = {"K5": "ragged_paged_attention",
                  "K6": "ragged_paged_mla_attention",
                  "K7": "ragged_paged_mla_attention"}


@contextlib.contextmanager
def held_to_plain(kernel: str, errors: list):
    """Within the block, every call an engine makes to `kernel`'s dispatcher
    also runs the plain version on the same inputs, and the kernel's error
    (a share of the plain result's largest magnitude, at least 1) is
    appended to `errors`. The engine module's reference to the dispatcher
    is wrapped; the kernel's wrapper, and its launch count, stay as they
    are."""
    name = PAGED_DISPATCH[kernel]
    dispatch = getattr(serving_engine, name)

    def checked(*args, **kw):
        got = dispatch(*args, **kw)
        want = dispatch(*args, **dict(kw, impl="torch")).float()
        errors.append(((got.float() - want).abs().max()
                       / want.abs().max().clamp(min=1.0)).item())
        return got

    setattr(serving_engine, name, checked)
    try:
        yield
    finally:
        setattr(serving_engine, name, dispatch)


def engine_bf16_check(phase: str, cfg, params, sc, tol: float,
                      kernel: str) -> None:
    """A bf16 engine on the kernels and one on the plain versions, on
    identical step plans, each held to the same model in fp32 (the bf16
    weights upcast exactly, plain attention): the kernels' logits may stray
    from the fp32 logits by at most the plain version's own bf16 error plus
    `tol`, both as shares of the step's largest fp32 logit magnitude (at
    least 1). The two bf16 engines round attention at other places and bf16
    carries the difference through the layers, the MoE routing and the
    int8 quantization of new rows, so they are compared through the fp32
    model, not with each other; their difference and the greedy agreements
    are reported. Every call of the kernels' engine to `kernel` is also held
    to its plain version on the same inputs, within `PAGED_TOL`."""
    engines = {
        "cuda": ServingEngine(params, cfg, sc, attn_impl="cuda"),
        "torch": ServingEngine(params, cfg, sc, attn_impl="torch"),
        "fp32": ServingEngine(tree_map(lambda t: t.float(), params),
                              dataclasses.replace(cfg, dtype=torch.float32), sc,
                              attn_impl="torch"),
    }
    sched = engines["cuda"].make_scheduler()
    submit_engine_requests(sched, cfg)
    err = {"cuda_vs_fp32": 0.0, "plain_vs_fp32": 0.0, "cuda_vs_plain": 0.0}
    agree = {"cuda_vs_fp32": 0, "plain_vs_fp32": 0, "cuda_vs_plain": 0}
    steps, rows, errors = 0, 0, []
    wrapper = PAGED_KERNELS[kernel]
    n0 = wrapper.launches
    while sched.has_work:
        plan = sched.schedule(steps)
        with held_to_plain(kernel, errors):
            lg = {"cuda": engines["cuda"].step_logits(plan).float()}
        lg.update({k: engines[k].step_logits(plan).float() for k in ("torch", "fp32")})
        den = max(1.0, lg["fp32"].abs().max().item())
        top = {k: v.argmax(-1) for k, v in lg.items()}
        # greedy agreement over the slots that sample this step (an idle
        # slot's row is a copy of row 0)
        live = torch.as_tensor(plan.sample_tok >= 0, device=top["cuda"].device)
        for key, a, b in (("cuda_vs_fp32", "cuda", "fp32"),
                          ("plain_vs_fp32", "torch", "fp32"),
                          ("cuda_vs_plain", "cuda", "torch")):
            err[key] = max(err[key], (lg[a] - lg[b]).abs().max().item() / den)
            agree[key] += int(((top[a] == top[b]) & live).sum().item())
        rows += int(live.sum().item())
        sched.update(plan, top["cuda"].to(torch.int32).cpu().numpy(), steps)
        steps += 1
    emit({"phase": phase, "layers": cfg.num_layers, "dtype": "bfloat16",
          "kv_cache_dtype": sc.kv_cache_dtype, "steps": steps,
          "max_rel_logit_err": err, "tol": tol,
          "greedy_agreement": {k: v / rows for k, v in agree.items()},
          "kernel": kernel, "kernel_calls": len(errors),
          "kernel_launches": wrapper.launches - n0,
          "kernel_max_rel_err": max(errors),
          "kernel_tol": PAGED_TOL[torch.bfloat16]})
    if wrapper.launches - n0 != len(errors) or not errors:
        raise AssertionError(
            f"{phase}: the engine's {kernel} calls did not all launch {kernel}")
    if max(errors) > PAGED_TOL[torch.bfloat16]:
        raise AssertionError(f"{phase}: {kernel} calls disagree with the plain version")
    if err["cuda_vs_fp32"] > err["plain_vs_fp32"] + tol:
        raise AssertionError(
            f"{phase}: the kernels stray from the fp32 model more than the "
            f"plain version does: {err}")


def engine_phase() -> None:
    """2-layer fp32 engine at Llama-3-8B width: K4 against the plain
    version through the engine; then the same engine in bf16 on the int8
    pool, which takes K5's tensor-core route."""
    cfg = dataclasses.replace(
        llama_config(LLAMA3_8B), num_layers=2, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = decoder.init(cfg, gen)
    sc = dataclasses.replace(SERVE, num_pages=256)
    engine_check("engine", cfg, params, sc, ENGINE_LOGITS_TOL)
    params16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    engine_bf16_check("engine_int8_bf16", dataclasses.replace(cfg, dtype=torch.bfloat16),
                      params16, dataclasses.replace(sc, kv_cache_dtype="int8"),
                      ENGINE_BF16_LOGITS_TOL, "K5")
    del params16
    torch.cuda.empty_cache()


def engine_mla_phase() -> None:
    """A 2-layer Moonlight-width engine (one dense, one MoE layer) in fp32:
    K6 on the fp pool and K7 (CUDA-core routes) on the int8 pool against the
    plain versions; then the same engine in bf16 on the fp pool and on the
    int8 pool, which take K6's and K7's tensor-core routes."""
    cfg = dataclasses.replace(deepseek_v3_moe_config(MOONLIGHT), num_layers=2,
                              dtype=torch.float32)
    params = moe_decoder.init(cfg, torch.Generator(device="cuda").manual_seed(1))
    sc = dataclasses.replace(SERVE, num_pages=256)
    int8 = dataclasses.replace(sc, kv_cache_dtype="int8")
    engine_check("engine_mla", cfg, params, sc, ENGINE_LOGITS_TOL)
    engine_check("engine_mla_int8", cfg, params, int8, ENGINE_INT8_LOGITS_TOL)
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    engine_bf16_check("engine_mla_bf16", cfg16, params16, sc,
                      ENGINE_BF16_LOGITS_TOL, "K6")
    engine_bf16_check("engine_mla_int8_bf16", cfg16, params16, int8,
                      ENGINE_BF16_LOGITS_TOL, "K7")
    del params16
    torch.cuda.empty_cache()


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
    fa_names = {n + "<" for names in fa_cuda.KERNELS.values() for n in names}
    fa_ms = sum(v for k, v in by_name.items() if any(f in k for f in fa_names))
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


# the tensor-core kernels in ptxas's mangled names: (pattern, readable name)
MMA_KERNELS = (
    (r"((?:fwd|dkv|dq)_mma_kernel)ILi(\d+)E", lambda m: f"{m[1]}<{m[2]}>"),
    (r"((?:mla|gqa)_split_kernel)I(a|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
     lambda m: f"{m[1]}<{'int8' if m[2] == 'a' else 'bf16'}, {m[3]}, {m[4]}>"),
    (r"((?:mla|gqa)_combine_kernel)I13__nv_bfloat16E", lambda m: f"{m[1]}<bf16>"),
)


def mma_ptxas(log: str) -> dict:
    """ptxas's report on the bf16 tensor-core instantiations (K1-K3 at each
    head dim; the split kernels of K5, K6 and K7 at each step and column
    count, their combines): registers, spill bytes and, for K1-K3 and the
    split kernels at Llama-3-8B's (K5) and Moonlight's (K6, K7) widths,
    dynamic shared memory (the launch size)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            name = None
            for pattern, readable in MMA_KERNELS:
                m = re.search(pattern, line)
                if m:
                    name = readable(m)
            continue
        if name is None:
            continue
        entry = out.setdefault(name, {})
        if "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            entry["spill_store_bytes"], entry["spill_load_bytes"] = int(st), int(ld)
        elif "Used" in line and "registers" in line:
            entry["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            name = None
    which = {"fwd": 0, "dkv": 1, "dq": 2}
    for key, entry in out.items():
        if key.startswith("mla_split"):
            n, r, dr = MOONLIGHT_MLA
            page = torch.int8 if "int8" in key else torch.bfloat16
            entry["dynamic_smem_bytes_moonlight"] = mla_cuda.split_smem_bytes(
                n, r, dr, SERVE.page_size, SERVE.pages_per_slot, page)
        elif key.startswith("gqa_split"):
            entry["dynamic_smem_bytes_llama3_8b"] = rpa_cuda.split_smem_bytes(
                32, 8, 128, 128, SERVE.page_size, SERVE.pages_per_slot)
        elif "_mma_" in key:
            entry["dynamic_smem_bytes"] = fa_cuda.mma_smem_bytes(
                which[key.split("_")[0]], int(key[:-1].split("<")[1]))
    return out


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
    libs = _build.build(K4_SOURCE, fa_cuda.SOURCE, MLA_SOURCE)
    logs = {lib.stem: lib.with_suffix(".log").read_text() for lib in libs}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {stem: [l.strip() for l in log.splitlines()
                           if "registers" in l or "spill" in l]
                    for stem, log in logs.items()},
          "tensor_core_kernels": mma_ptxas(
              logs[_build.library_path(fa_cuda.SOURCE).stem]
              + logs[_build.library_path(MLA_SOURCE).stem]
              + logs[_build.library_path(K4_SOURCE).stem])})

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    k4 = kernel_phase(flush)
    paged = paged_kernels_phase(flush)
    flash = flash_phase(flush)
    del flush
    launches = serve_phase(card)
    launches.update(serve_mla_phase(card))
    engine_phase()
    engine_mla_phase()
    torch.cuda.empty_cache()
    train_launches = train_phase(card)
    train_check_phase()
    train_paths_phase()

    no_library = ("no single PyTorch call attends over per-row page tables; "
                  "scaled_dot_product_attention needs each row's KV gathered "
                  "dense (and dequantized) first")
    paged_rows = (
        ("K4", "ragged_paged_attention_gqa", "ragged_paged_attention.cu", ":42", k4),
        ("K5", "ragged_paged_attention_gqa_int8", "ragged_paged_attention.cu",
         ":170", paged["K5"]),
        ("K6", "paged_mla_attention", "paged_mla_attention.cu", ":315", paged["K6"]),
        ("K7", "paged_mla_attention_int8", "paged_mla_attention.cu", ":428",
         paged["K7"]),
    )
    kernels = []
    for name, kname, src, line, e in paged_rows:
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "automodel_tpu_torch/csrc/" + src,
            "replaces": "automodel_tpu/ops/pallas/ragged_paged_attention.py" + line,
            "launches": launches[name],
            "max_abs_err": e["max_abs_err"],
            "ms": e["ms"],
            "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"],
            "library_ms": None,
            "library_why": no_library,
            "card": card,
        })
        # K4 has one route; K5's, K6's and K7's follow the query dtype
        if name == "K5":
            kernels[-1]["kernel_route"] = rpa_cuda.route(torch.bfloat16)
        elif name in ("K6", "K7"):
            kernels[-1]["kernel_route"] = mla_cuda.route(torch.bfloat16)
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
            "kernel_route": fa_cuda.route(torch.bfloat16),
            "tflops": e["tflops"],
            "bound_share": e["bound_share"],
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
