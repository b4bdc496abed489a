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
   r 512, dr 64); bf16 K4-K7 are split-KV kernels on the tensor cores and
   their combines, fp32 K4-K7 the CUDA-core kernels;
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
   moe_sync: one Moonlight MoE block (gate, grouped expert products,
   shared experts, combine) in bf16 at full width under
   `torch.cuda.set_sync_debug_mode("error")`: it reads nothing to the host;
6. recipe_serve: the `llm_serve` recipe through the CLI entry
   (`automodel_tpu_torch.cli.app.main([yaml])`, the card by default) on
   an HF safetensors checkpoint of Llama-3-8B (full width, 32 layers,
   bf16, seed-0 weights) that the port's `save_hf_checkpoint` writes to a
   temporary directory first: 16 mock prompts of 512 tokens, the serve
   config above, 32 new tokens each. The weights the recipe holds must
   equal the written ones bit for bit, every request must finish with 32
   tokens, K4 must launch on every layer of every step, and the recipe's
   tokens must equal a `ServingEngine.serve_batch` on the same weights and
   requests in this process;
7. engine / engine_mla: 2-layer fp32 engines at Llama-3-8B width (K4) and
   at Moonlight width (one dense, one MoE layer; K6 on the fp pool, K7 on
   the int8 pool): the same step plans run through the engine with the
   kernels and with the plain versions, whose logits and greedy tokens
   must agree; then the same engines in bf16 on the tensor-core routes
   (Llama on the fp pool, K4, and on the int8 pool, K5; Moonlight on the
   fp pool, K6, and on the int8 pool, K7), on the kernels and on the plain
   versions, each held to the same model in fp32: the kernels' logits no
   farther from it than the plain version's plus the bf16 tolerance,
   every kernel call within `PAGED_TOL` of its plain version on the same
   inputs, greedy agreements reported;
8. train: the training CLI (`python -m automodel_tpu_torch`, run in this
   process) on `examples/llm_pretrain/llama3_8b_mock_bf16.yaml` at its
   published width, bf16 and full remat, cut to 8 layers, 2 microbatches
   of 4096 tokens per step, 5 steps: every loss and grad norm finite, the
   first loss near ln(vocab), K1 launched 2 x layers x microbatches x steps
   times (forward and remat recompute), K2 and K3 half that; then one more
   step under torch.profiler;
9. train check: the same width, 2 layers, fp32, one accumulated step from
   the same weights and batch with the kernels and with the plain
   attention: losses and gradients must agree;
10. train paths: `examples/llm_finetune/tiny_llama_mock_smoke.yaml` (fp32,
   head dim 16) for its 10 steps through the CLI with the kernels and
   through the recipe class called directly with the plain attention:
   the loss curves must agree.

The build line carries ptxas's registers and spills of every kernel, and of
the tensor-core K1-K7 kernels by name with their dynamic shared memory.
Then it prints the `{"kernels": [...]}` line and, last, the
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
import yaml

from automodel_tpu_torch.checkpoint import DenseDecoderAdapter, save_hf_checkpoint
from automodel_tpu_torch.cli.app import main as cli_main
from automodel_tpu_torch.config import parse_args_and_load_config
from automodel_tpu_torch.datasets.loader import make_global_batch, stack_microbatches
from automodel_tpu_torch.datasets.mock import MockDatasetConfig
from automodel_tpu_torch.loss import fused_linear_cross_entropy
from automodel_tpu_torch.loss.utils import combine_losses
from automodel_tpu_torch.models.common.layers import count_params
from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.models.llm.families import gemma2_config, llama_config
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.moe_lm.families import deepseek_v3_moe_config
from automodel_tpu_torch.moe.layer import init_moe, moe_forward
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
# the recipe_serve phase: 16 mock prompts of this many tokens, 32 new each
RECIPE_PROMPT_LEN = 512

# K4 tolerances against the plain version on the same inputs.
# fp32: both sum in fp32; only the order (online vs two-pass softmax, the
# kernel's warp reductions) differs, which moves outputs by ~1e-6.
# bf16: both round the probabilities to bf16 for the value product (the
# Pallas kernel's cast); the plain version rounds the value product to
# bf16, the kernel accumulates it in fp32 over splits and rounds once;
# 2e-2 is about two bf16 ulps at |out| ~ 1.
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
# product and their output once (K4 and K6 round p to bf16 as their plain
# versions do); 2e-2 is about two bf16 ulps at the largest value.
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
FA_SHAPE = dict(B=1, S=4096, Hq=32, Hkv=8, D=128, Dv=128)
# ... and of Moonlight-16B-A3B's MLA attention: q/k 192 (qk_nope 128 +
# qk_rope 64), v 128, 16 heads for q and kv alike
FA_MLA_SHAPE = dict(B=1, S=4096, Hq=16, Hkv=16, D=192, Dv=128)
# Gemma-2-2B's attention at its published 8192-token context (a sliding
# layer: window 4096, soft cap 50, query_pre_attn_scalar 256) and
# Gemma-3-1B's at 4096 tokens (MQA 4:1, window 512)
FA_GEMMA2_SHAPE = dict(B=1, S=8192, Hq=8, Hkv=4, D=256, Dv=256)
FA_GEMMA2_MASKS = dict(window=4096, soft_cap=50.0, scale=256 ** -0.5)
FA_GEMMA3_SHAPE = dict(B=1, S=4096, Hq=4, Hkv=1, D=256, Dv=256)
FA_GEMMA3_MASKS = dict(window=512, scale=256 ** -0.5)
# Mistral-7B's heads (32/8, D 128); its own window is 4096, here 1024 so that
# the window masks at 4096 tokens, where the plain versions' (B, H, S, T)
# fp32 intermediates still fit beside the kernels' inputs
FA_MISTRAL_MASKS = dict(window=1024)

# Gemma-2-2B (google/gemma-2-2b, config.json) and Gemma-3-1B
# (google/gemma-3-1b-pt, config.json), as the model-configs catalog gives
# them; both tie the head to the embedding
GEMMA2_2B = {
    "architectures": ["Gemma2ForCausalLM"], "vocab_size": 256000,
    "hidden_size": 2304, "intermediate_size": 9216, "num_hidden_layers": 26,
    "num_attention_heads": 8, "num_key_value_heads": 4, "head_dim": 256,
    "sliding_window": 4096, "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0, "query_pre_attn_scalar": 256,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "max_position_embeddings": 8192, "tie_word_embeddings": True,
}
GEMMA3_1B = {
    "architectures": ["Gemma3ForCausalLM"], "vocab_size": 262144,
    "hidden_size": 1152, "intermediate_size": 6912, "num_hidden_layers": 26,
    "num_attention_heads": 4, "num_key_value_heads": 1, "head_dim": 256,
    "sliding_window": 512, "sliding_window_pattern": 6,
    "rope_theta": 1000000.0, "rope_local_base_freq": 10000.0,
    "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 32768, "tie_word_embeddings": True,
}

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
# train_moe: Moonlight-16B-A3B at full width through the training CLI, on a
# YAML the phase writes. Cut: 27 -> 4 layers (1 dense + 3 MoE), ~2.5 B
# parameters whose fp32 masters, gradients and AdamW moments take ~40 GB;
# all 27 layers (~16 B parameters, ~256 GB of that state) do not fit one
# 80 GB card. Sequences of 4096 tokens, microbatch 1, 5 steps. The mock
# tokens are drawn from the first MOE_TRAIN_TOKEN_IDS ids, as a finetuning
# corpus uses a small share of a 163840-token vocabulary: uniform tokens
# over the whole vocabulary leave nothing to learn in 5 steps (the loss
# then stays at ln(V) plus the init's excess).
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_TRAIN_SEQ = 4, 5, 4096
MOE_TRAIN_TOKEN_IDS = 4096
# train_moe_check: 2 layers (1 dense + 1 MoE) at Moonlight width in fp32,
# one step of 2 microbatches of this many tokens, kernels vs plain
# attention; the tolerances of the dense check
MOE_CHECK_SEQ = 2048
# the <192, 128> instantiations of K1-K3 in the profiler's kernel names
MLA_FA_KERNELS = {"K1": r"fwd_mma_kernel<192,\s*128,", "K2": r"dq_mma_kernel<192,\s*128,",
                  "K3": r"dkv_mma_kernel<192,\s*128,"}
# ... and the <256, 256> ones (Gemma-2, Gemma-3), with and without the
# position code (windowed and global layers)
GEMMA_FA_KERNELS = {"K1": r"fwd_mma_kernel<256,\s*256,", "K2": r"dq_mma_kernel<256,\s*256,",
                    "K3": r"dkv_mma_kernel<256,\s*256,"}
# train_gemma2 / train_gemma3: the training CLI at full width and full depth
# on a YAML the phase writes (nothing cut), bf16 over fp32 masters, full
# remat, AdamW, mock tokens over the first GEMMA_TRAIN_TOKEN_IDS ids (as
# train_moe draws them), microbatch 1, this many steps at these lengths
GEMMA_TRAIN_STEPS = 5
GEMMA_TRAIN_TOKEN_IDS = 4096
GEMMA2_TRAIN_SEQ, GEMMA3_TRAIN_SEQ = 8192, 4096
# train_gemma2_plain: step 1 of train_gemma2 with the plain attention, from
# the same weights and batch, against the kernels' in bf16: the loss to 1e-2
# relative, the grad norm to 5e-2 (bf16 rounds attention's probabilities and
# outputs at other places in the two paths, through 26 layers)
GEMMA_PLAIN_LOSS_RTOL, GEMMA_PLAIN_GNORM_RTOL = 1e-2, 5e-2
# train_gemma_check: Gemma-2-2B widths, 2 layers (one sliding, one global),
# fp32, 2 microbatches of this many tokens, a window that masks
GEMMA_CHECK_SEQ, GEMMA_CHECK_WINDOW = 2048, 512


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
    """K4 against its plain version on both routes, bf16 (split-KV on the
    tensor cores) and fp32 (CUDA cores), with and without the soft cap, pad
    rows 0; returns the bf16 (main-path dtype) entry for the kernels
    line."""
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
            "dtype": str(dtype).removeprefix("torch."),
            "route": rpa_cuda.route(dtype), "max_abs_err": err,
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


def fa_inputs(dtype, B, S, T, Hq, Hkv, D, Dv, packed: bool, seed: int = 0):
    """Random q (B, S), k (head dim D), v, dO (Dv) and k, v (B, T) on the
    card, and packed segment ids (four documents) or None."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v = randn(B, S, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, Dv)
    dout = randn(B, S, Hq, Dv)
    seg = None
    if packed:
        cuts = torch.tensor([S // 5, S // 2, S // 2 + 7], device="cuda")
        seg = ((torch.arange(S, device="cuda")[:, None] >= cuts).sum(-1)
               .to(torch.int32)[None].expand(B, S).contiguous())
    return q, k, v, dout, seg


def fa_masks(B, S, T, seg, masks: dict):
    """A case's masks: the kernel wrappers' mask keywords and the plain
    versions' (B, S, T) mask. Causal by index unless `masks` says
    "causal": False (a window is then two-sided) or "ring": the q rows at
    positions S/4.., the kv rows at S/2.. with the first 64 in a document of
    their own, causal by position (the first S/4 q rows see no key). Packed
    documents restart their positions; a "window" is on positions."""
    return fa.mask_case(B, S, T, device="cuda", causal=masks.get("causal", True),
                        segment_ids=seg, sliding_window=masks.get("window"),
                        ring=(S // 4, S // 2, 64) if masks.get("ring") else None)


def fa_bound(kernel: str, q, k, v, pairs: int):
    """Least time of one K1/K2/K3 call: the larger of its bytes over HBM
    bandwidth (each input read once, each output written once) and its
    operations over the dtype's peak. Each product counts at its own width:
    per unmasked (q, k) pair and query head, Q.K^T, dS.K (dq) and dS^T.Q
    (dk) take 2 DQK flops, P.V, dO.V^T and P^T.dO (dv) 2 DV. So K1 does
    2 DQK + 2 DV, K2 4 DQK + 2 DV, K3 4 DQK + 4 DV (4, 6 and 8 D at
    DQK = DV = D)."""
    B, S, Hq, D = q.shape
    Dv = v.shape[-1]
    elt = q.element_size()
    q_bytes = q.numel() * elt               # q and dq
    o_bytes = q_bytes // D * Dv             # out and dO
    k_bytes, v_bytes = k.numel() * elt, v.numel() * elt  # k, dk; v, dv
    row_bytes = B * Hq * S * 4              # lse and delta, fp32
    nbytes, flops_per_pair = {
        "K1": (q_bytes + k_bytes + v_bytes + o_bytes + row_bytes,
               2 * D + 2 * Dv),
        "K2": (2 * q_bytes + k_bytes + v_bytes + o_bytes + 2 * row_bytes,
               4 * D + 2 * Dv),
        "K3": (q_bytes + o_bytes + 2 * k_bytes + 2 * v_bytes + 2 * row_bytes,
               4 * D + 4 * Dv),
    }[kernel]
    ops = flops_per_pair * pairs * Hq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def fa_check_case(dtype, S, packed, flush, timed: bool, shape=None,
                  masks: dict | None = None, **dims) -> dict:
    """K1-K3 against their plain versions on one input of `shape` (the
    Llama-3-8B training shape unless given; `dims` override its keys) under
    `masks` (`fa_masks`'s, plus "soft_cap" and "scale"; "ring" makes
    T = 3 S / 2); with `timed`, also their times, the plain versions' and
    scaled_dot_product_attention's."""
    masks = dict(masks or {})
    sh = dict(shape or FA_SHAPE, S=S, **dims)
    B, Hq, D = sh["B"], sh["Hq"], sh["D"]
    T = S + S // 2 if masks.get("ring") else S
    q, k, v, dout, seg = fa_inputs(dtype, B, S, T, Hq, sh["Hkv"], D, sh["Dv"], packed)
    scale = masks.pop("scale", D ** -0.5)
    cap = masks.pop("soft_cap", None)
    if cap is not None:
        # the unit-variance logits (at scale D^-0.5) spread over a quarter of
        # the cap, so the largest reach it and the cap bends them: a kernel
        # that dropped the cap or its gradient fails the check by far
        q = (q.float() * (cap / 4)).to(dtype)
    mkw, mask = fa_masks(B, S, T, seg, masks)
    if masks.get("window"):  # the window masks pairs the causal mask keeps
        assert masks["window"] < S
    kw = dict(scale=scale, soft_cap=cap, **mkw)
    out, lse = fa_cuda.flash_fwd_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    out_ref, lse_ref = fa.flash_attention_ref(q, k, v, mask, scale=scale, soft_cap=cap)
    delta = (dout.float() * out_ref.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa_cuda.flash_dq_cuda(q, k, v, dout, lse_ref, delta, **kw)
    dk, dv = fa_cuda.flash_dkv_cuda(q, k, v, dout, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    grads_ref = fa.flash_attention_bwd_ref(q, k, v, dout, lse_ref, delta, mask,
                                           scale=scale, soft_cap=cap)
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
                f"S={S}, T={T}, D={D}, Dv={sh['Dv']}, packed={packed}, "
                f"masks={masks}, soft_cap={cap}): {err} > {tol} x {max(1.0, ref_max)}")
    pairs = int(mask.sum().item())  # unmasked (q, k) pairs per head
    entry = {"phase": "flash", "dtype": str(dtype).removeprefix("torch."),
             "route": fa_cuda.route(dtype), "shape": dict(sh, T=T),
             "packed_segments": packed, "masks": masks, "soft_cap": cap,
             "q_scaled_by": None if cap is None else cap / 4,
             "scale": scale, "unmasked_pairs_per_head": pairs,
             "causal_pairs_per_head": S * (S + 1) // 2, "tol": tol, "errors": errs}
    if timed:
        del grads_ref, out_ref
        # the yardstick: the causal call for the unmasked cases, an explicit
        # boolean mask for the others (windows, segments, positions)
        plain_causal = not masks and seg is None
        entry["times"] = fa_times(q, k, v, dout, lse, delta, kw, mask, pairs,
                                  flush, None if plain_causal else mask)
        if cap is not None:
            for name in ("K1", "K2", "K3"):
                entry["times"][name]["library_same_function"] = False
                entry["times"][name]["library_why"] = (
                    "no single PyTorch call caps the logits (tanh soft cap) "
                    "inside attention: the yardstick is the same call uncapped")
    emit(entry)
    return entry


# substrings of the device kernels' names -> scaled_dot_product_attention's
# backend, in the order they are tried (cuDNN's names also say "flash")
SDPA_BACKENDS = (("cudnn", "cuDNN"), ("fmha", "memory-efficient (CUTLASS fmha)"),
                 ("efficient", "memory-efficient (CUTLASS fmha)"),
                 ("flash", "FlashAttention"))


def sdpa_backend(fn) -> dict:
    """The device kernels one call of `fn` launches and the
    scaled_dot_product_attention backend they name (from the kernel
    names: FlashAttention, CUTLASS's memory-efficient fmha, cuDNN; "math"
    when none of theirs ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
    backend = "math"
    for key, label in SDPA_BACKENDS:
        if any(key in n.lower() for n in names):
            backend = label
            break
    return {"backend": backend, "kernels": [n[:90] for n in names][:6]}


def fa_times(q, k, v, dout, lse, delta, kw, mask, pairs, flush, sdpa_mask) -> dict:
    """K1-K3's times with the wrapper keywords `kw`, the plain versions' on
    `mask`, and scaled_dot_product_attention's: causal when `sdpa_mask` is
    None, else with that (B, S, T) boolean mask (never soft-capped)."""
    scale, cap = kw["scale"], kw["soft_cap"]
    times = {
        "K1": time_ms(lambda: fa_cuda.flash_fwd_cuda(q, k, v, **kw), 10, flush),
        "K2": time_ms(lambda: fa_cuda.flash_dq_cuda(
            q, k, v, dout, lse, delta, **kw), 10, flush),
        "K3": time_ms(lambda: fa_cuda.flash_dkv_cuda(
            q, k, v, dout, lse, delta, **kw), 10, flush),
    }
    plain_fwd = time_ms(lambda: fa.flash_attention_ref(
        q, k, v, mask, scale=scale, soft_cap=cap), 3, flush)
    plain_bwd = time_ms(lambda: fa.flash_attention_bwd_ref(
        q, k, v, dout, lse, delta, mask, scale=scale, soft_cap=cap), 3, flush)
    # the yardstick: PyTorch's fused attention on the same inputs, (B, H, S, D)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    if sdpa_mask is None:
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True, scale=scale)
    else:
        am = sdpa_mask[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=am, enable_gqa=True, scale=scale)
    sdpa_fwd = time_ms(sdpa, 10, flush)
    o = sdpa()
    dot = dout.transpose(1, 2)
    sdpa_grad = lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)
    sdpa_bwd = time_ms(sdpa_grad, 10, flush)
    backends = {"forward": sdpa_backend(sdpa), "backward": sdpa_backend(sdpa_grad)}
    mask_note = "is_causal" if sdpa_mask is None else "an explicit boolean mask"
    out = {}
    for name in ("K1", "K2", "K3"):
        bound_ms, bound_by, nbytes, ops = fa_bound(name, q, k, v, pairs)
        out[name] = {
            "ms": times[name], "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "operations": ops,
            "tflops": ops / times[name] / 1e9,
            "bound_share": bound_ms / times[name],
            # the plain backward computes dq, dk and dv in one call
            "plain_ms": plain_fwd if name == "K1" else plain_bwd,
            "library_ms": sdpa_fwd if name == "K1" else sdpa_bwd,
            "library_call": (
                f"scaled_dot_product_attention forward ({mask_note})" if name == "K1" else
                f"scaled_dot_product_attention backward ({mask_note}; dq, dk and dv in one call)"),
            "library_backend": backends["forward" if name == "K1" else "backward"]["backend"],
        }
    out["sdpa_fwd_bwd_ms"] = sdpa_fwd + sdpa_bwd
    out["sdpa_backends"] = backends
    return out


def fa_entries(case: dict) -> dict:
    """A timed case's K1, K2 and K3 numbers for the kernels line."""
    errs = case["errors"]
    return {
        "K1": dict(case["times"]["K1"], max_abs_err=max(
            errs["out"]["max_abs_err"], errs["lse"]["max_abs_err"])),
        "K2": dict(case["times"]["K2"], max_abs_err=errs["dq"]["max_abs_err"]),
        "K3": dict(case["times"]["K3"], max_abs_err=max(
            errs["dk"]["max_abs_err"], errs["dv"]["max_abs_err"])),
    }


def flash_phase(flush) -> dict:
    """K1-K3 against their plain versions: the Llama-3-8B training shapes
    in bf16 (timed) and fp32, a packed-segment case, a ragged S and head
    dim 64; Moonlight's MLA heads (q/k 192, v 128) in bf16 (timed), packed
    and ragged, and in fp32; then the sliding-window masks, each timed in
    bf16: Gemma-2-2B's heads at 8192 tokens (window 4096, soft cap 50),
    Gemma-3-1B's at 4096 (MQA, window 512), Gemma-2's heads over packed
    documents with a window, a two-sided window, causal masking by
    position with T != S (ring-attention shaped), Mistral's heads with a
    window; and Gemma-2's heads in fp32 at train_gemma_check's length.
    Returns the timed bf16 entries for the kernels line, keyed "dense",
    "mla", "gemma2", "gemma3" and the other windowed cases' names."""
    S = FA_SHAPE["S"]
    main = fa_check_case(torch.bfloat16, S, False, flush, timed=True)
    fa_check_case(torch.float32, S, False, flush, timed=False)
    fa_check_case(torch.bfloat16, S, True, flush, timed=False)
    fa_check_case(torch.bfloat16, S - 96 - 5, False, flush, timed=False)
    fa_check_case(torch.bfloat16, S, False, flush, timed=False, D=64, Dv=64)
    mla = fa_check_case(torch.bfloat16, S, False, flush, timed=True, shape=FA_MLA_SHAPE)
    fa_check_case(torch.bfloat16, S, True, flush, timed=False, shape=FA_MLA_SHAPE)
    fa_check_case(torch.bfloat16, S - 96 - 5, False, flush, timed=False,
                  shape=FA_MLA_SHAPE, Hq=4, Hkv=2)
    fa_check_case(torch.float32, S, False, flush, timed=False, shape=FA_MLA_SHAPE)
    torch.cuda.empty_cache()
    out = {"dense": fa_entries(main), "mla": fa_entries(mla)}
    g2, g3 = FA_GEMMA2_SHAPE, FA_GEMMA3_SHAPE
    windowed = {
        "gemma2": (g2["S"], False, g2, FA_GEMMA2_MASKS),
        "gemma3": (g3["S"], False, g3, FA_GEMMA3_MASKS),
        "gemma2_packed_window": (4096, True, g2, dict(FA_GEMMA2_MASKS, window=1024)),
        "two_sided_window": (4096, False, g2, dict(window=512, causal=False,
                                                   scale=256 ** -0.5)),
        "position_causal_ring": (4096, False, g2, dict(ring=True, scale=256 ** -0.5)),
        "mistral_window": (4096, False, FA_SHAPE, FA_MISTRAL_MASKS),
    }
    for name, (s_len, packed, shape, masks) in windowed.items():
        out[name] = fa_entries(fa_check_case(torch.bfloat16, s_len, packed, flush,
                                             timed=True, shape=shape, masks=masks))
        torch.cuda.empty_cache()
    fa_check_case(torch.float32, GEMMA_CHECK_SEQ, False, flush, timed=False, shape=g2,
                  masks=dict(FA_GEMMA2_MASKS, window=GEMMA_CHECK_WINDOW))
    fa_check_case(torch.float32, 2048, False, flush, timed=False, shape=g2,
                  masks=dict(ring=True, window=700, scale=256 ** -0.5))
    torch.cuda.empty_cache()
    return out


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
    # bf16 queries: K4 is the split kernel and its combine over bf16 pages
    profile_steps(engine, cfg, card, "serve",
                  rpa_cuda.KERNELS["K4"][rpa_cuda.route(torch.bfloat16)])
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
                  rpa_cuda.KERNELS["K5"][rpa_cuda.route(torch.bfloat16)])
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


def moe_sync_phase(card: str) -> None:
    """One Moonlight MoE block in bf16 at full width (64 experts, top-6,
    H 2048, I 1408, 2 shared experts) on one serve step's 64 rows, one in 8
    masked: the forward runs under set_sync_debug_mode("error"), which
    raises at any device-to-host read."""
    cfg = deepseek_v3_moe_config(MOONLIGHT, dtype=torch.bfloat16).moe
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_moe(cfg, MOONLIGHT["hidden_size"], gen, torch.bfloat16)
    params["gate"]["e_score_bias"].normal_(0, 0.1, generator=gen)
    x = torch.randn(1, 64, MOONLIGHT["hidden_size"], device="cuda",
                    generator=gen).to(torch.bfloat16)
    mask = (torch.arange(64, device="cuda") % 8 != 5)[None]
    moe_forward(params, cfg, x, mask)  # warm-up: library handles, workspaces
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _, _ = moe_forward(params, cfg, x, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out).all())
    emit({"phase": "moe_sync", "card": card, "rows": 64, "dtype": "bfloat16",
          "sync_debug_mode": "error", "finite": finite})
    if not finite:
        raise AssertionError("moe_sync: the MoE block gave non-finite values")


def tree_bitwise_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_bitwise_equal(a[k], b[k]) for k in a)
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.int16), b.view(torch.int16)))


def recipe_serve_phase(card: str) -> int:
    """The llm_serve recipe through the CLI on a Llama-3-8B checkpoint that
    the port writes first; returns the recipe's launches of K4."""
    cfg = llama_config(LLAMA3_8B, dtype=torch.bfloat16)
    params = decoder.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                          dtype=torch.bfloat16)
    hf = dict(LLAMA3_8B, architectures=["LlamaForCausalLM"], model_type="llama",
              torch_dtype="bfloat16")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        save_hf_checkpoint(DenseDecoderAdapter(cfg).to_hf(params), str(tmp / "ckpt"),
                           hf_config=hf)
        write_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / "ckpt").iterdir())
        serving = {f.name: getattr(SERVE, f.name) for f in dataclasses.fields(SERVE)
                   if f.name in ("page_size", "num_pages", "max_slots", "pages_per_slot",
                                 "token_budget", "prefill_chunk")}
        node = {
            "recipe": "llm_serve", "seed": 0, "run_dir": str(tmp / "run"),
            "model": {"pretrained_path": str(tmp / "ckpt"), "dtype": "bfloat16"},
            "dataset": {"_target_": "automodel_tpu_torch.datasets.mock.MockDatasetConfig",
                        "num_samples": 16, "seq_len": RECIPE_PROMPT_LEN,
                        "vocab_size": cfg.vocab_size},
            "dataloader": {"microbatch_size": 16, "grad_acc_steps": 1},
            "max_requests": 16,
            "serving": {**serving, "max_new_tokens": 32, "temperature": 0.0,
                        "arrival_stride": 2},
        }
        (tmp / "serve.yaml").write_text(json.dumps(node, indent=1))  # JSON is YAML
        torch.cuda.reset_peak_memory_stats()
        for fn in PAGED_KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        recipe = cli_main([str(tmp / "serve.yaml")])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in PAGED_KERNELS.items()}
        gens = [json.loads(line) for line in (tmp / "run" / "generations.jsonl").open()]
        serve_log = [json.loads(line) for line in (tmp / "run" / "serving.jsonl").open()]
        stats = {k.removeprefix("serve_"): v for k, v in serve_log[-1].items()
                 if k.startswith("serve_")}
        same_weights = tree_bitwise_equal(recipe.params, params)
        steps = recipe.engine.steps_run
        del recipe
        torch.cuda.empty_cache()
    # the same weights and requests through the engine, in this process
    reqs = [Request(prompt=g["prompt_ids"], max_new_tokens=32, seed=i, arrival=i // 2)
            for i, g in enumerate(gens)]
    engine = ServingEngine(params, cfg, SERVE)
    direct = engine.serve_batch(reqs)["outputs"]
    del engine, params
    torch.cuda.empty_cache()
    emit({
        "phase": "recipe_serve", "card": card,
        "model": "Llama-3-8B widths, 32 layers, bf16, seed-0 weights",
        "checkpoint_gb": ckpt_bytes / 1e9, "write_s": write_s, "cli_s": cli_s,
        "load_s": cli_s - stats["elapsed_s"], "serve_s": stats["elapsed_s"],
        "requests": len(gens), "prompt_tokens": RECIPE_PROMPT_LEN, "steps": steps,
        "decode_tokens_per_sec": stats["decode_tokens_per_sec"],
        "itl_p50_ms": stats["itl_p50_ms"], "itl_p95_ms": stats["itl_p95_ms"],
        "ttft_p50_ms": stats["ttft_p50_ms"], "ttft_p95_ms": stats["ttft_p95_ms"],
        "launches": launches, "weights_bitwise_equal": same_weights,
        "equal_to_serve_batch": [g["generated_ids"] for g in gens] == direct,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    if not same_weights:
        raise AssertionError("recipe_serve: the loaded weights differ from the written ones")
    if len(gens) != 16 or any(len(g["generated_ids"]) != 32 for g in gens):
        raise AssertionError("recipe_serve: not every request finished with 32 tokens")
    want = {name: 0 for name in PAGED_KERNELS}
    want["K4"] = cfg.num_layers * steps
    if launches != want:
        raise AssertionError(
            f"recipe_serve: paged kernels launched {launches} in {steps} steps "
            f"of {cfg.num_layers} layers; expected {want}")
    if [g["generated_ids"] for g in gens] != direct:
        raise AssertionError("recipe_serve: the recipe's tokens differ from serve_batch's")
    return launches["K4"]


# the runtime calls by which the host launches a kernel, as the profiler
# names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx")


def profile_steps(engine, cfg, card: str, phase: str,
                  kernel_keys: tuple[str, ...]) -> None:
    """Where a serve step's time goes: the same traffic again, 40 steps to
    reach a mix of prefill and decode, then 10 steps under torch.profiler.
    Prints device busy time per step by kernel, the device's idle share of
    the window's wall time, the host's kernel launches per step and its
    operators with the most self time. `kernel_keys` name the attention
    kernel's device kernels (substrings of the profiler's names, as
    `KERNELS` gives them)."""
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
                attn_launches[k] += k in e.name
    busy_ms = sum(by_name.values())
    attn_ms = sum(v for k, v in by_name.items()
                  if any(key in k for key in kernel_keys))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the host's side of the window: kernel launches it issued, and the
    # operators that took the most of its own time (self CPU time)
    ops = prof.key_averages()
    launch_calls = sum(e.count for e in ops if e.key in HOST_LAUNCH_CALLS)
    host_top = sorted(((e.key, e.self_cpu_time_total / 1e3) for e in ops),
                      key=lambda kv: -kv[1])[:8]
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
        "host_launch_calls_per_step": launch_calls / n_steps,
        "top_host_self_ms_per_step": [[k[:80], v / n_steps] for k, v in host_top],
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
PAGED_DISPATCH = {"K4": "ragged_paged_attention",
                  "K5": "ragged_paged_attention",
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
    version through the engine; then the same engine in bf16 on the fp pool
    and on the int8 pool, which take K4's and K5's tensor-core routes."""
    cfg = dataclasses.replace(
        llama_config(LLAMA3_8B), num_layers=2, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = decoder.init(cfg, gen)
    sc = dataclasses.replace(SERVE, num_pages=256)
    engine_check("engine", cfg, params, sc, ENGINE_LOGITS_TOL)
    params16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    engine_bf16_check("engine_bf16", cfg16, params16, sc,
                      ENGINE_BF16_LOGITS_TOL, "K4")
    engine_bf16_check("engine_int8_bf16", cfg16, params16,
                      dataclasses.replace(sc, kv_cache_dtype="int8"),
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
    fa_names = {n for names in fa_cuda.KERNELS.values() for n in names}
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


# the aten ops whose own kernels are the dense GEMMs
DENSE_GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def self_device_ms_by_op(prof) -> dict:
    """Device time (ms) of the kernels each aten op launched itself."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0 and e.key.startswith("aten::"):
            out[e.key] = t / 1e3
    return out


def profile_step(recipe, mbs, patterns: dict, want: dict, attempts: int = 3):
    """One more optimizer step of `recipe` on `mbs` under torch.profiler:
    (profile, wall ms, device-kernel launches counted by the regex
    `patterns`). torch.profiler now and then loses a session's device
    events: up to `attempts` steps are profiled and the first whose counts
    equal `want` kept (the last one if none does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            recipe.run_step(mbs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        got = {k: sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                      and re.search(pat, e.name))
               for k, pat in patterns.items()}
        if got == want:
            break
    return prof, wall_ms, got


def train_moe_yaml(run_dir: str) -> str:
    """The train_moe phase's recipe, written to `run_dir`: Moonlight's
    config.json at MOE_TRAIN_LAYERS layers, bf16 over fp32 masters, full
    remat, mock data over MOE_TRAIN_TOKEN_IDS token ids, AdamW; returns its
    path."""
    cfg = {
        "seed": 0, "run_dir": run_dir,
        "model": {"hf_config": dict(MOONLIGHT, num_hidden_layers=MOE_TRAIN_LAYERS),
                  "dtype": "bfloat16", "remat_policy": "full"},
        "distributed": {"dp_shard": -1},
        "dataset": {"_target_": "automodel_tpu_torch.datasets.mock.MockDatasetConfig",
                    "num_samples": 64, "seq_len": MOE_TRAIN_SEQ,
                    "vocab_size": MOE_TRAIN_TOKEN_IDS},
        "dataloader": {"microbatch_size": 1, "grad_acc_steps": 1},
        "optimizer": {"name": "adamw", "lr": 1.0e-3, "weight_decay": 0.1},
        "lr_scheduler": {"style": "constant", "warmup_steps": 0},
        "step_scheduler": {"max_steps": MOE_TRAIN_STEPS},
        "checkpoint": {"enabled": False},
        "loss": {"chunk_size": 2048},
    }
    path = Path(run_dir) / "moonlight_train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def moe_block_sync_check(recipe, card: str) -> dict:
    """The first MoE layer of the trained model, its weights cast to bf16,
    forward and backward on one 4096-token microbatch (one token in 8
    masked) under set_sync_debug_mode("error"), which raises at any
    device-to-host read."""
    cfg = recipe.model_cfg
    moe_params = tree_map(lambda t: t[0].detach().to(cfg.dtype).requires_grad_(),
                          recipe.train_state.params["moe_layers"]["moe"])
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(1, MOE_TRAIN_SEQ, cfg.hidden_size, device="cuda",
                    generator=gen).to(cfg.dtype).requires_grad_()
    mask = (torch.arange(MOE_TRAIN_SEQ, device="cuda") % 8 != 5)[None]

    def fwd_bwd():
        out, aux, _ = moe_forward(moe_params, cfg.moe, x, mask)
        (out.float().square().mean() + aux).backward()

    fwd_bwd()  # warm-up: library handles, workspaces
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fwd_bwd()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(x.grad).all()) and all(
        p.grad is None or bool(torch.isfinite(p.grad).all())
        for p in tree_leaves(moe_params))
    if not finite:
        raise AssertionError("train_moe: the MoE block's gradients are not finite")
    return {"rows": MOE_TRAIN_SEQ, "dtype": str(cfg.dtype).removeprefix("torch."),
            "sync_debug_mode": "error", "forward_and_backward": True,
            "finite": finite}


def train_moe_phase(card: str) -> dict:
    """Moonlight-16B-A3B training through the CLI (full width, 4 layers, 5
    steps); returns K1-K3 launches of that run, all at <192, 128>."""

    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_moe_")
    torch.cuda.reset_peak_memory_stats()
    fa_cuda.launches_fwd = fa_cuda.launches_dq = fa_cuda.launches_dkv = 0
    t0 = time.perf_counter()
    recipe = cli_main([train_moe_yaml(run_dir)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"K1": fa_cuda.launches_fwd, "K2": fa_cuda.launches_dq,
                "K3": fa_cuda.launches_dkv}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    records = [json.loads(l) for l in
               (Path(run_dir) / "training.jsonl").read_text().splitlines()]
    cfg = recipe.model_cfg
    L = cfg.num_layers
    n = L * MOE_TRAIN_STEPS
    steady = records[1:]  # step 1 carries the first-call set-up
    tps = statistics.median(r["tps"] for r in steady)

    # one more step under the profiler: device time by kernel and by op
    mbs = [next(iter(recipe.dataloader))]
    prof, prof_wall_ms, mla_launches = profile_step(
        recipe, mbs, MLA_FA_KERNELS, {"K1": 2 * L, "K2": L, "K3": L})
    by_name = device_ms_by_kernel(prof)
    busy_ms = sum(by_name.values())
    attn_ms = sum(v for k, v in by_name.items()
                  if any(re.search(pat, k) for pat in MLA_FA_KERNELS.values()))
    self_dev = self_device_ms_by_op(prof)
    grouped_ms = self_dev.get("aten::_grouped_mm", 0.0)
    dense_gemm_ms = sum(self_dev.get(k, 0.0) for k in DENSE_GEMM_OPS)
    top = [[k[:80], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    top_ops = [[k, v] for k, v in sorted(self_dev.items(), key=lambda kv: -kv[1])[:12]]

    moe_sync = moe_block_sync_check(recipe, card)
    # the chunked CE (forward and backward) of one microbatch alone, and one
    # AdamW update of every master alone (zero gradients: the phase's last
    # use of these weights)
    params = recipe.train_state.params
    kernel = moe_decoder.head_kernel(params, cfg).detach().to(cfg.dtype)
    gen = torch.Generator(device="cuda").manual_seed(4)
    hidden = torch.randn(1, MOE_TRAIN_SEQ, cfg.hidden_size, device="cuda",
                         generator=gen).to(cfg.dtype).requires_grad_()
    labels = torch.randint(1, cfg.vocab_size, (1, MOE_TRAIN_SEQ), device="cuda",
                           generator=gen)

    def ce_fwd_bwd():
        ce, _ = fused_linear_cross_entropy(hidden, kernel, labels, chunk_size=2048)
        ce.backward()

    no_flush = torch.empty(0, device="cuda")  # both run warm, as in a step
    ce_ms = time_ms(ce_fwd_bwd, 1, no_flush)
    del kernel, hidden
    zeros = tree_map(torch.zeros_like, params)
    opt_ms = time_ms(lambda: recipe.tx.update(zeros, recipe.train_state.opt_state,
                                              params), 1, no_flush)
    del zeros
    emit({
        "phase": "train_moe", "card": card,
        "model": f"Moonlight-16B-A3B widths, {L} layers ({cfg.first_k_dense} dense + "
                 f"{cfg.num_moe_layers} MoE), {cfg.dtype}, remat {cfg.remat_policy}",
        "cut": "27 -> 4 layers: ~16 B parameters need ~256 GB of fp32 masters, "
               "gradients and AdamW moments; 4 layers need ~40 GB",
        "params": count_params(params),
        "steps": len(records), "tokens_per_step": MOE_TRAIN_SEQ,
        "losses": [r["loss"] for r in records],
        "grad_norms": [r["grad_norm"] for r in records],
        "moe_load_imbalance": [r["moe_load_imbalance"] for r in records],
        "ms_per_step": MOE_TRAIN_SEQ / tps * 1e3, "tokens_per_s": tps,
        "mfu_pct": statistics.median(r["mfu_pct"] for r in steady),
        "tflops_per_device": statistics.median(r["tflops_per_device"] for r in steady),
        "flops_per_token": cfg.flops_per_token(MOE_TRAIN_SEQ),
        "wall_s_with_setup": wall_s, "peak_mem_gib": peak_gib,
        "launches": launches,
        "expected_launches": {"K1": 2 * n, "K2": n, "K3": n},
        "profiled_step": {
            "wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
            "mla_flash_launches_by_profiler_name": mla_launches,
            "attention_k1_k3_ms": attn_ms,
            "grouped_expert_gemm_ms": grouped_ms,
            "dense_gemm_ms": dense_gemm_ms,
            "other_ms": busy_ms - attn_ms - grouped_ms - dense_gemm_ms,
            "top_kernels_ms": top, "top_ops_self_device_ms": top_ops},
        "ce_fwd_bwd_ms_alone": ce_ms, "adamw_update_ms_alone": opt_ms,
        "moe_block_sync": moe_sync,
    })
    losses = [r["loss"] for r in records]
    if len(records) != MOE_TRAIN_STEPS:
        raise AssertionError(f"{len(records)} MoE training records, not {MOE_TRAIN_STEPS}")
    if not all(math.isfinite(x) for x in losses + [r["grad_norm"] for r in records]):
        raise AssertionError(f"train_moe: non-finite loss or grad norm: {records}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_moe: the loss did not fall: {losses}")
    if launches != {"K1": 2 * n, "K2": n, "K3": n}:
        raise AssertionError(f"train_moe: K1-K3 launches {launches} on {n} layer-steps")
    if mla_launches != {"K1": 2 * L, "K2": L, "K3": L}:
        raise AssertionError(
            f"train_moe: the profiled step's <192, 128> K1-K3 launches {mla_launches}")
    del recipe, prof, params
    torch.cuda.empty_cache()
    return launches


def train_moe_check_phase() -> None:
    """fp32, 2 layers (1 dense + 1 MoE) at Moonlight width: one accumulated
    step (2 microbatches of MOE_CHECK_SEQ tokens) from the same weights and
    batch with attn_impl "flash" (K1-K3 at <192, 128> on the CUDA cores) and
    "torch" (the plain attention). The balanced gate holds the routing
    equal in both: a top-k near-tie could otherwise move a token to another
    expert between two runs whose attention differs by ~1e-6."""
    base = deepseek_v3_moe_config(dict(MOONLIGHT, num_hidden_layers=2),
                                  dtype=torch.float32, remat_policy="full")
    base = dataclasses.replace(base, moe=dataclasses.replace(base.moe, fake_balanced_gate=True))
    params0 = moe_decoder.init(base, torch.Generator(device="cuda").manual_seed(4))
    ds = MockDatasetConfig(num_samples=4, seq_len=MOE_CHECK_SEQ,
                           vocab_size=base.vocab_size, seed=5).build()
    batch = make_global_batch(stack_microbatches(
        [{k: v[None] for k, v in ds[i].items()} for i in range(2)]), "cuda")
    results = {}
    for impl in ("flash", "torch"):
        cfg = dataclasses.replace(base, attn_impl=impl)

        def loss_fn(params, mb, rng, cfg=cfg):
            h, aux, _ = moe_decoder.forward(params, cfg, mb["input_ids"],
                                            return_hidden=True, return_stats=True,
                                            token_mask=mb["labels"] != -100)
            ce, n = fused_linear_cross_entropy(
                h, moe_decoder.head_kernel(params, cfg), mb["labels"], chunk_size=2048)
            return combine_losses(ce, n, aux)

        params = tree_map(lambda t: t.clone().requires_grad_(), params0)
        leaves = tree_leaves(params)
        fa_cuda.launches_fwd = 0
        ce, aux = accumulate_grads(loss_fn, params, batch)
        results[impl] = (float(ce / aux["num_label_tokens"]),
                         [t.grad for t in leaves], fa_cuda.launches_fwd)
        del params, leaves
        torch.cuda.empty_cache()
    (loss_f, g_f, n_f), (loss_t, g_t, n_t) = results["flash"], results["torch"]
    if any((a is None) != (b is None) for a, b in zip(g_f, g_t)):
        raise AssertionError("train_moe_check: the two runs reach different leaves")
    grad_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                   for a, b in zip(g_f, g_t) if a is not None)
    loss_rel = abs(loss_f - loss_t) / abs(loss_t)
    emit({"phase": "train_moe_check", "layers": 2, "dtype": "float32",
          "tokens": [2, MOE_CHECK_SEQ], "loss_flash": loss_f, "loss_torch": loss_t,
          "loss_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
          "grad_max_rel_err": grad_err, "grad_tol": TRAIN_GRAD_TOL,
          "k1_launches": [n_f, n_t]})
    if n_f == 0 or n_t != 0:
        raise AssertionError("train_moe_check: attn_impl did not select the kernels / plain path")
    if loss_rel > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_TOL:
        raise AssertionError("train_moe_check: the step differs between kernels and plain")


def gemma_train_yaml(run_dir: str, hf: dict, seq: int, attn_impl: str = "auto") -> str:
    """A train_gemma phase's recipe, written to `run_dir`: the published
    config at full width and depth, bf16 over fp32 masters, full remat,
    mock data over GEMMA_TRAIN_TOKEN_IDS token ids, microbatch 1, AdamW,
    attention by `attn_impl`; returns its path."""
    cfg = {
        "seed": 0, "run_dir": run_dir,
        "model": {"hf_config": dict(hf), "dtype": "bfloat16", "remat_policy": "full",
                  "attn_impl": attn_impl},
        "distributed": {"dp_shard": -1},
        "dataset": {"_target_": "automodel_tpu_torch.datasets.mock.MockDatasetConfig",
                    "num_samples": 64, "seq_len": seq,
                    "vocab_size": GEMMA_TRAIN_TOKEN_IDS},
        "dataloader": {"microbatch_size": 1, "grad_acc_steps": 1},
        "optimizer": {"name": "adamw", "lr": 1.0e-3, "weight_decay": 0.1},
        "lr_scheduler": {"style": "constant", "warmup_steps": 0},
        "step_scheduler": {"max_steps": GEMMA_TRAIN_STEPS},
        "checkpoint": {"enabled": False},
        "loss": {"chunk_size": 2048},
    }
    path = Path(run_dir) / f"{hf['architectures'][0]}_train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def train_gemma_phase(card: str, phase: str, model: str, hf: dict, seq: int) -> dict:
    """Gemma-2-2B or Gemma-3-1B training through the CLI at full width and
    full depth, GEMMA_TRAIN_STEPS steps of `seq` tokens; returns K1-K3
    launches of that run, all at <256, 256>, and its training records."""

    run_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_")
    torch.cuda.reset_peak_memory_stats()
    fa_cuda.launches_fwd = fa_cuda.launches_dq = fa_cuda.launches_dkv = 0
    t0 = time.perf_counter()
    recipe = cli_main([gemma_train_yaml(run_dir, hf, seq)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"K1": fa_cuda.launches_fwd, "K2": fa_cuda.launches_dq,
                "K3": fa_cuda.launches_dkv}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    records = [json.loads(l) for l in
               (Path(run_dir) / "training.jsonl").read_text().splitlines()]
    cfg = recipe.model_cfg
    L = cfg.num_layers
    windows = decoder.layer_windows(cfg)
    n = L * GEMMA_TRAIN_STEPS
    steady = records[1:]  # step 1 carries the first-call set-up
    tps = statistics.median(r["tps"] for r in steady)

    # one more step under the profiler: device time by kernel, idle share
    mbs = [next(iter(recipe.dataloader))]
    prof, prof_wall_ms, fa_launches = profile_step(
        recipe, mbs, GEMMA_FA_KERNELS, {"K1": 2 * L, "K2": L, "K3": L})
    by_name = device_ms_by_kernel(prof)
    busy_ms = sum(by_name.values())
    attn_ms = {k: sum(v for name, v in by_name.items() if re.search(pat, name))
               for k, pat in GEMMA_FA_KERNELS.items()}
    self_dev = self_device_ms_by_op(prof)
    dense_gemm_ms = sum(self_dev.get(k, 0.0) for k in DENSE_GEMM_OPS)
    top = [[k[:80], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    top_ops = [[k, v] for k, v in sorted(self_dev.items(), key=lambda kv: -kv[1])[:12]]
    losses = [r["loss"] for r in records]
    # the init's excess over ln(V): logits are the unit-RMS final hidden
    # state times the final norm's scale 2 (zero-centred, stored 1) times the
    # tied 0.02-std (truncated at 2 std: 0.0176) embedding, a spread of
    # sigma = 2 sqrt(H) 0.0176 and an excess of about sigma^2 / 2
    sigma = 2 * math.sqrt(cfg.hidden_size) * 0.0176
    ln_v = math.log(cfg.vocab_size)
    emit({
        "phase": phase, "card": card,
        "model": f"{model}, full width and all {L} layers, {cfg.dtype}, "
                 f"remat {cfg.remat_policy}",
        "cut": "nothing: full width, full depth, the published context "
               f"({seq} tokens)",
        "windows": {"sliding_layers": sum(w is not None for w in windows),
                    "global_layers": sum(w is None for w in windows),
                    "window": cfg.sliding_window},
        "params": count_params(recipe.train_state.params),
        "steps": len(records), "tokens_per_step": seq,
        "losses": losses, "grad_norms": [r["grad_norm"] for r in records],
        "ln_vocab": ln_v, "init_excess_estimate": sigma ** 2 / 2,
        "ms_per_step": seq / tps * 1e3, "tokens_per_s": tps,
        "mfu_pct": statistics.median(r["mfu_pct"] for r in steady),
        "tflops_per_device": statistics.median(r["tflops_per_device"] for r in steady),
        "flops_per_token": cfg.flops_per_token(seq),
        "flops_per_token_note": "the JAX formula: full causal attention on every "
                                "layer, windowed ones included",
        "wall_s_with_setup": wall_s, "peak_mem_gib": peak_gib,
        "launches": launches,
        "expected_launches": {"K1": 2 * n, "K2": n, "K3": n},
        "profiled_step": {
            "wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
            "flash_256_launches_by_profiler_name": fa_launches,
            "attention_ms_by_kernel": attn_ms,
            "dense_gemm_ms": dense_gemm_ms,
            "other_ms": busy_ms - sum(attn_ms.values()) - dense_gemm_ms,
            "top_kernels_ms": top, "top_ops_self_device_ms": top_ops},
    })
    if len(records) != GEMMA_TRAIN_STEPS:
        raise AssertionError(f"{phase}: {len(records)} records, not {GEMMA_TRAIN_STEPS}")
    if not all(math.isfinite(x) for x in losses + [r["grad_norm"] for r in records]):
        raise AssertionError(f"{phase}: non-finite loss or grad norm: {records}")
    if not ln_v - 0.5 <= losses[0] <= ln_v + sigma ** 2 + 1.0:
        raise AssertionError(
            f"{phase}: step-1 loss {losses[0]} is not near ln(V) = {ln_v} plus "
            f"the init's excess ~{sigma ** 2 / 2}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")
    if launches != {"K1": 2 * n, "K2": n, "K3": n}:
        raise AssertionError(f"{phase}: K1-K3 launches {launches} on {n} layer-steps")
    if fa_launches != {"K1": 2 * L, "K2": L, "K3": L}:
        raise AssertionError(
            f"{phase}: the profiled step's <256, 256> K1-K3 launches {fa_launches}")
    del recipe, prof
    torch.cuda.empty_cache()
    return launches, records


def train_gemma2_plain_phase(card: str, flash_records: list) -> None:
    """train_gemma2 again with the plain attention (attn_impl "torch"):
    the same YAML, seed, weights and batches, bf16, full depth. Step 1 runs
    from the same weights on the same batch, so its loss and grad norm must
    agree with the kernels' run to bf16's rounding (GEMMA_PLAIN_LOSS_RTOL,
    GEMMA_PLAIN_GNORM_RTOL); the later steps are recorded beside the
    kernels' (AdamW at a constant 1e-3 from random weights moves far enough
    that bf16 differences grow), with the step at which each curve rises."""
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_gemma2_plain_")
    torch.cuda.reset_peak_memory_stats()
    fa_cuda.launches_fwd = 0
    t0 = time.perf_counter()
    cli_main([gemma_train_yaml(run_dir, GEMMA2_2B, GEMMA2_TRAIN_SEQ, attn_impl="torch")])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    records = [json.loads(l) for l in
               (Path(run_dir) / "training.jsonl").read_text().splitlines()]

    def rises(rs):
        return [i + 2 for i in range(len(rs) - 1) if rs[i + 1]["loss"] > rs[i]["loss"]]

    f_loss, p_loss = flash_records[0]["loss"], records[0]["loss"]
    f_gn, p_gn = flash_records[0]["grad_norm"], records[0]["grad_norm"]
    loss_rel, gn_rel = abs(f_loss - p_loss) / abs(p_loss), abs(f_gn - p_gn) / abs(p_gn)
    emit({"phase": "train_gemma2_plain", "card": card,
          "model": "Gemma-2-2B, full width and all 26 layers, bf16, remat full, "
                   "attn_impl torch (the plain attention)",
          "steps": len(records), "tokens_per_step": GEMMA2_TRAIN_SEQ,
          "losses_plain": [r["loss"] for r in records],
          "losses_kernels": [r["loss"] for r in flash_records],
          "grad_norms_plain": [r["grad_norm"] for r in records],
          "grad_norms_kernels": [r["grad_norm"] for r in flash_records],
          "loss_rises_at_step": {"plain": rises(records), "kernels": rises(flash_records)},
          "step1_loss_rel_err": loss_rel, "loss_rtol": GEMMA_PLAIN_LOSS_RTOL,
          "step1_grad_norm_rel_err": gn_rel, "grad_norm_rtol": GEMMA_PLAIN_GNORM_RTOL,
          "ms_per_step": GEMMA2_TRAIN_SEQ / statistics.median(r["tps"] for r in records[1:]) * 1e3,
          "ms_per_step_kernels": GEMMA2_TRAIN_SEQ / statistics.median(
              r["tps"] for r in flash_records[1:]) * 1e3,
          "k1_launches": fa_cuda.launches_fwd, "wall_s_with_setup": wall_s,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    if fa_cuda.launches_fwd != 0:
        raise AssertionError("train_gemma2_plain: attn_impl torch launched K1")
    if len(records) != GEMMA_TRAIN_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
        raise AssertionError(f"train_gemma2_plain: bad records {records}")
    if loss_rel > GEMMA_PLAIN_LOSS_RTOL or gn_rel > GEMMA_PLAIN_GNORM_RTOL:
        raise AssertionError(
            "train_gemma2_plain: step 1 differs between kernels and plain attention")
    torch.cuda.empty_cache()


def train_gemma_check_phase() -> None:
    """fp32, Gemma-2-2B widths, 2 layers (one sliding with a window of
    GEMMA_CHECK_WINDOW, one global), soft caps and tied head: one
    accumulated step (2 microbatches of GEMMA_CHECK_SEQ tokens) from the
    same weights and batch with attn_impl "flash" (K1-K3 at <256, 256> on
    the CUDA cores) and "torch" (the plain attention)."""
    base = gemma2_config(dict(GEMMA2_2B, num_hidden_layers=2,
                              sliding_window=GEMMA_CHECK_WINDOW),
                         dtype=torch.float32, remat_policy="full")
    windows = decoder.layer_windows(base)
    assert windows == (GEMMA_CHECK_WINDOW, None), windows
    params0 = decoder.init(base, torch.Generator(device="cuda").manual_seed(6))
    ds = MockDatasetConfig(num_samples=4, seq_len=GEMMA_CHECK_SEQ,
                           vocab_size=GEMMA_TRAIN_TOKEN_IDS, seed=7).build()
    batch = make_global_batch(stack_microbatches(
        [{k: v[None] for k, v in ds[i].items()} for i in range(2)]), "cuda")
    results = {}
    for impl in ("flash", "torch"):
        cfg = dataclasses.replace(base, attn_impl=impl)

        def loss_fn(params, mb, rng, cfg=cfg):
            h = decoder.forward(params, cfg, mb["input_ids"], return_hidden=True)
            return fused_linear_cross_entropy(
                h, decoder.head_kernel(params, cfg), mb["labels"], chunk_size=2048,
                logits_soft_cap=cfg.logits_soft_cap)

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
    emit({"phase": "train_gemma_check", "layers": 2, "windows": list(windows),
          "dtype": "float32", "tokens": [2, GEMMA_CHECK_SEQ], "loss_flash": loss_f,
          "loss_torch": loss_t, "loss_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
          "grad_max_rel_err": grad_err, "grad_tol": TRAIN_GRAD_TOL,
          "k1_launches": [n_f, n_t]})
    if n_f == 0 or n_t != 0:
        raise AssertionError("train_gemma_check: attn_impl did not select the kernels / plain path")
    if loss_rel > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_TOL:
        raise AssertionError("train_gemma_check: the step differs between kernels and plain")


# the tensor-core kernels in ptxas's mangled names: (pattern, readable name)
MMA_KERNELS = (
    (r"((?:fwd|dkv|dq)_mma_kernel)ILi(\d+)ELi(\d+)ELb([01])E",
     lambda m: f"{m[1]}<{m[2]}, {m[3]}, {'true' if m[4] == '1' else 'false'}>"),
    (r"((?:mla|gqa)_split_kernel)I(a|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
     lambda m: f"{m[1]}<{'int8' if m[2] == 'a' else 'bf16'}, {m[3]}, {m[4]}>"),
    # mla_combine_kernel<bf16 out>, gqa_combine_kernel<int8 or bf16 pages>
    (r"((?:mla|gqa)_combine_kernel)I(a|13__nv_bfloat16)E",
     lambda m: f"{m[1]}<{'int8' if m[2] == 'a' else 'bf16'}>"),
)


# K1-K3's CUDA-core (fp32) instantiations in ptxas's mangled names
FMA_FLASH_KERNELS = (
    (r"((?:fwd|dkv|dq)_kernel)IfLi(\d+)ELi(\d+)E",
     lambda m: f"{m[1]}<float, {m[2]}, {m[3]}>"),
)


def mma_ptxas(log: str, patterns=MMA_KERNELS) -> dict:
    """ptxas's report on the kernels `patterns` name (by default the bf16
    tensor-core instantiations: K1-K3 at each (q/k, v) pair of head dims;
    the split kernels of K4-K7 at each step and column count, their
    combines): registers, spill bytes and, for K1-K3 (on either route) and
    the split kernels at Llama-3-8B's (K4, K5) and Moonlight's (K6, K7)
    widths, dynamic shared memory (the launch size)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            name = None
            for pattern, readable in patterns:
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
    for key, entry in out.items():
        page = torch.int8 if "int8" in key else torch.bfloat16
        if key.startswith("mla_split"):
            n, r, dr = MOONLIGHT_MLA
            entry["dynamic_smem_bytes_moonlight"] = mla_cuda.split_smem_bytes(
                n, r, dr, SERVE.page_size, SERVE.pages_per_slot, page)
        elif key.startswith("gqa_split"):
            entry["dynamic_smem_bytes_llama3_8b"] = rpa_cuda.split_smem_bytes(
                32, 8, 128, 128, SERVE.page_size, SERVE.pages_per_slot, page)
        elif key.startswith(("fwd_", "dq_", "dkv_")):
            d, dv = (int(x) for x in re.findall(r"\d+", key.split("<")[1])[:2])
            entry["dynamic_smem_bytes"] = fa_cuda.smem_bytes(
                "mma" if "_mma_" in key else "fma", key.split("_")[0], d, dv)
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
              + logs[_build.library_path(K4_SOURCE).stem]),
          "cuda_core_flash_kernels": mma_ptxas(
              logs[_build.library_path(fa_cuda.SOURCE).stem], FMA_FLASH_KERNELS)})

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    k4 = kernel_phase(flush)
    paged = paged_kernels_phase(flush)
    flash = flash_phase(flush)
    del flush
    launches = serve_phase(card)
    launches.update(serve_mla_phase(card))
    moe_sync_phase(card)
    launches["K4_recipe"] = recipe_serve_phase(card)
    engine_phase()
    engine_mla_phase()
    torch.cuda.empty_cache()
    train_launches = train_phase(card)
    train_check_phase()
    train_paths_phase()
    moe_launches = train_moe_phase(card)
    train_moe_check_phase()
    gemma_launches, gemma2_records = train_gemma_phase(
        card, "train_gemma2", "Gemma-2-2B", GEMMA2_2B, GEMMA2_TRAIN_SEQ)
    gemma_launches = {"gemma2": gemma_launches, "gemma3": train_gemma_phase(
        card, "train_gemma3", "Gemma-3-1B", GEMMA3_1B, GEMMA3_TRAIN_SEQ)[0]}
    train_gemma2_plain_phase(card, gemma2_records)
    train_gemma_check_phase()

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
        if name == "K4":  # the llm_serve recipe's run, counted apart
            kernels[-1]["recipe_serve_launches"] = launches["K4_recipe"]
        # each paged kernel's route follows the query dtype
        if name in ("K4", "K5"):
            kernels[-1]["kernel_route"] = rpa_cuda.route(torch.bfloat16)
        elif name in ("K6", "K7"):
            kernels[-1]["kernel_route"] = mla_cuda.route(torch.bfloat16)
    # K1-K3 at Llama-3-8B's heads (<128, 128>, the dense train run's
    # launches), at Moonlight's MLA heads (<192, 128>, train_moe's), and at
    # Gemma-2-2B's and Gemma-3-1B's windowed heads (<256, 256>, their
    # training runs')
    for key, suffix, dims, runs in (
            ("dense", "", (128, 128), train_launches),
            ("mla", "_mla", (192, 128), moe_launches),
            ("gemma2", "_gemma2", (256, 256), gemma_launches["gemma2"]),
            ("gemma3", "_gemma3", (256, 256), gemma_launches["gemma3"])):
        for name, replaces in (("K1", ":140"), ("K2", ":238"), ("K3", ":283")):
            e = flash[key][name]
            row = {
                "name": {"K1": "flash_attention_fwd", "K2": "flash_attention_dq",
                         "K3": "flash_attention_dkv"}[name] + suffix,
                "route": "cuda",
                "source": "automodel_tpu_torch/csrc/flash_attention.cu",
                "replaces": "automodel_tpu/ops/pallas/flash_attention.py" + replaces,
                "launches": runs[name],
                "max_abs_err": e["max_abs_err"],
                "ms": e["ms"],
                "plain_ms": e["plain_ms"],
                "bound_ms": e["bound_ms"],
                "bound_by": e["bound_by"],
                "library_ms": e["library_ms"],
                "library_call": e["library_call"],
                "library_backend": e["library_backend"],
                "kernel_route": fa_cuda.route(torch.bfloat16),
                "head_dims": list(dims),
                "tflops": e["tflops"],
                "bound_share": e["bound_share"],
                "card": card,
            }
            if "library_why" in e:
                row["library_same_function"] = e["library_same_function"]
                row["library_why"] = e["library_why"]
            kernels.append(row)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
