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
   kernel_window: K4 and K5 with sliding windows and sinks on both routes
   against the plain version, over contexts longer than each window (a
   window of no multiple of the page or the split; gpt-oss-20b's heads with
   window 128 and sinks), and timed at Gemma-2-2B's heads (8/4, D 256, cap
   50) on 64 rows at positions of ~8000 with window 4096 and without, each
   beside its bound over the pages that meet the rows' windows;
3. flash: K1-K3 (flash attention forward, dq, dk/dv) against their plain
   versions at the training shapes (B 1, S 4096, Hq 32, Hkv 8, D 128,
   causal) in bf16 (K1-K3 on the tensor cores) and fp32 (CUDA cores),
   plus a packed-segment case, an S that is not a multiple of the tile and
   head dim 64 in bf16; timed beside their operations bound, the plain
   versions and `scaled_dot_product_attention` as a yardstick; and, in bf16
   and fp32, the head dims they run padded to an instantiated pair (8 at
   the smoke YAMLs' shapes, 32, 96, (64, 96)), through the autograd
   function's `kernels_forward` / `kernels_backward`;
4. serve / serve_int8: the dense main path (`ServingEngine.serve_batch`) at
   the full width and depth of Llama-3-8B with random weights: 16 requests
   of 64-900 prompt tokens arriving every 2 steps, 32 greedy tokens each,
   on the fp pool (every layer of every step launches K4) and on the int8
   pool with the same weights (K5), with the greedy agreement between the
   two; a profile of 10 more steps of the same traffic follows each
   (device time by kernel, idle share);
5. serve_mla / serve_mla_int8: the MLA + MoE main path, Moonlight-16B-A3B
   at full width cut to 4 of its 27 layers, bf16, random weights from seed 0, on
   the same traffic, on the fp pool (K6) and on the int8 pool (K7), each
   with its profile;
   serve_gemma2 / serve_gemma2_int8: the windowed main path,
   google/gemma-2-2b at full width cut to 6 of its 26 layers (window 4096
   and global, alternating), bf16, 16 requests of 4200-7800 prompt tokens, 32
   greedy tokens each, on the fp pool (K4 on every layer of every step,
   the global layers with no window) and the int8 pool (K5), no plain
   attention call, with a profile of the fp pool's steps;
   serve_dsv3 / serve_dsv3_int8 / serve_kimi_k2: DeepSeek-V3 (cut to 4
   layers: 3 dense + 1 MoE of 256 experts) and Kimi-K2 (cut to 2: 1 dense
   + 1 MoE of 384 experts) at their published widths with yarn rope, bf16,
   random weights from seed 0, on serve's traffic: DeepSeek-V3 on the fp
   (K6) and int8 (K7) pools, Kimi-K2 on the fp pool, K6 / K7 on every
   layer of every step at 128 and 64 heads, each with its profile and a
   few steps of the engine with every kernel call held to its plain
   version;
   serve_qwen3_moe / serve_qwen3_moe_int8 / serve_gpt_oss / serve_mixtral:
   the GQA MoE main path at published widths, bf16, random weights from
   seed 0, on serve's traffic: Qwen3-30B-A3B cut to 8 of its 48 layers
   (128 experts, G 8 x D 128) on the fp (K4) and int8 (K5) pools, gpt-oss-20b
   cut to 12 of its 24 layers (K4 with window 128 and sinks on the sliding layers,
   sinks alone on the full ones), Mixtral-8x7B cut to 8 of 32 layers;
   each with its profile and a few steps of the engine with every kernel
   call held to its plain version;
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
   inputs, greedy agreements reported; engine_window: the same four checks
   on a 2-layer Gemma-2 engine at Gemma-2-2B widths (window 512 and a
   global layer) with prompts of 600-900 tokens;
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
   the loss curves must agree;
11. train_gemma3_ckpt: the Gemma-3-1B training recipe at full width, cut
   to 6 of 26 layers (the script's time and disk budget, below), with the
   train-state checkpointer on (a save every 3 steps,
   async, one kept, the consolidated HF export at the end): 5 unbroken
   steps; a new process restored from the step-3 checkpoint runs steps 4-5
   with the unbroken run's losses and grad norms (1e-6 relative); then the
   `llm_serve` recipe through the CLI on the export, prompts of 900 tokens
   over the 512 window, K4 on every layer of every step. Checkpoint bytes,
   save seconds and time_to_resume_s are printed;
12. train_lora (right after recipe_serve, whose Llama-3-8B checkpoint is
   its base at `model.pretrained_path`): `examples/llm_finetune/
   llama_lora.yaml`'s peft section (r 16, alpha 32, q/k/v/o), optimizer and
   schedule on Llama-3-8B at its published config with nothing cut (32
   layers, seq 4096, bf16 over the fp32 base, full remat), 2 accumulated
   microbatches, 6 steps, validation (loss on 2 mock samples of 4096
   tokens, and the sampling eval: 16-token prompt, 32 greedy tokens) every
   3 steps, a PEFT-only checkpoint every 3 steps and the merged
   consolidated export, read back and held to the merge; K1-K3 counted
   against 2n + the validation forwards, n, n; one profiled step; then a
   new recipe object restored from the step-3 checkpoint, which rebuilds
   the base from the HF checkpoint: its steps 4-6 and validation must
   equal the unbroken run's bit for bit. train_qlora: the same with
   `quantize_base: int8`, 3 steps, its peak below train_lora's;
13. generate_check (after the engine phases): greedy `generate()` on
   2-layer fp32 models at the full widths of Llama-3-8B, Gemma-2-2B,
   Moonlight-16B-A3B and DeepSeek-V3 and a 1-layer Kimi-K2 (both with
   yarn), 8 prompts of 64-512 tokens, 32 new tokens, equal to the
   teacher-forced `forward` argmax and to `serve_batch` (K4, K6; the fp32
   K6 at 128 and 64 heads in head tiles);
14. train_lora_check (after train_check): fp32, 2 layers at Llama-3-8B
   width, one step each of LoRA, DoRA and QLoRA adapters with K1-K3 and
   with the plain attention: losses and adapter gradients agree;
15. train_moe_capacity (after train_moe): train_moe's recipe with
   `model.moe_dispatcher: capacity`, 3 steps, its ms per step beside the
   dropless run's and the share of routed pairs the capacity dropped;
   train_dsv3_mtp: the training CLI on DeepSeek-V3's published widths with
   yarn and the MTP head, cut to its 2 first (dense) layers, seq 2048, 5
   steps: finite losses, the main and MTP losses apart, K1-K3 at <192, 128>
   on the 2 layers and the MTP block (K1 twice under full remat);
16. train_qwen3_moe / train_gpt_oss: the training CLI at Qwen3-30B-A3B's
   and gpt-oss-20b's published widths cut to 4 and 2 layers, seq 4096,
   bf16, full remat, 5 steps: finite losses and `moe_load_imbalance`, K1-K3
   counted, all at the heads' <128, 128> and <64, 64>, one profiled step;
   train_gpt_oss_check: fp32, 2 layers (window 128 and full, random
   sinks), one accumulated step with the kernels and with the plain
   attention: losses and gradients, the sinks' included, agree; smoke_families: the eight GQA MoE families' smoke
   YAMLs (head dim 8, which K1-K3 run padded to 16) through the CLI, 3
   steps each with the kernels and with the plain attention: the curves
   agree, and a control run with the kernels at the padded dim's softmax
   scale must not;
17. serve_glm4 (after serve_gemma2): GLM-4-9B-0414 cut to 16 of its 40 layers (rotary
   on half of each head, G 16) on serve's traffic, K4 on every layer of
   every step, with a profile, then on the int8 pool (K5), and its engine
   at 2 layers in fp32 held to the plain version; serve_dense_groups:
   Qwen2.5-7B (G 7) and Baichuan2-7B (MHA, NormHead) cut to 2 layers;
   train_qwen25_lora (after smoke_families): the LoRA CLI on Qwen2.5-7B
   uncut at seq 4096 (BASELINE.md's single-GPU row), 5 steps, K1-K3 on
   all 28 layers; remat_policies: that recipe under "none", "dots",
   "dots_with_no_batch_dims", "checkpoint_dots" and "full", losses and
   gradients equal to "full"'s, peak memory in that order; train_encoders:
   the retrieval_bi_encoder CLI on a LlamaBidirectionalModel at
   llama-3.2-nv-embedqa-1b-v2's widths, uncut, 64 pairs of 512 tokens a
   step (K1-K3 with no mask), then llm_seq_cls on the same widths, and a
   2-layer fp32 check, kernels vs plain; smoke_dense_families: the five
   new families' smoke YAMLs and the seq-cls, bi- and cross-encoder ones,
   as smoke_families;
18. after smoke_dense_families: train_tokenbin: the training recipe on
   `examples/llm_pretrain/llama3_8b_mock_bf16.yaml` at full width cut to 2
   layers, 5 steps of 2 x 4096 tokens, its dataset a
   `TokenBinDatasetConfig` over a 64 Mi-token int32 corpus written from
   seed 0 (documents of log-uniform length 16-32768), with wandb and
   mlflow sections and gc_control on: the native index build timed, the
   loader's ms per batch beside the step's, the first step's rows equal to
   a plain gather from the memmap, each tracker mirror equal to
   `training.jsonl`, GC off during the steps and on after, K1-K3 counted;
   serve_glm47_flash / _int8: GLM-4.7-Flash (`Glm4MoeLiteForCausalLM`
   through the registry) at full width cut to 8 of its 47 layers, bf16,
   on serve's traffic, K6 / K7 at 20 heads on every layer of every step,
   each with its profile and `engine_plain_check`, then 2 layers in fp32
   on both pools (the fp32 route at 20 heads); train_glm47_flash: K1-K3
   at its heads (20 of <256, 256>, S 4096) held to the plain versions and
   timed, then the training CLI at its widths cut to 2 layers and its MTP
   layer, 3 steps of 4096 tokens, K1-K3 all at <256, 256>;
   serve_mistral4: `Mistral4ForCausalLM` at DeepSeek-V3's widths, 2
   layers, the q-rope scale at beta 0.1 over 256 positions (four values
   on serve's traffic), `engine_plain_check`, and a control with the
   scaling off whose greedy tokens must differ; smoke_moe_lite: the
   GLM-4.7-Flash, Mistral-4 and Hy-MT2 smoke YAMLs as smoke_families (the
   MLA ones' control from the padded v dim: their q/k dim 16 is not
   padded); train_chat_sft: `llm_finetune` at Llama-3.2-1B's widths on an
   `AgentChatDatasetConfig` of 512 tool-calling conversations written
   from seed 0, through a byte-level tokenizer (it needs no `transformers`,
   which a card's host may lack: a recipe subclass overrides
   `_build_tokenizer`), wandb
   and comet sections and gc_control on, 5 steps of 4 x 2048 tokens: each
   step's label tokens equal to the rows' own, the mirrors equal to
   `training.jsonl`, GC on after, and one validation pass whose sampling
   eval returns the tool-call metrics;
19. quantized linears, DSA and routing replay: quant_mm (after flash): the
   fp8 (`_scaled_mm`) and int8 (`_int_mm`) routes of
   `ops/quant.quantized_matmul` against its plain version on the card,
   forward and backward, at Llama-3-8B's linears at 64 and 4096 rows,
   timed beside the bf16 `torch.matmul` and their bound (1979 TFLOP/s);
   serve_fp8 / serve_int8w (after serve, its weights' first 16 layers):
   `serve_precision` fp8 on the fp pool (K4, with a profile) and int8 on
   the int8 pool (K5), the quantized GEMMs counted, the greedy agreement
   with the same layers' bf16 tokens;
   train_fp8 (after train): train's run with `model.linear_precision: fp8`
   beside train's numbers; train_qat: the same YAML at 2 layers with `qat`
   (int8 from step 2), 4 steps, the steps before it bit-equal to a plain
   run's; serve_dsv32 (after serve_mistral4): DeepSeek-V3.2
   (`DeepseekV32ForCausalLM`) at its published widths cut to 3 dense + 1
   MoE layers with its indexers, serve's traffic, K6 on every layer of
   every step, the tokens equal to the same weights' without the indexers;
   dsa_check: one DeepSeek-V3.2 layer in fp32 at S 1024, the chunked sparse
   path against the oracle; train_dsv32_dsa:
   `examples/long_context/dsv32_dsa_32k_chunked.yaml` at 32768 tokens on
   the chunked path, cut to the model's 2 dense layers (ms a step, peak
   memory, the indexer-KL aux); train_moe ends with one step whose routing
   is captured and replayed: the same routing, loss and gradient norm.
20. observability and fault tolerance: serve_traced (after recipe_serve,
   on its checkpoint): the `llm_serve` CLI again with
   `serving.observability` on and a `torch.profiler` window of steps 8-10:
   the generations equal to the untraced run's, the Chrome trace valid,
   the TTFT attribution's phases summing to its median TTFT, `metrics.prom`
   with the catalog's engine series and `serve_steps_total` equal to the
   steps run, K4 on all 32 layers of each step in the window; then the
   run traced without the window and untraced again, token-equal (runs in
   the order untraced, traced with the window, traced, untraced); the four
   runs' ITL / TTFT, the window's start and stop ms, the events and
   `ServingEngine.step_cost` / `step_efficiency` printed; serve_chaos: the
   same config with `resilience.faults: [{point: serve_step, step: 20,
   mode: crash}]` in a new process, which must die of the FaultCrash
   leaving the flight recorder's file, its last event at step 20;
   train_resilient (after train_chat_sft): `llm_finetune` at Llama-3.2-1B's
   widths, uncut, seq 4096, 12 steps, the checkpointer on (async),
   `skip_nonfinite_updates` (the update selected on the card, under the
   guard), `resilience` with snapshots every 4 steps, the spike and
   nonfinite detectors, 3 retry attempts, the transfer guard, and faults
   (two transient checkpoint writes, NaN params before step 6, a SIGTERM
   at step 11), a profiling window: one rollback, to step 4, restoring the
   state bitwise equal to a copy on the card of the state snapshotted, and
   the step after it bit-equal to the same step run again from that copy;
   two retries in `training.jsonl`; the emergency checkpoint committed
   within the grace; a new process resumes from it and runs step 12; the
   snapshot's bytes and ms, the restore's ms and the step's ms with and
   without the guard printed.
21. the heterogeneous MoE engine and Gemma-4 MoE (after train_gemma3_ckpt):
   smoke_het: the Step-3.5, MiMo-V2-Flash, MiniMax-M3 and Gemma-4 smoke
   YAMLs as smoke_families (`--distributed.ep=1`; MiniMax-M3's sparse
   layers launch nothing); train_mimo_check: MiMo-V2-Flash
   (`MIMO_V2_FLASH`, written from recall) at its widths cut to its first
   2 layers (global with a dense MLP, sliding with sinks and 256 routed
   experts), bf16, the parameter bytes reckoned before the draw: one
   forward and backward of `het_moe.forward` at 4096 tokens with K1-K3
   (at <192, 128>, G 16 and G 8, window 128, the sinks around K1-K3), with
   the plain attention and with the kernels and the sinks dropped (the
   control), the loss and the attention leaves' gradients held to bf16
   tolerances; generate_mimo: `generate()` (het_generate) on that cut, 4
   prompts of 512 tokens, 32 greedy tokens, its prefill logits held to
   the K1-K3 forward's, ms a decode step; train_gemma4: the training CLI at
   Gemma-4 26B-A4B's widths (`GEMMA4_26B_A4B`, from recall) cut to 2
   layers (sliding, global), 5 steps of 4096 tokens, K1-K3 at <256, 256>;
   train_gemma4_check: the 2 layers in fp32, one step with the kernels
   and with the plain attention. The flash phase times K1-K3 at MiMo's
   sliding heads and Gemma-4's beside their bounds.

The paged kernel phase also holds fp32 K6 and K7 at DeepSeek-V3's 128 and
Kimi-K2's 64 heads x r 512 to their plain versions, timed beside their
bound, and K6 and K7 on both routes at GLM-4.7-Flash's 20 heads (the bf16
split kernel's whole head tile of 16 and a partial one of 4); the kernel phase times K4 at Qwen3-30B-A3B's heads too, and at
G 7, 16 and 1 (Qwen2.5-7B's, GLM-4-9B's and Baichuan2-7B's heads; K5 at
GLM-4-9B's), and the flash phase K1-K3 at gpt-oss-20b's (64 / 8 heads of
64, window 128), with no mask at the encoder's heads (whose data a
causally masking kernel would fail) and at Qwen2.5-7B's.

Launch counts: each library's C dispatch counts the launches of every
device kernel it issues without error (`launch_counts()`, summed by kernel
in `kernel_launches()`); the main-path runs set every count to 0 just
before they start and read them just after, and the kernels line gives
those counts.

The build line carries ptxas's registers and spills of every kernel, and of
the tensor-core K1-K7 kernels by name with their dynamic shared memory.
Then it prints the `{"kernels": [...]}` line and, last, the
`{"ok": true, "device": {...}}` line. Any failed check raises and the exit
code is not 0. Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
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

from automodel_tpu_torch.checkpoint import (
    Checkpointer,
    DenseDecoderAdapter,
    HFCheckpointReader,
    save_hf_checkpoint,
)
from automodel_tpu_torch.cli.app import main as cli_main
from automodel_tpu_torch.cli.app import resolve_recipe_class
from automodel_tpu_torch.config import parse_args_and_load_config
from automodel_tpu_torch.datasets.loader import make_global_batch, stack_microbatches
from automodel_tpu_torch.datasets.mock import MockDatasetConfig, MockRetrievalDatasetConfig
from automodel_tpu_torch.inference.generate import GenerateConfig, generate
from automodel_tpu_torch.loss import fused_linear_cross_entropy
from automodel_tpu_torch.loss.utils import combine_losses
from automodel_tpu_torch.models.common.layers import count_params
from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.models.llm.families import gemma2_config, llama_config
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.moe_lm.families import deepseek_v3_moe_config
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.moe.layer import init_moe, moe_forward
from automodel_tpu_torch.ops import flash_attention as fa
from automodel_tpu_torch.ops import paged_attention as paged_ops
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
from automodel_tpu_torch.peft import (
    LoRAConfig,
    init_lora,
    merge_lora,
    merged_state_dict,
    quantize_base,
)
from automodel_tpu_torch.peft.lora import dequantize
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine
from automodel_tpu_torch.serving import engine as serving_engine
from automodel_tpu_torch.serving.kv_pages import pages_for
from automodel_tpu_torch.training import (
    TrainStepConfig,
    accumulate_grads,
    init_train_state,
    make_train_step,
)
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
# serve_mla: Moonlight cut 27 -> 9 layers (1 dense + 8 MoE) when the
# DeepSeek-V3 and Kimi-K2 serve phases came, and 9 -> 4 (1 dense + 3 MoE)
# when the GQA MoE ones came: the script ran past ~780 s each time, and
# those phases run the same MLA + MoE engine path at wider widths
MLA_SERVE_LAYERS = 4
# DeepSeek-V3 (https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/config.json)
# and Kimi-K2 (https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/config.json),
# as the model-configs catalog gives them: MLA at 128 and 64 heads (q rank
# 1536, kv rank 512), 256 and 384 routed experts, yarn rope (factor 40 and
# 32), DeepSeek-V3's one MTP layer; Kimi-K2 names DeepSeek-V3's architecture
DEEPSEEK_V3 = {
    "architectures": ["DeepseekV3ForCausalLM"], "vocab_size": 129280,
    "hidden_size": 7168, "intermediate_size": 18432,
    "moe_intermediate_size": 2048, "num_hidden_layers": 61,
    "num_attention_heads": 128, "num_key_value_heads": 128,
    "n_shared_experts": 1, "n_routed_experts": 256,
    "routed_scaling_factor": 2.5, "kv_lora_rank": 512, "q_lora_rank": 1536,
    "qk_rope_head_dim": 64, "qk_nope_head_dim": 128, "v_head_dim": 128,
    "n_group": 8, "topk_group": 4, "num_experts_per_tok": 8,
    "first_k_dense_replace": 3, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc",
    "rope_theta": 10000, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 163840, "num_nextn_predict_layers": 1,
    "tie_word_embeddings": False,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1,
                     "mscale_all_dim": 1, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
}
KIMI_K2 = {
    "architectures": ["DeepseekV3ForCausalLM"], "vocab_size": 163840,
    "hidden_size": 7168, "intermediate_size": 18432,
    "moe_intermediate_size": 2048, "num_hidden_layers": 61,
    "num_attention_heads": 64, "num_key_value_heads": 64,
    "n_shared_experts": 1, "n_routed_experts": 384,
    "routed_scaling_factor": 2.827, "kv_lora_rank": 512, "q_lora_rank": 1536,
    "qk_rope_head_dim": 64, "qk_nope_head_dim": 128, "v_head_dim": 128,
    "n_group": 1, "topk_group": 1, "num_experts_per_tok": 8,
    "first_k_dense_replace": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc",
    "rope_theta": 50000, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 131072, "num_nextn_predict_layers": 0,
    "tie_word_embeddings": False,
    "rope_scaling": {"beta_fast": 1, "beta_slow": 1, "factor": 32, "mscale": 1,
                     "mscale_all_dim": 1, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
}
# serve_dsv3: DeepSeek-V3 cut 61 -> 4 layers (3 dense + 1 MoE): 15.1 B
# parameters, 30.2 GB in bf16 (its 256 experts 11.3 B); serve_kimi_k2:
# Kimi-K2 cut 61 -> 2 layers (1 dense + 1 MoE): 19.9 B, 39.8 GB (its 384
# experts 16.9 B). Every layer of one MoE layer's model fits one card with
# its pools; all 61 do not. A served model carries no MTP head (training
# state the HF adapter does not map).
DSV3_SERVE_LAYERS, KIMI_SERVE_LAYERS = 4, 2
# the fp32 route of K6 / K7 at the many-head widths: heads, rank, rope dim
MANY_HEADS_MLA = {"deepseek_v3": (128, 512, 64), "kimi_k2": (64, 512, 64)}
# serve_gemma2: contexts to 8192 tokens (Gemma-2's max_position_embeddings)
# for 16 resident requests, and 512 rows per step (480 of one prefill
# chunk), so that the ~96k prompt tokens prefill in ~200 steps
SERVE_GEMMA2 = ServingConfig(
    page_size=16, num_pages=8192, max_slots=16, pages_per_slot=512,
    token_budget=512, prefill_chunk=480,
)
# ... whose prompts of 4200-7800 tokens are longer than the 4096 window;
# cut 26 -> 10 layers (5 windowed, 5 global) when the GQA MoE
# serve phases came: the script ran past ~780 s, and K4 / K5 take the same
# windows on every windowed layer; -> 6 (3 and 3) for the resilience phases
GEMMA2_SERVE_PROMPTS = (4200, 7800)
GEMMA2_SERVE_LAYERS = 6
# engine_window_phase: Gemma-2-2B widths, 2 layers, window 512, prompts
# longer than it
ENGINE_WINDOW, ENGINE_WINDOW_PROMPTS = 512, (900, 700, 600)
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
# K4 and K5 with windows and sinks (window_kernels_phase): case, heads
# (Hq, Hkv, D), decode contexts (`window_rows`), window (0: none), soft cap,
# sinks, timed. Every row's position exceeds its window, so the window masks.
# An output over thousands of kv rows is small (about 0.02 at Gemma-2-2B's
# heads), so these cases hold the error to PAGED_TOL times the plain
# result's own largest value and root mean square (no floor of 1), and
# require the plain version without the window, and without the sinks, to
# lie more than 3 x PAGED_TOL from it: a kernel that ignores either fails.
WINDOW_KERNEL_CASES = (
    # gpt-oss-20b's attention (openai/gpt-oss-20b config.json: 64 q / 8 kv
    # heads of 64; window 128 on its sliding layers; one sink per head)
    ("gpt_oss_20b_window_sinks", (64, 8, 64), (600, 1000), 128, None, True, False),
    # a window of no multiple of the page (16) or of the split (128), at
    # Gemma-3-1B's heads (4 q / 1 kv of 256)
    ("gemma3_window_1000", (4, 1, 256), (1100, 2000), 1000, None, False, False),
    # Gemma-2-2B's heads (8 q / 4 kv of 256, cap 50) at positions of ~8000:
    # its sliding layers' window 4096, and its global layers
    ("gemma2_2b_window_4096", (8, 4, 256), (7800, 8192), 4096, 50.0, False, True),
    ("gemma2_2b_global", (8, 4, 256), (7800, 8192), 0, 50.0, False, True),
)
# the flash attention kernels and the paged-attention ones
FLASH, PAGED = ("K1", "K2", "K3"), ("K4", "K5", "K6", "K7")
# each paged kernel's device kernels on the bf16 route, which the libraries'
# C dispatch counts (K6 and K7 share the combine)
PAGED_DEVICE_KERNELS = {
    "K4": rpa_cuda.KERNELS["K4"]["mma"], "K5": rpa_cuda.KERNELS["K5"]["mma"],
    "K6": mla_cuda.KERNELS["K6"]["mma"], "K7": mla_cuda.KERNELS["K7"]["mma"],
}


def reset_counts() -> None:
    """Sets every kernel library's launch counts to 0."""
    for lib in (fa_cuda, rpa_cuda, mla_cuda):
        lib.reset_launch_counts()


def kernel_launches(*names) -> dict:
    """The launches of K1-K7 (or of `names`) since the counts were last set
    to 0, as the libraries' C dispatch counts them: each call's first device
    kernel on its route, K1-K3 at every head-dim pair."""
    counts = {**fa_cuda.kernel_launches(), **rpa_cuda.kernel_launches(),
              **mla_cuda.kernel_launches()}
    return {k: counts[k] for k in names or counts}


def paged_counts(keys) -> dict:
    """The launches so far of the paged kernels' device kernels `keys`
    (`KERNELS` names), as their library's C dispatch counts them."""
    counts = {**rpa_cuda.launch_counts(), **mla_cuda.launch_counts()}
    return {k: counts[k] for k in keys}

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
# gpt-oss-20b's attention on a sliding layer (64 q / 8 kv heads of 64, window
# 128; its sinks are applied in torch, outside K1-K3) at 4096 tokens
FA_GPT_OSS_SHAPE = dict(B=1, S=4096, Hq=64, Hkv=8, D=64, Dv=64)
FA_GPT_OSS_MASKS = dict(window=128)
# MiMo-V2-Flash's sliding layers (q/k 192, v 128, 64 q / 8 kv heads: G 8,
# window 128; the sinks rescale K1's output in torch, outside the kernels)
# and Gemma-4 26B-A4B's sliding layers (16 / 8 heads of 256, window 1024, at
# the query_pre_attn_scalar 256 scale)
FA_MIMO_SWA_SHAPE = dict(B=1, S=4096, Hq=64, Hkv=8, D=192, Dv=128)
FA_MIMO_SWA_MASKS = dict(window=128)
FA_GEMMA4_SHAPE = dict(B=1, S=4096, Hq=16, Hkv=8, D=256, Dv=256)
FA_GEMMA4_MASKS = dict(window=1024, scale=256 ** -0.5)
# Mistral-7B's heads (32/8, D 128); its own window is 4096, here 1024 so that
# the window masks at 4096 tokens, where the plain versions' (B, H, S, T)
# fp32 intermediates still fit beside the kernels' inputs
FA_MISTRAL_MASKS = dict(window=1024)
# K1-K3 at head dims with no instantiation of their own, run padded through
# `kernels_forward` / `kernels_backward`: head dim 8 (-> 16) at the smoke
# YAMLs' shapes (qwen3_moe_ep: 8 x 256 tokens, 8 / 4 heads; gpt_oss: 8 x 32
# tokens, 4 / 2 heads, window 16), then 32 (-> 64), 96 (-> 128) and (64, 96)
# (-> (128, 128)) at 1024 tokens and 8 / 4 heads; each in bf16 and fp32
FA_PADDED_CASES = (
    (dict(B=8, S=256, Hq=8, Hkv=4, D=8, Dv=8), {}),
    (dict(B=8, S=32, Hq=4, Hkv=2, D=8, Dv=8), dict(window=16)),
    (dict(B=1, S=1024, Hq=8, Hkv=4, D=32, Dv=32), {}),
    (dict(B=1, S=1024, Hq=8, Hkv=4, D=96, Dv=96), {}),
    (dict(B=1, S=1024, Hq=8, Hkv=4, D=64, Dv=96), {}),
)

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
# the <192, 128> instantiations of K1-K3 in the profiler's kernel names (for
# their device time; their launches come from the library's counters)
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
# train_gemma3_ckpt: train_gemma3 with the checkpointer on, a save every
# CKPT_EVERY steps; the run resumed from that save in a new process must
# give the unbroken run's losses and grad norms within this relative
# tolerance (the same state and batches; the backward's atomic sums may
# take another order, which moves fp32 grad norms by ~1e-7); then the
# llm_serve recipe on its HF export with prompts of this many tokens
CKPT_EVERY, CKPT_RESUME_RTOL, CKPT_SERVE_PROMPT_LEN = 3, 1e-6, 900
# ... cut to this many of Gemma-3-1B's 26 layers (one whole pattern of 5
# sliding and 1 global; 12 before the observability and resilience phases
# needed the time). The script keeps what it writes to disk, files deleted again
# included, under 45 GiB: beside the 16.06 GB Llama-3-8B checkpoint the
# full-depth phase's two 12.0 GB saves, 4.0 GB export and the resumed
# run's 12.0 GB save passed that; 12 layers wrote two 7.5 GB saves and a
# 2.5 GB export, and the resumed run saves nothing
CKPT_GEMMA3_LAYERS = 6
# train_gemma_check: Gemma-2-2B widths, 2 layers (one sliding, one global),
# fp32, 2 microbatches of this many tokens, a window that masks
GEMMA_CHECK_SEQ, GEMMA_CHECK_WINDOW = 2048, 512
# train_lora / train_qlora: examples/llm_finetune/llama_lora.yaml (its peft
# section: r 16, alpha 32 on q/k/v/o; its optimizer and schedule) on
# Llama-3-8B at its published config, nothing cut: 32 layers, sequences of
# 4096 tokens, bf16 over the fp32 base, full remat; the base read from the
# recipe_serve phase's checkpoint at model.pretrained_path; microbatch 1,
# 2 accumulation steps; validation on 2 mock samples of 4096 tokens every 3
# steps with the sampling eval below; a PEFT-only checkpoint every 3 steps
LORA_YAML = "examples/llm_finetune/llama_lora.yaml"
LORA_STEPS, LORA_ACCUM, LORA_SEQ, LORA_EVERY, LORA_VAL_SAMPLES = 6, 2, 4096, 3, 2
LORA_VAL_GENERATION = {"prompt_len": 16, "max_new_tokens": 32, "max_batches": 1}
QLORA_STEPS = 3
# the adapters' parameters: 32 layers x r 16 x (in + out) of q, k, v, o
LORA_TRAINABLE = 32 * 16 * ((4096 + 4096) * 2 + (4096 + 1024) * 2)
# K1-K3 at Llama-3-8B's heads in the profiler's kernel names
DENSE_FA_KERNELS = {"K1": r"fwd_mma_kernel<128,\s*128,", "K2": r"dq_mma_kernel<128,\s*128,",
                    "K3": r"dkv_mma_kernel<128,\s*128,"}
# train_dsv3_mtp: DeepSeek-V3's published widths with yarn and the MTP head,
# cut 61 -> 2 layers: the dense prefix, as one MoE layer's fp32 masters,
# gradients and AdamW moments (~180 GB) do not fit; 2 layers plus the MTP
# head are 3.71 B parameters, ~59 GB of that state. Sequences of 2048
# tokens, microbatch 1, 5 steps, bf16 over fp32 masters, full remat
DSV3_MTP_LAYERS, DSV3_MTP_SEQ, DSV3_MTP_STEPS = 2, 2048, 5
# train_moe_capacity: train_moe's YAML with the capacity dispatcher
CAPACITY_STEPS = 3
# generate_check: 2 layers at full width in fp32, 8 prompts of these
# lengths, GEN_NEW greedy tokens each
GEN_PROMPTS = tuple(int(x) for x in np.linspace(64, 512, 8))
GEN_NEW = 32


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


def k4_inputs(dtype, seed: int = 0, heads=(32, 8, 128)):
    """A serve step's K4 call (`step_rows`) at `heads` (Hq, Hkv, D):
    Llama-3-8B's attention shapes by default."""
    pt, pos, N, ps = step_rows(seed)
    Hq, Hkv, D = heads
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(64, Hq, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(N + 1, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(N + 1, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    return q, kp, vp, pt, pos


def paged_bound(pt, pos, ps: int, page_bytes: int, io_bytes: int,
                ops_per_kv: int, dtype, window: int = 0):
    """Least time of one paged-attention call: the larger of (bytes it must
    move over HBM bandwidth) and (operations over the peak rate of the
    query dtype). Bytes: every distinct page any live row needs, once
    (`page_bytes` each, scales included; with a `window`, only the pages
    that meet the row's window), plus `io_bytes` (queries, output) and the
    page tables and positions. Operations: `ops_per_kv` for each kv index
    each live row attends to."""
    pos_h = pos.cpu().numpy()
    pt_h = pt.cpu().numpy()
    pages = set()
    for p, row in zip(pos_h, pt_h):
        if p >= 0:
            lo = max(int(p) - window + 1, 0) if window else 0
            pages.update(int(x) for x in row[lo // ps: p // ps + 1])
    nbytes = len(pages) * page_bytes + io_bytes + pt.numel() * 4 + pos.numel() * 4
    ops = sum(min(int(p) + 1, window or int(p) + 1) for p in pos_h if p >= 0) * ops_per_kv
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
    rows 0, at Llama-3-8B's heads and (bf16) at Qwen3-30B-A3B's (32 q / 4 kv
    of 128: G 8) and the dense families' K4_GROUP_HEADS (G 7, 16 and 1);
    returns the bf16 (main-path dtype) entries for the kernels line, keyed
    by model."""
    checks = {}
    cases = [("llama3_8b", (32, 8, 128), torch.bfloat16),
             ("llama3_8b", (32, 8, 128), torch.float32),
             ("qwen3_moe", (32, 4, 128), torch.bfloat16)]
    cases += [(model, heads, torch.bfloat16) for model, heads in K4_GROUP_HEADS.items()]
    for model, heads, dtype in cases:
        q, kp, vp, pt, pos = k4_inputs(dtype, heads=heads)
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
            "model": model, "heads": list(heads),
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
        if dtype == torch.bfloat16:
            checks[model] = entry
    return checks


def int8_pages(gen, *shape):
    """Random int8 pages and (N+1, ps) fp32 per-row scales on the card."""
    pages = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
    scales = 0.002 + 0.03 * torch.rand(shape[:2], generator=gen, device="cuda")
    return pages, scales


def k5_case(dtype, seed: int = 0, heads=(32, 8, 128)):
    """K5 at `heads` (Hq, Hkv, D; Llama-3-8B's by default) over int8 pages."""
    pt, pos, N, ps = step_rows(seed)
    Hq, Hkv, D = heads
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


def k67_case(dtype, quant: bool, seed: int = 0, widths=MOONLIGHT_MLA,
             scale: float = (128 + 64) ** -0.5):
    """K6 (fp pages) or K7 (int8 pages) at `widths` (heads, latent rank,
    rope dim; Moonlight's n 16, r 512, dr 64 by default), at `scale`
    (Moonlight's (128 + 64)^-0.5 by default)."""
    pt, pos, N, ps = step_rows(seed)
    n, r, dr = widths
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q_abs = torch.randn(64, n, r, generator=gen, device="cuda").to(dtype)
    q_rope = torch.randn(64, n, dr, generator=gen, device="cuda").to(dtype)
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
    flush) beside their bound; then fp32 K6 and K7 at DeepSeek-V3's 128 and
    Kimi-K2's 64 heads x r 512, whose rows the fp32 route splits into head
    tiles of several blocks, bf16 K5 at GLM-4-9B's heads (G 16), and K6 and
    K7 at GLM-4.7-Flash's 20 heads x r 512 on both routes (the bf16 split
    kernel's whole head tile of 16 and a partial one of 4). Returns the
    bf16 entries for the kernels line (those as "K5_glm4_9b",
    "K6_glm47_flash" and "K7_glm47_flash", the latter two with their fp32
    entry under "fp32"), each K6 / K7 entry with its fp32 many-head entries
    under "fp32_many_heads"."""
    cases = {
        "K5": lambda dtype: k5_case(dtype),
        "K6": lambda dtype: k67_case(dtype, quant=False),
        "K7": lambda dtype: k67_case(dtype, quant=True),
    }
    runs = [(name, make, dtype, None) for name, make in cases.items()
            for dtype in (torch.bfloat16, torch.float32)]
    runs += [(name, (lambda dtype, q=quant, w=widths: k67_case(dtype, q, widths=w)),
              torch.float32, model)
             for model, widths in MANY_HEADS_MLA.items()
             for name, quant in (("K6", False), ("K7", True))]
    runs.append(("K5", lambda dtype: k5_case(dtype, heads=K4_GROUP_HEADS["glm4_9b"]),
                 torch.bfloat16, "glm4_9b"))
    runs += [(name, (lambda dtype, q=quant: k67_case(dtype, q, widths=GLM47_MLA,
                                                     scale=(192 + 64) ** -0.5)),
              dtype, "glm47_flash")
             for name, quant in (("K6", False), ("K7", True))
             for dtype in (torch.bfloat16, torch.float32)]
    out = {}
    for name, make, dtype, model in runs:
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
        if model in MANY_HEADS_MLA:
            n, r, _ = MANY_HEADS_MLA[model]
            entry.update(model=model, heads=n, rank=r,
                         blocks_per_row=-(-n // mla_cuda.head_tile(n, r)))
        elif model == "glm47_flash":
            n, r, _ = GLM47_MLA
            entry.update(model=model, heads=n, rank=r, route=mla_cuda.route(dtype),
                         head_tiles=(-(-n // 16) if dtype == torch.bfloat16
                                     else -(-n // mla_cuda.head_tile(n, r))))
        elif model is not None:
            entry.update(model=model, heads=list(K4_GROUP_HEADS[model]))
        emit({"phase": "kernel", "kernel": name, **entry})
        if not (err <= tol * max(1.0, ref_max) and pad_zero):
            raise AssertionError(f"{name} disagrees with its plain version: {entry}")
        if model in MANY_HEADS_MLA:
            out[name].setdefault("fp32_many_heads", []).append(entry)
        elif model == "glm47_flash" and dtype == torch.float32:
            out[f"{name}_{model}"]["fp32"] = entry
        elif model is not None:
            out[f"{name}_{model}"] = entry
        elif dtype == torch.bfloat16:
            out[name] = entry
        del got, want
        torch.cuda.empty_cache()
    return out


def window_rows(ctx_lo: int, ctx_hi: int, ps: int, seed: int = 0):
    """The rows of one serve step over long contexts: T=64 (12 decode rows of
    12 requests with contexts in [ctx_lo, ctx_hi], one request's 48-row
    prefill chunk ending at ctx_hi, 4 pad rows), pages in permuted order,
    tables as wide as ctx_hi, padded with the trash page. Returns
    (page_tables, positions, N) on the card."""
    rng = np.random.default_rng(seed)
    P = pages_for(ctx_hi, ps)
    ctx = [int(c) for c in rng.integers(ctx_lo, ctx_hi + 1, 12)] + [ctx_hi]
    N = sum(pages_for(c, ps) for c in ctx)
    perm = iter(rng.permutation(N))
    tables = []
    for c in ctx:
        pages = [int(next(perm)) for _ in range(pages_for(c, ps))]
        tables.append(pages + [N] * (P - len(pages)))
    rows_pt = tables[:12] + [tables[12]] * 48 + [tables[0]] * 4
    rows_pos = [c - 1 for c in ctx[:12]] + list(range(ctx_hi - 48, ctx_hi)) + [-1] * 4
    return (torch.tensor(rows_pt, dtype=torch.int32, device="cuda"),
            torch.tensor(rows_pos, dtype=torch.int32, device="cuda"), N)


def k45_window_case(kernel: str, dtype, heads, ctx, window: int, soft_cap,
                    sinks: bool, seed: int = 0):
    """K4 (pages of the query dtype) or K5 (int8 pages) on `window_rows(*ctx)`
    at heads (Hq, Hkv, D), with a window (0: none), a soft cap and sink
    logits or not: (kernel call, plain call, positions, bound). The plain
    call takes keyword overrides (`window=None`, `sinks=None`)."""
    Hq, Hkv, D = heads
    ps = 16
    pt, pos, N = window_rows(*ctx, ps, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(64, Hq, D, generator=gen, device="cuda").to(dtype)
    sink = torch.randn(Hq, generator=gen, device="cuda") + 3.0 if sinks else None
    kw = dict(scale=D ** -0.5, soft_cap=soft_cap, window=window or None, sinks=sink)
    elt = q.element_size()
    io, ops = 2 * q.numel() * elt, Hq * 4 * D
    if kernel == "K5":
        kp, ks = int8_pages(gen, N + 1, ps, Hkv, D)
        vp, vs = int8_pages(gen, N + 1, ps, Hkv, D)
        bound = paged_bound(pt, pos, ps, ps * Hkv * 2 * D + 2 * ps * 4, io, ops,
                            dtype, window)
        return (
            lambda: ragged_paged_attention_quant_cuda(q, kp, vp, ks, vs, pt, pos, **kw),
            lambda **o: ragged_paged_attention_ref(q, kp, vp, pt, pos, k_scales=ks,
                                                   v_scales=vs, **{**kw, **o}),
            pos, bound,
        )
    kp = torch.randn(N + 1, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(N + 1, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    bound = paged_bound(pt, pos, ps, ps * Hkv * 2 * D * elt, io, ops, dtype, window)
    return (
        lambda: ragged_paged_attention_cuda(q, kp, vp, pt, pos, **kw),
        lambda **o: ragged_paged_attention_ref(q, kp, vp, pt, pos, **{**kw, **o}),
        pos, bound,
    )


def window_kernels_phase(flush) -> dict:
    """K4 and K5 with sliding windows and sinks against their plain versions
    in bf16 (split-KV on the tensor cores) and fp32 (CUDA cores), on
    `WINDOW_KERNEL_CASES`; the timed cases are timed (median of 10 launches,
    each after an L2 flush) beside their bound over the pages that meet
    each row's window. The tolerance is stated at WINDOW_KERNEL_CASES.
    Returns {(kernel, case): bf16 entry} of the timed cases."""
    out = {}
    for case, heads, ctx, window, cap, sinks, timed in WINDOW_KERNEL_CASES:
        if window:  # every row's window masks
            assert ctx[0] > window, case
        for kernel in ("K4", "K5"):
            for dtype in (torch.bfloat16, torch.float32):
                fn, plain, pos, bound = k45_window_case(kernel, dtype, heads, ctx,
                                                        window, cap, sinks)
                got = fn()
                torch.cuda.synchronize()
                want = plain()
                diff = got.float() - want.float()
                err = diff.abs().max().item()
                ref_max = want.float().abs().max().item()
                ref_norm = want.float().norm().item()
                rel_rms = diff.norm().item() / ref_norm
                # how far off a kernel that ignored the window / the sinks is
                off = {knob: (plain(**{knob: None}).float() - want.float()).norm().item()
                       / ref_norm for knob, on in (("window", window), ("sinks", sinks))
                       if on}
                pad_zero = bool((got[pos < 0] == 0).all().item())
                tol = PAGED_TOL[dtype]
                bound_ms, bound_by, nbytes, ops = bound
                entry = {
                    "case": case, "heads": list(heads), "contexts": list(ctx),
                    "window": window, "soft_cap": cap, "sinks": sinks,
                    "dtype": str(dtype).removeprefix("torch."),
                    "route": rpa_cuda.route(dtype), "max_abs_err": err,
                    "ref_max": ref_max, "rel_rms_err": rel_rms,
                    "ref_rms": ref_norm / want.numel() ** 0.5,
                    "rel_rms_without": off, "tol": tol, "pad_rows_zero": pad_zero,
                    "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                    "operations": ops,
                }
                del diff
                del got, want
                if timed:
                    entry["ms"] = time_ms(fn, 10, flush)
                    entry["plain_ms"] = time_ms(plain, 3, flush)
                emit({"phase": "kernel_window", "kernel": kernel, **entry})
                if not (err <= tol * ref_max and rel_rms <= tol and pad_zero):
                    raise AssertionError(
                        f"{kernel} with a window / sinks disagrees with its plain "
                        f"version: {entry}")
                if any(v <= 3 * tol for v in off.values()):
                    raise AssertionError(
                        f"{case}: the window / sinks barely move the plain version, "
                        f"so the check cannot see a kernel ignore them: {entry}")
                if timed and dtype == torch.bfloat16:
                    out[(kernel, case)] = entry
                del fn, plain
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
    # the head dims K1-K3 run at: a pair that is not instantiated goes
    # through the autograd function's padding (`kernels_forward` and
    # `kernels_backward`) at the caller's scale
    dims = fa_cuda.padded_head_dims(D, sh["Dv"])
    if cap is not None:
        # the unit-variance logits (at scale D^-0.5) spread over a quarter of
        # the cap, so the largest reach it and the cap bends them: a kernel
        # that dropped the cap or its gradient fails the check by far
        q = (q.float() * (cap / 4)).to(dtype)
    mkw, mask = fa_masks(B, S, T, seg, masks)
    if masks.get("window"):  # the window masks pairs the causal mask keeps
        assert masks["window"] < S
    kw = dict(scale=scale, soft_cap=cap, **mkw)
    padded = dims != (D, sh["Dv"])
    if padded:
        pkw = dict(scale=scale, soft_cap=cap, masks=fa_cuda.mask_args(q, k, **mkw))
        out, lse = fa.kernels_forward(q, k, v, **pkw)
    else:
        out, lse = fa_cuda.flash_fwd_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    out_ref, lse_ref = fa.flash_attention_ref(q, k, v, mask, scale=scale, soft_cap=cap)
    delta = (dout.float() * out_ref.float()).sum(-1).transpose(1, 2).contiguous()
    if padded:
        dq, dk, dv = fa.kernels_backward(q, k, v, dout, lse_ref, delta, **pkw)
    else:
        dq = fa_cuda.flash_dq_cuda(q, k, v, dout, lse_ref, delta, **kw)
        dk, dv = fa_cuda.flash_dkv_cuda(q, k, v, dout, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    grads_ref = fa.flash_attention_bwd_ref(q, k, v, dout, lse_ref, delta, mask,
                                           scale=scale, soft_cap=cap)
    tol = FA_TOL[dtype]
    causal_gap = None
    if masks.get("causal") is False:
        # the data must be able to fail a kernel that masked causally: the
        # plain causal result lies more than 3 tolerances from this one
        _, causal_mask = fa_masks(B, S, T, seg, dict(masks, causal=True))
        out_causal, _ = fa.flash_attention_ref(q, k, v, causal_mask, scale=scale,
                                               soft_cap=cap)
        causal_gap = (out_causal.float() - out_ref.float()).abs().max().item()
        del out_causal, causal_mask
        limit = 3 * tol * max(1.0, out_ref.float().abs().max().item())
        if not causal_gap > limit:
            raise AssertionError(f"K1-K3 non-causal case: the causal result is only "
                                 f"{causal_gap} from it (<= {limit})")
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
                f"S={S}, T={T}, D={D}, Dv={sh['Dv']} run at {dims}, packed={packed}, "
                f"masks={masks}, soft_cap={cap}): {err} > {tol} x {max(1.0, ref_max)}")
    pairs = int(mask.sum().item())  # unmasked (q, k) pairs per head
    entry = {"phase": "flash", "dtype": str(dtype).removeprefix("torch."),
             "route": fa_cuda.route(dtype), "shape": dict(sh, T=T),
             "kernel_head_dims": list(dims),
             "packed_segments": packed, "masks": masks, "soft_cap": cap,
             "q_scaled_by": None if cap is None else cap / 4,
             "scale": scale, "unmasked_pairs_per_head": pairs,
             "causal_pairs_per_head": S * (S + 1) // 2, "tol": tol, "errors": errs,
             "causal_control_max_abs_gap": causal_gap}
    if timed:
        assert not padded, "the timed cases run at instantiated head dims"
        del grads_ref, out_ref
        # the yardstick: the causal call for the causal cases with no other
        # mask, no mask for the non-causal ones with none, an explicit
        # boolean mask for the others (windows, segments, positions)
        if seg is None and not masks:
            sdpa_kw, note = {"is_causal": True}, "is_causal"
        elif seg is None and masks == {"causal": False}:
            sdpa_kw, note = {}, "no mask"
        else:
            sdpa_kw, note = {"attn_mask": mask[:, None]}, "an explicit boolean mask"
        entry["times"] = fa_times(q, k, v, dout, lse, delta, kw, mask, pairs,
                                  flush, sdpa_kw, note)
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


def fa_times(q, k, v, dout, lse, delta, kw, mask, pairs, flush, sdpa_kw: dict,
             mask_note: str) -> dict:
    """K1-K3's times with the wrapper keywords `kw`, the plain versions' on
    `mask`, and scaled_dot_product_attention's with the keywords `sdpa_kw`
    (its mask, `mask_note` says which; never soft-capped)."""
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
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, scale=scale, **sdpa_kw)
    sdpa_fwd = time_ms(sdpa, 10, flush)
    o = sdpa()
    dot = dout.transpose(1, 2)
    sdpa_grad = lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)
    sdpa_bwd = time_ms(sdpa_grad, 10, flush)
    backends = {"forward": sdpa_backend(sdpa), "backward": sdpa_backend(sdpa_grad)}
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
    window, gpt-oss-20b's heads with its 128-token window; Gemma-2's heads
    in fp32 at train_gemma_check's length; and FA_PADDED_CASES, the head
    dims K1-K3 run padded, in bf16 and fp32; no mask at all at
    the bidirectional encoder's heads (bf16 timed, and fp32) and the causal
    Qwen2.5-7B heads (G 7, timed); MiMo-V2-Flash's sliding heads (q/k
    192, v 128, G 8, window 128) and Gemma-4 26B-A4B's (G 2 x 256, window
    1024, scale 256^-0.5), timed. Returns the timed bf16 entries for the
    kernels line, keyed "dense", "mla", "encoder", "qwen25_7b", "gemma2",
    "gemma3", "gpt_oss", "mimo_swa", "gemma4" and the other windowed cases'
    names."""
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
    # the bidirectional encoder: no mask at all (code 0, no window), the
    # bi-encoder step's 2 x 64 rows of 512 tokens; Qwen2.5-7B's causal G 7
    out["encoder"] = fa_entries(fa_check_case(
        torch.bfloat16, FA_ENCODER_SHAPE["S"], False, flush, timed=True,
        shape=FA_ENCODER_SHAPE, masks={"causal": False}))
    fa_check_case(torch.float32, FA_ENCODER_SHAPE["S"], False, flush, timed=False,
                  shape=FA_ENCODER_SHAPE, masks={"causal": False}, B=8)
    torch.cuda.empty_cache()
    out["qwen25_7b"] = fa_entries(fa_check_case(
        torch.bfloat16, FA_QWEN25_SHAPE["S"], False, flush, timed=True,
        shape=FA_QWEN25_SHAPE))
    torch.cuda.empty_cache()
    g2, g3 = FA_GEMMA2_SHAPE, FA_GEMMA3_SHAPE
    windowed = {
        "gemma2": (g2["S"], False, g2, FA_GEMMA2_MASKS),
        "gemma3": (g3["S"], False, g3, FA_GEMMA3_MASKS),
        "gemma2_packed_window": (4096, True, g2, dict(FA_GEMMA2_MASKS, window=1024)),
        "two_sided_window": (4096, False, g2, dict(window=512, causal=False,
                                                   scale=256 ** -0.5)),
        "position_causal_ring": (4096, False, g2, dict(ring=True, scale=256 ** -0.5)),
        "mistral_window": (4096, False, FA_SHAPE, FA_MISTRAL_MASKS),
        "gpt_oss": (4096, False, FA_GPT_OSS_SHAPE, FA_GPT_OSS_MASKS),
        "mimo_swa": (4096, False, FA_MIMO_SWA_SHAPE, FA_MIMO_SWA_MASKS),
        "gemma4": (4096, False, FA_GEMMA4_SHAPE, FA_GEMMA4_MASKS),
    }
    for name, (s_len, packed, shape, masks) in windowed.items():
        out[name] = fa_entries(fa_check_case(torch.bfloat16, s_len, packed, flush,
                                             timed=True, shape=shape, masks=masks))
        torch.cuda.empty_cache()
    fa_check_case(torch.float32, GEMMA_CHECK_SEQ, False, flush, timed=False, shape=g2,
                  masks=dict(FA_GEMMA2_MASKS, window=GEMMA_CHECK_WINDOW))
    fa_check_case(torch.float32, 2048, False, flush, timed=False, shape=g2,
                  masks=dict(ring=True, window=700, scale=256 ** -0.5))
    for shape, masks in FA_PADDED_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            fa_check_case(dtype, shape["S"], False, flush, timed=False, shape=shape,
                          masks=masks)
    torch.cuda.empty_cache()
    return out


def serve_traffic(vocab_size: int, seed: int = 0, lens=(64, 900)) -> list:
    """16 requests of `lens` (64-900) prompt tokens arriving every 2 steps,
    32 greedy tokens each."""
    rng = np.random.default_rng(seed)
    return [
        Request(
            prompt=[int(t) for t in rng.integers(1, vocab_size, (int(n),))],
            max_new_tokens=32, arrival=2 * i,
        )
        for i, n in enumerate(rng.integers(lens[0], lens[1] + 1, 16))
    ]


@contextlib.contextmanager
def plain_calls_counted():
    """Within the block, the paged attention dispatchers' calls of the
    plain versions are counted into the yielded dict (a route check: on
    the card's main path they must stay 0)."""
    counts = {}
    saved = {}
    for name in ("ragged_paged_attention_ref", "ragged_paged_mla_attention_ref"):
        fn = saved[name] = getattr(paged_ops, name)
        counts[name] = 0

        def counted(*args, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*args, **kw)

        setattr(paged_ops, name, counted)
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(paged_ops, name, fn)


def serve_run(engine, cfg, card: str, phase: str, model: str, kernel: str,
              setup_s: float, lens=(64, 900)) -> tuple[int, dict]:
    """One main-path run: `serve_batch` on `serve_traffic(lens)`, with every
    kernel's launch count set to 0 just before and read just after. Every
    layer of every step must have launched `kernel`, no other paged kernel,
    and no plain version. Returns (launches of `kernel`, the serve
    result)."""
    reqs = serve_traffic(cfg.vocab_size, lens=lens)
    torch.cuda.reset_peak_memory_stats()
    keys = PAGED_DEVICE_KERNELS[kernel]
    reset_counts()
    with plain_calls_counted() as plain_calls:
        res = engine.serve_batch(reqs)
    launches = kernel_launches(*PAGED)
    counted = paged_counts(keys)
    stats = res["stats"]
    emit({
        "phase": phase, "card": card, "model": model, "setup_s": setup_s,
        "kv_cache_dtype": engine.serve_cfg.kv_cache_dtype,
        "prompt_tokens": list(lens), "stats": stats, "launches": launches,
        "launches_per_step": launches[kernel] / stats["steps"],
        "device_kernel_launches_counted": counted,
        "plain_attention_calls": plain_calls,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    if any(plain_calls.values()):
        raise AssertionError(f"{phase}: the plain attention ran: {plain_calls}")
    if len(res["outputs"]) != 16 or any(len(o) != 32 for o in res["outputs"]):
        raise AssertionError(f"{phase}: not every request finished with 32 tokens")
    if any(not 0 <= t < cfg.vocab_size for o in res["outputs"] for t in o):
        raise AssertionError(f"{phase}: a generated token is outside the vocabulary")
    want = dict.fromkeys(PAGED, 0)
    want[kernel] = cfg.num_layers * stats["steps"]
    if launches != want or counted != dict.fromkeys(keys, want[kernel]):
        raise AssertionError(
            f"{phase}: paged kernels launched {launches} (device kernels counted "
            f"{counted}) in {stats['steps']} steps of {cfg.num_layers} layers; "
            f"expected {want}")
    return launches[kernel], res


def serve_phase(card: str) -> tuple[dict, tuple]:
    """The dense main path at Llama-3-8B width and depth, on the fp pool
    (K4) and then on the int8 pool (K5) with the same weights; returns the
    launches of K4 and K5, and (config, weights, the fp pool's tokens)."""
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
                  rpa_cuda.KERNELS["K4"][rpa_cuda.route(torch.bfloat16)],
                  n_steps=MOE_PROFILE_STEPS)
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
                  rpa_cuda.KERNELS["K5"][rpa_cuda.route(torch.bfloat16)],
                  n_steps=MOE_PROFILE_STEPS)
    del engine
    torch.cuda.empty_cache()
    # the weights and the fp pool's tokens go on to serve_fp8 / serve_int8w
    return {"K4": k4, "K5": k5}, (cfg, params, fp["outputs"])


def serve_mla_phase(card: str) -> dict:
    """The MLA + MoE main path: Moonlight-16B-A3B at full width cut to
    MLA_SERVE_LAYERS layers, bf16, random weights from seed 0, on the fp
    pool (K6) and then on the int8 pool (K7); returns the launches of K6
    and K7."""
    cfg = deepseek_v3_moe_config(dict(MOONLIGHT, num_hidden_layers=MLA_SERVE_LAYERS),
                                 dtype=torch.bfloat16)
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
                  mla_cuda.KERNELS["K6"][mla_cuda.route(torch.bfloat16)])
    del engine
    torch.cuda.empty_cache()
    engine = ServingEngine(params, cfg, dataclasses.replace(SERVE, kv_cache_dtype="int8"))
    launches["K7"], _ = serve_run(engine, cfg, card, "serve_mla_int8", model, "K7", 0.0)
    # bf16 queries: K7 is the split kernel and its combine
    profile_steps(engine, cfg, card, "serve_mla_int8",
                  mla_cuda.KERNELS["K7"][mla_cuda.route(torch.bfloat16)])
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


def recipe_serve_node(ckpt_dir: Path, run_dir: Path, vocab_size: int, **serving) -> dict:
    """The llm_serve config of recipe_serve: the checkpoint at `ckpt_dir`,
    16 mock prompts of RECIPE_PROMPT_LEN tokens, SERVE's geometry, 32 greedy
    tokens each; `serving` adds keys to the serving section."""
    geometry = {f.name: getattr(SERVE, f.name) for f in dataclasses.fields(SERVE)
                if f.name in ("page_size", "num_pages", "max_slots", "pages_per_slot",
                              "token_budget", "prefill_chunk")}
    return {
        "recipe": "llm_serve", "seed": 0, "run_dir": str(run_dir),
        "model": {"pretrained_path": str(ckpt_dir), "dtype": "bfloat16"},
        "dataset": {"_target_": "automodel_tpu_torch.datasets.mock.MockDatasetConfig",
                    "num_samples": 16, "seq_len": RECIPE_PROMPT_LEN,
                    "vocab_size": vocab_size},
        "dataloader": {"microbatch_size": 16, "grad_acc_steps": 1},
        "max_requests": 16,
        "serving": {**geometry, "max_new_tokens": 32, "temperature": 0.0,
                    "arrival_stride": 2, **serving},
    }


def recipe_serve_phase(card: str, ckpt_dir: Path) -> tuple[int, dict]:
    """The llm_serve recipe through the CLI on a Llama-3-8B checkpoint that
    the port writes first to `ckpt_dir` (kept for the LoRA phases); returns
    the recipe's launches of K4 and its generations and serve stats (the
    untraced run serve_traced is held to)."""
    cfg = llama_config(LLAMA3_8B, dtype=torch.bfloat16)
    params = decoder.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                          dtype=torch.bfloat16)
    hf = dict(LLAMA3_8B, architectures=["LlamaForCausalLM"], model_type="llama",
              torch_dtype="bfloat16")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        save_hf_checkpoint(DenseDecoderAdapter(cfg).to_hf(params), str(ckpt_dir),
                           hf_config=hf)
        write_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.iterdir())
        node = recipe_serve_node(ckpt_dir, tmp / "run", cfg.vocab_size)
        (tmp / "serve.yaml").write_text(json.dumps(node, indent=1))  # JSON is YAML
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        recipe = cli_main([str(tmp / "serve.yaml")])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = kernel_launches(*PAGED)
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
    want = dict.fromkeys(PAGED, 0)
    want["K4"] = cfg.num_layers * steps
    if launches != want:
        raise AssertionError(
            f"recipe_serve: paged kernels launched {launches} in {steps} steps "
            f"of {cfg.num_layers} layers; expected {want}")
    if [g["generated_ids"] for g in gens] != direct:
        raise AssertionError("recipe_serve: the recipe's tokens differ from serve_batch's")
    return launches["K4"], {"generated": direct, "stats": stats, "steps": steps}


# serve_traced: recipe_serve's run with serving.observability on, a
# torch.profiler window over these [start, steps]; serve_chaos: the same
# run in a new process with a crash injected at this serve step
SERVE_TRACE_WINDOW, SERVE_CHAOS_STEP = (8, 3), 20
# the engine series of the metric catalog (JAX observability/metrics.py)
ENGINE_SERIES = (
    "serve_steps_total", "serve_plan_tokens_total", "serve_plan_samples_total",
    "serve_step_ms", "serve_new_tokens_total", "serve_requests_total",
    "serve_preemptions_total", "serve_timed_out_total", "serve_cancelled_total",
    "serve_free_pages", "serve_compiled_signatures")


def serve_cli_run(tmp: Path, name: str, ckpt_dir: Path, **serving) -> tuple:
    """recipe_serve's CLI run under `tmp / name` with `serving` added to its
    serving section: (recipe, generated ids, serving.jsonl records, K1-K7
    launches, the run's ITL / TTFT p50 and p95 in ms)."""
    node = recipe_serve_node(ckpt_dir, tmp / name, LLAMA3_8B["vocab_size"], **serving)
    (tmp / f"{name}.yaml").write_text(json.dumps(node, indent=1))  # JSON is YAML
    reset_counts()
    recipe = cli_main([str(tmp / f"{name}.yaml")])
    torch.cuda.synchronize()
    launches = kernel_launches(*PAGED)
    gens = [json.loads(line)["generated_ids"]
            for line in (tmp / name / "generations.jsonl").open()]
    log = [json.loads(line) for line in (tmp / name / "serving.jsonl").open()]
    stats = next(r for r in reversed(log) if "serve_steps" in r)
    latency = {k: stats[f"serve_{k}"] for k in ("itl_p50_ms", "itl_p95_ms",
                                                 "ttft_p50_ms", "ttft_p95_ms")}
    return recipe, gens, log, launches, latency


def serve_traced_phase(card: str, ckpt_dir: Path, untraced: dict) -> int:
    """recipe_serve's CLI run again with `serving.observability` on (spans,
    lifecycle instants, counters, a profile window of SERVE_TRACE_WINDOW):
    the generations must equal the untraced run's, the Chrome trace pass
    `validate_chrome_trace`, the TTFT attribution's phases sum to its
    median TTFT, `metrics.prom` carry the catalog's engine series with
    `serve_steps_total` equal to the steps run, and K4 launch once a layer
    in each step of the window (counted by the library at the window's
    start and stop). Then the run traced without the window, and untraced
    again, each token-equal: with recipe_serve's run before, the order is
    untraced, traced with the window, traced, untraced, so the cost of
    tracing (traced against the untraced runs on both sides) stands apart
    from the window's, whose start and stop (the export) are timed where
    they run, inside the serve loop. Prints the four runs' ITL / TTFT, the
    window's ms, the events, and `ServingEngine.step_cost` with
    `step_efficiency` over the steps. Returns the traced run's K4
    launches."""
    from automodel_tpu_torch.observability import (
        ServeProfiler,
        card_peaks,
        step_efficiency,
        validate_chrome_trace,
    )
    from automodel_tpu_torch.observability.metrics import METRIC_CATALOG

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_traced_"))
    start, stop, run_step = ServeProfiler._start, ServeProfiler._stop, ServingEngine.run_step
    window, plans = {}, []

    def counted_start(self, step_idx, stop_at, why):
        window["start"] = (step_idx, kernel_launches("K4")["K4"])
        t0 = time.perf_counter()
        start(self, step_idx, stop_at, why)
        window["start_ms"] = (time.perf_counter() - t0) * 1e3

    def counted_stop(self):
        window["stop"] = (self._stop_at, kernel_launches("K4")["K4"])
        t0 = time.perf_counter()
        stop(self)
        window["stop_ms"] = (time.perf_counter() - t0) * 1e3

    def recorded(self, plan):
        plans.append(dataclasses.replace(plan))
        return run_step(self, plan)

    try:
        obs = {"enabled": True, "trace_path": str(tmp / "trace" / "serve"),
               "profile_window": list(SERVE_TRACE_WINDOW), "profile_dir": str(tmp / "prof")}
        ServeProfiler._start, ServeProfiler._stop = counted_start, counted_stop
        ServingEngine.run_step = recorded
        t0 = time.perf_counter()
        try:
            recipe, gens, serve_log, launches, windowed = serve_cli_run(
                tmp, "run", ckpt_dir, observability=obs)
        finally:
            ServeProfiler._start, ServeProfiler._stop = start, stop
            ServingEngine.run_step = run_step
        cli_s = time.perf_counter() - t0
        run = tmp / "run"
        attr = next(r for r in serve_log if r.get("metric") == "latency_attribution")
        trace = validate_chrome_trace(str(tmp / "trace" / "serve.trace.json"))
        prom = (run / "metrics.prom").read_text()
        engine = recipe.engine
        steps, n_layers = engine.steps_run, engine.cfg.num_layers
        events = len(engine.obs.tracer.events)
        spans = [e.dur for e in engine.obs.tracer.events if e.name == "step.run"]
        costs = [engine.step_cost(plan) for plan in plans]
        prof_path = engine.obs.profiler.trace_path
        peaks = card_peaks(torch.cuda.get_device_name(0), engine.cfg.dtype) or {}
        del recipe, engine
        gc.collect()
        torch.cuda.empty_cache()
        # the same run traced without the window, then untraced again
        again = {}
        for name, serving in (("traced", {"observability": {
                "enabled": True, "trace_path": str(tmp / "trace" / "again")}}),
                              ("untraced", {})):
            recipe, again_gens, _, again_launches, latency = serve_cli_run(
                tmp, name, ckpt_dir, **serving)
            again[name] = {"generated": again_gens, "launches": again_launches,
                           "steps": recipe.engine.steps_run, **latency}
            del recipe
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    eff = [step_efficiency(c, s, **peaks) for c, s in zip(costs, spans)]
    p50 = attr["ttft_p50"]
    phases_ms = sum(v for k, v in p50.items() if k.endswith("_ms") and k != "ttft_ms")
    catalog = {name: kind for name, kind, _ in METRIC_CATALOG}
    missing = [n for n in ENGINE_SERIES if f"# TYPE {n} {catalog[n]}\n" not in prom]
    (w0, k0), (w1, k1) = window.get("start", (None, 0)), window.get("stop", (None, 0))
    window_steps = (w1 - w0) if w0 is not None and w1 is not None else 0

    def median(key):
        return statistics.median(e[key] for e in eff if key in e)

    latency_keys = ("itl_p50_ms", "itl_p95_ms", "ttft_p50_ms", "ttft_p95_ms")
    runs = [{"run": "untraced (recipe_serve)", **{k: untraced["stats"][k] for k in latency_keys}},
            {"run": "traced, profile window", **windowed},
            {"run": "traced", **{k: again["traced"][k] for k in latency_keys}},
            {"run": "untraced", **{k: again["untraced"][k] for k in latency_keys}}]
    emit({
        "phase": "serve_traced", "card": card,
        "model": "Llama-3-8B widths, 32 layers, bf16, seed-0 weights (recipe_serve's)",
        "cli_s": cli_s, "steps": steps, "trace_events": events, "chrome_trace": trace,
        "runs_in_order": runs,
        "window_start_ms": window.get("start_ms"), "window_stop_ms": window.get("stop_ms"),
        "latency_attribution": {k: v for k, v in attr.items()
                                if k in ("requests", "with_first_token", "ttft_p50",
                                         "itl_mean")},
        "profile_window": list(SERVE_TRACE_WINDOW), "profile_trace": bool(prof_path),
        "window_k4_launches": k1 - k0, "window_steps": window_steps,
        "launches": launches,
        "launches_again": {name: r["launches"] for name, r in again.items()},
        "step_cost": {"flops_median": statistics.median(c["flops"] for c in costs),
                      "bytes_median": statistics.median(c["bytes_accessed"] for c in costs)},
        "step_efficiency": {"step_ms_median": median("step_ms"),
                            "achieved_gflops_per_s_median": median("achieved_gflops_per_s"),
                            "achieved_gbytes_per_s_median": median("achieved_gbytes_per_s"),
                            "mfu_median": median("mfu") if peaks else None,
                            "bw_util_median": median("bw_util") if peaks else None,
                            "bw_util_max": max(e.get("bw_util", 0) for e in eff)},
        "missing_engine_series": missing,
    })
    if gens != untraced["generated"]:
        raise AssertionError("serve_traced: tracing changed the generated tokens")
    for name, r in again.items():
        if r["generated"] != untraced["generated"]:
            raise AssertionError(f"serve_traced: the {name} run changed the generated tokens")
        want = dict.fromkeys(PAGED, 0)
        want["K4"] = n_layers * r["steps"]
        if r["launches"] != want:
            raise AssertionError(f"serve_traced: the {name} run launched {r['launches']}; "
                                 f"expected {want}")
    if trace["spans"] == 0 or trace["instants"] == 0:
        raise AssertionError(f"serve_traced: the trace holds {trace}")
    if abs(phases_ms - p50["ttft_ms"]) > 1e-6 * p50["ttft_ms"]:
        raise AssertionError(f"serve_traced: the TTFT phases sum to {phases_ms}, "
                             f"not the median TTFT {p50['ttft_ms']}")
    if missing or f"serve_steps_total {steps}\n" not in prom:
        raise AssertionError(f"serve_traced: metrics.prom lacks {missing} or "
                             f"serve_steps_total {steps}")
    if len(spans) != steps or len(plans) != steps:
        raise AssertionError(f"serve_traced: {len(spans)} step spans, {len(plans)} plans, "
                             f"{steps} steps")
    if not prof_path or window_steps != SERVE_TRACE_WINDOW[1] or \
            k1 - k0 != n_layers * window_steps:
        raise AssertionError(f"serve_traced: the profile window {window} launched "
                             f"{k1 - k0} K4 in {window_steps} steps of {n_layers} layers")
    want = dict.fromkeys(PAGED, 0)
    want["K4"] = n_layers * steps
    if launches != want:
        raise AssertionError(f"serve_traced: paged kernels launched {launches}; "
                             f"expected {want}")
    return launches["K4"]


def serve_chaos_phase(card: str, ckpt_dir: Path) -> None:
    """recipe_serve's config with observability on and
    `resilience.faults: [{point: serve_step, step: SERVE_CHAOS_STEP, mode:
    crash}]`, through `python -m automodel_tpu_torch` in a new process: the
    process must die of the injected FaultCrash, leaving the flight
    recorder's file, whose last event is of step SERVE_CHAOS_STEP, and no
    generations."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_chaos_"))
    try:
        flight = tmp / "flight.jsonl"
        node = recipe_serve_node(ckpt_dir, tmp / "run", LLAMA3_8B["vocab_size"],
                                 observability={"enabled": True,
                                                "flight_recorder_path": str(flight)})
        node["resilience"] = {"faults": [{"point": "serve_step", "step": SERVE_CHAOS_STEP,
                                          "mode": "crash"}]}
        (tmp / "serve.yaml").write_text(json.dumps(node, indent=1))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "automodel_tpu_torch", str(tmp / "serve.yaml")],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))
        wall = time.perf_counter() - t0
        lines = [json.loads(line) for line in flight.open()] if flight.exists() else []
        generations = (tmp / "run" / "generations.jsonl").exists()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    crash = f"FaultCrash: injected crash at serve_step (step={SERVE_CHAOS_STEP})"
    last = lines[-1] if len(lines) > 1 else {}
    emit({"phase": "serve_chaos", "card": card, "returncode": proc.returncode,
          "process_wall_s": wall, "crashed": crash in proc.stderr,
          "flight_header": lines[0] if lines else None, "flight_events": len(lines) - 1,
          "flight_last_event": last, "flight_max_step": max(
              (e["step"] for e in lines[1:]), default=None),
          "generations_written": generations})
    if proc.returncode == 0 or crash not in proc.stderr:
        raise AssertionError(f"serve_chaos: the child did not die of the injected crash "
                             f"(rc {proc.returncode}):\n{proc.stderr[-3000:]}")
    if not lines or lines[0].get("reason") != "crash" or last.get("step") != SERVE_CHAOS_STEP:
        raise AssertionError(f"serve_chaos: the flight recorder holds {lines[:1]} ... {last}")
    if generations:
        raise AssertionError("serve_chaos: the crashed run wrote generations")


# the runtime calls by which the host launches a kernel, as the profiler
# names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx")


def profile_steps(engine, cfg, card: str, phase: str,
                  kernel_keys: tuple[str, ...], lens=(64, 900),
                  n_steps: int = 10) -> None:
    """Where a serve step's time goes: the same traffic again, 30 + n_steps
    steps to reach a mix of prefill and decode, then `n_steps` under
    torch.profiler.
    Prints device busy time per step by kernel, the device's idle share of
    the window's wall time, the host's kernel launches per step and its
    operators with the most self time. `kernel_keys` name the attention
    kernel's device kernels (substrings of the profiler's names, as
    `KERNELS` gives them), whose device time the profiler gives and whose
    launches their library counts."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    sched = engine.make_scheduler()
    for r in serve_traffic(cfg.vocab_size, seed=1, lens=lens):
        sched.submit(r)
    for step in range(30):
        engine.run_one_step(sched, step)
    # n_steps unprofiled steps from step 30: the profiler's own host cost
    # inflates the profiled window's wall time, so the idle share is also
    # given against this window's (similar steps, no profiler)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(30, 30 + n_steps):
        engine.run_one_step(sched, step)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = 0
    before = paged_counts(kernel_keys)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(30 + n_steps, 30 + 2 * n_steps):
            plan, _, _ = engine.run_one_step(sched, step)
            rows += plan.n_tokens if plan is not None else 0
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    after = paged_counts(kernel_keys)
    attn_launches = {k: after[k] - before[k] for k in kernel_keys}
    by_name = device_ms_by_kernel(prof)
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
        "seconds": time.perf_counter() - t_phase,
    })


def submit_engine_requests(sched, cfg, lens=(100, 60, 30)) -> None:
    rng = np.random.default_rng(1)
    for n in lens:
        sched.submit(Request(
            prompt=[int(t) for t in rng.integers(1, cfg.vocab_size, (n,))],
            max_new_tokens=4,
        ))


def engine_check(phase: str, cfg, params, sc, tol: float,
                 lens=(100, 60, 30)) -> None:
    """Identical step plans through an engine on the kernels and one on the
    plain versions (same weights, fp32), prompts of `lens` tokens: every
    step's logits within `tol`, greedy tokens equal."""
    e_cuda = ServingEngine(params, cfg, sc, attn_impl="cuda")
    e_torch = ServingEngine(params, cfg, sc, attn_impl="torch")
    sched = e_cuda.make_scheduler()
    submit_engine_requests(sched, cfg, lens)
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
    is wrapped; the kernel's wrapper stays as it is, and the plain calls
    launch nothing."""
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
                      kernel: str, lens=(100, 60, 30)) -> None:
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
    submit_engine_requests(sched, cfg, lens)
    err = {"cuda_vs_fp32": 0.0, "plain_vs_fp32": 0.0, "cuda_vs_plain": 0.0}
    agree = {"cuda_vs_fp32": 0, "plain_vs_fp32": 0, "cuda_vs_plain": 0}
    steps, rows, errors = 0, 0, []
    n0 = kernel_launches()[kernel]
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
          "kernel_launches": kernel_launches()[kernel] - n0,
          "kernel_max_rel_err": max(errors),
          "kernel_tol": PAGED_TOL[torch.bfloat16]})
    if kernel_launches()[kernel] - n0 != len(errors) or not errors:
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


def engine_window_phase() -> None:
    """A 2-layer Gemma-2 engine at Gemma-2-2B widths (one sliding layer with
    a window of ENGINE_WINDOW, one global; soft caps 50 and 30) on prompts
    longer than the window: in fp32 on the fp and the int8 pool (K4's and
    K5's CUDA-core routes) against the plain version, logits within the
    engine tolerances and greedy tokens equal; then in bf16 on both pools
    (the tensor-core routes), held to the fp32 model as engine_bf16_check
    holds the other engines. The global layer launches the kernels too,
    with no window."""
    cfg = gemma2_config(dict(GEMMA2_2B, num_hidden_layers=2, sliding_window=ENGINE_WINDOW),
                        dtype=torch.float32)
    assert decoder.layer_windows(cfg) == (ENGINE_WINDOW, None)
    params = decoder.init(cfg, torch.Generator(device="cuda").manual_seed(2))
    sc = dataclasses.replace(SERVE, num_pages=256)
    int8 = dataclasses.replace(sc, kv_cache_dtype="int8")
    lens = ENGINE_WINDOW_PROMPTS
    engine_check("engine_window", cfg, params, sc, ENGINE_LOGITS_TOL, lens)
    engine_check("engine_window_int8", cfg, params, int8, ENGINE_INT8_LOGITS_TOL, lens)
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    engine_bf16_check("engine_window_bf16", cfg16, params16, sc,
                      ENGINE_BF16_LOGITS_TOL, "K4", lens)
    engine_bf16_check("engine_window_int8_bf16", cfg16, params16, int8,
                      ENGINE_BF16_LOGITS_TOL, "K5", lens)
    del params16
    torch.cuda.empty_cache()


def serve_gemma2_phase(card: str) -> dict:
    """The windowed main path: google/gemma-2-2b at full width, cut to its
    first GEMMA2_SERVE_LAYERS layers (alternating window 4096 and global,
    soft caps 50 / 30), bf16,
    random weights from seed 0, on SERVE_GEMMA2 traffic (prompts of
    4200-7800 tokens, so the window masks) on the fp pool (K4), with its
    profile, and then on the int8 pool (K5); returns the launches of K4
    and K5."""
    cfg = gemma2_config(dict(GEMMA2_2B, num_hidden_layers=GEMMA2_SERVE_LAYERS),
                        dtype=torch.bfloat16)
    windows = decoder.layer_windows(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = decoder.init(cfg, gen, dtype=torch.bfloat16)
    engine = ServingEngine(params, cfg, SERVE_GEMMA2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = (f"Gemma-2-2B, full width, {cfg.num_layers} of 26 layers "
             f"({sum(w is not None for w in windows)} with window {cfg.sliding_window}, "
             f"{sum(w is None for w in windows)} global), bf16, "
             f"{count_params(params)} params")
    launches = {}
    for kernel, kv in (("K4", None), ("K5", "int8")):
        if kv is not None:
            engine = ServingEngine(params, cfg,
                                   dataclasses.replace(SERVE_GEMMA2, kv_cache_dtype=kv))
        phase = "serve_gemma2" + ("_int8" if kv else "")
        launches[kernel], _ = serve_run(engine, cfg, card, phase, model, kernel,
                                        setup_s if kv is None else 0.0,
                                        lens=GEMMA2_SERVE_PROMPTS)
        if kv is None:
            profile_steps(engine, cfg, card, phase,
                          rpa_cuda.KERNELS[kernel][rpa_cuda.route(torch.bfloat16)],
                          lens=GEMMA2_SERVE_PROMPTS)
        del engine
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return launches


def device_ms_by_kernel(prof) -> dict:
    """Device time (ms) of each kernel name in a torch.profiler window."""
    from torch.autograd import DeviceType

    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def train_phase(card: str, phase: str = "train", extra: tuple = ()) -> tuple[dict, dict]:
    """The training CLI at Llama-3-8B width, 8 layers, 5 steps, with the
    overrides `extra` (train_fp8: `model.linear_precision`, whose quantized
    GEMMs are counted: 7 linears a layer, forward and remat recompute);
    returns K1-K3 launches of that run and its step time, rate and peak."""
    from torch.profiler import ProfilerActivity, profile

    from automodel_tpu_torch.ops import quant

    run_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_")
    argv = [
        TRAIN_YAML,
        f"--model.hf_config.num_hidden_layers={TRAIN_LAYERS}",
        "--dataloader.microbatch_size=1",
        f"--dataloader.grad_acc_steps={TRAIN_ACCUM}",
        f"--step_scheduler.max_steps={TRAIN_STEPS}",
        "--checkpoint.enabled=false",
        f"--run_dir={run_dir}",
        *extra,
    ]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    quant.reset_launches()
    t0 = time.perf_counter()
    recipe = cli_main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel_launches(*FLASH)
    quant_gemms = dict(quant.LAUNCHES)
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
    prec = cfg.linear_precision
    want_gemms = {k: (2 * TRAIN_QUANT_LINEARS * n if k == prec else 0) for k in quant_gemms}
    summary = {"ms_per_step": tokens_per_step / tps * 1e3, "tokens_per_s": tps,
               "peak_mem_gib": peak_gib, "losses": [r["loss"] for r in records],
               "grad_norms": [r["grad_norm"] for r in records]}
    emit({
        "phase": phase, "card": card,
        "model": f"Llama-3-8B widths, {cfg.num_layers} layers, {cfg.dtype}, "
                 f"remat {cfg.remat_policy}, linear_precision {prec}",
        "quant_gemm_launches": quant_gemms, "expected_quant_gemm_launches": want_gemms,
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
    if quant_gemms != want_gemms:
        raise AssertionError(f"{phase}: quantized GEMMs {quant_gemms}, expected {want_gemms}")
    del recipe, prof
    torch.cuda.empty_cache()
    return launches, summary


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
        reset_counts()
        ce, aux = accumulate_grads(loss_fn, params, batch)
        results[impl] = (float(ce / aux["num_label_tokens"]),
                         [t.grad for t in leaves], kernel_launches()["K1"])
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
        reset_counts()
        if way == "cli":
            cli_main(argv)
        else:
            recipe = TrainFinetuneRecipeForNextTokenPrediction(
                parse_args_and_load_config(argv))
            recipe.setup()
            recipe.run_train_validation_loop()
        k1[way] = kernel_launches()["K1"]
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


# train_mesh: the training mesh on NCCL, one rank per visible card (up to
# 8): Llama-3-8B at the train phase's 8-layer cut over dp_shard (FSDP, the
# DTensor/gather path on at any size), TRAIN_MESH_STEPS steps; a smaller
# Llama (MESH_CKPT_HF: 2 layers, its heads, a 8192 vocab; ~0.6 GB a save)
# saved sharded at step 2 and resumed in the plain one-device path; each
# Qwen3-30B-A3B expert's output (2 layers at its widths, MESH_EP_TOKENS
# tokens a rank) through the EP dispatch over ep = the world size, held to
# the unsharded dropless path within the bf16 tolerance the engine's MoE
# checks use (ENGINE_BF16_LOGITS_TOL, relative to the largest output)
TRAIN_MESH_STEPS = 3
TRAIN_MESH_LOSS_RTOL = 1e-3
TRAIN_MESH_PEAK_MARGIN = 1.05
MESH_CKPT_HF = {
    "architectures": ["LlamaForCausalLM"], "vocab_size": 8192, "hidden_size": 1024,
    "intermediate_size": 4096, "num_hidden_layers": 2, "num_attention_heads": 8,
    "num_key_value_heads": 8, "rope_theta": 500000.0, "max_position_embeddings": 8192,
}
MESH_EP_TOKENS = 4096


def mesh_ckpt_yaml(path: Path, run_dir: str, ckpt_dir: str, steps: int) -> str:
    """MESH_CKPT_HF on mock data, bf16 over fp32 masters, 2048 tokens."""
    node = {
        "seed": 5, "run_dir": run_dir,
        "model": {"hf_config": MESH_CKPT_HF, "dtype": "bfloat16", "remat_policy": "full"},
        "distributed": {"dp_shard": -1},
        "dataset": {"_target_": "automodel_tpu.datasets.mock.MockDatasetConfig",
                    "num_samples": 64, "seq_len": 2048, "vocab_size": 8192},
        "dataloader": {"microbatch_size": 1, "grad_acc_steps": 1},
        "optimizer": {"name": "adamw", "lr": 3e-4, "weight_decay": 0.1},
        "lr_scheduler": {"warmup_steps": 1, "decay_steps": 10, "style": "cosine"},
        "step_scheduler": {"max_steps": steps, "ckpt_every_steps": 2},
        "checkpoint": {"enabled": True, "checkpoint_dir": ckpt_dir, "async_save": False},
        "loss": {"chunk_size": 2048},
    }
    path.write_text(yaml.safe_dump(node))
    return str(path)


def dropless_rows(params, cfg, x, indices) -> torch.Tensor:
    """Each (token, slot) pair's expert output before weighting, (T*K, H) in
    pair order, through the unsharded dropless path's sort and grouped
    products (masked pairs 0)."""
    from automodel_tpu_torch.moe.experts import _expert_mlp

    T, K = indices.shape
    E = cfg.n_routed_experts
    flat = indices.reshape(T * K).long()
    sort_idx = torch.argsort(flat, stable=True)
    expert_of = flat[sort_idx]
    offs = torch.searchsorted(expert_of, torch.arange(1, E + 1, device=x.device),
                              out_int32=True)
    y = _expert_mlp(params, cfg, x[sort_idx // K], offs, torch.clamp(expert_of, 0, E - 1))
    y = torch.where((expert_of < E)[:, None], y, 0)
    return torch.zeros_like(y).index_copy(0, sort_idx, y)


def mesh_ep_check(rank: int, world: int) -> dict:
    """Qwen3-30B-A3B's MoE blocks, 2 layers at its widths, bf16: this rank's
    MESH_EP_TOKENS tokens through `experts_forward_dropless_ep` over ep =
    the world (E / world experts a rank) against the unsharded dropless
    path with every expert, on the same tokens and routing; per expert,
    the largest error of the rows it computed. Times both (the EP path
    includes its one host read of the split sizes a layer)."""
    import torch.distributed as dist

    from automodel_tpu_torch.moe.experts import (
        experts_forward_dropless,
        experts_forward_dropless_ep,
    )
    from automodel_tpu_torch.moe.gate import gate_forward

    cfg, _ = gqa_moe_config(QWEN3_30B_A3B, 2, torch.bfloat16)
    moe_cfg, E = cfg.moe, cfg.moe.n_routed_experts
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_moe(moe_cfg, cfg.hidden_size, gen, torch.bfloat16, num_layers=2)
    group = dist.new_group(list(range(world)))
    per = E // world
    xgen = torch.Generator(device="cuda").manual_seed(100 + rank)
    errors, out_errs, ep_ms, plain_ms, scale = [0.0] * E, [], [], [], 0.0
    for li in range(2):
        p = tree_map(lambda t: t[li], params)
        x = torch.randn(MESH_EP_TOKENS, cfg.hidden_size, device="cuda",
                        generator=xgen).to(torch.bfloat16)
        w, idx, _, _ = gate_forward(p["gate"], moe_cfg, x)
        local = tree_map(lambda t: t[rank * per:(rank + 1) * per].contiguous(), p["experts"])
        for _ in range(2):  # the second pass is timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_ep, rows_ep = experts_forward_dropless_ep(local, moe_cfg, x, w, idx, group,
                                                          return_rows=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = experts_forward_dropless(p["experts"], moe_cfg, x, w, idx)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        ep_ms.append((t1 - t0) * 1e3)
        plain_ms.append((t2 - t1) * 1e3)
        rows = dropless_rows(p["experts"], moe_cfg, x, idx)
        scale = max(scale, float(rows.float().abs().max()), float(out.float().abs().max()))
        diff = (rows_ep.float() - rows.float()).abs().amax(-1)
        flat = idx.reshape(-1).long()
        per_e = torch.zeros(E + 1, device="cuda").scatter_reduce(0, flat, diff, "amax")
        errors = [max(a, b) for a, b in zip(errors, per_e[:E].tolist())]
        out_errs.append(float((out_ep.float() - out.float()).abs().max()))
        if not torch.isfinite(out_ep).all():
            raise AssertionError("train_mesh: non-finite EP output")
    routed = torch.bincount(idx.reshape(-1).long(), minlength=E + 1)[:E]
    return {"experts": E, "experts_per_rank": per, "tokens_per_rank": MESH_EP_TOKENS,
            "layers": 2, "max_abs_err_per_expert": errors, "max_abs_ref": scale,
            "out_max_abs_err": out_errs, "experts_routed_last_layer": int((routed > 0).sum()),
            "ep_dispatch_ms": ep_ms, "plain_dropless_ms": plain_ms}


def train_mesh_rank(spec_path: str) -> int:
    """One rank of train_mesh, under torchrun: the sharded save of the
    checkpoint model through the recipe class (which joins the NCCL group),
    the EP check, then the Llama-3-8B run through the CLI on the mesh (as
    torchrun runs it; it tears the group down at its end); writes
    `rank_<r>.json` beside the spec."""
    spec = json.loads(Path(spec_path).read_text())
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    out: dict = {"rank": rank, "world": world}
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(fa_cuda.SOURCE)  # built by the parent: loads the library
    recipe = TrainFinetuneRecipeForNextTokenPrediction(parse_args_and_load_config(spec["ckpt"]))
    recipe.setup()
    recipe.run_train_validation_loop()
    out["ckpt"] = {"last_save": recipe.checkpointer.last_save}
    del recipe
    gc.collect()
    torch.cuda.empty_cache()
    out["ep"] = mesh_ep_check(rank, world)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    recipe = cli_main(spec["llama"])
    torch.cuda.synchronize()
    leaves = tree_leaves(recipe.train_state.params)
    out["llama"] = {
        "mesh": recipe.mesh_ctx.describe(),
        "param_bytes": sum(p.to_local().numel() * p.element_size() for p in leaves),
        "param_bytes_whole": sum(p.numel() * p.element_size() for p in leaves),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": kernel_launches(*FLASH), "wall_s": time.perf_counter() - t0,
    }
    Path(spec["out"], f"rank_{rank}.json").write_text(json.dumps(out))
    return 0


def train_mesh_phase(card: str, plain: dict) -> dict:
    """train_mesh (see TRAIN_MESH_STEPS): torchrun over every visible card
    (up to 8) runs `train_mesh_rank`; then this process resumes the
    sharded checkpoint in the plain one-device path. `plain` is the train
    phase's summary (its step-1 loss and peak). Returns the Llama run's
    K1-K3 launches (rank 0's)."""
    world = min(torch.cuda.device_count(), 8)
    print(f"train_mesh world size: {world}", flush=True)
    if world == 1:
        print("train_mesh: one card, a mesh of one rank; multi-rank parity is "
              "shown by the CPU tests only (tests/test_torch_mesh.py, gloo)", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_mesh_"))
    llama_dir, ckpt_run = tmp / "llama", tmp / "ckpt_run"
    spec = {
        "out": str(tmp),
        "llama": [TRAIN_YAML, f"--model.hf_config.num_hidden_layers={TRAIN_LAYERS}",
                  f"--dataloader.microbatch_size={world}",
                  f"--dataloader.grad_acc_steps={TRAIN_ACCUM}",
                  f"--step_scheduler.max_steps={TRAIN_MESH_STEPS}",
                  "--checkpoint.enabled=false", "--distributed.dp_shard=-1",
                  f"--run_dir={llama_dir}"],
        "ckpt": [mesh_ckpt_yaml(tmp / "ckpt.yaml", str(ckpt_run), str(tmp / "ckpt"), 3)],
    }
    (tmp / "spec.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={world}", __file__, "--train-mesh-rank",
             str(tmp / "spec.json")],
            capture_output=True, text=True, timeout=600)
        ranks_s = time.perf_counter() - t0
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-8000:], file=sys.stderr)
            raise AssertionError(f"train_mesh: the ranks exited with {r.returncode}")
        ranks = [json.loads((tmp / f"rank_{i}.json").read_text()) for i in range(world)]
        llama = jsonl(llama_dir / "training.jsonl")
        mesh_ckpt = jsonl(ckpt_run / "training.jsonl")
        # the plain one-device path from the step-2 checkpoint
        resumed_dir = tmp / "resumed"
        resumed = TrainFinetuneRecipeForNextTokenPrediction(parse_args_and_load_config(
            [mesh_ckpt_yaml(tmp / "resume.yaml", str(resumed_dir), str(tmp / "unused"), 3),
             "--checkpoint.enabled=false", f"--checkpoint.restore_from={tmp / 'ckpt'}",
             "--checkpoint.restore_step=2"]))
        resumed.setup()
        resumed.run_train_validation_loop()
        del resumed
        after = jsonl(resumed_dir / "training.jsonl")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = TRAIN_LAYERS * TRAIN_ACCUM * TRAIN_MESH_STEPS
    want = {"K1": 2 * n, "K2": n, "K3": n}
    tokens_per_step = TRAIN_ACCUM * world * 4096
    steady = llama[1:]
    tps = statistics.median(r["tps"] for r in steady)
    step1_rel = abs(llama[0]["loss"] - plain["losses"][0]) / abs(plain["losses"][0])
    ep = [r["ep"] for r in ranks]
    ep_rows_err = max(max(e["max_abs_err_per_expert"]) for e in ep)
    ep_err = max(ep_rows_err, max(max(e["out_max_abs_err"]) for e in ep))
    ep_scale = max(e["max_abs_ref"] for e in ep)
    resume_pair = {k: [mesh_ckpt[2][k], after[0][k]] for k in ("loss", "grad_norm")}
    bitwise = all(a == b for a, b in resume_pair.values())
    emit({
        "phase": "train_mesh", "card": card, "world": world, "ranks_wall_s": ranks_s,
        "model": f"Llama-3-8B widths, {TRAIN_LAYERS} layers, bf16, remat full, "
                 f"dp_shard {world}, {TRAIN_MESH_STEPS} steps of {tokens_per_step} tokens",
        "per_rank": [{"rank": r["rank"], "mesh": r["llama"]["mesh"],
                      "param_bytes": r["llama"]["param_bytes"],
                      "param_bytes_whole": r["llama"]["param_bytes_whole"],
                      "peak_mem_gib": r["llama"]["peak_mem_gib"],
                      "launches": r["llama"]["launches"],
                      "wall_s": r["llama"]["wall_s"]} for r in ranks],
        "losses": [r["loss"] for r in llama], "grad_norms": [r["grad_norm"] for r in llama],
        "ms_per_step": tokens_per_step / tps * 1e3, "tokens_per_s": tps,
        "step1_loss_vs_train": [llama[0]["loss"], plain["losses"][0], step1_rel],
        # the same seed and batches: at one rank the same arithmetic
        "steps_bitwise_equal_to_train": [
            r["loss"] == a and r["grad_norm"] == b for r, a, b in
            zip(llama, plain["losses"], plain["grad_norms"])],
        "plain_train_peak_mem_gib": plain["peak_mem_gib"],
        "expected_launches": want,
        "resharding": {"saved_world": world, "resumed": "plain one-device path",
                       "step3_mesh_vs_resumed": resume_pair, "bitwise": bitwise,
                       "save_bytes_rank0": ranks[0]["ckpt"]["last_save"]},
        "ep": {"model": "Qwen3-30B-A3B widths, 2 layers, bf16", "ep": world,
               "max_abs_err": ep_err, "max_abs_err_expert_rows": ep_rows_err,
               "max_abs_ref": ep_scale,
               "tol": ENGINE_BF16_LOGITS_TOL,
               "per_rank": [{k: v for k, v in e.items() if k != "max_abs_err_per_expert"}
                            for e in ep]},
    })
    for r in ranks:
        if r["llama"]["launches"] != want:
            raise AssertionError(f"train_mesh: rank {r['rank']} K1-K3 {r['llama']['launches']}, "
                                 f"expected {want}")
        if r["llama"]["peak_mem_gib"] > TRAIN_MESH_PEAK_MARGIN * plain["peak_mem_gib"]:
            raise AssertionError(f"train_mesh: rank {r['rank']} peak "
                                 f"{r['llama']['peak_mem_gib']:.2f} GiB over the plain "
                                 f"run's {plain['peak_mem_gib']:.2f}")
    values = [r["loss"] for r in llama] + [r["grad_norm"] for r in llama]
    if len(llama) != TRAIN_MESH_STEPS or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"train_mesh: {len(llama)} records or non-finite: {llama}")
    if world == 1 and step1_rel > TRAIN_MESH_LOSS_RTOL:
        raise AssertionError(f"train_mesh: step-1 loss {llama[0]['loss']} against the "
                             f"train phase's {plain['losses'][0]}")
    if [r["step"] for r in after] != [3] or len(mesh_ckpt) != 3:
        raise AssertionError("train_mesh: the resumed run did not take exactly step 3")
    if world == 1 and not bitwise:
        raise AssertionError(f"train_mesh: step 3 after the resume {resume_pair}")
    if world > 1 and any(abs(a - b) > TRAIN_MESH_LOSS_RTOL * abs(a)
                         for a, b in resume_pair.values()):
        raise AssertionError(f"train_mesh: step 3 after the resume {resume_pair}")
    if ep_err > ENGINE_BF16_LOGITS_TOL * ep_scale:
        raise AssertionError(f"train_mesh: an expert's EP output is {ep_err} off")
    return ranks[0]["llama"]["launches"]


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


def flash_counts(dims: tuple, routes=("mma",)) -> dict:
    """K1, K2 and K3's launches at head dims `dims` since the counts were
    last set to 0, on `routes` (the tensor cores by default), as the flash
    library's C dispatch counts them."""
    counts = fa_cuda.launch_counts(by_head_dims=True)
    return {k: sum(counts[(fa_cuda.KERNELS[r][i], tuple(dims))] for r in routes)
            for i, k in enumerate(("K1", "K2", "K3"))}


def profile_step(recipe, mbs, dims: tuple):
    """One more optimizer step of `recipe` on `mbs` under torch.profiler:
    (profile, wall ms, the step's K1-K3 launches on the tensor cores at
    head dims `dims`, as the flash library's C dispatch counts them)."""
    from torch.profiler import ProfilerActivity, profile

    before = flash_counts(dims)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        recipe.run_step(mbs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    after = flash_counts(dims)
    return prof, wall_ms, {k: after[k] - before[k] for k in after}


def moe_train_yaml(run_dir: str, name: str, hf: dict, seq: int, steps: int,
                   **model) -> str:
    """A MoE training recipe written to `run_dir`: `hf` as the HF config,
    bf16 over fp32 masters, full remat, mock data over MOE_TRAIN_TOKEN_IDS
    token ids, microbatch 1, AdamW, `model` keys added to its model
    section; returns its path."""
    cfg = {
        "seed": 0, "run_dir": run_dir,
        "model": {"hf_config": hf, "dtype": "bfloat16", "remat_policy": "full", **model},
        "distributed": {"dp_shard": -1},
        "dataset": {"_target_": "automodel_tpu_torch.datasets.mock.MockDatasetConfig",
                    "num_samples": 64, "seq_len": seq,
                    "vocab_size": MOE_TRAIN_TOKEN_IDS},
        "dataloader": {"microbatch_size": 1, "grad_acc_steps": 1},
        "optimizer": {"name": "adamw", "lr": 1.0e-3, "weight_decay": 0.1},
        "lr_scheduler": {"style": "constant", "warmup_steps": 0},
        "step_scheduler": {"max_steps": steps},
        "checkpoint": {"enabled": False},
        "loss": {"chunk_size": 2048},
    }
    path = Path(run_dir) / f"{name}.yaml"
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


def train_moe_phase(card: str) -> tuple[dict, float]:
    """Moonlight-16B-A3B training through the CLI (full width, 4 layers, 5
    steps); returns K1-K3 launches of that run, all at <192, 128>, and its
    ms per step."""

    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_moe_")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    hf = dict(MOONLIGHT, num_hidden_layers=MOE_TRAIN_LAYERS)
    recipe = cli_main([moe_train_yaml(run_dir, "moonlight_train", hf, MOE_TRAIN_SEQ,
                                      MOE_TRAIN_STEPS)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel_launches(*FLASH)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    records = jsonl(Path(run_dir) / "training.jsonl")
    cfg = recipe.model_cfg
    L = cfg.num_layers
    n = L * MOE_TRAIN_STEPS
    steady = records[1:]  # step 1 carries the first-call set-up
    tps = statistics.median(r["tps"] for r in steady)

    # one more step under the profiler: device time by kernel and by op
    mbs = [next(iter(recipe.dataloader))]
    prof, prof_wall_ms, mla_launches = profile_step(recipe, mbs, (192, 128))
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
    replay = routing_replay_check(recipe)
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
            "mla_flash_launches_counted": mla_launches,
            "attention_k1_k3_ms": attn_ms,
            "grouped_expert_gemm_ms": grouped_ms,
            "dense_gemm_ms": dense_gemm_ms,
            "other_ms": busy_ms - attn_ms - grouped_ms - dense_gemm_ms,
            "top_kernels_ms": top, "top_ops_self_device_ms": top_ops},
        "ce_fwd_bwd_ms_alone": ce_ms, "adamw_update_ms_alone": opt_ms,
        "moe_block_sync": moe_sync, "routing_replay": replay,
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
    return launches, MOE_TRAIN_SEQ / tps * 1e3


def moe_check_step(phase: str, base, params0: dict, seq: int, data_seed: int) -> None:
    """fp32: one accumulated step (2 microbatches of `seq` tokens) of the
    MoE decoder `base` from `params0` and one batch, with attn_impl "flash"
    (K1-K3 on the CUDA cores) and "torch" (the plain attention): the losses
    and every gradient leaf must agree, sink logits (`moe_layers.sinks`)
    reported apart. `base` takes the balanced gate: a top-k near-tie could
    otherwise move a token to another expert between two runs whose
    attention differs by ~1e-6."""
    ds = MockDatasetConfig(num_samples=4, seq_len=seq, vocab_size=base.vocab_size,
                           seed=data_seed).build()
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
        sinks = params["moe_layers"].get("sinks")
        reset_counts()
        ce, aux = accumulate_grads(loss_fn, params, batch)
        results[impl] = (float(ce / aux["num_label_tokens"]),
                         [t.grad for t in leaves], kernel_launches()["K1"],
                         None if sinks is None else sinks.grad.clone())
        del params, leaves, sinks
        torch.cuda.empty_cache()
    (loss_f, g_f, n_f, s_f), (loss_t, g_t, n_t, s_t) = results["flash"], results["torch"]
    if any((a is None) != (b is None) for a, b in zip(g_f, g_t)):
        raise AssertionError(f"{phase}: the two runs reach different leaves")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()

    grad_err = max(rel(a, b) for a, b in zip(g_f, g_t) if a is not None)
    loss_rel = abs(loss_f - loss_t) / abs(loss_t)
    entry = {"phase": phase, "layers": base.num_layers, "dtype": "float32",
             "windows": list(decoder.layer_windows(base)), "tokens": [2, seq],
             "loss_flash": loss_f, "loss_torch": loss_t, "loss_rel_err": loss_rel,
             "loss_rtol": TRAIN_LOSS_RTOL, "grad_max_rel_err": grad_err,
             "grad_tol": TRAIN_GRAD_TOL, "k1_launches": [n_f, n_t]}
    if s_t is not None:
        entry.update(sinks_grad_rel_err=rel(s_f, s_t), sinks_grad_max=s_t.abs().max().item())
    emit(entry)
    if n_f == 0 or n_t != 0:
        raise AssertionError(f"{phase}: attn_impl did not select the kernels / plain path")
    if s_t is not None and not s_t.abs().max().item() > 0:
        raise AssertionError(f"{phase}: the sinks got no gradient")
    if loss_rel > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_TOL:
        raise AssertionError(f"{phase}: the step differs between kernels and plain")


def train_moe_check_phase() -> None:
    """fp32, 2 layers (1 dense + 1 MoE) at Moonlight width, the balanced
    gate: `moe_check_step` on 2 microbatches of MOE_CHECK_SEQ tokens (K1-K3
    at <192, 128> on the CUDA cores)."""
    base = deepseek_v3_moe_config(dict(MOONLIGHT, num_hidden_layers=2),
                                  dtype=torch.float32, remat_policy="full")
    base = dataclasses.replace(base, moe=dataclasses.replace(base.moe, fake_balanced_gate=True))
    params0 = moe_decoder.init(base, torch.Generator(device="cuda").manual_seed(4))
    moe_check_step("train_moe_check", base, params0, MOE_CHECK_SEQ, 5)


def gemma_train_yaml(run_dir: str, hf: dict, seq: int, attn_impl: str = "auto",
                     checkpoint: dict | None = None, ckpt_every_steps: int = 1000) -> str:
    """A train_gemma phase's recipe, written to `run_dir`: the published
    config at full width and depth, bf16 over fp32 masters, full remat,
    mock data over GEMMA_TRAIN_TOKEN_IDS token ids, microbatch 1, AdamW,
    attention by `attn_impl`, the `checkpoint` section (off when None);
    returns its path."""
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
        "step_scheduler": {"max_steps": GEMMA_TRAIN_STEPS,
                           "ckpt_every_steps": ckpt_every_steps},
        "checkpoint": checkpoint or {"enabled": False},
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
    reset_counts()
    t0 = time.perf_counter()
    recipe = cli_main([gemma_train_yaml(run_dir, hf, seq)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel_launches(*FLASH)
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
    prof, prof_wall_ms, fa_launches = profile_step(recipe, mbs, (256, 256))
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
            "flash_256_launches_counted": fa_launches,
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
    reset_counts()
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
          "k1_launches": kernel_launches()["K1"], "wall_s_with_setup": wall_s,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    if kernel_launches()["K1"] != 0:
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
        reset_counts()
        ce, aux = accumulate_grads(loss_fn, params, batch)
        results[impl] = (float(ce / aux["num_label_tokens"]),
                         [t.grad for t in leaves], kernel_launches()["K1"])
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


def train_gemma3_ckpt_phase(card: str) -> int:
    """The train_gemma3 recipe with the train-state checkpointer on, in a
    temporary directory deleted at the end: `ckpt_every_steps` 3,
    `max_recent_checkpoints` 1, `async_save`, `save_consolidated: final`.

    1. The unbroken 5-step run through the CLI in this process. Its step-3
       checkpoint is hard-linked aside when it commits (retention deletes it
       when step 5 commits).
    2. A new process (`python -m automodel_tpu_torch`) restores that step-3
       checkpoint (`checkpoint.restore_from`, the checkpointer otherwise
       off: it saves nothing) and runs steps 4-5: its losses and grad norms
       must equal the unbroken run's within CKPT_RESUME_RTOL relative.

    The model is cut to CKPT_GEMMA3_LAYERS layers (see there).
    3. The `llm_serve` recipe through the CLI on the consolidated export:
       16 mock prompts of CKPT_SERVE_PROMPT_LEN tokens over Gemma-3-1B's
       512 window, 32 new tokens each, K4 on every layer of every step.

    Returns the serve's K4 launches."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_gemma3_ckpt_"))
    try:
        ck_a, ck_b = tmp / "ckpt", tmp / "ckpt_resume"
        (tmp / "run").mkdir()
        (tmp / "run_resume").mkdir()
        ckpt = {"enabled": True, "checkpoint_dir": str(ck_a), "async_save": True,
                "max_recent_checkpoints": 1, "save_consolidated": "final"}
        hf = dict(GEMMA3_1B, num_hidden_layers=CKPT_GEMMA3_LAYERS)
        yaml_a = gemma_train_yaml(str(tmp / "run"), hf, GEMMA3_TRAIN_SEQ,
                                  checkpoint=ckpt, ckpt_every_steps=CKPT_EVERY)
        # the step-3 save as it committed, and its files linked aside
        cadenced: dict = {}
        prune = Checkpointer._prune

        def keep_cadenced_step(self):
            if self.root == str(ck_a) and CKPT_EVERY in self.all_steps() and not cadenced:
                cadenced.update(self.last_save)
                shutil.copytree(self._dir(CKPT_EVERY), ck_b / f"step_{CKPT_EVERY}",
                                copy_function=os.link)
            prune(self)

        Checkpointer._prune = keep_cadenced_step
        try:
            t0 = time.perf_counter()
            recipe = cli_main([yaml_a])
            torch.cuda.synchronize()
            wall_a = time.perf_counter() - t0
        finally:
            Checkpointer._prune = prune
        final = dict(recipe.checkpointer.last_save)
        steps_a = recipe.checkpointer.all_steps()
        n_layers = recipe.model_cfg.num_layers
        del recipe
        torch.cuda.empty_cache()
        export = ck_a / "hf"
        export_bytes = sum(f.stat().st_size for f in export.iterdir())
        shutil.rmtree(ck_a / f"step_{GEMMA_TRAIN_STEPS}")  # disk for the resume
        records_a = [json.loads(l) for l in (tmp / "run" / "training.jsonl").open()]

        # 2. a new process resumes from the linked step-3 checkpoint
        yaml_b = gemma_train_yaml(str(tmp / "run_resume"), hf, GEMMA3_TRAIN_SEQ,
                                  checkpoint={"enabled": False, "restore_from": str(ck_b)},
                                  ckpt_every_steps=CKPT_EVERY)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "automodel_tpu_torch", yaml_b],
                              capture_output=True, text=True, timeout=900,
                              env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))
        wall_b = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"train_gemma3_ckpt: the resumed process failed:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        records_b = [json.loads(l) for l in
                     (tmp / "run_resume" / "training.jsonl").open()]
        tail_a = records_a[CKPT_EVERY:]
        pairs = [(a[k], b[k]) for a, b in zip(tail_a, records_b)
                 for k in ("loss", "grad_norm")]
        rel = max(abs(a - b) / abs(a) for a, b in pairs)

        # 3. llm_serve on the export
        node = {
            "recipe": "llm_serve", "seed": 0, "run_dir": str(tmp / "serve"),
            "model": {"pretrained_path": str(export), "dtype": "bfloat16"},
            "dataset": {"_target_": "automodel_tpu_torch.datasets.mock.MockDatasetConfig",
                        "num_samples": 16, "seq_len": CKPT_SERVE_PROMPT_LEN,
                        "vocab_size": GEMMA_TRAIN_TOKEN_IDS},
            "dataloader": {"microbatch_size": 16, "grad_acc_steps": 1},
            "max_requests": 16,
            "serving": {"page_size": SERVE.page_size, "num_pages": SERVE.num_pages,
                        "max_slots": SERVE.max_slots, "pages_per_slot": SERVE.pages_per_slot,
                        "token_budget": SERVE.token_budget,
                        "prefill_chunk": SERVE.prefill_chunk, "max_new_tokens": 32,
                        "temperature": 0.0, "arrival_stride": 2},
        }
        (tmp / "serve.yaml").write_text(json.dumps(node, indent=1))  # JSON is YAML
        reset_counts()
        t0 = time.perf_counter()
        with plain_calls_counted() as plain_calls:
            served = cli_main([str(tmp / "serve.yaml")])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = kernel_launches(*PAGED)
        gens = [json.loads(l) for l in (tmp / "serve" / "generations.jsonl").open()]
        stats = {k.removeprefix("serve_"): v for k, v in json.loads(
            (tmp / "serve" / "serving.jsonl").read_text().splitlines()[-1]).items()
                 if k.startswith("serve_")}
        serve_steps, serve_windows = served.engine.steps_run, served.engine._windows
        del served
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    resume_rec = records_b[0] if records_b else {}
    emit({
        "phase": "train_gemma3_ckpt", "card": card,
        "model": f"Gemma-3-1B, full width, {n_layers} of 26 layers, bf16 over fp32 "
                 "masters, remat full",
        "checkpoint": {"ckpt_every_steps": CKPT_EVERY, "max_recent_checkpoints": 1,
                       "async_save": True, "save_consolidated": "final"},
        "steps_kept": steps_a, "wall_s_unbroken": wall_a,
        "state_bytes": final.get("bytes"),
        "host_ram_bytes": os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"),
        "save_step3_async": cadenced, "save_final": final,
        "export_bytes": export_bytes,
        "resume_process_wall_s": wall_b,
        "resumed_steps": [r["step"] for r in records_b],
        "time_to_resume_s": resume_rec.get("time_to_resume_s"),
        "losses_unbroken": [r["loss"] for r in records_a],
        "losses_resumed": [r["loss"] for r in records_b],
        "grad_norms_unbroken": [r["grad_norm"] for r in records_a],
        "grad_norms_resumed": [r["grad_norm"] for r in records_b],
        "resume_max_rel_err": rel, "resume_rtol": CKPT_RESUME_RTOL,
        "resume_bit_equal": all(a == b for a, b in pairs),
        "serve": {"prompt_tokens": CKPT_SERVE_PROMPT_LEN, "windows": serve_windows,
                  "cli_s": cli_s, "load_s": cli_s - stats["elapsed_s"],
                  "serve_s": stats["elapsed_s"], "steps": serve_steps,
                  "decode_tokens_per_sec": stats["decode_tokens_per_sec"],
                  "ttft_p50_ms": stats["ttft_p50_ms"], "itl_p50_ms": stats["itl_p50_ms"],
                  "launches": launches, "plain_attention_calls": plain_calls},
    })
    if steps_a != [GEMMA_TRAIN_STEPS] or len(records_a) != GEMMA_TRAIN_STEPS:
        raise AssertionError(f"train_gemma3_ckpt: kept steps {steps_a}, "
                             f"{len(records_a)} records")
    if not cadenced or cadenced.get("bytes") != final.get("bytes"):
        raise AssertionError(f"train_gemma3_ckpt: the step-{CKPT_EVERY} save {cadenced}")
    if [r["step"] for r in records_b] != list(range(CKPT_EVERY + 1, GEMMA_TRAIN_STEPS + 1)):
        raise AssertionError(f"train_gemma3_ckpt: the resumed run's records {records_b}")
    if "time_to_resume_s" not in resume_rec:
        raise AssertionError("train_gemma3_ckpt: the resumed run did not resume")
    if rel > CKPT_RESUME_RTOL:
        raise AssertionError("train_gemma3_ckpt: the resumed curve left the unbroken one")
    if len(gens) != 16 or any(len(g["generated_ids"]) != 32 for g in gens):
        raise AssertionError("train_gemma3_ckpt: not every request finished with 32 tokens")
    want = dict.fromkeys(PAGED, 0)
    want["K4"] = n_layers * serve_steps
    if launches != want or any(plain_calls.values()):
        raise AssertionError(
            f"train_gemma3_ckpt: paged kernels launched {launches} (plain calls "
            f"{plain_calls}) in {serve_steps} steps of {n_layers} layers; expected {want}")
    return launches["K4"]


def lora_yaml(path: Path, model: dict, run_dir: Path, steps: int, peft: dict,
              checkpoint: dict, validation: bool,
              vocab_size: int = LLAMA3_8B["vocab_size"]) -> str:
    """llama_lora.yaml on Llama-3-8B: its peft section (updated by `peft`),
    optimizer and schedule as written; `model` (where the base comes from)
    in bf16 with full remat; mock data of LORA_SEQ tokens over the whole
    vocabulary; written to `path`."""
    cfg = yaml.safe_load(Path(LORA_YAML).read_text())
    cfg.update({
        "seed": 0, "run_dir": str(run_dir),
        "model": dict(model, dtype="bfloat16", remat_policy="full"),
        "peft": dict(cfg["peft"], **peft),
        "dataset": {"_target_": "automodel_tpu_torch.datasets.mock.MockDatasetConfig",
                    "num_samples": 64, "seq_len": LORA_SEQ,
                    "vocab_size": vocab_size},
        "dataloader": {"microbatch_size": 1, "grad_acc_steps": LORA_ACCUM},
        "step_scheduler": {"max_steps": steps, "ckpt_every_steps": LORA_EVERY},
        "checkpoint": checkpoint,
        "loss": {"chunk_size": 2048},
    })
    if validation:
        cfg["step_scheduler"]["val_every_steps"] = LORA_EVERY
        cfg["validation_dataset"] = {
            "_target_": "automodel_tpu_torch.datasets.mock.MockDatasetConfig",
            "num_samples": LORA_VAL_SAMPLES, "seq_len": LORA_SEQ,
            "vocab_size": vocab_size, "seed": 1}
        cfg["validation_generation"] = dict(LORA_VAL_GENERATION)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def run_recipe(yaml_path: str):
    """The recipe the CLI builds for `yaml_path`, set up and run as the CLI
    runs it, with the device's peak memory read after the set-up (the base
    read) and reset for the training loop; returns (recipe, seconds of
    set-up, seconds of the loop, set-up peak GiB, loop peak GiB)."""
    cfg = parse_args_and_load_config([yaml_path])
    recipe = resolve_recipe_class(cfg)(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recipe.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    return (recipe, setup_s, time.perf_counter() - t0, setup_peak,
            torch.cuda.max_memory_allocated() / 2**30)


def jsonl(path: Path) -> list:
    return [json.loads(l) for l in path.read_text().splitlines()]


def lora_export_check(recipe, export: Path) -> dict:
    """The consolidated export read back tensor by tensor against the HF
    tensors of `merged_state_dict` of the base and the final adapters."""
    adapter = DenseDecoderAdapter(recipe.model_cfg)
    merged = merged_state_dict(recipe.base_params, recipe.train_state.params,
                               recipe.peft_cfg)
    n = n_equal = 0
    with HFCheckpointReader(str(export)) as reader:
        for name, want in adapter.to_hf(merged):
            got = reader(name).to("cuda")
            n += 1
            n_equal += int(got.dtype == want.dtype and torch.equal(got, want))
    base_q = dequantize(recipe.base_params["layers"]["q_proj"]["kernel"], torch.float32)
    moved = float((merged["layers"]["q_proj"]["kernel"] - base_q).abs().max())
    return {"tensors": n, "bitwise_equal": n_equal, "q_proj_max_change": moved}


def train_lora_phase(card: str, ckpt_dir: Path) -> dict:
    """LoRA fine-tuning of Llama-3-8B at its published config (nothing cut)
    from the HF checkpoint at `ckpt_dir`, through the training recipe:

    1. the unbroken run: LORA_STEPS steps, validation (loss and the sampling
       eval) every LORA_EVERY steps, a PEFT-only checkpoint every
       LORA_EVERY steps (async); then one more step under torch.profiler
       (the merged export is checked at 2 layers in train_lora_check: at
       32 layers its 32.1 GB beside the 16.06 GB base would pass the
       script's 45 GiB disk budget);
    2. a new recipe object on `checkpoint.restore_from` = that checkpoint at
       step LORA_EVERY, which rebuilds the base from `ckpt_dir`: its steps
       and validation records must equal the unbroken run's bit for bit.

    Returns the unbroken run's K1-K3 launches and its loop's peak GiB."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_lora_"))
    try:
        ck_a = tmp / "ckpt"
        base = {"pretrained_path": str(ckpt_dir)}
        yaml_a = lora_yaml(tmp / "lora.yaml", base, tmp / "run", LORA_STEPS, {},
                           {"enabled": True, "checkpoint_dir": str(ck_a),
                            "async_save": True}, True)
        reset_counts()
        recipe, setup_s, loop_s, setup_peak, peak = run_recipe(yaml_a)
        launches = kernel_launches(*FLASH)
        cfg = recipe.model_cfg
        L = cfg.num_layers
        records, val = jsonl(tmp / "run" / "training.jsonl"), jsonl(tmp / "run" / "validation.jsonl")
        n = L * LORA_ACCUM * LORA_STEPS
        n_val = L * LORA_VAL_SAMPLES * (LORA_STEPS // LORA_EVERY)
        want = {"K1": 2 * n + n_val, "K2": n, "K3": n}
        trainable = count_params(recipe.train_state.params)
        save = dict(recipe.checkpointer.last_save)
        steps_kept = recipe.checkpointer.all_steps()
        final = tree_map(lambda t: t.detach().cpu().clone(), recipe.train_state.params)
        steady = [r for r in records[1:]]
        tps = statistics.median(r["tps"] for r in steady)

        mbs = [next(iter(recipe.dataloader)) for _ in range(LORA_ACCUM)]
        prof, prof_wall_ms, prof_launches = profile_step(recipe, mbs, (128, 128))
        by_name = device_ms_by_kernel(prof)
        busy_ms = sum(by_name.values())
        fa_ms = sum(v for k, v in by_name.items()
                    if any(re.search(pat, k) for pat in DENSE_FA_KERNELS.values()))
        self_dev = self_device_ms_by_op(prof)
        gemm_ms = sum(self_dev.get(k, 0.0) for k in DENSE_GEMM_OPS)
        top = [[k[:80], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
        top_ops = [[k, v] for k, v in sorted(self_dev.items(), key=lambda kv: -kv[1])[:12]]
        del recipe, prof
        torch.cuda.empty_cache()

        # 2. a new recipe object resumes from the step-LORA_EVERY checkpoint
        yaml_b = lora_yaml(tmp / "resume.yaml", base, tmp / "run_resume", LORA_STEPS, {},
                           {"enabled": True, "checkpoint_dir": str(tmp / "ckpt_resume"),
                            "restore_from": str(ck_a), "restore_step": LORA_EVERY}, True)
        reset_counts()
        t0 = time.perf_counter()
        resumed = cli_main([yaml_b])
        torch.cuda.synchronize()
        resume_wall_s = time.perf_counter() - t0
        resume_launches = kernel_launches(*FLASH)
        records_b = jsonl(tmp / "run_resume" / "training.jsonl")
        val_b = jsonl(tmp / "run_resume" / "validation.jsonl")
        final_b = tree_map(lambda t: t.detach().cpu(), resumed.train_state.params)
        del resumed
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tail = records[LORA_EVERY:]
    resume_equal = (
        [r["step"] for r in records_b] == [r["step"] for r in tail]
        and all(a[k] == b[k] for a, b in zip(tail, records_b) for k in ("loss", "grad_norm")))
    strip = lambda recs: [{k: v for k, v in r.items() if k != "ts"} for r in recs]
    val_equal = strip(val_b) == strip(val[1:])
    adapters_equal = all(torch.equal(final[p][k], final_b[p][k]) for p in final for k in final[p])
    n_b = L * LORA_ACCUM * (LORA_STEPS - LORA_EVERY)
    want_b = {"K1": 2 * n_b + L * LORA_VAL_SAMPLES, "K2": n_b, "K3": n_b}
    emit({
        "phase": "train_lora", "card": card,
        "model": f"Llama-3-8B, all {L} layers, seq {LORA_SEQ}, {cfg.dtype} over the "
                 f"fp32 base, remat {cfg.remat_policy}; nothing cut",
        "peft": {"r": 16, "alpha": 32.0, "targets": ["q_proj", "k_proj", "v_proj", "o_proj"]},
        "trainable_params": trainable, "expected_trainable": LORA_TRAINABLE,
        "steps": len(records), "tokens_per_step": LORA_ACCUM * LORA_SEQ,
        "losses": [r["loss"] for r in records],
        "grad_norms": [r["grad_norm"] for r in records],
        "ms_per_step": LORA_ACCUM * LORA_SEQ / tps * 1e3, "tokens_per_s": tps,
        "mfu_pct": statistics.median(r["mfu_pct"] for r in steady),
        "tflops_per_device": statistics.median(r["tflops_per_device"] for r in steady),
        "flops_per_token": cfg.flops_per_token(LORA_SEQ),
        "setup_s": setup_s, "loop_s": loop_s,
        "setup_peak_mem_gib": setup_peak, "peak_mem_gib": peak,
        "validation": val,
        "launches": launches, "expected_launches": want,
        "checkpoint": {"steps_kept": steps_kept, "bytes": save.get("bytes"),
                       "host_s": save.get("host_s"), "write_s": save.get("write_s"),
                       "pinned_bytes": save.get("pinned_bytes")},
        "export": "not at 32 layers: its 32.1 GB (fp32) beside the 16.06 GB base "
                  "pass the script's 45 GiB disk budget; train_lora_check exports "
                  "the merge at 2 layers",
        "resume": {"wall_s": resume_wall_s,
                   "time_to_resume_s": records_b[0].get("time_to_resume_s") if records_b else None,
                   "steps": [r["step"] for r in records_b],
                   "losses": [r["loss"] for r in records_b],
                   "bit_equal": resume_equal, "validation_equal": val_equal,
                   "adapters_equal": adapters_equal,
                   "launches": resume_launches, "expected_launches": want_b},
        "profiled_step": {"wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
                          "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
                          "flash_launches_counted": prof_launches,
                          "flash_kernels_ms": fa_ms, "dense_gemm_ms": gemm_ms,
                          "top_kernels_ms": top, "top_ops_self_device_ms": top_ops},
    })
    if trainable != LORA_TRAINABLE:
        raise AssertionError(f"train_lora: {trainable} trainable parameters")
    if len(records) != LORA_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
        raise AssertionError(f"train_lora: records {records}")
    if [v["step"] for v in val] != list(range(LORA_EVERY, LORA_STEPS + 1, LORA_EVERY)) or any(
            not math.isfinite(v["val_loss"]) or v["gen_samples"] != 1 for v in val):
        raise AssertionError(f"train_lora: validation records {val}")
    if launches != want or resume_launches != want_b:
        raise AssertionError(f"train_lora: K1-K3 launches {launches} / {resume_launches}; "
                             f"expected {want} / {want_b}")
    if steps_kept != [LORA_EVERY, LORA_STEPS]:
        raise AssertionError(f"train_lora: checkpoint steps {steps_kept}")
    if not (resume_equal and val_equal and adapters_equal):
        raise AssertionError("train_lora: the resumed run left the unbroken one")
    return {"launches": launches, "peak_mem_gib": peak}


def train_qlora_phase(card: str, ckpt_dir: Path, lora_peak_gib: float) -> dict:
    """train_lora's model and base with `peft.quantize_base: int8` (the
    frozen kernels int8, dequantized layer by layer at use), QLORA_STEPS
    steps, no checkpoint or validation. Its loop's peak must lie below
    train_lora's. Returns its K1-K3 launches."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_qlora_"))
    try:
        path = lora_yaml(tmp / "qlora.yaml", {"pretrained_path": str(ckpt_dir)},
                         tmp / "run", QLORA_STEPS,
                         {"quantize_base": "int8"}, {"enabled": False}, False)
        reset_counts()
        recipe, setup_s, loop_s, setup_peak, peak = run_recipe(path)
        launches = kernel_launches(*FLASH)
        records = jsonl(tmp / "run" / "training.jsonl")
        cfg = recipe.model_cfg
        base_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(recipe.base_params))
        int8_leaves = sum(1 for t in tree_leaves(recipe.base_params) if t.dtype == torch.int8)
        del recipe
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = cfg.num_layers * LORA_ACCUM * QLORA_STEPS
    want = {"K1": 2 * n, "K2": n, "K3": n}
    tps = statistics.median(r["tps"] for r in records[1:])
    emit({
        "phase": "train_qlora", "card": card,
        "model": f"Llama-3-8B, all {cfg.num_layers} layers, seq {LORA_SEQ}, int8 base "
                 f"(absmax per output channel), {cfg.dtype} compute; nothing cut",
        "steps": len(records), "losses": [r["loss"] for r in records],
        "grad_norms": [r["grad_norm"] for r in records],
        "ms_per_step": LORA_ACCUM * LORA_SEQ / tps * 1e3, "tokens_per_s": tps,
        "mfu_pct": statistics.median(r["mfu_pct"] for r in records[1:]),
        "base_bytes": base_bytes, "int8_leaves": int8_leaves,
        "setup_s": setup_s, "loop_s": loop_s,
        "setup_peak_mem_gib": setup_peak, "peak_mem_gib": peak,
        "train_lora_peak_mem_gib": lora_peak_gib,
        "launches": launches, "expected_launches": want,
    })
    if len(records) != QLORA_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
        raise AssertionError(f"train_qlora: records {records}")
    if launches != want:
        raise AssertionError(f"train_qlora: K1-K3 launches {launches}, expected {want}")
    if not peak < lora_peak_gib:
        raise AssertionError(f"train_qlora: peak {peak} GiB not below train_lora's "
                             f"{lora_peak_gib}")
    return launches


def train_lora_check_phase() -> None:
    """fp32, 2 layers at Llama-3-8B width: one accumulated step (2
    microbatches of 4096 tokens) of LoRA, DoRA and QLoRA adapters (b and
    DoRA's m drawn away from their init, so that every adapter has a
    gradient) on the same base and batch, with attn_impl "flash" (K1-K3)
    and "torch" (the plain attention): losses and adapter gradients within
    train_check's tolerances. Then llama_lora.yaml with DoRA over the int8
    base at 2 layers of the same width through the recipe, 2 steps, and its
    merged consolidated export (5.9 GB, fp32) read back tensor for tensor
    against `merged_state_dict` of the base and the final adapters."""
    base_cfg = llama_config(LLAMA3_8B, num_layers=2, dtype=torch.float32,
                            remat_policy="full")
    params0 = decoder.init(base_cfg, torch.Generator(device="cuda").manual_seed(2))
    ds = MockDatasetConfig(num_samples=4, seq_len=4096, vocab_size=base_cfg.vocab_size,
                           seed=3).build()
    batch = make_global_batch(stack_microbatches(
        [{k: v[None] for k, v in ds[i].items()} for i in range(2)]), "cuda")
    out = {}
    for variant, extra in (("lora", {}), ("dora", {"dora": True}),
                           ("qlora", {"quantize_base": "int8"})):
        lcfg = LoRAConfig(r=16, alpha=32.0, **extra)
        gen = torch.Generator(device="cuda").manual_seed(5)
        base = quantize_base(params0, lcfg)
        adapters0 = init_lora(params0, lcfg, gen)
        for ab in adapters0.values():
            ab["b"].normal_(0.0, 0.02, generator=gen)
            if "m" in ab:
                ab["m"].mul_(torch.empty_like(ab["m"]).uniform_(0.5, 1.5, generator=gen))
        results = {}
        for impl in ("flash", "torch"):
            cfg = dataclasses.replace(base_cfg, attn_impl=impl)

            def loss_fn(ad, mb, rng, cfg=cfg):
                h = decoder.forward(base, cfg, mb["input_ids"], return_hidden=True,
                                    lora=ad, lora_cfg=lcfg)
                head = decoder.head_kernel(merge_lora(base, ad, lcfg, skip=("layers",)), cfg)
                return fused_linear_cross_entropy(h, head, mb["labels"], chunk_size=2048)

            adapters = tree_map(lambda t: t.clone().requires_grad_(), adapters0)
            reset_counts()
            ce, aux = accumulate_grads(loss_fn, adapters, batch)
            results[impl] = (float(ce / aux["num_label_tokens"]),
                             [t.grad for t in tree_leaves(adapters)], kernel_launches()["K1"])
            del adapters
        (loss_f, g_f, n_f), (loss_t, g_t, n_t) = results["flash"], results["torch"]
        out[variant] = {
            "loss_flash": loss_f, "loss_torch": loss_t,
            "loss_rel_err": abs(loss_f - loss_t) / abs(loss_t),
            "grad_max_rel_err": max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                                    for a, b in zip(g_f, g_t)),
            "grad_leaves": len(g_f),
            "k1_launches": [n_f, n_t]}
        del base, adapters0, results, g_f, g_t
        torch.cuda.empty_cache()
    del params0
    torch.cuda.empty_cache()
    # the recipe's merged consolidated export, at 2 layers: DoRA over the
    # int8 base (dequantize, merge, renormalize), 2 steps (the YAML's warmup
    # gives step 1 no learning rate)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lora_export_"))
    try:
        ck = tmp / "ckpt"
        path = lora_yaml(
            tmp / "export.yaml",
            {"hf_config": dict(LLAMA3_8B, architectures=["LlamaForCausalLM"],
                               num_hidden_layers=2)},
            tmp / "run", 2, {"dora": True, "quantize_base": "int8"},
            {"enabled": True, "checkpoint_dir": str(ck), "async_save": False,
             "save_consolidated": "final"}, False)
        recipe = run_recipe(path)[0]
        export_bytes = sum(f.stat().st_size for f in (ck / "hf").iterdir())
        t0 = time.perf_counter()
        export = lora_export_check(recipe, ck / "hf")
        export.update(bytes=export_bytes, readback_s=time.perf_counter() - t0)
        del recipe
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "train_lora_check", "layers": 2, "dtype": "float32",
          "loss_rtol": TRAIN_LOSS_RTOL, "grad_tol": TRAIN_GRAD_TOL, **out,
          "recipe_export_dora_int8_base": export})
    if export["bitwise_equal"] != export["tensors"] or export["q_proj_max_change"] == 0.0:
        raise AssertionError(f"train_lora_check: the export is not the merge: {export}")
    for variant, r in out.items():
        if r["k1_launches"][0] == 0 or r["k1_launches"][1] != 0:
            raise AssertionError(f"train_lora_check {variant}: attn_impl did not select "
                                 "the kernels / the plain path")
        if r["loss_rel_err"] > TRAIN_LOSS_RTOL or r["grad_max_rel_err"] > TRAIN_GRAD_TOL:
            raise AssertionError(f"train_lora_check {variant}: kernels and plain differ")


def generate_check_phase() -> None:
    """Greedy `generate()` (plain attention over its dense cache, as in the
    JAX package) on 2-layer fp32 models at the full widths of Llama-3-8B,
    Gemma-2-2B, Moonlight-16B-A3B (one dense, one MoE layer) and
    DeepSeek-V3, and on Kimi-K2's at 1 layer (both with yarn), 8 prompts
    of 64-512 tokens, GEN_NEW new tokens each, against the teacher-forced
    `forward` argmax over the generated sequence (one pass; K1 on the card)
    and against `ServingEngine.serve_batch` on the same weights (K4 and K6,
    fp32 routes; K6 at 128 and 64 heads x r 512 in head tiles)."""
    models = (
        ("Llama-3-8B", decoder, llama_config(LLAMA3_8B, num_layers=2, dtype=torch.float32)),
        ("Gemma-2-2B", decoder, gemma2_config(dict(GEMMA2_2B, num_hidden_layers=2),
                                              dtype=torch.float32)),
        ("Moonlight-16B-A3B", moe_decoder, dataclasses.replace(
            deepseek_v3_moe_config(MOONLIGHT), num_layers=2, dtype=torch.float32)),
        # yarn's scale in K1 at <192, 128>; the fp32 K6 at 128 and 64 heads
        # (4 and 2 head tiles a row); both cuts are dense layers alone
        ("DeepSeek-V3", moe_decoder, cut_config(DEEPSEEK_V3, 2, 2, torch.float32)),
        ("Kimi-K2", moe_decoder, cut_config(KIMI_K2, 1, 1, torch.float32)),
    )
    report = {}
    for name, module, cfg in models:
        params = module.init(cfg, torch.Generator(device="cuda").manual_seed(6))
        rng = np.random.default_rng(7)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in GEN_PROMPTS]
        t0 = time.perf_counter()
        gen_tokens = [generate(params, cfg, torch.tensor([p], device="cuda"), None,
                               GenerateConfig(max_new_tokens=GEN_NEW))[0, len(p):].tolist()
                      for p in prompts]
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        reset_counts()
        teacher = []
        with torch.no_grad():
            for p, g in zip(prompts, gen_tokens):
                out = module.forward(params, cfg, torch.tensor([p + g], device="cuda"))
                logits = out[0] if isinstance(out, tuple) else out
                teacher.append(logits[0, len(p) - 1:-1].argmax(-1).tolist())
        k1 = kernel_launches()["K1"]
        reset_counts()
        engine = ServingEngine(params, cfg, SERVE)
        served = engine.serve_batch([Request(prompt=list(p), max_new_tokens=GEN_NEW, seed=i)
                                     for i, p in enumerate(prompts)])["outputs"]
        paged = {k: n for k, n in kernel_launches(*PAGED).items() if n}
        # the first new token at which each prompt's tokens differ, if any
        misses = {ref_name: {i: next(j for j, (a, b) in enumerate(zip(g, ref)) if a != b)
                             for i, (g, ref) in enumerate(zip(gen_tokens, refs)) if g != ref}
                  for ref_name, refs in (("teacher", teacher), ("serve_batch", served))}
        report[name] = {"prompt_lens": list(GEN_PROMPTS), "new_tokens": GEN_NEW,
                        "generate_s": gen_s, "k1_launches_teacher": k1,
                        "paged_launches_serve": paged, "first_miss_by_prompt": misses}
        del params, engine, logits
        torch.cuda.empty_cache()
    emit({"phase": "generate_check", "dtype": "float32", "layers": 2, **report})
    for name, r in report.items():
        if any(r["first_miss_by_prompt"].values()):
            raise AssertionError(f"generate_check {name}: greedy tokens differ: "
                                 f"{r['first_miss_by_prompt']}")
        if r["k1_launches_teacher"] == 0 or not r["paged_launches_serve"]:
            raise AssertionError(f"generate_check {name}: the references ran no kernel")


def cut_config(hf: dict, layers: int, dense: int, dtype):
    """A published MLA + MoE config through its registry family, cut to
    `layers` layers, the first `dense` of them dense, with no MTP head
    (training state, which the HF adapter does not map either)."""
    cut = dict(hf, num_hidden_layers=layers, first_k_dense_replace=dense)
    cfg = get_model_spec(cut).config_from_hf(cut, dtype=dtype)
    return dataclasses.replace(cfg, mtp_num_layers=0)


def engine_plain_check(phase: str, cfg, params, sc, kernel: str) -> dict:
    """The engine (bf16, or fp32 on the kernels' CUDA-core route) on the
    kernels, a few short requests to their end: every `kernel` call held to
    the plain version on the same inputs within PAGED_TOL of the model's
    dtype, and each step's logits beside those of the same engine on the
    plain attention, same weights (reported, with the greedy agreement:
    bf16 rounds attention at other places in the two, and the MoE routing
    carries it)."""
    t0 = time.perf_counter()
    e_cuda = ServingEngine(params, cfg, sc, attn_impl="cuda")
    e_torch = ServingEngine(params, cfg, sc, attn_impl="torch")
    sched = e_cuda.make_scheduler()
    submit_engine_requests(sched, cfg)
    n0, errors, steps, rows, agree, gap = kernel_launches()[kernel], [], 0, 0, 0, 0.0
    while sched.has_work:
        plan = sched.schedule(steps)
        with held_to_plain(kernel, errors):
            got = e_cuda.step_logits(plan).float()
        want = e_torch.step_logits(plan).float()
        gap = max(gap, ((got - want).abs().max()
                        / want.abs().max().clamp(min=1.0)).item())
        live = torch.as_tensor(plan.sample_tok >= 0, device=got.device)
        agree += int(((got.argmax(-1) == want.argmax(-1)) & live).sum().item())
        rows += int(live.sum().item())
        sched.update(plan, got.argmax(-1).to(torch.int32).cpu().numpy(), steps)
        steps += 1
    report = {"steps": steps, "kernel": kernel, "kernel_calls": len(errors),
              "kernel_launches": kernel_launches()[kernel] - n0,
              "kernel_max_rel_err": max(errors),
              "kernel_tol": PAGED_TOL[cfg.dtype],
              "max_rel_logit_gap_vs_plain_engine": gap,
              "greedy_agreement_vs_plain_engine": agree / rows,
              "seconds": time.perf_counter() - t0}
    del e_cuda, e_torch
    torch.cuda.empty_cache()
    if kernel_launches()[kernel] - n0 != len(errors) or not errors:
        raise AssertionError(f"{phase}: the engine's {kernel} calls did not all launch {kernel}")
    if max(errors) > PAGED_TOL[cfg.dtype]:
        raise AssertionError(f"{phase}: {kernel} calls disagree with the plain version: {report}")
    return report


def serve_published_mla_phase(card: str, name: str, hf: dict, layers: int,
                              pools: tuple) -> dict:
    """A published MLA + MoE model at its full widths, cut to `layers`
    layers (the dense prefix's first ones, then one MoE layer), bf16,
    random weights from seed 0, on each of `pools` ((phase, kernel):
    "K6" the fp pool, "K7" the int8 pool): `serve_run` on the serve
    traffic (K6 / K7 on every layer of every step), its profile, and
    `engine_plain_check`; returns the launches of each kernel."""
    cfg = cut_config(hf, layers, layers - 1, torch.bfloat16)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = moe_decoder.init(cfg, gen, dtype=torch.bfloat16)
    n_params = count_params(params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = (f"{name} widths, {cfg.num_layers} of {hf['num_hidden_layers']} layers "
             f"({cfg.first_k_dense} dense + {cfg.num_moe_layers} MoE, "
             f"{cfg.moe.n_routed_experts} experts), yarn, bf16, {n_params} params")
    launches = {}
    for phase, kernel in pools:
        sc = SERVE if kernel == "K6" else dataclasses.replace(SERVE, kv_cache_dtype="int8")
        engine = ServingEngine(params, cfg, sc)
        launches[kernel], _ = serve_run(engine, cfg, card, phase, model, kernel, setup_s)
        profile_steps(engine, cfg, card, phase,
                      mla_cuda.KERNELS[kernel][mla_cuda.route(torch.bfloat16)])
        del engine
        torch.cuda.empty_cache()
        emit({"phase": f"{phase}_check", "card": card, "model": model,
              **engine_plain_check(phase, cfg, params, sc, kernel)})
        setup_s = 0.0
    del params
    torch.cuda.empty_cache()
    return launches


def train_dsv3_mtp_phase(card: str) -> dict:
    """DeepSeek-V3 training through the CLI at its published widths with
    yarn and the MTP head, cut to its first DSV3_MTP_LAYERS (dense) layers:
    DSV3_MTP_STEPS steps of DSV3_MTP_SEQ tokens. K1-K3 at <192, 128> on the
    main layers and the MTP block (forward twice under full remat); then,
    on one more batch, the main CE and the MTP CE apart. Returns the K1-K3
    launches."""
    from automodel_tpu_torch.models.moe_lm.mtp import mtp_hidden, mtp_loss

    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_dsv3_mtp_")
    hf = dict(DEEPSEEK_V3, num_hidden_layers=DSV3_MTP_LAYERS,
              first_k_dense_replace=DSV3_MTP_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    recipe = cli_main([moe_train_yaml(run_dir, "dsv3_mtp", hf, DSV3_MTP_SEQ,
                                      DSV3_MTP_STEPS)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel_launches(*FLASH)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    records = jsonl(Path(run_dir) / "training.jsonl")
    cfg = recipe.model_cfg
    # the main layers and the MTP block: K1 twice each (full remat)
    n = (cfg.num_layers + cfg.mtp_num_layers) * DSV3_MTP_STEPS
    want = {"K1": 2 * n, "K2": n, "K3": n}
    steady = records[1:]
    tps = statistics.median(r["tps"] for r in steady)
    params = recipe.train_state.params
    batch = make_global_batch(next(iter(recipe.dataloader)), "cuda")
    with torch.no_grad():  # the layers cast the fp32 masters, as in a step
        hidden, _ = moe_decoder.forward(params, cfg, batch["input_ids"], return_hidden=True)
        kernel = moe_decoder.head_kernel(params, cfg)
        ce, n_tok = fused_linear_cross_entropy(hidden, kernel, batch["labels"],
                                               chunk_size=2048)
        mtp_ce, n_mtp = mtp_loss(mtp_hidden(params, cfg, hidden, batch["input_ids"]),
                                 kernel, batch["labels"], chunk_size=2048)
    main_loss, mtp_loss_value = float(ce / n_tok), float(mtp_ce / n_mtp)
    emit({
        "phase": "train_dsv3_mtp", "card": card,
        "model": f"DeepSeek-V3 widths, {cfg.num_layers} dense layers + the MTP head, "
                 f"yarn (attn_scale {cfg.attn_scale:.5f}), {cfg.dtype}, remat "
                 f"{cfg.remat_policy}",
        "cut": "61 -> 2 layers, the dense prefix: one MoE layer's fp32 masters, "
               "gradients and AdamW moments need ~180 GB",
        "params": count_params(params), "mtp_params": count_params(params["mtp"]),
        "steps": len(records), "tokens_per_step": DSV3_MTP_SEQ,
        "losses": [r["loss"] for r in records],
        "grad_norms": [r["grad_norm"] for r in records],
        "main_loss_after": main_loss, "mtp_loss_after": mtp_loss_value,
        "ms_per_step": DSV3_MTP_SEQ / tps * 1e3, "tokens_per_s": tps,
        "mfu_pct": statistics.median(r["mfu_pct"] for r in steady),
        "flops_per_token": cfg.flops_per_token(DSV3_MTP_SEQ),
        "wall_s_with_setup": wall_s, "peak_mem_gib": peak_gib,
        "launches": launches, "expected_launches": want,
    })
    values = [r["loss"] for r in records] + [r["grad_norm"] for r in records]
    if len(records) != DSV3_MTP_STEPS or not all(math.isfinite(x) for x in values):
        raise AssertionError(f"train_dsv3_mtp: {len(records)} records, or non-finite: {records}")
    if not (math.isfinite(main_loss) and math.isfinite(mtp_loss_value)):
        raise AssertionError(f"train_dsv3_mtp: losses {main_loss}, {mtp_loss_value}")
    if launches != want:
        raise AssertionError(f"train_dsv3_mtp: K1-K3 launches {launches}, expected {want}")
    del recipe, params, hidden, kernel
    torch.cuda.empty_cache()
    return launches


def train_moe_capacity_phase(card: str, dropless_ms: float) -> None:
    """train_moe's recipe (Moonlight widths, 4 layers) with the capacity
    dispatcher, CAPACITY_STEPS steps: ms per step beside train_moe's
    dropless run, and the share of routed (token, expert) pairs the
    capacity dropped, counted on the device over every dispatch of the
    run (remat's recomputations included)."""
    from automodel_tpu_torch.moe import layer as moe_layer

    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_moe_capacity_")
    dispatch = moe_layer.dispatch_tensors
    kept = torch.zeros((), dtype=torch.float64, device="cuda")
    routed = torch.zeros((), dtype=torch.float64, device="cuda")

    def counted(cfg, indices, weights, capacity, dtype=torch.float32):
        d, c = dispatch(cfg, indices, weights, capacity, dtype)
        kept.add_(d.sum(dtype=torch.float64))
        routed.add_((indices < cfg.n_routed_experts).sum())
        return d, c

    hf = dict(MOONLIGHT, num_hidden_layers=MOE_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    moe_layer.dispatch_tensors = counted
    try:
        recipe = cli_main([moe_train_yaml(run_dir, "moonlight_capacity", hf, MOE_TRAIN_SEQ,
                                          CAPACITY_STEPS, moe_dispatcher="capacity")])
        torch.cuda.synchronize()
    finally:
        moe_layer.dispatch_tensors = dispatch
    records = jsonl(Path(run_dir) / "training.jsonl")
    steady = records[1:]
    ms = MOE_TRAIN_SEQ / statistics.median(r["tps"] for r in steady) * 1e3
    dropped = 1.0 - kept.item() / max(routed.item(), 1.0)
    emit({"phase": "train_moe_capacity", "card": card,
          "model": f"Moonlight-16B-A3B widths, {MOE_TRAIN_LAYERS} layers, "
                   f"{recipe.model_cfg.moe.dispatcher} dispatcher, capacity_factor "
                   f"{recipe.model_cfg.moe.capacity_factor}",
          "steps": len(records), "losses": [r["loss"] for r in records],
          "grad_norms": [r["grad_norm"] for r in records],
          "ms_per_step": ms, "dropless_ms_per_step": dropless_ms,
          "ratio_to_dropless": ms / dropless_ms,
          "routed_pairs": routed.item(), "dropped_share": dropped,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    values = [r["loss"] for r in records] + [r["grad_norm"] for r in records]
    if len(records) != CAPACITY_STEPS or not all(math.isfinite(x) for x in values):
        raise AssertionError(f"train_moe_capacity: {records}")
    if recipe.model_cfg.moe.dispatcher != "capacity" or routed.item() == 0:
        raise AssertionError("train_moe_capacity: the capacity dispatcher did not run")
    del recipe
    torch.cuda.empty_cache()


# Qwen3-30B-A3B (https://huggingface.co/Qwen/Qwen3-30B-A3B/blob/main/config.json):
# 48 GQA layers (32 q / 4 kv heads of 128, per-head q/k norms), each with
# 128 experts of 768, 8 per token, renormalized; 30.5 B parameters, 56.9
# GiB in bf16
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"], "vocab_size": 151936,
    "hidden_size": 2048, "intermediate_size": 6144, "moe_intermediate_size": 768,
    "num_hidden_layers": 48, "num_attention_heads": 32, "num_key_value_heads": 4,
    "head_dim": 128, "num_experts": 128, "num_experts_per_tok": 8,
    "norm_topk_prob": True, "decoder_sparse_step": 1, "mlp_only_layers": [],
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "max_position_embeddings": 40960,
    "router_aux_loss_coef": 0.001, "tie_word_embeddings": False,
}
# gpt-oss-20b (https://huggingface.co/openai/gpt-oss-20b/blob/main/config.json):
# 24 layers alternating a 128-token window and full attention, 64 q / 8 kv
# heads of 64 with biases and one sink per head, 32 experts of 2880 (4 per
# token, biased router, the clamped swiglu at 7), yarn rope (factor 32);
# ~20.9 B parameters with bf16 experts (the checkpoint's are MXFP4)
GPT_OSS_20B = {
    "architectures": ["GptOssForCausalLM"], "vocab_size": 201088,
    "hidden_size": 2880, "intermediate_size": 2880, "num_hidden_layers": 24,
    "num_attention_heads": 64, "num_key_value_heads": 8, "head_dim": 64,
    "num_local_experts": 32, "num_experts_per_tok": 4, "experts_per_token": 4,
    "sliding_window": 128,
    "layer_types": ["sliding_attention", "full_attention"] * 12,
    "attention_bias": True, "swiglu_limit": 7.0, "rope_theta": 150000,
    "rope_scaling": {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                     "beta_slow": 1.0, "truncate": False,
                     "original_max_position_embeddings": 4096},
    "rms_norm_eps": 1e-5, "max_position_embeddings": 131072,
    "initial_context_length": 4096, "router_aux_loss_coef": 0.9,
    "tie_word_embeddings": False,
}
# Mixtral-8x7B (https://huggingface.co/mistralai/Mixtral-8x7B-v0.1/blob/main/config.json):
# 32 layers of 32 q / 8 kv heads of 128, 8 experts of 14336, 2 per token
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "vocab_size": 32000,
    "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8, "num_local_experts": 8,
    "num_experts_per_tok": 2, "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 32768, "router_aux_loss_coef": 0.02,
    "tie_word_embeddings": False,
}
# serve_gpt_oss is cut 24 -> 12 layers (6 windowed + sinks, 6 sinks alone;
# all 24 until the resilience phases needed the time); serve_mixtral is cut
# 32 -> 8 layers: all
# 32 are 46.7 B parameters, 93 GB in bf16; serve_qwen3_moe is cut 48 -> 16
# (all 48 took ~100 s with its two pools and profiles, and with the
# quantized-linear and DSA phases the script neared its 1200 s limit on a
# slow host), and to 8 to make room for the resilience phases: K4 / K5 and
# the expert products run the same path on every layer
QWEN3_SERVE_LAYERS, GPT_OSS_SERVE_LAYERS, MIXTRAL_SERVE_LAYERS = 8, 12, 8
# ... each profiled over 5 steps, not 10: the profiler's own processing of
# one 48-layer step's ~5700 launches took ~4 s on an H100's host
MOE_PROFILE_STEPS = 5
# train_qwen3_moe / train_gpt_oss: the training CLI at the published widths,
# cut to 4 and 2 layers: fp32 masters, gradients and AdamW moments take ~10
# GB a Qwen3-30B-A3B layer and ~13 GB a gpt-oss-20b one, beside ~10 and ~19
# GB for the embedding and the head; sequences of 4096 tokens, 5 steps
QWEN3_TRAIN_LAYERS, GPT_OSS_TRAIN_LAYERS = 4, 2
FAMILY_TRAIN_SEQ, FAMILY_TRAIN_STEPS = 4096, 5
# train_gpt_oss_check: 2 layers (one sliding, one full) at gpt-oss-20b widths
# in fp32, one step of 2 microbatches of this many tokens, kernels vs plain
GPT_OSS_CHECK_SEQ = 1024
# smoke_families: the eight GQA MoE families' smoke YAMLs as written (head
# dim 8, which K1-K3 run padded to 16), SMOKE_STEPS steps each through the
# CLI with the kernels and with the plain attention. Two set `ep: 2`, which
# the port refuses: they run with `--distributed.ep=1`.
SMOKE_FAMILIES = ("qwen3_moe_ep", "mixtral", "gpt_oss", "glm4_moe", "ernie4_5_moe",
                  "hunyuan_moe", "minimax_m2", "ling_v2")
SMOKE_STEPS = 3
# the two curves' largest relative gap: docs/PARITY.md's 1e-4 in fp32; in
# bf16 (qwen3_moe_ep's dtype) the two attentions round at other places.
# Readings on an H100 (chip_smoke.py's smoke_families): the sound gaps at
# most 1.8e-7 (fp32) and 3.38e-4 (bf16); the control's (the softmax scale
# taken from the padded head dim) at least 3.53e-4 (fp32) and 1.57e-3
# (bf16). Each limit lies between the two, and the phase fails if a
# control's gap does not pass it.
SMOKE_RTOL = {"float32": 1e-4, "bfloat16": 8e-4}


def gqa_moe_config(hf: dict, layers: int, dtype, **overrides):
    """A published GQA MoE config through its registry family, cut to its
    first `layers` layers."""
    cut = dict(hf, num_hidden_layers=layers)
    if "layer_types" in hf:
        cut["layer_types"] = hf["layer_types"][:layers]
    return get_model_spec(cut).config_from_hf(cut, dtype=dtype, **overrides), cut


def serve_gqa_moe_phase(card: str, name: str, hf: dict, layers: int,
                        pools: tuple) -> dict:
    """A published GQA MoE model at its full widths, its first `layers`
    layers, bf16, random weights from seed 0 (each expert stack drawn
    slice by slice in bf16, `models/common/layers._trunc_normal`), on each
    of `pools` ((phase, kernel): "K4" the fp pool, "K5" the int8 pool):
    `serve_run` on the serve traffic (the kernel on every layer of every
    step, each layer with its own window and sinks), its profile, and
    `engine_plain_check`; returns the launches of each kernel."""
    cfg, _ = gqa_moe_config(hf, layers, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = moe_decoder.init(cfg, gen, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = count_params(params)
    windows = decoder.layer_windows(cfg)
    model = (f"{name}, {cfg.num_layers} of {hf['num_hidden_layers']} layers, "
             f"{cfg.moe.n_routed_experts} experts (top {cfg.moe.experts_per_token}), "
             f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, "
             f"bf16, {n_params} params")
    emit({"phase": f"{pools[0][0]}_weights", "card": card, "model": model,
          "params": n_params, "weights_gib": n_params * 2 / 2**30,
          "draw_s": setup_s, "draw_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "windows": sorted({w or 0 for w in windows}),
          "sinked_layers": cfg.num_layers if cfg.attention_sinks else 0})
    launches = {}
    for phase, kernel in pools:
        sc = SERVE if kernel == "K4" else dataclasses.replace(SERVE, kv_cache_dtype="int8")
        engine = ServingEngine(params, cfg, sc)
        if engine._windows != [w or 0 for w in windows]:
            raise AssertionError(f"{phase}: the engine's windows {engine._windows}")
        launches[kernel], _ = serve_run(engine, cfg, card, phase, model, kernel, setup_s)
        profile_steps(engine, cfg, card, phase, PAGED_DEVICE_KERNELS[kernel],
                      n_steps=MOE_PROFILE_STEPS)
        del engine
        torch.cuda.empty_cache()
        emit({"phase": f"{phase}_check", "card": card, "model": model,
              **engine_plain_check(phase, cfg, params, sc, kernel)})
        setup_s = 0.0
    del params
    torch.cuda.empty_cache()
    return launches


def train_gqa_moe_phase(card: str, phase: str, name: str, hf: dict,
                        layers: int) -> dict:
    """The training CLI at a published GQA MoE config's widths, its first
    `layers` layers, on a YAML the phase writes (`moe_train_yaml`: bf16 over
    fp32 masters, full remat, FAMILY_TRAIN_SEQ tokens, microbatch 1):
    FAMILY_TRAIN_STEPS steps with finite losses and grad norms and the
    routers' `moe_load_imbalance`; K1 2 x layers x steps (all of them on
    the tensor cores at the head dims the kernels run), K2 and K3 half
    that; then one profiled step. Returns the K1-K3 launches."""
    run_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_")
    _, cut = gqa_moe_config(hf, layers, torch.bfloat16)
    D = hf["head_dim"]
    dims = fa_cuda.padded_head_dims(D, D)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    recipe = cli_main([moe_train_yaml(run_dir, phase, cut, FAMILY_TRAIN_SEQ,
                                      FAMILY_TRAIN_STEPS)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel_launches(*FLASH)
    counted = flash_counts(dims)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    records = jsonl(Path(run_dir) / "training.jsonl")
    cfg = recipe.model_cfg
    L = cfg.num_layers
    n = L * FAMILY_TRAIN_STEPS
    want = {"K1": 2 * n, "K2": n, "K3": n}
    steady = records[1:]  # step 1 carries the first-call set-up
    tps = statistics.median(r["tps"] for r in steady)

    mbs = [next(iter(recipe.dataloader))]
    prof, prof_wall_ms, prof_launches = profile_step(recipe, mbs, dims)
    by_name = device_ms_by_kernel(prof)
    busy_ms = sum(by_name.values())
    attn_ms = sum(v for k, v in by_name.items()
                  if any(f in k for f in fa_cuda.KERNELS["mma"]))
    self_dev = self_device_ms_by_op(prof)
    grouped_ms = self_dev.get("aten::_grouped_mm", 0.0)
    dense_gemm_ms = sum(self_dev.get(k, 0.0) for k in DENSE_GEMM_OPS)
    top = [[k[:80], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    emit({
        "phase": phase, "card": card,
        "model": f"{name} widths, {L} of {hf['num_hidden_layers']} layers, "
                 f"{cfg.moe.n_routed_experts} experts, heads of {D} (K1-K3 at "
                 f"{dims}), {cfg.dtype}, remat {cfg.remat_policy}",
        "params": count_params(recipe.train_state.params),
        "steps": len(records), "tokens_per_step": FAMILY_TRAIN_SEQ,
        "losses": [r["loss"] for r in records],
        "grad_norms": [r["grad_norm"] for r in records],
        "moe_load_imbalance": [r.get("moe_load_imbalance") for r in records],
        "ms_per_step": FAMILY_TRAIN_SEQ / tps * 1e3, "tokens_per_s": tps,
        "mfu_pct": statistics.median(r["mfu_pct"] for r in steady),
        "flops_per_token": cfg.flops_per_token(FAMILY_TRAIN_SEQ),
        "wall_s_with_setup": wall_s, "peak_mem_gib": peak_gib,
        "launches": launches, "launches_at_head_dims": counted, "expected_launches": want,
        "profiled_step": {
            "wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
            "flash_launches_counted": prof_launches,
            "attention_k1_k3_ms": attn_ms, "grouped_expert_gemm_ms": grouped_ms,
            "dense_gemm_ms": dense_gemm_ms,
            "other_ms": busy_ms - attn_ms - grouped_ms - dense_gemm_ms,
            "top_kernels_ms": top},
    })
    values = [r["loss"] for r in records] + [r["grad_norm"] for r in records]
    imbalance = [r.get("moe_load_imbalance") for r in records]
    if len(records) != FAMILY_TRAIN_STEPS or not all(math.isfinite(x) for x in values):
        raise AssertionError(f"{phase}: {len(records)} records, or non-finite: {records}")
    if not all(x is not None and math.isfinite(x) for x in imbalance):
        raise AssertionError(f"{phase}: moe_load_imbalance {imbalance}")
    if launches != want or counted != want:
        raise AssertionError(f"{phase}: K1-K3 launches {launches} (counted {counted}), "
                             f"expected {want}")
    if prof_launches != {"K1": 2 * L, "K2": L, "K3": L}:
        raise AssertionError(f"{phase}: the profiled step's K1-K3 launches {prof_launches}")
    del recipe, prof
    torch.cuda.empty_cache()
    return launches


def train_gpt_oss_check_phase() -> None:
    """fp32, 2 layers at gpt-oss-20b widths (one with the 128-token window,
    one full, sinks of random values on both), the balanced gate:
    `moe_check_step` on 2 microbatches of GPT_OSS_CHECK_SEQ tokens (K1-K3
    at <64, 64> on the CUDA cores, the sinks in torch); the sinks'
    gradient must agree too."""
    base, _ = gqa_moe_config(GPT_OSS_20B, 2, torch.float32, remat_policy="full")
    base = dataclasses.replace(base, moe=dataclasses.replace(base.moe, fake_balanced_gate=True))
    gen = torch.Generator(device="cuda").manual_seed(6)
    params0 = moe_decoder.init(base, gen)
    params0["moe_layers"]["sinks"] = torch.randn(
        params0["moe_layers"]["sinks"].shape, generator=gen, device="cuda")
    moe_check_step("train_gpt_oss_check", base, params0, GPT_OSS_CHECK_SEQ, 7)


@contextlib.contextmanager
def scale_from_padded_dim():
    """Within the block, K1-K3 run a padded head at the softmax scale of
    the padded head dim, not at the caller's (of the padded v dim where
    q/k is not padded, as MLA's q/k 16 with v 8): a deliberately wrong
    call, the control that shows what the smoke curves' tolerance can
    see."""
    saved = fa.kernels_forward, fa.kernels_backward

    def wrong(fn):
        def call(q, k, v, *args, scale, **kw):
            Dp, Dvp = fa_cuda.padded_head_dims(q.shape[-1], v.shape[-1])
            d, dp = (q.shape[-1], Dp) if Dp != q.shape[-1] else (v.shape[-1], Dvp)
            return fn(q, k, v, *args, scale=scale * (d / dp) ** 0.5, **kw)
        return call

    fa.kernels_forward, fa.kernels_backward = (wrong(f) for f in saved)
    try:
        yield
    finally:
        fa.kernels_forward, fa.kernels_backward = saved


def smoke_families_phase(card: str, phase: str = "smoke_families",
                         yamls: tuple = tuple(f"examples/llm_finetune/{f}_smoke.yaml"
                                              for f in SMOKE_FAMILIES)) -> dict:
    """Each YAML of `yamls` (SMOKE_FAMILIES' smoke YAMLs by default) through
    the CLI for SMOKE_STEPS steps, with the kernels (attn_impl "auto": K1-K3
    at head dim 8 padded to 16) and with the plain attention ("torch"), from
    the same seed: the loss curves within SMOKE_RTOL of each other, K1-K3
    launched only by the first, all at <16, 16>. A third run, the control,
    takes the kernels under `scale_from_padded_dim`: its gap to the plain
    curve must pass SMOKE_RTOL, or the tolerance could not see a wrong
    scale. Returns each YAML's K1-K3 launches, keyed by its name."""
    out = {}
    for yaml_path in yamls:
        fam = Path(yaml_path).stem.removesuffix("_smoke")
        losses, launches, at_16 = {}, {}, {}
        for run in ("auto", "torch", "control"):
            run_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{fam}_{run}_")
            impl = "torch" if run == "torch" else "auto"
            argv = [yaml_path, f"--run_dir={run_dir}", "--checkpoint.enabled=false",
                    f"--step_scheduler.max_steps={SMOKE_STEPS}", "--distributed.ep=1",
                    f"--model.attn_impl={impl}"]
            reset_counts()
            with scale_from_padded_dim() if run == "control" else contextlib.nullcontext():
                recipe = cli_main(argv)
            torch.cuda.synchronize()
            launches[run] = kernel_launches(*FLASH)
            at_16[run] = flash_counts((16, 16), ("mma", "fma"))
            dtype = str(recipe.model_cfg.dtype).removeprefix("torch.")
            mc = recipe.model_cfg
            # the heterogeneous engine's (q/k, v) head dims per geometry
            D = (mc.resolved_head_dim if hasattr(mc, "resolved_head_dim") else
                 sorted({(mc.geom(t).head_dim, mc.geom(t).vd) for t in mc.layer_types}))
            losses[run] = [r["loss"] for r in jsonl(Path(run_dir) / "training.jsonl")]
            del recipe

        def gap(run):
            return max(abs(a - b) / abs(b) for a, b in zip(losses[run], losses["torch"]))

        rel = gap("auto")
        emit({"phase": phase, "card": card, "yaml": yaml_path,
              "dtype": dtype, "head_dim": D, "kernel_head_dims": [16, 16],
              "losses": losses, "max_rel_err": rel, "rtol": SMOKE_RTOL[dtype],
              "control": "softmax scale from the padded head dim",
              "control_max_rel_err": gap("control"),
              "launches": launches["auto"], "launches_at_16": at_16["auto"],
              "plain_launches": launches["torch"]})
        if any(len(c) != SMOKE_STEPS for c in losses.values()):
            raise AssertionError(f"{phase} {fam}: {losses}")
        if not all(math.isfinite(x) for c in losses.values() for x in c):
            raise AssertionError(f"{phase} {fam}: non-finite losses {losses}")
        if launches["auto"]["K1"] == 0 or launches["auto"] != at_16["auto"] \
                or any(launches["torch"].values()):
            raise AssertionError(f"{phase} {fam}: K1-K3 launches {launches}, "
                                 f"at <16, 16> {at_16}")
        if rel > SMOKE_RTOL[dtype]:
            raise AssertionError(f"{phase} {fam}: kernel and plain curves differ: {rel}")
        if not gap("control") > SMOKE_RTOL[dtype]:
            raise AssertionError(f"{phase} {fam}: the control's curve is within "
                                 f"{SMOKE_RTOL[dtype]} of the plain one: {gap('control')}")
        out[fam] = launches["auto"]
    torch.cuda.empty_cache()
    return out


# --- the dense families, the encoders, the remat policies -------------------
# Qwen2.5-7B (https://huggingface.co/Qwen/Qwen2.5-7B/blob/main/config.json),
# nothing cut: 28 layers of 28 q / 4 kv heads of 128 (G 7) with qkv bias,
# 18944-wide MLP, untied head over 152064 ids, rope theta 1e6
QWEN25_7B = {
    "architectures": ["Qwen2ForCausalLM"], "vocab_size": 152064,
    "hidden_size": 3584, "intermediate_size": 18944, "num_hidden_layers": 28,
    "num_attention_heads": 28, "num_key_value_heads": 4,
    "max_position_embeddings": 131072, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "sliding_window": 131072, "use_sliding_window": False,
    "max_window_layers": 28, "tie_word_embeddings": False,
}
# serve_glm4 cuts GLM-4-9B-0414 to this many of its 40 layers (uncut before
# the resilience phases needed the time: every layer runs the same K4 at
# G 16)
GLM4_SERVE_LAYERS = 16
# GLM-4-9B-0414 (https://huggingface.co/THUDM/GLM-4-9B-0414/blob/main/config.json):
# 40 layers of 32 q / 2 kv heads of 128 (G 16), rotary on half of each head
# (interleaved), sandwich norms, qkv bias; 9.4 B parameters, 18.8 GB in bf16
GLM4_9B = {
    "architectures": ["Glm4ForCausalLM"], "vocab_size": 151552,
    "hidden_size": 4096, "intermediate_size": 13696, "num_hidden_layers": 40,
    "num_attention_heads": 32, "num_key_value_heads": 2, "head_dim": 128,
    "partial_rotary_factor": 0.5, "attention_bias": True, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "max_position_embeddings": 32768,
    "tie_word_embeddings": False,
}
# Baichuan2-7B-Base (https://huggingface.co/baichuan-inc/Baichuan2-7B-Base/
# blob/main/config.json): MHA, 32 heads of 128 (G 1), NormHead
BAICHUAN2_7B = {
    "architectures": ["BaichuanForCausalLM"], "vocab_size": 125696,
    "hidden_size": 4096, "intermediate_size": 11008, "num_hidden_layers": 32,
    "num_attention_heads": 32, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 4096, "tie_word_embeddings": False,
}
# nvidia/llama-3.2-nv-embedqa-1b-v2 (https://huggingface.co/nvidia/
# llama-3.2-nv-embedqa-1b-v2): Llama-3.2-1B's widths as a bidirectional
# encoder: 16 layers of 32 q / 8 kv heads of 64, llama3 rope scaling, tied
NV_EMBEDQA_1B = {
    "architectures": ["LlamaBidirectionalModel"], "vocab_size": 128256,
    "hidden_size": 2048, "intermediate_size": 8192, "num_hidden_layers": 16,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64,
    "max_position_embeddings": 131072, "rope_theta": 500000.0,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "rms_norm_eps": 1e-5, "tie_word_embeddings": True, "pooling": "avg",
}
# the K4 group sizes the serve phases had not run: Qwen2.5-7B's G 7,
# GLM-4-9B's G 16 (the split kernel's whole M tile), Baichuan2-7B's G 1
K4_GROUP_HEADS = {"qwen25_7b": (28, 4, 128), "glm4_9b": (32, 2, 128),
                  "baichuan2_7b": (32, 32, 128)}
# K1-K3's new shapes: the bi-encoder step's 2 x 64 rows of 512 tokens at
# the encoder's heads (no mask), one 4096-token row at Qwen2.5-7B's (causal)
FA_ENCODER_SHAPE = dict(B=128, S=512, Hq=32, Hkv=8, D=64, Dv=64)
FA_QWEN25_SHAPE = dict(B=1, S=4096, Hq=28, Hkv=4, D=128, Dv=128)
# train_qwen25_lora: llama_lora.yaml's peft section on Qwen2.5-7B uncut, the
# conditions of BASELINE.md's Qwen2.5-7B row (one GPU, seq 4096): microbatch
# 1, 2 accumulated, 5 steps; the adapters: 28 layers x r 16 x (in + out) of
# q (3584 -> 3584), k and v (3584 -> 512), o (3584 -> 3584)
QWEN25_LORA_STEPS = 5
QWEN25_LORA_TRAINABLE = 28 * 16 * ((3584 + 3584) * 2 + (3584 + 512) * 2)
# remat_policies: the same recipe (its fp32 base, 30.5 GB) under each
# policy, REMAT_STEPS steps of one microbatch of REMAT_SEQ tokens. "none"
# keeps every layer's activations and its bf16 weight copies (the frozen
# base's casts, which the products' backward reads): ~0.47 GB of weights
# and ~1.2 GB of activations a layer at 4096 tokens, 28 x 1.7 = 47 GB
# beside the base, past the card's 80 GB; at 2048 tokens ~1.07 GB a
# layer, 30 GB. The microbatch is cut, the depth is not
REMAT_ORDER = ("none", "dots", "dots_with_no_batch_dims", "checkpoint_dots", "full")
REMAT_SEQ, REMAT_STEPS, REMAT_RTOL, REMAT_PEAK_RTOL = 2048, 2, 1e-5, 1e-3
# train_encoders: the retrieval_bi_encoder CLI at NV_EMBEDQA_1B, 64 query /
# document pairs of 512 tokens a step (one forward of 128 rows), 5 steps;
# then llm_seq_cls on the same widths, 64 rows of 512 tokens, 2 steps; the
# check: 2 layers in fp32, 8 pairs, the documents' last 112 tokens padding
# in every other row, InfoNCE at temperature 1.0
ENCODER_SEQ, ENCODER_PAIRS, ENCODER_STEPS, SEQ_CLS_STEPS = 512, 64, 5, 2
ENCODER_CHECK_PAIRS, ENCODER_CHECK_PAD, ENCODER_CHECK_TEMPERATURE = 8, 112, 1.0
# smoke_dense_families: the new families' smoke YAMLs and the seq-cls and
# retrieval ones (head dim 8, padded to 16), as smoke_families runs its own
DENSE_SMOKE_YAMLS = tuple(f"examples/llm_finetune/{f}_smoke.yaml" for f in (
    "glm4", "ernie4_5", "hunyuan_dense", "baichuan", "ministral3")) + (
    "examples/llm_seq_cls/llama_seq_cls_smoke.yaml",
    "examples/retrieval/bi_encoder_smoke.yaml",
    "examples/retrieval/cross_encoder_smoke.yaml")


def qwen25_lora_yaml(path: Path, run_dir: Path) -> str:
    """llama_lora.yaml's peft section, optimizer and schedule on Qwen2.5-7B
    at its published config (random base from seed 0), bf16 over the fp32
    base, full remat, mock data of LORA_SEQ tokens over the whole
    vocabulary, microbatch 1, LORA_ACCUM accumulated, no checkpoint."""
    return lora_yaml(path, {"hf_config": dict(QWEN25_7B)}, run_dir, QWEN25_LORA_STEPS, {},
                     {"enabled": False}, False, vocab_size=QWEN25_7B["vocab_size"])


def train_qwen25_lora_phase(card: str):
    """The LoRA CLI recipe on Qwen2.5-7B uncut at seq 4096 (BASELINE.md's
    conditions): QWEN25_LORA_STEPS steps with K1-K3 on all 28 layers of
    every microbatch (K1 twice: the forward and the remat recompute), then
    one profiled step. Returns (the recipe, for remat_policies; the
    launches; the record)."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_qwen25_lora_"))
    try:
        reset_counts()
        recipe, setup_s, loop_s, setup_peak, peak = run_recipe(
            qwen25_lora_yaml(tmp / "lora.yaml", tmp / "run"))
        launches = kernel_launches(*FLASH)
        at_128 = flash_counts((128, 128))
        records = jsonl(tmp / "run" / "training.jsonl")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = recipe.model_cfg
    n = cfg.num_layers * LORA_ACCUM * QWEN25_LORA_STEPS
    want = {"K1": 2 * n, "K2": n, "K3": n}
    trainable = count_params(recipe.train_state.params)
    steady = records[1:]
    tps = statistics.median(r["tps"] for r in steady)
    mbs = [next(iter(recipe.dataloader)) for _ in range(LORA_ACCUM)]
    prof, prof_wall_ms, prof_launches = profile_step(recipe, mbs, (128, 128))
    by_name = device_ms_by_kernel(prof)
    busy_ms = sum(by_name.values())
    fa_ms = sum(v for k, v in by_name.items()
                if any(re.search(pat, k) for pat in DENSE_FA_KERNELS.values()))
    self_dev = self_device_ms_by_op(prof)
    gemm_ms = sum(self_dev.get(k, 0.0) for k in DENSE_GEMM_OPS)
    del prof
    record = {
        "phase": "train_qwen25_lora", "card": card,
        "model": f"Qwen2.5-7B, all {cfg.num_layers} layers, seq {LORA_SEQ}, {cfg.dtype} "
                 f"over the fp32 base, remat {cfg.remat_policy}; nothing cut",
        "peft": {"r": 16, "alpha": 32.0, "targets": ["q_proj", "k_proj", "v_proj", "o_proj"]},
        "trainable_params": trainable, "expected_trainable": QWEN25_LORA_TRAINABLE,
        "steps": len(records), "tokens_per_step": LORA_ACCUM * LORA_SEQ,
        "losses": [r["loss"] for r in records],
        "grad_norms": [r["grad_norm"] for r in records],
        "ms_per_step": LORA_ACCUM * LORA_SEQ / tps * 1e3, "tokens_per_s": tps,
        "mfu_pct": statistics.median(r["mfu_pct"] for r in steady),
        "tflops_per_device": statistics.median(r["tflops_per_device"] for r in steady),
        "flops_per_token": cfg.flops_per_token(LORA_SEQ),
        "reference_tokens_per_s": 14110.05,
        "reference": "BASELINE.md: Qwen2.5 7B, 1 GPU, seq 4096 (LoRA, H100)",
        "setup_s": setup_s, "loop_s": loop_s,
        "setup_peak_mem_gib": setup_peak, "peak_mem_gib": peak,
        "launches": launches, "launches_at_128": at_128, "expected_launches": want,
        "profiled_step": {"wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
                          "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
                          "flash_launches_counted": prof_launches,
                          "flash_kernels_ms": fa_ms, "dense_gemm_ms": gemm_ms},
    }
    emit(record)
    if trainable != QWEN25_LORA_TRAINABLE:
        raise AssertionError(f"train_qwen25_lora: {trainable} trainable parameters")
    if len(records) != QWEN25_LORA_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
        raise AssertionError(f"train_qwen25_lora: records {records}")
    if launches != want or at_128 != want:
        raise AssertionError(f"train_qwen25_lora: K1-K3 launches {launches} "
                             f"(at <128, 128> {at_128}); expected {want}")
    return recipe, launches, record


def remat_policies_phase(card: str, recipe) -> dict:
    """train_qwen25_lora's recipe (its base and first adapters) under each of
    REMAT_ORDER: the step-1 batch's LoRA gradients, then REMAT_STEPS steps of
    one REMAT_SEQ-token microbatch, from the same adapters and a fresh AdamW
    state. Losses and gradients must equal "full"'s within REMAT_RTOL
    (bitwise is expected: K1-K3 and the products use no atomics; which
    held is printed); peak memory must order none > dots >=
    dots_with_no_batch_dims > full, with checkpoint_dots equal to dots.
    Returns each policy's record."""
    base_cfg = recipe.model_cfg
    ds = MockDatasetConfig(num_samples=REMAT_STEPS, seq_len=REMAT_SEQ,
                           vocab_size=base_cfg.vocab_size, seed=3).build()
    batches = [make_global_batch(stack_microbatches([{k: v[None] for k, v in ds[i].items()}]),
                                 "cuda") for i in range(REMAT_STEPS)]
    init = tree_map(lambda t: t.detach().clone(), recipe.train_state.params)
    step_cfg = TrainStepConfig(max_grad_norm=recipe.cfg.get("max_grad_norm", 1.0))
    del recipe.train_state
    torch.cuda.empty_cache()
    out = {}
    for policy in REMAT_ORDER:
        recipe.model_cfg = dataclasses.replace(base_cfg, remat_policy=policy)
        loss_fn = recipe._make_loss_fn()
        params = tree_map(lambda t: t.clone().requires_grad_(), init)
        reset_counts()
        accumulate_grads(loss_fn, params, batches[0])
        # on the host, so no policy's peak carries an earlier one's
        grads = [p.grad.detach().cpu() for p in tree_leaves(params)]
        k1 = kernel_launches("K1")["K1"]
        for p in tree_leaves(params):
            p.grad = None
        state = init_train_state(params, recipe.tx)
        step = make_train_step(loss_fn, recipe.tx, recipe.lr_schedule, step_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        losses, times = [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        out[policy] = {"losses": losses, "grads": grads, "ms_per_step": times,
                       "peak_mem_gib": peak / 2**30,
                       "peak_above_start_bytes": peak - base_bytes,
                       "k1_launches_per_microbatch": k1}
        del state, params, metrics
        torch.cuda.empty_cache()
    recipe.model_cfg = base_cfg
    full = out["full"]
    summary = {}
    for policy, r in out.items():
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], full["losses"]))
        grad_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                       for a, b in zip(r["grads"], full["grads"]))
        bitwise = (r["losses"] == full["losses"]
                   and all(torch.equal(a, b) for a, b in zip(r["grads"], full["grads"])))
        summary[policy] = {k: r[k] for k in ("losses", "ms_per_step", "peak_mem_gib",
                                             "peak_above_start_bytes",
                                             "k1_launches_per_microbatch")}
        summary[policy].update(loss_max_rel_err=loss_err, grad_max_rel_err=grad_err,
                               bitwise_equal_to_full=bitwise)
    emit({"phase": "remat_policies", "card": card,
          "model": f"Qwen2.5-7B LoRA (train_qwen25_lora's recipe), {base_cfg.num_layers} "
                   f"layers, one microbatch of {REMAT_SEQ} tokens, {REMAT_STEPS} steps",
          "rtol": REMAT_RTOL, "policies": summary})
    for policy, r in summary.items():
        if r["loss_max_rel_err"] > REMAT_RTOL or r["grad_max_rel_err"] > REMAT_RTOL:
            raise AssertionError(f"remat_policies: {policy} leaves full: {r}")
    # what each policy holds above the step's start (the base, the adapters
    # and AdamW's state): checkpoint_dots is dots by another name, equal
    # to within the allocator's rounding (REMAT_PEAK_RTOL)
    peak = {p: r["peak_above_start_bytes"] for p, r in summary.items()}
    if not (peak["none"] > peak["dots"] >= peak["dots_with_no_batch_dims"] > peak["full"]
            and abs(peak["checkpoint_dots"] - peak["dots"]) <= REMAT_PEAK_RTOL * peak["dots"]):
        raise AssertionError(f"remat_policies: peak memory above the start {peak}")
    L = base_cfg.num_layers
    k1 = {p: r["k1_launches_per_microbatch"] for p, r in summary.items()}
    if k1 != {p: (L if p == "none" else 2 * L) for p in REMAT_ORDER}:
        raise AssertionError(f"remat_policies: K1 launches {k1}")
    return summary


def dense_serve_model(name: str, hf: dict, layers: int, dtype):
    """A published dense config through its registry family, cut to its
    first `layers` layers, with random weights from seed 0 in `dtype`;
    (config, params, description)."""
    cut = dict(hf, num_hidden_layers=layers)
    cfg = get_model_spec(cut).config_from_hf(cut, dtype=dtype)
    params = decoder.init(cfg, torch.Generator(device="cuda").manual_seed(0), dtype=dtype)
    D = cfg.resolved_head_dim
    return cfg, params, (f"{name}, {layers} of {hf['num_hidden_layers']} layers, "
                         f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {D} "
                         f"(rotary on {cfg.rope_dim}), {str(dtype).removeprefix('torch.')}, "
                         f"{count_params(params)} params")


def serve_glm4_phase(card: str) -> dict:
    """GLM-4-9B-0414 cut to GLM4_SERVE_LAYERS layers (bf16, seed-0 weights) on serve's
    traffic: the fp pool (K4, G 16, on every layer of every step) with a
    10-step profile, then the int8 pool (K5); then the engine at 2 layers
    in fp32 held to the plain version (`engine_check`). Returns the
    launches of K4 and K5."""
    t0 = time.perf_counter()
    cfg, params, model = dense_serve_model("GLM-4-9B-0414", GLM4_9B, GLM4_SERVE_LAYERS,
                                           torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches = {}
    engine = ServingEngine(params, cfg, SERVE)
    launches["K4"], _ = serve_run(engine, cfg, card, "serve_glm4", model, "K4", setup_s)
    profile_steps(engine, cfg, card, "serve_glm4", PAGED_DEVICE_KERNELS["K4"])
    del engine
    torch.cuda.empty_cache()
    engine = ServingEngine(params, cfg, dataclasses.replace(SERVE, kv_cache_dtype="int8"))
    launches["K5"], _ = serve_run(engine, cfg, card, "serve_glm4_int8", model, "K5", 0.0)
    del engine, params
    torch.cuda.empty_cache()
    cfg32, params32, _ = dense_serve_model("GLM-4-9B-0414", GLM4_9B, 2, torch.float32)
    engine_check("engine_glm4", cfg32, params32, dataclasses.replace(SERVE, num_pages=256),
                 ENGINE_LOGITS_TOL)
    del params32
    torch.cuda.empty_cache()
    return launches


def serve_dense_groups_phase(card: str) -> dict:
    """Qwen2.5-7B (G 7) and Baichuan2-7B (MHA, G 1, the NormHead) at their
    widths cut to 2 layers, bf16, on serve's traffic and the fp pool: K4
    on every layer of every step; Baichuan's engine also at 2 layers in
    fp32 held to the plain version. Returns each model's K4 launches."""
    out = {}
    for key, name, hf in (("qwen25_7b", "Qwen2.5-7B", QWEN25_7B),
                          ("baichuan2_7b", "Baichuan2-7B", BAICHUAN2_7B)):
        cfg, params, model = dense_serve_model(name, hf, 2, torch.bfloat16)
        engine = ServingEngine(params, cfg, SERVE)
        out[key], _ = serve_run(engine, cfg, card, f"serve_{key}", model, "K4", 0.0)
        del engine, params
        torch.cuda.empty_cache()
    cfg32, params32, _ = dense_serve_model("Baichuan2-7B", BAICHUAN2_7B, 2, torch.float32)
    engine_check("engine_baichuan2", cfg32, params32,
                 dataclasses.replace(SERVE, num_pages=256), ENGINE_LOGITS_TOL)
    del params32
    torch.cuda.empty_cache()
    return out


def encoder_yaml(path: Path, run_dir: Path, recipe: str, hf: dict, **over) -> str:
    """A bi-encoder (or seq-cls) recipe at `hf`'s widths: bf16 over fp32
    masters, full remat, ENCODER_PAIRS rows of ENCODER_SEQ tokens (mock
    pairs or labelled rows over the whole vocabulary), AdamW, no
    checkpoint; `over` replaces top-level sections."""
    seq_cls = recipe == "llm_seq_cls"
    cfg = {
        "recipe": recipe, "seed": 0, "run_dir": str(run_dir), "auto_resume": False,
        "model": {"hf_config": dict(hf), "dtype": "bfloat16", "remat_policy": "full"},
        "distributed": {"dp_shard": -1},
        "dataset": {
            "_target_": "automodel_tpu_torch.datasets.mock." + (
                "MockSeqClsDatasetConfig" if seq_cls else "MockRetrievalDatasetConfig"),
            "num_samples": ENCODER_PAIRS * ENCODER_STEPS, "seq_len": ENCODER_SEQ,
            "vocab_size": hf["vocab_size"]},
        "dataloader": {"microbatch_size": ENCODER_PAIRS, "grad_acc_steps": 1},
        "optimizer": {"name": "adamw", "lr": 1.0e-5, "weight_decay": 0.0},
        "lr_scheduler": {"style": "constant", "warmup_steps": 0},
        "step_scheduler": {"max_steps": SEQ_CLS_STEPS if seq_cls else ENCODER_STEPS,
                           "ckpt_every_steps": 1000},
        "checkpoint": {"enabled": False},
        "loss": {"chunk_size": 2048},
    }
    if seq_cls:
        cfg["seq_cls"] = {"num_labels": 4}
    else:
        cfg["retrieval"] = {"temperature": 0.05, "symmetric": True}
    cfg.update(over)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@contextlib.contextmanager
def flash_masks_seen():
    """Within the block, the (causal code, window) of every K1-K3 mask the
    autograd function makes is added to the yielded set."""
    seen = set()
    make = fa_cuda.mask_args

    def recorded(*args, **kw):
        m = make(*args, **kw)
        seen.add((m.code, m.window))
        return m

    fa_cuda.mask_args = recorded
    try:
        yield seen
    finally:
        fa_cuda.mask_args = make


def train_encoders_phase(card: str) -> dict:
    """The retrieval_bi_encoder CLI on a LlamaBidirectionalModel at
    llama-3.2-nv-embedqa-1b-v2's widths, uncut: ENCODER_STEPS steps of
    ENCODER_PAIRS pairs of ENCODER_SEQ tokens, K1-K3 at <64, 64> on every
    layer with no mask (code 0, no window: the pads' segment ids aside);
    then SEQ_CLS_STEPS steps of llm_seq_cls on
    LlamaBidirectionalForSequenceClassification at the same widths.
    Returns the bi-encoder run's K1-K3 launches."""
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_encoders_"))
    try:
        for phase, recipe_name, arch, steps in (
                ("train_bi_encoder", "retrieval_bi_encoder", "LlamaBidirectionalModel",
                 ENCODER_STEPS),
                ("train_seq_cls", "llm_seq_cls",
                 "LlamaBidirectionalForSequenceClassification", SEQ_CLS_STEPS)):
            hf = dict(NV_EMBEDQA_1B, architectures=[arch])
            path = encoder_yaml(tmp / f"{phase}.yaml", tmp / phase, recipe_name, hf)
            reset_counts()
            with flash_masks_seen() as masks:
                recipe, setup_s, loop_s, _, peak = run_recipe(path)
            launches = kernel_launches(*FLASH)
            at_64 = flash_counts((64, 64))
            records = jsonl(tmp / phase / "training.jsonl")
            L = recipe.model_cfg.num_layers
            want = {"K1": 2 * L * steps, "K2": L * steps, "K3": L * steps}
            # a step's rows: the queries and the documents, or the labelled rows
            tokens = ENCODER_PAIRS * ENCODER_SEQ * (1 if recipe_name == "llm_seq_cls" else 2)
            rec = {
                "phase": phase, "card": card,
                "model": f"{arch} at llama-3.2-nv-embedqa-1b-v2's widths, all {L} layers, "
                         f"bf16 over fp32 masters, remat full; nothing cut",
                "causal": recipe.model_cfg.causal, "tokens_per_step": tokens,
                "losses": [r["loss"] for r in records],
                "grad_norms": [r["grad_norm"] for r in records],
                "ms_per_step": [tokens / r["tps"] * 1e3 for r in records],
                "tokens_per_s": statistics.median(r["tps"] for r in records[1:]),
                "mfu_pct": statistics.median(r["mfu_pct"] for r in records[1:]),
                "mfu_note": "flops_per_token counts causal attention (JAX's formula): "
                            "the encoder's attention is undercounted",
                "num_correct": [r.get("num_correct") for r in records],
                "setup_s": setup_s, "loop_s": loop_s, "peak_mem_gib": peak,
                "flash_masks": sorted(masks), "launches": launches,
                "launches_at_64": at_64, "expected_launches": want,
            }
            emit(rec)
            del recipe
            torch.cuda.empty_cache()
            if recipe_name == "retrieval_bi_encoder":
                out = launches
            if rec["causal"] or masks != {(0, 0)}:
                raise AssertionError(f"{phase}: not the unmasked encoder: {rec}")
            if len(records) != steps or not all(
                    math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                    for r in records):
                raise AssertionError(f"{phase}: records {records}")
            if launches != want or at_64 != want:
                raise AssertionError(f"{phase}: K1-K3 launches {launches} (at <64, 64> "
                                     f"{at_64}); expected {want}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def train_encoders_check_phase() -> None:
    """fp32, 2 layers at NV_EMBEDQA_1B's widths: the bi-encoder recipe's
    loss on one batch of ENCODER_CHECK_PAIRS pairs (every other document
    ending in ENCODER_CHECK_PAD pad tokens) from the same weights with
    attn_impl "flash" (K1-K3 non-causal over the pads' segments) and
    "torch": loss and every gradient leaf within TRAIN_LOSS_RTOL /
    TRAIN_GRAD_TOL, as train_gemma_check."""
    hf = dict(NV_EMBEDQA_1B, num_hidden_layers=2)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_encoder_check_"))
    # at the recipe's 0.05 a random encoder's pools of a pair already match
    # (loss ~1e-7 in a first card run): at 1.0 the loss and its gradients
    # are O(1), so the check can see a wrong kernel
    retrieval = {"temperature": ENCODER_CHECK_TEMPERATURE, "symmetric": True}
    try:
        ds = MockRetrievalDatasetConfig(num_samples=ENCODER_CHECK_PAIRS, seq_len=ENCODER_SEQ,
                                        vocab_size=hf["vocab_size"], seed=7).build()
        mb = {k: np.stack([ds[i][k] for i in range(ENCODER_CHECK_PAIRS)]) for k in ds[0]}
        mb["doc_mask"][::2, -ENCODER_CHECK_PAD:] = 0
        batch = make_global_batch(stack_microbatches([mb]), "cuda")
        results, params0 = {}, None
        for impl in ("flash", "torch"):
            cfg = parse_args_and_load_config([encoder_yaml(
                tmp / f"{impl}.yaml", tmp / impl, "retrieval_bi_encoder", hf,
                model={"hf_config": hf, "dtype": "float32", "remat_policy": "full",
                       "attn_impl": impl}, retrieval=retrieval)])
            recipe = resolve_recipe_class(cfg)(cfg)
            recipe.setup()
            if params0 is None:
                params0 = tree_map(lambda t: t.detach().clone(), recipe.train_state.params)
            params = tree_map(lambda t: t.clone().requires_grad_(), params0)
            reset_counts()
            ce, aux = accumulate_grads(recipe._loss_fn, params, batch)
            results[impl] = (float(ce / aux["num_label_tokens"]),
                             [t.grad for t in tree_leaves(params)],
                             kernel_launches()["K1"])
            del recipe, params
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (loss_f, g_f, n_f), (loss_t, g_t, n_t) = results["flash"], results["torch"]
    grad_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                   for a, b in zip(g_f, g_t))
    loss_rel = abs(loss_f - loss_t) / abs(loss_t)
    emit({"phase": "train_encoders_check", "layers": 2, "dtype": "float32",
          "pairs": ENCODER_CHECK_PAIRS, "seq": ENCODER_SEQ, "pad": ENCODER_CHECK_PAD,
          "temperature": ENCODER_CHECK_TEMPERATURE,
          "loss_flash": loss_f, "loss_torch": loss_t, "loss_rel_err": loss_rel,
          "loss_rtol": TRAIN_LOSS_RTOL, "grad_max_rel_err": grad_err,
          "grad_tol": TRAIN_GRAD_TOL, "k1_launches": [n_f, n_t]})
    if n_f == 0 or n_t != 0:
        raise AssertionError("train_encoders_check: attn_impl did not select the kernels / plain path")
    if loss_rel > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_TOL:
        raise AssertionError("train_encoders_check: the step differs between kernels and plain")


# --- the token-bin corpus, the MoE architectures on the registry, chat SFT ---
# train_tokenbin: TRAIN_YAML at its full width cut to TOKENBIN_LAYERS layers,
# TOKENBIN_STEPS steps of TOKENBIN_MICROBATCH sequences of TOKENBIN_SEQ
# tokens, its dataset a TokenBinDatasetConfig (int32: Llama-3's 128256 ids
# do not fit uint16) over a corpus written from seed 0: TOKENBIN_TOKENS
# tokens (256 MiB) in documents of log-uniform length 16-32768, with wandb
# and mlflow sections (their JSONL mirrors where the packages are missing)
# and gc_control on, a collection every 2 steps
TOKENBIN_TOKENS = 64 * 2**20
TOKENBIN_DOC_LENS = (16, 32768)
TOKENBIN_LAYERS, TOKENBIN_STEPS, TOKENBIN_SEQ, TOKENBIN_MICROBATCH = 2, 5, 4096, 2
TOKENBIN_GC_EVERY = 2
# GLM-4.7-Flash (huggingface.co/zai-org/GLM-4.7-Flash, config.json):
# Glm4MoeLiteForCausalLM, MLA (20 heads, q_lora 768, kv_lora 512, qk 192 +
# 64 rope, v 256) over 1 dense + 46 MoE layers of 64 experts (top 4) and a
# shared one, an MTP layer
GLM47_FLASH = {
    "architectures": ["Glm4MoeLiteForCausalLM"], "vocab_size": 154880,
    "hidden_size": 2048, "intermediate_size": 10240, "moe_intermediate_size": 1536,
    "num_hidden_layers": 47, "num_attention_heads": 20, "num_key_value_heads": 20,
    "n_shared_experts": 1, "n_routed_experts": 64, "routed_scaling_factor": 1.8,
    "kv_lora_rank": 512, "q_lora_rank": 768, "qk_rope_head_dim": 64,
    "qk_nope_head_dim": 192, "v_head_dim": 256, "n_group": 1, "topk_group": 1,
    "num_experts_per_tok": 4, "first_k_dense_replace": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc", "rope_theta": 1000000,
    "rms_norm_eps": 1e-5, "max_position_embeddings": 202752,
    "num_nextn_predict_layers": 1, "tie_word_embeddings": False,
}
# K6 / K7 at GLM-4.7-Flash's 20 heads x r 512: one whole head tile of the
# bf16 split kernel and a partial one of 4
GLM47_MLA = (20, 512, 64)
# serve_glm47_flash / _int8: GLM-4.7-Flash at full width, its first
# GLM47_SERVE_LAYERS layers (1 dense, the rest MoE), seq-0 bf16 weights;
# cut 47 -> 16 as serve_qwen3_moe was (all 47 took 116 s), and to 8 to make
# room for the resilience phases
GLM47_SERVE_LAYERS = 8
# train_glm47_flash: the training CLI at GLM-4.7-Flash's widths cut to 2
# layers (1 dense + 1 MoE) and its MTP layer, GLM47_TRAIN_STEPS steps of
# GLM47_TRAIN_SEQ tokens; K1-K3 at <256, 256>
GLM47_TRAIN_LAYERS, GLM47_TRAIN_SEQ, GLM47_TRAIN_STEPS = 2, 4096, 3
FA_GLM47_SHAPE = dict(B=1, S=4096, Hq=20, Hkv=20, D=256, Dv=256)
# serve_mistral4: Mistral4ForCausalLM at DeepSeek-V3's published widths, cut
# to 2 layers (1 dense + 1 MoE), with Llama-4's q-rope scaling at beta 0.1
# over original_max_position_embeddings 256, so serve's positions (to ~930)
# take four values of the scale (the published 8192 would leave it 1)
MISTRAL4_ROPE = {"llama_4_scaling_beta": 0.1, "original_max_position_embeddings": 256}
# smoke_moe_lite: the three new families' smoke YAMLs, as smoke_families
MOE_LITE_SMOKE_YAMLS = tuple(f"examples/llm_finetune/{f}_smoke.yaml"
                             for f in ("glm4_moe_lite", "mistral4", "hy_mt2"))
# --- the heterogeneous MoE engine and Gemma-4 MoE ----------------------------
# XiaomiMiMo/MiMo-V2-Flash config.json, written from recall (no file can be
# fetched here) and checked against the published totals, 309 B parameters
# and 15 B active, which these widths give (308.6 B, 15.2 B): 48 layers,
# global at every sixth and the last (the JAX function's default pattern),
# 64 q heads of q/k 192 and v 128 on both types, 4 kv heads on the global
# layers (G 16) and 8 on the sliding ones (G 8), window 128 with sink
# logits on the sliding layers only, 64 rotary channels of 192, 256 routed
# experts of 2048 (top 8), the first layer's MLP dense
MIMO_V2_FLASH = {
    "architectures": ["MiMoV2FlashForCausalLM"], "model_type": "mimo_v2_flash",
    "vocab_size": 152576, "hidden_size": 4096, "intermediate_size": 16384,
    "num_hidden_layers": 48, "num_attention_heads": 64, "num_key_value_heads": 4,
    "head_dim": 192, "v_head_dim": 128, "swa_num_attention_heads": 64,
    "swa_num_key_value_heads": 8, "swa_head_dim": 192, "swa_v_head_dim": 128,
    "sliding_window": 128,
    "hybrid_layer_pattern": [0 if (i % 6 == 0 or i == 47) else 1 for i in range(48)],
    "rope_theta": 5000000.0, "swa_rope_theta": 10000.0, "partial_rotary_factor": 0.334,
    "add_full_attention_sink_bias": False, "add_swa_attention_sink_bias": True,
    "n_routed_experts": 256, "num_experts_per_tok": 8, "moe_intermediate_size": 2048,
    "moe_layer_freq": [0] + [1] * 47, "n_shared_experts": 0, "scoring_func": "sigmoid",
    "n_group": 1, "topk_group": 1, "norm_topk_prob": True,
    "layernorm_epsilon": 1e-5, "max_position_embeddings": 262144,
    "tie_word_embeddings": False,
}
# google/gemma-4-26B-A4B config.json (text_config), written from recall and
# checked against the model card's totals, 25.2 B parameters and 3.8 B
# active, which these widths give (25.1 B, 3.75 B): 30 layers, five sliding
# (window 1024) to one global, 16 q / 8 kv heads of 256, 128 experts of
# 704 (top 8) beside a 2112-wide dense MLP, vocabulary 262144, tied. The
# JAX config holds one head dim and kv-head count for both layer types, so
# whatever the published global layers do beyond that is not expressed
GEMMA4_26B_A4B = {
    "architectures": ["Gemma4ForConditionalGeneration"], "model_type": "gemma4",
    "tie_word_embeddings": True,
    "text_config": {
        "vocab_size": 262144, "hidden_size": 2816, "intermediate_size": 2112,
        "num_hidden_layers": 30, "num_attention_heads": 16, "num_key_value_heads": 8,
        "head_dim": 256,
        "layer_types": ["full_attention" if (i + 1) % 6 == 0 else "sliding_attention"
                        for i in range(30)],
        "sliding_window": 1024, "rope_theta": 1000000.0, "rope_local_base_freq": 10000.0,
        "query_pre_attn_scalar": 256, "num_kv_shared_layers": 0,
        "num_experts": 128, "top_k_experts": 8, "moe_intermediate_size": 704,
        "rms_norm_eps": 1e-6, "max_position_embeddings": 262144,
    },
}
# train_chat_sft: llm_finetune at Llama-3.2-1B's widths (NV_EMBEDQA_1B's,
# causal), uncut, on an AgentChatDatasetConfig over CHAT_SFT_CONVERSATIONS
# tool-calling conversations written from seed 0, seq CHAT_SFT_SEQ,
# CHAT_SFT_MICROBATCH rows a step, CHAT_SFT_STEPS steps, a validation pass
# with validation_generation at the last step
CHAT_SFT_CONVERSATIONS, CHAT_SFT_VAL = 512, 8
CHAT_SFT_SEQ, CHAT_SFT_MICROBATCH, CHAT_SFT_STEPS = 2048, 4, 5
CHAT_SFT_USER_CHARS = 96  # every user turn padded to this many characters
CHAT_SFT_NEW_TOKENS = 128


def write_token_corpus(prefix: Path, seed: int = 0) -> tuple[np.ndarray, float]:
    """TOKENBIN_TOKENS int32 token ids below Llama-3's vocabulary in
    documents of log-uniform length TOKENBIN_DOC_LENS (the last one cut to
    the total), as `<prefix>.bin` and `<prefix>.doclens.npy`; returns (the
    document lengths, seconds)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    lo, hi = (math.log(x) for x in TOKENBIN_DOC_LENS)
    lens = np.exp(rng.uniform(lo, hi, 2 * TOKENBIN_TOKENS // 4000)).astype(np.int64)
    ends = np.cumsum(lens)
    n = int(np.searchsorted(ends, TOKENBIN_TOKENS)) + 1
    lens = lens[:n]
    lens[-1] -= int(ends[n - 1]) - TOKENBIN_TOKENS
    assert lens.sum() == TOKENBIN_TOKENS and lens[-1] > 0
    rng.integers(0, LLAMA3_8B["vocab_size"], TOKENBIN_TOKENS,
                 dtype=np.int32).tofile(f"{prefix}.bin")
    np.save(f"{prefix}.doclens.npy", lens.astype(np.int32))
    return lens, time.perf_counter() - t0


def plain_token_rows(prefix: Path, doc_lens: np.ndarray, doc_order: np.ndarray,
                     rows: list[int], seq: int) -> np.ndarray:
    """The tokens of samples `rows` of the sample map, gathered from the
    memmap by a plain loop: sample r is the (seq + 1) tokens from position
    r (seq + 1) of the documents concatenated in `doc_order`."""
    tokens = np.memmap(f"{prefix}.bin", dtype=np.int32, mode="r")
    starts = np.concatenate([[0], np.cumsum(doc_lens, dtype=np.int64)])
    shuffled_ends = np.cumsum(doc_lens[doc_order].astype(np.int64))
    out = []
    for r in rows:
        sample = []
        for p in range(r * (seq + 1), (r + 1) * (seq + 1)):
            k = int(np.searchsorted(shuffled_ends, p, side="right"))
            offset = p - (int(shuffled_ends[k - 1]) if k else 0)
            sample.append(int(tokens[starts[doc_order[k]] + offset]))
        out.append(sample)
    return np.asarray(out, np.int64)


TRACKER_PACKAGES = {"wandb": "wandb", "mlflow": "mlflow", "comet": "comet_ml"}


def tracker_mirrors(run_dir: Path, records: list, kinds=("wandb", "mlflow")) -> dict:
    """Each tracker's JSONL mirror held to `training.jsonl`: the config line
    first, then one line per record with the record's values, then
    "FINISHED". Returns each mirror's count of metric lines; a tracker
    with no mirror must have its package installed (wandb, where present,
    writes an offline run under `run_dir`), and is reported as such."""
    import importlib.util

    out = {}
    for kind in kinds:
        if not (run_dir / f"{kind}_metrics.jsonl").exists():
            if importlib.util.find_spec(TRACKER_PACKAGES[kind]) is None:
                raise AssertionError(f"{kind}: no mirror, and no package")
            out[kind] = "package installed: its own run, no mirror"
            continue
        lines = jsonl(run_dir / f"{kind}_metrics.jsonl")
        metrics = [{k: v for k, v in l.items() if k != "ts"} for l in lines[1:-1]]
        want = [{k: v for k, v in r.items() if k != "ts"} for r in records]
        if "_config" not in lines[0] or lines[-1].get("_status") != "FINISHED" \
                or metrics != want:
            raise AssertionError(f"{kind} mirror differs from training.jsonl: {lines}")
        out[kind] = len(metrics)
    return out


def train_tokenbin_phase(card: str) -> dict:
    """TRAIN_YAML at full width, TOKENBIN_LAYERS layers, on the token-bin
    corpus: the native index build timed alone, the loader's ms per batch
    beside the step's, the first step's rows equal to `plain_token_rows`,
    the tracker mirrors equal to `training.jsonl`, GC off during the steps
    and on after, K1-K3 counted. Returns the run's K1-K3 launches."""
    import gc

    from automodel_tpu_torch.datasets.megatron import gpt_dataset, index_helpers

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tokenbin_"))
    try:
        prefix = tmp / "corpus"
        doc_lens, write_s = write_token_corpus(prefix)
        t0 = time.perf_counter()
        index_helpers._load()  # g++, once per checkout
        compile_s = time.perf_counter() - t0
        ds_kw = dict(prefix=str(prefix), seq_len=TOKENBIN_SEQ, seed=0, dtype="int32")
        t0 = time.perf_counter()
        ds = gpt_dataset.TokenBinDatasetConfig(**ds_kw).build()
        index_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds.set_epoch(1)
        epoch_s = time.perf_counter() - t0
        ds.set_epoch(0)  # the epoch the run reads
        spanning = int((np.diff(ds.sample_idx[:, 0]) > 0).sum())
        cfg = yaml.safe_load(Path(TRAIN_YAML).read_text())
        cfg["model"]["hf_config"]["num_hidden_layers"] = TOKENBIN_LAYERS
        cfg.update(
            run_dir=str(tmp / "run"), checkpoint={"enabled": False},
            dataset={"_target_": "automodel_tpu.datasets.megatron.gpt_dataset."
                                 "TokenBinDatasetConfig", **ds_kw},
            dataloader={"microbatch_size": TOKENBIN_MICROBATCH, "grad_acc_steps": 1},
            step_scheduler={"max_steps": TOKENBIN_STEPS},
            wandb={"project": "chip_smoke", "mode": "offline"},
            mlflow={"experiment": "chip_smoke",
                    "tracking_uri": f"file:{tmp / 'run' / 'mlruns'}"},
            gc_control=True, gc_every_steps=TOKENBIN_GC_EVERY)
        yaml_path = tmp / "tokenbin.yaml"
        yaml_path.write_text(yaml.safe_dump(cfg))
        node = parse_args_and_load_config([str(yaml_path)])
        recipe = resolve_recipe_class(node)(node)
        recipe.setup()
        loader = recipe.dataloader
        order = loader._order()  # the loader's sample order, epoch 0
        # the loader's ms per batch, on a second loader over the same data
        probe = recipe.typed.dataloader.build(recipe.dataloader.dataset)
        it = iter(probe)
        t0 = time.perf_counter()
        for _ in range(8):
            stack_microbatches([next(it)])
        loader_ms = (time.perf_counter() - t0) / 8 * 1e3
        first, gc_during = [], []
        run_step = recipe.run_step

        def watched(microbatches):
            if not first:
                first.append([{k: np.asarray(v) for k, v in mb.items()}
                              for mb in microbatches])
            gc_during.append(gc.isenabled())
            return run_step(microbatches)

        recipe.run_step = watched
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        recipe.run_train_validation_loop()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = kernel_launches(*FLASH)
        gc_after = gc.isenabled()
        run_dir = tmp / "run"
        records = jsonl(run_dir / "training.jsonl")
        mirrors = tracker_mirrors(run_dir, records)
        got = first[0][0]["input_ids"].reshape(-1, TOKENBIN_SEQ)
        got_labels = first[0][0]["labels"].reshape(-1, TOKENBIN_SEQ)
        rows = [int(ds.sample_order[int(i)]) for i in order[:TOKENBIN_MICROBATCH]]
        want = plain_token_rows(prefix, doc_lens, ds.doc_order, rows, TOKENBIN_SEQ)
        tokens_per_step = TOKENBIN_MICROBATCH * TOKENBIN_SEQ
        steady = records[1:]
        step_ms = tokens_per_step / statistics.median(r["tps"] for r in steady) * 1e3
        n = TOKENBIN_LAYERS * TOKENBIN_STEPS
        want_launches = {"K1": 2 * n, "K2": n, "K3": n}
        emit({
            "phase": "train_tokenbin", "card": card,
            "model": f"Llama-3-8B widths, {TOKENBIN_LAYERS} of 32 layers, bf16, remat full",
            "corpus": {"tokens": TOKENBIN_TOKENS, "bytes": TOKENBIN_TOKENS * 4,
                       "documents": len(doc_lens), "doc_len_min": int(doc_lens.min()),
                       "doc_len_median": float(np.median(doc_lens)),
                       "doc_len_max": int(doc_lens.max()), "write_s": write_s},
            "index_compile_s": compile_s, "index_build_s": index_s,
            "index_epoch_s": epoch_s, "samples": len(ds),
            "samples_spanning_documents": spanning,
            "loader_ms_per_batch": loader_ms, "step_ms": step_ms,
            "loader_share_of_step": loader_ms / step_ms,
            "first_step_rows_equal_plain_gather": bool(
                np.array_equal(got, want[:, :-1]) and np.array_equal(got_labels, want[:, 1:])),
            "losses": [r["loss"] for r in records],
            "grad_norms": [r["grad_norm"] for r in records],
            "tokens_per_s": statistics.median(r["tps"] for r in steady),
            "mfu_pct": statistics.median(r["mfu_pct"] for r in steady),
            "wall_s": wall_s, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "tracker_mirror_lines": mirrors, "gc_enabled_during_steps": gc_during,
            "gc_enabled_after": gc_after, "launches": launches,
            "expected_launches": want_launches,
        })
        if len(records) != TOKENBIN_STEPS or not all(
                math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
            raise AssertionError(f"train_tokenbin: records {records}")
        if not (np.array_equal(got, want[:, :-1]) and np.array_equal(got_labels, want[:, 1:])):
            raise AssertionError("train_tokenbin: the first step's rows differ from the memmap's")
        if spanning == 0:
            raise AssertionError("train_tokenbin: no sample spans two documents")
        if any(gc_during) or not gc_after:
            raise AssertionError(f"train_tokenbin: GC during {gc_during}, after {gc_after}")
        if launches != want_launches:
            raise AssertionError(f"train_tokenbin: K1-K3 {launches}, expected {want_launches}")
        del recipe
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def serve_glm47_flash_phase(card: str) -> dict:
    """GLM-4.7-Flash through the registry at full width, GLM47_SERVE_LAYERS
    layers, bf16, seed-0 weights, on serve's traffic: the fp pool (K6) and
    the int8 pool (K7) at 20 heads on every layer of every step, each with
    its profile and `engine_plain_check`; then the engine at 2 layers in
    fp32 on both pools (the fp32 route at 20 heads), every kernel call held
    to its plain version. Returns the bf16 runs' launches."""
    cfg = cut_config(GLM47_FLASH, GLM47_SERVE_LAYERS, 1, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = moe_decoder.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                              dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = count_params(params)
    model = (f"GLM-4.7-Flash, {cfg.num_layers} of {GLM47_FLASH['num_hidden_layers']} "
             f"layers ({cfg.first_k_dense} dense + {cfg.num_moe_layers} MoE, "
             f"{cfg.moe.n_routed_experts} experts), {cfg.num_heads} heads x r "
             f"{cfg.mla_kv_lora_rank}, bf16, {n_params} params")
    emit({"phase": "serve_glm47_flash_weights", "card": card, "model": model,
          "params": n_params, "weights_gib": n_params * 2 / 2**30, "draw_s": setup_s,
          "draw_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    launches = {}
    for phase, kernel in (("serve_glm47_flash", "K6"), ("serve_glm47_flash_int8", "K7")):
        sc = SERVE if kernel == "K6" else dataclasses.replace(SERVE, kv_cache_dtype="int8")
        engine = ServingEngine(params, cfg, sc)
        launches[kernel], _ = serve_run(engine, cfg, card, phase, model, kernel, setup_s)
        profile_steps(engine, cfg, card, phase,
                      mla_cuda.KERNELS[kernel][mla_cuda.route(torch.bfloat16)],
                      n_steps=MOE_PROFILE_STEPS)
        del engine
        torch.cuda.empty_cache()
        emit({"phase": f"{phase}_check", "card": card, "model": model,
              **engine_plain_check(phase, cfg, params, sc, kernel)})
        setup_s = 0.0
    del params
    torch.cuda.empty_cache()
    cfg32 = cut_config(GLM47_FLASH, 2, 1, torch.float32)
    params = moe_decoder.init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                              dtype=torch.float32)
    for phase, kernel in (("engine_glm47_flash", "K6"), ("engine_glm47_flash_int8", "K7")):
        sc = SERVE if kernel == "K6" else dataclasses.replace(SERVE, kv_cache_dtype="int8")
        emit({"phase": phase, "card": card,
              "model": "GLM-4.7-Flash widths, 2 layers (1 dense + 1 MoE), fp32",
              "kernel_route": mla_cuda.route(torch.float32),
              "head_tile": mla_cuda.head_tile(GLM47_MLA[0], GLM47_MLA[1]),
              **engine_plain_check(phase, cfg32, params, sc, kernel)})
    del params
    torch.cuda.empty_cache()
    return launches


def serve_mistral4_phase(card: str) -> int:
    """Mistral4ForCausalLM through the registry at DeepSeek-V3's widths, 2
    layers, with MISTRAL4_ROPE: serve's traffic on the fp pool (K6 on every
    layer of every step) and `engine_plain_check`; the control, the same
    weights and traffic with the scaling off, must give other greedy tokens
    (the scale reaches K6's queries). Returns the run's K6 launches."""
    hf = dict(DEEPSEEK_V3, architectures=["Mistral4ForCausalLM"],
              rope_parameters=MISTRAL4_ROPE)
    cfg = cut_config(hf, 2, 1, torch.bfloat16)
    t0 = time.perf_counter()
    params = moe_decoder.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                              dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = (f"Mistral-4 (DeepSeek-V3 widths), 2 layers (1 dense + 1 MoE), q-rope "
             f"beta {cfg.mla_qpe_scaling_beta} over {cfg.mla_qpe_scaling_orig_max}, "
             f"bf16, {count_params(params)} params")
    engine = ServingEngine(params, cfg, SERVE)
    k6, res = serve_run(engine, cfg, card, "serve_mistral4", model, "K6", setup_s)
    del engine
    max_pos = max(len(r.prompt) + len(o) - 1 for r, o in zip(
        serve_traffic(cfg.vocab_size), res["outputs"]))
    scales = sorted({1 + cfg.mla_qpe_scaling_beta * math.log1p(p // cfg.mla_qpe_scaling_orig_max)
                     for p in range(max_pos + 1)})
    check = engine_plain_check("serve_mistral4", cfg, params, SERVE, "K6")
    off = ServingEngine(params, dataclasses.replace(cfg, mla_qpe_scaling_beta=None), SERVE)
    control = off.serve_batch(serve_traffic(cfg.vocab_size))
    del off
    same = sum(a == b for o1, o2 in zip(res["outputs"], control["outputs"])
               for a, b in zip(o1, o2))
    total = sum(len(o) for o in res["outputs"])
    emit({"phase": "serve_mistral4_check", "card": card, "model": model, **check,
          "max_position": max_pos, "q_rope_scales": scales,
          "control": "the same weights and traffic with the scaling off",
          "control_greedy_agreement": same / total})
    del params
    torch.cuda.empty_cache()
    if len(scales) < 3:
        raise AssertionError(f"serve_mistral4: the q-rope scale takes {scales}")
    if same == total:
        raise AssertionError("serve_mistral4: the control's tokens equal the scaled run's")
    return k6


def train_glm47_flash_phase(card: str) -> tuple[dict, dict]:
    """K1-K3 at GLM-4.7-Flash's MLA heads (20 of q/k 256, v 256, S 4096,
    causal) held to their plain versions and timed; then the training CLI
    on GLM-4.7-Flash (the registry's Glm4MoeLiteForCausalLM) at full width
    cut to GLM47_TRAIN_LAYERS layers and its MTP layer, GLM47_TRAIN_STEPS
    steps of GLM47_TRAIN_SEQ tokens: finite losses, K1-K3 all at <256,
    256>. Returns (the timed case's entries, the run's launches)."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    entries = fa_entries(fa_check_case(torch.bfloat16, FA_GLM47_SHAPE["S"], False, flush,
                                       timed=True, shape=FA_GLM47_SHAPE))
    del flush
    torch.cuda.empty_cache()
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_glm47_")
    hf = dict(GLM47_FLASH, num_hidden_layers=GLM47_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    recipe = cli_main([moe_train_yaml(run_dir, "glm47_flash", hf, GLM47_TRAIN_SEQ,
                                      GLM47_TRAIN_STEPS)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel_launches(*FLASH)
    cfg = recipe.model_cfg
    dims = fa_cuda.padded_head_dims(cfg.mla_qk_nope_head_dim + cfg.mla_qk_rope_head_dim,
                                    cfg.mla_v_head_dim)
    at_dims = flash_counts(dims)
    records = jsonl(Path(run_dir) / "training.jsonl")
    n = (cfg.num_layers + cfg.mtp_num_layers) * GLM47_TRAIN_STEPS
    want = {"K1": 2 * n, "K2": n, "K3": n}
    steady = records[1:]
    tps = statistics.median(r["tps"] for r in steady)
    emit({
        "phase": "train_glm47_flash", "card": card,
        "model": f"GLM-4.7-Flash widths via {recipe.model_spec.name}, {cfg.num_layers} of "
                 f"47 layers ({cfg.first_k_dense} dense + {cfg.num_moe_layers} MoE) + "
                 f"{cfg.mtp_num_layers} MTP, {cfg.dtype}, remat {cfg.remat_policy}",
        "params": count_params(recipe.train_state.params),
        "steps": len(records), "tokens_per_step": GLM47_TRAIN_SEQ,
        "losses": [r["loss"] for r in records],
        "grad_norms": [r["grad_norm"] for r in records],
        "moe_load_imbalance": [r.get("moe_load_imbalance") for r in records],
        "ms_per_step": GLM47_TRAIN_SEQ / tps * 1e3, "tokens_per_s": tps,
        "mfu_pct": statistics.median(r["mfu_pct"] for r in steady),
        "wall_s_with_setup": wall_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "kernel_head_dims": list(dims),
        "launches_at_head_dims": at_dims, "expected_launches": want,
    })
    values = [r["loss"] for r in records] + [r["grad_norm"] for r in records]
    if len(records) != GLM47_TRAIN_STEPS or not all(math.isfinite(x) for x in values):
        raise AssertionError(f"train_glm47_flash: records {records}")
    if recipe.model_spec.name != "glm4_moe_lite" or cfg.attention_type != "mla":
        raise AssertionError(f"train_glm47_flash: {recipe.model_spec.name} {cfg.attention_type}")
    if launches != want or at_dims != want:
        raise AssertionError(f"train_glm47_flash: K1-K3 {launches} (at {dims} "
                             f"{at_dims}), expected {want}")
    del recipe
    torch.cuda.empty_cache()
    return entries, launches


class ByteTokenizer:
    """A byte-level tokenizer with what the chat datasets and the sampling
    eval read: UTF-8 bytes as ids 0-255, bos 256, eos 257, pad 258, no chat
    template (the datasets render the role-tag fallback)."""

    bos_token_id, eos_token_id, pad_token_id = 256, 257, 258
    chat_template = None

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": list(text.encode("utf-8"))}

    def decode(self, ids):
        return bytes(int(i) for i in ids if int(i) < 256).decode("utf-8", errors="replace")


CHAT_SFT_TOOLS = [
    {"name": "get_weather", "parameters": {"city": "string", "unit": "string"}},
    {"name": "convert_currency", "parameters": {"amount": "number", "from": "string",
                                                "to": "string"}},
    {"name": "search_flights", "parameters": {"origin": "string", "destination": "string"}},
]
CHAT_SFT_CITIES = ("Oslo", "Rome", "Lima", "Pune", "Kyiv", "Doha", "Nice", "Bern")


def write_tool_conversations(path: Path, n: int, seed: int) -> None:
    """`n` ShareGPT rows: the tools, a user turn padded to
    CHAT_SFT_USER_CHARS, one or two tool calls, the tool's answer and the
    assistant's reply; every row's text before the first assistant turn
    has the same length."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        a, b = (str(x) for x in rng.choice(CHAT_SFT_CITIES, 2, replace=False))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            user = f"What is the weather in {a} and in {b}?"
            calls = [{"name": "get_weather", "arguments": {"city": c, "unit": "celsius"}}
                     for c in (a, b)]
        elif kind == 1:
            amount = int(rng.integers(1, 1000))
            user = f"Convert {amount} EUR to NOK for my trip to {a}."
            calls = [{"name": "convert_currency",
                      "arguments": {"amount": amount, "from": "EUR", "to": "NOK"}}]
        else:
            user = f"Find flights from {a} to {b}."
            calls = [{"name": "search_flights", "arguments": {"origin": a, "destination": b}}]
        conv = [{"from": "human", "value": user.ljust(CHAT_SFT_USER_CHARS)}]
        conv += [{"from": "function_call", "value": json.dumps(c)} for c in calls]
        conv += [{"from": "observation", "value": json.dumps({"ok": True, "n": len(calls)})},
                 {"from": "gpt", "value": "Done: " + user.lower()}]
        rows.append({"tools": CHAT_SFT_TOOLS, "conversations": conv})
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


def train_chat_sft_phase(card: str) -> dict:
    """llm_finetune at Llama-3.2-1B's widths on an AgentChatDatasetConfig of
    tool-calling conversations through `ByteTokenizer` (no `transformers`
    needed: a recipe subclass overrides `_build_tokenizer`), wandb
    and comet sections and gc_control on: each step's label-token count
    equal to the count of the dataset rows it took, the tracker mirrors
    equal to `training.jsonl`, GC back on after; at the last step one
    validation pass over held-out conversations (the subclass builds that
    loader with the tokenizer) whose sampling eval, prompted with the text
    before the first assistant turn, returns the tool-call metrics.
    Returns the run's K1-K3 launches."""
    import gc

    from automodel_tpu_torch.datasets.agent import (
        AgentChatDatasetConfig,
        normalize_agent_messages,
    )
    from automodel_tpu_torch.models.auto_tokenizer import apply_chat_template

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_chat_sft_"))
    train_path, val_path = tmp / "train.jsonl", tmp / "val.jsonl"
    write_tool_conversations(train_path, CHAT_SFT_CONVERSATIONS, seed=0)
    write_tool_conversations(val_path, CHAT_SFT_VAL, seed=1)
    tok = ByteTokenizer()
    first_row = json.loads(val_path.read_text().splitlines()[0])
    messages = normalize_agent_messages(first_row)
    prompt_len = len(tok(apply_chat_template(tok, messages[:2]))["input_ids"])
    hf = {k: v for k, v in NV_EMBEDQA_1B.items() if k != "pooling"}
    hf["architectures"] = ["LlamaForCausalLM"]
    cfg = {
        "seed": 0, "run_dir": str(tmp / "run"),
        "model": {"hf_config": hf, "dtype": "bfloat16", "remat_policy": "full"},
        "distributed": {"dp_shard": -1},
        "dataset": {"_target_": "automodel_tpu.datasets.agent.AgentChatDatasetConfig",
                    "path": str(train_path), "seq_len": CHAT_SFT_SEQ},
        "dataloader": {"microbatch_size": CHAT_SFT_MICROBATCH, "grad_acc_steps": 1},
        "optimizer": {"name": "adamw", "lr": 1.0e-4, "weight_decay": 0.0},
        "lr_scheduler": {"style": "constant", "warmup_steps": 0},
        "step_scheduler": {"max_steps": CHAT_SFT_STEPS, "val_every_steps": CHAT_SFT_STEPS},
        "checkpoint": {"enabled": False},
        "loss": {"chunk_size": 2048},
        "validation_generation": {"prompt_len": prompt_len,
                                  "max_new_tokens": CHAT_SFT_NEW_TOKENS, "max_batches": 1,
                                  "eos_token_id": tok.eos_token_id},
        # offline where a package is installed: wandb's offline mode, a
        # disabled comet experiment
        "wandb": {"project": "chip_smoke", "mode": "offline"},
        "comet": {"workspace": "chip_smoke", "disabled": True},
        "gc_control": True, "gc_every_steps": 1,
    }
    yaml_path = tmp / "chat_sft.yaml"
    yaml_path.write_text(yaml.safe_dump(cfg))

    class ByteTokenizerRecipe(TrainFinetuneRecipeForNextTokenPrediction):
        def _build_tokenizer(self):
            return ByteTokenizer()

        def _build_data(self):
            super()._build_data()
            val = AgentChatDatasetConfig(path=str(val_path), seq_len=CHAT_SFT_SEQ)
            self.val_dataloader = self.typed.dataloader.build(val.build(self._tokenizer))

    try:
        recipe = ByteTokenizerRecipe(parse_args_and_load_config([str(yaml_path)]))
        recipe.setup()
        counts, gc_during = [], []
        run_step = recipe.run_step

        def counted(microbatches):
            counts.append(int(sum((np.asarray(mb["labels"]) != -100).sum()
                                  for mb in microbatches)))
            gc_during.append(gc.isenabled())
            return run_step(microbatches)

        recipe.run_step = counted
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        recipe.run_train_validation_loop()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = kernel_launches(*FLASH)
        gc_after = gc.isenabled()
        run_dir = tmp / "run"
        records = jsonl(run_dir / "training.jsonl")
        val = jsonl(run_dir / "validation.jsonl")
        mirrors = tracker_mirrors(run_dir, records, ("wandb", "comet"))
        label_counts = [int(r["num_label_tokens"]) for r in records]
        tool_keys = sorted(k for k in val[-1] if k.startswith("tool_")) if val else []
        emit({
            "phase": "train_chat_sft", "card": card,
            "model": "Llama-3.2-1B widths (16 layers, 32 / 8 heads of 64), bf16, remat full",
            "dataset": f"AgentChatDatasetConfig, {CHAT_SFT_CONVERSATIONS} tool-calling "
                       f"conversations, ByteTokenizer, seq {CHAT_SFT_SEQ}",
            "losses": [r["loss"] for r in records],
            "num_label_tokens": label_counts, "dataset_label_tokens": counts,
            "tokens_per_s": statistics.median(r["tps"] for r in records[1:]),
            "validation": val, "tool_keys": tool_keys, "prompt_len": prompt_len,
            "tracker_mirror_lines": mirrors, "gc_enabled_during_steps": gc_during,
            "gc_enabled_after": gc_after, "wall_s": wall_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches,
        })
        if len(records) != CHAT_SFT_STEPS or not all(math.isfinite(r["loss"]) for r in records):
            raise AssertionError(f"train_chat_sft: records {records}")
        if label_counts != counts or not all(0 < c < CHAT_SFT_MICROBATCH * CHAT_SFT_SEQ
                                             for c in counts):
            raise AssertionError(f"train_chat_sft: label tokens {label_counts} vs the "
                                 f"dataset's {counts}")
        if len(val) != 1 or tool_keys != ["tool_exact_accuracy", "tool_fuzzy_accuracy",
                                          "tool_name_accuracy", "tool_num_examples"]:
            raise AssertionError(f"train_chat_sft: validation {val}")
        if any(gc_during) or not gc_after:
            raise AssertionError(f"train_chat_sft: GC during {gc_during}, after {gc_after}")
        if launches["K1"] == 0:
            raise AssertionError(f"train_chat_sft: K1-K3 {launches}")
        del recipe
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# the tensor-core kernels in ptxas's mangled names: (pattern, readable name)
# ---------------------------------------------------------------------------
# quantized linears (fp8 / int8), DSA and routing replay
# ---------------------------------------------------------------------------
# Llama-3-8B's linears (in, out): q and o, k and v, gate and up, down; at a
# serve step's 64 rows and a train microbatch's 4096
QUANT_MM_SHAPES = {"q_o": (4096, 4096), "k_v": (4096, 1024),
                   "gate_up": (4096, 14336), "down": (14336, 4096)}
QUANT_MM_ROWS = (64, 4096)
# fp8 and int8 dense peaks of one H100 SXM (NVIDIA data sheet)
QUANT_PEAK_OPS = 1979e12
# a route's bf16 result against the plain version's on the same operands:
# both sum exact products in fp32 (int8: exactly, in int32) in another
# order, so they differ by a bf16 rounding: of the largest magnitude
QUANT_TOL = 1e-2
# the linears a quantized decoder layer sends through quant.matmul: in the
# train step q, k, v, o, gate, up, down; in the engine's step all but o
TRAIN_QUANT_LINEARS, SERVE_QUANT_LINEARS = 7, 6
# serve_fp8 / serve_int8w serve the first this many of serve's 32 layers
# (all 32 until the resilience phases needed the time: the quantize
# launches make each step host-bound, ~60 ms at 32 layers)
SERVE_QUANT_LAYERS = 16
# train_qat: llama3_8b_mock_bf16.yaml cut to 2 layers, 4 steps, int8
# fake-quant from step 2 (the steps before it must equal a plain run's)
QAT_LAYERS, QAT_STEPS, QAT_START = 2, 4, 2
# DeepSeek-V3.2 (huggingface.co/deepseek-ai/DeepSeek-V3.2-Exp config.json):
# DeepSeek-V3's widths plus the lightning indexer, written from recall (no
# network here); where the published file differs, it wins
DEEPSEEK_V32 = dict(DEEPSEEK_V3, architectures=["DeepseekV32ForCausalLM"],
                    index_topk=2048, index_n_heads=64, index_head_dim=128)
DSA_YAML = "examples/long_context/dsv32_dsa_32k_chunked.yaml"
# train_dsv32_dsa: the YAML as written but for: hf_config the dict above in
# place of pretrained_path, cut to its 2 dense layers (one MoE layer's fp32
# training state is ~180 GB) and no MTP layer, distributed sizes 1,
# microbatch 1, 3 steps
DSA_TRAIN_LAYERS, DSA_TRAIN_STEPS = 2, 3
# dsa_check: one DeepSeek-V3.2 layer in fp32 at S 1024, the chunked path
# against the oracle; top-k 256 so that the selection binds (2048 >= S
# would select every admissible key and check nothing)
DSA_CHECK_SEQ, DSA_CHECK_TOPK, DSA_CHECK_TOL = 1024, 256, 1e-5


# train_resilient: llm_finetune at Llama-3.2-1B's widths, uncut, sequences
# of RESILIENT_SEQ tokens, RESILIENT_STEPS steps, with the checkpointer
# (async, one kept) and the resilience section armed: a snapshot every 4
# steps, two transient checkpoint-write faults at its first save, NaN
# params before step RESILIENT_NAN_STEP and a SIGTERM at
# RESILIENT_SIGTERM_STEP, the transfer guard on, a profiling window
RESILIENT_SEQ, RESILIENT_STEPS = 4096, 12
# (the checkpointer's cadence is past the run: two 14.8 GB writes six steps
# apart did not commit within the grace window, 33.6 s, on the card's disk)
RESILIENT_NAN_STEP, RESILIENT_SIGTERM_STEP, RESILIENT_CKPT_EVERY = 6, 11, 100


def resilient_yaml(tmp: Path, faults: list, **over) -> Path:
    hf = {k: v for k, v in NV_EMBEDQA_1B.items() if k != "pooling"}
    hf["architectures"] = ["LlamaForCausalLM"]
    cfg = {
        "seed": 0, "run_dir": str(tmp / "run"),
        "model": {"hf_config": hf, "dtype": "bfloat16", "remat_policy": "full"},
        "distributed": {"dp_shard": -1},
        "dataset": {"_target_": "automodel_tpu_torch.datasets.mock.MockDatasetConfig",
                    "num_samples": 64, "seq_len": RESILIENT_SEQ,
                    "vocab_size": hf["vocab_size"]},
        "dataloader": {"microbatch_size": 1, "grad_acc_steps": 1},
        "optimizer": {"name": "adamw", "lr": 3.0e-4, "weight_decay": 0.0},
        "lr_scheduler": {"style": "cosine", "warmup_steps": 2,
                         "decay_steps": RESILIENT_STEPS},
        "skip_nonfinite_updates": True,
        "step_scheduler": {"max_steps": RESILIENT_STEPS,
                           "ckpt_every_steps": RESILIENT_CKPT_EVERY},
        "checkpoint": {"enabled": True, "checkpoint_dir": str(tmp / "ckpt"),
                       "async_save": True, "max_recent_checkpoints": 1},
        "resilience": {"snapshot_every_steps": 4, "loss_spike_factor": 6.0,
                       "max_consecutive_nonfinite": 10, "retry_attempts": 3,
                       "transfer_guard": True, "faults": faults},
        "profiling": {"trace_dir": str(tmp / "trace"), "start_step": 2, "num_steps": 2},
        "loss": {"chunk_size": 2048},
    }
    for key, value in over.items():
        node = cfg
        *path, last = key.split(".")
        for p in path:
            node = node[p]
        node[last] = value
    path = tmp / f"resilient_{len(list(tmp.glob('resilient_*.yaml')))}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def train_resilient_phase(card: str) -> dict:
    """The resilience section on the card, through the training recipe:
    (1) the armed run (resilient_yaml): exactly one rollback, at the NaN
    step, to the step-4 snapshot; the restored state (params, moments,
    counters) bitwise equal to a copy on the card of the state the
    snapshot was taken of; the step after it bit-equal (loss, grad norm,
    every updated parameter) to the same step run again from that copy on
    the same batch; two retries of the first
    checkpoint write counted in training.jsonl; the SIGTERM's emergency
    checkpoint committed within `sigterm_grace_s`; the profiling window's
    trace written; (2) after the run, the step timed with the guard and
    without; (3) a new process resumes from the emergency checkpoint (the
    recipe's CLI, `checkpoint.restore_from`, saving nothing) and runs the
    last step. Prints the snapshot's bytes and ms, the restore's ms, the
    step's ms with and without the guard and K1-K3's launches; returns
    them."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_resilient_"))
    faults = [{"point": "checkpoint_write", "call": 1, "times": 2},
              {"point": "nan_grads", "step": RESILIENT_NAN_STEP},
              {"point": "sigterm", "step": RESILIENT_SIGTERM_STEP}]
    try:
        recipe = TrainFinetuneRecipeForNextTokenPrediction(
            parse_args_and_load_config([str(resilient_yaml(tmp, faults))]))
        recipe.setup()
        rb = recipe.rollback
        snapshots, kept, restored, after = [], {}, {}, {}
        snapshot, rollback, run_step = rb.snapshot, rb.rollback, recipe.run_step

        def card_copy(state):
            return dataclasses.replace(
                state, params=tree_map(lambda t: t.detach().clone(), state.params),
                opt_state=tree_map(lambda t: t.clone() if torch.is_tensor(t) else t,
                                   state.opt_state))

        def timed_snapshot(step, state):
            snapshot(step, state)
            snapshots.append(dict(rb.last_snapshot))
            if not restored:
                # a copy on the card of the state snapshotted, which the
                # rollback must restore bit for bit
                kept.clear()
                kept.update(step=step, state=card_copy(state))

        def kept_rollback(step, reason, state=None):
            snap_step, state = rollback(step, reason, state)
            want = kept.pop("state")
            restored.update(step=snap_step, state=want, equal=(
                snap_step == kept["step"] and state.step == want.step
                and all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(state.params), tree_leaves(want.params)))
                and all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                        for a, b in zip(tree_leaves(state.opt_state),
                                        tree_leaves(want.opt_state)))))
            return snap_step, state

        def kept_step(microbatches):
            metrics = run_step(microbatches)
            if restored and not after:
                after.update(microbatches=microbatches, loss=float(metrics["loss"]),
                             grad_norm=float(metrics["grad_norm"]),
                             params=tree_map(lambda t: t.detach().clone(),
                                             recipe.train_state.params))
            return metrics

        rb.snapshot, rb.rollback, recipe.run_step = timed_snapshot, kept_rollback, kept_step
        reset_counts()
        t0 = time.perf_counter()
        recipe.run_train_validation_loop()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = kernel_launches(*FLASH)
        records = jsonl(tmp / "run" / "training.jsonl")
        restore = dict(rb.last_restore)
        last_save = dict(recipe.checkpointer.last_save)
        trace_path = recipe.profiler.trace_path
        grace = recipe.resilience_cfg.sigterm_grace_s

        # (2) the step with the guard and without, in turns
        batch = after["microbatches"]
        step_ms = {True: [], False: []}
        for guard in (True, False, False, True, True, False):
            recipe.resilience_cfg = dataclasses.replace(recipe.resilience_cfg,
                                                        transfer_guard=guard)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            float(recipe.run_step(batch)["loss"])
            step_ms[guard].append((time.perf_counter() - t1) * 1e3)

        # (1) the step after the rollback again, from the copy of the
        # snapshotted state
        state = restored["state"]
        for t in tree_leaves(state.params):
            t.requires_grad_(True)
        recipe.train_state = state
        again = recipe.run_step(batch)
        same_params = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(recipe.train_state.params), tree_leaves(after["params"])))
        bit_equal = (float(again["loss"]) == after["loss"]
                     and float(again["grad_norm"]) == after["grad_norm"] and same_params)
        restored_equal = restored["equal"]
        del recipe, state, restored, after, batch, again
        gc.collect()  # the patched methods' closures keep the recipe in a cycle
        torch.cuda.empty_cache()

        # (3) a new process resumes from the emergency checkpoint
        resume_yaml = resilient_yaml(tmp, [], **{
            "run_dir": str(tmp / "run_resume"),
            "checkpoint": {"enabled": False, "restore_from": str(tmp / "ckpt")}})
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "automodel_tpu_torch", str(resume_yaml)],
                              capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))
        resume_wall = time.perf_counter() - t1
        if proc.returncode != 0:
            raise AssertionError(f"train_resilient: the resumed process failed:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        resumed = jsonl(tmp / "run_resume" / "training.jsonl")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = [r for r in records if "loss" in r]
    events = [r for r in records if "event" in r]
    rollbacks = [r for r in events if r["event"] == "rollback"]
    emergency = [r for r in events if r["event"] == "emergency_checkpoint"]
    emit({
        "phase": "train_resilient", "card": card,
        "model": "Llama-3.2-1B widths (16 layers, 32 / 8 heads of 64), bf16 over fp32 "
                 f"masters, remat full, seq {RESILIENT_SEQ}",
        "faults": faults, "steps": [r["step"] for r in steps],
        "losses": [r["loss"] for r in steps], "lr": [r["lr"] for r in steps],
        "events": events, "wall_s": wall_s, "emergency_save": last_save,
        "snapshots": snapshots, "restore": restore,
        "step_ms_guarded": step_ms[True], "step_ms_unguarded": step_ms[False],
        "restored_bitwise_equal_to_snapshot": restored_equal,
        "step_after_rollback_bit_equal": bit_equal,
        "retries": max((r.get("retry_checkpoint_write", 0) for r in records), default=0),
        "sigterm_grace_s": grace, "profile_trace": bool(trace_path),
        "resumed_steps": [r["step"] for r in resumed if "loss" in r],
        "time_to_resume_s": next((r.get("time_to_resume_s") for r in resumed), None),
        "resume_process_wall_s": resume_wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
    })
    want_steps = [s for s in range(1, RESILIENT_SIGTERM_STEP + 1) if s != RESILIENT_NAN_STEP]
    if [r["step"] for r in steps] != want_steps or not all(
            math.isfinite(r["loss"]) for r in steps):
        raise AssertionError(f"train_resilient: steps {steps}")
    if len(rollbacks) != 1 or rollbacks[0]["step"] != RESILIENT_NAN_STEP or \
            rollbacks[0]["restored_step"] != 4 or rollbacks[0]["reason"] != "nonfinite":
        raise AssertionError(f"train_resilient: rollbacks {rollbacks}")
    if not restored_equal:
        raise AssertionError("train_resilient: the rollback did not restore the state "
                             "the step-4 snapshot was taken of")
    if not bit_equal:
        raise AssertionError("train_resilient: the step after the rollback is not the "
                             "snapshot's step again")
    if max(r.get("retry_checkpoint_write", 0) for r in records) != 2:
        raise AssertionError("train_resilient: the retries were not counted")
    if len(emergency) != 1 or not emergency[0]["committed"] or \
            emergency[0]["seconds"] > grace or emergency[0]["step"] != RESILIENT_SIGTERM_STEP:
        raise AssertionError(f"train_resilient: emergency checkpoint {emergency}")
    if not trace_path:
        raise AssertionError("train_resilient: the profiling window wrote no trace")
    if [r["step"] for r in resumed if "loss" in r] != [RESILIENT_SIGTERM_STEP + 1] or \
            "time_to_resume_s" not in resumed[0]:
        raise AssertionError(f"train_resilient: the resumed process's records {resumed}")
    if launches["K1"] == 0 or launches["K2"] == 0:
        raise AssertionError(f"train_resilient: K1-K3 {launches}")
    return {**launches, "snapshot_bytes": snapshots[-1]["bytes"],
            "snapshot_ms": [s["seconds"] * 1e3 for s in snapshots],
            "restore_ms": restore["seconds"] * 1e3}


def quant_mm_phase(flush) -> list:
    """The fp8 (`_scaled_mm`) and int8 (`_int_mm`) routes of
    `quant.quantized_matmul` against its plain version on the card, forward
    and backward, at Llama-3-8B's linears at 64 and 4096 rows (bf16), each
    timed after an L2 flush beside the bf16 `torch.matmul` of the shape and
    its bound."""
    from automodel_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for precision in ("fp8", "int8"):
        qdtype, qmax = quant._qparams(precision)
        for M in QUANT_MM_ROWS:
            for name, (K, N) in QUANT_MM_SHAPES.items():
                x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
                w = (torch.randn(K, N, device="cuda", generator=gen)
                     * K ** -0.5).to(torch.bfloat16)
                cot = torch.randn(M, N, device="cuda", generator=gen).to(torch.bfloat16)
                res = {}
                for impl in ("cuda", "torch"):
                    xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
                    quant.reset_launches()
                    out = quant.quantized_matmul(xi, wi, precision, impl=impl)
                    (out.float() * cot.float()).sum().backward()
                    res[impl] = (out.detach().float(), xi.grad.float(), wi.grad.float(),
                                 quant.LAUNCHES[precision])
                (got, gx, gw, n_cuda), (want, wx, ww, n_torch) = res["cuda"], res["torch"]
                err = ((got - want).abs().max() / want.abs().max()).item()
                grad_err = max(((gx - wx).abs().max() / wx.abs().max()).item(),
                               ((gw - ww).abs().max() / ww.abs().max()).item())
                qk = quant.quantize_kernel(w, precision)
                qx, sx = quant._quantize(x, qdtype, qmax, dim=-1)
                t = {
                    "ms": time_ms(lambda: quant.quantized_matmul(x, w, precision), 10, flush),
                    "prequantized_ms": time_ms(
                        lambda: quant.quantized_matmul(x, qk, precision), 10, flush),
                    "gemm_ms": time_ms(lambda: quant._qproduct(
                        qx, sx, qk.qw, qk.sw, precision, torch.bfloat16, "cuda"), 10, flush),
                    "plain_ms": time_ms(lambda: quant.quantized_matmul(
                        x, w, precision, impl="torch"), 10, flush),
                    "library_ms": time_ms(lambda: torch.matmul(x, w), 10, flush),
                }
                ops = 2.0 * M * K * N
                gemm_bytes = M * K + K * N + 2 * M * N
                rec = {
                    "precision": precision, "linear": name, "M": M, "K": K, "N": N,
                    "max_rel_err": err, "grad_max_rel_err": grad_err, "tol": QUANT_TOL,
                    "route_launches": n_cuda, "plain_launches": n_torch, **t,
                    "bound_ms": max(ops / QUANT_PEAK_OPS, gemm_bytes / HBM_BYTES_PER_S) * 1e3,
                    "bound_by": ("operations" if ops / QUANT_PEAK_OPS
                                 > gemm_bytes / HBM_BYTES_PER_S else "bytes"),
                    "library_bound_ms": max(ops / PEAK_OPS[torch.bfloat16],
                                            2 * (M * K + K * N + M * N)
                                            / HBM_BYTES_PER_S) * 1e3,
                }
                rec["gemm_bound_share"] = rec["bound_ms"] / t["gemm_ms"]
                records.append(rec)
                if n_cuda != 1 or n_torch != 0:
                    raise AssertionError(f"quant_mm: {precision} launches {n_cuda}, {n_torch}")
                if err > QUANT_TOL or grad_err > 1e-6:
                    raise AssertionError(f"quant_mm: the {precision} route disagrees: {rec}")
    emit({"phase": "quant_mm", "records": records,
          "library_call": "torch.matmul in bf16 (cuBLAS)"})
    return records


def serve_quant_phase(card: str, cfg, params) -> dict:
    """serve's Llama-3-8B (same weights, their first SERVE_QUANT_LAYERS
    layers) with `serve_precision`: fp8 on the fp pool (K4) and int8 on the
    int8 pool (K5), the JAX package's quantized serve entry point; each
    `serve_run` (fp8's with its profile), the quantized GEMM launches
    counted (6 linears a layer a step; o_proj stays bf16, as in the JAX
    engine) and the greedy agreement with the same layers' bf16 tokens.
    Returns the launches of K4 and K5."""
    from automodel_tpu_torch.ops import quant

    cfg = dataclasses.replace(cfg, num_layers=SERVE_QUANT_LAYERS)
    params = {**params, "layers": tree_map(lambda t: t[:SERVE_QUANT_LAYERS],
                                           params["layers"])}
    model = f"Llama-3-8B widths, {SERVE_QUANT_LAYERS} of 32 layers, bf16"
    engine = ServingEngine(params, cfg, SERVE)
    fp_outputs = engine.serve_batch(serve_traffic(cfg.vocab_size))["outputs"]
    del engine
    torch.cuda.empty_cache()
    launches = {}
    for phase, precision, kernel, pool in (("serve_fp8", "fp8", "K4", None),
                                           ("serve_int8w", "int8", "K5", "int8")):
        t0 = time.perf_counter()
        engine = ServingEngine(params, cfg, dataclasses.replace(
            SERVE, serve_precision=precision, kv_cache_dtype=pool))
        torch.cuda.synchronize()
        quant.reset_launches()
        launches[kernel], res = serve_run(engine, cfg, card, phase, model, kernel,
                                          time.perf_counter() - t0)
        gemms, steps = quant.LAUNCHES[precision], res["stats"]["steps"]
        want = SERVE_QUANT_LINEARS * cfg.num_layers * steps
        pairs = [(a, b) for o1, o2 in zip(fp_outputs, res["outputs"])
                 for a, b in zip(o1, o2)]
        first = [next((i for i, (a, b) in enumerate(zip(o1, o2)) if a != b), len(o1))
                 for o1, o2 in zip(fp_outputs, res["outputs"])]
        emit({"phase": f"{phase}_agreement", "card": card, "serve_precision": precision,
              "kv_cache_dtype": pool, "quant_gemm_launches": gemms,
              "expected_quant_gemm_launches": want,
              "greedy_agreement_vs_serve": sum(a == b for a, b in pairs) / len(pairs),
              "tokens": len(pairs), "first_divergence_per_request": first})
        if gemms != want:
            raise AssertionError(f"{phase}: {gemms} quantized GEMMs in {steps} steps, "
                                 f"expected {want}")
        if precision == "fp8":  # 5 steps: the profiler's processing of 4600
            # launches a step held the phase
            profile_steps(engine, cfg, card, phase,
                          rpa_cuda.KERNELS[kernel][rpa_cuda.route(torch.bfloat16)],
                          n_steps=MOE_PROFILE_STEPS)
        del engine
        torch.cuda.empty_cache()
    return launches


def train_qat_phase(card: str) -> dict:
    """llama3_8b_mock_bf16.yaml cut to QAT_LAYERS layers with `qat` (int8
    from step QAT_START) and without, QAT_STEPS steps each through the CLI:
    the steps before QAT_START equal bit for bit, the later ones not.
    Returns K1-K3 launches of the QAT run."""
    runs = {}
    for name, extra in (("qat", ["--qat.enabled=true", "--qat.precision=int8",
                                 f"--qat.start_step={QAT_START}"]), ("plain", [])):
        run_dir = tempfile.mkdtemp(prefix=f"chip_smoke_train_{name}_")
        argv = [TRAIN_YAML, f"--model.hf_config.num_hidden_layers={QAT_LAYERS}",
                "--dataloader.microbatch_size=1", f"--dataloader.grad_acc_steps={TRAIN_ACCUM}",
                f"--step_scheduler.max_steps={QAT_STEPS}", "--checkpoint.enabled=false",
                f"--run_dir={run_dir}", *extra]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        recipe = cli_main(argv)
        torch.cuda.synchronize()
        runs[name] = (jsonl(Path(run_dir) / "training.jsonl"), kernel_launches(*FLASH),
                      torch.cuda.max_memory_allocated() / 2**30)
        del recipe
        torch.cuda.empty_cache()
    (qat, launches, peak), (plain, plain_launches, _) = runs["qat"], runs["plain"]
    n = QAT_LAYERS * TRAIN_ACCUM * QAT_STEPS
    same = [(a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
            for a, b in zip(qat, plain)]
    emit({"phase": "train_qat", "card": card,
          "model": f"Llama-3-8B widths, {QAT_LAYERS} layers, bf16, remat full",
          "qat": {"precision": "int8", "start_step": QAT_START},
          "losses": [r["loss"] for r in qat], "plain_losses": [r["loss"] for r in plain],
          "grad_norms": [r["grad_norm"] for r in qat],
          "equal_to_plain_per_step": same,
          "ms_per_step": statistics.median(
              TRAIN_ACCUM * 4096 / r["tps"] * 1e3 for r in qat[1:]),
          "plain_ms_per_step": statistics.median(
              TRAIN_ACCUM * 4096 / r["tps"] * 1e3 for r in plain[1:]),
          "peak_mem_gib": peak, "launches": launches,
          "expected_launches": {"K1": 2 * n, "K2": n, "K3": n}})
    if len(qat) != QAT_STEPS or not all(math.isfinite(r["loss"]) for r in qat):
        raise AssertionError(f"train_qat: records {qat}")
    if not all(same[:QAT_START]) or any(same[QAT_START:]):
        raise AssertionError(f"train_qat: steps equal to the plain run's: {same}")
    if launches != plain_launches or launches != {"K1": 2 * n, "K2": n, "K3": n}:
        raise AssertionError(f"train_qat: K1-K3 launches {launches}, plain {plain_launches}")
    return launches


def serve_dsv32_phase(card: str) -> int:
    """DeepSeek-V3.2 (`DeepseekV32ForCausalLM` through the registry) at its
    published widths cut to DSV3_SERVE_LAYERS layers (3 dense + 1 MoE) with
    its indexers, bf16, seed-0 weights, on serve's traffic: K6 at 128 heads
    on every layer of every step. The engine decodes DSA
    with dense MLA, as JAX's does: the same weights with the indexers taken
    out, served as DeepSeek-V3, must give the same greedy tokens. Both runs
    use `torch.use_deterministic_algorithms` (the experts' `index_add_`
    otherwise sums a token's rows with atomics in any order, and random
    weights' small top-1 margins turn that into other tokens). Returns the
    launches of K6."""
    cfg = cut_config(DEEPSEEK_V32, DSV3_SERVE_LAYERS, DSV3_SERVE_LAYERS - 1, torch.bfloat16)
    t0 = time.perf_counter()
    params = moe_decoder.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                              dtype=torch.bfloat16)
    indexer_params = sum(count_params(params[k]["indexer"])
                         for k in ("dense_layers", "moe_layers"))
    engine = ServingEngine(params, cfg, SERVE)
    torch.cuda.synchronize()
    torch.use_deterministic_algorithms(True, warn_only=True)
    model = (f"DeepSeek-V3.2 widths, {cfg.num_layers} of 61 layers ({cfg.first_k_dense} "
             f"dense + {cfg.num_moe_layers} MoE), the indexer (top-k "
             f"{cfg.dsa_index_topk}, {cfg.dsa_index_n_heads} heads of "
             f"{cfg.dsa_index_head_dim}; {indexer_params} params), yarn, bf16, "
             f"{count_params(params)} params")
    k6, res = serve_run(engine, cfg, card, "serve_dsv32", model, "K6",
                        time.perf_counter() - t0)
    del engine
    torch.cuda.empty_cache()
    bare = {k: ({kk: vv for kk, vv in v.items() if kk != "indexer"}
                if k in ("dense_layers", "moe_layers") else v) for k, v in params.items()}
    engine = ServingEngine(bare, dataclasses.replace(cfg, dsa_index_topk=None), SERVE)
    _, res_v3 = serve_run(engine, cfg, card, "serve_dsv32_no_indexer",
                          model + ", the indexers taken out", "K6", 0.0)
    torch.use_deterministic_algorithms(False)
    same = res["outputs"] == res_v3["outputs"]
    emit({"phase": "serve_dsv32_dense_decode", "card": card, "deterministic_algorithms": True,
          "greedy_equal_without_indexer": same, "indexer_params": indexer_params})
    del engine, params, bare
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError("serve_dsv32: the indexers changed the served tokens")
    return k6


def dsa_check_phase(card: str) -> None:
    """One DeepSeek-V3.2 layer (its widths, fp32, top-k DSA_CHECK_TOPK) at
    S DSA_CHECK_SEQ: the chunked path (query block 128) against the
    oracle on the same weights and input: outputs and the indexer-KL aux
    within DSA_CHECK_TOL, the same keys selected; each timed."""
    from automodel_tpu_torch.models.llm.decoder import init_attention_layers
    from automodel_tpu_torch.models.llm.mla import mla_sparse_attention_block
    from automodel_tpu_torch.ops.rope import rope_frequencies

    base = dataclasses.replace(cut_config(DEEPSEEK_V32, 1, 1, torch.float32),
                               dsa_index_topk=DSA_CHECK_TOPK)
    gen = torch.Generator(device="cuda").manual_seed(5)
    lp = tree_map(lambda t: t[0], init_attention_layers(base, gen, 1))
    S = DSA_CHECK_SEQ
    h = torch.randn(1, S, base.hidden_size, device="cuda", generator=gen)
    pos = torch.arange(S, device="cuda", dtype=torch.int32)[None]
    inv = rope_frequencies(base.rope_dim, base.rope_theta, base.rope_scaling).to("cuda")
    out, times = {}, {}
    no_flush = torch.empty(0, device="cuda")
    for impl in ("oracle", "chunked"):
        cfg = dataclasses.replace(base, dsa_impl=impl, dsa_query_block=128)
        with torch.no_grad():
            out[impl] = mla_sparse_attention_block(h, lp, cfg, pos, None, inv)
            times[impl] = time_ms(lambda: mla_sparse_attention_block(h, lp, cfg, pos, None,
                                                                     inv), 3, no_flush)
    (o_h, o_aux, sel), (c_h, c_aux, idx) = out["oracle"], out["chunked"]
    err = ((c_h - o_h).abs().max() / o_h.abs().max()).item()
    aux_err = abs(c_aux.item() - o_aux.item()) / abs(o_aux.item())
    valid = idx <= pos[0][:, None]  # causal: key index <= query position
    picked = torch.zeros_like(sel).scatter(-1, idx, valid)
    same_keys = bool(torch.equal(picked, sel))
    emit({"phase": "dsa_check", "card": card, "dtype": "float32", "seq": S,
          "topk": DSA_CHECK_TOPK, "heads": base.num_heads,
          "indexer_heads": base.dsa_index_n_heads, "max_rel_err": err,
          "aux": [o_aux.item(), c_aux.item()], "aux_rel_err": aux_err,
          "tol": DSA_CHECK_TOL, "same_keys": same_keys,
          "oracle_ms": times["oracle"], "chunked_ms": times["chunked"]})
    if err > DSA_CHECK_TOL or aux_err > DSA_CHECK_TOL or not same_keys:
        raise AssertionError("dsa_check: the chunked path disagrees with the oracle")


def train_dsv32_dsa_phase(card: str) -> dict:
    """examples/long_context/dsv32_dsa_32k_chunked.yaml through the CLI with
    the cuts DSA_TRAIN_* names: DeepSeek-V3.2's 2 dense layers, bf16, S
    32768 on the chunked sparse path (query block 128), full remat. Prints
    ms a step, peak memory and the indexer-KL aux of one more batch.
    Returns K1-K3 launches (none: DSA runs no flash attention)."""
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_dsv32_dsa_")
    cfg_node = yaml.safe_load(Path(DSA_YAML).read_text())
    cfg_node["model"].pop("pretrained_path")
    cfg_node["model"]["hf_config"] = dict(
        DEEPSEEK_V32, num_hidden_layers=DSA_TRAIN_LAYERS,
        first_k_dense_replace=DSA_TRAIN_LAYERS, num_nextn_predict_layers=0)
    cfg_node["distributed"] = {"dp_shard": -1}
    cfg_node["dataloader"]["microbatch_size"] = 1
    cfg_node["step_scheduler"]["max_steps"] = DSA_TRAIN_STEPS
    cfg_node["run_dir"] = run_dir
    path = Path(run_dir) / "dsv32_dsa.yaml"
    path.write_text(yaml.safe_dump(cfg_node))
    seq = int(cfg_node["dataset"]["seq_len"])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    recipe = cli_main([str(path)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel_launches(*FLASH)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    records = jsonl(Path(run_dir) / "training.jsonl")
    cfg = recipe.model_cfg
    params = recipe.train_state.params
    batch = make_global_batch(next(iter(recipe.dataloader)), "cuda")
    with torch.no_grad():
        _, aux = moe_decoder.forward(params, cfg, batch["input_ids"], return_hidden=True)
    ms = [seq / r["tps"] * 1e3 for r in records[1:]]
    emit({"phase": "train_dsv32_dsa", "card": card, "yaml": DSA_YAML,
          "model": f"DeepSeek-V3.2 widths, {cfg.num_layers} dense layers, DSA "
                   f"{cfg.dsa_impl} (query block {cfg.dsa_query_block}, top-k "
                   f"{cfg.dsa_index_topk}), {cfg.dtype}, remat {cfg.remat_policy}",
          "cut": "pretrained_path -> the published widths with seed-0 weights; 61 -> 2 "
                 "layers, the dense prefix (one MoE layer's fp32 training state is "
                 "~180 GB), no MTP layer; ep 8 -> 1; microbatch 8 -> 1; 100 -> 3 steps",
          "params": count_params(params), "seq": seq, "steps": len(records),
          "losses": [r["loss"] for r in records],
          "grad_norms": [r["grad_norm"] for r in records],
          "ms_per_step": statistics.median(ms), "tokens_per_s": seq / statistics.median(ms) * 1e3,
          "indexer_kl_aux": aux.item(),
          "indexer_kl_per_layer": aux.item() / cfg.dsa_indexer_loss_coeff / cfg.num_layers,
          "wall_s_with_setup": wall_s, "peak_mem_gib": peak_gib, "launches": launches})
    values = [r["loss"] for r in records] + [r["grad_norm"] for r in records] + [aux.item()]
    if len(records) != DSA_TRAIN_STEPS or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"train_dsv32_dsa: records {records}, aux {aux.item()}")
    if cfg.dsa_impl != "chunked" or not aux.item() > 0:
        raise AssertionError(f"train_dsv32_dsa: impl {cfg.dsa_impl}, aux {aux.item()}")
    del recipe, params, batch
    torch.cuda.empty_cache()
    return launches


def routing_replay_check(recipe) -> dict:
    """One step of train_moe's model with the routing captured from its own
    forward and replayed (`return_routing` / `routing_override`): the
    replayed routing, the loss and the gradient norm equal the unreplayed
    step's. Both run under `torch.use_deterministic_algorithms`: the
    experts' `index_add_` otherwise sums a token's K rows with atomics in
    any order."""
    cfg, params = recipe.model_cfg, recipe.train_state.params
    batch = make_global_batch(next(iter(recipe.dataloader)), "cuda")
    ids, labels = batch["input_ids"], batch["labels"]
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    for name in ("captured", "replayed"):
        override = out["captured"][2] if name == "replayed" else None
        hidden, aux, stats = moe_decoder.forward(
            params, cfg, ids, return_hidden=True, return_stats=True, return_routing=True,
            token_mask=labels != -100, routing_override=override)
        ce, n = fused_linear_cross_entropy(hidden, moe_decoder.head_kernel(params, cfg),
                                           labels, chunk_size=2048)
        total, n = combine_losses(ce, n, aux)
        total.backward()
        grads = [p.grad for p in tree_leaves(params) if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads])).item()
        for p in tree_leaves(params):
            p.grad = None
        out[name] = ((total / n).item(), norm, stats["routing"])
    torch.use_deterministic_algorithms(False)
    (loss0, norm0, r0), (loss1, norm1, r1) = out["captured"], out["replayed"]
    report = {"routing_shape": list(r0.shape), "routing_equal": bool(torch.equal(r0, r1)),
              "loss": [loss0, loss1], "grad_norm": [norm0, norm1]}
    if not (report["routing_equal"] and loss0 == loss1 and norm0 == norm1):
        raise AssertionError(f"train_moe: the replayed step differs: {report}")
    return report


# --- the heterogeneous MoE engine and Gemma-4 MoE (phases) -------------------
# smoke_het: the four families' smoke YAMLs, as smoke_families (K1-K3 at
# head dims 8 and (16, 8), padded to <16, 16>; MiniMax-M3's sparse layers
# attend in plain torch and launch nothing)
HET_SMOKE_YAMLS = tuple(f"examples/llm_finetune/{f}_smoke.yaml"
                        for f in ("step3p5", "mimo_v2_flash", "minimax_m3", "gemma4_moe"))
# train_mimo_check / generate_mimo: MiMo-V2-Flash at its published widths
# cut to its first MIMO_LAYERS layers (0 global with a dense MLP, 1 sliding
# with sinks and 256 routed experts): 8.07 B parameters, 16.1 GB in bf16.
# Its fp32 AdamW state (16 bytes a parameter, 129 GB) fits no card, so the
# check is one forward and backward in bf16 with gradients for the
# attention leaves alone, at MIMO_SEQ tokens. Its MoE layer routes on the
# balanced gate (token t to experts tK..tK+K-1, as train_moe_check): the
# learned router's top 8 of 256 flips for some tokens under bf16 rounding
# differences of the attention in front of it (the first card run, on the
# learned router: gradients 5-6% apart, L2), and the check is of the
# attention
MIMO_LAYERS, MIMO_SEQ = 2, 4096
# the sliding layers' sink logits, drawn around MIMO_SINK_MEAN: a sink then
# holds ~20% of a row's mass over the 128-key window (at 0 it would hold
# ~1%, which no bf16 tolerance could tell from rounding)
MIMO_SINK_MEAN = 4.0
# bf16, kernels vs plain attention on the same weights and batch: the loss
# relative, each attention leaf's gradient as ||a - b|| / ||b||. Both paths
# round q, k, v and the attention output to bf16, the plain one also the
# probabilities before the value product; ~0.4% per element at bf16's
# 2^-8, so the leaf norms agree to ~1%
MIMO_LOSS_RTOL, MIMO_GRAD_RTOL = 2e-3, 3e-2
# generate_mimo: 4 prompts of 512 mock tokens, 32 greedy new tokens; the
# prefill's last-position logits (einsums over the dense cache) against
# the K1-K3 forward's on the same prompts, as a share of the largest
MIMO_GEN_PROMPTS, MIMO_GEN_LEN, MIMO_GEN_NEW = 4, 512, 32
MIMO_GEN_LOGIT_TOL = 5e-2
# train_gemma4: Gemma-4 26B-A4B at its widths (GEMMA4_26B_A4B) cut to 2 of
# its 30 layers, one sliding and one global (it shares no KV): 2.37 B
# parameters, 37.9 GB at 16 bytes a parameter of fp32 state; through the
# CLI, GEMMA4_STEPS steps of GEMMA4_SEQ tokens; K1-K3 at <256, 256>
GEMMA4_LAYERS, GEMMA4_SEQ, GEMMA4_STEPS = 2, 4096, 5
GEMMA4_STATE_BUDGET_GIB = 60
# train_gemma4_check: the same 2 layers in fp32, 2 microbatches of
# GEMMA4_CHECK_SEQ tokens, kernels vs plain attention
GEMMA4_CHECK_SEQ = 1024


def mimo_cut(dtype, **overrides):
    """MiMo-V2-Flash's config cut to its first MIMO_LAYERS layers."""
    from automodel_tpu_torch.models.moe_lm.het_families import mimo_v2_flash_config

    hf = dict(MIMO_V2_FLASH, num_hidden_layers=MIMO_LAYERS,
              hybrid_layer_pattern=MIMO_V2_FLASH["hybrid_layer_pattern"][:MIMO_LAYERS],
              moe_layer_freq=MIMO_V2_FLASH["moe_layer_freq"][:MIMO_LAYERS])
    return mimo_v2_flash_config(hf, dtype=dtype, **overrides)


def het_param_count(cfg) -> int:
    """A het config's parameter count from its widths (the same tree
    `het_moe.init` draws), to size a phase before it allocates."""
    H, E = cfg.hidden_size, cfg.moe.n_routed_experts
    n = cfg.vocab_size * H * (1 if cfg.tie_word_embeddings else 2) + H
    for lt, mlp in zip(cfg.layer_types, cfg.mlp_kinds):
        g = cfg.geom(lt)
        n += H * (g.num_heads * g.head_dim + g.num_kv_heads * (g.head_dim + g.vd))
        n += g.num_heads * g.vd * H + 2 * H
        n += g.num_heads * (g.sinks + H * cfg.head_gate) + 2 * g.head_dim * cfg.qk_norm
        n += (E * (3 * H * cfg.moe.moe_intermediate_size + 1) + H * E if mlp == "moe"
              else 3 * H * cfg.intermediate_size)
    return n


def mimo_params(cfg):
    """Seed-0 bf16 weights on the card, the sliding layers' sinks around
    MIMO_SINK_MEAN."""
    from automodel_tpu_torch.models.moe_lm import het_moe

    params = het_moe.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                          dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    sinks = params["s_attn"]["sinks"]
    sinks.copy_(MIMO_SINK_MEAN + 0.5 * torch.randn(sinks.shape, generator=gen,
                                                    device="cuda"))
    return params


def train_mimo_check_phase(card: str) -> tuple:
    """MiMo-V2-Flash cut to MIMO_LAYERS layers at its published widths,
    bf16, the MoE layer on the balanced gate: one forward and backward of
    `het_moe.forward` at MIMO_SEQ tokens
    with the kernels (attn_impl "auto": K1-K3 at <192, 128> on both layers,
    the sliding one with window 128 and sinks around K1-K3), with the plain
    attention ("torch"), and the control (the kernels with the sinks
    dropped), on the same weights and batch. Loss and the attention leaves'
    gradients (q/k/v/o of both geometries, the sinks) within MIMO_LOSS_RTOL
    / MIMO_GRAD_RTOL; the control must miss MIMO_GRAD_RTOL. Returns (K1-K3
    launches of the kernel run, the config, the params) for generate_mimo."""
    from automodel_tpu_torch.models.moe_lm import het_moe

    cfg = mimo_cut(torch.bfloat16, remat_policy="full")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, fake_balanced_gate=True))
    n_params = het_param_count(cfg)
    state_gb = {"bf16_params": 2 * n_params / 1e9,
                "fp32_adamw_state_16_bytes_a_param": 16 * n_params / 1e9}
    if 2 * n_params > 30e9:
        raise AssertionError(f"train_mimo_check: {n_params} parameters do not leave "
                             "room for the activations")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mimo_params(cfg)
    init_s = time.perf_counter() - t0
    if count_params(params) != n_params:
        raise AssertionError(f"train_mimo_check: {count_params(params)} parameters drawn, "
                             f"{n_params} reckoned")
    ds = MockDatasetConfig(num_samples=1, seq_len=MIMO_SEQ, vocab_size=MOE_TRAIN_TOKEN_IDS,
                           seed=3).build()
    mb = make_global_batch({k: v[None] for k, v in ds[0].items()}, "cuda")
    attn_leaves = {(gk, name): lp
                   for gk in ("g_attn", "s_attn")
                   for name, lp in (("q", params[gk]["q_proj"]["kernel"]),
                                    ("k", params[gk]["k_proj"]["kernel"]),
                                    ("v", params[gk]["v_proj"]["kernel"]),
                                    ("o", params[gk]["o_proj"]["kernel"]))}
    attn_leaves[("s_attn", "sinks")] = params["s_attn"]["sinks"]
    results = {}
    for run in ("auto", "torch", "control"):
        rcfg = dataclasses.replace(cfg, attn_impl="torch" if run == "torch" else "auto")
        if run == "control":
            rcfg = dataclasses.replace(rcfg, sliding_attn=dataclasses.replace(
                cfg.sliding_attn, sinks=False))
        leaves = list(attn_leaves.values())
        for t in leaves:
            t.requires_grad_(True)
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hidden, aux = het_moe.forward(params, rcfg, mb["input_ids"], return_hidden=True)
        ce, n = fused_linear_cross_entropy(hidden, het_moe.head_kernel(params, rcfg),
                                           mb["labels"], chunk_size=2048)
        loss = ce / n
        grads = torch.autograd.grad(loss + aux, leaves, allow_unused=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        for t in leaves:
            t.requires_grad_(False)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        results[run] = (loss.item(), grads, kernel_launches(*FLASH),
                        flash_counts((192, 128), ("mma", "fma")), ms)
        del hidden, aux, ce, loss
        torch.cuda.empty_cache()

    def gaps(run):
        loss_rel = abs(results[run][0] - results["torch"][0]) / abs(results["torch"][0])
        grad_rel = {f"{gk}.{name}": (torch.linalg.vector_norm((a - b).float())
                                     / torch.linalg.vector_norm(b.float()).clamp(min=1e-30)).item()
                    for (gk, name), a, b in zip(attn_leaves, results[run][1],
                                                results["torch"][1])}
        return loss_rel, grad_rel

    loss_rel, grad_rel = gaps("auto")
    c_loss_rel, c_grad_rel = gaps("control")
    launches, at_dims = results["auto"][2], results["auto"][3]
    expected = {"K1": 2 * MIMO_LAYERS, "K2": MIMO_LAYERS, "K3": MIMO_LAYERS}
    emit({"phase": "train_mimo_check", "card": card,
          "model": f"MiMo-V2-Flash (from recall), published widths, {MIMO_LAYERS} of "
                   f"{MIMO_V2_FLASH['num_hidden_layers']} layers "
                   f"({list(cfg.layer_types)}, MLPs {list(cfg.mlp_kinds)}), bf16, "
                   "remat full, seed-0 weights, the balanced gate",
          "params": count_params(params), "bytes": state_gb,
          "heads": {"global": [cfg.global_attn.num_heads, cfg.global_attn.num_kv_heads,
                               cfg.global_attn.head_dim, cfg.global_attn.vd],
                    "sliding": [cfg.sliding_attn.num_heads, cfg.sliding_attn.num_kv_heads,
                                cfg.sliding_attn.head_dim, cfg.sliding_attn.vd,
                                cfg.sliding_attn.sliding_window]},
          "tokens": MIMO_SEQ, "init_s": init_s,
          "loss": {r: results[r][0] for r in results}, "loss_rel_err": loss_rel,
          "loss_rtol": MIMO_LOSS_RTOL, "grad_rel_l2_err": grad_rel,
          "grad_rtol": MIMO_GRAD_RTOL,
          "control": "the kernels with the sliding layers' sinks dropped",
          "control_loss_rel_err": c_loss_rel, "control_grad_rel_l2_err": c_grad_rel,
          "fwd_bwd_ms": {r: results[r][4] for r in results},
          "launches": launches, "expected_launches": expected,
          "launches_at_192_128": at_dims,
          "plain_launches": results["torch"][2],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    if not all(math.isfinite(results[r][0]) for r in results):
        raise AssertionError(f"train_mimo_check: non-finite loss {results}")
    if launches != expected or at_dims != expected or any(results["torch"][2].values()):
        raise AssertionError(f"train_mimo_check: K1-K3 launches {launches}, at <192, 128> "
                             f"{at_dims}, plain run {results['torch'][2]}")
    if loss_rel > MIMO_LOSS_RTOL or max(grad_rel.values()) > MIMO_GRAD_RTOL:
        raise AssertionError("train_mimo_check: kernels and plain attention differ")
    if not max(c_grad_rel.values()) > MIMO_GRAD_RTOL:
        raise AssertionError("train_mimo_check: the control (no sinks) is within "
                             f"{MIMO_GRAD_RTOL} of the plain run: {c_grad_rel}")
    del results
    torch.cuda.empty_cache()
    return launches, cfg, params


def generate_mimo_phase(card: str, cfg, params) -> dict:
    """`generate()` (het_generate) on train_mimo_check's cut and weights,
    bf16: MIMO_GEN_PROMPTS mock prompts of MIMO_GEN_LEN tokens, MIMO_GEN_NEW
    greedy new tokens. The prefill's last-position logits (captured at the
    prefill's unembed) against the K1-K3 forward's on the same prompts
    within MIMO_GEN_LOGIT_TOL of the largest; ms per decode step from a
    1-token and a MIMO_GEN_NEW-token run. het_generate attends with einsums
    over its dense cache, as in JAX: it launches no kernel. Returns the
    K1-K3 launches of the reference forward."""
    from automodel_tpu_torch.inference import het_generate as het_gen
    from automodel_tpu_torch.models.moe_lm import het_moe

    cfg = dataclasses.replace(cfg, attn_impl="auto")
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompts = torch.randint(1, MOE_TRAIN_TOKEN_IDS, (MIMO_GEN_PROMPTS, MIMO_GEN_LEN),
                            generator=gen, device="cuda")
    reset_counts()
    with torch.no_grad():
        ref, _ = het_moe.forward(params, cfg, prompts)
    ref = ref[:, -1].float()
    fwd_launches = kernel_launches(*FLASH)
    captured = []
    unembed = het_gen.unembed

    def capture(*args):
        out = unembed(*args)
        captured.append(out)
        return out

    torch.cuda.reset_peak_memory_stats()
    times = {}
    het_gen.unembed = capture
    try:
        for n_new in (1, MIMO_GEN_NEW):
            captured.clear()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate(params, cfg, prompts, None, GenerateConfig(max_new_tokens=n_new))
            torch.cuda.synchronize()
            times[n_new] = (time.perf_counter() - t0) * 1e3
            gen_launches = kernel_launches(*FLASH)
    finally:
        het_gen.unembed = unembed
    prefill = captured[0][:, 0].float()
    err = (prefill - ref).abs().max().item()
    scale = ref.abs().max().item()
    decode_ms = (times[MIMO_GEN_NEW] - times[1]) / (MIMO_GEN_NEW - 1)
    first_equal = (prefill.argmax(-1) == ref.argmax(-1)).float().mean().item()
    emit({"phase": "generate_mimo", "card": card,
          "model": f"train_mimo_check's cut ({cfg.num_layers} layers), bf16",
          "prompts": [MIMO_GEN_PROMPTS, MIMO_GEN_LEN], "new_tokens": MIMO_GEN_NEW,
          "out_shape": list(out.shape), "prefill_logit_max_abs_err": err,
          "ref_logit_max": scale, "tol": MIMO_GEN_LOGIT_TOL,
          "first_token_agreement": first_equal,
          "prefill_ms": times[1], "generate_ms": times[MIMO_GEN_NEW],
          "ms_per_decode_step": decode_ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "reference_forward_launches": fwd_launches,
          "generate_launches": gen_launches})
    if tuple(out.shape) != (MIMO_GEN_PROMPTS, MIMO_GEN_LEN + MIMO_GEN_NEW):
        raise AssertionError(f"generate_mimo: output shape {tuple(out.shape)}")
    if not torch.isfinite(prefill).all() or err > MIMO_GEN_LOGIT_TOL * max(scale, 1.0):
        raise AssertionError(f"generate_mimo: prefill logits {err} from the forward's")
    if fwd_launches["K1"] != cfg.num_layers or any(gen_launches.values()):
        raise AssertionError(f"generate_mimo: K1-K3 launches {fwd_launches} (forward), "
                             f"{gen_launches} (generate)")
    return fwd_launches


def gemma4_cut(layers: int) -> dict:
    """GEMMA4_26B_A4B cut to `layers` layers: one global last, the rest
    sliding."""
    text = dict(GEMMA4_26B_A4B["text_config"], num_hidden_layers=layers,
                layer_types=["sliding_attention"] * (layers - 1) + ["full_attention"])
    return dict(GEMMA4_26B_A4B, text_config=text)


def train_gemma4_phase(card: str) -> dict:
    """Gemma-4 26B-A4B through the training CLI at its widths, cut to
    GEMMA4_LAYERS layers (one sliding, one global), bf16 over fp32 masters,
    full remat, GEMMA4_STEPS steps of GEMMA4_SEQ tokens: tokens/s, ms a
    step, MFU, peak memory and K1-K3 launches at <256, 256> (2 K1 a layer
    and step, forward and recompute); the loss must fall by a quarter over
    the steps. Returns the launches."""
    from automodel_tpu_torch.models.moe_lm import gemma4

    hf = gemma4_cut(GEMMA4_LAYERS)
    cfg0 = gemma4.gemma4_moe_config(hf)
    H, E = cfg0.hidden_size, cfg0.moe.n_routed_experts
    per_layer = (H * cfg0.head_dim * (2 * cfg0.num_heads + 2 * cfg0.num_kv_heads)
                 + 3 * H * cfg0.intermediate_size
                 + E * 3 * H * cfg0.moe.moe_intermediate_size + H * E
                 + 8 * H + 2 * cfg0.head_dim + 1)
    n_params = cfg0.vocab_size * H + H + GEMMA4_LAYERS * per_layer
    state_gib = 16 * n_params / 2**30
    if state_gib > GEMMA4_STATE_BUDGET_GIB:
        raise AssertionError(f"train_gemma4: {state_gib:.1f} GiB of fp32 state")
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_gemma4_")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    recipe = cli_main([moe_train_yaml(run_dir, "gemma4_train", hf, GEMMA4_SEQ,
                                      GEMMA4_STEPS)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel_launches(*FLASH)
    at_dims = flash_counts((256, 256))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    records = jsonl(Path(run_dir) / "training.jsonl")
    cfg = recipe.model_cfg
    steady = records[1:]
    tps = statistics.median(r["tps"] for r in steady)
    losses = [r["loss"] for r in records]
    ln_v = math.log(cfg.vocab_size)
    n = GEMMA4_LAYERS * GEMMA4_STEPS
    expected = {"K1": 2 * n, "K2": n, "K3": n}
    emit({"phase": "train_gemma4", "card": card,
          "model": f"Gemma-4 26B-A4B (from recall), full width, {GEMMA4_LAYERS} of 30 "
                   f"layers ({list(cfg.layer_types)}), bf16 over fp32 masters, "
                   f"remat {cfg.remat_policy}",
          "params": count_params(recipe.train_state.params), "params_reckoned": n_params,
          "fp32_state_gib_reckoned": state_gib, "steps": len(records),
          "tokens_per_step": GEMMA4_SEQ, "losses": losses,
          "grad_norms": [r["grad_norm"] for r in records], "ln_vocab": ln_v,
          "ln_vocab_note": "at 2 layers the input token's own embedding, scaled by "
                           "sqrt(H) and tied to the head, holds ~20% of the residual's "
                           "energy, so the step-1 loss lies ~2 x ln(V) (the current "
                           "token's own logit ~20); the fp32 check's forward sits there too",
          "ms_per_step": GEMMA4_SEQ / tps * 1e3, "tokens_per_s": tps,
          "mfu_pct": statistics.median(r["mfu_pct"] for r in steady),
          "tflops_per_device": statistics.median(r["tflops_per_device"] for r in steady),
          "moe_load_imbalance": [r.get("moe_load_imbalance") for r in records],
          "wall_s_with_setup": wall_s, "peak_mem_gib": peak_gib,
          "launches": launches, "expected_launches": expected,
          "launches_at_256_256": at_dims, "scale": cfg.attn_scale,
          "window": cfg.sliding_window})
    if count_params(recipe.train_state.params) != n_params:
        raise AssertionError(f"train_gemma4: {n_params} parameters reckoned, "
                             f"{count_params(recipe.train_state.params)} trained")
    if len(records) != GEMMA4_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
        raise AssertionError(f"train_gemma4: bad records {records}")
    if not losses[-1] < 0.75 * losses[0]:
        raise AssertionError(f"train_gemma4: the loss did not fall: {losses}")
    if launches != expected or at_dims != expected:
        raise AssertionError(f"train_gemma4: K1-K3 launches {launches}, at <256, 256> "
                             f"{at_dims}")
    del recipe
    torch.cuda.empty_cache()
    return launches


def train_gemma4_check_phase() -> None:
    """fp32, Gemma-4 26B-A4B widths, 2 layers (sliding, window 1024, and
    global): one accumulated step (2 microbatches of GEMMA4_CHECK_SEQ
    tokens) from the same weights and batch with attn_impl "flash" (K1-K3
    at <256, 256> on the CUDA cores) and "torch". The loss and every
    gradient leaf but the routed experts' and the router's within
    TRAIN_LOSS_RTOL / TRAIN_GRAD_TOL: the attention outputs differ by ~1e-6
    between the two, which may move a token whose 8th and 9th expert
    probabilities lie that close to another expert, and those two leaves'
    gradients with it (their errors are printed)."""
    from automodel_tpu_torch.models.moe_lm import gemma4

    base = gemma4.gemma4_moe_config(gemma4_cut(2), dtype=torch.float32,
                                    remat_policy="full")
    params0 = gemma4.init(base, torch.Generator(device="cuda").manual_seed(6))
    ds = MockDatasetConfig(num_samples=4, seq_len=GEMMA4_CHECK_SEQ,
                           vocab_size=MOE_TRAIN_TOKEN_IDS, seed=7).build()
    batch = make_global_batch(stack_microbatches(
        [{k: v[None] for k, v in ds[i].items()} for i in range(2)]), "cuda")
    results = {}
    for impl in ("flash", "torch"):
        cfg = dataclasses.replace(base, attn_impl=impl)

        def loss_fn(params, mb, rng, cfg=cfg):
            h, _ = gemma4.forward(params, cfg, mb["input_ids"], return_hidden=True)
            return fused_linear_cross_entropy(h, gemma4.head_kernel(params, cfg),
                                              mb["labels"], chunk_size=2048)

        params = tree_map(lambda t: t.clone().requires_grad_(), params0)
        reset_counts()
        ce, aux = accumulate_grads(loss_fn, params, batch)
        flat = {}

        def walk(node, prefix=""):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.")
                else:
                    flat[prefix + k] = v.grad
        walk(params)
        results[impl] = (float(ce / aux["num_label_tokens"]), flat, kernel_launches(*FLASH),
                         flash_counts((256, 256), ("fma",)))
        del params
        torch.cuda.empty_cache()
    (loss_f, g_f, n_f, d_f), (loss_t, g_t, n_t, _) = results["flash"], results["torch"]
    errs = {k: ((g_f[k] - g_t[k]).abs().max() / g_t[k].abs().max().clamp(min=1e-30)).item()
            for k in g_t if g_t[k] is not None}
    routed = {k: v for k, v in errs.items() if "experts" in k or "router" in k}
    held = {k: v for k, v in errs.items() if k not in routed}
    loss_rel = abs(loss_f - loss_t) / abs(loss_t)
    emit({"phase": "train_gemma4_check", "layers": 2, "dtype": "float32",
          "tokens": [2, GEMMA4_CHECK_SEQ], "loss_flash": loss_f, "loss_torch": loss_t,
          "loss_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
          "grad_max_rel_err": max(held.values()), "grad_tol": TRAIN_GRAD_TOL,
          "routed_leaves_rel_err": routed, "launches": [n_f, n_t],
          "launches_at_256_256_fp32": d_f})
    if n_f["K1"] == 0 or n_f != d_f or any(n_t.values()):
        raise AssertionError("train_gemma4_check: attn_impl did not select the kernels "
                             f"/ the plain path: {n_f}, {n_t}, {d_f}")
    if loss_rel > TRAIN_LOSS_RTOL or max(held.values()) > TRAIN_GRAD_TOL:
        raise AssertionError(f"train_gemma4_check: kernels and plain differ: {held}")
    torch.cuda.empty_cache()


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
    if len(sys.argv) > 2 and sys.argv[1] == "--train-mesh-rank":
        return train_mesh_rank(sys.argv[2])
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

    # each phase's seconds, for the total line
    seconds, last = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = round(now - last[0], 1)
        # a phase's recipes can outlive their last reference in reference
        # cycles (frames a lazy import keeps); free their memory on the card
        # before the next phase allocates
        gc.collect()
        torch.cuda.empty_cache()
        last[0] = time.perf_counter()

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    k4 = kernel_phase(flush)
    lap("kernel")
    paged = paged_kernels_phase(flush)
    lap("paged_kernels")
    windowed = window_kernels_phase(flush)
    lap("kernel_window")
    flash = flash_phase(flush)
    lap("flash")
    quant_mm_phase(flush)
    lap("quant_mm")
    del flush
    launches, llama = serve_phase(card)
    lap("serve")
    quant_launches = serve_quant_phase(card, *llama[:2])
    launches.update(K4_serve_fp8=quant_launches["K4"], K5_serve_int8w=quant_launches["K5"])
    del llama
    torch.cuda.empty_cache()
    lap("serve_fp8_int8w")
    launches.update(serve_mla_phase(card))
    lap("serve_mla")
    published = {
        "deepseek_v3": serve_published_mla_phase(
            card, "DeepSeek-V3", DEEPSEEK_V3, DSV3_SERVE_LAYERS,
            (("serve_dsv3", "K6"), ("serve_dsv3_int8", "K7"))),
        "kimi_k2": serve_published_mla_phase(
            card, "Kimi-K2", KIMI_K2, KIMI_SERVE_LAYERS, (("serve_kimi_k2", "K6"),)),
    }
    lap("serve_dsv3_kimi_k2")
    gqa_moe = {"qwen3_moe": serve_gqa_moe_phase(
        card, "Qwen3-30B-A3B", QWEN3_30B_A3B, QWEN3_SERVE_LAYERS,
        (("serve_qwen3_moe", "K4"), ("serve_qwen3_moe_int8", "K5")))}
    lap("serve_qwen3_moe")
    gqa_moe["gpt_oss"] = serve_gqa_moe_phase(
        card, "gpt-oss-20b", GPT_OSS_20B, GPT_OSS_SERVE_LAYERS, (("serve_gpt_oss", "K4"),))
    lap("serve_gpt_oss")
    gqa_moe["mixtral"] = serve_gqa_moe_phase(
        card, "Mixtral-8x7B", MIXTRAL_8X7B, MIXTRAL_SERVE_LAYERS, (("serve_mixtral", "K4"),))
    lap("serve_mixtral")
    window_launches = serve_gemma2_phase(card)
    lap("serve_gemma2")
    glm4_launches = serve_glm4_phase(card)
    lap("serve_glm4")
    group_launches = serve_dense_groups_phase(card)
    lap("serve_dense_groups")
    moe_sync_phase(card)
    lap("moe_sync")
    # Llama-3-8B's HF checkpoint: served by recipe_serve, the base of the
    # LoRA phases
    hf_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_llama3_8b_"))
    try:
        launches["K4_recipe"], untraced = recipe_serve_phase(card, hf_dir / "hf")
        lap("recipe_serve")
        launches["K4_serve_traced"] = serve_traced_phase(card, hf_dir / "hf", untraced)
        lap("serve_traced")
        serve_chaos_phase(card, hf_dir / "hf")
        lap("serve_chaos")
        lora = train_lora_phase(card, hf_dir / "hf")
        lap("train_lora")
        qlora_launches = train_qlora_phase(card, hf_dir / "hf", lora["peak_mem_gib"])
        lap("train_qlora")
    finally:
        shutil.rmtree(hf_dir, ignore_errors=True)
    engine_phase()
    lap("engine")
    engine_mla_phase()
    lap("engine_mla")
    engine_window_phase()
    lap("engine_window")
    generate_check_phase()
    lap("generate_check")
    torch.cuda.empty_cache()
    train_launches, train_summary = train_phase(card)
    lap("train")
    fp8_launches, fp8_summary = train_phase(card, "train_fp8",
                                            ("--model.linear_precision=fp8",))
    emit({"phase": "train_fp8_vs_train", "card": card,
          "ms_per_step": [train_summary["ms_per_step"], fp8_summary["ms_per_step"]],
          "tokens_per_s": [train_summary["tokens_per_s"], fp8_summary["tokens_per_s"]],
          "peak_mem_gib": [train_summary["peak_mem_gib"], fp8_summary["peak_mem_gib"]],
          "step1_loss": [train_summary["losses"][0], fp8_summary["losses"][0]]})
    lap("train_fp8")
    qat_launches = train_qat_phase(card)
    lap("train_qat")
    train_check_phase()
    lap("train_check")
    train_lora_check_phase()
    lap("train_lora_check")
    train_paths_phase()
    lap("train_paths")
    mesh_launches = train_mesh_phase(card, train_summary)
    lap("train_mesh")
    moe_launches, moe_ms = train_moe_phase(card)
    lap("train_moe")
    train_moe_capacity_phase(card, moe_ms)
    lap("train_moe_capacity")
    train_moe_check_phase()
    lap("train_moe_check")
    mtp_launches = train_dsv3_mtp_phase(card)
    lap("train_dsv3_mtp")
    family_launches = {"qwen3_moe": train_gqa_moe_phase(
        card, "train_qwen3_moe", "Qwen3-30B-A3B", QWEN3_30B_A3B, QWEN3_TRAIN_LAYERS)}
    lap("train_qwen3_moe")
    family_launches["gpt_oss"] = train_gqa_moe_phase(
        card, "train_gpt_oss", "gpt-oss-20b", GPT_OSS_20B, GPT_OSS_TRAIN_LAYERS)
    lap("train_gpt_oss")
    train_gpt_oss_check_phase()
    lap("train_gpt_oss_check")
    smoke_launches = smoke_families_phase(card)
    lap("smoke_families")
    qwen_recipe, qwen_launches, _ = train_qwen25_lora_phase(card)
    lap("train_qwen25_lora")
    remat_policies_phase(card, qwen_recipe)
    del qwen_recipe
    torch.cuda.empty_cache()
    lap("remat_policies")
    encoder_launches = train_encoders_phase(card)
    lap("train_encoders")
    train_encoders_check_phase()
    lap("train_encoders_check")
    dense_smoke_launches = smoke_families_phase(card, "smoke_dense_families",
                                                DENSE_SMOKE_YAMLS)
    lap("smoke_dense_families")
    tokenbin_launches = train_tokenbin_phase(card)
    lap("train_tokenbin")
    glm47_launches = serve_glm47_flash_phase(card)
    lap("serve_glm47_flash")
    glm47_flash_entries, glm47_train_launches = train_glm47_flash_phase(card)
    lap("train_glm47_flash")
    mistral4_launches = serve_mistral4_phase(card)
    lap("serve_mistral4")
    dsv32_launches = serve_dsv32_phase(card)
    lap("serve_dsv32")
    dsa_check_phase(card)
    lap("dsa_check")
    dsa_train_launches = train_dsv32_dsa_phase(card)
    lap("train_dsv32_dsa")
    moe_lite_smoke_launches = smoke_families_phase(card, "smoke_moe_lite",
                                                   MOE_LITE_SMOKE_YAMLS)
    lap("smoke_moe_lite")
    chat_sft_launches = train_chat_sft_phase(card)
    lap("train_chat_sft")
    resilient_launches = train_resilient_phase(card)
    lap("train_resilient")
    gemma_launches, gemma2_records = train_gemma_phase(
        card, "train_gemma2", "Gemma-2-2B", GEMMA2_2B, GEMMA2_TRAIN_SEQ)
    lap("train_gemma2")
    gemma_launches = {"gemma2": gemma_launches, "gemma3": train_gemma_phase(
        card, "train_gemma3", "Gemma-3-1B", GEMMA3_1B, GEMMA3_TRAIN_SEQ)[0]}
    lap("train_gemma3")
    train_gemma2_plain_phase(card, gemma2_records)
    lap("train_gemma2_plain")
    train_gemma_check_phase()
    lap("train_gemma_check")
    ckpt_serve_launches = train_gemma3_ckpt_phase(card)
    lap("train_gemma3_ckpt")
    het_smoke_launches = smoke_families_phase(card, "smoke_het", HET_SMOKE_YAMLS)
    lap("smoke_het")
    mimo_launches, mimo_cfg, mimo_weights = train_mimo_check_phase(card)
    lap("train_mimo_check")
    mimo_gen_launches = generate_mimo_phase(card, mimo_cfg, mimo_weights)
    del mimo_weights
    lap("generate_mimo")
    gemma4_launches = train_gemma4_phase(card)
    lap("train_gemma4")
    train_gemma4_check_phase()
    lap("train_gemma4_check")

    no_library = ("no single PyTorch call attends over per-row page tables; "
                  "scaled_dot_product_attention needs each row's KV gathered "
                  "dense (and dequantized) first")
    paged_rows = (
        ("K4", "ragged_paged_attention_gqa", "ragged_paged_attention.cu", ":42",
         k4["llama3_8b"]),
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
        if name == "K4":  # the llm_serve recipe's runs, counted apart
            kernels[-1]["recipe_serve_launches"] = launches["K4_recipe"]
            kernels[-1]["serve_traced_launches"] = launches["K4_serve_traced"]
            kernels[-1]["serve_fp8_launches"] = launches["K4_serve_fp8"]
        if name == "K5":  # serve_precision int8 over the int8 pool
            kernels[-1]["serve_int8w_launches"] = launches["K5_serve_int8w"]
        if name in ("K4", "K5"):  # the GQA MoE serve runs, counted apart
            for model, runs in gqa_moe.items():
                if name in runs:
                    kernels[-1][f"{model}_serve_launches"] = runs[name]
        if name in ("K6", "K7"):
            # the published models' serve runs, counted apart, and the fp32
            # route at their head counts
            kernels[-1]["deepseek_v3_serve_launches"] = published["deepseek_v3"][name]
            if name in published["kimi_k2"]:
                kernels[-1]["kimi_k2_serve_launches"] = published["kimi_k2"][name]
            kernels[-1]["fp32_many_heads"] = e["fp32_many_heads"]
            # GLM-4.7-Flash's serve runs (20 heads), Mistral-4's (K6)
            kernels[-1]["glm47_flash_serve_launches"] = glm47_launches[name]
            if name == "K6":
                kernels[-1]["mistral4_serve_launches"] = mistral4_launches
                # DeepSeek-V3.2 decodes dense over the latent pool
                kernels[-1]["deepseek_v32_serve_launches"] = dsv32_launches
        # each paged kernel's route follows the query dtype
        if name in ("K4", "K5"):
            kernels[-1]["kernel_route"] = rpa_cuda.route(torch.bfloat16)
        elif name in ("K6", "K7"):
            kernels[-1]["kernel_route"] = mla_cuda.route(torch.bfloat16)
    # K4 and K5 with windows (and sinks, checked apart): Gemma-2-2B's heads at
    # positions of ~8000, window 4096, beside the same rows with no window;
    # the launches of the serve_gemma2 runs (every layer, windowed or global)
    for name, kname, line in (
            ("K4", "ragged_paged_attention_gqa_window", ":42"),
            ("K5", "ragged_paged_attention_gqa_int8_window", ":170")):
        e = windowed[(name, "gemma2_2b_window_4096")]
        g = windowed[(name, "gemma2_2b_global")]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "automodel_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "automodel_tpu/ops/pallas/ragged_paged_attention.py" + line,
            "launches": window_launches[name],
            "max_abs_err": e["max_abs_err"],
            "ms": e["ms"],
            "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"],
            "library_ms": None,
            "library_why": no_library,
            "card": card,
            "kernel_route": rpa_cuda.route(torch.bfloat16),
            "window": e["window"], "heads": e["heads"], "contexts": e["contexts"],
            "unwindowed_ms": g["ms"], "unwindowed_bound_ms": g["bound_ms"],
            "unwindowed_plain_ms": g["plain_ms"],
        })
        if name == "K4":  # the llm_serve run of the Gemma-3-1B export
            kernels[-1]["ckpt_serve_launches"] = ckpt_serve_launches
    # K6 and K7 at GLM-4.7-Flash's 20 heads x r 512 (a whole and a partial
    # head tile), the serve_glm47_flash runs' launches, the fp32 route's
    # entry beside
    for name, kname, line in (("K6", "paged_mla_attention_glm47_flash", ":315"),
                              ("K7", "paged_mla_attention_int8_glm47_flash", ":428")):
        e = paged[f"{name}_glm47_flash"]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "automodel_tpu_torch/csrc/paged_mla_attention.cu",
            "replaces": "automodel_tpu/ops/pallas/ragged_paged_attention.py" + line,
            "launches": glm47_launches[name],
            "max_abs_err": e["max_abs_err"],
            "ms": e["ms"],
            "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"],
            "library_ms": None,
            "library_why": no_library,
            "card": card,
            "kernel_route": mla_cuda.route(torch.bfloat16),
            "heads": e["heads"], "rank": e["rank"], "head_tiles": e["head_tiles"],
            "fp32": e["fp32"],
        })
    # K4 at Qwen3-30B-A3B's heads (G 8 x D 128), the serve_qwen3_moe run's
    # launches
    e = k4["qwen3_moe"]
    kernels.append({
        "name": "ragged_paged_attention_gqa_qwen3_moe",
        "route": "cuda",
        "source": "automodel_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "automodel_tpu/ops/pallas/ragged_paged_attention.py:42",
        "launches": gqa_moe["qwen3_moe"]["K4"],
        "max_abs_err": e["max_abs_err"],
        "ms": e["ms"],
        "plain_ms": e["plain_ms"],
        "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"],
        "library_ms": None,
        "library_why": no_library,
        "card": card,
        "kernel_route": rpa_cuda.route(torch.bfloat16),
        "heads": e["heads"],
    })
    # K4 at the dense families' groups (Qwen2.5-7B's G 7, GLM-4-9B's G 16,
    # Baichuan2-7B's G 1) with the launches of their serve runs, and K5 at
    # GLM-4-9B's
    group_runs = {"qwen25_7b": group_launches["qwen25_7b"],
                  "glm4_9b": glm4_launches["K4"],
                  "baichuan2_7b": group_launches["baichuan2_7b"]}
    for name, kname, line, e, n in (
            [("K4", f"ragged_paged_attention_gqa_{m}", ":42", k4[m], group_runs[m])
             for m in K4_GROUP_HEADS]
            + [("K5", "ragged_paged_attention_gqa_int8_glm4_9b", ":170",
                paged["K5_glm4_9b"], glm4_launches["K5"])]):
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "automodel_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "automodel_tpu/ops/pallas/ragged_paged_attention.py" + line,
            "launches": n,
            "max_abs_err": e["max_abs_err"],
            "ms": e["ms"],
            "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"],
            "library_ms": None,
            "library_why": no_library,
            "card": card,
            "kernel_route": rpa_cuda.route(torch.bfloat16),
            "heads": e["heads"],
        })
    # K1-K3 at Llama-3-8B's heads (<128, 128>, the dense train run's
    # launches), at Moonlight's MLA heads (<192, 128>, train_moe's), at
    # Gemma-2-2B's and Gemma-3-1B's windowed heads (<256, 256>, their
    # training runs'), at the encoder's with no mask (<64, 64>, the
    # bi-encoder run's) and at Qwen2.5-7B's (<128, 128>, its LoRA run's)
    for key, suffix, dims, runs in (
            ("dense", "", (128, 128), train_launches),
            ("mla", "_mla", (192, 128), moe_launches),
            ("gemma2", "_gemma2", (256, 256), gemma_launches["gemma2"]),
            ("gemma3", "_gemma3", (256, 256), gemma_launches["gemma3"]),
            ("gpt_oss", "_gpt_oss", (64, 64), family_launches["gpt_oss"]),
            ("encoder", "_encoder", (64, 64), encoder_launches),
            ("qwen25_7b", "_qwen25_7b", (128, 128), qwen_launches),
            ("glm47_flash", "_glm47_flash", (256, 256), glm47_train_launches),
            ("mimo_swa", "_mimo_swa", (192, 128), mimo_launches),
            ("gemma4", "_gemma4", (256, 256), gemma4_launches)):
        for name, replaces in (("K1", ":140"), ("K2", ":238"), ("K3", ":283")):
            e = (glm47_flash_entries if key == "glm47_flash" else flash[key])[name]
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
            if key == "dense":  # the LoRA runs at the same heads, counted apart
                row["train_lora_launches"] = lora["launches"][name]
                row["train_qlora_launches"] = qlora_launches[name]
            if key == "mla":  # DeepSeek-V3 with yarn and the MTP head, apart
                row["train_dsv3_mtp_launches"] = mtp_launches[name]
            if key == "dense":  # Qwen3-30B-A3B's heads are <128, 128> too
                row["train_qwen3_moe_launches"] = family_launches["qwen3_moe"][name]
                row["train_tokenbin_launches"] = tokenbin_launches[name]
                row["train_fp8_launches"] = fp8_launches[name]
                row["train_qat_launches"] = qat_launches[name]
                # rank 0 of the training mesh (tp-local heads: all of them at tp 1)
                row["train_mesh_launches"] = mesh_launches[name]
            if key == "mla":  # DSA training runs no flash attention
                row["train_dsv32_dsa_launches"] = dsa_train_launches[name]
            if key == "encoder":  # Llama-3.2-1B's heads, causal
                row["train_chat_sft_launches"] = chat_sft_launches[name]
                row["train_resilient_launches"] = resilient_launches[name]
            if key == "gpt_oss":  # the smoke YAMLs' head dim 8, padded to 16
                row["smoke_families_launches_at_16"] = {
                    fam: c[name] for fam, c in smoke_launches.items()}
                row["smoke_dense_families_launches_at_16"] = {
                    fam: c[name] for fam, c in dense_smoke_launches.items()}
                row["smoke_moe_lite_launches_at_16"] = {
                    fam: c[name] for fam, c in moe_lite_smoke_launches.items()}
                row["smoke_het_launches_at_16"] = {
                    fam: c[name] for fam, c in het_smoke_launches.items()}
            if key == "mimo_swa":  # train_mimo_check's kernel run, both layers
                row["launches_note"] = (
                    "train_mimo_check's forward and backward, both layers at <192, 128> "
                    "(the global layer G 16 with no window, the sliding one G 8, "
                    "window 128, sinks)")
                row["generate_mimo_reference_forward_launches"] = mimo_gen_launches[name]
            kernels.append(row)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "phase_seconds": seconds})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
