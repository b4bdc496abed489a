"""The flagship recipe: next-token-prediction finetune / pretrain on one
device (port of `automodel_tpu/recipes/llm/train_ft.py`).

YAML-driven setup of model -> optimizer -> data -> logging, then the train
loop: per step the microbatches of `grad_acc_steps` run the port's decoder
forward (K1 for every attention call on the card, twice under full remat),
the chunked linear cross-entropy, the backward (K2, K3), global-norm
clipping and the optimizer update (`training/train_step.py`). Each step
appends a `training.jsonl` record with the JAX recipe's keys.

A MoE model (a config with `moe`, e.g. DeepSeek-V3 / Moonlight) trains as
in the JAX recipe: pad labels (-100) mask their tokens out of routing, the
aux loss joins the CE sum scaled by the label-token count
(`combine_losses`), each microbatch's tokens per expert add up over the
step, the DeepSeek gate bias moves after the optimizer step
(`apply_gate_bias_update`), and the record carries `moe_load_imbalance`.
`model.fake_balanced_gate` and `model.moe_dispatcher` ("dropless" or
"capacity") override the MoE config. The heterogeneous MoE engine
(Step-3.5, MiMo-V2-Flash, MiniMax-M3) and Gemma-4 MoE train the same way:
the loss and the gate-bias update go through the model module's own
`head_kernel` and `apply_gate_bias_update`, the validation generation
through `generate()` (`het_generate`), the consolidated export through the
architecture's adapter. A config with the MTP head
(`num_nextn_predict_layers`) adds `mtp_loss_coeff` times its CE to the CE
sum, normalised by the same label tokens; from `model.pretrained_path` the
head starts fresh from the recipe's generator, as HF checkpoints do not
map it.

The train-state checkpointer runs as in the JAX recipe (on unless
`checkpoint.enabled: false`): a save every `step_scheduler.ckpt_every_steps`
steps, a final save and wait (which then frees the checkpointer's host
snapshot buffers), `checkpoint.save_consolidated` as a
consolidated HF export to `<checkpoint_dir>/hf` after the final save,
`checkpoint.restore_from` / `restore_step` or else auto-resume from the
newest committed step (`auto_resume`, default true), and
`time_to_resume_s` on the first record after a resume. SIGTERM sets the
step scheduler's flag; after the step it lands in, the recipe forces a
save, waits for its commit at most `resilience.sigterm_grace_s` (30 s by
default) from the signal, logs an `emergency_checkpoint` record and
returns.

The `resilience` section (`resilience/`) is wired first, before the model
build, as in the JAX recipe: its `faults` are installed as the process's
fault injector (the checkpointer's, the HF reader's and export's probes,
and the loop's `nan_grads` and `sigterm` flags), its retry policy wraps the
pretrained reads, the checkpointer and the HF export (each attempt counted
as `retry_<point>` on the records), `max_consecutive_nonfinite` fails a
diverged run fast naming its first bad step, `snapshot_every_steps` keeps
host snapshots of the train state and rolls back to the newest on a
non-finite step or a loss spike (`rollback` records; the data stream moves
on), and `transfer_guard` runs the train step under
`torch.cuda.set_sync_debug_mode("error")`, so a host sync inside the step
raises on the card (the CPU has no device to sync with). The `profiling`
section writes a `torch.profiler` trace of its step window to `trace_dir`.

The `peft` section trains LoRA / DoRA adapters over a frozen base, int8
for QLoRA (`peft/lora.py`): the adapters are the train state (the
optimizer's, the checkpoint's), merged into the base one layer at a time
inside the decoder; the consolidated export holds the merged weights.
`validation_dataset` runs every `step_scheduler.val_every_steps` steps:
`validation.jsonl` gets the token-weighted `val_loss` and, with
`validation_generation`, the greedy sampling eval (`eval/sampling.py`).

The `tokenizer` section builds an HF tokenizer from a local path
(`models/auto_tokenizer.py`), handed to datasets whose `build` takes one
(chat, agent, column-mapped and the presets) and to the sampling eval,
which then adds the tool-call metrics. The `wandb`, `mlflow` and `comet`
sections each build a tracker (`loggers/trackers.py`; a local JSONL
mirror where the library is missing or offline): the config at setup,
every `training.jsonl` record's metrics, and the run's end, "FINISHED",
"KILLED" after a SIGTERM or "FAILED" when the loop raises. `gc_control`
(with `gc_every_steps`) turns automatic garbage collection off for the
run and collects on that step cadence (`training/utils.GCController`);
collection comes back on at every exit of the loop.

`model.linear_precision` ("fp8" / "int8") quantizes the decoders' linears
per channel in every forward (`ops/quant.quantized_matmul`; the backward
stays bf16 on the original operands). The `qat` section (`enabled`,
`precision`, `start_step`) fake-quantizes every `kernel` leaf inside the
train step once the step count reaches `start_step`, with straight-through
gradients to the fp32 masters; with `peft` it raises ValueError, as in JAX
(the transform would see only the adapters). `model.dsa_impl` and
`model.dsa_query_block` pick a DSA model's sparse path; a DSA model read
from a checkpoint without indexer weights (a V3-style one) gets fresh
indexers from the recipe's generator.

The `distributed` section builds the mesh when a launcher started the
process (`torchrun --nproc-per-node N`, or a test's spawned ranks:
`distributed/init_utils.py`; NCCL on the card, gloo on the CPU), as the
JAX recipe builds its mesh over the devices: the params become DTensors
laid out by the model's `param_specs` and the rule table (FSDP over
`dp_shard`, HSDP with `dp_replicate`, tensor parallelism over `tp`,
experts over `ep`; `parallel/`), the same seed giving the same global
weights on every mesh; each rank feeds its slice of the global batch the
dataloader yields (the microbatch must divide by dp_replicate * dp_shard
* ep); the train step reduces over the mesh (`training/train_step.py`);
the checkpoint is saved sharded and restores onto any mesh
(`checkpoint/sharded.py`); the records, trackers and exports come from
rank 0. A process no launcher started is the one-device path, where the
mesh's sizes must resolve to 1 (`dp_shard: -1` does).

The same YAML files drive both packages. What the port does not have yet
raises NotImplementedError instead of being skipped: `cp` or `pp` above 1
(ROADMAP.md item 12b), other unported architectures
(`models/registry.py`), a remote `checkpoint_dir`, and PEFT on a MoE model
with the gate-bias update or the MTP head.

`model.pretrained_path` names a local HF safetensors checkpoint: its
`config.json` gives the HF config and `checkpoint/hf_adapter.py` fills the
params on the device.

The `packing` section parses (`recipes/typed_config.py`) and, as in the
JAX recipe, applies to nothing: a packed dataset brings its own segment
ids and positions.

Recipes over other heads (`train_seq_cls.py`, `retrieval/`) subclass this
one: they add their head in `_build_peft`, build their loss on
`make_hidden_forward` in `_make_loss_fn`, and count their tokens in
`_batch_token_count`. Scalar sums of a loss's aux dict other than the
label-token count (`num_correct`) join the step's record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import logging
import os
import time

import numpy as np
import torch

from automodel_tpu_torch.checkpoint import (
    HFCheckpointReader,
    get_adapter,
    save_hf_checkpoint,
)
from automodel_tpu_torch.config import ConfigNode, parse_args_and_load_config
from automodel_tpu_torch.datasets.loader import make_global_batch, stack_microbatches
from automodel_tpu_torch.distributed import (
    initialize_distributed,
    is_main_process,
    refuse_unported_axes,
)
from automodel_tpu_torch.distributed.init_utils import local_device
from automodel_tpu_torch.loggers.metric_logger import MetricLogger, setup_logging
from automodel_tpu_torch.loggers.trackers import build_trackers
from automodel_tpu_torch.loss import fused_linear_cross_entropy
from automodel_tpu_torch.loss.utils import combine_losses
from automodel_tpu_torch.models.common.layers import count_params
from automodel_tpu_torch.models.moe_lm.mtp import init_mtp, mtp_hidden, mtp_loss
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.parallel.collectives import copy_to
from automodel_tpu_torch.parallel.sharding import (
    distribute_params,
    full_tree,
    local_tree,
    logical_to_shardings,
)
from automodel_tpu_torch.peft.lora import (
    LAYER_STACKS,
    init_lora,
    lora_param_shardings,
    merge_lora,
    merged_state_dict,
    quantize_base,
)
from automodel_tpu_torch.recipes.base_recipe import BaseRecipe
from automodel_tpu_torch.resilience import (
    ResilienceError,
    install_injector,
    process_index,
    wait_with_deadline,
)
from automodel_tpu_torch.training import (
    TrainStepConfig,
    init_train_state,
    make_train_step,
)
from automodel_tpu_torch.training.rng import StatefulRNG
from automodel_tpu_torch.training.step_scheduler import StepScheduler
from automodel_tpu_torch.training.utils import GCController
from automodel_tpu_torch.utils.device import resolve_device, torch_dtype
from automodel_tpu_torch.utils.flops import MFUCalculator, device_peak_tflops
from automodel_tpu_torch.utils.tree import tree_leaves

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def sync_guard(device: torch.device, enabled: bool = True):
    """Within the block a host sync on the card (an `.item()`, a
    device-to-host copy, a blocking host-to-device copy) raises: the
    `resilience.transfer_guard` tripwire around the train step. The CPU
    has no device to sync with, so there it does nothing."""
    if not enabled or device.type != "cuda":
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


class RetryCounter:
    """The retry policy's `on_attempt`: counts every retried I/O attempt as
    `retry_<point>` and pins the counts on the metric logger once it is
    attached (the pretrained reads retry before it exists). An object of
    its own, so the checkpointer that holds it holds no reference back to
    the recipe, whose memory then goes with its last reference."""

    def __init__(self):
        self.counts: dict = {}
        self.metric_logger = None

    def attach(self, metric_logger) -> None:
        self.metric_logger = metric_logger
        for name, n in self.counts.items():
            metric_logger.set_counter(name, n)

    def __call__(self, point, attempt, exc, delay_s) -> None:
        name = f"retry_{point}"
        self.counts[name] = self.counts.get(name, 0) + 1
        if self.metric_logger is not None:
            self.metric_logger.set_counter(name, self.counts[name])


def make_hidden_forward(module, model_cfg, peft_cfg=None, base_params=None,
                        mesh_ctx=None):
    """The backbone forward every recipe shares (JAX `make_hidden_forward`),
    hiding the LoRA merge and the MoE forward's extra outputs.

    `fwd(params, ids, token_mask=None, **kw) -> (params, hidden, aux,
    extra)`: under PEFT `params` is the adapter tree, merged into the frozen
    `base_params` layer by layer inside the decoder, and the returned tree
    is the base with the adapters merged outside the layers (the head and
    embeddings, for tied heads); `aux` is the MoE aux loss (else None) and
    `extra` the tokens per expert of a MoE model. `token_mask` keeps pad
    tokens out of the MoE routing. On a mesh the returned tree's leaves
    outside the layer stacks are unsharded over `dp_shard` (local tensors,
    still split on `tp`) and merged there."""
    is_moe = getattr(model_cfg, "moe", None) is not None
    if mesh_ctx is not None:
        from automodel_tpu_torch.parallel.spmd import Spmd

        spmd = Spmd(mesh_ctx)

    def fwd(params, ids, *, token_mask=None, **kw):
        lora = None
        if peft_cfg is not None:
            lora, params = params, base_params
            kw.update(lora=lora, lora_cfg=peft_cfg)
        if mesh_ctx is not None:
            kw["mesh_ctx"] = mesh_ctx
        aux, extra = None, {}
        if is_moe:
            hidden, aux, stats = module.forward(
                params, model_cfg, ids, return_hidden=True, return_stats=True,
                token_mask=token_mask, **kw)
            extra = {"tokens_per_expert": stats["tokens_per_expert"]}
        else:
            hidden = module.forward(params, model_cfg, ids, return_hidden=True, **kw)
        if mesh_ctx is not None:
            params = {k: v for k, v in params.items() if k not in LAYER_STACKS}
            if lora is not None:
                lora = {k: v for k, v in lora.items()
                        if k.split("/", 1)[0] not in LAYER_STACKS}
                flags = spmd.lora_tp_flags({"base": params, "lora": lora})
                lora = {k: {n: copy_to(x, spmd.tp) if flags[k][n] else x
                            for n, x in ab.items()}
                        for k, ab in spmd.gather_tree(lora).items()}
            params = spmd.gather_tree(params)
        if lora is not None:
            params = merge_lora(params, lora, peft_cfg, skip=LAYER_STACKS)
        return params, hidden, aux, extra

    return fwd


class TrainFinetuneRecipeForNextTokenPrediction(BaseRecipe):
    def __init__(self, cfg: ConfigNode, device=None):
        super().__init__(cfg)
        self.device = resolve_device(device)
        self.mesh_ctx = None

    # ------------------------------------------------------------------
    def setup(self) -> None:
        cfg = self.cfg
        setup_logging()
        self._setup_mesh()
        self.rng = StatefulRNG(seed=int(cfg.get("seed", 42)), device=self.device)
        # resilience comes FIRST: the pretrained reads of _build_model already
        # run under the retry policy and the fault points
        self._setup_resilience()
        self._build_model(torch.float32)  # fp32 masters
        self._build_peft()
        self._distribute()
        self._build_optimizer()
        self._build_data()
        ckpt_cfg = dataclasses.replace(
            self.typed.checkpoint,
            save_every_steps=self.step_scheduler.config.ckpt_every_steps,
        )
        self.checkpointer = ckpt_cfg.build() if ckpt_cfg.enabled else None
        if self.checkpointer is not None and self._retry_policy is not None:
            self.checkpointer.set_retry(self._retry_policy,
                                        on_attempt=self._on_retry_attempt)
        run_dir = cfg.get("run_dir", ".")
        # the records and trackers are rank 0's
        main = is_main_process()
        self.metric_logger = MetricLogger(
            os.path.join(run_dir, "training.jsonl") if main else None, also_stdout=main)
        self.val_logger = MetricLogger(
            os.path.join(run_dir, "validation.jsonl") if main else None, also_stdout=main)
        # retries before the logger existed (the pretrained reads) ride the
        # first records too
        self._on_retry_attempt.attach(self.metric_logger)
        self.trackers = build_trackers(cfg, run_dir) if main else []
        for t in self.trackers:
            t.log_config(cfg.to_dict(redact=True))
        self.profiler = self.typed.profiling.build(self.device)
        seq_len = int(cfg.get("dataset.seq_len", 512))
        self.mfu = MFUCalculator(
            flops_per_token=self.model_cfg.flops_per_token(seq_len),
            num_devices=self.mesh_ctx.num_devices if self.mesh_ctx is not None else 1,
            peak_tflops_per_device=(
                device_peak_tflops(self.device) if self.device.type == "cuda" else None
            ),
        )

        restore_from = cfg.get("checkpoint.restore_from", None)
        t_restore = time.perf_counter()
        resumed = False
        if restore_from:
            self.restore_from(restore_from, step=cfg.get("checkpoint.restore_step"))
            resumed = True
        elif cfg.get("auto_resume", True):
            resumed = self.load_checkpoint()
        if resumed:
            # restore only: the model build is the same either way
            self._time_to_resume_s = round(time.perf_counter() - t_restore, 3)
        self.gc = GCController(every_steps=int(cfg.get("gc_every_steps", 100)),
                               enabled=bool(cfg.get("gc_control", False)))
        self.step_scheduler.install_sigterm_handler()

    def _setup_mesh(self) -> None:
        """The `distributed` section (JAX recipe `:130`): under a launcher,
        the process group and the mesh over its ranks; otherwise the
        one-device path, whose sizes must resolve to 1. `cp` and `pp` above
        1 raise NotImplementedError (item 12b)."""
        mesh_cfg = self.typed.mesh
        refuse_unported_axes(dataclasses.asdict(mesh_cfg))
        if not initialize_distributed(self.device):
            mesh_cfg.resolve(1)
            return
        self.device = local_device(self.device)
        self.mesh_ctx = mesh_cfg.build(self.device.type)
        logger.info("mesh: %s", self.mesh_ctx.describe())
        if type(self)._make_loss_fn is not TrainFinetuneRecipeForNextTokenPrediction._make_loss_fn:
            raise NotImplementedError(
                f"{type(self).__name__} on a mesh: only the next-token loss runs "
                "sharded so far")

    def _setup_resilience(self) -> None:
        """The fault-tolerance layer (`resilience/`): the config's fault
        injector installed for the process, the retry policy (seeded with
        the process's rank), the rollback manager and the nonfinite
        counters. Runs before the model, the checkpointer and the loggers
        exist; the checkpointer takes the policy in setup()."""
        res_cfg = self.typed.resilience
        self.resilience_cfg = res_cfg
        self.fault_injector = install_injector(res_cfg.build_injector())
        if self.fault_injector.armed:
            logger.warning("fault injection armed: %s",
                           [dataclasses.asdict(s) for s in self.fault_injector.specs])
        self._retry_policy = res_cfg.retry_policy(seed=process_index())
        self._on_retry_attempt = RetryCounter()
        self.rollback = res_cfg.build_rollback()
        self._nonfinite_streak = 0
        self._first_nonfinite_step = None
        self._time_to_resume_s = None
        self._preempt_finished = False

    def _check_nonfinite_cap(self, step: int, nonfinite: bool) -> None:
        """Fail fast on a diverged run: without this cap a NaN'd run would
        skip (or apply) non-finite updates to completion. With rollback on,
        recovery fires first; this cap is the backstop."""
        if not nonfinite:
            self._nonfinite_streak = 0
            self._first_nonfinite_step = None
            return
        self._nonfinite_streak += 1
        if self._first_nonfinite_step is None:
            self._first_nonfinite_step = step
        cap = int(self.resilience_cfg.max_consecutive_nonfinite or 0)
        if self.resilience_cfg.enabled and cap and self._nonfinite_streak >= cap:
            raise ResilienceError(
                f"{self._nonfinite_streak} consecutive non-finite step(s); "
                f"first bad step: {self._first_nonfinite_step}. The run has "
                "diverged — failing fast instead of skipping every update "
                "to completion (raise resilience.max_consecutive_nonfinite "
                "or enable rollback snapshots to auto-recover)")

    def _maybe_rollback(self, step: int, loss: float, nonfinite: bool) -> bool:
        """NaN/spike detection + bounded rollback. Returns True when the
        step's outcome was discarded and the loop should move on."""
        if self.rollback is None:
            return False
        reason = self.rollback.observe(step, loss, nonfinite)
        if reason is None:
            return False
        snap_step, self.train_state = self.rollback.rollback(step, reason)
        self._nonfinite_streak = 0
        self._first_nonfinite_step = None
        self.metric_logger.set_counter("rollbacks", self.rollback.stats.rollbacks)
        self.metric_logger.set_counter("wasted_steps", self.rollback.stats.wasted_steps)
        self.metric_logger.log({
            "step": step, "event": "rollback", "reason": reason,
            "restored_step": snap_step,
        })
        return True

    @torch.no_grad()
    def _poison_params(self) -> None:
        """The `nan_grads` fault: every trainable leaf becomes NaN, so this
        step's gradients (and every later step's, absent recovery) are
        non-finite."""
        for p in tree_leaves(local_tree(self.train_state.params)):
            p.mul_(float("nan"))

    # ------------------------------------------------------------------
    def _build_model(self, param_dtype: torch.dtype | None) -> None:
        """The model config, and its params on the device in `param_dtype`
        (None: the model's compute dtype): read from the HF checkpoint at
        `model.pretrained_path`, whose config.json gives the HF config, or
        drawn from the recipe's generator."""
        mcfg = self.cfg.get("model")
        overrides = dict(
            dtype=torch_dtype(mcfg.get("dtype", "bfloat16")),
            remat_policy=mcfg.get("remat_policy", "full"),
            attn_impl=mcfg.get("attn_impl", "auto"),
        )
        if mcfg.get("linear_precision", None):
            overrides["linear_precision"] = mcfg.get("linear_precision")
        # DSA implementation knobs (oracle | chunked | auto)
        if mcfg.get("dsa_impl", None):
            overrides["dsa_impl"] = str(mcfg.get("dsa_impl"))
        if mcfg.get("dsa_query_block", None):
            overrides["dsa_query_block"] = int(mcfg.get("dsa_query_block"))

        def build_config(hf_config) -> torch.dtype:
            self._hf_config = dict(hf_config)
            self.model_spec = get_model_spec(hf_config)
            cfg = self.model_spec.config_from_hf(hf_config, **overrides)
            self.model_cfg = self._moe_overrides(cfg, mcfg)
            return self.model_cfg.dtype if param_dtype is None else param_dtype

        pretrained = mcfg.get("pretrained_path")
        if pretrained:
            with HFCheckpointReader(pretrained, retry_policy=self._retry_policy,
                                    on_retry=self._on_retry_attempt) as reader:
                hf_config = reader.hf_config()
                if hf_config is None:
                    raise FileNotFoundError(f"{pretrained}: no config.json")
                dtype = build_config(hf_config)
                adapter = get_adapter(self.model_spec.adapter_name, self.model_cfg,
                                      **self.model_spec.adapter_kwargs)
                kw = {}
                if (self.mesh_ctx is not None and self.cfg.get("peft") is None
                        and hasattr(self.model_spec.module, "param_specs")):
                    # each rank keeps its block of each leaf as it is read
                    kw["place"] = self._place_leaf
                self._init_params = adapter.from_hf(reader, device=self.device,
                                                    dtype=dtype, **kw)
            if getattr(self.model_cfg, "dsa_index_topk", None) is not None:
                self._backfill_indexers(dtype)
            if getattr(self.model_cfg, "mtp_num_layers", 0) > 0:
                # MTP weights are training-only and not part of HF
                # checkpoints: they start fresh
                self._init_params["mtp"] = init_mtp(
                    self.model_cfg, self.rng.next_key(), dtype=dtype)
            logger.info("loaded pretrained weights from %s", pretrained)
        else:
            hf_config = mcfg.get("hf_config")
            dtype = build_config(hf_config.to_dict() if isinstance(hf_config, ConfigNode)
                                 else dict(hf_config))
            self._init_params = self.model_spec.module.init(
                self.model_cfg, self.rng.next_key(), dtype=dtype)
        logger.info("model %s: %d parameters", self.model_spec.name,
                    count_params(self._init_params))

    def _backfill_indexers(self, dtype: torch.dtype) -> None:
        """V3-style checkpoints predate DSA: a stack read without indexer
        weights gets fresh ones from the recipe's generator (JAX recipe)."""
        from automodel_tpu_torch.models.llm.mla import init_indexer

        for key in ("dense_layers", "moe_layers", "layers"):
            stack = self._init_params.get(key)
            if stack is not None and "indexer" not in stack:
                logger.warning(
                    "checkpoint carries no compatible DSA indexer weights for %s: "
                    "initializing fresh (top-k selection starts untrained)", key)
                L = stack["input_norm"]["scale"].shape[0]
                stack["indexer"] = init_indexer(self.model_cfg, self.rng.next_key(), L,
                                                dtype=dtype)

    def _moe_overrides(self, cfg, mcfg):
        """A MoE config with the recipe's `model.fake_balanced_gate` and
        `model.moe_dispatcher` applied (JAX recipe, the benchmark's
        balanced gate); sets `is_moe`."""
        self.is_moe = getattr(cfg, "moe", None) is not None
        if not self.is_moe:
            return cfg
        over = {}
        if mcfg.get("fake_balanced_gate", False):
            over["fake_balanced_gate"] = True
        if mcfg.get("moe_dispatcher"):
            over["dispatcher"] = mcfg.get("moe_dispatcher")
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))

    def _build_peft(self) -> None:
        """The `peft` section (JAX recipe): the adapters from the recipe's
        generator become the trainable tree; the base, int8 for QLoRA, stays
        frozen in `base_params`, outside the optimizer, the gradients and
        the checkpoint, which then holds the adapters and their optimizer
        state alone. A resume rebuilds the base from `pretrained_path` or
        the seed, as here, before the checkpoint fills the adapters."""
        self.peft_cfg = self.typed.peft
        self.base_params = None
        if self.peft_cfg is None:
            return
        if self.is_moe and self.model_cfg.moe.gate_bias_update_speed > 0:
            raise NotImplementedError(
                "peft with the DeepSeek gate-bias update: the correction bias "
                "lives in the frozen base, which no step updates")
        if getattr(self.model_cfg, "mtp_num_layers", 0) > 0:
            raise NotImplementedError("peft with the MTP head is not ported")
        lora = init_lora(self._init_params, self.peft_cfg, self.rng.next_key())
        base = quantize_base(self._init_params, self.peft_cfg)
        if self.peft_cfg.quantize_base:
            logger.info("QLoRA: base weights stored %s", self.peft_cfg.quantize_base)
        for p in tree_leaves(base):
            p.requires_grad_(False)
        self.base_params = base
        self._init_params = lora
        logger.info("LoRA enabled: %d trainable adapter params", count_params(lora))

    def _layouts(self, params, under: tuple = ()) -> dict:
        """Each leaf's `Layout` from the module's `param_specs` (the subtree
        at path `under`) and the rule table, with the divisibility fallback
        on the real shapes; a QLoRA `{"q8", "sc"}` leaf lays out both parts
        like its kernel."""
        module = self.model_spec.module
        if not hasattr(module, "param_specs"):
            raise NotImplementedError(
                f"{self.model_spec.name} on a mesh: its module has no param_specs")
        specs = module.param_specs(self.model_cfg)
        for k in under:
            specs = specs[k]

        def walk(spec, leaf):
            if isinstance(spec, dict):
                return {k: walk(spec[k], leaf[k]) for k in leaf}
            if isinstance(leaf, dict):  # QLoRA
                return {k: walk(spec, v) for k, v in leaf.items()}
            return logical_to_shardings(spec, self.mesh_ctx, shapes=tuple(leaf.shape))

        return walk(specs, params)

    def _place_leaf(self, path: tuple, full: torch.Tensor):
        """One leaf read from a checkpoint, as this rank's DTensor block."""
        layout = self._layouts({path[-1]: full}, path[:-1])[path[-1]]
        return distribute_params(full, layout, self.mesh_ctx)

    def _distribute(self) -> None:
        """On a mesh, the params (under PEFT the base and the adapters) as
        DTensors on their layouts; every rank built the same full tree
        from the same seed (or read the same checkpoint) and keeps its
        block. Leaves placed as they were read stay as they are."""
        if self.mesh_ctx is None:
            return
        if self.peft_cfg is None:
            self._init_params = distribute_params(
                self._init_params, self._layouts(self._init_params), self.mesh_ctx)
            return
        base_layouts = self._layouts(self.base_params)
        self.base_params = distribute_params(self.base_params, base_layouts, self.mesh_ctx)
        self._init_params = distribute_params(
            self._init_params, lora_param_shardings(self._init_params, base_layouts),
            self.mesh_ctx)

    def _build_optimizer(self) -> None:
        opt_cfg = self.typed.optimizer
        self.lr_schedule = self.typed.lr_scheduler.build(opt_cfg.lr)
        self.tx = opt_cfg.build(self.lr_schedule)
        self.train_state = init_train_state(self._init_params, self.tx)
        del self._init_params
        step_cfg = TrainStepConfig(
            max_grad_norm=self.cfg.get("max_grad_norm", 1.0),
            skip_nonfinite_updates=bool(self.cfg.get("skip_nonfinite_updates", False)),
        )
        qat_cfg = self.typed.qat
        if qat_cfg.enabled and self.peft_cfg is not None:
            # the trainable tree is the adapters (no 'kernel' leaf): the
            # transform would fake-quantize nothing; QLoRA quantizes a base
            raise ValueError(
                "qat.enabled does not compose with peft (the transform only sees "
                "LoRA params); use peft.quantize_base=int8 (QLoRA) for a quantized "
                "base model instead")
        self._loss_fn = self._make_loss_fn()
        self._train_step = make_train_step(
            self._loss_fn, self.tx, self.lr_schedule, step_cfg,
            param_transform=qat_cfg.make_param_transform(), mesh_ctx=self.mesh_ctx)

    def _make_loss_fn(self):
        """`loss_fn(params, microbatch, rng) -> (CE sum, aux)`; under PEFT
        `params` is the adapter tree, merged into the frozen base layer by
        layer inside the decoder and into the head here. With the MTP head,
        the CE sum gains `mtp_loss_coeff` times the head's CE sum (JAX
        recipe): both count against the main CE's label tokens."""
        module = self.model_spec.module
        model_cfg = self.model_cfg
        chunk = int(self.cfg.get("loss.chunk_size", 1024))
        is_moe = self.is_moe
        use_mtp = is_moe and getattr(model_cfg, "mtp_num_layers", 0) > 0
        fwd = self._hidden_forward()

        vocab = self._vocab_parallel()

        def loss_fn(params, batch, rng):
            kw = {k: batch[k] for k in ("positions", "segment_ids") if k in batch}
            full_params = params
            params, hidden, aux, extra = fwd(
                params, batch["input_ids"],
                token_mask=(batch["labels"] != -100) if is_moe else None, **kw)
            kernel = module.head_kernel(params, model_cfg)
            ce_sum, n = fused_linear_cross_entropy(
                hidden, kernel, batch["labels"], chunk_size=chunk,
                logits_soft_cap=model_cfg.logits_soft_cap, **vocab,
            )
            if use_mtp:
                h_mtp = mtp_hidden(full_params, model_cfg, hidden, batch["input_ids"],
                                   kw.get("positions"), kw.get("segment_ids"),
                                   mesh_ctx=self.mesh_ctx)
                mtp_ce, _ = mtp_loss(
                    h_mtp, kernel, batch["labels"], chunk_size=chunk,
                    segment_ids=kw.get("segment_ids"),
                    logits_soft_cap=model_cfg.logits_soft_cap, **vocab,
                )
                ce_sum = ce_sum + model_cfg.mtp_loss_coeff * mtp_ce
            total, n = combine_losses(ce_sum, n, aux)
            return total, {"num_label_tokens": n, **extra}

        return loss_fn

    def _hidden_forward(self):
        return make_hidden_forward(self.model_spec.module, self.model_cfg,
                                   self.peft_cfg, self.base_params, self.mesh_ctx)

    def _vocab_parallel(self) -> dict:
        """The CE's `vocab_group` / `vocab_start` when the head's vocab dim
        is split on `tp` (JAX shards `vocab` there), else nothing."""
        if self.mesh_ctx is None:
            return {}
        from automodel_tpu_torch.parallel.spmd import Spmd

        spmd = Spmd(self.mesh_ctx)
        base = self.base_params if self.peft_cfg is not None else self.train_state.params
        if "lm_head" in base and not self.model_cfg.tie_word_embeddings:
            leaf, dim = base["lm_head"]["kernel"], 1
        else:
            leaf, dim = base["embed"]["embedding"], 0
        leaf = leaf["q8"] if isinstance(leaf, dict) else leaf
        group = spmd.tp_of(leaf, dim)
        if group is None:
            return {}
        return {"vocab_group": group,
                "vocab_start": spmd.tp_rank() * leaf.to_local().shape[dim]}

    def _batch_token_count(self, microbatches: list) -> int:
        """Tokens of one step (for tokens/s and MFU); recipes with other
        batch layouts override."""
        return int(sum(mb["input_ids"].size for mb in microbatches))

    def _build_tokenizer(self):
        """The `tokenizer` section's HF tokenizer (pad defaulting to EOS),
        or None without one."""
        node = self.cfg.get("tokenizer")
        if node is None:
            return None
        from automodel_tpu_torch.models.auto_tokenizer import build_tokenizer

        return build_tokenizer(node.get("pretrained_path"),
                               trust_remote_code=bool(node.get("trust_remote_code", False)))

    def _build_data(self) -> None:
        if self.mesh_ctx is not None:
            div = self.mesh_ctx.batch_size_divisor
            mb = self.typed.dataloader.microbatch_size
            if mb % div != 0:
                raise ValueError(
                    f"dataloader.microbatch_size={mb} must be divisible by "
                    f"dp_replicate*dp_shard*ep={div} (the token-sharding axes of the mesh)")
        self._tokenizer = self._build_tokenizer()
        ds_cfg = self.cfg.get("dataset").instantiate()
        # a dataset whose build takes a tokenizer gets it (JAX recipe: one
        # that takes none builds without it)
        if self._tokenizer is not None and inspect.signature(ds_cfg.build).parameters:
            dataset = ds_cfg.build(self._tokenizer)
        else:
            dataset = ds_cfg.build()
        dl_cfg = self.typed.dataloader
        self.dataloader = dl_cfg.build(dataset)
        ss_cfg = dataclasses.replace(
            self.typed.step_scheduler, grad_acc_steps=dl_cfg.grad_acc_steps)
        self.step_scheduler = StepScheduler(ss_cfg, self.dataloader)
        val_node = self.cfg.get("validation_dataset")
        self.val_dataloader = None
        if val_node is not None:
            self.val_dataloader = dl_cfg.build(val_node.instantiate().build())

    # ------------------------------------------------------------------
    def _rank_slice(self, batch: dict, axis: int) -> dict:
        """This rank's rows of a global numpy batch along `axis`: the batch
        axes (dp_replicate, dp_shard, ep) split it in that order, as JAX's
        `act_batch` rule does; `tp` ranks share their slice."""
        if self.mesh_ctx is None:
            return batch
        n = self.mesh_ctx.batch_size_divisor
        i = self.mesh_ctx.axis_index("batch")
        return {k: np.split(v, n, axis=axis)[i] for k, v in batch.items()}

    def run_step(self, microbatches: list) -> dict:
        """One optimizer step over a list of grad-accum microbatches (numpy
        dicts, as the dataloader yields them: the global batch); returns the
        step's metrics."""
        batch = make_global_batch(self._rank_slice(stack_microbatches(microbatches), 1),
                                  self.device)
        key = self.rng.next_key()
        # the batch upload above and the metric reads after stay outside the
        # guard: inside it, only a sync the step itself makes can trip it
        with sync_guard(self.device, self.resilience_cfg.transfer_guard):
            self.train_state, metrics = self._train_step(self.train_state, batch, key)
        if self.is_moe and self.model_cfg.moe.gate_bias_update_speed > 0:
            # DeepSeek aux-free balancing after the optimizer step
            self.model_spec.module.apply_gate_bias_update(
                local_tree(self.train_state.params), self.model_cfg,
                metrics["tokens_per_expert"])
        return metrics

    def run_train_validation_loop(self) -> None:
        try:
            self._run_train_validation_loop()
        except BaseException:
            # a crashed run must not look FINISHED in a tracker
            for t in self.trackers:
                t.finish(status="FAILED")
            self.trackers = []
            raise
        finally:
            self.gc.close()  # never leave the process's GC off
            self.profiler.close()

    def _run_train_validation_loop(self) -> None:
        t_last = time.perf_counter()
        first_record = True
        if self.rollback is not None:
            # the step-0 snapshot: a NaN on the very first steps is recoverable
            self.rollback.snapshot(self.step_scheduler.step, self.train_state)
        try:
            for microbatches in self.step_scheduler:
                step = self.step_scheduler.step
                # chaos hooks: no-ops unless armed through `resilience.faults`
                if self.fault_injector.check("sigterm", step=step) is not None:
                    self.step_scheduler.sigterm_received = True
                if self.fault_injector.check("nan_grads", step=step) is not None:
                    self._poison_params()
                metrics = self.run_step(microbatches)
                self.profiler.step(step)
                self.gc.step(step)
                loss = float(metrics["loss"])  # waits for the step
                nonfinite = (not np.isfinite(loss)
                             or float(metrics.get("skipped_nonfinite", 0.0)) > 0)
                if self._maybe_rollback(step, loss, nonfinite):
                    t_last = time.perf_counter()
                    if self.step_scheduler.sigterm_received:
                        self._finish_preempted(step)
                        break
                    continue
                self._check_nonfinite_cap(step, nonfinite)
                now = time.perf_counter()
                perf = self.mfu.metrics(self._batch_token_count(microbatches),
                                        now - t_last)
                t_last = now
                record = {
                    "step": step,
                    "epoch": self.step_scheduler.epoch,
                    "loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": metrics.get("lr", 0.0),
                    "num_label_tokens": float(metrics["num_label_tokens"]),
                    **{k: (None if v is None else round(v, 4)) for k, v in perf.items()},
                }
                if "tokens_per_expert" in metrics and metrics["tokens_per_expert"].numel():
                    tpe = metrics["tokens_per_expert"]
                    record["moe_load_imbalance"] = float(
                        tpe.amax(-1).mean() / torch.clamp(tpe.mean(), min=1e-9))
                if "skipped_nonfinite" in metrics:
                    record["skipped_nonfinite"] = float(metrics["skipped_nonfinite"])
                for k, v in metrics.items():  # a loss's other scalar sums
                    if k not in record and torch.is_tensor(v) and v.dim() == 0:
                        record[k] = float(v)
                if first_record and self._time_to_resume_s is not None:
                    record["time_to_resume_s"] = self._time_to_resume_s
                first_record = False
                if not np.isfinite(loss):
                    logger.warning("step %d: non-finite loss %s", step, loss)
                self.metric_logger.log(record)
                for t in self.trackers:
                    t.log({k: v for k, v in record.items() if k not in ("step", "ts")},
                          step=step)
                if (self.rollback is not None and not nonfinite
                        and self.rollback.due(step)):
                    self.rollback.snapshot(step, self.train_state)
                if self.step_scheduler.is_val_step and self.val_dataloader is not None:
                    self._run_validation(step)
                if self.step_scheduler.sigterm_received:
                    self._finish_preempted(step)
                    break
                if self.step_scheduler.is_ckpt_step:
                    self.save_checkpoint(step)

            if self.step_scheduler.sigterm_received:
                if not self._preempt_finished:
                    # the signal landed after the last in-loop check (during
                    # the final step or its cadenced save)
                    self._finish_preempted(self.step_scheduler.step)
                # preempted: no further unbounded finalization (a re-save,
                # wait or export would block past the grace window)
                return
            if self.checkpointer is not None:
                self.save_checkpoint(self.step_scheduler.step)
                self.checkpointer.wait()
                self.checkpointer.close()
            if self.cfg.get("checkpoint.save_consolidated", False):
                self.save_consolidated_hf()
            for t in self.trackers:
                t.finish()
            self.trackers = []
        finally:
            self.metric_logger.close()
            self.val_logger.close()

    def _finish_preempted(self, step: int) -> None:
        """SIGTERM: a forced save, then a wait for its commit bounded by
        what is left of the grace window, then the `emergency_checkpoint`
        record."""
        self._preempt_finished = True
        t0 = time.perf_counter()
        saved = self.save_checkpoint(step)
        committed = True
        if self.checkpointer is not None:
            committed = wait_with_deadline(
                self.checkpointer, self.step_scheduler.grace_remaining(
                    float(self.resilience_cfg.sigterm_grace_s)))
            if committed:  # else the write still reads the snapshot buffers
                self.checkpointer.close()
        self.metric_logger.log({
            "step": step, "event": "emergency_checkpoint", "saved": bool(saved),
            "committed": bool(committed),
            "seconds": round(time.perf_counter() - t0, 3),
        })
        if not committed:
            logger.error(
                "emergency checkpoint at step %d NOT committed within the grace "
                "window; resume will fall back to step %s", step,
                self.checkpointer.latest_step() if self.checkpointer else None)
        logger.info("SIGTERM received: checkpointed and exiting")
        for t in self.trackers:
            t.finish(status="KILLED")
        self.trackers = []

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _run_validation(self, step: int) -> None:
        """The token-weighted CE over the whole `validation_dataset`, plus
        the sampling eval's metrics, as one `validation.jsonl` record."""
        total = torch.zeros(2, dtype=torch.float64)
        for mb in self.val_dataloader:
            loss_sum, aux = self._loss_fn(
                self.train_state.params,
                make_global_batch(self._rank_slice(mb, 0), self.device), None)
            total += torch.tensor([float(loss_sum), float(aux["num_label_tokens"])],
                                  dtype=torch.float64)
        if self.mesh_ctx is not None:
            total = total.to(self.device)
            torch.distributed.all_reduce(total, group=self.mesh_ctx.group("batch"))
            total = total.cpu()
        rec = {"step": step, "val_loss": float(total[0]) / max(float(total[1]), 1.0)}
        rec.update(self._run_sampling_eval())
        self.val_logger.log(rec)

    def _run_sampling_eval(self) -> dict:
        """`validation_generation: {prompt_len, max_new_tokens, max_batches,
        eos_token_id}`: greedy continuations of the val batches' prompts
        scored against the corpus (`eval/sampling.py`). The val loader's
        position is put back after the sweep, so the next val-loss pass
        sees the same data."""
        node = self.cfg.get("validation_generation")
        if node is None or self.val_dataloader is None:
            return {}
        from automodel_tpu_torch.eval.sampling import run_sampling_eval

        params, base = self.train_state.params, self.base_params
        if self.mesh_ctx is not None:
            # generate() runs whole on every rank: the params gathered
            params, base = full_tree(params), full_tree(base)
        if self.peft_cfg is not None:
            # straight into the compute dtype that generate() casts to
            params = merge_lora(base, params, self.peft_cfg, dtype=self.model_cfg.dtype)
        dl_state = self.val_dataloader.state_dict()
        try:
            return run_sampling_eval(
                params, self.model_cfg, iter(self.val_dataloader),
                prompt_len=int(node.get("prompt_len", 16)),
                max_new_tokens=int(node.get("max_new_tokens", 32)),
                max_batches=int(node.get("max_batches", 4)),
                eos_token_id=node.get("eos_token_id"),
                tokenizer=self._tokenizer,
                seed=int(self.cfg.get("seed", 42)),
            )
        finally:
            self.val_dataloader.load_state_dict(dl_state)

    def save_consolidated_hf(self, out_dir: str | None = None) -> str:
        """The consolidated HF safetensors export of the params (the fp32
        masters; under PEFT the base merged with the adapters,
        `merged_state_dict`), with the model's config.json, to
        `<checkpoint_dir>/hf` by default: what `llm_serve` reads."""
        out_dir = out_dir or os.path.join(
            self.cfg.get("checkpoint.checkpoint_dir", "checkpoints"), "hf")
        adapter = get_adapter(self.model_spec.adapter_name, self.model_cfg,
                              **self.model_spec.adapter_kwargs)
        params, base = self.train_state.params, self.base_params
        if self.mesh_ctx is not None:
            # gathered leaf by leaf into rank 0's host memory; rank 0 writes
            with torch.no_grad():
                params = full_tree(params, to_cpu_on_rank0=True)
                base = full_tree(base, to_cpu_on_rank0=True)
            if not is_main_process():
                torch.distributed.barrier()
                return out_dir
        if self.peft_cfg is not None:
            params = merged_state_dict(base, params, self.peft_cfg)
        with torch.no_grad():
            save_hf_checkpoint(adapter.to_hf(params), out_dir, hf_config=self._hf_config,
                               retry_policy=self._retry_policy,
                               on_retry=self._on_retry_attempt)
        logger.info("consolidated HF checkpoint written to %s", out_dir)
        if self.mesh_ctx is not None:
            torch.distributed.barrier()
        return out_dir


def main(argv=None) -> TrainFinetuneRecipeForNextTokenPrediction:
    cfg = parse_args_and_load_config(argv)
    recipe = TrainFinetuneRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    recipe.run_train_validation_loop()
    return recipe
