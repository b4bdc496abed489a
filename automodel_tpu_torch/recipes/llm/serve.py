"""Offline serving recipe: continuous-batching paged-KV generation to JSONL
(port of the single-replica offline branch of
`automodel_tpu/recipes/llm/serve.py`).

    python -m automodel_tpu_torch examples/llm_serve/llama_serve_smoke.yaml \
        --model.pretrained_path=/path/to/hf_checkpoint

Builds the model (from the HF checkpoint at `model.pretrained_path`, or
random weights from the recipe's seed), feeds the dataset's prompts through
`ServingEngine.serve_batch` as a ragged request stream with staggered
arrivals, writes one `generations.jsonl` record per request and counters to
`serving.jsonl`, and prints the `serving_decode` summary line.

Unlike the JAX recipe it builds no optimizer or train state: the params are
made once, in the model's dtype, on the device (an 8B model's fp32 masters
and AdamW moments would not fit beside it on one card). The values are the
JAX recipe's, which loads fp32 and casts in the engine. With a
`tokenizer` section, prompts lose their trailing pad ids and each record
carries the decoded `text`. The replicated, sharded, disaggregated,
online and speculative modes raise NotImplementedError
(`RecipeConfig.refuse_unported_serving`).

`serving.observability` runs as in the JAX recipe: the engine records its
spans, lifecycle instants and counters, and at the end of the run the
recipe writes the Perfetto and JSONL trace (`trace_path`, by default
`<run_dir>/serve`), `<run_dir>/metrics.prom` and the `latency_attribution`
record (its TTFT phases sum to the median TTFT), which also joins the
summary's stats. `profile_window` / `itl_spike_ms` with `profile_dir`
capture a `torch.profiler` trace of those steps. The top-level
`resilience` section is set up as in training, so its `faults` (the
`serve_step` and `serve_step_run` points among them) fire in the engine.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os

import numpy as np

from automodel_tpu_torch.config import parse_args_and_load_config
from automodel_tpu_torch.distributed import refuse_unported_axes
from automodel_tpu_torch.loggers.metric_logger import MetricLogger, setup_logging
from automodel_tpu_torch.observability import attribution_summary
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.serving import Request, ServingConfig, ServingEngine
from automodel_tpu_torch.training.rng import StatefulRNG

logger = logging.getLogger(__name__)


class ServeRecipe(TrainFinetuneRecipeForNextTokenPrediction):
    """The train chassis' model build and dataloader, then one
    continuous-batching serve. `device=None` means CUDA."""

    def setup(self) -> None:
        cfg = self.cfg
        cfg.set("checkpoint.enabled", False)
        cfg.set("auto_resume", False)
        setup_logging()
        self.typed.refuse_unported_serving()
        self._one_device()
        self.rng = StatefulRNG(seed=int(cfg.get("seed", 42)), device=self.device)
        self._setup_resilience()
        self._build_model(None)
        self.params = self._init_params
        del self._init_params
        self._build_data()

    def _one_device(self) -> None:
        """The engine serves on one device (a sharded serve step is ROADMAP.md
        item 13): the `distributed` sizes must resolve to 1."""
        mesh = self.typed.mesh
        refuse_unported_axes(dataclasses.asdict(mesh))
        mesh.resolve(1)

    def _requests(self, serving, serve_cfg: ServingConfig) -> list:
        """Dataset rows -> a ragged Request stream with staggered arrivals.
        Prompts are clamped to what the engine can hold
        (`pages_per_slot * page_size - max_new_tokens`)."""
        max_requests = int(self.cfg.get("max_requests", 64))
        stride = int(serving.get("arrival_stride", 2)) if serving else 2
        max_new = int(serving.get("max_new_tokens", 64)) if serving else 64
        temp = float(serving.get("temperature", 0.0)) if serving else 0.0
        eos = serving.get("eos_token_id") if serving else None
        cap = serve_cfg.pages_per_slot * serve_cfg.page_size - max_new
        if cap < 1:
            raise ValueError(
                f"serving.max_new_tokens={max_new} leaves no room for a "
                f"prompt (max context = {cap + max_new} tokens)")
        max_prompt = serving.get("max_prompt_len") if serving else None
        max_prompt = min(int(max_prompt), cap) if max_prompt else cap
        # with a tokenizer, a row's trailing pad ids are not prompt
        pad_id = getattr(self._tokenizer, "pad_token_id", None)
        reqs = []
        for mb in self.dataloader:
            ids = np.asarray(mb["input_ids"])
            for row in ids.reshape(-1, ids.shape[-1]):
                toks = [int(t) for t in row]
                if pad_id is not None:
                    while len(toks) > 1 and toks[-1] == pad_id:
                        toks.pop()
                reqs.append(Request(
                    prompt=toks[:max_prompt],
                    max_new_tokens=max_new, temperature=temp,
                    eos_token_id=eos, seed=len(reqs),
                    arrival=len(reqs) // max(stride, 1),
                ))
                if len(reqs) >= max_requests:
                    return reqs
        return reqs

    def serving_config(self) -> ServingConfig:
        node = self.cfg.get("serving")
        get = (lambda k, d: node.get(k, d)) if node is not None else (lambda k, d: d)
        return ServingConfig(
            page_size=int(get("page_size", 16)),
            num_pages=int(get("num_pages", 2048)),
            max_slots=int(get("max_slots", 16)),
            pages_per_slot=int(get("pages_per_slot", 64)),
            token_budget=int(get("token_budget", 64)),
            prefill_chunk=int(get("prefill_chunk", 0)) or None,
            top_k=int(get("top_k", 0)) or None,
            top_p=float(get("top_p", 0.0)) or None,
            prefix_cache=self.typed.serving_prefix_cache,
            admission_policy=str(get("admission_policy", "fifo")),
            kv_cache_dtype=get("kv_cache_dtype", None) or None,
            serve_precision=get("serve_precision", None) or None,
            observability=self.typed.serving_observability,
        )

    def run_train_validation_loop(self) -> dict:
        """Serve the dataset's requests; returns `serve_batch`'s result."""
        cfg = self.cfg
        run_dir = cfg.get("run_dir", ".")
        serve_cfg = self.serving_config()
        reqs = self._requests(cfg.get("serving"), serve_cfg)
        logger.info("serving %d requests (%s)", len(reqs), serve_cfg)
        self.engine = ServingEngine(self.params, self.model_cfg, serve_cfg,
                                    device=self.device)
        serve_logger = MetricLogger(os.path.join(run_dir, "serving.jsonl"))
        try:
            res = self.engine.serve_batch(reqs, metric_logger=serve_logger, log_every=16)
            obs = self.engine.obs
            if obs.enabled:
                # end-of-run exports: the Perfetto/JSONL trace, the Prometheus
                # snapshot and the TTFT/ITL attribution block
                paths = obs.export(obs.cfg.trace_path or os.path.join(run_dir, "serve"))
                attr = attribution_summary(list(obs.tracer.events))
                res["stats"]["latency_attribution"] = attr
                prom_path = os.path.join(run_dir, "metrics.prom")
                with open(prom_path, "w") as f:
                    f.write(obs.registry.snapshot_prometheus())
                serve_logger.log({
                    "metric": "latency_attribution", **attr,
                    "trace_paths": paths, "prometheus": prom_path,
                })
                obs.close()
        finally:
            serve_logger.close()
        out_path = os.path.join(run_dir, "generations.jsonl")
        with open(out_path, "w") as f:
            for req in res["requests"]:
                rec = {
                    "rid": req.rid,
                    "prompt_ids": list(req.prompt),
                    "generated_ids": list(req.generated),
                    "finish_reason": req.finish_reason,
                    "preemptions": req.preemptions,
                }
                if self._tokenizer is not None:
                    rec["text"] = self._tokenizer.decode(rec["generated_ids"])
                f.write(json.dumps(rec) + "\n")
        print(json.dumps({"metric": "serving_decode", **res["stats"]}))
        logger.info("wrote %d generations to %s", len(res["requests"]), out_path)
        return res


def main(argv=None) -> ServeRecipe:
    cfg = parse_args_and_load_config(argv)
    recipe = ServeRecipe(cfg)
    recipe.setup()
    recipe.run_train_validation_loop()
    return recipe
