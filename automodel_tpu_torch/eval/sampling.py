"""Validation-time sampling eval: greedy continuations of prompts, scored
against the corpus (port of `automodel_tpu/eval/sampling.py`).

Metrics:
- gen_token_accuracy: greedy continuation tokens equal to the reference
  continuation, over supervised positions;
- gen_prefix_len: the mean exact-match prefix length (over supervised
  positions);
- gen_samples: the number of sequences scored;
- with a `tokenizer`, where the decoded reference continuations carry
  `<tool_call>` blocks: `tool_num_examples` and the name, exact and fuzzy
  tool-call accuracies of the decoded predictions
  (`eval/tool_call_evaluator`).

The port runs one process, so there is no all-gather across hosts.
"""

from __future__ import annotations

import numpy as np
import torch

from automodel_tpu_torch.eval.tool_call_evaluator import evaluate_tool_calls, parse_tool_calls
from automodel_tpu_torch.inference.generate import GenerateConfig, generate

IGNORE_INDEX = -100


def run_sampling_eval(
    params,
    model_cfg,
    batches,                  # iterable of {"input_ids", "labels", ...} (numpy)
    *,
    prompt_len: int = 16,
    max_new_tokens: int = 32,
    max_batches: int = 4,
    eos_token_id: int | None = None,
    tokenizer=None,
    seed: int = 0,
) -> dict:
    """Greedy-generate from each batch's first `prompt_len` tokens (on the
    params' device) and score the continuation against the batch's own
    next tokens. Returns a flat dict of scalar metrics."""
    device = params["embed"]["embedding"].device
    gen = GenerateConfig(max_new_tokens=max_new_tokens, eos_token_id=eos_token_id)
    tok_hits = tok_total = 0.0
    prefix_sum = prefix_n = 0.0
    preds_text: list[str] = []
    refs_text: list[str] = []
    for bi, mb in enumerate(batches):
        if bi >= max_batches:
            break
        ids = np.asarray(mb["input_ids"])
        if ids.shape[1] <= prompt_len:
            continue
        prompts = torch.from_numpy(np.ascontiguousarray(ids[:, :prompt_len])).to(device)
        rng = torch.Generator(device=device).manual_seed(seed + bi)
        out = generate(params, model_cfg, prompts, rng, gen).cpu().numpy()
        n_ref = min(max_new_tokens, ids.shape[1] - prompt_len)
        cont = out[:, prompt_len:prompt_len + n_ref]
        ref = ids[:, prompt_len:prompt_len + n_ref]
        # labels are pre-shifted (labels[t] supervises ids[t+1]): the token
        # at absolute position p carries supervision flag labels[p-1]
        labels = np.asarray(mb["labels"])[:, prompt_len - 1:prompt_len - 1 + n_ref]
        valid = labels != IGNORE_INDEX
        hit = (cont == ref) & valid
        tok_hits += float(hit.sum())
        tok_total += float(valid.sum())
        # exact-match prefix length per sample (over valid positions)
        miss = (~hit) & valid
        first_miss = np.where(miss.any(axis=1), miss.argmax(axis=1), valid.sum(axis=1))
        prefix_sum += float(first_miss.sum())
        prefix_n += float(len(first_miss))
        if tokenizer is not None:
            for row_pred, row_ref, row_valid in zip(cont, ref, valid):
                preds_text.append(tokenizer.decode(
                    [int(t) for t, v in zip(row_pred, row_valid) if v]))
                refs_text.append(tokenizer.decode(
                    [int(t) for t, v in zip(row_ref, row_valid) if v]))
    metrics = {
        "gen_token_accuracy": tok_hits / max(tok_total, 1.0),
        "gen_prefix_len": prefix_sum / max(prefix_n, 1.0),
        "gen_samples": prefix_n,
    }
    if tokenizer is not None and refs_text:
        ref_calls = [parse_tool_calls(t) for t in refs_text]
        if any(ref_calls):
            tc = evaluate_tool_calls(preds_text, ref_calls)
            metrics.update({f"tool_{k}": v for k, v in tc.items()})
    return metrics
