"""Bi-encoder retrieval training: a shared bidirectional encoder and
in-batch InfoNCE (port of `automodel_tpu/recipes/retrieval/train_bi_encoder.py`).

The backbone is the dense decoder flipped to `causal=False`; queries and
documents share its weights and run as one forward of 2B rows, their pad
tokens apart by segment id (pads 0, real tokens 1), so bidirectional
attention never mixes the two. The embeddings are masked mean pools.

YAML adds:

    retrieval: {temperature: 0.05, symmetric: true}

Dataset rows: {query_ids, doc_ids, query_mask, doc_mask}.
"""

from __future__ import annotations

import dataclasses

import torch

from automodel_tpu_torch.loss.infonce import info_nce_loss, mean_pool
from automodel_tpu_torch.loss.utils import combine_losses
from automodel_tpu_torch.recipes.llm.train_ft import TrainFinetuneRecipeForNextTokenPrediction


class TrainBiEncoderRecipe(TrainFinetuneRecipeForNextTokenPrediction):
    def _build_model(self, param_dtype) -> None:
        super()._build_model(param_dtype)
        if self.model_cfg.causal:
            self.model_cfg = dataclasses.replace(self.model_cfg, causal=False)

    def _make_loss_fn(self):
        temperature = float(self.cfg.get("retrieval.temperature", 0.05))
        symmetric = bool(self.cfg.get("retrieval.symmetric", True))
        fwd = self._hidden_forward()

        def loss_fn(params, batch, rng):
            ids = torch.cat([batch["query_ids"], batch["doc_ids"]], dim=0)
            mask = torch.cat([batch["query_mask"], batch["doc_mask"]], dim=0)
            _, hidden, aux, extra = fwd(params, ids, token_mask=mask.bool(),
                                        segment_ids=mask.to(torch.int32))
            pooled = mean_pool(hidden, mask)
            B = batch["query_ids"].shape[0]
            loss_sum, n = info_nce_loss(pooled[:B], pooled[B:], temperature=temperature,
                                        symmetric=symmetric)
            total, n = combine_losses(loss_sum, n, aux)
            return total, {"num_label_tokens": n, **extra}

        return loss_fn

    def _batch_token_count(self, microbatches: list) -> int:
        return int(sum(mb["query_ids"].size + mb["doc_ids"].size for mb in microbatches))
