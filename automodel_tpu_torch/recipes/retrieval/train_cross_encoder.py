"""Cross-encoder (reranker) training: joint query ⊕ document scoring (port
of `automodel_tpu/recipes/retrieval/train_cross_encoder.py`).

Each example is a group of G (query, document) pairs, the positive at slot
0 and negatives after it. The backbone encodes each pair, the last real
token's hidden state feeds a scalar score head (`score_head`, beside the
backbone in the train state), and a listwise softmax CE over the group
pushes the positive above the negatives; `num_correct` counts the groups
whose positive scores highest.

Dataset rows: {"pair_ids": (G, S), "pair_mask": (G, S)}.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.loss.utils import combine_losses
from automodel_tpu_torch.models.common.layers import dense_init
from automodel_tpu_torch.recipes.llm.train_ft import TrainFinetuneRecipeForNextTokenPrediction
from automodel_tpu_torch.recipes.llm.train_seq_cls import last_token_pool


class TrainCrossEncoderRecipe(TrainFinetuneRecipeForNextTokenPrediction):
    def _build_peft(self) -> None:
        super()._build_peft()
        head = dense_init(self.rng.next_key(), (self.model_cfg.hidden_size, 1))
        self._init_params = {**self._init_params, "score_head": {"kernel": head}}

    def _make_loss_fn(self):
        fwd = self._hidden_forward()

        def loss_fn(params, batch, rng):
            ids, mask = batch["pair_ids"], batch["pair_mask"]  # (B, G, S)
            B, G, S = ids.shape
            backbone = {k: v for k, v in params.items() if k != "score_head"}
            flat_mask = mask.reshape(B * G, S)
            _, hidden, aux, extra = fwd(backbone, ids.reshape(B * G, S),
                                        token_mask=flat_mask.bool())
            pooled = last_token_pool(hidden, flat_mask)
            scores = (pooled @ params["score_head"]["kernel"].to(pooled.dtype)
                      ).float().reshape(B, G)
            loss_sum = torch.sum(torch.logsumexp(scores, dim=-1) - scores[:, 0])
            correct = torch.sum((scores.argmax(-1) == 0).float())
            total, n = combine_losses(
                loss_sum, torch.tensor(float(B), device=scores.device), aux)
            return total, {"num_label_tokens": n, "num_correct": correct, **extra}

        return loss_fn

    def _batch_token_count(self, microbatches: list) -> int:
        return int(sum(mb["pair_ids"].size for mb in microbatches))
