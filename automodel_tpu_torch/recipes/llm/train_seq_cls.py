"""Sequence-classification finetune recipe (port of
`automodel_tpu/recipes/llm/train_seq_cls.py`).

The decoder runs with `return_hidden`; the hidden state of each row's last
real token feeds a classification head, the HF `*ForSequenceClassification`
convention. The head's kernel, `score_head`, lives beside the backbone in
the train state (beside the adapters under PEFT), so checkpoints and PEFT
work unchanged. The loss is the CE over the labels, summed, with the rows
as its count; `num_correct` joins each step's record.

YAML adds:

    seq_cls: {num_labels: 4}
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.loss.utils import combine_losses
from automodel_tpu_torch.models.common.layers import dense_init
from automodel_tpu_torch.recipes.llm.train_ft import TrainFinetuneRecipeForNextTokenPrediction


def last_token_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, S, H) -> (B, H): each row's last token with mask 1 (its first
    token where a row has none)."""
    last = torch.clamp(mask.sum(-1) - 1, min=0)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]


class TrainSeqClsRecipe(TrainFinetuneRecipeForNextTokenPrediction):
    def _build_peft(self) -> None:
        super()._build_peft()
        self.num_labels = int(self.cfg.get("seq_cls.num_labels", 2))
        head = dense_init(self.rng.next_key(), (self.model_cfg.hidden_size, self.num_labels))
        self._init_params = {**self._init_params, "score_head": {"kernel": head}}

    def _make_loss_fn(self):
        fwd = self._hidden_forward()

        def loss_fn(params, batch, rng):
            backbone = {k: v for k, v in params.items() if k != "score_head"}
            ids = batch["input_ids"]
            mask = batch.get("attention_mask")
            if mask is None:
                mask = torch.ones_like(ids)
            _, hidden, aux, extra = fwd(backbone, ids, token_mask=mask.bool())
            pooled = last_token_pool(hidden, mask)
            logits = (pooled @ params["score_head"]["kernel"].to(pooled.dtype)).float()
            labels = batch["label"].long()
            picked = logits.gather(-1, labels[:, None])[:, 0]
            loss_sum = torch.sum(torch.logsumexp(logits, dim=-1) - picked)
            correct = torch.sum((logits.argmax(-1) == labels).float())
            total, n = combine_losses(
                loss_sum, torch.tensor(float(labels.shape[0]), device=logits.device), aux)
            return total, {"num_label_tokens": n, "num_correct": correct, **extra}

        return loss_fn
