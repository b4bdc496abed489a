"""Chat / agent SFT dataset: messages -> templated tokens with
assistant-only loss masking (port of `automodel_tpu/datasets/chat.py`).

Each row of the jsonl is {"messages": [{"role", "content"}, ...]}. The
conversation is rendered one growing prefix at a time through the
tokenizer's chat template (or the role-tag fallback,
`models/auto_tokenizer.apply_chat_template`), and each message takes the
new tokens: a template's one-time preamble (bos, a system prompt) comes out
once, and the stream equals the rendering of the whole conversation. Where
BPE merges across a message boundary, the ids resynchronize on the common
prefix and the merged tokens take the later message's supervision. Only
assistant tokens (and the EOS after a final assistant turn) carry labels,
unless `train_on_assistant_only` is off.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX
from automodel_tpu_torch.models.auto_tokenizer import apply_chat_template


@dataclasses.dataclass
class ChatDatasetConfig:
    path: str = ""          # jsonl with a "messages" column
    seq_len: int = 1024
    train_on_assistant_only: bool = True

    def build(self, tokenizer) -> "ChatDataset":
        return ChatDataset(self, tokenizer)


class ChatDataset:
    def __init__(self, config: ChatDatasetConfig, tokenizer):
        self.config = config
        self.tokenizer = tokenizer
        with open(config.path) as f:
            self.rows = [json.loads(line) for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> dict:
        c = self.config
        tok = self.tokenizer
        messages = self.rows[idx]["messages"]
        ids: list[int] = []
        labels: list[int] = []
        prev_ids: list[int] = []
        last_supervised = False
        for k, m in enumerate(messages, 1):
            text = apply_chat_template(tok, messages[:k])
            cur_ids = tok(text, add_special_tokens=False)["input_ids"]
            supervise = (not c.train_on_assistant_only) or m["role"] == "assistant"
            last_supervised = supervise
            if cur_ids[:len(prev_ids)] == prev_ids:
                delta = cur_ids[len(prev_ids):]
                ids.extend(delta)
                labels.extend(delta if supervise else [IGNORE_INDEX] * len(delta))
            else:
                # BPE merged across the boundary: resynchronize on the common
                # prefix; the merged tokens take this message's supervision
                common = 0
                for a, b in zip(prev_ids, cur_ids):
                    if a != b:
                        break
                    common += 1
                tail = cur_ids[common:]
                ids = list(cur_ids)
                labels = labels[:common] + (tail if supervise else [IGNORE_INDEX] * len(tail))
            prev_ids = cur_ids
        eos = getattr(tok, "eos_token_id", None)
        if eos is not None:
            ids.append(eos)
            # EOS is taught only after a supervised (assistant) final turn
            labels.append(eos if last_supervised else IGNORE_INDEX)

        labels = labels[1:] + [IGNORE_INDEX]  # next-token shift
        ids = ids[:c.seq_len]
        labels = labels[:c.seq_len]
        pad_id = getattr(tok, "pad_token_id", None) or 0
        pad = c.seq_len - len(ids)
        return {
            "input_ids": np.asarray(ids + [pad_id] * pad, np.int32),
            "labels": np.asarray(labels + [IGNORE_INDEX] * pad, np.int32),
        }
