"""Column-mapped instruction dataset: rows -> tokenized SFT samples (port
of `automodel_tpu/datasets/column_mapped.py`).

The YAML maps dataset columns onto context / question / answer; the prompt
is `prompt_template` over context and question, and with
`answer_only_loss_mask` only the answer tokens (and EOS) carry labels.
Rows come from a local `.json` / `.jsonl`; any other path goes to HF
`datasets.load_dataset(path, split="train")`, imported only then.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Optional

import numpy as np

from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX


@dataclasses.dataclass
class ColumnMappedTextInstructionDatasetConfig:
    path_or_dataset: str = ""
    column_mapping: Optional[dict] = None  # {context: ..., question: ..., answer: ...}
    seq_len: int = 512
    answer_only_loss_mask: bool = True
    prompt_template: str = "{context}\n{question}\n"

    def build(self, tokenizer) -> "ColumnMappedTextInstructionDataset":
        return ColumnMappedTextInstructionDataset(self, tokenizer)


def _load_rows(path: str):
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, list) else data["data"]
    # hub names and dataset directories (an offline cache)
    import datasets as hf_datasets

    return hf_datasets.load_dataset(path, split="train")


class ColumnMappedTextInstructionDataset:
    def __init__(self, config: ColumnMappedTextInstructionDatasetConfig, tokenizer):
        self.config = config
        self.tokenizer = tokenizer
        self.rows = _load_rows(config.path_or_dataset)
        self.mapping = config.column_mapping or {
            "context": "context", "question": "question", "answer": "answer"
        }

    def __len__(self) -> int:
        return len(self.rows)

    def _fields(self, row: Mapping) -> tuple[str, str]:
        parts = {role: str(row.get(col, "")) for role, col in self.mapping.items()}
        answer = parts.pop("answer", "")
        prompt = self.config.prompt_template.format(
            context=parts.get("context", ""), question=parts.get("question", "")
        )
        return prompt, answer

    def __getitem__(self, idx: int) -> dict:
        prompt, answer = self._fields(self.rows[idx])
        tok = self.tokenizer
        prompt_ids = tok(prompt, add_special_tokens=False)["input_ids"]
        answer_ids = tok(answer, add_special_tokens=False)["input_ids"]
        bos = [tok.bos_token_id] if getattr(tok, "bos_token_id", None) is not None else []
        eos = [tok.eos_token_id] if getattr(tok, "eos_token_id", None) is not None else []
        ids = bos + prompt_ids + answer_ids + eos
        labels = list(ids[1:]) + [IGNORE_INDEX]
        if self.config.answer_only_loss_mask:
            n_prompt = len(bos) + len(prompt_ids)
            for i in range(min(n_prompt - 1, len(labels))):
                labels[i] = IGNORE_INDEX

        ids = ids[:self.config.seq_len]
        labels = labels[:self.config.seq_len]
        pad = self.config.seq_len - len(ids)
        pad_id = getattr(tok, "pad_token_id", None)
        pad_id = pad_id if pad_id is not None else 0
        return {
            "input_ids": np.asarray(ids + [pad_id] * pad, np.int32),
            "labels": np.asarray(labels + [IGNORE_INDEX] * pad, np.int32),
        }
