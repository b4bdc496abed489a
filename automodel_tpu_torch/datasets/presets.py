"""Named instruct-dataset presets, SQuAD and HellaSwag (port of
`automodel_tpu/datasets/presets.py`): row normalizers in front of the
column-mapped SFT dataset, so a YAML reads

    dataset:
      _target_: automodel_tpu.datasets.presets.SquadDatasetConfig
      path_or_dataset: squad/train.json      # local json/jsonl or HF dir
      seq_len: 1024

Rows become context / question / answer before the shared tokenize-and-mask
path (answer-only loss).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from automodel_tpu_torch.datasets.column_mapped import (
    ColumnMappedTextInstructionDataset,
    ColumnMappedTextInstructionDatasetConfig,
)


class _TransformedDataset(ColumnMappedTextInstructionDataset):
    """A column-mapped dataset whose rows pass through a normalizer first."""

    def __init__(self, config, tokenizer, normalize):
        super().__init__(config, tokenizer)
        self._normalize = normalize

    def _fields(self, row: Mapping) -> tuple[str, str]:
        return super()._fields(self._normalize(row))


def _squad_normalize(row: Mapping) -> dict:
    """SQuAD rows: answers as {'text': [...]} (HF flat), a list of
    {'text': ...} (the official qas), or a string."""
    ans: Any = row.get("answers", row.get("answer", ""))
    if isinstance(ans, Mapping):
        texts = ans.get("text", [])
        ans = texts[0] if texts else ""
    elif isinstance(ans, (list, tuple)):
        ans = ans[0] if ans else ""
        if isinstance(ans, Mapping):
            ans = ans.get("text", "")
    return {
        "context": row.get("context", ""),
        "question": row.get("question", ""),
        "answer": str(ans),
    }


def _hellaswag_normalize(row: Mapping) -> dict:
    """HellaSwag rows: ctx, and the ending at `label` as the answer."""
    endings = row.get("endings", [])
    label = int(row.get("label", 0) or 0)
    ending = endings[label] if 0 <= label < len(endings) else ""
    return {
        "context": str(row.get("ctx", row.get("context", ""))),
        "question": "",
        "answer": " " + str(ending) if ending else "",
    }


def _flatten_squad_articles(rows) -> list:
    """The official SQuAD JSON nests articles -> paragraphs -> qas: one row
    per question. Flat rows pass."""
    if not rows or "paragraphs" not in rows[0]:
        return list(rows)
    flat = []
    for article in rows:
        for para in article.get("paragraphs", []):
            for qa in para.get("qas", []):
                flat.append({
                    "context": para.get("context", ""),
                    "question": qa.get("question", ""),
                    "answers": qa.get("answers", []),
                })
    return flat


@dataclasses.dataclass
class SquadDatasetConfig(ColumnMappedTextInstructionDatasetConfig):
    prompt_template: str = "Context: {context}\nQuestion: {question}\nAnswer:"

    def build(self, tokenizer) -> ColumnMappedTextInstructionDataset:
        ds = _TransformedDataset(self, tokenizer, _squad_normalize)
        ds.rows = _flatten_squad_articles(ds.rows)
        return ds


@dataclasses.dataclass
class HellaSwagDatasetConfig(ColumnMappedTextInstructionDatasetConfig):
    prompt_template: str = "{context}"

    def build(self, tokenizer) -> ColumnMappedTextInstructionDataset:
        return _TransformedDataset(self, tokenizer, _hellaswag_normalize)
