"""Tool-call accuracy for agent SFT (port of
`automodel_tpu/eval/tool_call_evaluator.py`): the JSON tool calls of
generated text against gold calls, by function name and by arguments,
exactly and after normalization (case, whitespace, numbers)."""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any

_CALL_RE = re.compile(
    r"<tool_call>\s*(\{.*?\})\s*</tool_call>|```json\s*(\{.*?\})\s*```",
    re.DOTALL,
)


def parse_tool_calls(text: str) -> list[dict]:
    """The tool-call dicts of generated text: `<tool_call>{...}</tool_call>`
    blocks, ```json fences, or the whole string as a JSON object or array
    of {name, arguments}."""
    calls: list[dict] = []
    for m in _CALL_RE.finditer(text):
        blob = m.group(1) or m.group(2)
        try:
            calls.append(json.loads(blob))
        except json.JSONDecodeError:
            continue
    if not calls:
        try:
            data = json.loads(text.strip())
            if isinstance(data, dict):
                calls = [data]
            elif isinstance(data, list):
                calls = [c for c in data if isinstance(c, dict)]
        except json.JSONDecodeError:
            pass
    return [c for c in map(normalize_call, calls) if c is not None]


def normalize_call(c: dict) -> dict | None:
    """One call dict in canonical form (predictions and gold alike): the
    name's aliases resolved, string arguments JSON-decoded."""
    name = c.get("name") or c.get("function", {}).get("name")
    args = c.get("arguments", c.get("parameters", {}))
    if isinstance(args, str):
        try:
            args = json.loads(args)
        except json.JSONDecodeError:
            args = {"_raw": args}
    if not name:
        return None
    return {"name": name, "arguments": args or {}}


def _norm(v: Any) -> Any:
    if isinstance(v, str):
        s = v.strip().lower()
        try:
            return float(s)
        except ValueError:
            return s
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in sorted(v.items())}
    if isinstance(v, list):
        return [_norm(x) for x in v]
    return v


@dataclasses.dataclass
class ToolCallMetrics:
    num_examples: int = 0
    name_matches: int = 0
    exact_matches: int = 0
    fuzzy_matches: int = 0

    def as_dict(self) -> dict:
        n = max(self.num_examples, 1)
        return {
            "num_examples": self.num_examples,
            "name_accuracy": self.name_matches / n,
            "exact_accuracy": self.exact_matches / n,
            "fuzzy_accuracy": self.fuzzy_matches / n,
        }


def evaluate_tool_calls(predictions: list[str], references: list[list[dict]]) -> dict:
    """Per example, every gold call must be matched (in any order)."""
    if len(predictions) != len(references):
        raise ValueError(f"{len(predictions)} predictions vs {len(references)} references")

    def key_exact(c):
        return (c["name"], json.dumps(c["arguments"], sort_keys=True))

    def key_fuzzy(c):
        return (c["name"], json.dumps(_norm(c["arguments"]), sort_keys=True))

    m = ToolCallMetrics()
    for pred_text, gold in zip(predictions, references):
        m.num_examples += 1
        pred = parse_tool_calls(pred_text)
        gold = [c for c in map(normalize_call, gold) if c is not None]
        if sorted(c["name"] for c in pred) != sorted(c["name"] for c in gold):
            continue
        m.name_matches += 1
        if sorted(map(key_exact, pred)) == sorted(map(key_exact, gold)):
            m.exact_matches += 1
            m.fuzzy_matches += 1
        elif sorted(map(key_fuzzy, pred)) == sorted(map(key_fuzzy, gold)):
            m.fuzzy_matches += 1
    return m.as_dict()
