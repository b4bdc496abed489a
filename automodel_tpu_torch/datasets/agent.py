"""Agent / tool-call SFT dataset, xlam-style function calling (port of
`automodel_tpu/datasets/agent.py`).

Normalization:
- ShareGPT `{from, value}` turns map onto chatml roles (human -> user,
  gpt -> assistant, function_call -> tool_call, observation -> tool).
- Consecutive `tool_call` turns merge into one assistant message whose
  content holds the calls as `<tool_call>{json}</tool_call>` blocks, the
  format `eval/tool_call_evaluator.parse_tool_calls` reads.
- `tool_response` / `tool` turns become role "tool" (never supervised).
- A `tools` column (the available functions' schemas) goes into a system
  message.

Tokenization and assistant-only masking are `ChatDataset`'s.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from automodel_tpu_torch.datasets.chat import ChatDataset, ChatDatasetConfig

_SHAREGPT_ROLE_MAP = {
    "system": "system",
    "human": "user",
    "user": "user",
    "gpt": "assistant",
    "assistant": "assistant",
    "function_call": "tool_call",
    "tool_call": "tool_call",
    "observation": "tool",
    "tool_response": "tool",
    "tool": "tool",
}


def _as_chatml(row: dict) -> list[dict]:
    if "messages" in row:
        return list(row["messages"])
    out = []
    for t in row.get("conversations") or []:
        if "role" in t:
            out.append({"role": t["role"], "content": t.get("content", "")})
            continue
        src = t.get("from")
        if src not in _SHAREGPT_ROLE_MAP:
            raise ValueError(f"unsupported sharegpt role {src!r}")
        out.append({"role": _SHAREGPT_ROLE_MAP[src], "content": t.get("value", "")})
    return out


def _fmt_call(content: Any) -> str:
    if isinstance(content, str):
        try:
            content = json.loads(content)
        except json.JSONDecodeError:
            return f"<tool_call>{content}</tool_call>"
    return f"<tool_call>{json.dumps(content, sort_keys=True)}</tool_call>"


def normalize_agent_messages(row: dict, tools_key: str = "tools") -> list[dict]:
    """chatml messages with the tool calls folded into assistant turns."""
    msgs = _as_chatml(row)
    out: list[dict] = []
    tools = row.get(tools_key)
    if tools:
        if not isinstance(tools, str):
            tools = json.dumps(tools, sort_keys=True)
        out.append({"role": "system",
                    "content": "You may call the following tools:\n" + tools})
    for m in msgs:
        role, content = m["role"], m["content"]
        if role == "tool_call":
            block = _fmt_call(content)
            if out and out[-1]["role"] == "assistant":
                # parallel calls (or a reasoning assistant turn) merge
                out[-1] = {"role": "assistant",
                           "content": (out[-1]["content"] + "\n" + block).strip()}
            else:
                out.append({"role": "assistant", "content": block})
        elif role == "tool":
            out.append({"role": "tool", "content": str(content)})
        else:
            out.append({"role": role, "content": content})
    return out


@dataclasses.dataclass
class AgentChatDatasetConfig(ChatDatasetConfig):
    tools_key: str = "tools"

    def build(self, tokenizer) -> "AgentChatDataset":
        return AgentChatDataset(self, tokenizer)


class AgentChatDataset(ChatDataset):
    def __init__(self, config: AgentChatDatasetConfig, tokenizer):
        super().__init__(config, tokenizer)
        self.rows = [{"messages": normalize_agent_messages(r, config.tools_key)}
                     for r in self.rows]
