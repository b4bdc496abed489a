"""Tokenizer wrapper over HF `AutoTokenizer` (port of
`automodel_tpu/models/auto_tokenizer.py`): the pad token defaults to EOS,
and `apply_chat_template` renders a conversation through the tokenizer's
template, or a role-prefixed fallback when it has none. `transformers` is
imported inside `build_tokenizer`, so the module imports without it.
"""

from __future__ import annotations

import logging
from typing import Any

logger = logging.getLogger(__name__)


def build_tokenizer(
    pretrained_path: str,
    *,
    default_pad_to_eos: bool = True,
    trust_remote_code: bool = False,
    **kwargs: Any,
):
    """An HF tokenizer from a local path (or hub name), its pad token set to
    EOS when it has none."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(
        pretrained_path, trust_remote_code=trust_remote_code, **kwargs
    )
    if tok.pad_token_id is None and default_pad_to_eos and tok.eos_token_id is not None:
        tok.pad_token = tok.eos_token
        logger.info("tokenizer pad_token defaulted to eos (%s)", tok.eos_token)
    return tok


def apply_chat_template(tokenizer, messages: list, add_generation_prompt: bool = False) -> str:
    """The conversation as text: the tokenizer's chat template, or
    `<|role|>\\ncontent\\n` per message when it has none."""
    if getattr(tokenizer, "chat_template", None):
        return tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=add_generation_prompt
        )
    text = "".join(f"<|{m['role']}|>\n{m['content']}\n" for m in messages)
    if add_generation_prompt:
        text += "<|assistant|>\n"
    return text
