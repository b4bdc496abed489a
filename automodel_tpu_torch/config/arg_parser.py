"""CLI argument parsing: ``python -m automodel_tpu_torch <cfg.yaml> [--a.b.c=v ...]``.

A copy of `automodel_tpu/config/arg_parser.py` (host-only Python). The JAX
package's re-design of the reference's dotted CLI overrides
(reference: nemo_automodel/components/config/_arg_parser.py:79
`parse_args_and_load_config`). Values are YAML-parsed so ``--lr=3e-4``
arrives as a float and ``--flags='[1,2]'`` as a list.
"""

from __future__ import annotations

import sys
from typing import Any, Sequence

import yaml

from automodel_tpu_torch.config.loader import ConfigNode, load_yaml


def parse_override(arg: str) -> tuple[str, Any]:
    """Parse ``--a.b.c=value`` (or ``a.b.c=value``) into (dotted_key, value)."""
    arg = arg.lstrip("-")
    if "=" not in arg:
        raise ValueError(f"Override '{arg}' must be of the form key.path=value")
    key, _, raw = arg.partition("=")
    # YAML 1.1 misses "3e-4"-style floats; coerce numerics explicitly first.
    try:
        value: Any = int(raw)
    except ValueError:
        try:
            value = float(raw)
        except ValueError:
            try:
                value = yaml.safe_load(raw)
            except yaml.YAMLError:
                value = raw
    return key, value


def apply_overrides(cfg: ConfigNode, overrides: Sequence[str]) -> ConfigNode:
    for arg in overrides:
        key, value = parse_override(arg)
        cfg.set(key, value)
    return cfg


def parse_args_and_load_config(argv: Sequence[str] | None = None) -> ConfigNode:
    """Load the YAML named by argv[0] and apply the dotted overrides after it."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(
            "usage: python -m automodel_tpu_torch <config.yaml> [--key.path=value ...]"
        )
    cfg_path, overrides = argv[0], argv[1:]
    cfg = load_yaml(cfg_path)
    apply_overrides(cfg, overrides)
    return cfg
