from automodel_tpu_torch.config.loader import (
    ALLOWED_IMPORT_PREFIXES,
    ConfigError,
    ConfigNode,
    instantiate,
    load_yaml,
)
from automodel_tpu_torch.config.arg_parser import (
    apply_overrides,
    parse_args_and_load_config,
    parse_override,
)

__all__ = [
    "ALLOWED_IMPORT_PREFIXES",
    "ConfigError",
    "ConfigNode",
    "instantiate",
    "load_yaml",
    "apply_overrides",
    "parse_args_and_load_config",
    "parse_override",
]
