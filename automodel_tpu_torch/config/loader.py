"""YAML config tree with Hydra-style ``_target_`` instantiation.

A copy of `automodel_tpu/config/loader.py` (host-only Python) with one
change: a ``_target_`` in the JAX package (``automodel_tpu.x.y``) resolves
to its counterpart in this package (``automodel_tpu_torch.x.y``), so both
packages read the same YAML files, and a target with no counterpart raises
ImportError naming it. Targets in JAX-family packages raise too: the port
never imports JAX.

The JAX package's re-design of the reference config system
(reference: nemo_automodel/components/config/loader.py:332 `ConfigNode`,
:450 `instantiate`, :272 `_resolve_target`, :178 env resolution,
:33 import allowlist). Behavior parity:

- YAML → attribute-accessible node tree with dotted ``get``/``set``.
- ``_target_: pkg.mod.Symbol`` instantiation, recursively instantiating
  child nodes; extra call-site kwargs override YAML ones.
- ``${ENV_VAR}`` / ``${ENV_VAR:default}`` interpolation in string values.
- Import allowlist for ``_target_`` resolution; opt-out via
  ``AUTOMODEL_TPU_ENABLE_USER_MODULES=1``.
- Secret redaction in ``repr``/``to_dict(redact=True)``.
"""

from __future__ import annotations

import importlib
import os
import re
from typing import Any, Callable, Iterator, Mapping

import yaml

# Mirrors the reference's ALLOWED_IMPORT_PREFIXES security posture
# (reference: components/config/loader.py:33-39), plus the port itself.
ALLOWED_IMPORT_PREFIXES = (
    "automodel_tpu",
    "automodel_tpu_torch",
    "jax",
    "flax",
    "optax",
    "orbax",
    "numpy",
    "transformers",
    "datasets",
    "builtins",
    "math",
    "functools",
)
_USER_MODULES_ENV = "AUTOMODEL_TPU_ENABLE_USER_MODULES"
_JAX_PACKAGE = "automodel_tpu"
_PORT_PACKAGE = "automodel_tpu_torch"
_JAX_FAMILY = ("jax", "flax", "optax", "orbax")

_SECRET_PAT = re.compile(r"(key|token|secret|password|credential)", re.IGNORECASE)
_ENV_PAT = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)(?::([^}]*))?\}")


class ConfigError(Exception):
    pass


def _resolve_env(value: str) -> str:
    """Interpolate ``${VAR}`` / ``${VAR:default}`` from the environment."""

    def sub(m: re.Match) -> str:
        var, default = m.group(1), m.group(2)
        if var in os.environ:
            return os.environ[var]
        if default is not None:
            return default
        raise ConfigError(f"Environment variable '{var}' is not set and has no default")

    return _ENV_PAT.sub(sub, value)


def _port_path(path: str) -> str:
    """The port's name of a target: ``automodel_tpu.*`` -> ``automodel_tpu_torch.*``."""
    if path == _JAX_PACKAGE or path.startswith(_JAX_PACKAGE + "."):
        return _PORT_PACKAGE + path[len(_JAX_PACKAGE):]
    return path


def _resolve_target(path: str) -> Any:
    """Import ``pkg.mod.Symbol`` with the allowlist applied, the JAX
    package's names mapped to the port's."""
    if os.environ.get(_USER_MODULES_ENV, "0") not in ("1", "true", "True"):
        if not any(path == p or path.startswith(p + ".") for p in ALLOWED_IMPORT_PREFIXES):
            raise ConfigError(
                f"_target_ '{path}' is outside the allowed import prefixes "
                f"{ALLOWED_IMPORT_PREFIXES}; set {_USER_MODULES_ENV}=1 to allow user modules"
            )
    if any(path == p or path.startswith(p + ".") for p in _JAX_FAMILY):
        raise ImportError(f"_target_ '{path}' is a JAX-family symbol; the port does not import JAX")
    ported = _port_path(path)
    module_path, _, attr = ported.rpartition(".")
    if not module_path:
        raise ConfigError(f"_target_ '{path}' must be a dotted path")
    # Walk from the longest importable module prefix so nested attributes
    # ("pkg.mod.Class.method") resolve too.
    parts = ported.split(".")
    for split in range(len(parts) - 1, 0, -1):
        mod_name = ".".join(parts[:split])
        try:
            obj: Any = importlib.import_module(mod_name)
        except ImportError:
            continue
        try:
            for attr_name in parts[split:]:
                obj = getattr(obj, attr_name)
        except AttributeError:
            continue
        return obj
    if ported != path:
        raise ImportError(
            f"_target_ '{path}' has no counterpart in {_PORT_PACKAGE} "
            f"(looked for '{ported}')"
        )
    raise ConfigError(f"Could not resolve _target_ '{path}'")


class ConfigNode:
    """Attribute-accessible config tree node.

    Wraps a dict; child mappings are wrapped lazily. Supports dotted
    ``get``/``set``, ``instantiate``, ``to_dict``, and containment.
    """

    def __init__(self, data: Mapping[str, Any] | None = None):
        object.__setattr__(self, "_data", {})
        for k, v in (data or {}).items():
            self._data[k] = _wrap(v)

    # -- mapping-ish interface ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._data[name]
        except KeyError:
            raise AttributeError(f"Config has no field '{name}'") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = _wrap(value)

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def __setitem__(self, name: str, value: Any) -> None:
        self.set(name, value)

    def __contains__(self, name: str) -> bool:
        sentinel = object()
        return self.get(name, sentinel) is not sentinel

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, ConfigNode):
            return self.to_dict() == other.to_dict()
        if isinstance(other, Mapping):
            return self.to_dict() == dict(other)
        return NotImplemented

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def values(self):
        return self._data.values()

    # -- dotted access --------------------------------------------------------
    def get(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, ConfigNode):
                if part not in node._data:
                    return default
                node = node._data[part]
            elif isinstance(node, list):
                try:
                    node = node[int(part)]
                except (ValueError, IndexError):
                    return default
            else:
                return default
        return node

    def set(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            child = node._data.get(part)
            if not isinstance(child, ConfigNode):
                child = ConfigNode()
                node._data[part] = child
            node = child
        node._data[parts[-1]] = _wrap(value)

    # -- conversion -----------------------------------------------------------
    def to_dict(self, redact: bool = False) -> dict:
        out: dict = {}
        for k, v in self._data.items():
            if isinstance(v, ConfigNode):
                out[k] = v.to_dict(redact=redact)
            elif isinstance(v, list):
                out[k] = [x.to_dict(redact=redact) if isinstance(x, ConfigNode) else x for x in v]
            elif redact and isinstance(v, str) and _SECRET_PAT.search(k):
                out[k] = "***"
            else:
                out[k] = v
        return out

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict(redact=True)})"

    # -- instantiation --------------------------------------------------------
    def instantiate(self, **overrides: Any) -> Any:
        """Build the object named by ``_target_`` from this node.

        Child ConfigNodes that themselves carry ``_target_`` are instantiated
        recursively; others are passed through as ConfigNode. ``overrides``
        take precedence over YAML-specified kwargs.
        """
        if "_target_" not in self._data:
            raise ConfigError("instantiate() requires a '_target_' field")
        target = _resolve_target(self._data["_target_"])
        kwargs: dict = {}
        for k, v in self._data.items():
            if k in ("_target_", "_partial_"):
                continue
            kwargs[k] = _instantiate_value(v)
        kwargs.update(overrides)
        if self._data.get("_partial_"):
            import functools

            return functools.partial(target, **kwargs)
        return target(**kwargs)


def _instantiate_value(v: Any) -> Any:
    if isinstance(v, ConfigNode):
        if "_target_" in v._data:
            return v.instantiate()
        return v
    if isinstance(v, list):
        return [_instantiate_value(x) for x in v]
    return v


def _wrap(v: Any) -> Any:
    if isinstance(v, ConfigNode):
        return v
    if isinstance(v, Mapping):
        return ConfigNode(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    if isinstance(v, str):
        return _translate_value(_resolve_env(v))
    return v


def _translate_value(s: str) -> Any:
    """Env interpolation can leave numeric strings; coerce the obvious ones."""
    return s


def load_yaml(path: str) -> ConfigNode:
    with open(path) as f:
        data = yaml.safe_load(f)
    if data is None:
        data = {}
    if not isinstance(data, Mapping):
        raise ConfigError(f"Top-level YAML in {path} must be a mapping")
    return ConfigNode(data)


def instantiate(node_or_target: "ConfigNode | str", **kwargs: Any) -> Any:
    """Free-function form: instantiate(node) or instantiate("pkg.Sym", a=1)."""
    if isinstance(node_or_target, str):
        return _resolve_target(node_or_target)(**kwargs)
    return node_or_target.instantiate(**kwargs)
