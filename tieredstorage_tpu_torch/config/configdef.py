"""A small Kafka-ConfigDef-style schema: typed keys, defaults, validators, docs.

Reference model: Kafka's ConfigDef as used throughout
core/.../config/RemoteStorageManagerConfig.java (typed keys with defaults,
range/class validators, docstrings that generate docs/configs.rst, and
prefix-stripping for nested configs).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Mapping, Optional


class ConfigException(ValueError):
    pass


NO_DEFAULT = object()


@dataclasses.dataclass
class ConfigKey:
    name: str
    type: str  # "string" | "int" | "long" | "double" | "bool" | "class" | "list" | "password"
    default: Any = NO_DEFAULT
    validator: Optional[Callable[[str, Any], None]] = None
    importance: str = "medium"
    doc: str = ""

    @property
    def required(self) -> bool:
        return self.default is NO_DEFAULT


def in_range(min_value=None, max_value=None):
    def check(name: str, value) -> None:
        if min_value is not None and value < min_value:
            raise ConfigException(
                f"Invalid value {value} for configuration {name}: Value must be at least {min_value}"
            )
        if max_value is not None and value > max_value:
            raise ConfigException(
                f"Invalid value {value} for configuration {name}: Value must be no more than {max_value}"
            )

    # Reference docs render ranges as "[min,...,max]" (docs/configs.rst:13).
    if min_value is not None and max_value is not None:
        check.description = f"[{min_value},...,{max_value}]"
    elif min_value is not None:
        check.description = f"[{min_value},...]"
    else:
        check.description = f"[...,{max_value}]"
    return check


def null_or(validator: Callable[[str, Any], None]):
    """Accept None, else delegate to `validator`."""

    def check(name: str, value) -> None:
        if value is not None:
            validator(name, value)

    inner = getattr(validator, "description", None)
    if inner:
        check.description = f"null or {inner}"
    return check


def parseable_by(parser: Callable[[Any], Any], description: str = "parseable"):
    """Validate a value by attempting to parse it; the parser's error text
    becomes the config error message (used for structured string configs like
    `fault.schedule` rules)."""

    def check(name: str, value) -> None:
        if value is None or value == "" or value == []:
            return
        try:
            parser(value)
        except ConfigException:
            raise
        except Exception as e:
            raise ConfigException(
                f"Invalid value {value!r} for configuration {name}: {e}"
            ) from e

    check.description = description
    return check


def non_empty_string(name: str, value) -> None:
    if value is not None and str(value).strip() == "":
        raise ConfigException(f"Invalid value for configuration {name}: String must be non-empty")


non_empty_string.description = "non-empty string"


def subclass_of(base: type):
    def check(name: str, value) -> None:
        if value is not None and not (isinstance(value, type) and issubclass(value, base)):
            raise ConfigException(
                f"Invalid value {value} for configuration {name}: Must be a subclass of {base.__name__}"
            )

    check.description = f"Any implementation of {base.__name__}"
    return check


def _coerce(key: ConfigKey, value: Any) -> Any:
    if value is None:
        return None
    t = key.type
    try:
        if t in ("int", "long"):
            if isinstance(value, bool):
                raise ValueError
            return int(value)
        if t == "double":
            if isinstance(value, bool):
                raise ValueError
            return float(value)
        if t == "bool":
            if isinstance(value, bool):
                return value
            s = str(value).strip().lower()
            if s in ("true", "1", "yes"):
                return True
            if s in ("false", "0", "no"):
                return False
            raise ValueError
        if t == "class":
            if isinstance(value, type):
                return value
            path = str(value)
            if ":" in path:
                module_name, _, cls = path.partition(":")
            else:
                module_name, _, cls = path.rpartition(".")
            return getattr(importlib.import_module(module_name), cls)
        if t == "list":
            if isinstance(value, (list, tuple)):
                return list(value)
            s = str(value).strip()
            return [p.strip() for p in s.split(",") if p.strip()] if s else []
        return str(value)
    except (ValueError, TypeError, ImportError, AttributeError) as e:
        raise ConfigException(
            f"Invalid value {value!r} for configuration {key.name}: expected {t}"
        ) from e


class ConfigDef:
    def __init__(self) -> None:
        self._keys: dict[str, ConfigKey] = {}

    def define(self, key: ConfigKey) -> "ConfigDef":
        if key.name in self._keys:
            raise ValueError(f"Configuration {key.name} defined twice")
        self._keys[key.name] = key
        return self

    @property
    def keys(self) -> dict[str, ConfigKey]:
        return dict(self._keys)

    def parse(self, props: Mapping[str, Any]) -> dict[str, Any]:
        parsed: dict[str, Any] = {}
        for name, key in self._keys.items():
            if name in props:
                value = _coerce(key, props[name])
            elif key.required:
                raise ConfigException(
                    f'Missing required configuration "{name}" which has no default value.'
                )
            else:
                value = _coerce(key, key.default)
            if key.validator is not None:
                key.validator(name, value)
            parsed[name] = value
        return parsed


def subset_with_prefix(props: Mapping[str, Any], prefix: str) -> dict[str, Any]:
    """Strip `prefix` from matching keys (Kafka originalsWithPrefix semantics;
    reference: RemoteStorageManagerConfig.java:44-46, 315-320)."""
    return {k[len(prefix) :]: v for k, v in props.items() if k.startswith(prefix)}
