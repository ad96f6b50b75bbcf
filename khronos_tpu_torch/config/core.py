"""Typed config system with YAML/CLI layering, plugin registry, and validation.

Host-only copy of `khronos_tpu/config/core.py` with its own plugin registry, so
both packages build from the same config dicts. PyYAML is imported only by the
functions that read or write YAML.

Replacement for the reference's `config_utilities` semantics
(SURVEY.md §5: declare_config/field/check*, RegistrationWithConfig factories,
VirtualConfig plugin selection, --config-utilities-file/-yaml layering;
cf. reference khronos/src/active_window/active_window.cpp:50-71).

Design: plain dataclasses are configs. `build(cls, mapping)` constructs a config
tree recursively; fields typed as `Plugin` select an implementation by `type:`
string from a global registry (factory pattern). `load_config` layers YAML files
and `key.path=value` CLI overrides. Validation hooks: a config may define
`check(self)` raising ValueError; `build` calls it.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Callable, Dict, List, Optional, Tuple, Type, TypeVar

T = TypeVar("T")

# ----------------------------------------------------------------------------
# Plugin registry: (base_name, type_string) -> (config_cls, factory)
# ----------------------------------------------------------------------------

_REGISTRY: Dict[Tuple[str, str], Tuple[type, Callable]] = {}


def register(base: str, type_name: str):
    """Register a (config_cls, factory) pair under a plugin base category.

    Usage:
        @register("motion_detector", "FreeSpaceMotionDetector")
        @dataclasses.dataclass
        class FreeSpaceMotionDetectorConfig:
            ...
            def create(self, **kw): return FreeSpaceMotionDetector(self, **kw)
    """

    def deco(config_cls):
        _REGISTRY[(base, type_name)] = (config_cls, getattr(config_cls, "create", None))
        config_cls._plugin_type = type_name
        return config_cls

    return deco


def registered_types(base: str) -> List[str]:
    return sorted(t for (b, t) in _REGISTRY if b == base)


@dataclasses.dataclass
class Plugin:
    """A virtual config: selects a registered implementation by `type:`.

    If `type` is None/empty the plugin is disabled (mirrors the reference's
    optional modules: "by not setting the 'type' param no motion detection
    will be performed", khronos_ros/config/mapper/uHumans2.yaml:51).
    """

    base: str
    config: Optional[Any] = None  # the resolved config dataclass instance

    @property
    def enabled(self) -> bool:
        return self.config is not None

    def create(self, *args, **kwargs):
        if self.config is None:
            return None
        return self.config.create(*args, **kwargs)

    @property
    def type(self) -> Optional[str]:
        return getattr(self.config, "_plugin_type", None) if self.config else None


def plugin_field(base: str, default_type: Optional[str] = None, **default_overrides):
    """Dataclass field for a Plugin slot with an optional default implementation."""

    def factory():
        if default_type is None:
            return Plugin(base=base, config=None)
        cfg_cls, _ = _REGISTRY[(base, default_type)]
        return Plugin(base=base, config=cfg_cls(**default_overrides))

    return dataclasses.field(default_factory=factory, metadata={"plugin_base": base})


# ----------------------------------------------------------------------------
# Recursive construction from nested mappings
# ----------------------------------------------------------------------------


def build(cls: Type[T], data: Optional[Dict[str, Any]] = None) -> T:
    """Build config dataclass `cls` from a nested mapping, with validation."""
    data = dict(data or {})
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a config dataclass")
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if f.name not in data:
            if "plugin_base" in f.metadata:
                # allow YAML to omit plugin entirely -> default factory
                continue
            continue
        raw = data.pop(f.name)
        ftype = hints.get(f.name, f.type)
        kwargs[f.name] = _coerce(ftype, raw, f)
    if data:
        unknown = ", ".join(sorted(data))
        raise ValueError(f"Unknown config keys for {cls.__name__}: {unknown}")
    obj = cls(**kwargs)
    check = getattr(obj, "check", None)
    if callable(check):
        check()
    return obj


def _coerce(ftype, raw, f: dataclasses.Field):
    origin = typing.get_origin(ftype)
    if ftype is Plugin or (isinstance(ftype, type) and issubclass_safe(ftype, Plugin)):
        base = f.metadata.get("plugin_base")
        return _build_plugin(base, raw)
    if dataclasses.is_dataclass(ftype) and isinstance(raw, dict):
        return build(ftype, raw)
    if origin in (list, List) and isinstance(raw, (list, tuple)):
        (item_t,) = typing.get_args(ftype) or (Any,)
        if dataclasses.is_dataclass(item_t):
            return [build(item_t, r) for r in raw]
        return list(raw)
    if origin in (tuple, Tuple) and isinstance(raw, (list, tuple)):
        return tuple(raw)
    if origin is typing.Union:
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if raw is None:
            return None
        if len(args) == 1:
            return _coerce(args[0], raw, f)
        return raw
    if ftype is float and isinstance(raw, (int, float)):
        return float(raw)
    if ftype is int and isinstance(raw, (int, float)) and float(raw).is_integer():
        return int(raw)
    if ftype is bool and isinstance(raw, bool):
        return raw
    return raw


def issubclass_safe(a, b) -> bool:
    try:
        return issubclass(a, b)
    except TypeError:
        return False


def _build_plugin(base: str, raw) -> Plugin:
    if raw is None:
        return Plugin(base=base, config=None)
    if not isinstance(raw, dict):
        raise ValueError(f"Plugin '{base}' expects a mapping with a 'type' key")
    raw = dict(raw)
    type_name = raw.pop("type", None)
    if not type_name:
        return Plugin(base=base, config=None)
    key = (base, str(type_name))
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown plugin type '{type_name}' for base '{base}'. "
            f"Registered: {registered_types(base)}"
        )
    cfg_cls, _ = _REGISTRY[key]
    return Plugin(base=base, config=build(cfg_cls, raw))


# ----------------------------------------------------------------------------
# YAML + CLI layering
# ----------------------------------------------------------------------------


def deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def parse_override(kv: str) -> Dict[str, Any]:
    """Parse `a.b.c=value` into a nested dict (value parsed as YAML scalar)."""
    if "=" not in kv:
        raise ValueError(f"Override '{kv}' must be key.path=value")
    import yaml

    path, _, value = kv.partition("=")
    leaf = yaml.safe_load(value)
    out: Dict[str, Any] = leaf
    for key in reversed(path.strip().split(".")):
        out = {key: out}
    return out


def load_mapping(files: List[str] = (), overrides: List[str] = ()) -> Dict[str, Any]:
    import yaml

    data: Dict[str, Any] = {}
    for path in files:
        with open(path) as fh:
            layer = yaml.safe_load(fh) or {}
        data = deep_merge(data, layer)
    for ov in overrides:
        data = deep_merge(data, parse_override(ov))
    return data


def load_config(cls: Type[T], files: List[str] = (), overrides: List[str] = ()) -> T:
    return build(cls, load_mapping(files, overrides))


def to_dict(cfg) -> Dict[str, Any]:
    """Realized config tree as a plain dict (for config.txt reproducibility logs)."""
    if isinstance(cfg, Plugin):
        if cfg.config is None:
            return {"type": None}
        d = to_dict(cfg.config)
        d = {"type": cfg.type, **d}
        return d
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def format_config(cfg, name: str = None) -> str:
    import yaml

    return yaml.safe_dump({name or type(cfg).__name__: to_dict(cfg)}, sort_keys=False)


# Validation helpers (mirror config_utilities check/checkInRange semantics).
def check_gt(value, bound, name: str):
    if not value > bound:
        raise ValueError(f"config field '{name}'={value} must be > {bound}")


def check_ge(value, bound, name: str):
    if not value >= bound:
        raise ValueError(f"config field '{name}'={value} must be >= {bound}")


def check_in_range(value, lo, hi, name: str):
    if not (lo <= value <= hi):
        raise ValueError(f"config field '{name}'={value} must be in [{lo}, {hi}]")


def check_in(value, options, name: str):
    if value not in options:
        raise ValueError(f"config field '{name}'={value} must be one of {options}")
