"""Config system: executable-Python configs with ``_base_`` inheritance.

Capability parity with mmengine's ``Config.fromfile`` as used by the reference
(``tools/diffusion/train.py:43``; semantics documented in SURVEY.md §5):

- a config is a Python file; its module-level variables become config keys
- ``_base_ = ["./relative/path.py", ...]`` merges base configs first
  (later bases and the child override earlier ones, dict-deep merge)
- a dict containing ``_delete_ = True`` replaces the base subtree instead of
  merging into it

Unlike the reference, configs here are declarative-first: values should be
plain dicts/lists/scalars. Attribute access is provided for ergonomics.

A copy of ``fish_diffusion_tpu/config/config.py``: that package imports jax
on import, which this one must not.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict

_DELETE_KEY = "_delete_"
_BASE_KEY = "_base_"

_RESERVED = {
    "__name__", "__doc__", "__package__", "__loader__", "__spec__",
    "__file__", "__builtins__", "__cached__",
}


class ConfigDict(dict):
    """dict with attribute access; missing attributes raise AttributeError."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def get(self, name, default=None):
        return super().get(name, default)

    def copy(self) -> "ConfigDict":
        return _to_config_dict(copy.deepcopy(dict(self)))


def _to_config_dict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _merge_dict(base: Dict, override: Dict) -> Dict:
    """Deep-merge ``override`` into ``base`` (mmengine semantics)."""
    if override.pop(_DELETE_KEY, False):
        return copy.deepcopy(override)

    merged = dict(base)
    for key, value in override.items():
        if (
            key in merged
            and isinstance(merged[key], dict)
            and isinstance(value, dict)
        ):
            merged[key] = _merge_dict(merged[key], dict(value))
        else:
            merged[key] = copy.deepcopy(value)
    return merged


def _load_raw(path: Path) -> Dict[str, Any]:
    source = path.read_text()
    namespace: Dict[str, Any] = {"__file__": str(path)}
    exec(compile(source, str(path), "exec"), namespace)

    import types

    cfg = {
        k: v
        for k, v in namespace.items()
        if (
            (not k.startswith("_") or k == _BASE_KEY)
            and k not in _RESERVED
            and not isinstance(v, types.ModuleType)
        )
    }

    bases = cfg.pop(_BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]

    merged: Dict[str, Any] = {}
    for base_rel in bases:
        base_path = (path.parent / base_rel).resolve()
        merged = _merge_dict(merged, _load_raw(base_path))

    return _merge_dict(merged, cfg)


class Config(ConfigDict):
    """Top-level config object."""

    @staticmethod
    def fromfile(filename) -> "Config":
        path = Path(filename).resolve()
        if not path.exists():
            raise FileNotFoundError(path)
        raw = _load_raw(path)
        cfg = Config(_to_config_dict(raw))
        return cfg

    @staticmethod
    def fromdict(d: Dict[str, Any]) -> "Config":
        return Config(_to_config_dict(copy.deepcopy(d)))
