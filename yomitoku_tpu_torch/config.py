"""Structured configuration (the port's copy of yomitoku_tpu/config.py):
a model variant's dataclass defaults, recursively merged with an
optional user YAML file.  Unknown keys in the YAML raise.  The result is a
``Config``: a dict with attribute access, nested dicts included."""

import dataclasses
from pathlib import Path
from typing import Any, Optional, Union

import yaml


class Config(dict):
    """A dict with attribute access; nested dicts are also ``Config``."""

    def __init__(self, data: Optional[dict] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = self._wrap(v)

    @staticmethod
    def _wrap(v):
        if isinstance(v, Config):
            return v
        if isinstance(v, dict):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return [Config._wrap(x) for x in v]
        return v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        self[name] = self._wrap(value)


def _dataclass_to_dict(obj) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _dataclass_to_dict(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (list, tuple)):
        return [_dataclass_to_dict(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _dataclass_to_dict(v) for k, v in obj.items()}
    return obj


def structured(default_config) -> Config:
    """Build a Config from a dataclass type or instance (or a dict)."""
    if isinstance(default_config, type):
        default_config = default_config()
    if dataclasses.is_dataclass(default_config):
        return Config(_dataclass_to_dict(default_config))
    if isinstance(default_config, dict):
        return Config(default_config)
    raise TypeError(f"Unsupported default config type: {type(default_config)}")


def merge_into(base: Config, override: dict, path: str = "") -> Config:
    """Recursively merge ``override`` into ``base`` (mutates and returns
    base).  Unknown keys raise KeyError."""
    for k, v in override.items():
        full = f"{path}.{k}" if path else str(k)
        if k not in base:
            raise KeyError(f"Unknown config key: {full}")
        cur = base[k]
        if isinstance(cur, Config) and isinstance(v, dict):
            merge_into(cur, v, full)
        else:
            base[k] = Config._wrap(v)
    return base


def load_yaml_config(path_config: Union[str, Path]) -> dict:
    path_config = Path(path_config)
    if not path_config.exists():
        raise FileNotFoundError(f"Config file not found: {path_config}")
    with open(path_config, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f)
    return data or {}


def load_config(default_config, path_config: Union[str, Path, None] = None) -> Config:
    """Dataclass defaults merged with an optional YAML override."""
    cfg = structured(default_config)
    if path_config is not None:
        merge_into(cfg, load_yaml_config(path_config))
    return cfg
