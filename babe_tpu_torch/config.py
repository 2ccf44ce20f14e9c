"""YAML configuration: groups, overrides and attribute access.

The port's own copy of the small Hydra-like composer the JAX package uses, so
both packages read the same ``conf/`` tree (data shared by the two packages):

  * a root config with a ``defaults`` list naming config groups,
  * group swaps (``tester=blind_bwe``) and dotted overrides (``tester.T=35``,
    values YAML-parsed),
  * attribute-style access (``cfg.network.cqt.num_octs``).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Iterable

import yaml


class ConfigDict(dict):
    """dict with attribute access, recursively applied. Missing keys raise KeyError."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name, value) -> None:
        super().__setitem__(name, _wrap(value))

    def __delattr__(self, name: str) -> None:
        del self[name]

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = ConfigDict()
            node = node[part]
        node[parts[-1]] = _wrap(value)

    def to_dict(self) -> dict:
        return _unwrap(self)


def _wrap(obj: Any) -> Any:
    if isinstance(obj, ConfigDict):
        return obj
    if isinstance(obj, dict):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return [_wrap(v) for v in obj]
    return obj


def _unwrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _unwrap(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unwrap(v) for v in obj]
    return obj


def _deep_merge(base: ConfigDict, extra: dict) -> None:
    """Merge ``extra`` into ``base`` in place (extra wins; dicts merge recursively)."""
    for k, v in extra.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, dict):
            _deep_merge(base[k], v)
        else:
            base[k] = _wrap(v)


def _parse_value(text: str) -> Any:
    """YAML-parse an override value ('1e-4' -> float, '[1,2]' -> list, ...)."""
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def load_yaml(path: str) -> ConfigDict:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return _wrap(data)


def load_config(
    config_dir: str,
    config_name: str = "conf",
    overrides: Iterable[str] = (),
) -> ConfigDict:
    """Compose a config from a root file, its defaults list and overrides.

    ``group=name`` swaps a config group file (conf/<group>/<name>.yaml);
    ``a.b.c=value`` sets a dotted key.  Group swaps apply first (in order),
    then dotted overrides.
    """
    root = load_yaml(os.path.join(config_dir, config_name + ".yaml"))
    defaults = root.pop("defaults", [])

    group_choice: dict[str, str] = {}
    for entry in defaults:
        if isinstance(entry, dict):
            for g, n in entry.items():
                group_choice[str(g)] = str(n)

    dotted: list[tuple[str, str]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, val = ov.partition("=")
        key = key.lstrip("+")
        if "." not in key and os.path.isdir(os.path.join(config_dir, key)):
            group_choice[key] = val
        else:
            dotted.append((key, val))

    cfg = ConfigDict()
    for g, n in group_choice.items():
        path = os.path.join(config_dir, g, n + ".yaml")
        if not os.path.exists(path):
            raise FileNotFoundError(f"config group file not found: {path}")
        cfg[g] = load_yaml(path)
    _deep_merge(cfg, root)

    for key, val in dotted:
        cfg.set_path(key, _parse_value(val))
    return cfg


def default_config(overrides: Iterable[str] = ()) -> ConfigDict:
    """Load the repository's shared ``conf/`` tree with the shipped defaults."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_config(os.path.join(here, "conf"), "conf", overrides)


def make_config(data: dict) -> ConfigDict:
    """Wrap a plain nested dict."""
    return _wrap(copy.deepcopy(data))
