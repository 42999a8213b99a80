"""Layered experiment configuration (the JAX package's ``config/``).

Plain YAML files, this package's own copies under ``configs/``, composed
into a ``Config`` (a dict with attribute access). The root config declares
``defaults`` (group: file) pairs; overrides are group swaps
(``model=imitation``) or dotted value assignments (``BATCH_SIZE=8``,
``sim.n_envs=1024``); ``${now:FMT}`` is the one interpolation. ``compose``
is a pure function of the config directory.
"""

from __future__ import annotations

import ast
import copy
import datetime
import os
from pathlib import Path
from typing import Any, Iterable

import yaml

_PKG_CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


class Config(dict):
    """Dict with attribute access (``cfg["camera"]`` and ``cfg.camera``),
    recursive over nested mappings."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        # through __setitem__, so nested dicts are wrapped too
        super().__init__()
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def merge(self, other: dict) -> "Config":
        """Recursive in-place merge; ``other`` wins on conflicts."""
        for k, v in other.items():
            if k in self and isinstance(self[k], dict) and isinstance(v, dict):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def set_dotted(self, dotted: str, value: Any) -> None:
        node = self
        parts = dotted.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = value

    def get_dotted(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for p in dotted.split("."):
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        return node

    def to_dict(self) -> dict:
        def unwrap(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def copy(self) -> "Config":  # type: ignore[override]
        return Config(copy.deepcopy(self.to_dict()))


def _parse_value(text: str) -> Any:
    """Parse an override value: try python literal, fall back to string."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _interpolate(value: Any) -> Any:
    """Resolve ``${now:FMT}`` (``log_dir: logs/${now:%Y-%m-%d}``)."""
    if isinstance(value, str) and "${now:" in value:
        start = value.index("${now:")
        end = value.index("}", start)
        fmt = value[start + len("${now:"):end]
        stamp = datetime.datetime.now().strftime(fmt)
        return value[:start] + stamp + value[end + 1:]
    return value


def _interpolate_tree(cfg: Config) -> None:
    for k, v in list(cfg.items()):
        if isinstance(v, Config):
            _interpolate_tree(v)
        else:
            cfg[k] = _interpolate(v)


def _load_yaml(path: Path) -> dict:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"config file {path} must contain a mapping")
    return data


def _group_file(config_dir: Path, group: str, name: str) -> Path:
    name = name if name.endswith((".yaml", ".yml")) else name + ".yaml"
    return config_dir / group / name


def compose(
    config_name: str = "config",
    overrides: Iterable[str] = (),
    config_dir: str | os.PathLike | None = None,
) -> Config:
    """Compose a config from the config directory (default this package's
    ``configs/``).

    ``overrides`` entries are either group swaps (``model=imitation`` — load
    ``<dir>/model/imitation.yaml`` instead of the default) or dotted value
    assignments (``BATCH_SIZE=8``, ``sim.n_envs=1024``).  Group swaps are
    recognized by the existence of ``<dir>/<lhs>/`` as a directory.
    """
    cdir = Path(config_dir) if config_dir is not None else _PKG_CONFIG_DIR
    root_path = cdir / (config_name if config_name.endswith(".yaml") else config_name + ".yaml")
    root = _load_yaml(root_path)
    defaults: list[dict] = []
    for item in root.pop("defaults", []):
        if isinstance(item, dict):
            defaults.append(item)
        else:  # bare string entry → group-less include
            defaults.append({None: item})

    # Partition overrides into group swaps vs value assignments.
    group_swaps: dict[str, str] = {}
    value_sets: list[tuple[str, Any]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        lhs, rhs = ov.split("=", 1)
        if (cdir / lhs).is_dir():
            group_swaps[lhs] = rhs
        else:
            value_sets.append((lhs, _parse_value(rhs)))

    cfg = Config()
    for item in defaults:
        for group, name in item.items():
            if group is None:
                path = cdir / (name if name.endswith(".yaml") else name + ".yaml")
            else:
                name = group_swaps.pop(group, name)
                path = _group_file(cdir, group, name)
            cfg.merge(_load_yaml(path))
    for group, name in group_swaps.items():  # swap for a group not in defaults
        cfg.merge(_load_yaml(_group_file(cdir, group, name)))
    cfg.merge(root)
    for dotted, value in value_sets:
        cfg.set_dotted(dotted, value)
    _interpolate_tree(cfg)
    return cfg
