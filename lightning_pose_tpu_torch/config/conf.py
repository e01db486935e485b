"""A minimal, dependency-free OmegaConf-like configuration tree (the port's
copy of ``lightning_pose_tpu/config/conf.py``).

Supports the subset of OmegaConf the Lightning Pose config schema relies on
(reference usage: lightning_pose/train.py, lightning_pose/api/model_config.py):

- attribute and item access over nested mappings,
- ``cfg.get(key, default)``,
- string interpolation ``${a.b.c}`` resolved lazily against the config root,
- custom resolvers ``${NAME:arg}`` (e.g. ``${LP_ROOT_PATH:}``),
- deep merge of configs,
- Hydra-style dotted overrides ``a.b.c=value`` (values parsed as YAML),
- round-trip to/from YAML.
"""

from __future__ import annotations

import copy as _copy
import re
from typing import Any, Callable, Iterator

import yaml

_INTERP_RE = re.compile(r"\$\{([^${}]*)\}")

_RESOLVERS: dict[str, Callable[[str], Any]] = {}


def register_resolver(name: str, fn: Callable[[str], Any]) -> None:
    """Register a ``${name:arg}`` resolver (mirrors OmegaConf.register_new_resolver)."""
    _RESOLVERS[name] = fn


def _register_builtin_resolvers() -> None:
    import datetime

    from lightning_pose_tpu_torch import LP_ROOT_PATH

    register_resolver("LP_ROOT_PATH", lambda _arg: LP_ROOT_PATH)
    # hydra's ${now:%Y-%m-%d} pattern, used in the hydra.run.dir default
    register_resolver("now", lambda fmt: datetime.datetime.now().strftime(fmt or "%Y-%m-%d"))


class Config:
    """Nested attribute-accessible config node with lazy interpolation."""

    __slots__ = ("_data", "_root")

    def __init__(self, data: dict | None = None, _root: "Config | None" = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_root", _root)
        if data:
            for k, v in data.items():
                self._data[k] = self._wrap(v)

    # -- construction helpers ------------------------------------------------

    def _wrap(self, value: Any) -> Any:
        root = self._root or self
        if isinstance(value, Config):
            return Config(value.to_dict(resolve=False), _root=root)
        if isinstance(value, dict):
            node = Config(_root=root)
            for k, v in value.items():
                node._data[k] = node._wrap(v)
            return node
        if isinstance(value, (list, tuple)):
            return [self._wrap(v) for v in value]
        return value

    def _reroot(self, root: "Config") -> None:
        object.__setattr__(self, "_root", root if root is not self else None)
        for v in self._data.values():
            if isinstance(v, Config):
                v._reroot(root)
            elif isinstance(v, list):
                for item in v:
                    if isinstance(item, Config):
                        item._reroot(root)

    @property
    def root(self) -> "Config":
        return self._root or self

    # -- interpolation ---------------------------------------------------------

    def _resolve_value(self, value: Any) -> Any:
        if isinstance(value, str) and "${" in value:
            return self._resolve_str(value)
        if isinstance(value, list):
            return [self._resolve_value(v) for v in value]
        return value

    def _resolve_str(self, s: str, _depth: int = 0) -> Any:
        if _depth > 20:
            raise ValueError(f"interpolation loop while resolving {s!r}")
        full = _INTERP_RE.fullmatch(s)
        if full:
            resolved = self._resolve_ref(full.group(1), _depth)
            return resolved

        def sub(m: re.Match) -> str:
            v = self._resolve_ref(m.group(1), _depth)
            return "" if v is None else str(v)

        return _INTERP_RE.sub(sub, s)

    def _resolve_ref(self, ref: str, _depth: int) -> Any:
        if ":" in ref:
            name, _, arg = ref.partition(":")
            if name in _RESOLVERS:
                return _RESOLVERS[name](arg)
            raise KeyError(f"no resolver registered for ${{{ref}}}")
        node: Any = self.root
        for part in ref.split("."):
            if not isinstance(node, Config) or part not in node._data:
                raise KeyError(f"interpolation key not found: {ref!r}")
            node = node._data[part]
        if isinstance(node, str) and "${" in node:
            return self._resolve_str(node, _depth + 1)
        if isinstance(node, Config):
            return node
        return self._resolve_value(node)

    # -- mapping protocol --------------------------------------------------------

    def __getattr__(self, key: str) -> Any:
        if key.startswith("__"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(str(e)) from None

    def __getitem__(self, key: str) -> Any:
        if key not in self._data:
            raise KeyError(f"missing config key: {key!r}")
        return self._resolve_value(self._data[key])

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = self._wrap(value)

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __bool__(self) -> bool:
        return bool(self._data)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self.to_dict(resolve=False)!r})"

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            value = self[key]
            return default if value is None else value
        return default

    def keys(self):
        return self._data.keys()

    def values(self):
        return [self[k] for k in self._data]

    def items(self):
        return [(k, self[k]) for k in self._data]

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            self[key] = default
        return self[key]

    def pop(self, key: str, *default: Any) -> Any:
        if key in self._data:
            value = self[key]
            del self._data[key]
            return value
        if default:
            return default[0]
        raise KeyError(key)

    # -- dotted-path access ----------------------------------------------------

    def select(self, path: str, default: Any = None) -> Any:
        """Return the value at a dotted path, or ``default`` if absent."""
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, Config) or part not in node:
                return default
            node = node[part]
        return node

    def update_at(self, path: str, value: Any) -> None:
        """Set the value at a dotted path, creating intermediate nodes."""
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node._data or not isinstance(node._data[part], Config):
                node._data[part] = Config(_root=node.root)
            node = node._data[part]
        node._data[parts[-1]] = node._wrap(value)

    # -- merge / overrides ------------------------------------------------------

    def merge_with(self, other: "Config | dict") -> None:
        """Deep-merge ``other`` into this config (other wins)."""
        other_items = other.items() if isinstance(other, (Config, dict)) else other
        if isinstance(other, Config):
            other_items = [(k, other._data[k]) for k in other._data]
        elif isinstance(other, dict):
            other_items = list(other.items())
        for k, v in other_items:
            if (
                k in self._data
                and isinstance(self._data[k], Config)
                and isinstance(v, (Config, dict))
            ):
                self._data[k].merge_with(v)
            else:
                self._data[k] = self._wrap(
                    v.to_dict(resolve=False) if isinstance(v, Config) else v
                )

    def apply_overrides(self, overrides: list[str]) -> None:
        """Apply Hydra-style ``a.b.c=value`` overrides; values parsed as YAML."""
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override must look like key=value, got {ov!r}")
            key, _, raw = ov.partition("=")
            key = key.strip().lstrip("+")
            value = yaml.safe_load(raw) if raw != "" else None
            if isinstance(value, str):
                # YAML 1.1 doesn't parse "1e-3" as a float; coerce numerics
                try:
                    value = int(value)
                except ValueError:
                    try:
                        value = float(value)
                    except ValueError:
                        pass
            self.update_at(key, value)

    # -- serialization ---------------------------------------------------------

    def to_dict(self, resolve: bool = False) -> dict:
        out: dict = {}
        for k, v in self._data.items():
            if isinstance(v, Config):
                out[k] = v.to_dict(resolve=resolve)
            elif isinstance(v, list):
                out[k] = [
                    item.to_dict(resolve=resolve) if isinstance(item, Config)
                    else (self._resolve_value(item) if resolve else item)
                    for item in v
                ]
            else:
                out[k] = self._resolve_value(v) if resolve else v
        return out

    def to_yaml(self, resolve: bool = False) -> str:
        return yaml.safe_dump(self.to_dict(resolve=resolve), sort_keys=False)

    def save(self, path: str, resolve: bool = False) -> None:
        with open(path, "w") as f:
            f.write(self.to_yaml(resolve=resolve))

    def copy(self) -> "Config":
        return Config(_copy.deepcopy(self.to_dict(resolve=False)))

    def __deepcopy__(self, memo: dict) -> "Config":
        return self.copy()

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        return cls(data)


def load_config(
    path: str | None = None,
    overrides: list[str] | None = None,
    use_defaults: bool = True,
) -> Config:
    """Load a config file on top of the package defaults, then apply overrides.

    Mirrors the reference's ``hydra.compose`` flow (reference
    lightning_pose/cli/commands/train.py:84-87): defaults <- file <- overrides.
    """
    from lightning_pose_tpu_torch.config.defaults import default_config

    cfg = default_config() if use_defaults else Config()
    if path is not None:
        cfg.merge_with(Config.from_yaml(path))
    if overrides:
        cfg.apply_overrides(list(overrides))
    return cfg


_register_builtin_resolvers()
