"""Hierarchical configuration nodes (the port's own copy of
``dfd_clip_tpu/config.py``'s ``CN``): attribute access, ``get``,
``merge_from_other_cfg``, ``merge_from_file``, ``dump`` and open
(``new_allowed``) nodes. ``yaml`` is imported only by the functions that
read or write it.
"""

from __future__ import annotations

from typing import Any, Dict

_VALID_SCALARS = (int, float, bool, str, type(None))


def _validate(value: Any, key: str) -> Any:
    if isinstance(value, CfgNode):
        return value
    if isinstance(value, dict):
        return CfgNode(value)
    if isinstance(value, (list, tuple)):
        return [_validate(v, key) for v in value]
    if isinstance(value, _VALID_SCALARS):
        return value
    raise TypeError(f"Invalid config value for key '{key}': {type(value)}")


class CfgNode:
    """A dict-like config node with attribute access and merge semantics."""

    def __init__(self, init: Dict[str, Any] | None = None, new_allowed: bool = False):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_new_allowed", new_allowed)
        for k, v in (init or {}).items():
            self._data[str(k)] = _validate(v, str(k))

    def __getattr__(self, key: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if key in data:
            return data[key]
        raise AttributeError(f"Config key not found: {key}")

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _validate(value, key)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __repr__(self) -> str:
        return f"CfgNode({self.to_dict()!r})"

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def merge_from_file(self, filename: str) -> "CfgNode":
        import yaml

        with open(filename, "r") as f:
            self._merge_dict(yaml.safe_load(f) or {})
        return self

    def merge_from_other_cfg(self, other: "CfgNode | Dict[str, Any]") -> "CfgNode":
        self._merge_dict(other.to_dict() if isinstance(other, CfgNode) else other)
        return self

    def _merge_dict(self, src: Dict[str, Any]) -> None:
        for k, v in src.items():
            k = str(k)
            current = self._data.get(k)
            if isinstance(current, CfgNode) and isinstance(v, (dict, CfgNode)):
                current._merge_dict(v.to_dict() if isinstance(v, CfgNode) else v)
            elif k in self._data or self._new_allowed:
                self._data[k] = _validate(v, k)
            else:
                raise KeyError(f"Non-existent config key: {k}")

    def to_dict(self) -> Dict[str, Any]:
        def convert(v: Any) -> Any:
            if isinstance(v, CfgNode):
                return v.to_dict()
            if isinstance(v, list):
                return [convert(i) for i in v]
            return v

        return {k: convert(v) for k, v in self._data.items()}

    def dump(self, **kwargs: Any) -> str:
        """The node as YAML (block style, keys in insertion order), as the
        JAX package's ``CN.dump`` writes a run's setting.yaml."""
        import yaml

        kwargs.setdefault("default_flow_style", False)
        kwargs.setdefault("sort_keys", False)
        return yaml.safe_dump(self.to_dict(), **kwargs)


CN = CfgNode
