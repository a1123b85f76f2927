"""TOML configuration loader with environment overrides.

The port's copy of seaweedfs_tpu/utils/config.py (weed/util/config.go:20-47,
viper): ``<name>.toml`` is looked for in ".", "~/.seaweedfs" and
"/etc/seaweedfs", the first hit wins, and a ``WEED_<SECTION>_<KEY>``
environment variable overrides what the file says (the convention the
reference's docker compose files rely on).  Files are parsed with the
standard library's ``tomllib``; the reference's fallback parser for
interpreters without it is not ported: on Python 3.10 ``load_toml``
raises.
"""

from __future__ import annotations

import os
from typing import Any, Optional

try:  # the standard library's since 3.11
    import tomllib
except ImportError:  # pragma: no cover - version-dependent
    tomllib = None

SEARCH_DIRS = [".", os.path.expanduser("~/.seaweedfs"), "/etc/seaweedfs"]


class Configuration:
    def __init__(self, data: Optional[dict] = None, source: str = ""):
        self.data = data or {}
        self.source = source

    def get(self, dotted_key: str, default: Any = None) -> Any:
        """viper-style lookup: 'jwt.signing.key' walks nested tables, and a
        WEED_JWT_SIGNING_KEY environment variable overrides the file."""
        env = "WEED_" + dotted_key.upper().replace(".", "_").replace("-", "_")
        if env in os.environ:
            return _coerce(os.environ[env], default)
        node: Any = self.data
        for part in dotted_key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_string(self, key: str, default: str = "") -> str:
        return str(self.get(key, default))

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        return v if isinstance(v, bool) else str(v).lower() in ("1", "true",
                                                                "yes")

    def get_int(self, key: str, default: int = 0) -> int:
        try:
            return int(self.get(key, default))
        except (TypeError, ValueError):
            return default


def _coerce(value: str, default: Any) -> Any:
    """An environment value typed as the default is."""
    if isinstance(default, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        try:
            return int(value)
        except ValueError:
            return default
    return value


def load_toml(path: str) -> dict:
    if tomllib is None:  # pragma: no cover - version-dependent
        raise RuntimeError(f"{path}: reading TOML needs Python 3.11+")
    with open(path, "rb") as f:
        return tomllib.load(f)


def load_configuration(name: str, search_dirs: Optional[list[str]] = None
                       ) -> Configuration:
    """util/config.go LoadConfiguration: <name>.toml from the search path;
    an empty Configuration when there is none."""
    for d in (search_dirs if search_dirs is not None else SEARCH_DIRS):
        path = os.path.join(d, f"{name}.toml")
        if os.path.isfile(path):
            return Configuration(load_toml(path), source=path)
    return Configuration()
