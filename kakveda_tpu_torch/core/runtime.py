"""Env-driven runtime configuration, structured logging, request ids.

A copy of ``kakveda_tpu/core/runtime.py`` (which imports no JAX; the port
imports nothing of the JAX package): one frozen RuntimeConfig per service,
JSON structured logs with service/request_id/duration fields, and a
request-id helper. The port's service reads ``data_dir``,
``index_capacity``, ``request_id_header`` and the logging knobs; the other
fields keep the reference's shape.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
import uuid
from dataclasses import dataclass
from typing import Any, Mapping, Optional


def _env(name: str, default: Optional[str] = None) -> Optional[str]:
    v = os.environ.get(name)
    if v is None:
        return default
    v = str(v).strip()
    return v if v != "" else default


def _env_bool(name: str, default: bool = False) -> bool:
    v = _env(name)
    if v is None:
        return default
    return v.lower() in {"1", "true", "yes", "y", "on"}


def _env_int(name: str, default: int) -> int:
    v = _env(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        return default


@dataclass(frozen=True)
class RuntimeConfig:
    env: str
    log_level: str
    log_format: str
    request_id_header: str

    # Security / secrets
    dashboard_jwt_secret: str

    # Storage
    data_dir: str

    # TPU intelligence core
    model_runtime: str  # stub | tpu | ollama
    index_capacity: int
    mesh_shape: str  # e.g. "data:8" or "data:4,model:2"

    # Observability
    otel_enabled: bool
    otel_service_name: str
    otel_exporter_otlp_endpoint: Optional[str]


def get_runtime_config(*, service_name: str) -> RuntimeConfig:
    env = (_env("KAKVEDA_ENV", _env("ENV", "dev")) or "dev").lower()
    return RuntimeConfig(
        env=env,
        log_level=(_env("KAKVEDA_LOG_LEVEL", "INFO") or "INFO").upper(),
        log_format=(_env("KAKVEDA_LOG_FORMAT", "json") or "json").lower(),
        request_id_header=(_env("KAKVEDA_REQUEST_ID_HEADER", "x-request-id") or "x-request-id").lower(),
        dashboard_jwt_secret=_env("DASHBOARD_JWT_SECRET", "dev-secret-change-me") or "dev-secret-change-me",
        data_dir=_env("KAKVEDA_DATA_DIR", "data") or "data",
        model_runtime=(_env("KAKVEDA_MODEL_RUNTIME", "stub") or "stub").lower(),
        index_capacity=_env_int("KAKVEDA_INDEX_CAPACITY", 1 << 17),
        mesh_shape=_env("KAKVEDA_MESH_SHAPE", "data:-1") or "data:-1",
        otel_enabled=_env_bool("KAKVEDA_OTEL_ENABLED", default=False),
        otel_service_name=_env("OTEL_SERVICE_NAME", service_name) or service_name,
        otel_exporter_otlp_endpoint=_env("OTEL_EXPORTER_OTLP_ENDPOINT"),
    )


def _json_record(level: str, msg: str, extra: Optional[Mapping[str, Any]] = None) -> str:
    body: dict[str, Any] = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "level": level,
        "msg": msg,
    }
    if extra:
        for k, v in extra.items():
            if v is not None:
                body[k] = v
    return json.dumps(body, ensure_ascii=False)


class _JsonFormatter(logging.Formatter):
    def __init__(self, service_name: str):
        super().__init__()
        self._service = service_name

    def format(self, record: logging.LogRecord) -> str:
        extra: dict[str, Any] = {"logger": record.name, "service": self._service}
        for key in ("request_id", "path", "method", "status_code", "duration_ms"):
            if hasattr(record, key):
                extra[key] = getattr(record, key)
        if record.exc_info and record.exc_info[0] is not None:
            # Server-side exceptions (aiohttp logs them with exc_info) must
            # reach the JSON stream — a 500 with no traceback in the logs
            # is undebuggable in production.
            extra["exc"] = self.formatException(record.exc_info)
        return _json_record(record.levelname, record.getMessage(), extra)


def setup_logging(*, service_name: str) -> None:
    cfg = get_runtime_config(service_name=service_name)
    root = logging.getLogger()
    root.setLevel(getattr(logging, cfg.log_level, logging.INFO))
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream=sys.stdout)
    if cfg.log_format == "json":
        handler.setFormatter(_JsonFormatter(service_name))
    else:
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
    root.addHandler(handler)


def ensure_request_id(incoming: Optional[str] = None) -> str:
    v = (incoming or "").strip()
    if v:
        return v[:128]
    return uuid.uuid4().hex
