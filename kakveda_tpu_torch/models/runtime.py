"""The result every model runtime returns (``kakveda_tpu/models/runtime.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class GenerateResult:
    text: str
    meta: Dict[str, Any] = field(default_factory=dict)
