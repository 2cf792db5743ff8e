"""Device resolution and the index store-dtype rule.

Counterpart of ``kakveda_tpu/ops/device.py``. The port's entry points run on
the CUDA card unless the caller names another device: ``device=None``
resolves to ``cuda`` and raises when no card is visible — a missing card is
an error, never a silent fall back to the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by default; "
                "pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def store_dtype(device: torch.device) -> torch.dtype:
    """Index store dtype: bf16 on the card, f32 on the CPU (the rule of
    ``kakveda_tpu/ops/knn.py`` — bf16 on the accelerator, f32 on the host)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
