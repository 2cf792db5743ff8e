"""Device-side profiling hooks: ``torch.profiler`` traces and NVTX ranges.

Counterpart of ``kakveda_tpu/core/profiling.py`` (which labels XPlane
traces through ``jax.profiler``), under the same names and rules:

- ``annotate(name)``: a ``torch.profiler.record_function`` range, plus an
  NVTX range when a card is present, around a hot entry point (GFKB
  match / insert / mining delta, Llama generate), so a trace reads in
  product terms; the block's host wall also lands on the metrics plane as
  ``kakveda_device_block_seconds{name=...}`` under the same name.
- ``profile(logdir)``: a ``torch.profiler.profile`` of the enclosed block
  (CPU, and CUDA when a card is present), written into ``logdir`` as a
  Chrome trace (``chrome://tracing`` or Perfetto reads it).
- ``KAKVEDA_PROFILE_DIR``: when set, the service captures a trace of one
  warm pre-flight warn at startup (``service/main.py``).

Every hook degrades to a no-op when the profiler cannot start; none may
break the work it wraps.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch

log = logging.getLogger("kakveda.profiling")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label the enclosed work in the profiler's timeline (and, on the
    card, in NVTX), and observe its host wall as
    ``kakveda_device_block_seconds{name=name}``. Only the setup and the
    teardown are guarded: the ``yield`` stays outside any ``try``/
    ``except``, so an exception from the enclosed work surfaces unchanged."""
    rf = None
    nvtx = False
    try:
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            nvtx = True
    except Exception:  # noqa: BLE001 - profiling must never break the hot path
        pass
    t0 = time.perf_counter()
    try:
        yield
    finally:
        try:
            if nvtx:
                torch.cuda.nvtx.range_pop()
            if rf is not None:
                rf.__exit__(None, None, None)
        except Exception:  # noqa: BLE001
            pass
        try:
            from kakveda_tpu_torch.core import metrics as _metrics

            _metrics.device_block(name, time.perf_counter() - t0)
        except Exception:  # noqa: BLE001 - metrics must never break the hot path
            pass


@contextlib.contextmanager
def profile(logdir) -> Iterator[None]:
    """Capture a trace of the enclosed block into ``logdir`` (created if
    missing) as ``trace-<pid>-<ns>.json``, a Chrome trace."""
    prof = None
    try:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001
        log.warning("profiler unavailable: %s", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                path = os.path.join(str(logdir), f"trace-{os.getpid()}-{time.time_ns()}.json")
                prof.export_chrome_trace(path)
                log.info("device trace written to %s", path)
            except Exception as e:  # noqa: BLE001
                log.warning("profiler stop failed: %s", e)


def startup_profile_dir() -> Optional[str]:
    return os.environ.get("KAKVEDA_PROFILE_DIR") or None
