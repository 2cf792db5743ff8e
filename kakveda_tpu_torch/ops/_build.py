"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``kakveda_tpu_torch/csrc/<name>.cu`` is one shared library with a plain
C interface, compiled by ``nvcc`` for ``sm_90a`` into
``kakveda_tpu_torch/csrc/build/`` (git-ignored) under a name keyed by a hash
of its source and flags, so an edited kernel rebuilds and an unchanged one
loads as it is. The flash kernel builds as one library per head_dim,
``flash_gqa_cache:<d>`` for each d of ``FLASH_HEAD_DIMS``, compiled with
``-DKKV_HEAD_DIM=<d>``, so its instantiations compile in parallel.
``build()`` starts one ``nvcc`` per target, all at once. No ``nvcc``, or a
failed build, raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source: a software fault, which the
    device-loss latch never mistakes for the card failing."""

_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")
    return path


FLASH_HEAD_DIMS = (32, 64, 96, 128, 256)  # one flash library each


def targets() -> list:
    """Every library the sources make: ``<name>``, or ``flash_gqa_cache:<d>``
    for each head_dim of the flash kernel."""
    out = []
    for src in sorted(CSRC.glob("*.cu")):
        out += [f"{src.stem}:{d}" for d in FLASH_HEAD_DIMS] if src.stem == "flash_gqa_cache" else [src.stem]
    return out


def _flags(name: str) -> tuple:
    head_dim = name.partition(":")[2]
    return NVCC_FLAGS + ((f"-DKKV_HEAD_DIM={head_dim}",) if head_dim else ())


def _target(name: str) -> Path:
    stem, _, head_dim = name.partition(":")
    src = CSRC / f"{stem}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}{'-' + head_dim if head_dim else ''}-{h}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named target (``<name>`` or ``<name>:<head_dim>``) that
    has no up-to-date library, one ``nvcc`` process each, all started
    together. Returns name → library path; the compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside each
    library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        so = _target(name)
        out[name] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = open(so.with_suffix(".log"), "w")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name.partition(':')[0]}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (rc={rc}, see {out[name].with_suffix('.log')}):\n"
                          + out[name].with_suffix(".log").read_text()[-4000:])
            continue
        os.replace(tmp, out[name])
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of a target (``<name>`` or ``<name>:<head_dim>``),
    built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
