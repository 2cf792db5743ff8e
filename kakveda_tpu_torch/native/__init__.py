"""ctypes bindings for the port's C++ host tier (``src/native.cc``).

The library speeds up three host-side hot loops around the card:
signature-text featurization (every ingest batch and every warn batch
embeds its texts on the host before the device scatter), the GFKB's
append-only persistence (a group-commit writer) and host-tier scoring
(:func:`score_block` / :func:`score_candidates` / :func:`score_gather`:
the sparse-dot cosine under the routed match past the card's hot cap and
every degraded-mode warn, ``index/tiers.py``; the gather form scores
candidate row ids in place from the warm arrays or a cold memmap shard).
ctypes releases the GIL for the duration of each foreign call.

The source is a copy of the JAX package's ``native/src/native.cc``, built
here with ``g++`` at first use under
the reference's exact flags (its ``Makefile``: ``-O3 -fPIC -std=c++17
-Wall -Wextra -pthread -shared``; no ``-march=native``, no
``-ffast-math``), so the port's native embeddings equal the reference's
native embeddings bit for bit. The library goes into
``kakveda_tpu_torch/native/build/`` (git-ignored) under a name keyed by a
hash of the source and the flags: an edited source rebuilds, an unchanged
one loads as it is.

Everything here is optional: ``load()`` returns None when the library
cannot be built or loaded, and every consumer falls back to the pure
Python implementation. ``KAKVEDA_NATIVE=0`` forces the fallback,
``KAKVEDA_NATIVE=require`` fails loudly instead of falling back.
Scoring knobs: ``KAKVEDA_NATIVE_THREADS`` (0 = one per CPU, capped at 16)
and ``KAKVEDA_NATIVE_MIN_ROWS`` (the row floor below which the numpy path
wins: thread and ctypes overhead dominate tiny scans).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("kakveda.native")

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "src" / "native.cc"
BUILD_DIR = _DIR / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_lock = threading.Lock()


def _mode() -> str:
    return os.environ.get("KAKVEDA_NATIVE", "auto").lower()


def lib_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libkakveda_native-{h}.so"


def _build(so: Path) -> bool:
    """Compile the library with ``g++`` into ``so`` (via a temporary file,
    so a concurrent process never loads a half-written library)."""
    cxx = shutil.which("g++")
    if cxx is None:
        log.debug("native build skipped: no g++")
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        log.debug("native build failed: %s", e)
        tmp.unlink(missing_ok=True)
        return False


def load() -> Optional[ctypes.CDLL]:
    """The shared library, building it on first use; None if unavailable
    (``KAKVEDA_NATIVE=require``: raise instead)."""
    global _lib, _load_attempted
    with _lock:
        if _lib is not None:
            return _lib
        if _load_attempted:
            return None
        _load_attempted = True
        env = _mode()
        if env in ("0", "false", "off"):
            return None
        so = lib_path()
        if not so.exists() and not _build(so):
            if env == "require":
                raise RuntimeError("KAKVEDA_NATIVE=require but the native library cannot be built")
            return None
        try:
            lib = ctypes.CDLL(str(so))
            _bind(lib)
        except (OSError, AttributeError) as e:
            if env == "require":
                raise
            log.warning("native library unusable (%s); using the Python fallback", e)
            return None
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.kkv_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.kkv_crc32.restype = ctypes.c_uint32
    lib.kkv_encode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_char_p,
    ]
    lib.kkv_encode_batch.restype = ctypes.c_int
    lib.kkv_encode_sparse_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_char_p,
    ]
    lib.kkv_encode_sparse_batch.restype = ctypes.c_int
    lib.kkv_log_open.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.kkv_log_open.restype = ctypes.c_void_p
    lib.kkv_log_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.kkv_log_append.restype = ctypes.c_int
    lib.kkv_log_flush.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.kkv_log_flush.restype = ctypes.c_int
    lib.kkv_log_close.argtypes = [ctypes.c_void_p]
    lib.kkv_log_close.restype = None
    lib.kkv_score_block.argtypes = [
        _PF, ctypes.c_long, ctypes.c_int, _PI32, _PF, ctypes.c_long, ctypes.c_int, _PF, ctypes.c_int,
    ]
    lib.kkv_score_block.restype = ctypes.c_int
    lib.kkv_score_candidates.argtypes = [
        _PF, ctypes.c_long, ctypes.c_int, _PI32, _PF, _PI64, ctypes.c_int, _PF, ctypes.c_int,
    ]
    lib.kkv_score_candidates.restype = ctypes.c_int
    lib.kkv_score_gather.argtypes = [
        _PF, ctypes.c_int, _PI32, _PF, ctypes.c_int, _PI64, ctypes.c_long, _PF, ctypes.c_int,
    ]
    lib.kkv_score_gather.restype = ctypes.c_int


def available() -> bool:
    return load() is not None


def status() -> dict:
    """Load/build status for /readyz: did the library load, from where,
    and under which policy. Builds nothing beyond the normal first-use
    ``load()``."""
    try:
        lib = load()
    except (RuntimeError, OSError, AttributeError):  # KAKVEDA_NATIVE=require and unusable
        lib = None
    so = lib_path()
    return {
        "available": lib is not None,
        "mode": _mode(),
        "lib": str(so) if so.exists() else None,
    }


# ---------------------------------------------------------------------------
# host-tier scoring
# ---------------------------------------------------------------------------

_PF = ctypes.POINTER(ctypes.c_float)
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PI64 = ctypes.POINTER(ctypes.c_int64)


def score_threads() -> int:
    """``KAKVEDA_NATIVE_THREADS``, resolved: 0 or unset = one per CPU,
    capped at 16 (scoring is memory-bound well before that)."""
    try:
        t = int(os.environ.get("KAKVEDA_NATIVE_THREADS", "0"))
    except ValueError:
        t = 0
    if t <= 0:
        t = os.cpu_count() or 1
    return max(1, min(t, 16))


def score_min_rows() -> int:
    """``KAKVEDA_NATIVE_MIN_ROWS``: the total-row floor below which callers
    keep the numpy path (ctypes marshalling beats the win on tiny scans)."""
    try:
        return max(0, int(os.environ.get("KAKVEDA_NATIVE_MIN_ROWS", "256")))
    except ValueError:
        return 256


def _f32c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def score_block(
    qdense: np.ndarray, idx: np.ndarray, val: np.ndarray, dim: int, *, threads: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Scores ``[B, n]`` of B dense queries (``[B, dim+1]``, pad column
    zero) over the same n fixed-width sparse rows, or None when the
    library is unavailable or the call fails (the caller runs numpy)."""
    lib = load()
    if lib is None:
        return None
    q = _f32c(qdense if qdense.ndim == 2 else qdense[None, :])
    b, n = q.shape[0], idx.shape[0]
    if q.shape[1] != dim + 1:
        return None
    idx_c = np.ascontiguousarray(idx, np.int32)
    val_c = _f32c(val)
    out = np.empty((b, n), np.float32)
    rc = lib.kkv_score_block(
        q.ctypes.data_as(_PF), b, dim, idx_c.ctypes.data_as(_PI32), val_c.ctypes.data_as(_PF),
        n, idx_c.shape[1] if idx_c.ndim == 2 else 0, out.ctypes.data_as(_PF),
        score_threads() if threads is None else threads,
    )
    if rc != 0:
        log.warning("kkv_score_block failed (rc=%d); numpy fallback", rc)
        return None
    return out[0] if qdense.ndim == 1 else out


def score_candidates(
    qdense: np.ndarray, idx: np.ndarray, val: np.ndarray, offsets: np.ndarray, dim: int,
    *, threads: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Flat scores ``[offsets[-1]]`` where query q covers candidate rows
    ``[offsets[q], offsets[q+1])``: one thread-pooled call per routed
    batch. None when unavailable or failed (the caller runs numpy)."""
    lib = load()
    if lib is None:
        return None
    q = _f32c(qdense)
    if q.ndim != 2 or q.shape[1] != dim + 1:
        return None
    off = np.ascontiguousarray(offsets, np.int64)
    idx_c = np.ascontiguousarray(idx, np.int32)
    val_c = _f32c(val)
    out = np.empty(int(off[-1]), np.float32)
    rc = lib.kkv_score_candidates(
        q.ctypes.data_as(_PF), q.shape[0], dim, idx_c.ctypes.data_as(_PI32), val_c.ctypes.data_as(_PF),
        off.ctypes.data_as(_PI64), idx_c.shape[1] if idx_c.ndim == 2 else 0, out.ctypes.data_as(_PF),
        score_threads() if threads is None else threads,
    )
    if rc != 0:
        log.warning("kkv_score_candidates failed (rc=%d); numpy fallback", rc)
        return None
    return out


def score_gather(
    qdense: np.ndarray, idx: np.ndarray, val: np.ndarray, rows: np.ndarray, dim: int,
    *, threads: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Scores ``[len(rows)]`` of one dense query over row ids gathered in
    place from a base array: the warm tier's resident ``[cap, K]`` arrays
    or a cold shard's memmap (pages fault in inside the C call). Strictly
    zero-copy on idx/val: a dtype or layout mismatch returns None rather
    than copying a multi-GB shard. Out-of-range row ids return None."""
    lib = load()
    if lib is None:
        return None
    q = _f32c(qdense)
    if q.ndim != 1 or q.shape[0] != dim + 1:
        return None
    if (
        idx.ndim != 2 or val.ndim != 2
        or idx.dtype != np.int32 or val.dtype != np.float32
        or not idx.flags["C_CONTIGUOUS"] or not val.flags["C_CONTIGUOUS"]
    ):
        return None
    r = np.ascontiguousarray(rows, np.int64)
    if len(r) and (int(r.min()) < 0 or int(r.max()) >= idx.shape[0]):
        return None
    out = np.empty(len(r), np.float32)
    rc = lib.kkv_score_gather(
        q.ctypes.data_as(_PF), dim, idx.ctypes.data_as(_PI32), val.ctypes.data_as(_PF),
        idx.shape[1], r.ctypes.data_as(_PI64), len(r), out.ctypes.data_as(_PF),
        score_threads() if threads is None else threads,
    )
    if rc != 0:
        log.warning("kkv_score_gather failed (rc=%d); numpy fallback", rc)
        return None
    return out


class AppendLog:
    """Buffered append-only log with explicit group-commit flush.

    Pure-Python fallback when the native library is absent — same API, one
    ``open`` file object with Python-side buffering.
    """

    def __init__(self, path: str | os.PathLike, flush_bytes: int = 1 << 20):
        self._path = str(path)
        self._lib = load()
        self._h = None
        self._f = None
        if self._lib is not None:
            self._h = self._lib.kkv_log_open(self._path.encode(), flush_bytes)
        if self._h is None:
            self._lib = None
            self._f = open(self._path, "ab", buffering=flush_bytes)

    @property
    def native(self) -> bool:
        return self._h is not None

    def append(self, record: bytes) -> None:
        """Append one record (caller includes the trailing newline)."""
        if self._h is not None:
            if self._lib.kkv_log_append(self._h, record, len(record)) != 0:
                raise OSError(f"native append failed: {self._path}")
        else:
            self._f.write(record)

    def flush(self, fsync: bool = False) -> None:
        if self._h is not None:
            if self._lib.kkv_log_flush(self._h, 1 if fsync else 0) != 0:
                raise OSError(f"native flush failed: {self._path}")
        else:
            self._f.flush()
            if fsync:
                os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._h is not None:
            self._lib.kkv_log_close(self._h)
            self._h = None
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
