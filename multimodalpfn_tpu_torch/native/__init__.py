"""Native (C) host-runtime components.

The device compute path is PyTorch and CUDA; these modules accelerate host-side
work that the profiler showed hot and that numpy cannot vectorize.  Every
native component has a pure-Python twin and is loaded best-effort: any
build/load failure silently falls back (correctness is never native-gated).

Currently: `fingerprint` — batch BLAKE2b-64 row hashing for
AddFingerprintFeaturesStep (see fingerprint.c for the parity contract).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fingerprint.c")
_LIB_PATH = os.path.join(_DIR, f"_fingerprint_py{sys.version_info[0]}{sys.version_info[1]}.so")

_lock = threading.Lock()
_lib = None
_load_attempted = False


def _build() -> bool:
    """Compile fingerprint.c -> _fingerprint*.so (one-time, ~0.3 s)."""
    compiler = os.environ.get("CC", "cc")
    # Write to a temp file in the same dir, then atomic-rename, so concurrent
    # processes (pytest-xdist, HPO workers) never load a half-written .so.
    tmp = None
    try:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
        os.close(fd)
        subprocess.run(
            [compiler, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=60,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        # read-only install dir, missing compiler, ... -> pure-Python fallback
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return False


def _load():
    global _lib, _load_attempted
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("MMPFN_TPU_NO_NATIVE", "") not in ("", "0"):
            return None
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.fp_hash_rows.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.fp_hash_rows.restype = None
            lib.fp_blake2b64.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.fp_blake2b64.restype = ctypes.c_uint64
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def hash_rows(X: np.ndarray) -> "np.ndarray | None":
    """Batch `_stable_float_hash` over the rows of a 2-D array.

    Returns a float64 vector of per-row hashes in [0, 1) computed natively,
    or None when the native library is unavailable (caller falls back to the
    Python loop).  Bit-exact with hashing each row's `.tobytes()` via
    hashlib.blake2b(digest_size=8) — pinned by tests/test_native_fingerprint.py.
    """
    lib = _load()
    if lib is None or X.ndim != 2:
        return None
    X = np.ascontiguousarray(X)
    n, _ = X.shape
    out = np.empty(n, dtype=np.float64)
    lib.fp_hash_rows(
        X.ctypes.data_as(ctypes.c_char_p),
        n,
        X.shape[1] * X.itemsize,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def blake2b64(data: bytes) -> "int | None":
    """Native blake2b(digest_size=8) as a little-endian int, or None."""
    lib = _load()
    if lib is None:
        return None
    return int(lib.fp_blake2b64(data, len(data)))
