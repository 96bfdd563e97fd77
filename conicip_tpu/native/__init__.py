"""ctypes bindings for the native (C++) host-side kernels.

The shared library is not committed: it is built on first use from
``native/pivoted_qr.cpp`` at the repo root (``make -C native``), under a
lock so that concurrent processes build it once, into a temporary file
renamed into place. If the toolchain or source tree is absent the callers
fall back to scipy implementations.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _REPO_ROOT / "native"
_LIB_NAME = "libconicip_native.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = _NATIVE_DIR / _LIB_NAME
    if not so.exists() and (_NATIVE_DIR / "pivoted_qr.cpp").exists():
        try:
            _build(so)
        except Exception:
            return None
    if not so.exists():
        return None
    try:
        lib = ctypes.CDLL(str(so))
        lib.cip_pivoted_qr.restype = ctypes.c_int
        lib.cip_pivoted_qr.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long),
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def _build(so: Path) -> None:
    dir_fd = os.open(_NATIVE_DIR, os.O_RDONLY)
    try:
        fcntl.flock(dir_fd, fcntl.LOCK_EX)  # released when the fd closes
        if so.exists():  # another process built it while we waited
            return
        tmp = f"{_LIB_NAME}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR), f"TARGET={tmp}"],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(_NATIVE_DIR / tmp, so)
        finally:
            (_NATIVE_DIR / tmp).unlink(missing_ok=True)
    finally:
        os.close(dir_fd)


def pivoted_qr_rank(
    A: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Column-pivoted QR rank data via the native kernel.

    Returns ``(rdiag, piv)`` — |R_kk| for k < min(m,n) and the column
    permutation — or None if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    A = np.ascontiguousarray(A, dtype=np.float64).copy()
    m, n = A.shape
    rdiag = np.zeros(min(m, n), dtype=np.float64)
    piv = np.zeros(n, dtype=np.int64)
    rc = lib.cip_pivoted_qr(
        A.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long(m),
        ctypes.c_long(n),
        rdiag.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        piv.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    if rc != 0:
        return None
    return rdiag, piv


def available() -> bool:
    return _load() is not None
