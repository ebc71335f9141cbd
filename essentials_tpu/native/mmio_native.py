"""ctypes binding for the native .mtx parser (libetpu_mmio.so)."""

from __future__ import annotations

import ctypes
import os

import numpy as np

_DIR = os.path.dirname(__file__)
_SO = os.path.join(_DIR, "libetpu_mmio.so")

_lib = None
_build_error = None


def _build_lib() -> bool:
    """Build the native parser in place (checkouts ship sources, not .so
    artifacts). One `make` invocation, serialized by an exclusive lockfile
    so parallel test workers don't race the compiler."""
    import subprocess
    global _build_error
    try:
        with open(os.path.join(_DIR, ".build.lock"), "w") as lk:
            try:
                import fcntl
                fcntl.flock(lk, fcntl.LOCK_EX)
            except ImportError:
                pass
            if not os.path.exists(_SO):
                subprocess.run(["make", "-C", _DIR], check=True,
                               capture_output=True, timeout=300)
    except subprocess.CalledProcessError as e:
        # surface compiler diagnostics instead of the generic ImportError
        tail = (e.stderr or b"").decode(errors="replace")[-2000:]
        _build_error = f"`make -C {_DIR}` failed:\n{tail}"
        return False
    except (OSError, subprocess.TimeoutExpired) as e:
        _build_error = f"{type(e).__name__}: {e}"
        return False
    return os.path.exists(_SO)


class _EtpuCoo(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("rows", ctypes.POINTER(ctypes.c_int32)),
        ("cols", ctypes.POINTER(ctypes.c_int32)),
        ("vals", ctypes.POINTER(ctypes.c_float)),
        ("err", ctypes.c_char * 256),
    ]


def _load_lib():
    global _lib
    if _lib is None:
        if not os.path.exists(_SO):
            _build_lib()
        if not os.path.exists(_SO):
            raise ImportError(f"native mmio library not built ({_SO}); "
                              f"run: make -C essentials_tpu/native "
                              f"({_build_error})")
        _lib = ctypes.CDLL(_SO)
        _lib.etpu_load_mtx.restype = ctypes.POINTER(_EtpuCoo)
        _lib.etpu_load_mtx.argtypes = [ctypes.c_char_p, ctypes.c_int]
        _lib.etpu_coo_free.argtypes = [ctypes.POINTER(_EtpuCoo)]
    return _lib


def available() -> bool:
    return os.path.exists(_SO)


def load_mtx(path: str, expand_symmetric: bool = True):
    """Returns (n_rows, n_cols, rows, cols, vals) or raises.

    Returns None when the file needs the Python fallback (array format)."""
    lib = _load_lib()
    ptr = lib.etpu_load_mtx(path.encode(), int(expand_symmetric))
    if not ptr:
        raise MemoryError("etpu_load_mtx allocation failure")
    c = ptr.contents
    try:
        err = bytes(c.err).split(b"\0", 1)[0].decode()
        if err:
            if "coordinate format only" in err:
                return None  # caller falls back to the NumPy array-format path
            from essentials_tpu.errors import EssentialsError
            raise EssentialsError(f"mtx parse error ({path}): {err}")
        n = int(c.nnz)
        rows = np.ctypeslib.as_array(c.rows, shape=(n,)).copy()
        cols = np.ctypeslib.as_array(c.cols, shape=(n,)).copy()
        vals = np.ctypeslib.as_array(c.vals, shape=(n,)).copy()
        return int(c.n_rows), int(c.n_cols), rows, cols, vals
    finally:
        lib.etpu_coo_free(ptr)
