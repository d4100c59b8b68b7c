"""ctypes bindings for the native helpers (native/parse_sdpa.cpp).

Built by native/build.sh into proxsdp_tpu/utils/_native.so.  All functions
degrade gracefully: importers catch exceptions and fall back to pure
Python (see models/sdplib.py).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "_native.so")

_lib = None


def _build():
    """Compile native/parse_sdpa.cpp next to this module (fresh checkouts
    ship no build artifacts).  The library is written under a temporary
    name and renamed into place, so a killed build never leaves a broken
    ``_native.so``.  Raises on failure; callers fall back to Python."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    src = os.path.join(root, "native", "parse_sdpa.cpp")
    tmp = f"{_LIB_PATH}.tmp{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib
    if _lib is None:
        if not os.path.exists(_LIB_PATH):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.sdpa_parse.restype = ctypes.c_void_p
        lib.sdpa_parse.argtypes = [ctypes.c_char_p]
        lib.sdpa_n.restype = ctypes.c_int64
        lib.sdpa_n.argtypes = [ctypes.c_void_p]
        lib.sdpa_m.restype = ctypes.c_int64
        lib.sdpa_m.argtypes = [ctypes.c_void_p]
        lib.sdpa_nnz.restype = ctypes.c_int64
        lib.sdpa_nnz.argtypes = [ctypes.c_void_p]
        lib.sdpa_c.restype = ctypes.POINTER(ctypes.c_double)
        lib.sdpa_c.argtypes = [ctypes.c_void_p]
        lib.sdpa_entries.restype = ctypes.POINTER(ctypes.c_double)
        lib.sdpa_entries.argtypes = [ctypes.c_void_p]
        lib.sdpa_free.restype = None
        lib.sdpa_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def parse_sdpa(path: str):
    """Parse a .dat-s file -> (n, m, entries(nnz,4), c(m,)).

    Same output convention as the Python parser in models/sdplib.py.
    Raises on any failure (caller falls back).
    """
    lib = _load()
    h = lib.sdpa_parse(path.encode())
    if not h:
        raise IOError(f"native parse failed: {path}")
    try:
        n = int(lib.sdpa_n(h))
        m = int(lib.sdpa_m(h))
        nnz = int(lib.sdpa_nnz(h))
        c = np.ctypeslib.as_array(lib.sdpa_c(h), shape=(m,)).copy()
        entries = np.ctypeslib.as_array(
            lib.sdpa_entries(h), shape=(nnz, 4)
        ).copy()
    finally:
        lib.sdpa_free(h)
    return n, m, entries, c
