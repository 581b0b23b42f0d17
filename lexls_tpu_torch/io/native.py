"""ctypes bindings to the native hierarchy loader.

The shared library is built on demand from ``native/src/hierarchy_io.cpp``
with ``make`` (no external dependencies; ~1 s compile, cached next to the
sources, where the JAX package's loader finds it too).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "liblexls_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    src = os.path.join(_NATIVE_DIR, "src", "hierarchy_io.cpp")
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-s"],
            check=True, capture_output=True, timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None

        lib.lexls_io_parse_file.restype = ctypes.c_void_p
        lib.lexls_io_parse_file.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.lexls_io_parse_string.restype = ctypes.c_void_p
        lib.lexls_io_parse_string.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_int]
        lib.lexls_io_free.argtypes = [ctypes.c_void_p]
        for name in ("hier_type", "n_var", "n_obj", "has_sol_guess", "has_solution"):
            fn = getattr(lib, f"lexls_io_{name}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
        for name in ("n_ctr", "obj_type"):
            fn = getattr(lib, f"lexls_io_{name}")
            fn.restype = ctypes.POINTER(ctypes.c_int32)
            fn.argtypes = [ctypes.c_void_p]
        for name in ("obj_rows", "obj_cols"):
            fn = getattr(lib, f"lexls_io_{name}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lexls_io_obj_data.restype = ctypes.POINTER(ctypes.c_double)
        lib.lexls_io_obj_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lexls_io_obj_as_guess.restype = ctypes.POINTER(ctypes.c_int32)
        lib.lexls_io_obj_as_guess.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for name in ("sol_guess", "solution"):
            fn = getattr(lib, f"lexls_io_{name}")
            fn.restype = ctypes.POINTER(ctypes.c_double)
            fn.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def parse_file_native(path: str):
    """Parse a .dat file with the native loader.

    Returns the same tuple as :func:`lexls_tpu_torch.io.dat._parse_python`, or
    raises RuntimeError (parse errors) / OSError (loader unavailable)."""
    lib = _load()
    if lib is None:
        raise OSError("native loader not available")
    err = ctypes.create_string_buffer(512)
    h = lib.lexls_io_parse_file(path.encode(), err, len(err))
    if not h:
        raise RuntimeError(err.value.decode())
    try:
        hier_type = lib.lexls_io_hier_type(h)
        n_var = lib.lexls_io_n_var(h)
        n_obj = lib.lexls_io_n_obj(h)
        n_ctr = np.ctypeslib.as_array(lib.lexls_io_n_ctr(h), (n_obj,)).copy()
        obj_type = np.ctypeslib.as_array(lib.lexls_io_obj_type(h), (n_obj,)).copy()
        objectives = []
        as_guess = []
        for i in range(n_obj):
            r = lib.lexls_io_obj_rows(h, i)
            c = lib.lexls_io_obj_cols(h, i)
            objectives.append(
                np.ctypeslib.as_array(lib.lexls_io_obj_data(h, i), (r, c)).copy())
            g = lib.lexls_io_obj_as_guess(h, i)
            as_guess.append(np.ctypeslib.as_array(g, (r,)).copy() if g else None)
        sol_guess = (np.ctypeslib.as_array(lib.lexls_io_sol_guess(h), (n_var,)).copy()
                     if lib.lexls_io_has_sol_guess(h) else None)
        solution = (np.ctypeslib.as_array(lib.lexls_io_solution(h), (n_var,)).copy()
                    if lib.lexls_io_has_solution(h) else None)
    finally:
        lib.lexls_io_free(h)
    if all(g is None for g in as_guess):
        as_guess = None
    return hier_type, n_var, n_obj, n_ctr, obj_type, objectives, as_guess, sol_guess, solution
