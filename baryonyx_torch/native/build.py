"""Build at first use, and load, the native LP parser library.

``lp_parser.cpp`` is compiled with ``g++`` into
``build/native/liblpparse-<source hash>.so`` at the root of the checkout
(rebuilt whenever the source changes; never into the package directory)
and loaded with ``ctypes``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

SRC = Path(__file__).resolve().parent / "lp_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

# the loaded library (or None once a build failed), by path
_loaded: Dict[str, Optional[ctypes.CDLL]] = {}


def library_path() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"liblpparse-{digest}.so"


def _build(out: Path) -> bool:
    """Compile the library to ``out``; False when there is no compiler or
    it fails (the callers then use the Python parser)."""
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return True


def load_library() -> Optional[ctypes.CDLL]:
    """The native library, built first if needed; None when unavailable."""
    out = library_path()
    key = str(out)
    if key in _loaded:
        return _loaded[key]
    lib = None
    if out.exists() or _build(out):
        try:
            lib = ctypes.CDLL(key)
        except OSError:  # built on another machine: build it here
            lib = ctypes.CDLL(key) if _build(out) else None
    if lib is not None:
        _declare(lib)
    _loaded[key] = lib
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    """Argument and result types of every exported function."""
    c_char_p = ctypes.c_char_p
    c_i32 = ctypes.c_int32
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_dp = ctypes.POINTER(ctypes.c_double)
    void_p = ctypes.c_void_p

    lib.lp_parse_file.restype = void_p
    lib.lp_parse_file.argtypes = [c_char_p]
    lib.lp_parse_buffer.restype = void_p
    lib.lp_parse_buffer.argtypes = [c_char_p, ctypes.c_size_t]
    lib.lp_error.restype = c_char_p
    lib.lp_error.argtypes = [void_p]
    for name in ("lp_maximize", "lp_n_vars", "lp_n_obj", "lp_n_quad",
                 "lp_n_cst", "lp_n_elements"):
        fn = getattr(lib, name)
        fn.restype = c_i32
        fn.argtypes = [void_p]
    lib.lp_obj_constant.restype = ctypes.c_double
    lib.lp_obj_constant.argtypes = [void_p]
    for name in ("lp_var_names", "lp_cst_labels"):
        fn = getattr(lib, name)
        fn.restype = c_char_p
        fn.argtypes = [void_p]
    for name in ("lp_var_min", "lp_var_max", "lp_var_type", "lp_obj_idx",
                 "lp_qa", "lp_qb", "lp_cst_op", "lp_cst_rhs", "lp_cst_start",
                 "lp_el_var", "lp_el_coef"):
        fn = getattr(lib, name)
        fn.restype = c_i32p
        fn.argtypes = [void_p]
    for name in ("lp_obj_coef", "lp_qcoef"):
        fn = getattr(lib, name)
        fn.restype = c_dp
        fn.argtypes = [void_p]
    lib.lp_free.restype = None
    lib.lp_free.argtypes = [void_p]


def native_available() -> bool:
    return load_library() is not None
