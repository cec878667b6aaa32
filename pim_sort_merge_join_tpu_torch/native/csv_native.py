"""ctypes bindings of the port's native CSV parser and formatter.

`csv_parser.cpp` (beside this module, the port's own copy of the JAX
package's parser) is compiled with ``g++ -O3 -shared -fPIC -pthread`` at
first use into ``build/native/`` at the root of the checkout, under a
name that carries a hash of the source and the flags, so a stale build is
never loaded; a lock across processes (`utils/build_lock.py`) holds the
check and the build, so processes that reach first use together build
once, and the library is written under a temporary name and moved into
place, so no reader sees a partial file. Without a compiler
`available` is False and the callers in `columnar/csv_io.py` keep their
numpy path, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from pim_sort_merge_join_tpu_torch.utils.build_lock import build_lock

SOURCE = Path(__file__).resolve().with_name("csv_parser.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _threads() -> int:
    return min(os.cpu_count() or 1, 16)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsmjcsv_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the parser if no library for the current source exists;
    raises `RuntimeError` when the compiler is missing or fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native CSV parser needs a C++ compiler")
    with build_lock(BUILD_DIR):
        if not path.exists():  # another process may have built it meanwhile
            _compile(cxx, path)
    return path


def _compile(cxx: str, path: Path) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    done = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({done.returncode}):\n{done.stderr}")
    os.replace(tmp, path)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        i64p, u64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64)
        signatures = {
            "csv_probe_cols": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64]),
            "csv_count_rows": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64]),
            "csv_parse_i64": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64, i64p,
                                             ctypes.c_int64, ctypes.c_int, ctypes.c_int]),
            "csv_format_i64": (ctypes.c_int64, [i64p, ctypes.c_int64, ctypes.c_int,
                                                ctypes.c_char_p, ctypes.c_int]),
            "csv_format_u64": (ctypes.c_int64, [u64p, ctypes.c_int64, ctypes.c_int,
                                                ctypes.c_char_p, ctypes.c_int]),
        }
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_csv(path: str) -> Optional[np.ndarray]:
    """Parse an integer CSV (with header) into a row-major int64 array, or
    None without the library; raises `ValueError` on a malformed file."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        raw = f.read()
    n = len(raw)
    ncol = lib.csv_probe_cols(raw, n)
    nrow = lib.csv_count_rows(raw, n)
    if ncol <= 0 or nrow < 0:
        return None
    out = np.empty((nrow, ncol), dtype=np.int64)
    rc = lib.csv_parse_i64(
        raw, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nrow, ncol, _threads()
    )
    if rc != 0:
        raise ValueError(
            f"malformed CSV {path!r}: row/field structure does not match "
            f"header ({ncol} columns, {nrow} rows expected)"
        )
    return out


def format_csv_body(array: np.ndarray) -> Optional[bytes]:
    """Format a row-major integer array as CSV body bytes (no header), or
    None without the library. uint64 prints unsigned; every other integer
    type through int64."""
    lib = _load()
    if lib is None:
        return None
    unsigned = array.dtype == np.uint64
    arr = np.ascontiguousarray(array, dtype=np.uint64 if unsigned else np.int64)
    nrow, ncol = arr.shape
    if nrow == 0:
        return b""
    buf = ctypes.create_string_buffer(nrow * ncol * 21)
    fmt, ptr = ((lib.csv_format_u64, ctypes.c_uint64) if unsigned
                else (lib.csv_format_i64, ctypes.c_int64))
    size = fmt(arr.ctypes.data_as(ctypes.POINTER(ptr)), nrow, ncol, buf, _threads())
    return buf.raw[:size]
