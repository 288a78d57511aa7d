"""ctypes loader for the repository's native C++ library (native/libfortseq.so).

The port binds the Fortran sequential-record codec of obs/io.py and the
bucket sort of ops/obs_select.py build_buckets. The library is built from
native/fortseq.cpp with native/Makefile on first use if a toolchain is
available; callers handle `load() is None` and take their numpy path.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB = None
_TRIED = False


def load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = _NATIVE_DIR / "libfortseq.so"
    if not so.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None

    lib.fortseq_read_f32.restype = ctypes.c_long
    lib.fortseq_read_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.fortseq_read_scalars_f32.restype = ctypes.c_int
    lib.fortseq_read_scalars_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.fortseq_write_f32.restype = ctypes.c_int
    lib.fortseq_write_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ctypes.c_int]
    lib.fortseq_count_f32.restype = ctypes.c_long
    lib.fortseq_count_f32.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                      ctypes.c_int]
    lib.bucket_sort.restype = ctypes.c_long
    lib.bucket_sort.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    lib.bucket_max_count.restype = ctypes.c_int
    lib.bucket_max_count.argtypes = lib.bucket_sort.argtypes[:-2]
    _LIB = lib
    return _LIB
