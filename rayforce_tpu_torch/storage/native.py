"""ctypes bindings for the native C++ runtime (native/rayforce_native.cpp).

The shared library is built on first use with g++ (cached beside the
source); every entry point degrades gracefully to the pure-Python path
when the toolchain or binary is unavailable. The threading model
mirrors the reference's pool_map chunking (core/pool.c:509): each
exported function splits rows across std::thread workers internally.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native",
    "rayforce_native.cpp")
_SO = os.path.join(os.path.dirname(_SRC), "librayforce_native.so")


def _build() -> bool:
    try:
        if os.path.exists(_SO) and \
                os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
            return True
        r = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread",
             "-std=c++17", "-o", _SO, _SRC],
            capture_output=True, timeout=120)
        if r.returncode != 0:
            print("rayforce-tpu: native build failed:",
                  r.stderr.decode()[:400], file=sys.stderr)
            return False
        return True
    except Exception:
        return False


def lib():
    """The loaded native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SRC):
        return None
    if not _build():
        return None
    try:
        L = ctypes.CDLL(_SO)
    except OSError:
        return None
    c_char_p = ctypes.c_char_p
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    L.rf_count_lines.restype = i64
    L.rf_count_lines.argtypes = [c_char_p, i64]
    L.rf_index_lines.restype = i64
    L.rf_index_lines.argtypes = [c_char_p, i64, p_i64, i64]
    L.rf_parse_i64.restype = None
    L.rf_parse_i64.argtypes = [c_char_p, i64, p_i64, i64,
                               ctypes.c_int, ctypes.c_char, p_i64, i64]
    L.rf_parse_f64.restype = None
    L.rf_parse_f64.argtypes = [c_char_p, i64, p_i64, i64,
                               ctypes.c_int, ctypes.c_char, p_f64]
    L.rf_parse_date.restype = None
    L.rf_parse_date.argtypes = [c_char_p, i64, p_i64, i64,
                                ctypes.c_int, ctypes.c_char, p_i32,
                                i32]
    L.rf_parse_time.restype = None
    L.rf_parse_time.argtypes = [c_char_p, i64, p_i64, i64,
                                ctypes.c_int, ctypes.c_char, p_i32,
                                i32]
    L.rf_parse_timestamp.restype = None
    L.rf_parse_timestamp.argtypes = [c_char_p, i64, p_i64, i64,
                                     ctypes.c_int, ctypes.c_char,
                                     p_i64, i64]
    L.rf_parse_b8.restype = None
    L.rf_parse_b8.argtypes = [c_char_p, i64, p_i64, i64,
                              ctypes.c_int, ctypes.c_char,
                              np.ctypeslib.ndpointer(
                                  np.int8, flags="C_CONTIGUOUS")]
    L.rf_min_fields.restype = i64
    L.rf_min_fields.argtypes = [c_char_p, i64, p_i64, i64,
                                ctypes.c_char]
    L.rf_field_spans.restype = None
    L.rf_field_spans.argtypes = [c_char_p, i64, p_i64, i64,
                                 ctypes.c_int, ctypes.c_char, p_i64,
                                 p_i32]
    L.rf_fill_fixed.restype = None
    L.rf_fill_fixed.argtypes = [c_char_p, p_i64, p_i32, i64, i32,
                                p_u8]
    L.rf_max_len.restype = i32
    L.rf_max_len.argtypes = [p_i32, i64]
    _LIB = L
    return _LIB


class NativeCsv:
    """One parsed CSV buffer: line index once, typed columns on demand."""

    def __init__(self, data: bytes, sep: str = ","):
        self.L = lib()
        if self.L is None:
            raise RuntimeError("native lib unavailable")
        self.data = data
        self.sep = sep.encode()[0:1]
        n = len(data)
        total = self.L.rf_count_lines(data, n)
        self.starts = np.empty(total, dtype=np.int64)
        cnt = self.L.rf_index_lines(data, n, self.starts, total)
        self.starts = self.starts[:cnt]

    def slice_rows(self, lo: int, hi: int):
        self.starts = self.starts[lo:hi]
        return self

    @property
    def n_rows(self):
        return len(self.starts)

    def col_i64(self, col: int, nullv: int) -> np.ndarray:
        out = np.empty(self.n_rows, dtype=np.int64)
        self.L.rf_parse_i64(self.data, len(self.data), self.starts,
                            self.n_rows, col, self.sep, out, nullv)
        return out

    def col_b8(self, col: int) -> np.ndarray:
        out = np.empty(self.n_rows, dtype=np.int8)
        self.L.rf_parse_b8(self.data, len(self.data), self.starts,
                           self.n_rows, col, self.sep, out)
        return out

    def min_fields(self) -> int:
        """Minimum field count over non-blank data lines."""
        return int(self.L.rf_min_fields(self.data, len(self.data),
                                        self.starts, self.n_rows,
                                        self.sep))

    def col_f64(self, col: int) -> np.ndarray:
        out = np.empty(self.n_rows, dtype=np.float64)
        self.L.rf_parse_f64(self.data, len(self.data), self.starts,
                            self.n_rows, col, self.sep, out)
        return out

    def col_date(self, col: int, nullv: int) -> np.ndarray:
        out = np.empty(self.n_rows, dtype=np.int32)
        self.L.rf_parse_date(self.data, len(self.data), self.starts,
                             self.n_rows, col, self.sep, out, nullv)
        return out

    def col_time(self, col: int, nullv: int) -> np.ndarray:
        out = np.empty(self.n_rows, dtype=np.int32)
        self.L.rf_parse_time(self.data, len(self.data), self.starts,
                             self.n_rows, col, self.sep, out, nullv)
        return out

    def col_timestamp(self, col: int, nullv: int) -> np.ndarray:
        out = np.empty(self.n_rows, dtype=np.int64)
        self.L.rf_parse_timestamp(self.data, len(self.data),
                                  self.starts, self.n_rows, col,
                                  self.sep, out, nullv)
        return out

    def col_strings(self, col: int):
        """(unique_strings, inverse_codes) via fixed-width matrix +
        np.unique — vectorized symbol interning."""
        n = self.n_rows
        off = np.empty(n, dtype=np.int64)
        ln = np.empty(n, dtype=np.int32)
        self.L.rf_field_spans(self.data, len(self.data), self.starts,
                              n, col, self.sep, off, ln)
        w = int(self.L.rf_max_len(ln, n))
        w = max(w, 1)
        mat = np.empty(n * w, dtype=np.uint8)
        self.L.rf_fill_fixed(self.data, off, ln, n, w, mat)
        mat = mat.reshape(n, w)
        view = mat.view([("s", f"S{w}")]).reshape(n)
        uniq, inv = np.unique(view, return_inverse=True)
        strs = [u[0].decode("utf-8", errors="replace") for u in uniq]
        return strs, inv.astype(np.int64)

    def col_raw(self, col: int):
        """Per-row bytes of a column (for C8 string columns)."""
        n = self.n_rows
        off = np.empty(n, dtype=np.int64)
        ln = np.empty(n, dtype=np.int32)
        self.L.rf_field_spans(self.data, len(self.data), self.starts,
                              n, col, self.sep, off, ln)
        return [self.data[off[i]:off[i] + ln[i]] for i in range(n)]
