"""ctypes binding of the native task-packing engine (``native/taskpack.cpp``).

Counterpart of ``deepsensornz_tpu/native/taskpack.py``: the same C entry
points, :func:`pack_station_batches` (per-date padded station batches) and
:func:`interp_grid_points_native` (bilinear gather of a grid at points).

The library is compiled at first use from the repository's
``native/taskpack.cpp`` with ``g++ -O3 -std=c++17 -shared -fPIC`` into
``deepsensornz_tpu_torch/_build/``; its name carries a hash of the source and
flags. The compiler writes a temporary file that is renamed into place, so
processes that build at once never load a half-written library. When the
build or the load fails, :func:`build_error` says why and the loader takes
its Python path. :func:`call_counts` counts the calls that ran natively
(the perf recorder's ``taskpack.`` counters).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from deepsensornz_tpu_torch.perf import spans

SOURCE = Path(__file__).resolve().parents[2] / "native" / "taskpack.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None
_CALLS = ("pack_station_batches", "interp_grid_points")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libtaskpack_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    path = library_path()
    if path.is_file():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".taskpack_", suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise OSError(f"g++ failed with code {proc.returncode}: {proc.stderr.strip()}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None (and :func:`build_error`) when
    it cannot be built or loaded. A failure is not retried."""
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is not None or _ERROR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError) as e:
            _ERROR = f"{type(e).__name__}: {e}"
            return None
        i64, f32, f64 = (ctypes.POINTER(t) for t in (ctypes.c_int64, ctypes.c_float,
                                                    ctypes.c_double))
        lib.pack_station_batches.restype = ctypes.c_int
        lib.pack_station_batches.argtypes = [
            i64, f32, f32, f32,               # times, x1, x2, values
            ctypes.c_int64, ctypes.c_int64,   # n_rows, n_cols
            i64, ctypes.c_int64,              # dates, n_dates
            ctypes.c_int64, ctypes.c_int,     # capacity, mode
            ctypes.c_double, ctypes.c_int64,  # frac, count
            ctypes.c_uint64,                  # seed
            f32, f32, f32, i64,               # out_x, out_y, out_mask, out_counts
        ]
        lib.interp_grid_points.restype = None
        lib.interp_grid_points.argtypes = [f32, ctypes.c_int64, ctypes.c_int64,
                                           f64, f64, f64, f64, ctypes.c_int64, f32]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    _load()
    return _ERROR


def call_counts() -> dict:
    counts = spans.counters("taskpack.")
    return {k: counts.get(f"taskpack.{k}", 0) for k in _CALLS}


def reset_call_counts() -> None:
    spans.reset("taskpack.")


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def pack_station_batches(times: np.ndarray, x1: np.ndarray, x2: np.ndarray,
                         values: np.ndarray, dates: np.ndarray, capacity: int,
                         mode: str = "all", frac: float = 1.0, count: int = 0,
                         seed: int = 0):
    """Per-date padded batches of station rows: (x (B,cap,2), y (B,cap,C),
    mask (B,cap), counts (B,)), or None without the library. ``times`` and
    ``dates`` are datetime64 (compared at second resolution)."""
    lib = _load()
    if lib is None:
        return None
    t = np.ascontiguousarray(np.asarray(times).astype("datetime64[s]").astype(np.int64))
    d = np.ascontiguousarray(np.asarray(dates).astype("datetime64[s]").astype(np.int64))
    x1 = np.ascontiguousarray(x1, np.float32)
    x2 = np.ascontiguousarray(x2, np.float32)
    values = np.ascontiguousarray(values, np.float32)
    R, C = values.shape
    if not len(t) == len(x1) == len(x2) == R:
        raise ValueError("times, x1, x2 and values must have one row each")
    B = len(d)
    out_x = np.empty((B, capacity, 2), np.float32)
    out_y = np.empty((B, capacity, C), np.float32)
    out_mask = np.empty((B, capacity), np.float32)
    out_counts = np.empty((B,), np.int64)
    mode_i = {"all": 0, "fraction": 1, "count": 2}[mode]
    rc = lib.pack_station_batches(
        _ptr(t, ctypes.c_int64), _ptr(x1, ctypes.c_float), _ptr(x2, ctypes.c_float),
        _ptr(values, ctypes.c_float), R, C, _ptr(d, ctypes.c_int64), B,
        capacity, mode_i, float(frac), int(count), int(seed) & (2**64 - 1),
        _ptr(out_x, ctypes.c_float), _ptr(out_y, ctypes.c_float),
        _ptr(out_mask, ctypes.c_float), _ptr(out_counts, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f"station rows exceed capacity {capacity} for at least one date")
    spans.count("taskpack.pack_station_batches")
    return out_x, out_y, out_mask, out_counts


def interp_grid_points_native(grid: np.ndarray, g1: np.ndarray, g2: np.ndarray,
                              px1: np.ndarray, px2: np.ndarray):
    """Bilinear gather of the (h, w) ``grid`` on ascending coordinates
    ``g1``/``g2`` at the points (px1, px2), edge-clamped, NaN read as 0;
    None without the library."""
    lib = _load()
    if lib is None:
        return None
    grid = np.ascontiguousarray(grid, np.float32)
    g1 = np.ascontiguousarray(g1, np.float64)
    g2 = np.ascontiguousarray(g2, np.float64)
    px1 = np.ascontiguousarray(px1, np.float64)
    px2 = np.ascontiguousarray(px2, np.float64)
    if grid.shape != (len(g1), len(g2)) or len(px1) != len(px2):
        raise ValueError("grid must be (len(g1), len(g2)) and px1, px2 of one length")
    out = np.empty(len(px1), np.float32)
    lib.interp_grid_points(_ptr(grid, ctypes.c_float), grid.shape[0], grid.shape[1],
                           _ptr(g1, ctypes.c_double), _ptr(g2, ctypes.c_double),
                           _ptr(px1, ctypes.c_double), _ptr(px2, ctypes.c_double),
                           len(px1), _ptr(out, ctypes.c_float))
    spans.count("taskpack.interp_grid_points")
    return out
