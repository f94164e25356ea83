"""ctypes binding for the C++ golden SGM oracle (golden/cpp/sgm.cpp).

Builds on first use with make (OpenMP where the compiler links it) — no
pybind11 in this environment, and the C ABI + ctypes keeps the native
tier dependency-free.  API mirrors
golden/sgm.py; every function is bit-exact against the NumPy oracle
(tests/unit/test_cpp_golden.py).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent / "cpp"
_LIB = _DIR / "libsgm_golden.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB.exists() or _LIB.stat().st_mtime < (_DIR / "sgm.cpp").stat().st_mtime:
        subprocess.run(["make", "-C", str(_DIR)], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(str(_LIB))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    c = ctypes.c_int
    c64 = ctypes.c_int64
    lib.census_u64.argtypes = [u8p, c, c, c, c, u64p]
    lib.cost_volume_stereo.argtypes = [u64p, u64p, c, c, c, c64, i64p]
    lib.aggregate_one_path.argtypes = [i64p, u8p, c, c, c, c, c, c64, c64,
                                       c, i64p]
    lib.aggregate_paths.argtypes = [i64p, u8p, c, c, c, i32p, c, c64, c64,
                                    c, i64p]
    lib.wta.argtypes = [i64p, c, c, c, i32p]
    lib.cost_volume_flow.argtypes = [u64p, u64p, i32p, i32p, c, c, c, c64,
                                     i64p]
    lib.aggregate_paths_2d.argtypes = [i64p, u8p, c, c, c, i32p, c, c64,
                                       c64, c, i64p]
    _lib = lib
    return lib


def census_transform(img: np.ndarray, window=(5, 5)) -> np.ndarray:
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    out = np.empty((h, w), dtype=np.uint64)
    lib.census_u64(img, h, w, window[0], window[1], out)
    return out


def cost_volume_stereo(cen_l, cen_r, max_disp: int,
                       invalid_cost: int = 255) -> np.ndarray:
    lib = _load()
    cen_l = np.ascontiguousarray(cen_l, dtype=np.uint64)
    cen_r = np.ascontiguousarray(cen_r, dtype=np.uint64)
    h, w = cen_l.shape
    out = np.empty((h, w, max_disp), dtype=np.int64)
    lib.cost_volume_stereo(cen_l, cen_r, h, w, max_disp, invalid_cost, out)
    return out


def aggregate_one_path(cost, img, direction, p1, p2,
                       adaptive_p2=False) -> np.ndarray:
    lib = _load()
    cost = np.ascontiguousarray(cost, dtype=np.int64)
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, nd = cost.shape
    out = np.empty_like(cost)
    lib.aggregate_one_path(cost, img, h, w, nd, direction[0], direction[1],
                           p1, p2, int(adaptive_p2), out)
    return out


def aggregate_paths(cost, img, dirs, p1, p2, adaptive_p2=False) -> np.ndarray:
    lib = _load()
    cost = np.ascontiguousarray(cost, dtype=np.int64)
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, nd = cost.shape
    dirs_a = np.ascontiguousarray(dirs, dtype=np.int32)
    out = np.empty_like(cost)
    lib.aggregate_paths(cost, img, h, w, nd, dirs_a, len(dirs), p1, p2,
                        int(adaptive_p2), out)
    return out


def wta(s) -> np.ndarray:
    lib = _load()
    s = np.ascontiguousarray(s, dtype=np.int64)
    h, w, nd = s.shape
    out = np.empty((h, w), dtype=np.int32)
    lib.wta(s, h, w, nd, out)
    return out


def cost_volume_flow(cen1, cen2, base_u, base_v, radius: int,
                     invalid_cost: int = 255) -> np.ndarray:
    lib = _load()
    cen1 = np.ascontiguousarray(cen1, dtype=np.uint64)
    cen2 = np.ascontiguousarray(cen2, dtype=np.uint64)
    h, w = cen1.shape
    bu = np.ascontiguousarray(base_u, dtype=np.int32)
    bv = np.ascontiguousarray(base_v, dtype=np.int32)
    ext = 2 * radius + 1
    out = np.empty((h, w, ext * ext), dtype=np.int64)
    lib.cost_volume_flow(cen1, cen2, bu, bv, h, w, radius, invalid_cost,
                         out)
    return out


def aggregate_paths_2d(cost, img, radius: int, dirs, p1, p2,
                       adaptive_p2=False) -> np.ndarray:
    lib = _load()
    cost = np.ascontiguousarray(cost, dtype=np.int64)
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, _ = cost.shape
    dirs_a = np.ascontiguousarray(dirs, dtype=np.int32)
    out = np.empty_like(cost)
    lib.aggregate_paths_2d(cost, img, h, w, radius, dirs_a, len(dirs),
                           p1, p2, int(adaptive_p2), out)
    return out
