"""Host-side scan I/O and packing: the port of plo_tpu/native.

  * `load_bin_padded` and `ScanPrefetcher`: the C++ KITTI .bin loader and
    its threaded double-buffered prefetcher (loader.cpp, a copy of the
    loader and prefetcher parts of plo_tpu/native/loader.cpp), built with
    g++ into plo_tpu_torch/_build/ at first use and bound with ctypes. A
    failed build raises with the compiler's output; unlike plo_tpu, nothing
    falls back to NumPy in silence.
  * int16: xyz in 5 mm fixed point (`quantize_pack`, the NumPy form in
    plo_tpu/models/odometry.py's process_scans);
  * grid16: the [n_scans, width] uint16 raster of quantized 3D range, 0 =
    empty, the nearest return wins a cell (`rasterize_grid16_numpy`).
The two packers are NumPy copies of plo_tpu's NumPy forms (its C++ forms
round and keep edge beams differently).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from plo_tpu_torch.ops.preprocess import VLP32C_ANGLES

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "loader.cpp")
LIBRARY = os.path.join(os.path.dirname(_DIR), "_build", "libploloader.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded loader library, built first if missing or older than its
    source (into a temporary name, then renamed, so concurrent processes
    never load a half-written file)."""
    global _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(LIBRARY)
                    or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
                os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
                tmp = f"{LIBRARY}.{os.getpid()}.tmp"
                proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                                       SOURCE, "-o", tmp], capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed to build the scan loader "
                                       f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, LIBRARY)
            lib = ctypes.CDLL(LIBRARY)
            fp, i64, vp = ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_void_p
            lib.plo_load_bin.restype = i64
            lib.plo_load_bin.argtypes = [ctypes.c_char_p, fp, i64]
            lib.plo_prefetcher_create.restype = vp
            lib.plo_prefetcher_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), i64, i64]
            lib.plo_prefetcher_next.restype = i64
            lib.plo_prefetcher_next.argtypes = [vp, fp]
            lib.plo_prefetcher_destroy.restype = None
            lib.plo_prefetcher_destroy.argtypes = [vp]
            _lib = lib
    return _lib


def _float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_bin_padded(path: str, capacity: int) -> Tuple[np.ndarray, int]:
    """One KITTI .bin (float32 x, y, z, reflectance) as a zero-padded
    [capacity, 4] float32 array and its point count, at most `capacity`
    (the points past it are dropped)."""
    out = np.zeros((capacity, 4), np.float32)
    n = library().plo_load_bin(path.encode(), _float_ptr(out), capacity)
    if n < 0:
        raise FileNotFoundError(path)
    return out, int(n)


class ScanPrefetcher:
    """Iterates (padded [capacity, 4] scan, point count) over `paths`: a
    native thread reads and pads the next scan while the caller works on the
    current one. The path array stays referenced while the thread reads it;
    `close()` (or garbage collection) joins the thread."""

    def __init__(self, paths: List[str], capacity: int):
        self.paths = list(paths)
        self.capacity = capacity
        self._lib = library()
        self._keepalive = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        self._handle = self._lib.plo_prefetcher_create(self._keepalive, len(self.paths), capacity)
        self._served = 0

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, int]:
        if self._handle is None:
            raise StopIteration
        out = np.empty((self.capacity, 4), np.float32)
        n = self._lib.plo_prefetcher_next(self._handle, _float_ptr(out))
        if n == -2:
            raise StopIteration
        if n < 0:
            raise FileNotFoundError(self.paths[self._served])
        self._served += 1
        return out, int(n)

    def close(self):
        if self._handle is not None:
            self._lib.plo_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def quantize_pack(raw: np.ndarray, inv_scale: float, out: np.ndarray) -> int:
    """Quantize one scan's xyz into a zeroed int16 [capacity, 3] row; returns
    the point count (at most the capacity). f32 throughout: rint + clip map
    NaN and inf to +-32767, which the 150 m range gate then drops on the
    device."""
    n = min(len(raw), out.shape[0])
    q = np.clip(np.rint(raw[:n, :3].astype(np.float32) * np.float32(inv_scale)),
                -32767.0, 32767.0)
    out[:n] = np.nan_to_num(q, nan=32767.0).astype(np.int16)
    return n


def rasterize_grid16_numpy(raw: np.ndarray, n_scans: int, width: int,
                           inv_scale: float, min_range: float,
                           max_range: float, out: np.ndarray) -> int:
    """Rasterize one raw scan [n, >=3] into `out` [n_scans, width] uint16
    (rings by the Velodyne formulas, columns by the azimuth fraction, the
    smallest quantized range wins a cell); returns the occupied-cell count."""
    xyz = raw[:, :3].astype(np.float64)
    finite = np.isfinite(xyz).all(axis=1)
    r2d = np.hypot(xyz[:, 0], xyz[:, 1])
    r3d = np.sqrt(r2d * r2d + xyz[:, 2] ** 2)
    ok = finite & (r3d >= min_range) & (r3d <= max_range)
    ang = np.degrees(np.arctan2(xyz[:, 2], np.maximum(r2d, 1e-12)))
    if n_scans == 16:
        ring = np.floor((ang + 15.0) / 2.0 + 0.5).astype(np.int64)
        ok &= (ring >= 0) & (ring < 16)
    elif n_scans == 32:
        ring = np.abs(ang[:, None] - VLP32C_ANGLES[None, :]).argmin(axis=1).astype(np.int64)
    else:
        ok &= (ang <= 2.0) & (ang >= -24.33)
        rhi = np.floor((2.0 - ang) * 3.0 + 0.5).astype(np.int64)
        rlo = 32 + np.floor((-8.83 - ang) * 2.0 + 0.5).astype(np.int64)
        ring = np.where(ang >= -8.83, rhi, rlo)
        ok &= (ring >= 0) & (ring <= 50)
    frac = (-np.arctan2(xyz[:, 1], xyz[:, 0])) / (2 * np.pi)
    frac -= np.floor(frac)
    col = (np.rint(frac * width).astype(np.int64)) % width
    q = np.minimum(np.rint(r3d * inv_scale), 65535).astype(np.uint16)
    q = np.maximum(q, 1)
    out[:] = 0
    cell = ring[ok] * width + col[ok]
    flat = out.reshape(-1)
    order = np.argsort(q[ok], kind="stable")[::-1]  # min wins: write descending
    flat[cell[order]] = q[ok][order]
    return int((flat > 0).sum())
