"""Host-side packing of scans for the compact transfers, in NumPy: the port's
copy of plo_tpu.native's NumPy forms (importing that package imports JAX,
and the port builds no C++ loader).

  * int16: xyz in 5 mm fixed point (`quantize_pack`, the NumPy form in
    plo_tpu/models/odometry.py's process_scans);
  * grid16: the [n_scans, width] uint16 raster of quantized 3D range, 0 =
    empty, the nearest return wins a cell (`rasterize_grid16_numpy`).
"""
from __future__ import annotations

import numpy as np

from plo_tpu_torch.ops.preprocess import VLP32C_ANGLES


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
