"""KITTI odometry dataset reader (velodyne .bin scans and ground-truth
poses) — the port of plo_tpu/io/kitti.py. Scans are read from the odometry
benchmark layout:

    <root>/sequences/<seq>/velodyne/NNNNNN.bin   (float32 x, y, z, reflectance)
    <root>/sequences/<seq>/calib.txt             (Tr: velodyne -> cam0)
    <root>/poses/<seq>.txt                       (3x4 row-major cam0 poses)
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """One KITTI velodyne scan as [N, 4] float32 (x, y, z, reflectance)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_poses(path: str) -> np.ndarray:
    """KITTI ground-truth poses as [N, 4, 4] float64."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4, dtype=np.float64), (rows.shape[0], 1, 1))
    poses[:, :3, :4] = rows
    return poses


def read_calib_tr(path: str) -> np.ndarray:
    """The velodyne->cam0 extrinsic `Tr` of a sequence's calib.txt as a 4x4.
    Ground truth lives in the cam0 frame; odometry in the velodyne frame
    compares through T_velo = Tr^-1 T_cam Tr."""
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = np.array(line.split(":", 1)[1].split(), dtype=np.float64)
                tr = np.eye(4)
                tr[:3, :4] = vals.reshape(3, 4)
                return tr
    raise ValueError(f"no 'Tr' line in {path}")


def poses_to_velodyne_frame(poses_cam: np.ndarray, tr: np.ndarray) -> np.ndarray:
    """Conjugate cam0-frame ground-truth poses into the velodyne frame."""
    return np.einsum("ij,njk,kl->nil", np.linalg.inv(tr), poses_cam, tr)


def kitti_scan_iterator(root: str, sequence: str = "00", start: int = 0,
                        count: Optional[int] = None,
                        capacity: Optional[int] = None) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (frame index, [N, 4] points) for a KITTI sequence.

    With `capacity`, the scans come through the native prefetcher (the next
    .bin is read and padded on a C++ thread while the current scan is
    processed), each the first n rows of a [capacity, 4] array; a scan
    larger than the capacity is cut to it. Without, each is read whole with
    NumPy."""
    vdir = os.path.join(root, "sequences", sequence, "velodyne")
    files = sorted(f for f in os.listdir(vdir) if f.endswith(".bin"))
    files = files[start:] if count is None else files[start:start + count]
    idxs = [int(os.path.splitext(f)[0]) for f in files]
    if capacity is not None:
        from plo_tpu_torch import native

        prefetcher = native.ScanPrefetcher([os.path.join(vdir, f) for f in files], capacity)
        try:
            for idx, (scan, n) in zip(idxs, prefetcher):
                yield idx, scan[:n]
        finally:
            prefetcher.close()
        return
    for idx, f in zip(idxs, files):
        yield idx, read_velodyne_bin(os.path.join(vdir, f))
