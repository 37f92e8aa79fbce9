"""Synthetic Velodyne-style LiDAR scans (numpy) — a copy of the JAX-free parts
of plo_tpu/io/synthetic.py, so the port and its smoke test can make the same
ground-truth-posed scans without importing the JAX package.

A world is a ground plane plus axis-aligned boxes; a scan is firing-major
(azimuth sweep from +x clockwise, all beams per firing) in the sensor frame,
x forward and z up.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def hdl64_vertical_angles(n_scans: int = 64) -> np.ndarray:
    """Beam elevation angles (degrees) matching the reference's HDL-64 ring
    model: rings 0..31 span [+2, -8.33] at 1/3 deg, rings 32..63 span
    [-8.83, -24.33] at 1/2 deg (scan_registration.cpp:990-1003)."""
    if n_scans == 64:
        upper = 2.0 - np.arange(32) / 3.0
        lower = -8.83 - np.arange(32) / 2.0
        return np.concatenate([upper, lower])
    if n_scans == 32:
        # VLP-32C table used by the reference (scan_registration.cpp:960-964).
        return np.array(
            [-25.000, -15.639, -11.310, -8.843, -7.254, -6.148, -5.333, -4.667,
             -4.000, -3.667, -3.333, -3.000, -2.667, -2.333, -2.000, -1.667,
             -1.333, -1.000, -0.667, -0.333, 0.000, 0.333, 0.667, 1.000,
             1.333, 1.667, 2.333, 2.667, 3.000, 3.333, 3.667, 4.000]
        )
    if n_scans == 16:
        return -15.0 + 2.0 * np.arange(16)
    raise ValueError(f"unsupported n_scans {n_scans}")


@dataclasses.dataclass
class SyntheticWorld:
    """Ground plane at z=0 (world frame) plus axis-aligned boxes."""

    boxes: np.ndarray  # [B, 6]: xmin, ymin, zmin, xmax, ymax, zmax
    ground_z: float = 0.0

    @staticmethod
    def corridor(seed: int = 0, n_boxes: int = 40, extent: float = 120.0) -> "SyntheticWorld":
        """A loosely urban scene: boxes scattered along a corridor in +x."""
        rng = np.random.default_rng(seed)
        cx = rng.uniform(-extent * 0.2, extent, size=n_boxes)
        cy = rng.uniform(-30.0, 30.0, size=n_boxes)
        # Keep a driving corridor |y| < 6 free of boxes.
        cy = np.where(np.abs(cy) < 6.0, np.sign(cy + 1e-9) * (np.abs(cy) + 6.0), cy)
        sx = rng.uniform(2.0, 12.0, size=n_boxes)
        sy = rng.uniform(2.0, 12.0, size=n_boxes)
        sz = rng.uniform(3.0, 15.0, size=n_boxes)
        boxes = np.stack([cx - sx / 2, cy - sy / 2, np.zeros(n_boxes), cx + sx / 2, cy + sy / 2, sz], axis=1)
        return SyntheticWorld(boxes=boxes.astype(np.float64))

    @staticmethod
    def around_path(path_xy: np.ndarray, seed: int = 0, n_boxes: int = 120,
                    clearance: float = 6.0, spread: float = 35.0) -> "SyntheticWorld":
        """Boxes scattered around an arbitrary trajectory with a guaranteed
        clear driving corridor — use for curved validation paths (a straight
        corridor world lets turning trajectories drive into walls)."""
        rng = np.random.default_rng(seed)
        anchors = path_xy[rng.integers(0, len(path_xy), size=n_boxes)]
        ang = rng.uniform(0, 2 * np.pi, size=n_boxes)
        rad = rng.uniform(clearance + 4.0, spread, size=n_boxes)
        cx = anchors[:, 0] + rad * np.cos(ang)
        cy = anchors[:, 1] + rad * np.sin(ang)
        sx = rng.uniform(2.0, 12.0, size=n_boxes)
        sy = rng.uniform(2.0, 12.0, size=n_boxes)
        sz = rng.uniform(3.0, 15.0, size=n_boxes)
        boxes = np.stack([cx - sx / 2, cy - sy / 2, np.zeros(n_boxes),
                          cx + sx / 2, cy + sy / 2, sz], axis=1)
        # Reject any box overlapping the swept corridor.
        keep = np.ones(n_boxes, bool)
        for i in range(n_boxes):
            b = boxes[i]
            nearx = np.clip(path_xy[:, 0], b[0], b[3])
            neary = np.clip(path_xy[:, 1], b[1], b[4])
            d = np.hypot(nearx - path_xy[:, 0], neary - path_xy[:, 1])
            if d.min() < clearance:
                keep[i] = False
        return SyntheticWorld(boxes=boxes[keep].astype(np.float64))

    def raycast(self, origins: np.ndarray, dirs: np.ndarray, max_range: float) -> np.ndarray:
        """Distance along each ray to the nearest surface ([R] float64;
        np.inf where nothing is hit within max_range)."""
        t_best = np.full(dirs.shape[0], np.inf)

        # Ground plane z = ground_z.
        dz = dirs[:, 2]
        oz = origins[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            t_ground = (self.ground_z - oz) / dz
        hit = (dz < -1e-9) & (t_ground > 0)
        t_best = np.where(hit, np.minimum(t_best, t_ground), t_best)

        # Boxes via the slab method, vectorized over rays x boxes.
        with np.errstate(divide="ignore"):
            inv = np.where(np.abs(dirs) > 1e-12, 1.0 / dirs, np.inf)  # [R, 3]
        lo = self.boxes[None, :, :3]  # [1, B, 3]
        hi = self.boxes[None, :, 3:]  # [1, B, 3]
        t1 = (lo - origins[:, None, :]) * inv[:, None, :]
        t2 = (hi - origins[:, None, :]) * inv[:, None, :]
        tmin = np.max(np.minimum(t1, t2), axis=2)  # [R, B]
        tmax = np.min(np.maximum(t1, t2), axis=2)
        hit_box = (tmax >= tmin) & (tmax > 0)
        t_entry = np.where(hit_box & (tmin > 0), tmin, np.inf)
        t_best = np.minimum(t_best, t_entry.min(axis=1))

        return np.where(t_best <= max_range, t_best, np.inf)


def render_scan(
    world: SyntheticWorld,
    pose: np.ndarray,
    n_scans: int = 64,
    azimuth_steps: int = 1800,
    max_range: float = 120.0,
    noise_std: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """Render one scan as [N, 4] float32 in the sensor frame (KITTI-style).

    `pose` is the 4x4 sensor-to-world transform. Point order is firing-major:
    azimuth sweep starting at +x going clockwise (matching KITTI's -atan2
    azimuth convention in scan_registration.cpp:901), all beams per firing.
    """
    rng = np.random.default_rng(seed)
    elev = np.deg2rad(hdl64_vertical_angles(n_scans))  # [H]
    azim = -2.0 * np.pi * np.arange(azimuth_steps) / azimuth_steps  # clockwise sweep

    az, el = np.meshgrid(azim, elev, indexing="ij")  # [A, H]
    dirs_sensor = np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1
    ).reshape(-1, 3)

    R, t = pose[:3, :3], pose[:3, 3]
    dirs_world = dirs_sensor @ R.T
    origins = np.broadcast_to(t, dirs_world.shape)

    dist = world.raycast(origins, dirs_world, max_range)
    ok = np.isfinite(dist)
    dist = dist + rng.normal(0.0, noise_std, size=dist.shape)
    pts = dirs_sensor[ok] * dist[ok, None]
    refl = np.full((pts.shape[0], 1), 0.5)
    return np.concatenate([pts, refl], axis=1).astype(np.float32)


def synthetic_sequence(
    n_frames: int,
    n_scans: int = 64,
    azimuth_steps: int = 1800,
    speed: float = 1.0,
    yaw_rate: float = 0.01,
    sensor_height: float = 1.7,
    seed: int = 0,
    world: Optional[SyntheticWorld] = None,
    workers: int = 1,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Generate a sequence of scans plus ground-truth poses [n_frames, 4, 4].

    The sensor drives forward at `speed` m/frame with yaw rate `yaw_rate`
    rad/frame; both may be scalars or per-frame arrays (a standstill-start
    ramp, 90-degree corners, loop-closing rectangles — the KITTI-protocol
    drill builds its turns-and-revisit path this way). `workers` > 1 renders
    the scans in that many processes (each scan has its own seed, so the
    result is the same).
    """
    # Trajectory first, so a generated world can be carved around it.
    speeds = np.broadcast_to(np.asarray(speed, np.float64), (n_frames,))
    yaw_rates = np.broadcast_to(np.asarray(yaw_rate, np.float64), (n_frames,))
    poses = np.zeros((n_frames, 4, 4))
    x, y, yaw = 0.0, 0.0, 0.0
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i] = np.array(
            [[c, -s, 0, x], [s, c, 0, y], [0, 0, 1, sensor_height], [0, 0, 0, 1.0]]
        )
        x += speeds[i] * np.cos(yaw)
        y += speeds[i] * np.sin(yaw)
        yaw += yaw_rates[i]
    if world is None:
        world = SyntheticWorld.around_path(poses[:, :2, 3], seed=seed)
    jobs = [dict(world=world, pose=poses[i], n_scans=n_scans, azimuth_steps=azimuth_steps,
                 seed=seed + i) for i in range(n_frames)]
    if workers > 1:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            scans = pool.map(_render, jobs)
    else:
        scans = [_render(j) for j in jobs]
    return scans, poses


def _render(job: dict) -> np.ndarray:
    return render_scan(**job)
