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
    def planetary(seed: int = 0, n_rocks: int = 8, extent: float = 50.0,
                  rock_size: Tuple[float, float] = (0.3, 1.0)) -> "SyntheticWorld":
        """Sparse planetary terrain (the reference's target domain,
        README.md:77,127): a flat ground plane with a handful of sub-meter
        rocks. Nearly every surface normal is +z, so point-to-plane
        constraints pin only {z, roll, pitch}; x/y/yaw are degenerate up to
        the few rock returns — the regime DRPM (solver.cpp:486-603) exists
        for."""
        rng = np.random.default_rng(seed)
        cx = rng.uniform(2.0, extent, n_rocks)
        cy = rng.uniform(-extent * 0.3, extent * 0.3, n_rocks)
        s = rng.uniform(rock_size[0], rock_size[1], n_rocks)
        boxes = np.stack([cx - s / 2, cy - s / 2, np.zeros(n_rocks),
                          cx + s / 2, cy + s / 2, s * 0.8], axis=1)
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


def write_kitti_layout(root: str, scans: List[np.ndarray], poses_velo: np.ndarray,
                       seq: str = "00", tr: Optional[np.ndarray] = None) -> np.ndarray:
    """Write scans and ground truth in the KITTI odometry benchmark layout
    (sequences/<seq>/velodyne/NNNNNN.bin, poses/<seq>.txt, calib.txt), so the
    `--dataset kitti` path of the CLI runs end to end without the dataset.

    The ground-truth poses are written in the cam0 frame (T_cam = Tr T_velo
    Tr^-1) with a non-trivial velodyne->cam0 extrinsic by default, so the
    reader's calib conjugation (io/kitti.py: poses_to_velodyne_frame) is
    exercised: the evaluation lines up only if the round trip is right.
    Returns the Tr used."""
    import os

    if tr is None:
        # A KITTI-like axis permutation (velodyne x forward, z up -> cam0 z
        # forward, y down) and a small lever arm.
        tr = np.array([[0.0, -1.0, 0.0, -0.02],
                       [0.0, 0.0, -1.0, -0.08],
                       [1.0, 0.0, 0.0, 0.27],
                       [0.0, 0.0, 0.0, 1.0]])
    vdir = os.path.join(root, "sequences", seq, "velodyne")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    for i, s in enumerate(scans):
        s.astype(np.float32).tofile(os.path.join(vdir, f"{i:06d}.bin"))
    poses_cam = np.einsum("ij,njk,kl->nil", tr, poses_velo, np.linalg.inv(tr))
    with open(os.path.join(root, "poses", f"{seq}.txt"), "w") as f:
        for p in poses_cam:
            f.write(" ".join(f"{v:.9e}" for v in p[:3, :4].reshape(-1)) + "\n")
    with open(os.path.join(root, "sequences", seq, "calib.txt"), "w") as f:
        f.write("P0: " + " ".join(["0"] * 12) + "\n")
        f.write("Tr: " + " ".join(f"{v:.9e}" for v in tr[:3, :4].reshape(-1)) + "\n")
    return tr


def rectangle_loop_profile(n_straight: int = 20, n_turn: int = 24,
                           speed: float = 1.2, turn_speed_factor: float = 0.7,
                           laps: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame (speeds, yaw_rates) for a closed rectangular loop — four
    straights and four 90-degree turns per lap, ending back at the start.
    The default turn rate is 90 deg / 24 frames = 3.75 deg a frame. The run
    starts from rest: the speed ramps in over the first 6 frames, and speed
    and yaw steps are low-passed (a cold start at full speed is the
    catastrophic regime in which the first frame's correspondences fall
    outside the anchor gate)."""
    seg_speed = np.concatenate([np.full(n_straight, speed),
                                np.full(n_turn, speed * turn_speed_factor)])
    seg_yaw = np.concatenate([np.zeros(n_straight),
                              np.full(n_turn, (np.pi / 2) / n_turn)])
    speeds = np.tile(seg_speed, 4 * laps)
    yaw_rates = np.tile(seg_yaw, 4 * laps)
    ramp = min(6, len(speeds))
    speeds[:ramp] *= np.linspace(0.25, 1.0, ramp)
    kern = np.ones(5) / 5.0
    speeds = np.convolve(speeds, kern, mode="same")
    yaw_rates = np.convolve(yaw_rates, kern, mode="same")
    return speeds, yaw_rates


def trajectory(n_frames: int, speed=1.0, yaw_rate=0.01,
               sensor_height: float = 1.7) -> np.ndarray:
    """The ground-truth poses [n_frames, 4, 4] of synthetic_sequence: the
    sensor drives forward at `speed` m a frame turning at `yaw_rate` rad a
    frame (scalars or per-frame arrays)."""
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
    return poses


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
    noise_std: float = 0.01,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Generate a sequence of scans plus ground-truth poses [n_frames, 4, 4].

    The sensor drives forward at `speed` m/frame with yaw rate `yaw_rate`
    rad/frame; both may be scalars or per-frame arrays (a standstill-start
    ramp, 90-degree corners, loop-closing rectangles — the KITTI-protocol
    drill builds its turns-and-revisit path this way). `workers` > 1 renders
    the scans in that many processes (each scan has its own seed, so the
    result is the same). `noise_std` is the range noise of every scan
    (tools/method_matrix.py renders its sequence at 0.02 m).
    """
    # Trajectory first, so a generated world can be carved around it.
    poses = trajectory(n_frames, speed, yaw_rate, sensor_height)
    if world is None:
        world = SyntheticWorld.around_path(poses[:, :2, 3], seed=seed)
    jobs = [dict(world=world, pose=poses[i], n_scans=n_scans, azimuth_steps=azimuth_steps,
                 seed=seed + i, noise_std=noise_std) for i in range(n_frames)]
    if workers > 1:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            scans = pool.map(_render, jobs)
    else:
        scans = [_render(j) for j in jobs]
    return scans, poses


def _render(job: dict) -> np.ndarray:
    return render_scan(**job)


def _interpolate_pose(T: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """exp(alpha * log(T)) with linear translation, in float32 as
    plo_tpu.geometry.interpolate_pose computes it. T [4, 4], alpha [N];
    returns [N, 4, 4]."""
    T = T.astype(np.float32)
    R = T[:3, :3]
    cos_theta = np.clip((np.trace(R) - np.float32(1.0)) / np.float32(2.0), -1.0, 1.0)
    theta = np.arccos(cos_theta)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]], np.float32)
    scale = (theta / np.maximum(np.float32(2.0) * np.sin(theta), np.float32(1e-12))
             if theta > 1e-6 else np.float32(0.5))
    aw = alpha[:, None] * (w * np.float32(scale))                   # [N, 3]
    th = np.maximum(np.linalg.norm(aw, axis=-1, keepdims=True), np.float32(1e-12))
    x, y, z = (aw / th).T
    zero = np.zeros_like(x)
    k = np.stack([np.stack([zero, -z, y], -1), np.stack([z, zero, -x], -1),
                  np.stack([-y, x, zero], -1)], axis=-2)           # [N, 3, 3]
    s, c = np.sin(th)[..., None], np.cos(th)[..., None]
    out = np.zeros((len(alpha), 4, 4), np.float32)
    out[:, :3, :3] = np.eye(3, dtype=np.float32) + s * k + (np.float32(1.0) - c) * (k @ k)
    out[:, :3, 3] = alpha[:, None] * T[:3, 3]
    out[:, 3, 3] = 1.0
    return out


def distort_sequence(scans: List[np.ndarray], gt: np.ndarray,
                     n_scans: int) -> List[np.ndarray]:
    """Per-point sweep-motion distortion (plo_tpu.io.synthetic.
    distort_sequence): a point fired at sweep fraction t is observed from
    the interpolated pose interp(rel, t), so inv(T_t) maps it into the
    end-of-sweep frame. Frame 0 takes frame 1's constant-velocity rel."""
    out = []
    for i, s in enumerate(scans):
        rel = np.linalg.inv(gt[max(i - 1, 0)]) @ gt[max(i, 1)]
        t = (np.arange(len(s)) // n_scans) / max(len(s) // n_scans, 1)
        Tinv = np.linalg.inv(_interpolate_pose(rel, t.astype(np.float32)))
        xyz = np.einsum("pij,pj->pi", Tinv[:, :3, :3],
                        s[:, :3].astype(np.float64)) + Tinv[:, :3, 3]
        s2 = s.copy()
        s2[:, :3] = xyz.astype(np.float32)
        out.append(s2)
    return out


def add_outliers(scans: List[np.ndarray], rng: np.random.Generator,
                 frac: float = 0.01, extent: float = 40.0) -> List[np.ndarray]:
    """Replace `frac` of each scan's points with uniform dynamic outliers."""
    out = []
    for s in scans:
        s2 = s.copy()
        n_out = int(len(s2) * frac)
        idx = rng.integers(0, len(s2), n_out)
        s2[idx, :3] = rng.uniform(-extent, extent, (n_out, 3)).astype(np.float32)
        out.append(s2)
    return out


def hardened_sequence(n_frames: int = 6):
    """The method matrix's sequence (tools/method_matrix.py): the corridor
    world at 32 beams x 450, 2 cm range noise, sweep distortion and 1 %
    dynamic outliers. Returns (scans, ground truth relative to frame 0)."""
    world = SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic_sequence(n_frames, n_scans=32, azimuth_steps=450, speed=0.4,
                                   yaw_rate=0.01, seed=3, world=world, noise_std=0.02)
    scans = add_outliers(distort_sequence(scans, gt, 32), np.random.default_rng(5))
    return scans, np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
