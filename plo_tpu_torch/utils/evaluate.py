"""Trajectory evaluation (numpy on the host) — the port of
plo_tpu/utils/evaluate.py: ATE and RPE against ground truth, KITTI's
segment drift, and the TUM trajectory file. The reference evaluates offline
against KITTI's ground truth (README.md:76-78)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from plo_tpu_torch import geometry as geo


def align_umeyama(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """SE(3) alignment of estimated positions [N, 3] onto ground truth.
    Returns the aligned estimated positions."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    H = (est - mu_e).T @ (gt - mu_g)
    u, _, vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    S = np.diag([1.0, 1.0, d])
    R = vt.T @ S @ u.T
    t = mu_g - R @ mu_e
    return est @ R.T + t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (RMSE of translation) of [N, 4, 4] pose arrays."""
    est = est_poses[:, :3, 3]
    gt = gt_poses[:, :3, 3]
    if align:
        est = align_umeyama(est, gt)
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over frame pairs (i, i+delta). Returns
    (rmse translation [m], rmse rotation [rad])."""
    terrs, rerrs = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerrs.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(np.sqrt(np.mean(np.square(rerrs))))


def trajectory_distances(gt_poses: np.ndarray) -> np.ndarray:
    """Cumulative traveled distance [N] along the ground-truth trajectory."""
    steps = np.linalg.norm(np.diff(gt_poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def kitti_odometry_errors(est_poses: np.ndarray, gt_poses: np.ndarray,
                          lengths=(100, 200, 300, 400, 500, 600, 700, 800),
                          step: int = 10):
    """KITTI's segment-based odometry metric: for every start frame (every
    `step` frames) and every segment length L in `lengths`, the frame where
    the ground-truth travelled distance first reaches L ends the segment;
    the relative-pose error over it is normalised, translation as a fraction
    of L (the drift %), rotation in rad/m.

    Returns (t_err, r_err, per_length): the mean translational drift (a
    fraction; times 100 for %), the mean rotational drift (rad/m), and
    {L: (t_err, r_err, count)}. Segments longer than the run are skipped;
    (nan, nan, {}) when no length fits (short runs pass scaled-down
    `lengths`)."""
    dist = trajectory_distances(gt_poses)
    t_errs, r_errs = [], []
    per_length = {}
    for L in lengths:
        seg_t, seg_r = [], []
        for first in range(0, len(gt_poses), step):
            last = int(np.searchsorted(dist, dist[first] + L))
            if last >= len(gt_poses):
                break
            de = np.linalg.inv(est_poses[first]) @ est_poses[last]
            dg = np.linalg.inv(gt_poses[first]) @ gt_poses[last]
            e = np.linalg.inv(dg) @ de
            seg_t.append(np.linalg.norm(e[:3, 3]) / L)
            c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
            seg_r.append(np.arccos(c) / L)
        if seg_t:
            per_length[L] = (float(np.mean(seg_t)), float(np.mean(seg_r)), len(seg_t))
            t_errs.extend(seg_t)
            r_errs.extend(seg_r)
    if not t_errs:
        return float("nan"), float("nan"), {}
    return float(np.mean(t_errs)), float(np.mean(r_errs)), per_length


def quat_f32(pose: np.ndarray) -> np.ndarray:
    """The (x, y, z, w) quaternion of a 4x4 pose's rotation as float32 numpy:
    the rotation is cast to float32 first, as plo_tpu's saver does, so the
    printed digits are float32's shortest ones."""
    R = torch.as_tensor(np.asarray(pose)[:3, :3], dtype=torch.float32)
    return geo.quat_from_rotation(R).numpy()


def save_tum(poses: np.ndarray, timestamps, path: str):
    """TUM format: t x y z qx qy qz qw (savePoseToFile, saver.cpp)."""
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses):
            q = quat_f32(T)
            t = T[:3, 3]
            f.write(f"{ts} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")
