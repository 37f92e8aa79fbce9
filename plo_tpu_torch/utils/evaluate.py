"""Absolute trajectory error (numpy) — a copy of `align_umeyama` and `ate_rmse`
from plo_tpu/utils/evaluate.py, kept here so the port never imports the JAX
package."""
from __future__ import annotations

import numpy as np


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
