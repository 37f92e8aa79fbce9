"""Huber-robust Gauss-Newton point-to-plane solver (the port of
plo_tpu/solvers/gauss_newton.py) — the counterpart of the reference's Ceres
path (SolveMotionEstimationProblemCeres, solver.cpp:25-72): point-to-plane
residuals n^T (R s + t - y) under HuberLoss(0.1).

The cost is minimized by IRLS Gauss-Newton with a left-multiplied axis-angle
increment, a fixed number of iterations with no line search, as in the JAX
package. The 6x6 system is solved with `solve_ex`, which leaves the result
on the device (no host sync for an error check); a singular system gives a
non-finite delta and ok = False, as jnp.linalg.solve does.
"""
from __future__ import annotations

import torch

from plo_tpu_torch import geometry as geo

HUBER_DELTA = 0.1  # solver.cpp:46


def solve_gauss_newton(source, ref, normal, valid, max_iterations: int = 20):
    """Returns (deltaTrans 4x4, ok bool)."""
    dev = source.device
    w_valid = valid.to(torch.float32)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    R = torch.eye(3, dtype=torch.float32, device=dev)
    t = torch.zeros(3, dtype=torch.float32, device=dev)
    for _ in range(max_iterations):
        rs = source @ R.T
        r = (normal * (rs + t - ref)).sum(1)  # residuals
        absr = r.abs()
        huber_w = torch.where(absr <= HUBER_DELTA, 1.0, HUBER_DELTA / absr.clamp_min(1e-12))
        w = huber_w * w_valid
        J = torch.cat([torch.cross(rs, normal, dim=1), normal], dim=1)  # [N, 6]
        JW = J * w[:, None]
        H = JW.T @ J + 1e-8 * eye6
        dx = -torch.linalg.solve_ex(H, JW.T @ r)[0]
        R = geo.exp_so3(dx[:3]) @ R
        t = t + dx[3:6]
    ok = torch.isfinite(R).all() & torch.isfinite(t).all() & (valid.sum() >= 3)
    R = torch.where(ok, R, torch.eye(3, dtype=torch.float32, device=dev))
    t = torch.where(ok, t, 0.0)
    return geo.make_se3(R, t), ok
