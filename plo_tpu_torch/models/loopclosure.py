"""Loop closure (the port of plo_tpu/models/loopclosure.py): revisit
detection, re-registration of each revisit pair with the back-end's ICP
loop, and pose-graph relaxation.

Detection and the relaxation run on the host in float64 NumPy, as in
plo_tpu (the graph is small, 6N unknowns, and the pose chain is already
host float64); these functions are copies of plo_tpu's. The
re-registration runs the port's FrontEnd and `icp_loop` on the device.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from plo_tpu_torch import resolve_device
from plo_tpu_torch.config import Config
from plo_tpu_torch.models.odometry import GeneratorDraws, icp_loop
from plo_tpu_torch.models.pipeline import FrontEnd


def detect_revisits(positions: np.ndarray, min_gap: int = 40,
                    radius: float = 3.0, min_spacing: int = 20
                    ) -> List[Tuple[int, int]]:
    """Candidate loop pairs (i, j), i + min_gap <= j, ||p_i - p_j|| < radius.

    Greedy: for each j (in order) the closest qualifying i is taken, and
    further candidates within `min_spacing` frames of an accepted j are
    skipped: one closure per revisit event."""
    p = np.asarray(positions, np.float64)
    n = len(p)
    pairs: List[Tuple[int, int]] = []
    last_j = -10**9
    for j in range(min_gap, n):
        if j - last_j < min_spacing:
            continue
        d = np.linalg.norm(p[: j - min_gap + 1] - p[j], axis=1)
        i = int(np.argmin(d))
        if d[i] < radius:
            pairs.append((i, j))
            last_j = j
    return pairs


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _log_so3(R):
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-9:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) / 2.0
    return th / (2.0 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def _exp_so3(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3) + _skew(w)
    K = _skew(w / th)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def pose_graph_optimize(poses: np.ndarray,
                        edges: List[Tuple[int, int, np.ndarray, float]],
                        iterations: int = 15,
                        damping: float = 1e-6) -> np.ndarray:
    """Relax [N, 4, 4] world poses against relative-pose edges
    (i, j, rel_meas 4x4 with X_i @ rel = X_j, weight).

    Decoupled residuals per edge:
      r_R = log(R_rel^T R_i^T R_j)          (rotation, rad)
      r_t = R_i^T (t_j - t_i) - t_rel       (translation, m)
    Right-perturbation first-order Jacobians; node 0 is gauge-fixed."""
    X = np.array(poses, np.float64, copy=True)
    n = len(X)

    for _ in range(iterations):
        H = np.zeros((6 * n, 6 * n))
        b = np.zeros(6 * n)
        for (i, j, rel, w) in edges:
            Ri, ti = X[i, :3, :3], X[i, :3, 3]
            Rj, tj = X[j, :3, :3], X[j, :3, 3]
            Rrel, trel = rel[:3, :3], rel[:3, 3]
            r_R = _log_so3(Rrel.T @ Ri.T @ Rj)
            dt = Ri.T @ (tj - ti)
            r_t = dt - trel
            # Jacobian blocks [r_R; r_t] w.r.t. (w_i, t_i, w_j, t_j).
            Ji = np.zeros((6, 6))
            Jj = np.zeros((6, 6))
            Ji[:3, :3] = -np.eye(3)           # d r_R / d w_i
            Jj[:3, :3] = np.eye(3)            # d r_R / d w_j
            Ji[3:, :3] = _skew(dt)            # d r_t / d w_i
            Ji[3:, 3:] = -Ri.T                # d r_t / d t_i
            Jj[3:, 3:] = Ri.T                 # d r_t / d t_j
            r = np.concatenate([r_R, r_t])
            for (a, Ja) in ((i, Ji), (j, Jj)):
                b[6 * a: 6 * a + 6] += w * Ja.T @ r
                for (c, Jc) in ((i, Ji), (j, Jj)):
                    H[6 * a: 6 * a + 6, 6 * c: 6 * c + 6] += w * Ja.T @ Jc
        # Gauge: clamp node 0.
        H[:6, :] = 0.0
        H[:, :6] = 0.0
        H[:6, :6] = np.eye(6)
        b[:6] = 0.0
        H += damping * np.eye(6 * n)
        dx = np.linalg.solve(H, -b)
        for k in range(n):
            w_k, t_k = dx[6 * k: 6 * k + 3], dx[6 * k + 3: 6 * k + 6]
            X[k, :3, :3] = X[k, :3, :3] @ _exp_so3(w_k)
            X[k, :3, 3] += t_k  # global-frame delta (matches d r_t/d t_j = R_i^T)
        if np.linalg.norm(dx) < 1e-10:
            break
        # Re-orthonormalize (accumulated exp-map roundoff).
        for k in range(n):
            u, _, vt = np.linalg.svd(X[k, :3, :3])
            X[k, :3, :3] = u @ np.diag([1, 1, np.linalg.det(u @ vt)]) @ vt
    return X


def close_loops(cfg: Config, scans: Union[Sequence[np.ndarray], Mapping[int, np.ndarray]],
                poses: np.ndarray, min_gap: int = 40, radius: float = 3.0,
                capacity: int = 57600, transfer_seed: int = 0, loop_weight: float = 10.0,
                max_pairs: int = 8, min_corr: int = 50, device=None,
                frontend_draws: Optional[Callable[[int], object]] = None,
                icp_draws: Optional[Callable[[int], object]] = None):
    """Detect revisits in an odometry trajectory `poses` [N, 4, 4], re-register
    each revisit pair (i, j) with the ICP loop (frame j's sampled cloud
    against frame i's filtered cloud, from the odometry's relative pose),
    and relax the pose graph of the odometry edges and the measured loop
    edges. A pair whose ICP finds fewer than `min_corr` correspondences or
    does not converge gives no edge. `scans` is indexed only at the pairs'
    frames (a mapping that holds just those will do); each such frame goes
    through the front-end once, as a first frame.

    Draws: `frontend_draws(idx)` gives the draws of the idx-th needed frame
    (in frame order) and `icp_draws(pi)` those of pair pi, objects with
    GeneratorDraws' methods; by default both come from one torch.Generator
    seeded with `transfer_seed`. Returns (corrected poses [N, 4, 4],
    loop edges [(i, j, rel 4x4 float64, correspondences)])."""
    poses = np.asarray(poses, np.float64)
    pairs = detect_revisits(poses[:, :3, 3], min_gap=min_gap, radius=radius)[:max_pairs]
    if not pairs:
        return poses.copy(), []
    device = resolve_device(device)
    if frontend_draws is None or icp_draws is None:
        gen = GeneratorDraws(torch.Generator(device=device).manual_seed(transfer_seed), device)
        frontend_draws = frontend_draws or (lambda idx: gen)
        icp_draws = icp_draws or (lambda pi: gen)
    frontend = FrontEnd(cfg, capacity=capacity, device=device)
    map_mode = cfg.laser_odometry.target_mode == "map"

    needed = sorted({i for i, _ in pairs} | {j for _, j in pairs})
    fe = {}
    for idx, f in enumerate(needed):
        # As a first frame: a frame alone has no previous cloud for the
        # major-axis sampler, which falls back to normal binning.
        scores = frontend_draws(idx).frontend(frontend.n_draws(True), frontend.filtered_capacity)
        fe[f] = frontend.process(scans[f], scores, None, True)

    loop_edges = []
    for pi, (i, j) in enumerate(pairs):
        init = torch.as_tensor((np.linalg.inv(poses[i]) @ poses[j]).astype(np.float32),
                               device=device)
        rel, _, n_corr, converged, _ = icp_loop(cfg, fe[j].flat, fe[i].filtered, icp_draws(pi),
                                                init, device, map_mode)
        n_corr = int(n_corr)
        if n_corr < min_corr or not bool(converged):
            continue
        loop_edges.append((i, j, rel.cpu().numpy().astype(np.float64), n_corr))
    if not loop_edges:
        return poses.copy(), []

    edges = [(k, k + 1, np.linalg.inv(poses[k]) @ poses[k + 1], 1.0)
             for k in range(len(poses) - 1)]
    edges += [(i, j, rel, loop_weight) for (i, j, rel, _) in loop_edges]
    return pose_graph_optimize(poses, edges), loop_edges
