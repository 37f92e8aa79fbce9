"""Back-end driver — frame-to-model ICP odometry (the port of the per-frame
path of plo_tpu/models/odometry.py; laser_odometry.cpp:416-683).

Per frame: the front-end, then the ICP loop (transform -> match -> solve
-> compose, at most `iterations` times with the dual distance/angle
convergence test, :524-647) against the window of the last `max_queue_size`
filtered clouds; the pose chain integrates in float64 on the host
(nowPose = prevLaserPose * rPose, :652-655).

Match: euclidean IMLS, or plane-ICP in euclidean or projected mode. Solve:
RANSAC/DRPM, Ceres (Huber Gauss-Newton) or LS (trimmed least squares).

PyTorch has no lax.while_loop or lax.cond, so the loop runs on the host:
each ICP iteration syncs once to the host for the convergence test (and,
with IMLS's hybrid refresh, the re-search decision), RANSAC's staged early
exit adds a second sync (solvers/ransac.py), and each IMLS search a third,
for knn's tie check (ops/neighbors.py).
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from plo_tpu_torch import geometry as geo
from plo_tpu_torch import resolve_device
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.config import Config
from plo_tpu_torch.models.pipeline import FrontEnd
from plo_tpu_torch.ops import matching
from plo_tpu_torch.solvers.gauss_newton import solve_gauss_newton
from plo_tpu_torch.solvers.ls import solve_ls_trimmed
from plo_tpu_torch.solvers.ransac import solve_ransac


@dataclasses.dataclass
class OdometryFrame:
    """Host-side record of one processed frame."""
    index: int
    pose: np.ndarray          # [4, 4] float64 world pose
    rel_pose: np.ndarray      # [4, 4] float64 frame-to-frame delta
    iterations: int
    n_correspondences: int
    stats: Dict[str, float]


class GeneratorDraws:
    """The random numbers of one odometry run, from a torch.Generator on the
    run's device. Any object with these two methods can stand in (the tests
    feed the draws the JAX package made)."""

    def __init__(self, generator: torch.Generator, device: torch.device):
        self.generator = generator
        self.device = device

    def frontend(self, n: int, p: int) -> Sequence[torch.Tensor]:
        """n uniform [0, 1) score vectors of length p."""
        return [torch.rand(p, generator=self.generator, device=self.device)
                for _ in range(n)]

    def ransac(self, iteration: int, n_valid: torch.Tensor, m: int) -> torch.Tensor:
        """m first-seed ranks in [0, n_valid), drawn on the device (no sync)."""
        u = torch.rand(m, generator=self.generator, device=self.device)
        n = n_valid.clamp_min(1)
        return torch.minimum((u * n.to(torch.float32)).long(), n - 1)


def _flat_query_cap(cfg: Config) -> Optional[int]:
    """Bound on the valid sampled points of a non-first frame when smaller
    than the sample capacity: major-axis quotas sum to <= max_total_points,
    and the sample is valid-first, so the ICP source is sliced to this
    (lane-aligned) prefix (plo_tpu.models.odometry._flat_query_cap)."""
    sm = cfg.scan_registration.sample_method
    if sm.method != "major_axis":
        return None
    live = -(-sm.major_axis.max_total_points // 128) * 128
    full = max(sm.major_axis.max_total_points,
               sm.normal.azimuth_bins * sm.normal.elevation_bins * sm.normal.max_points_per_bin)
    return live if live < full else None


def _check_supported(cfg: Config) -> None:
    lo = cfg.laser_odometry
    method = lo.matching_method.method
    imls = lo.matching_method.imls
    is_imls = method == "IMLS"
    unsupported = [
        (lo.target_mode != "window", f"target_mode={lo.target_mode!r}"),
        (method not in ("IMLS", "plane_ICP"), f"matching {method!r}"),
        (is_imls and not lo.refresh_correspondences, "frozen IMLS correspondences"),
        (is_imls and imls.use_projected_distance.enabled, "projected-distance IMLS"),
        (is_imls and not imls.get_normals.enabled and imls.use_tensor_voting.enabled,
         "tensor-voting IMLS"),
        (lo.solve_method.method not in ("RANSAC", "Ceres", "LS"),
         f"solve {lo.solve_method.method!r}"),
        (lo.undistort, "undistort"),
        (lo.ba.enabled, "bundle adjustment"),
        (cfg.saver.enabled, "saver artifacts"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


class Odometry:
    """Front-end + ICP back-end + float64 host pose chain, one frame per
    `process_scan` call. Runs on the CUDA card unless `device` names another;
    `device=None` with no card raises."""

    def __init__(self, cfg: Config, capacity: int = 131072, seed: int = 0, device=None):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.frontend = FrontEnd(cfg, capacity=capacity, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.draws = GeneratorDraws(self.generator, self.device)
        self.prev_pose = np.eye(4)              # prevLaserPose (:48)
        self.frame_count = 0
        self.cloud_queue: Deque[PointCloud] = deque()
        self.last_filtered: Optional[PointCloud] = None
        self.trajectory: List[OdometryFrame] = []
        self._last_rel: Optional[torch.Tensor] = None   # device rPose of the last frame
        # The front-end keeps the first `capacity` points of a larger scan;
        # the dropped points are counted here and warned about once.
        self.truncated_points = 0
        self._warned_truncation = False

    def _note_truncation(self, n_raw: int) -> None:
        cap = self.frontend.capacity
        if n_raw > cap:
            self.truncated_points += n_raw - cap
            if not self._warned_truncation:
                self._warned_truncation = True
                warnings.warn(
                    f"scan with {n_raw} points exceeds capacity "
                    f"{cap}; {n_raw - cap} "
                    "points dropped (see Odometry.truncated_points). Raise "
                    "`capacity` to cover the sensor's max return count.",
                    RuntimeWarning, stacklevel=3)

    def _target(self) -> PointCloud:
        """accumulateTargetCloud (laser_odometry.cpp:116-136)."""
        clouds = list(self.cloud_queue)
        acc = clouds[0]
        for c in clouds[1:]:
            acc = acc.concat(c)
        return acc

    def _icp(self, flat: PointCloud, target: PointCloud, draws, init_pose):
        """The ICP loop of plo_tpu.models.odometry._make_icp_step for
        euclidean IMLS or plane-ICP, solved by RANSAC, Ceres or LS. Returns
        (rPose [4, 4] f32 on the device, iterations, correspondences, DRPM
        probabilities [6], ones for solvers without a DRPM stage)."""
        lo = self.cfg.laser_odometry
        sv = lo.solve_method
        imls_cfg = lo.matching_method.imls
        is_imls = lo.matching_method.method == "IMLS"
        cap = _flat_query_cap(self.cfg)
        if cap is not None and flat.capacity > cap:
            flat = flat.slice(cap)
        if is_imls and not imls_cfg.get_normals.enabled:
            tgt_normal, tgt_normal_ok = matching.precompute_target_normals(
                target.xyz, target.valid, imls_cfg.get_normals.r_normal,
                imls_cfg.get_normals.search_number_normal)
        else:
            tgt_normal, tgt_normal_ok = target.normal, target.valid
        # Hybrid refresh (IMLS only): re-search the target only once the
        # accumulated per-point motion since the last search reaches the
        # threshold; between searches the frozen candidates are re-evaluated
        # at the current pose (exact at the search pose). Threshold 0
        # re-searches every iteration (strict laser_odometry.cpp:524-647).
        # Plane-ICP searches every iteration.
        hybrid = is_imls and lo.refresh_motion_threshold > 0.0

        rpose = (torch.eye(4, dtype=torch.float32, device=self.device)
                 if init_pose is None else init_pose)
        moved = np.float32(np.inf)  # inf -> search at iteration 0
        i = 0
        n_corr = torch.zeros((), dtype=torch.int64, device=self.device)
        probs = torch.ones(6, dtype=torch.float32, device=self.device)
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        while i < sv.iterations:
            src_xyz = geo.transform_points(rpose, flat.xyz)
            src_normal = geo.rotate_vectors(rpose, flat.normal) if lo.transform_normal else flat.normal
            src = dataclasses.replace(flat, xyz=src_xyz, normal=src_normal)
            if not is_imls:
                res = matching.plane_icp_project(src, target, lo.matching_method.plane_icp)
            elif hybrid:
                if moved >= lo.refresh_motion_threshold:
                    cache = matching.imls_search(src_xyz, target, imls_cfg)
                    moved = np.float32(0.0)
                res = matching.imls_project_cached(src, target, imls_cfg, cache,
                                                   tgt_normal, tgt_normal_ok)
            else:
                res = matching.imls_project(src, target, imls_cfg, tgt_normal, tgt_normal_ok)
            n_corr = res.valid.sum()
            enough = n_corr >= lo.matching_method.correspond_number
            if sv.method == "RANSAC":  # the only solver that draws
                delta, ok, probs = solve_ransac(
                    src_xyz, res.y, res.normal, res.valid,
                    draws.ransac(i, n_corr, sv.ransac.max_iterations), sv.ransac)
            elif sv.method == "Ceres":
                delta, ok = solve_gauss_newton(src_xyz, res.y, res.normal, res.valid,
                                               sv.ceres.max_iterations)
            else:
                delta, ok = solve_ls_trimmed(src_xyz, res.y, res.normal, res.valid,
                                             sv.ls.threshold)
            delta = torch.where(enough & ok, delta, eye)
            converged = ((torch.linalg.norm(delta[:3, 3]) < sv.delta_dist_threshold)
                         & (geo.rotation_angle(delta[:3, :3]) < sv.delta_angle_threshold))
            done = ~(enough & ok) | converged  # break conditions (:571-576,611-616,643-646)
            rpose = delta @ rpose
            i += 1
            if hybrid:
                # Worst per-point displacement of this delta: bounds the drift
                # since the last search (triangle inequality).
                disp = geo.transform_points(delta, src_xyz) - src_xyz
                step = torch.sqrt(torch.where(flat.valid, (disp * disp).sum(-1), 0.0).max())
                # The one host sync of the iteration.
                done_h, step_h = torch.stack([done.to(torch.float32), step]).tolist()
                moved = np.float32(moved + np.float32(step_h))
            else:
                done_h = bool(done)  # the one host sync of the iteration
            if done_h:
                break
        return rpose, i, n_corr, probs

    def process_scan(self, raw_pts: np.ndarray, draws=None) -> OdometryFrame:
        """One frame: front-end, ICP against the window, pose integration.
        `draws` replaces the run's own random numbers for this frame (an
        object with GeneratorDraws' methods)."""
        self._note_truncation(len(raw_pts))
        draws = self.draws if draws is None else draws
        first = self.frame_count == 0
        fe = self.frontend.process(
            raw_pts, draws.frontend(self.frontend.n_draws(first), self.frontend.capacity),
            self.last_filtered, first_frame=first)
        if not first:
            init = (self._last_rel if self.cfg.laser_odometry.motion_prior
                    and self._last_rel is not None else None)
            rpose, iters, n_corr, probs = self._icp(fe.flat, self._target(), draws, init)
            self._last_rel = rpose
        else:
            rpose = torch.eye(4, dtype=torch.float32, device=self.device)
            iters, n_corr = 0, torch.zeros((), dtype=torch.int64, device=self.device)
            probs = torch.ones(6, dtype=torch.float32, device=self.device)

        self.cloud_queue.append(fe.filtered)
        while len(self.cloud_queue) > self.cfg.laser_odometry.max_queue_size:
            self.cloud_queue.popleft()
        self.last_filtered = fe.filtered
        index = self.frame_count
        self.frame_count += 1

        keys = sorted(fe.stats)
        host = torch.cat([rpose.reshape(-1), n_corr.reshape(1).to(torch.float32), probs,
                          torch.stack([fe.stats[k] for k in keys]).to(torch.float32)]
                         ).cpu().numpy().astype(np.float64)
        stats = {k: float(v) for k, v in zip(keys, host[23:])}
        stats.update({f"drpm_prob_{j}": float(host[17 + j]) for j in range(6)})
        rel = host[:16].reshape(4, 4)
        self.prev_pose = self.prev_pose @ rel
        frame = OdometryFrame(index=index, pose=self.prev_pose, rel_pose=rel,
                              iterations=iters, n_correspondences=int(host[16]), stats=stats)
        self.trajectory.append(frame)
        return frame

    def poses(self) -> np.ndarray:
        return np.stack([f.pose for f in self.trajectory])
