"""Back-end — frame-to-model ICP odometry (the port of
plo_tpu/models/odometry.py in window mode, frame by frame and batched;
laser_odometry.cpp:416-683).

Per frame: the front-end, then the ICP loop (transform -> match -> solve
-> compose, at most `iterations` times with the dual distance/angle
convergence test, :524-647) against the window of the last `max_queue_size`
filtered clouds; the pose chain integrates in float64 on the host
(nowPose = prevLaserPose * rPose, :652-655).

Match: euclidean IMLS (re-searched every iteration, hybrid refresh, or
frozen after the first search), or plane-ICP in euclidean or projected mode.
Solve: RANSAC/DRPM, Ceres (Huber Gauss-Newton) or LS (trimmed least squares).

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
from plo_tpu_torch import native, resolve_device
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.config import Config
from plo_tpu_torch.models.pipeline import (GRID16_SCALE, STATS_KEYS, FrontEnd,
                                           FrontEndOutput, grid_to_device)
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


TRANSFERS = ("int16", "float32", "grid16")


def _check_supported(cfg: Config) -> None:
    lo = cfg.laser_odometry
    method = lo.matching_method.method
    imls = lo.matching_method.imls
    is_imls = method == "IMLS"
    unsupported = [
        (lo.target_mode != "window", f"target_mode={lo.target_mode!r}"),
        (method not in ("IMLS", "plane_ICP"), f"matching {method!r}"),
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


def _zeros_cloud(capacity: int, device) -> PointCloud:
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return PointCloud(xyz=z(capacity, 3), normal=z(capacity, 3), intensity=z(capacity),
                      curvature=z(capacity), eigvals=z(capacity, 3),
                      valid=torch.zeros(capacity, dtype=torch.bool, device=device))


def _map_fields(fn, *clouds: PointCloud) -> PointCloud:
    return PointCloud(**{f.name: fn(*(getattr(c, f.name) for c in clouds))
                         for f in dataclasses.fields(PointCloud)})


class Odometry:
    """Front-end + ICP back-end + float64 host pose chain. Runs on the CUDA
    card unless `device` names another; `device=None` with no card raises.

    `process_scan` takes one frame; `process_scans` takes a sequence and runs
    full batches of `batch` frames as one step each: one host-to-device copy
    of the batch's packed scans, the frames against the device-resident
    [K, P] model window, and one packed result row per frame kept on the
    device. `transfer` is how a batch's scans cross to the device: "int16"
    (xyz in 5 mm fixed point), "float32", or "grid16" (the [H, W] uint16
    range raster; range_image configs only). As in the JAX package, frame 0
    and the frames of a short last batch go through `process_scan`, which
    ships float32 points (grid16: the raster).

    Results stay on the device until a drain fetches all pending rows in one
    copy: at every frame, unless `async_mode`, which drains every
    `sync_every` pending steps and at `finalize()` / `poses()`. The ICP loop
    still syncs with the host each iteration (module docstring)."""

    # Fixed-point transfer scale: 5 mm steps cover +-163.8 m in int16,
    # beyond the 150 m range gate.
    TRANSFER_QUANT_SCALE = 0.005

    def __init__(self, cfg: Config, capacity: int = 131072, seed: int = 0, device=None,
                 async_mode: bool = False, sync_every: int = 64, transfer: str = "int16"):
        if transfer not in TRANSFERS:
            raise ValueError(f"transfer {transfer!r}: one of {TRANSFERS}")
        if transfer == "grid16":
            if cfg.scan_registration.compute_normal_method.format != "range_image":
                raise ValueError("transfer='grid16' requires "
                                 "compute_normal_method.format='range_image'")
            if cfg.scan_registration.presample_method.method == "curvature":
                raise ValueError("transfer='grid16' does not support the "
                                 "curvature presample (stage-1 ring curvature "
                                 "needs the compact point layout)")
        _check_supported(cfg)
        self.cfg = cfg
        self.transfer = transfer
        self.async_mode = async_mode
        self.sync_every = sync_every
        self.device = resolve_device(device)
        self.frontend = FrontEnd(cfg, capacity=capacity, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.draws = GeneratorDraws(self.generator, self.device)
        self.prev_pose = np.eye(4)              # prevLaserPose (:48)
        self.frame_count = 0
        self.cloud_queue: Deque[PointCloud] = deque()
        # The window [K, P] left on the device by a batch; cloud_queue is
        # rebuilt from it only when a per-frame step needs the queue.
        self._device_window: Optional[PointCloud] = None
        self.last_filtered: Optional[PointCloud] = None
        self.trajectory: List[OdometryFrame] = []
        self._last_rel: Optional[torch.Tensor] = None   # device rPose of the last frame
        self._pending: List[tuple] = []   # (first frame index, rows [n, 24 + stats])
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

    def _sync_queue(self) -> None:
        """Rebuild cloud_queue from the device window a batch left."""
        if self._device_window is None:
            return
        k = self.cfg.laser_odometry.max_queue_size
        self.cloud_queue = deque(_map_fields(lambda a, s=s: a[s], self._device_window)
                                 for s in range(k))
        self._device_window = None

    def _target(self) -> PointCloud:
        """accumulateTargetCloud (laser_odometry.cpp:116-136)."""
        self._sync_queue()
        clouds = list(self.cloud_queue)
        acc = clouds[0]
        for c in clouds[1:]:
            acc = acc.concat(c)
        return acc

    def _window_state(self) -> PointCloud:
        """The window [K, P]: the one the last batch left, else the cloud
        queue stacked (oldest first, invalid-padded at the front while the
        queue fills)."""
        if self._device_window is not None:
            return self._device_window
        k = self.cfg.laser_odometry.max_queue_size
        clouds = list(self.cloud_queue)[-k:]
        pad = [_zeros_cloud(self.frontend.filtered_capacity, self.device)] * (k - len(clouds))
        return _map_fields(lambda *xs: torch.stack(xs), *(pad + clouds))

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
        # Frozen correspondences (refresh_correspondences=False, IMLS): one
        # candidate search at the initial pose, then every iteration
        # re-evaluates gates, anchor, bandwidth and heights from the frozen
        # set at the current pose (exact at the search pose).
        frozen = is_imls and not lo.refresh_correspondences
        # Hybrid refresh (IMLS, refresh_correspondences=True): re-search the
        # target only once the accumulated per-point motion since the last
        # search reaches the threshold; between searches as frozen. Threshold
        # 0 re-searches every iteration (strict laser_odometry.cpp:524-647).
        # Plane-ICP searches every iteration.
        hybrid = is_imls and lo.refresh_correspondences and lo.refresh_motion_threshold > 0.0

        rpose = (torch.eye(4, dtype=torch.float32, device=self.device)
                 if init_pose is None else init_pose)
        if frozen:
            cache = matching.imls_search(geo.transform_points(rpose, flat.xyz), target, imls_cfg)
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
            elif frozen or hybrid:
                if hybrid and moved >= lo.refresh_motion_threshold:
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

    def _advance(self, fe: FrontEndOutput, target: Optional[PointCloud], draws) -> torch.Tensor:
        """The back-end of one frame: ICP against `target` (None on frame 0)
        from the motion prior. Returns the frame's packed result row
        [pose 16, iterations, correspondences, DRPM probabilities 6, stats],
        on the device."""
        dev = self.device
        if target is None:
            rpose = torch.eye(4, dtype=torch.float32, device=dev)
            iters, n_corr = 0, torch.zeros((), dtype=torch.int64, device=dev)
            probs = torch.ones(6, dtype=torch.float32, device=dev)
        else:
            init = (self._last_rel if self.cfg.laser_odometry.motion_prior
                    and self._last_rel is not None else None)
            rpose, iters, n_corr, probs = self._icp(fe.flat, target, draws, init)
            self._last_rel = rpose
        return torch.cat([rpose.reshape(-1), torch.full((1,), float(iters), device=dev),
                          n_corr.reshape(1).to(torch.float32), probs,
                          torch.stack([fe.stats[k] for k in STATS_KEYS]).to(torch.float32)])

    def _pack_grid(self, raw_pts: np.ndarray) -> np.ndarray:
        """The grid16 raster [H, W] uint16 of one raw scan."""
        h, w = self.frontend.height, self.frontend.width
        grid = np.zeros((h, w), np.uint16)
        s = self.cfg.sensor
        native.rasterize_grid16_numpy(np.ascontiguousarray(raw_pts, np.float32), h, w,
                                      1.0 / GRID16_SCALE, s.minimum_range, s.maximum_range,
                                      grid)
        return grid

    def process_scan(self, raw_pts: np.ndarray, draws=None) -> Optional[OdometryFrame]:
        """One frame: front-end, ICP against the window, pose integration.
        `draws` replaces the run's own random numbers for this frame (an
        object with GeneratorDraws' methods). Returns the frame, or None in
        async_mode (results wait for a drain)."""
        self._note_truncation(len(raw_pts))
        draws = self.draws if draws is None else draws
        first = self.frame_count == 0
        scores = draws.frontend(self.frontend.n_draws(first), self.frontend.filtered_capacity)
        if self.transfer == "grid16":
            fe = self.frontend.process_grid(self._pack_grid(raw_pts), scores,
                                            self.last_filtered, first)
        else:
            fe = self.frontend.process(raw_pts, scores, self.last_filtered, first)
        row = self._advance(fe, None if first else self._target(), draws)
        self.cloud_queue.append(fe.filtered)
        while len(self.cloud_queue) > self.cfg.laser_odometry.max_queue_size:
            self.cloud_queue.popleft()
        self.last_filtered = fe.filtered
        self._pending.append((self.frame_count, row[None]))
        self.frame_count += 1
        if self.async_mode:
            if len(self._pending) >= self.sync_every:
                self._drain()
            return None
        self._drain()
        return self.trajectory[-1]

    def _pack_batch(self, scans: Sequence[np.ndarray]):
        """The batch's scans in the transfer format (numpy) and their point
        counts."""
        b, cap = len(scans), self.frontend.capacity
        nvs = np.zeros(b, np.int64)
        if self.transfer == "grid16":
            raws = np.stack([self._pack_grid(s) for s in scans])
            return raws, (raws > 0).reshape(b, -1).sum(1)
        if self.transfer == "int16":
            raws = np.zeros((b, cap, 3), np.int16)
            inv = 1.0 / self.TRANSFER_QUANT_SCALE
            for j, raw in enumerate(scans):
                nvs[j] = native.quantize_pack(raw, inv, raws[j])
            return raws, nvs
        raws = np.zeros((b, cap, 4), np.float32)
        for j, raw in enumerate(scans):
            n = min(len(raw), cap)
            cols = min(raw.shape[1], 4)
            raws[j, :n, :cols] = raw[:n, :cols]
            nvs[j] = n
        return raws, nvs

    def _upload_batch(self, scans: Sequence[np.ndarray]):
        """The batch's scans packed in the transfer format and copied to the
        device in one copy; returns (raws on the device, point counts)."""
        for s in scans:
            self._note_truncation(len(s))
        raws, nvs = self._pack_batch(scans)
        if self.transfer == "grid16":
            return grid_to_device(raws, self.device), nvs
        return torch.from_numpy(raws).to(self.device), nvs

    def _batch_step(self, raws_dev: torch.Tensor, nvs: np.ndarray, draws: Sequence) -> None:
        """Frames 1.. of a run as one step on uploaded scans: each frame's
        front-end and ICP against the device window, the rows kept on the
        device (plo_tpu's _cached_batch_step, window mode)."""
        window = self._window_state()
        last = self.last_filtered
        rows = []
        for j, d in enumerate(draws):
            d = self.draws if d is None else d
            scores = d.frontend(self.frontend.n_draws(False), self.frontend.filtered_capacity)
            if self.transfer == "grid16":
                fe = self.frontend.run_grid(raws_dev[j], scores, last, False)
            else:
                raw = raws_dev[j]
                if self.transfer == "int16":
                    raw = raw.to(torch.float32) * self.TRANSFER_QUANT_SCALE
                fe = self.frontend.run(raw, int(nvs[j]), scores, last, False)
            target = _map_fields(lambda a: a.reshape((-1,) + a.shape[2:]), window)
            rows.append(self._advance(fe, target, d))
            window = _map_fields(lambda a, n: torch.cat([a[1:], n[None]]), window, fe.filtered)
            last = fe.filtered
        self._pending.append((self.frame_count, torch.stack(rows)))
        self._device_window = window
        self.cloud_queue.clear()
        self.last_filtered = last
        self.frame_count += len(rows)
        if not self.async_mode or len(self._pending) >= self.sync_every:
            self._drain()

    def process_scans(self, scans, batch: int = 8, draws: Optional[Sequence] = None):
        """Process a sequence of raw scans: frame 0 and a last batch shorter
        than `batch` frame by frame, the rest in steps of `batch` frames.
        `draws` gives each scan's draws object (None entries: the run's
        own). In async_mode, call finalize() (or poses()) after."""
        scans = list(scans)
        draws = [None] * len(scans) if draws is None else list(draws)
        i = 0
        while i < len(scans):
            if self.frame_count == 0 or len(scans) - i < batch:
                self.process_scan(scans[i], draws[i])
                i += 1
                continue
            self._batch_step(*self._upload_batch(scans[i:i + batch]), draws[i:i + batch])
            i += batch
        return self

    def _drain(self) -> None:
        """Fetch every pending frame's row in one device-to-host copy and
        integrate the poses in float64 (nowPose = prevLaserPose * rPose,
        laser_odometry.cpp:652)."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        host = torch.cat([rows for _, rows in pending]).cpu().numpy().astype(np.float64)
        k = 0
        for first, rows in pending:
            for j in range(rows.shape[0]):
                self._append_frame(first + j, host[k])
                k += 1

    def _append_frame(self, index: int, row: np.ndarray) -> None:
        stats = dict(zip(STATS_KEYS, (float(v) for v in row[24:])))
        stats.update({f"drpm_prob_{j}": float(row[18 + j]) for j in range(6)})
        rel = row[:16].reshape(4, 4)
        self.prev_pose = self.prev_pose @ rel
        self.trajectory.append(OdometryFrame(
            index=index, pose=self.prev_pose, rel_pose=rel, iterations=int(row[16]),
            n_correspondences=int(row[17]), stats=stats))

    def finalize(self) -> List[OdometryFrame]:
        """Drain all pending frames; returns the full trajectory."""
        self._drain()
        return self.trajectory

    def sync(self) -> None:
        """Wait for the device work queued so far, fetching nothing (a timing
        barrier; finalize() fetches the results)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def poses(self) -> np.ndarray:
        self._drain()
        return np.stack([f.pose for f in self.trajectory])
