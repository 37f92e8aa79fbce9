"""Back-end — frame-to-model ICP odometry (the port of
plo_tpu/models/odometry.py, frame by frame and batched;
laser_odometry.cpp:416-683).

Per frame: the front-end, then the ICP loop (transform -> match -> solve
-> compose, at most `iterations` times with the dual distance/angle
convergence test, :524-647) against the target model; the pose chain
integrates in float64 on the host (nowPose = prevLaserPose * rPose,
:652-655). The target is the window of the last `max_queue_size` filtered
clouds (target_mode="window", the reference's accumulateTargetCloud), or a
persistent world-frame voxel map (target_mode="map"): the ICP then solves
for the world pose from the previous one (or the motion prior), and each
frame's filtered cloud enters the map at its solved pose. With `undistort`,
the sampled source is compensated for the sweep's motion with the last
relative pose before the ICP, and the model cloud with the pose just solved.
With windowed bundle adjustment (laser_odometry.ba, window mode only), each
frame records correspondences to the previous and the skip (k-2) frame, and
the last `ba.window` poses are refined jointly on the device
(parallel/ba.py) and written back into the float64 chain on the host.

Match: euclidean IMLS (re-searched every iteration, hybrid refresh, or
frozen after the first search, which on a map can go through the grid hash),
projected-distance IMLS and tensor-voting IMLS (both re-searched every
iteration), or plane-ICP in euclidean or projected mode. Solve: RANSAC/DRPM,
Ceres (Huber Gauss-Newton), LS (trimmed least squares), ICP (point-to-point
Umeyama) or Teaser (k-core + GNC).

PyTorch has no lax.while_loop or lax.cond, so the loop runs on the host:
each ICP iteration syncs once to the host for the convergence test (and,
with IMLS's hybrid refresh, the re-search decision), RANSAC's staged early
exit adds a second sync (solvers/ransac.py), and each kNN search a third,
for knn's tie check (ops/neighbors.py). The map chain adds none.
"""
from __future__ import annotations

import dataclasses
import os
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
from plo_tpu_torch.ops import matching, tensor_voting, voxel
from plo_tpu_torch.ops.undistort import undistort_cloud
from plo_tpu_torch.parallel import ba as ba_ops, sharding
from plo_tpu_torch.solvers.gauss_newton import solve_gauss_newton
from plo_tpu_torch.solvers.gnc import ALGORITHMS as TEASER_ALGORITHMS, solve_gnc_tls
from plo_tpu_torch.solvers.icp_umeyama import solve_icp_point_to_point
from plo_tpu_torch.solvers.ls import solve_ls_trimmed
from plo_tpu_torch.solvers.ransac import solve_ransac
from plo_tpu_torch.utils import saver

# Iteration caps of the ICP and Teaser solvers (plo_tpu/models/odometry.py:
# 113, 118): a fused while_loop there unrolls the solver body.
ICP_SOLVER_CAP = 30
TEASER_CAP = 64


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

    def teaser(self, iteration: int, n: int, m: int):
        """Teaser's scale estimate: m index pairs (ia, ib), each in [0, n)."""
        return tuple(torch.randint(0, n, (m,), generator=self.generator, device=self.device)
                     for _ in range(2))


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
    """Raise on options the port does not run; warn where a solver's
    iteration cap cuts the configured count, and reject unknown Teaser
    algorithms (plo_tpu/models/odometry.py:129-156, with its texts)."""
    lo = cfg.laser_odometry
    sv = lo.solve_method
    if lo.target_mode not in ("window", "map"):
        raise ValueError(f"invalid target_mode {lo.target_mode!r}")
    if lo.target_mode == "map":
        if lo.map.search not in ("dense", "grid_hash"):
            raise ValueError(f"invalid map.search {lo.map.search!r}")
        if lo.ba.enabled:
            raise ValueError("ba.enabled requires target_mode='window' "
                             "(the map already anchors the pose chain)")
        if (lo.matching_method.method == "IMLS"
                and lo.matching_method.imls.use_projected_distance.enabled
                and lo.map.search == "grid_hash"):
            raise ValueError("map.search='grid_hash' requires euclidean IMLS "
                             "(freeze-mode search); projected-distance mode "
                             "uses the dense engine")
    if lo.matching_method.method not in ("IMLS", "plane_ICP"):
        raise ValueError(f"invalid matching method {lo.matching_method.method!r}")
    if sv.method not in ("RANSAC", "Ceres", "LS", "ICP", "Teaser"):
        raise ValueError(f"invalid solve method {sv.method!r}")
    if sv.method == "ICP" and sv.icp.max_iterations > ICP_SOLVER_CAP:
        warnings.warn(
            f"solve_method ICP max_iterations={sv.icp.max_iterations} is "
            "capped at 30 (the point-to-point Umeyama loop converges in <10; "
            "the reference's own outer driver caps at iterations=30)",
            RuntimeWarning, stacklevel=3)
    if (sv.method == "Teaser" and sv.teaser.rotation_max_iterations > TEASER_CAP
            and sv.teaser.rotation_cost_threshold <= 0.0):
        warnings.warn(
            f"Teaser rotation_max_iterations={sv.teaser.rotation_max_iterations} "
            "is capped at 64 and rotation_cost_threshold is disabled; set a "
            "positive rotation_cost_threshold for cost-converged termination",
            RuntimeWarning, stacklevel=3)
    if sv.method == "Teaser" and sv.teaser.rotation_estimation_algorithm \
            not in TEASER_ALGORITHMS:
        raise ValueError(
            f"unknown Teaser rotation_estimation_algorithm "
            f"{sv.teaser.rotation_estimation_algorithm!r} (solver.h:51-62 "
            "accepts GNC_TLS | FGR | QUATRO)")


def _zeros_cloud(capacity: int, device) -> PointCloud:
    return PointCloud.zeros(capacity, device)


def _map_fields(fn, *clouds: PointCloud) -> PointCloud:
    return PointCloud(**{f.name: fn(*(getattr(c, f.name) for c in clouds))
                         for f in dataclasses.fields(PointCloud)})


def _fix_pose(T: torch.Tensor) -> torch.Tensor:
    """T with its rotation projected onto SO(3). The map chain composes
    world -> rel (through the transpose inverse) -> next init every frame;
    the transpose inverse of a slightly non-orthonormal R doubles its defect,
    so f32 solver roundoff would grow exponentially (plo_tpu measured
    det(R) = 0.989 by frame 15 without it). geo.project_so3 needs no SVD, so
    the chain makes no host sync."""
    return geo.make_se3(geo.project_so3(T[:3, :3]), T[:3, 3])


def prepare_target(cfg: Config, target: PointCloud, map_mode: bool):
    """The target's normals and their validity for matching (plo_tpu's
    prepare_target, models/odometry.py:158-175): a map keeps the normals of
    insertion time (a surfel map), where zero-normal points (plane-fail
    survivors of use_all_points) are "no-normal" rejects
    (imls_icp.cpp:655-668); IMLS without get_normals computes ComputeNormal
    for every target point once; otherwise the target's own normals."""
    imls_cfg = cfg.laser_odometry.matching_method.imls
    if map_mode:
        return target.normal, target.valid & ((target.normal * target.normal).sum(-1) > 1e-12)
    if cfg.laser_odometry.matching_method.method == "IMLS" and not imls_cfg.get_normals.enabled:
        return matching.precompute_target_normals(
            target.xyz, target.valid, imls_cfg.get_normals.r_normal,
            imls_cfg.get_normals.search_number_normal)
    return target.normal, target.valid


def match_once(cfg: Config, src: PointCloud, target: PointCloud, tgt_normal, tgt_normal_ok):
    """One full match of a moved source against the target (plo_tpu's
    match, models/odometry.py:79-94): plane-ICP, or IMLS (euclidean or
    projected as its config says), whose tensor-voting form first votes
    per-source anchor normals from the target (VoteForAny,
    imls_icp.cpp:514-551)."""
    mm = cfg.laser_odometry.matching_method
    imls_cfg = mm.imls
    if mm.method != "IMLS":
        return matching.plane_icp_project(src, target, mm.plane_icp)
    if not imls_cfg.get_normals.enabled and imls_cfg.use_tensor_voting.enabled:
        anchor_n, anchor_ok = tensor_voting.vote_for_any(
            target.xyz, target.valid, target.normal, src.xyz, src.valid,
            imls_cfg.use_tensor_voting)
        return matching.imls_project(src, target, imls_cfg, tgt_normal, tgt_normal_ok,
                                     anchor_n, anchor_ok)
    return matching.imls_project(src, target, imls_cfg, tgt_normal, tgt_normal_ok)


def _moved(flat: PointCloud, pose: torch.Tensor, transform_normal: bool) -> PointCloud:
    """The cloud moved by a 4x4 pose; its normals too if transform_normal."""
    return dataclasses.replace(
        flat, xyz=geo.transform_points(pose, flat.xyz),
        normal=geo.rotate_vectors(pose, flat.normal) if transform_normal else flat.normal)


def _solve_step(cfg: Config, src_xyz: torch.Tensor, res, n_corr: torch.Tensor, draws,
                i: int, probs: torch.Tensor):
    """Solve and test one ICP iteration's correspondences `res` of the moved
    source `src_xyz` (iteration i, 0-based, drawing from `draws`): returns
    (delta, the identity where there are too few correspondences or the
    solve failed; converged; done, the loop's break condition; the DRPM
    probabilities, `probs` unchanged for solvers without a DRPM stage), all
    on the device."""
    lo = cfg.laser_odometry
    sv = lo.solve_method
    enough = n_corr >= lo.matching_method.correspond_number
    if sv.method == "RANSAC":
        delta, ok, probs = solve_ransac(
            src_xyz, res.y, res.normal, res.valid,
            draws.ransac(i, n_corr, sv.ransac.max_iterations), sv.ransac)
    elif sv.method == "Ceres":
        delta, ok = solve_gauss_newton(src_xyz, res.y, res.normal, res.valid,
                                       sv.ceres.max_iterations)
    elif sv.method == "LS":
        delta, ok = solve_ls_trimmed(src_xyz, res.y, res.normal, res.valid, sv.ls.threshold)
    elif sv.method == "ICP":
        delta, ok = solve_icp_point_to_point(src_xyz, res.y, res.valid,
                                             min(sv.icp.max_iterations, ICP_SOLVER_CAP))
    else:
        t = sv.teaser
        pairs = draws.teaser(i, src_xyz.shape[0], 1024) if t.estimate_scaling else None
        delta, ok = solve_gnc_tls(
            src_xyz, res.y, res.valid, t.noise_bound, t.rotation_gnc_factor,
            min(t.rotation_max_iterations, TEASER_CAP), use_max_clique=t.use_max_clique,
            kcore_min_fraction=t.kcore_heuristic_threshold,
            estimate_scaling=t.estimate_scaling, pairs=pairs,
            algorithm=t.rotation_estimation_algorithm,
            cost_threshold=t.rotation_cost_threshold)
    delta = torch.where(enough & ok, delta, torch.eye(4, dtype=delta.dtype, device=delta.device))
    converged = ((torch.linalg.norm(delta[:3, 3]) < sv.delta_dist_threshold)
                 & (geo.rotation_angle(delta[:3, :3]) < sv.delta_angle_threshold))
    done = ~(enough & ok) | converged  # break conditions (:571-576,611-616,643-646)
    return delta, converged, done, probs


def icp_loop(cfg: Config, flat: PointCloud, target: PointCloud, draws, init_pose,
             device: torch.device, map_mode: bool, mesh=None, candidates=None):
    """The ICP loop of plo_tpu.models.odometry._make_icp_step: the sampled
    cloud `flat` against `target` from `init_pose` (None: the identity),
    on `device`, drawing from `draws`. Returns (rPose [4, 4] f32 on the
    device, iterations, correspondences, converged (a device bool), DRPM
    probabilities [6], ones for solvers without a DRPM stage); in map mode
    the rPose is the world pose. With a `mesh` (parallel/sharding.py,
    `device` its first shard's), the source is sharded on points over it and
    the target replicated: each shard matches its slice, and the rows are
    gathered back in source order, so the solve sees the single-device rows
    (plo_tpu.parallel.sharding.make_sharded_icp_step). With `candidates`,
    the [Q, k] rows (points, normals, normal validity, presence) that a
    sharded map's search returned at `init_pose`
    (parallel/map_store.py knn_gather), `target` is unused and every
    iteration evaluates those frozen rows at the current pose
    (plo_tpu.parallel.odometry._make_candidate_icp)."""
    lo = cfg.laser_odometry
    sv = lo.solve_method
    imls_cfg = lo.matching_method.imls
    is_imls = lo.matching_method.method == "IMLS"
    cap = _flat_query_cap(cfg)
    if cap is not None and flat.capacity > cap:
        flat = flat.slice(cap)
    tgt_normal, tgt_normal_ok = ((None, None) if candidates is not None else
                                 prepare_target(cfg, target, map_mode))
    # The map's normals live in the world frame, so the source normals
    # are rotated for the angle gate whatever transform_normal says.
    transform_normal = lo.transform_normal or map_mode
    grid = map_mode and lo.map.search == "grid_hash"
    voting = (is_imls and not imls_cfg.get_normals.enabled
              and imls_cfg.use_tensor_voting.enabled)
    # Projected and tensor-voting IMLS search the target every iteration,
    # as plo_tpu does (odometry.py:73-76, 236-243). Euclidean IMLS either
    # freezes its correspondences (refresh_correspondences=False): one
    # candidate search at the initial pose, then each iteration
    # re-evaluates gates, anchor, bandwidth and heights from the frozen
    # set at the current pose; or refreshes them by motion (hybrid,
    # refresh_motion_threshold > 0): a re-search once the accumulated
    # per-point motion since the last one reaches the threshold, frozen
    # in between. Threshold 0 and plane-ICP search every iteration.
    # On a map searched through the grid hash, only the frozen search
    # takes the grid; hybrid refresh is off there (odometry.py:243).
    euclid = is_imls and not imls_cfg.use_projected_distance.enabled and not voting
    frozen = candidates is not None or (euclid and not lo.refresh_correspondences)
    hybrid = (candidates is None and euclid and lo.refresh_correspondences
              and lo.refresh_motion_threshold > 0.0 and not grid)
    # (source, target, target normals, their validity) of each shard.
    if mesh is None:
        parts = [(flat, target, tgt_normal, tgt_normal_ok)]
    else:
        parts = list(zip(sharding.shard_cloud(flat, mesh),
                         *(sharding.replicate(x, mesh) for x in (target, tgt_normal,
                                                                  tgt_normal_ok))))

    def search(src_xyz, tgt):
        if grid:
            mp = lo.map
            return matching.imls_search_grid(src_xyz, tgt, imls_cfg, mp.grid_cell,
                                             mp.grid_m, mp.grid_buckets)
        return matching.imls_search(src_xyz, tgt, imls_cfg)

    def merged(srcs, results):
        """The moved source and its match, gathered over the shards."""
        if mesh is None:
            return srcs[0].xyz, results[0]
        gather = lambda rows: sharding.all_gather(mesh, rows)[:flat.capacity]
        return gather([s.xyz for s in srcs]), matching.MatchResult(
            y=gather([r.y for r in results]), normal=gather([r.normal for r in results]),
            valid=gather([r.valid for r in results]), counters={})  # the loop reads none

    rpose = (torch.eye(4, dtype=torch.float32, device=device)
             if init_pose is None else init_pose)
    if candidates is not None:
        caches = [candidates]
    elif frozen:
        caches = [search(geo.transform_points(rpose.to(f.xyz.device), f.xyz), t)
                  for f, t, _, _ in parts]
    moved = np.float32(np.inf)  # inf -> search at iteration 0
    i = 0
    n_corr = torch.zeros((), dtype=torch.int64, device=device)
    converged = torch.zeros((), dtype=torch.bool, device=device)
    probs = torch.ones(6, dtype=torch.float32, device=device)
    while i < sv.iterations:
        srcs = [_moved(f, rpose.to(f.xyz.device), transform_normal) for f, _, _, _ in parts]
        if frozen or hybrid:
            if hybrid and moved >= lo.refresh_motion_threshold:
                caches = [matching.imls_search(s.xyz, t, imls_cfg)
                          for s, (_, t, _, _) in zip(srcs, parts)]
                moved = np.float32(0.0)
            results = [matching.imls_project_cached(s, t, imls_cfg, c, tn, tok)
                       if candidates is None else
                       matching.imls_project_candidates(s, *c, imls_cfg)
                       for s, (_, t, tn, tok), c in zip(srcs, parts, caches)]
        else:
            results = [match_once(cfg, s, t, tn, tok) for s, (_, t, tn, tok) in zip(srcs, parts)]
        src_xyz, res = merged(srcs, results)
        n_corr = res.valid.sum()
        delta, converged, done, probs = _solve_step(cfg, src_xyz, res, n_corr, draws, i, probs)
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
    return rpose, i, n_corr, converged, probs


def icp_loop_with_artifacts(cfg: Config, flat: PointCloud, target: PointCloud, draws,
                            init_pose, device: torch.device, map_mode: bool, out_dir: str,
                            frame: int):
    """The ICP loop of the saver's artifact mode (plo_tpu's
    _icp_loop_with_artifacts and _make_icp_iteration), dumping the
    reference's per-iteration trail (laser_odometry.cpp:621-625) into
    `out_dir`: matched_points/f<frame>_i<iteration>.txt ("sx sy sz rx ry rz"
    rows of the matched pairs) and iter_poses.txt (a TUM line a iteration,
    stamped <frame>.<iteration>). Every iteration makes a full match, as
    plo_tpu's does: euclidean IMLS neither freezes nor refreshes by motion
    here, so on IMLS its poses can differ from icp_loop's; on plane-ICP the
    two loops are the same. Returns what icp_loop returns."""
    lo = cfg.laser_odometry
    cap = _flat_query_cap(cfg)
    if cap is not None and flat.capacity > cap:
        flat = flat.slice(cap)
    tgt_normal, tgt_normal_ok = prepare_target(cfg, target, map_mode)
    transform_normal = lo.transform_normal or map_mode
    rpose = (torch.eye(4, dtype=torch.float32, device=device)
             if init_pose is None else init_pose)
    n_corr = torch.zeros((), dtype=torch.int64, device=device)
    converged = torch.zeros((), dtype=torch.bool, device=device)
    probs = torch.ones(6, dtype=torch.float32, device=device)
    i = 0
    while i < lo.solve_method.iterations:
        src = _moved(flat, rpose, transform_normal)
        res = match_once(cfg, src, target, tgt_normal, tgt_normal_ok)
        n_corr = res.valid.sum()
        delta, converged, done, probs = _solve_step(cfg, src.xyz, res, n_corr, draws, i, probs)
        rpose = delta @ rpose
        saver.save_matched_points(src.xyz, res.y, res.valid, os.path.join(
            out_dir, "matched_points", f"f{frame:06d}_i{i:02d}.txt"))
        saver.save_pose_tum(rpose.cpu().numpy().astype(np.float64),
                            os.path.join(out_dir, "iter_poses.txt"), f"{frame}.{i:02d}")
        i += 1
        if bool(done):
            break
    return rpose, i, n_corr, converged, probs


def record_corr(cfg: Config, flat: PointCloud, target: PointCloud, rel_pose: torch.Tensor):
    """Bundle adjustment's correspondence record (plo_tpu's
    _make_record_corr, models/odometry.py:380-407): the newer frame's
    sampled cloud, moved by `rel_pose` into an older frame, in one full match
    against that frame's filtered cloud; the matched rows first, in order,
    then unmatched ones, up to ba.max_correspondences rows. Returns
    (s [n, 3] in the newer frame, y [n, 3], n [n, 3] in the older frame,
    valid [n]), all on the device."""
    lo = cfg.laser_odometry
    n_out = lo.ba.max_correspondences
    cap = _flat_query_cap(cfg)
    # Sliced only where the prefix still holds n_out rows to compact.
    if (cap or 0) >= n_out and flat.capacity > cap:
        flat = flat.slice(cap)
    tgt_normal, tgt_normal_ok = prepare_target(cfg, target, False)
    res = match_once(cfg, _moved(flat, rel_pose, lo.transform_normal), target,
                     tgt_normal, tgt_normal_ok)
    # A stable sort on the uint8 key ~valid (torch sorts no bool tensor).
    order = torch.argsort((~res.valid).to(torch.uint8), stable=True)[:n_out]
    return flat.xyz[order], res.y[order], res.normal[order], res.valid[order]


class Odometry:
    """Front-end + ICP back-end + float64 host pose chain. Runs on the CUDA
    card unless `device` names another; `device=None` with no card raises.

    `process_scan` takes one frame; `process_scans` takes a sequence and runs
    full batches of `batch` frames as one step each: one host-to-device copy
    of the batch's packed scans, the frames against the device-resident
    model (the [K, P] window, or the voxel map with the world pose and the
    last relative pose), and one packed result row per frame kept on the
    device. `transfer` is how a batch's scans cross to the device: "int16"
    (xyz in 5 mm fixed point), "float32", or "grid16" (the [H, W] uint16
    range raster; range_image configs only). As in the JAX package, frame 0
    and the frames of a short last batch go through `process_scan`, which
    ships float32 points (grid16: the raster).

    Results stay on the device until a drain fetches all pending rows in one
    copy: at every frame, unless `async_mode`, which drains every
    `sync_every` pending steps and at `finalize()` / `poses()`. The ICP loop
    still syncs with the host each iteration (module docstring). With BA, a
    per-frame step drains at once (the skip record's relative pose comes
    from the refined chain), a batch keeps its records on the device until
    its drain, and each refine fetches the window's [K, 4, 4] poses."""

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
        # Map target mode: the world-frame voxel map and the f32 world pose
        # on the device (the pose only seeds the next frame's ICP; the
        # trajectory is the float64 chain of the fetched world poses).
        self._map_mode = cfg.laser_odometry.target_mode == "map"
        self._device_map: Optional[PointCloud] = None
        self._world_dev: Optional[torch.Tensor] = None
        # (first frame index, rows [n, 24 + stats], BA records of the rows'
        # frames or None)
        self._pending: List[tuple] = []
        # Windowed BA (parallel/ba.py): each frame's correspondence records
        # to the previous and the skip (k-2) frame, {k: (rec_prev, rec_skip
        # or None)} on the device, and the last filtered clouds they match
        # against; the last `window` poses are refined jointly.
        self._ba = cfg.laser_odometry.ba.enabled
        self._ba_clouds: Deque[PointCloud] = deque(maxlen=cfg.laser_odometry.ba.window)
        self._ba_corr: Dict[int, tuple] = {}
        # Artifact mode (saver.enabled with an output_dir): the ICP loop
        # dumps each iteration's matched pairs and pose there, and
        # process_scans runs frame by frame.
        self._artifact_dir = (cfg.saver.output_dir
                              if cfg.saver.enabled and cfg.saver.output_dir else None)
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
        """icp_loop on this run's config, device and target mode (in
        artifact mode icp_loop_with_artifacts, for the frame being
        processed), without the convergence flag."""
        if self._artifact_dir is not None:
            rpose, i, n_corr, _, probs = icp_loop_with_artifacts(
                self.cfg, flat, target, draws, init_pose, self.device, self._map_mode,
                self._artifact_dir, self.frame_count)
        else:
            rpose, i, n_corr, _, probs = icp_loop(self.cfg, flat, target, draws, init_pose,
                                                  self.device, self._map_mode)
        return rpose, i, n_corr, probs

    def _advance(self, fe: FrontEndOutput, target: Optional[PointCloud], draws) -> torch.Tensor:
        """The back-end of one frame: ICP against `target` (None on frame 0),
        then the model update. Window mode: from the motion prior (the last
        rPose) or the identity, the window takes the filtered cloud. Map
        mode: from the world pose, or with the motion prior the world pose
        times the last relative pose; the solved world pose is projected onto
        SO(3), the relative pose follows from the previous world pose, and
        the filtered cloud enters the map at the new world pose. Returns the
        frame's packed result row [pose 16, iterations, correspondences, DRPM
        probabilities 6, stats] on the device; its pose is the rPose (window)
        or the world pose (map)."""
        dev = self.device
        lo = self.cfg.laser_odometry
        if target is None:
            rpose = torch.eye(4, dtype=torch.float32, device=dev)
            iters, n_corr = 0, torch.zeros((), dtype=torch.int64, device=dev)
            probs = torch.ones(6, dtype=torch.float32, device=dev)
            if self._map_mode:
                self._world_dev = rpose
        else:
            flat = fe.flat
            if lo.undistort and self._last_rel is not None:
                flat = undistort_cloud(flat, self._last_rel)
            prior = lo.motion_prior and self._last_rel is not None
            if self._map_mode:
                init = self._world_dev @ self._last_rel if prior else self._world_dev
            else:
                init = self._last_rel if prior else None
            rpose, iters, n_corr, probs = self._icp(flat, target, draws, init)
            if self._map_mode:
                rpose = _fix_pose(rpose)
                self._last_rel = _fix_pose(geo.se3_inverse(self._world_dev) @ rpose)
                self._world_dev = rpose
            else:
                self._last_rel = rpose
        # With undistortion, the model cloud is compensated with this frame's
        # solved motion (the last relative pose in both modes): a compensated
        # source against a distorted model matches worse than neither.
        filtered = fe.filtered
        if lo.undistort and target is not None:
            filtered = undistort_cloud(filtered, self._last_rel)
        if self._map_mode:
            self._map_insert(filtered)
        else:
            self._model_window(filtered)
        return torch.cat([rpose.reshape(-1), torch.full((1,), float(iters), device=dev),
                          n_corr.reshape(1).to(torch.float32), probs,
                          torch.stack([fe.stats[k] for k in STATS_KEYS]).to(torch.float32)])

    def _map_target(self) -> PointCloud:
        """The model a map-mode frame after the first matches against: the
        device map."""
        return self._device_map

    def _map_insert(self, filtered: PointCloud) -> None:
        """The filtered cloud moved to the world frame at the world pose and
        inserted into the device map (voxel_map_insert)."""
        mp = self.cfg.laser_odometry.map
        if self._device_map is None:
            self._device_map = _zeros_cloud(mp.capacity, self.device)
        world = dataclasses.replace(
            filtered, xyz=geo.transform_points(self._world_dev, filtered.xyz),
            normal=geo.rotate_vectors(self._world_dev, filtered.normal))
        self._device_map = voxel.voxel_map_insert(self._device_map, world, mp.voxel_size,
                                                  self._world_dev[:3, 3], mp.n_buckets)

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
        """One frame: front-end, ICP against the window or the map, model
        update, pose integration. `draws` replaces the run's own random
        numbers for this frame (an object with GeneratorDraws' methods).
        Returns the frame, or None in async_mode (results wait for a drain)."""
        self._note_truncation(len(raw_pts))
        draws = self.draws if draws is None else draws
        first = self.frame_count == 0
        scores = draws.frontend(self.frontend.n_draws(first), self.frontend.filtered_capacity)
        if self.transfer == "grid16":
            fe = self.frontend.process_grid(self._pack_grid(raw_pts), scores,
                                            self.last_filtered, first)
        else:
            fe = self.frontend.process(raw_pts, scores, self.last_filtered, first)
        target = None if first else (self._map_target() if self._map_mode else self._target())
        row = self._advance(fe, target, draws)
        self.last_filtered = fe.filtered
        self._pending.append((self.frame_count, row[None], None))
        self.frame_count += 1
        if self._ba:
            self._ba_step(fe, None if first else row[:16].reshape(4, 4))
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

    def _model_window(self, filtered: PointCloud) -> None:
        """The window takes a filtered cloud: the device window [K, P] while a
        batch runs, else the cloud queue (accumulateTargetCloud, :116-136)."""
        if self._device_window is not None:
            self._device_window = _map_fields(lambda a, n: torch.cat([a[1:], n[None]]),
                                              self._device_window, filtered)
            return
        self.cloud_queue.append(filtered)
        while len(self.cloud_queue) > self.cfg.laser_odometry.max_queue_size:
            self.cloud_queue.popleft()

    def _batch_step(self, raws_dev: torch.Tensor, nvs: np.ndarray, draws: Sequence) -> None:
        """Frames 1.. of a run as one step on uploaded scans: each frame's
        front-end and ICP against the device window or map, the model, world
        pose and last relative pose kept on the device, the rows too
        (plo_tpu's _cached_batch_step)."""
        if not self._map_mode:
            self._device_window = self._window_state()
            self.cloud_queue.clear()
        last = self.last_filtered
        # BA records each frame inside the loop, as plo_tpu's batch_step_ba:
        # the previous frame's filtered cloud at the solved rPose, and the
        # one before it (`prev`) at the pre-refinement skip rel prior @ rPose
        # (the per-frame path takes the skip rel from the refined chain).
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        prev = (self._ba_clouds[-2] if len(self._ba_clouds) >= 2 else
                _zeros_cloud(self.frontend.filtered_capacity, self.device))
        rows, recs = [], ([] if self._ba else None)
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
            target = (self._map_target() if self._map_mode else
                      _map_fields(lambda a: a.reshape((-1,) + a.shape[2:]), self._device_window))
            prior = eye if self._last_rel is None else self._last_rel
            rows.append(self._advance(fe, target, d))
            if self._ba:
                rpose = rows[-1][:16].reshape(4, 4)
                recs.append((record_corr(self.cfg, fe.flat, last, rpose),
                             record_corr(self.cfg, fe.flat, prev, prior @ rpose)
                             if self.frame_count + j >= 2 else None))
            prev, last = last, fe.filtered
        if self._ba:
            self._ba_clouds.clear()
            self._ba_clouds.extend((prev, last))
        self._pending.append((self.frame_count, torch.stack(rows), recs))
        self.last_filtered = last
        self.frame_count += len(rows)
        if not self.async_mode or len(self._pending) >= self.sync_every:
            self._drain()

    def process_scans(self, scans, batch: int = 8, draws: Optional[Sequence] = None):
        """Process a sequence of raw scans: frame 0, a last batch shorter
        than `batch` and every frame in artifact mode frame by frame, the
        rest in steps of `batch` frames.
        `draws` gives each scan's draws object (None entries: the run's
        own). In async_mode, call finalize() (or poses()) after."""
        scans = list(scans)
        draws = [None] * len(scans) if draws is None else list(draws)
        i = 0
        while i < len(scans):
            if (self.frame_count == 0 or len(scans) - i < batch
                    or self._artifact_dir is not None):
                self.process_scan(scans[i], draws[i])
                i += 1
                continue
            self._batch_step(*self._upload_batch(scans[i:i + batch]), draws[i:i + batch])
            i += batch
        return self

    def _drain(self) -> None:
        """Fetch every pending frame's row in one device-to-host copy and
        integrate the poses in float64 (nowPose = prevLaserPose * rPose,
        laser_odometry.cpp:652); a batched frame with BA records then
        refines the window ending at it."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        host = torch.cat([rows for _, rows, _ in pending]).cpu().numpy().astype(np.float64)
        k = 0
        for first, rows, recs in pending:
            for j in range(rows.shape[0]):
                self._append_frame(first + j, host[k])
                k += 1
                if recs is not None:
                    self._ba_corr[first + j] = recs[j]
                    self._ba_refine_at(first + j)

    def _ba_step(self, fe: FrontEndOutput, rpose: Optional[torch.Tensor]) -> None:
        """BA after one frame (plo_tpu's _ba_step): record its
        correspondences to the previous frame at the solved rPose and to the
        skip frame k-2 at the refined chain's relative pose, then refine the
        window ending at it. BA is a smoother: it rewrites the float64
        trajectory; the model clouds already used stay as they are."""
        self._drain()   # the skip rel comes from the materialized chain
        k = self.frame_count - 1
        if rpose is not None and self._ba_clouds:
            rec_skip = None
            if len(self._ba_clouds) >= 2 and k >= 2 and self._traj_pos(k - 2) >= 0:
                rel_skip = (np.linalg.inv(self.trajectory[self._traj_pos(k - 2)].pose)
                            @ self.trajectory[self._traj_pos(k)].pose)
                rec_skip = record_corr(self.cfg, fe.flat, self._ba_clouds[-2], torch.as_tensor(
                    rel_skip.astype(np.float32), device=self.device))
            self._ba_corr[k] = (record_corr(self.cfg, fe.flat, self._ba_clouds[-1], rpose),
                                rec_skip)
        self._ba_clouds.append(fe.filtered)
        self._ba_refine_at(k)

    def _traj_pos(self, frame_index: int) -> int:
        """The list position of a frame index in the trajectory (they differ
        after a resume that restores only the trajectory's tail)."""
        return frame_index - (self.trajectory[0].index if self.trajectory else 0)

    def ba_window(self, k: int):
        """The window of `ba.window` frames ending at frame k and the
        arguments of its parallel.ba.refine_window call: the window's poses
        from the float64 trajectory as f32, its consecutive-pair records
        (i, i+1) then its skip-pair records (i, i+2), stacked on the device.
        None while the window is not full or a record is missing."""
        ba = self.cfg.laser_odometry.ba
        K = ba.window
        w = list(range(k - K + 1, k + 1))
        if w[0] < 0 or self._traj_pos(w[0]) < 0 or any(
                i not in self._ba_corr or (idx >= 2 and self._ba_corr[i][1] is None)
                for idx, i in enumerate(w) if idx >= 1):
            return None
        pairs = (tuple((i, i + 1) for i in range(K - 1))
                 + tuple((i, i + 2) for i in range(K - 2)))
        recs = ([self._ba_corr[w[i + 1]][0] for i in range(K - 1)]
                + [self._ba_corr[w[i + 2]][1] for i in range(K - 2)])
        src, ref, nrm, val = (torch.stack([r[f] for r in recs]) for f in range(4))
        poses = torch.as_tensor(np.stack([self.trajectory[self._traj_pos(i)].pose for i in w])
                                .astype(np.float32), device=self.device)
        return w, (poses, src, ref, nrm, val, K, ba.iterations, ba.damping, pairs,
                   ba.huber_delta)

    def _ba_refine_at(self, k: int) -> None:
        """Refine the window of `ba.window` poses ending at frame k on the
        device over its consecutive and skip records, then write it back on
        the host (plo_tpu's _ba_refine_at): each rotation projected onto
        SO(3) by an SVD with the determinant fix, the relative poses
        re-chained, the window's first pose fixed. Records older than the
        window are dropped; nothing is refined until the window is full and
        every skip record is there."""
        K = self.cfg.laser_odometry.ba.window
        for old in [i for i in self._ba_corr if i <= k - K]:
            del self._ba_corr[old]
        window = self.ba_window(k)
        if window is None:
            return
        w, args = window
        refined = ba_ops.refine_window(*args).cpu().numpy().astype(np.float64)
        for j, i in enumerate(w[1:], start=1):
            u, _, vt = np.linalg.svd(refined[j][:3, :3])
            pose = np.eye(4)
            pose[:3, :3] = u @ np.diag([1, 1, np.linalg.det(u @ vt)]) @ vt
            pose[:3, 3] = refined[j][:3, 3]
            ti = self._traj_pos(i)
            self.trajectory[ti] = dataclasses.replace(
                self.trajectory[ti], pose=pose,
                rel_pose=np.linalg.inv(self.trajectory[ti - 1].pose) @ pose)
        self.prev_pose = self.trajectory[-1].pose

    def _append_frame(self, index: int, row: np.ndarray) -> None:
        """One fetched row into the float64 chain: its pose is the rPose
        (pose = prevLaserPose * rPose, :652) or in map mode the world pose
        (rel = prevLaserPose^-1 * pose)."""
        stats = dict(zip(STATS_KEYS, (float(v) for v in row[24:])))
        stats.update({f"drpm_prob_{j}": float(row[18 + j]) for j in range(6)})
        mat = row[:16].reshape(4, 4)
        if self._map_mode:
            pose, rel = mat, np.linalg.inv(self.prev_pose) @ mat
        else:
            pose, rel = self.prev_pose @ mat, mat
        self.prev_pose = pose
        self.trajectory.append(OdometryFrame(
            index=index, pose=pose, rel_pose=rel, iterations=int(row[16]),
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
