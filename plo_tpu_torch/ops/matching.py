"""Stage 4 — plane-ICP projection and euclidean IMLS surface projection
(the port of plo_tpu/ops/matching.py; laser_odometry.cpp:277-413,
imls_icp.cpp:301-745).

The reference's erase-in-place rejection cascades become validity masks,
with exclusive first-failure counters per reason.
  * plane-ICP: the anchor is the nearest target within r (euclidean mode,
    :343-360) or the projected-distance argmin under the quirk gates
    |d| < r^2, proj < r_proj (:316-334, kept as-is); no h gate.
  * IMLS: the anchor is the nearest target within r (k=1 NN, :597-610),
    rejected beyond h (:620-625); the height is the IMLS weighted projection
    with the adaptive bandwidth h_max = sqrt(nearDist2[n_accepted-1]) / 3
    (:468, a reference quirk kept).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.config import IMLSConfig, PlaneICPConfig
from plo_tpu_torch.ops import cuda_nn, grid_hash, neighbors
from plo_tpu_torch.ops.eigh3 import eigh3_descending


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """Correspondences y_i for surviving source points x_i."""

    y: torch.Tensor        # [S, 3] matched point on the target surface
    normal: torch.Tensor   # [S, 3] target-surface normal at the match
    valid: torch.Tensor    # [S] bool — survived the whole cascade
    counters: Dict[str, torch.Tensor]  # per-reason exclusive rejection counts


def _angle_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle between vector batches in degrees (imls_icp.cpp:444-445)."""
    cos = (a * b).sum(-1) / (torch.linalg.norm(a, dim=-1)
                             * torch.linalg.norm(b, dim=-1)).clamp_min(1e-12)
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def _counters(eligible, stages):
    """Exclusive first-failure attribution."""
    out = {}
    alive = eligible
    for name, passed in stages:
        out[name] = (alive & ~passed).sum()
        alive = alive & passed
    return out, alive


def plane_icp_project(source: PointCloud, target: PointCloud,
                      cfg: PlaneICPConfig) -> MatchResult:
    """plane_ICP_proj (laser_odometry.cpp:277-413): y = x - ((x - p) . n) n
    for the anchor p with normal n (plo_tpu.ops.matching._plane_icp_impl).
    Counters: too_far (no anchor), invalid_normal, normal_constraint."""
    cap = target.capacity
    if cfg.use_projected_distance.enabled:
        # Quirk gates: |d| < r^2 and proj < r_proj (laser_odometry.cpp:322);
        # r^2 in f32, as the JAX package computes it from its traced r.
        r = np.float32(cfg.r)
        _, idx, found = neighbors.projected_argmin(
            source.xyz, source.normal, target.xyz, target.valid,
            euclid_gate=float(r * r), proj_gate=cfg.use_projected_distance.r_proj)
    else:
        _, idx, found = neighbors.nearest(source.xyz, target.xyz, target.valid, radius=cfg.r)
    idx_c = idx.clamp(0, cap - 1)
    n = target.normal[idx_c]
    p = target.xyz[idx_c]
    normal_ok = found & target.valid[idx_c] & torch.isfinite(n).all(-1)
    ang = cfg.normal_angle_constraint
    if ang.enabled:
        angle_ok = _angle_deg(source.normal, n) <= ang.angle_diff_threshold
    else:
        angle_ok = torch.ones_like(found)
    counters, alive = _counters(source.valid, [
        ("too_far", found),
        ("invalid_normal", normal_ok),
        ("normal_constraint", angle_ok),
    ])
    proj = ((source.xyz - p) * n).sum(-1)
    y = source.xyz - proj[:, None] * n
    return MatchResult(y=torch.where(alive[:, None], y, 0.0),
                       normal=torch.where(alive[:, None], n, 0.0),
                       valid=alive, counters=counters)


def precompute_target_normals(xyz: torch.Tensor, valid: torch.Tensor,
                              r_normal: float, k: int):
    """ComputeNormal (imls_icp.cpp:753-794) for every target point: PCA of
    its k nearest neighbors within r_normal; not ok with fewer than k.
    Returns (normals [T, 3], ok [T])."""
    _, idx, nvalid = neighbors.knn(xyz, xyz, valid, k=k, radius=r_normal)
    count = nvalid.sum(1)
    pts = xyz[idx.clamp(0, xyz.shape[0] - 1)]
    w = nvalid[..., None].to(torch.float32)
    denom = count[:, None, None].to(torch.float32).clamp_min(1.0)
    mu = (pts * w).sum(1, keepdim=True) / denom
    c = (pts - mu) * w
    _, vecs = eigh3_descending(torch.einsum("tki,tkj->tij", c, c) / denom)
    normal = vecs[:, :, 2]
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True).clamp_min(1e-12)
    ok = valid & (count >= k)
    return torch.where(ok[:, None], normal, 0.0), ok


def _height(diff, nnrm, n_ok, near_d2, k):
    """IMLS height with the adaptive bandwidth of the sorted in-radius
    distances near_d2 (imls_icp.cpp:468-480)."""
    n_accepted = n_ok.sum(1)
    pick = (n_accepted - 1).clamp(0, k - 1)
    d_far2 = torch.gather(near_d2, 1, pick[:, None])[:, 0]
    d_far2 = torch.where(torch.isfinite(d_far2), d_far2, 0.0)
    h_max = torch.sqrt(d_far2.clamp_min(0.0)) / 3.0
    h_max2 = (h_max * h_max).clamp_min(1e-20)
    d2_euclid = (diff * diff).sum(-1)
    w = torch.where(n_ok, torch.exp(-d2_euclid / h_max2[:, None]), 0.0)
    proj = (diff * nnrm).sum(-1)
    height = (w * proj).sum(1) / (w.sum(1) + 1e-5)
    return height, n_accepted >= 3


def _finish(src_xyz, src_valid, n_anchor, height, stages) -> MatchResult:
    counters, alive = _counters(src_valid, stages)
    y = src_xyz - height[:, None] * n_anchor
    return MatchResult(y=torch.where(alive[:, None], y, 0.0),
                       normal=torch.where(alive[:, None], n_anchor, 0.0),
                       valid=alive, counters=counters)


def imls_project(source: PointCloud, target: PointCloud, cfg: IMLSConfig,
                 target_normal=None, target_normal_ok=None,
                 anchor_normal_src=None, anchor_ok_src=None) -> MatchResult:
    """ProjSourcePtToSurface (imls_icp.cpp:496-745) with a full target search:
    y = x - I(x) n (plo_tpu.ops.matching._imls_impl). Euclidean mode: the
    anchor is the first kNN result. Projected mode
    (use_projected_distance): the anchor is the projected-distance argmin
    and the neighborhood the projected top-k, both under |d| < r_proj and
    proj < r (imls_icp.cpp:563-595, 341-364), with the squared projected
    distances as the bandwidth's sorted distances (:587). With
    `anchor_normal_src` (tensor-voting IMLS) the anchor normal is the SOURCE
    point's voted normal (imls_icp.cpp:634-644, a reference quirk kept)."""
    tn = target.normal if target_normal is None else target_normal
    tok = target.valid if target_normal_ok is None else target.valid & target_normal_ok
    cap = target.capacity
    k = cfg.search_number
    pd = cfg.use_projected_distance
    if pd.enabled:
        pmin, aidx, found = neighbors.projected_argmin(
            source.xyz, source.normal, target.xyz, target.valid,
            euclid_gate=pd.r_proj, proj_gate=cfg.r)
        npd, nidx, nfound = neighbors.projected_knn(
            source.xyz, source.normal, target.xyz, target.valid, k,
            euclid_gate=pd.r_proj, proj_gate=cfg.r)
        min_dist, near_d2 = pmin * pmin, npd * npd
    else:
        near_d2, nidx, nfound = neighbors.knn(source.xyz, target.xyz, target.valid,
                                              k=k, radius=cfg.r)
        min_dist, aidx, found = near_d2[:, 0], nidx[:, 0], nfound[:, 0]
    if anchor_normal_src is None:
        aidx_c = aidx.clamp(0, cap - 1)
        n_anchor = tn[aidx_c]
        anchor_normal_ok = tok[aidx_c] & torch.isfinite(n_anchor).all(-1)
    else:
        n_anchor = anchor_normal_src
        anchor_normal_ok = anchor_ok_src & torch.isfinite(n_anchor).all(-1)
    nidx_c = nidx.clamp(0, cap - 1)
    nnrm = tn[nidx_c]
    n_ok = nfound & tok[nidx_c]
    return _evaluate(source, target.xyz[nidx_c], nnrm, n_ok, near_d2, found,
                     min_dist, n_anchor, anchor_normal_ok, cfg)


def _evaluate(source, npts, nnrm, n_ok, near_d2, found, min_dist, n_anchor,
              anchor_normal_ok, cfg: IMLSConfig, h2=None) -> MatchResult:
    """The IMLS gates, bandwidth and height at the source's current
    positions; the anchor is rejected beyond sqrt(h2) (default: h squared
    in f32, as a traced gate)."""
    ang = cfg.normal_angle_constraint
    if ang.enabled:
        anchor_angle_ok = _angle_deg(source.normal, n_anchor) <= ang.angle_diff_threshold
        nang = _angle_deg(source.normal[:, None, :].expand(nnrm.shape), nnrm)
        n_ok = n_ok & (nang <= ang.angle_diff_threshold)
    else:
        anchor_angle_ok = torch.ones_like(found)
    diff = source.xyz[:, None, :] - npts
    height, enough = _height(diff, nnrm, n_ok, near_d2, cfg.search_number)
    stages = [
        ("too_far", found & (min_dist <= (cuda_nn.f32_square(cfg.h) if h2 is None else h2))),
        ("invalid_normal", anchor_normal_ok),
        ("normal_constraint", anchor_angle_ok),
        ("mls_fail", enough),
        ("nan_inf_height", torch.isfinite(height)),
    ]
    return _finish(source.xyz, source.valid, n_anchor, height, stages)


def imls_search(src_xyz: torch.Tensor, target: PointCloud, cfg: IMLSConfig):
    """Candidate search only: the k nearest target points within r
    (plo_tpu.ops.matching._imls_search_impl). Returns (nidx, nfound)."""
    _, nidx, nfound = neighbors.knn(src_xyz, target.xyz, target.valid,
                                    k=cfg.search_number, radius=cfg.r)
    return nidx, nfound


def imls_search_grid(src_xyz: torch.Tensor, target: PointCloud, cfg: IMLSConfig,
                     grid_cell: float, grid_m: int, grid_buckets: int):
    """Candidate search through the grid hash (ops/grid_hash.py), for
    voxel-map targets: the k nearest within r among 27*grid_m gathered
    candidates (plo_tpu.ops.matching.imls_search_grid), with cells of edge
    min(r, grid_cell). Exact where each cell holds at most grid_m points,
    which a voxel map of edge voxel_size guarantees for grid_cell / voxel_size
    <= cbrt(grid_m); neighbors between grid_cell and r can be missed.
    Returns (nidx, nfound) as `imls_search`."""
    cell = min(cfg.r, grid_cell)
    gh = grid_hash.build(target.xyz, target.valid, cell, grid_buckets)
    _, idx, ok = grid_hash.knn(gh, src_xyz, cfg.search_number, cfg.r, m=grid_m)
    return idx, ok


def imls_project_cached(source: PointCloud, target: PointCloud, cfg: IMLSConfig,
                        cache, target_normal=None, target_normal_ok=None) -> MatchResult:
    """IMLS projection against a frozen candidate set from `imls_search`
    (plo_tpu.ops.matching._imls_eval_cached): the candidates' rows gathered
    from the target, then evaluated as `_evaluate_gathered` does. At the
    search pose it equals `imls_project`."""
    tn = target.normal if target_normal is None else target_normal
    tok = target.valid if target_normal_ok is None else target.valid & target_normal_ok
    nidx, nfound = cache
    nidx_c = nidx.clamp(0, target.capacity - 1)
    return _evaluate_gathered(source, target.xyz[nidx_c], tn[nidx_c], tok[nidx_c], nfound,
                              cuda_nn.f32_square(cfg.r), cuda_nn.f32_square(cfg.h), cfg)


def imls_project_candidates(source: PointCloud, cand_xyz, cand_normal, cand_normal_ok,
                            cand_present, cfg: IMLSConfig) -> MatchResult:
    """IMLS projection against gathered candidate rows ([S, k, 3] points and
    normals, [S, k] masks): the sharded map's path, whose distributed search
    returns the candidates themselves (parallel/map_store.py knn_gather), so
    the evaluation never touches the whole map
    (plo_tpu.ops.matching.imls_project_candidates). plo_tpu squares r and h
    there as Python numbers of its config, in double before the f32 compare,
    where the cached path squares them in f32; so does this."""
    if cfg.use_projected_distance.enabled:
        raise ValueError("candidates mode is euclidean-only")
    return _evaluate_gathered(source, cand_xyz, cand_normal, cand_normal_ok, cand_present,
                              float(np.float32(cfg.r * cfg.r)),
                              float(np.float32(cfg.h * cfg.h)), cfg)


def _evaluate_gathered(source, npts, nnrm, neighbor_normal_ok, cand_present, r2: float,
                       h2: float, cfg: IMLSConfig) -> MatchResult:
    """IMLS over gathered candidates (plo_tpu.ops.matching._imls_eval_gathered):
    distances, the radius re-gate (d2 <= r2), the anchor (the nearest
    present candidate), the h gate (h2), bandwidth and height all from the
    CURRENT source pose; only the candidate identities are frozen."""
    diff = source.xyz[:, None, :] - npts
    d2_euclid = (diff * diff).sum(-1)
    present = cand_present & (d2_euclid <= r2)   # radius re-gate
    d2_masked = torch.where(present, d2_euclid, math.inf)
    j_star = torch.argmin(d2_masked, dim=1, keepdim=True)
    found = present.any(1)
    min_dist = torch.where(found, torch.gather(d2_masked, 1, j_star)[:, 0], 0.0)
    n_anchor = torch.gather(nnrm, 1, j_star[..., None].expand(-1, 1, 3))[:, 0]
    anchor_normal_ok = (torch.gather(neighbor_normal_ok, 1, j_star)[:, 0]
                        & torch.isfinite(n_anchor).all(-1))
    near_d2 = torch.sort(d2_masked, dim=1).values
    return _evaluate(source, npts, nnrm, present & neighbor_normal_ok, near_d2,
                     found, min_dist, n_anchor, anchor_normal_ok, cfg, h2)
