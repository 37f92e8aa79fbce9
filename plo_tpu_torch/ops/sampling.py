"""Stage 3b — three-axis, random, normal-direction and major-axis sampling,
and farthest-point sampling (the port of plo_tpu/ops/sampling.py,
scan_registration.cpp:492-759, common.cpp:19-85).

Every sampler returns a fixed-size index set (idx [S], valid [S]). Random
numbers come in as arguments (uniform [0, 1) scores of length P), so tests
can feed the draws the JAX package made.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from plo_tpu_torch.ops import cuda_nn


def compact_indices(keep: torch.Tensor, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kept indices first in ascending order, cut to [size];
    valid[j] = j < n_kept."""
    n_keep = keep.sum()
    valid = torch.arange(size, device=keep.device) < n_keep
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    return order[:size], valid


def random_sampling(candidates: torch.Tensor, scores: torch.Tensor, max_points: int):
    """Random subset of the candidate points (scan_registration.cpp:566-582):
    the candidates in ascending order of their uniform [0, 1) `scores` (the
    draw jax.random.uniform(key, (P,)) of plo_tpu's random_sampling), cut to
    max_points; a stable sort, as jnp.argsort is, so ties keep index order.
    Returns (idx [max_points], valid [max_points])."""
    order = torch.argsort(torch.where(candidates, scores, math.inf), stable=True)
    valid = torch.arange(max_points, device=candidates.device) < candidates.sum()
    return order[:max_points], valid


def spherical_bins(normals: torch.Tensor, azimuth_bins: int, elevation_bins: int) -> torch.Tensor:
    """Bin id of each normal direction (computeSphericalHistogram,
    scan_registration.cpp:536-564), in [0, Ab*Eb)."""
    az = torch.atan2(normals[:, 1], normals[:, 0])
    el = torch.arcsin(normals[:, 2].clamp(-1.0, 1.0))
    az = torch.where(az < 0, az + 2 * math.pi, az)
    el = el + math.pi / 2
    ai = torch.clamp_max((az / (2 * math.pi / azimuth_bins)).long(), azimuth_bins - 1)
    ei = torch.clamp_max((el / (math.pi / elevation_bins)).long(), elevation_bins - 1)
    return ai * elevation_bins + ei


def _rank_within_bins(bins: torch.Tensor, member: torch.Tensor, scores: torch.Tensor,
                      n_bins: int):
    """Rank (0-based) of each member within its bin by ascending score, ties
    by index — a lexsort on (bin, score) as two stable sorts. Non-members get
    rank P. Also returns the per-bin member counts."""
    p = bins.shape[0]
    safe_bins = torch.where(member, bins, n_bins)
    counts_full = torch.bincount(safe_bins, minlength=n_bins + 1)
    by_score = torch.argsort(torch.where(member, scores, math.inf), stable=True)
    order = by_score[torch.argsort(safe_bins[by_score], stable=True)]
    starts = torch.cumsum(counts_full, 0) - counts_full
    rank_sorted = torch.arange(p, device=bins.device) - starts[safe_bins[order]]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return torch.where(member, rank, p), counts_full[:n_bins]


def normal_sampling(normals: torch.Tensor, candidates: torch.Tensor, scores: torch.Tensor,
                    azimuth_bins: int, elevation_bins: int, min_points_per_bin: int,
                    max_points_per_bin: int, out_size: int, strategy: str = "random",
                    xyz: torch.Tensor = None):
    """Spherical-histogram sampling (normalSampling,
    scan_registration.cpp:584-629). Within-bin ranks come from the random
    `scores` (strategy "random") or from a farthest-first traversal whose
    slot order the scores set (strategy "FPS", :605-614; needs `xyz`)."""
    n_bins = azimuth_bins * elevation_bins
    bins = spherical_bins(normals, azimuth_bins, elevation_bins)
    if strategy == "FPS":
        rank, counts = fps_rank_within_bins(
            xyz, bins, candidates, scores, n_bins, bin_capacity=1024,
            max_rank=max_points_per_bin)
    else:
        rank, counts = _rank_within_bins(bins, candidates, scores, n_bins)
    binc = counts[bins.clamp(0, n_bins - 1)]
    keep = candidates & (binc >= min_points_per_bin) & (rank < max_points_per_bin)
    return compact_indices(keep, out_size)


def fps_rank_within_bins(xyz: torch.Tensor, bins: torch.Tensor, member: torch.Tensor,
                         scores: torch.Tensor, n_bins: int, bin_capacity: int,
                         max_rank: int, needed: Optional[torch.Tensor] = None):
    """Farthest-point rank of each member within its bin
    (scan_registration.cpp:605-614, 736-744). Members go into a dense
    [n_bins, bin_capacity] slot table in random order (`scores`; bins past
    capacity keep a random subset), the fps_ranks kernel traverses every bin
    until ranks 0..min(needed, max_rank)-1 are assigned (all max_rank
    without `needed`), and the ranks are scattered back. Unranked members get
    max_rank."""
    p = xyz.shape[0]
    if p >= 1 << 24:
        # The packed payload carries the source index as f32, exact below 2^24.
        raise ValueError(f"fps_rank_within_bins: {p} points, the f32 index payload "
                         "is exact only below 2**24")
    dev = xyz.device
    rank0, counts = _rank_within_bins(bins, member, scores, n_bins)
    slot_ok = member & (rank0 < bin_capacity)
    dump = n_bins * bin_capacity
    dest = torch.where(slot_ok, bins.clamp(0, n_bins - 1) * bin_capacity + rank0, dump)
    # ONE packed scatter builds the xyz, occupancy and source-index tables.
    # (bin, rank0) pairs are unique, so the only row written more than once
    # is the dump row, which is dropped.
    payload = torch.cat([xyz, torch.ones((p, 1), dtype=torch.float32, device=dev),
                         torch.arange(p, dtype=torch.float32, device=dev)[:, None]], dim=1)
    packed = torch.zeros((dump + 1, 5), dtype=torch.float32, device=dev)
    packed[dest] = payload
    packed = packed[:-1]
    table_xyz = packed[:, :3].reshape(n_bins, bin_capacity, 3).contiguous()
    table_occ = packed[:, 3].reshape(n_bins, bin_capacity).contiguous()
    src_index = torch.where(table_occ.reshape(-1) > 0.5, packed[:, 4].long(), p)

    steps = (torch.full((), max_rank, dtype=torch.int32, device=dev) if needed is None
             else needed.clamp(max=max_rank).to(torch.int32).reshape(()))
    bin_ranks = cuda_nn.fps_ranks(table_xyz, table_occ, steps, max_rank)
    # Empty slots all go to the dump entry p, which is dropped.
    flat_rank = torch.full((p + 1,), max_rank, dtype=torch.int32, device=dev)
    flat_rank[src_index] = bin_ranks.reshape(-1)
    return torch.where(member, flat_rank[:p], max_rank), counts


def major_axis_sampling(xyz: torch.Tensor, normals: torch.Tensor, candidates: torch.Tensor,
                        last_xyz: torch.Tensor, last_valid: torch.Tensor,
                        sub_scores: torch.Tensor, sel_scores: torch.Tensor,
                        r: float, r_proj: float, max_total_points: int,
                        azimuth_bins: int, elevation_bins: int,
                        min_points_per_bin: int, max_points_per_bin: int,
                        out_size: int, strategy: str = "FPS"):
    """Weighted-bin sampling against the previous frame's cloud
    (majorAxisSampling, scan_registration.cpp:631-759). `sub_scores` drive
    the weight-estimation subsample; `sel_scores` the quota selection: the
    random slot order of the FPS tables (strategy "FPS") or the random
    within-bin ranks (strategy "random", :736-748)."""
    n_bins = azimuth_bins * elevation_bins
    bins = spherical_bins(normals, azimuth_bins, elevation_bins)

    # Phase 1 — bin weights from a per-bin random subsample of up to
    # max_points_per_bin members (:658-664), scanned against the previous
    # cloud under the cylinder gates (:676-701).
    rank, counts = _rank_within_bins(bins, candidates, sub_scores, n_bins)
    binc = counts[bins.clamp(0, n_bins - 1)]
    bin_live = binc >= min_points_per_bin
    in_subsample = candidates & bin_live & (rank < max_points_per_bin)
    sub_cap = min(n_bins * max_points_per_bin, candidates.shape[0])
    sub_idx, sub_valid = compact_indices(in_subsample, sub_cap)
    # Valid-prefix bound of the previous (ring-sorted) cloud; stays on the
    # device, the kernel reads it there.
    p_t = last_valid.shape[0]
    t_live = torch.where(last_valid, torch.arange(1, p_t + 1, device=xyz.device), 0
                         ).max().to(torch.int32)
    cnt, dsum = cuda_nn.cylinder_stats(xyz[sub_idx], normals[sub_idx], last_xyz,
                                       last_valid, r_proj, r, t_live=t_live)
    has3 = sub_valid & (cnt >= 3)
    avg_dist = torch.where(has3, dsum / cnt.clamp_min(1).to(torch.float32), 0.0)

    safe_bins = torch.where(has3, bins[sub_idx], n_bins)
    bin_valid_samples = torch.bincount(safe_bins, minlength=n_bins + 1)[:n_bins]
    # Per-bin sum as a one-hot reduction: index_add_ on CUDA adds in atomic
    # order, which would make the quotas differ from run to run.
    bin_dist_sum = (F.one_hot(safe_bins, n_bins + 1).to(torch.float32)
                    * avg_dist[:, None]).sum(0)[:n_bins]
    bin_weight = torch.where(
        bin_valid_samples >= 3,
        bin_dist_sum / bin_valid_samples.clamp_min(1).to(torch.float32), 0.0)
    total_w = bin_weight.sum()
    bin_weight = torch.where(total_w > 0, bin_weight / total_w.clamp_min(1e-12), 0.0)

    # Phase 2 — quota selection (:726-758): quota = min(weight*max_total, size).
    quota = torch.minimum((bin_weight * max_total_points).long(), counts)
    if strategy == "FPS":
        # Clamped to the FPS rank range, so sentinel-ranked members never pass.
        max_rank = min(max_total_points, 1024)
        quota = quota.clamp(max=max_rank)
        rank2, _ = fps_rank_within_bins(xyz, bins, candidates, sel_scores, n_bins,
                                        bin_capacity=1024, max_rank=max_rank,
                                        needed=quota.max())
    else:
        rank2, _ = _rank_within_bins(bins, candidates, sel_scores, n_bins)
    my_quota = quota[bins.clamp(0, n_bins - 1)]
    keep = candidates & bin_live & (rank2 < my_quota)
    return compact_indices(keep, out_size)


def _descending_key(scores: torch.Tensor) -> torch.Tensor:
    """int64 keys that order as (score descending, index ascending) do: the
    f32 score mapped to a signed int in IEEE total order (-0 below +0, as
    lax.top_k orders them) in the high word, the complement of the index in
    the low word. The keys are distinct, so torch.topk on them has one
    answer on any device."""
    bits = scores.contiguous().view(torch.int32).to(torch.int64)
    total = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.arange(scores.shape[-1], device=scores.device)
    return total * (1 << 32) + (0xFFFFFFFF - idx)


def three_axis_sampling(xyz: torch.Tensor, normals: torch.Tensor, eigvals: torch.Tensor,
                        candidates: torch.Tensor, points_per_list: int):
    """IMLS-SLAM three-axis sampling (threeAxisSampling,
    scan_registration.cpp:492-533): the candidates scored on 9 lists
    (+-a2D (x cross n) per axis, a2D |n| per axis), the top points_per_list
    of each, duplicates allowed; equal scores go to the lower index, as
    lax.top_k takes them. Returns (idx, valid) of size 9 * points_per_list."""
    safe = lambda x: x.clamp_min(1e-20)
    l1, l2, l3 = eigvals[:, 0], eigvals[:, 1], eigvals[:, 2]
    a_d = (torch.sqrt(safe(l2)) - torch.sqrt(safe(l3))) / torch.sqrt(safe(l1))
    a2d = a_d * a_d
    cross = torch.linalg.cross(xyz, normals)
    scores = torch.stack([
        a2d * cross[:, 0], -a2d * cross[:, 0],
        a2d * cross[:, 1], -a2d * cross[:, 1],
        a2d * cross[:, 2], -a2d * cross[:, 2],
        a2d * normals[:, 0].abs(), a2d * normals[:, 1].abs(), a2d * normals[:, 2].abs(),
    ])
    scores = torch.where(candidates[None, :], scores, -math.inf)
    top = torch.topk(_descending_key(scores), points_per_list, dim=1).values
    idx = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    n = torch.clamp_max(candidates.sum(), points_per_list)
    valid = torch.arange(points_per_list, device=xyz.device)[None, :].expand(9, -1) < n
    return idx.reshape(-1), valid.reshape(-1)


def farthest_point_sampling(xyz: torch.Tensor, valid: torch.Tensor, first: torch.Tensor,
                            num_samples: int) -> torch.Tensor:
    """Exact greedy farthest-point sampling (farthestPointSampling,
    common.cpp:19-85; plo_tpu.ops.sampling.farthest_point_sampling): the
    first pick is the `first`-th valid point (a draw in [0, n_valid)), each
    next one the valid point farthest from all picked so far (lowest index on
    ties). Returns idx [num_samples]."""
    p = xyz.shape[0]
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    first_idx = order[first.clamp(0, p - 1)]
    min_d = torch.where(valid, torch.linalg.norm(xyz - xyz[first_idx], dim=-1), -math.inf)
    min_d[first_idx] = -math.inf
    picked = [first_idx.reshape(())]
    for _ in range(1, num_samples):
        nxt = torch.argmax(min_d)
        picked.append(nxt)
        d = torch.linalg.norm(xyz - xyz[nxt], dim=-1)
        min_d = torch.minimum(min_d, torch.where(valid, d, -math.inf))
        min_d[nxt] = -math.inf
    return torch.stack(picked)
