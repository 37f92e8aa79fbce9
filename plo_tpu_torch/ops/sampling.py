"""Stage 3b — normal-direction and major-axis sampling (the port of
plo_tpu/ops/sampling.py, scan_registration.cpp:584-759).

Every sampler returns a fixed-size index set (idx [S], valid [S]). Random
numbers come in as arguments (uniform [0, 1) scores of length P), so tests
can feed the draws the JAX package made.
"""
from __future__ import annotations

import math
from typing import Tuple

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
                    max_points_per_bin: int, out_size: int):
    """Spherical-histogram sampling with random within-bin ranks
    (normalSampling, scan_registration.cpp:584-629)."""
    n_bins = azimuth_bins * elevation_bins
    bins = spherical_bins(normals, azimuth_bins, elevation_bins)
    rank, counts = _rank_within_bins(bins, candidates, scores, n_bins)
    binc = counts[bins.clamp(0, n_bins - 1)]
    keep = candidates & (binc >= min_points_per_bin) & (rank < max_points_per_bin)
    return compact_indices(keep, out_size)


def fps_rank_within_bins(xyz: torch.Tensor, bins: torch.Tensor, member: torch.Tensor,
                         scores: torch.Tensor, n_bins: int, bin_capacity: int,
                         max_rank: int, needed: torch.Tensor):
    """Farthest-point rank of each member within its bin
    (scan_registration.cpp:605-614, 736-744). Members go into a dense
    [n_bins, bin_capacity] slot table in random order (`scores`; bins past
    capacity keep a random subset), the fps_ranks kernel traverses every bin
    until ranks 0..min(needed, max_rank)-1 are assigned, and the ranks are
    scattered back. Unranked members get max_rank."""
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

    steps = needed.clamp(max=max_rank).to(torch.int32).reshape(())
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
                        out_size: int):
    """Weighted-bin sampling against the previous frame's cloud with FPS
    quota selection (majorAxisSampling, scan_registration.cpp:631-759).
    `sub_scores` drive the weight-estimation subsample, `sel_scores` the
    random slot order of the FPS tables."""
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

    # Phase 2 — quota selection (:726-758): quota = min(weight*max_total, size),
    # clamped to the FPS rank range so sentinel-ranked members never pass.
    max_rank = min(max_total_points, 1024)
    quota = torch.minimum((bin_weight * max_total_points).long(), counts).clamp(max=max_rank)
    rank2, _ = fps_rank_within_bins(xyz, bins, candidates, sel_scores, n_bins,
                                    bin_capacity=1024, max_rank=max_rank,
                                    needed=quota.max())
    my_quota = quota[bins.clamp(0, n_bins - 1)]
    keep = candidates & bin_live & (rank2 < my_quota)
    return compact_indices(keep, out_size)
