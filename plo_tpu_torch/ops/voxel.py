"""Voxel-grid downsampling and the persistent voxel map (the port of
plo_tpu/ops/voxel.py).

The reference links PCL's VoxelGrid and ships the call commented out
(scan_registration.cpp:851-858); the map target depends on it: a
voxel-downsampled model bounds each cell's occupancy, which is what makes the
grid-hash search (ops/grid_hash.py) exact in practice on maps.

Voxels are identified by the spatial hash of their cell; collisions merge
voxels (rare at n_buckets far above the occupied voxels: a dropped point,
never a wrong one). Cells are floor(xyz * (1 / leaf)) in f32, as plo_tpu's
odometry computes them with the leaf size a constant of its program
(grid_hash.cell_coords).
"""
from __future__ import annotations

import dataclasses

import torch

from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.ops.grid_hash import cell_coords, hash_bucket, sum_sq3


def _buckets(xyz: torch.Tensor, valid: torch.Tensor, leaf_size: float, n_buckets: int):
    cell = cell_coords(xyz, leaf_size)
    return torch.where(valid, hash_bucket(cell, n_buckets), n_buckets)


def voxel_downsample(cloud: PointCloud, leaf_size: float, out_size: int,
                     n_buckets: int = 1 << 18) -> PointCloud:
    """One point per occupied voxel at the centroid of its members (normals
    averaged and renormalized, intensity and curvature averaged), in a cloud
    of capacity out_size; voxels in bucket order, those beyond out_size
    dropped. The centroid sums are f32 scatter-adds, whose order differs from
    XLA's, so the averages agree with plo_tpu's to f32 rounding, not bits."""
    dev = cloud.xyz.device
    bucket = _buckets(cloud.xyz, cloud.valid, leaf_size, n_buckets)
    ones = cloud.valid.to(torch.float32)

    def total(values):
        shape = (n_buckets + 1,) + values.shape[1:]
        return torch.zeros(shape, dtype=torch.float32, device=dev).index_add_(0, bucket, values)

    cnt = total(ones)
    sx = total(cloud.xyz * ones[:, None])
    sn = total(cloud.normal * ones[:, None])
    si = total(cloud.intensity * ones)
    sc = total(cloud.curvature * ones)
    occupied = cnt[:n_buckets] > 0
    order = torch.sort((~occupied).to(torch.uint8), stable=True).indices[:out_size]
    out_valid = torch.arange(out_size, device=dev) < occupied.sum()
    denom = cnt[order].clamp_min(1.0)[:, None]
    normal = sn[order] / denom
    nn = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = torch.where(nn > 1e-6, normal / nn.clamp_min(1e-12), 0.0)
    return PointCloud(xyz=sx[order] / denom, normal=normal,
                      intensity=si[order] / denom[:, 0], curvature=sc[order] / denom[:, 0],
                      eigvals=torch.zeros((out_size, 3), dtype=torch.float32, device=dev),
                      valid=out_valid)


def voxel_map_insert(map_cloud: PointCloud, new_cloud: PointCloud, leaf_size: float,
                     center: torch.Tensor, n_buckets: int = 1 << 19) -> PointCloud:
    """Insert a world-frame cloud into the fixed-capacity voxel map (the map
    form of accumulateTargetCloud, laser_odometry.cpp:116-136): map points
    never move; a new point enters only where its voxel is empty, the first
    in index order winning within the frame (a scatter-min); beyond the map's
    capacity the points farthest from `center` (the sensor) leave first, in
    a stable sort on the squared distance, so ties keep the older map points.
    Integer and ordering work only: which points enter and the map's order
    are plo_tpu's exactly (the distances as XLA's CPU backend rounds them,
    grid_hash.sum_sq3)."""
    cap = map_cloud.capacity
    p = new_cloud.capacity
    dev = map_cloud.xyz.device
    mb = _buckets(map_cloud.xyz, map_cloud.valid, leaf_size, n_buckets)
    occupied = torch.zeros(n_buckets + 1, dtype=torch.bool, device=dev)
    occupied[mb] = map_cloud.valid   # every valid point writes True; invalid ones the spare
    # The spare bucket is never occupied (not by a scalar write: a Python
    # scalar written into a CUDA tensor waits for the host).
    occupied = torch.cat([occupied[:n_buckets], occupied.new_zeros(1)])

    nb = _buckets(new_cloud.xyz, new_cloud.valid, leaf_size, n_buckets)
    idx = torch.arange(p, device=dev)
    first = torch.full((n_buckets + 1,), p, dtype=torch.int64, device=dev).scatter_reduce(
        0, nb, torch.where(new_cloud.valid, idx, p), "amin")
    keep_new = new_cloud.valid & (first[nb] == idx) & ~occupied[nb]

    merged = map_cloud.concat(dataclasses.replace(new_cloud, valid=keep_new))
    d2 = torch.where(merged.valid, sum_sq3(merged.xyz - center[None, :]), torch.inf)
    order = torch.sort(d2, stable=True).indices[:cap]
    out = PointCloud(**{f.name: getattr(merged, f.name)[order]
                        for f in dataclasses.fields(PointCloud)})
    return dataclasses.replace(out, valid=out.valid & torch.isfinite(d2[order]))
