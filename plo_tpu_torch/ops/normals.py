"""Stage 2 — pointcloud PCA normals (the port of the default path of
plo_tpu/ops/normals.py: `_pca_impl` with the rolled-arc kd search and the
exact +-window, scan_registration.cpp:117-229, loop :1161-1229).

Each point's neighborhood is a +-window along its own ring plus +-windows
around its nearest point on the rings above and below; the 3x3 covariance
goes through the closed-form eigh, then the plane-validity test and the +z
hemisphere flip.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.config import PCAConfig
from plo_tpu_torch.ops.eigh3 import eigh3_descending
from plo_tpu_torch.ops.preprocess import RingCloud


@dataclasses.dataclass(frozen=True)
class NormalResult:
    """Filtered cloud + PCA side data (plo_tpu.ops.normals.NormalResult)."""

    cloud: PointCloud          # valid = point survived normal computation
    eigvecs: torch.Tensor      # [P, 3, 3] descending-order eigenvector columns
    plane_fail: torch.Tensor   # [P] bool — kept in the model cloud, barred
                               # from sampling (:1481-1489)


def _ring_interior_mask(cloud: RingCloud) -> torch.Tensor:
    """Points eligible for normal computation: ring in [1, H-2], own and
    adjacent ring sizes >= 17, position in [5, size-5) (:1162-1170)."""
    h = cloud.ring_start.shape[0]
    ring = cloud.ring.clamp(0, h - 1)
    size_ok = lambda r: cloud.ring_count[r.clamp(0, h - 1)] >= 17
    ring_ok = (cloud.ring >= 1) & (cloud.ring <= h - 2)
    sizes_ok = size_ok(ring) & size_ok(ring - 1) & size_ok(ring + 1)
    pos_ok = (cloud.pos_in_ring >= 5) & (cloud.pos_in_ring < cloud.ring_count[ring] - 5)
    return cloud.valid & ring_ok & sizes_ok & pos_ok


def _packed_points(cloud: RingCloud) -> torch.Tensor:
    """[P, 5] = [x, y, z, ring, valid]."""
    return torch.cat([cloud.xyz, cloud.ring.to(torch.float32)[:, None],
                      cloud.valid.to(torch.float32)[:, None]], dim=1)


def _window_gather(cloud: RingCloud, packed: torch.Tensor, center_flat: torch.Tensor,
                   center_ok: torch.Tensor, window_size: int, iter_step: int):
    """The +-window along the ring of `center_flat`; a slot is valid if it
    stays inside the same ring (:166-169). Returns ([P, Wn, 3], [P, Wn])."""
    cap = cloud.capacity
    offs = torch.arange(-window_size, window_size + 1, iter_step, device=packed.device)
    idx = center_flat[:, None] + offs[None, :]
    rows = packed[idx.clamp(0, cap - 1)]
    center_ring = packed[center_flat.clamp(0, cap - 1), 3]
    same_ring = rows[..., 3] == center_ring[:, None]
    in_bounds = (idx >= 0) & (idx < cap)
    ok = center_ok[:, None] & same_ring & in_bounds & (rows[..., 4] > 0.5)
    return rows[..., :3], ok


def _window_shift(cloud: RingCloud, packed: torch.Tensor, center_ok: torch.Tensor,
                  window_size: int, iter_step: int):
    """Self-window form of _window_gather: the centers are the points
    themselves, so each window slot is a shifted copy of the packed rows."""
    p = cloud.capacity
    offs = list(range(-window_size, window_size + 1, iter_step))
    idx = (torch.arange(p, device=packed.device)[:, None]
           + torch.tensor(offs, device=packed.device)[None, :])
    rows = torch.stack([torch.roll(packed, -o, 0) for o in offs], dim=1)
    same_ring = rows[..., 3] == packed[:, None, 3]
    in_bounds = (idx >= 0) & (idx < p)  # roll wraps; mask the wrapped slots
    ok = center_ok[:, None] & same_ring & in_bounds & (rows[..., 4] > 0.5)
    return rows[..., :3], ok


def _rolled_adjacent_window(cloud: RingCloud, packed: torch.Tensor, offset: int,
                            knn_threshold: float, window_size: int,
                            iter_step: int, eligible: torch.Tensor,
                            search_window: int = 8):
    """findNearestPoint + window on ring r+offset, plo_tpu's default rolled
    form with the exact window: one [P] row gather resamples the adjacent ring
    onto the query ring's positions, the kd argmin runs over
    2*search_window+1 rolls of it (first lowest offset wins ties), and the
    +-window is gathered around the found point in target index space."""
    h = cloud.ring_start.shape[0]
    p_cap = cloud.capacity
    dev = packed.device
    tring = cloud.ring + offset
    tring_ok = (tring >= 0) & (tring < h)
    tring_c = tring.clamp(0, h - 1)
    tstart = cloud.ring_start[tring_c]
    tcount = cloud.ring_count[tring_c]
    qcount = cloud.ring_count[cloud.ring.clamp(0, h - 1)].clamp_min(1)
    center = (cloud.pos_in_ring.float() / qcount.float() * tcount.float()).long()
    anchor_ok = tring_ok & (center >= 0) & (center < tcount) & cloud.valid
    base_flat = (tstart + torch.minimum(center.clamp_min(0), tcount - 1)).clamp(0, p_cap - 1)
    res = packed[base_flat].clone()
    res[:, 4] = torch.where(anchor_ok & (res[:, 4] > 0.5), 1.0, 0.0)
    own_tring = tring_c.to(torch.float32)

    pos_idx = torch.arange(p_cap, device=dev)
    best_d2 = torch.full((p_cap,), math.inf, dtype=torch.float32, device=dev)
    best_rel = torch.zeros(p_cap, dtype=torch.int64, device=dev)
    for o in range(-search_window, search_window + 1):
        r = torch.roll(res, -o, 0)
        ok = ((r[:, 4] > 0.5) & (pos_idx + o >= 0) & (pos_idx + o < p_cap)
              & (r[:, 3] == own_tring))
        diff = r[:, :3] - cloud.xyz
        d2 = torch.where(ok, (diff * diff).sum(-1), math.inf)
        take = d2 < best_d2   # strict: the lowest offset wins ties
        best_d2 = torch.where(take, d2, best_d2)
        best_rel = torch.where(take, o, best_rel)
    found = torch.isfinite(best_d2) & cloud.valid & (best_d2 < knn_threshold)
    found_flat = base_flat[(pos_idx + best_rel).clamp(0, p_cap - 1)]
    return _window_gather(cloud, packed, found_flat, found & eligible,
                          window_size, iter_step)


def compute_normals_pca(cloud: RingCloud, cfg: PCAConfig,
                        use_all_points: bool) -> NormalResult:
    """PCA normals of every eligible point (plo_tpu.ops.normals.
    compute_normals_pca with its defaults: kdtree neighbor scan, rolled arc,
    exact window)."""
    if cfg.neighbor_scan != "kdtree":
        raise NotImplementedError(
            f"neighbor_scan={cfg.neighbor_scan!r}: the port covers the default "
            "'kdtree' scan only")
    ws, step = cfg.window_size, cfg.iter_step
    num = 3 * len(range(-ws, ws + 1, step))  # every slot must be filled (:161,198)

    eligible = _ring_interior_mask(cloud)
    packed = _packed_points(cloud)
    thr = cfg.knn_distance_threshold
    p0, m0 = _window_shift(cloud, packed, eligible, ws, step)
    p1, m1 = _rolled_adjacent_window(cloud, packed, -1, thr, ws, step, eligible)
    p2, m2 = _rolled_adjacent_window(cloud, packed, +1, thr, ws, step, eligible)
    pts = torch.cat([p0, p1, p2], dim=1)   # [P, num, 3]
    msk = torch.cat([m0, m1, m2], dim=1)   # [P, num]

    count = msk.sum(1)
    full = eligible & (count == num)
    w = msk[..., None].to(torch.float32)
    cnt_f = count[:, None, None].to(torch.float32)
    centroid = (pts * w).sum(1, keepdim=True) / cnt_f.clamp_min(1.0)
    centered = (pts - centroid) * w
    cov = torch.einsum("pni,pnj->pij", centered, centered) / (cnt_f - 1.0).clamp_min(1.0)
    eigvals, eigvecs = eigh3_descending(cov)

    normal = eigvecs[:, :, 2]
    # Plane validity (:138-156): share of window points within
    # distance_threshold of the plane through the centroid.
    dist = torch.einsum("pni,pi->pn", pts - centroid, normal).abs()
    pc = cfg.plane_constraint
    n_close = ((dist < pc.distance_threshold) & msk).sum(1)
    plane_ok = n_close >= pc.valid_points_threshold * count

    normal = normal * torch.where(normal[:, 2:3] < 0, -1.0, 1.0)  # +z flip (:1196-1200)
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True).clamp_min(1e-12)

    plane_fail = full & ~plane_ok
    keep = full if use_all_points else full & plane_ok
    out_eigvals = torch.where(plane_fail[:, None], -1.0, eigvals)
    out = PointCloud(
        xyz=cloud.xyz,
        normal=torch.where(keep[:, None], normal, 0.0),
        intensity=cloud.intensity,
        curvature=torch.zeros(cloud.capacity, dtype=torch.float32, device=packed.device),
        eigvals=torch.where(keep[:, None], out_eigvals, 0.0),
        valid=keep,
    )
    return NormalResult(cloud=out, eigvecs=eigvecs, plane_fail=plane_fail)
