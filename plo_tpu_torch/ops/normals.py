"""Stage 2 — PCA normals (the port of plo_tpu/ops/normals.py): the
pointcloud path (`_pca_impl` with the rolled-arc kd search and the exact
+-window, scan_registration.cpp:117-229, loop :1161-1229) and the
grid-stencil path on the range image (`_pca_grid_impl`).

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


# ---------------------------------------------------------------------------
# Grid-stencil PCA (format="range_image", method="pca")
# ---------------------------------------------------------------------------

def _row_shift(a: torch.Tensor, r: int) -> torch.Tensor:
    """out[h, w] = a[h+r, w] with zero fill."""
    if r == 0:
        return a
    h = a.shape[0]
    out = torch.zeros_like(a)
    if r > 0:
        out[:h - r] = a[r:]
    else:
        out[-r:] = a[:h + r]
    return out


def _col_shifts(a: torch.Tensor, t_lo: int, t_hi: int) -> torch.Tensor:
    """[T, H, W, ...]: out[t, h, w] = a[h, w+t] with zero fill (no azimuth
    wrap) for t = t_lo..t_hi, in one copy (plo_tpu's _col_shift, stacked)."""
    w = a.shape[1]
    left, right = max(-t_lo, 0), max(t_hi, 0)
    zeros = lambda n: a.new_zeros((a.shape[0], n) + a.shape[2:])
    padded = torch.cat([zeros(left), a, zeros(right)], dim=1)
    return torch.stack([padded[:, left + t:left + t + w] for t in range(t_lo, t_hi + 1)])


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) over 3 components, added left to right as plo_tpu's
    reduction adds them."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _pca_grid(xyzg: torch.Tensor, occ: torch.Tensor, window_size: int, iter_step: int,
              search_window: int, knn_distance_threshold: float,
              distance_threshold: float, valid_points_threshold: float,
              use_all_points: bool):
    """PCA normals on the rasterized (ring x azimuth) grid with shift
    stencils (plo_tpu.ops.normals._pca_grid_impl): own-ring window = column
    shifts; nearest point on the rows above and below = argmin of d2 over
    column shifts s in [-sw, sw] (the lowest s wins ties); the window around
    it = the shifts t with t - s* in the window offsets. Moments are centered
    on the cell's own point; a cell fails unless its 3 x n_win window is full.

    The shifts are stacked [T, H, W, ...] so each step is a few launches, not
    one per shift. The 0/1 counts are exact in any order; the f32 moment sums
    are added term by term in the JAX package's order (shift by shift: own
    ring, row above, row below), so they round the same way.

    Returns (normal [H,W,3], eigvals [H,W,3] desc, eigvecs [H,W,3,3],
    keep [H,W], plane_fail [H,W])."""
    offs = list(range(-window_size, window_size + 1, iter_step))
    num = 3 * len(offs)
    h, w = occ.shape
    sw = search_window
    t_lo, t_hi = offs[0] - sw, offs[-1] + sw
    center = xyzg
    occf = occ.to(torch.float32)
    rows = ((_row_shift(xyzg, -1), _row_shift(occf, -1)),    # ring above = row - 1
            (_row_shift(xyzg, +1), _row_shift(occf, +1)))    # ring below = row + 1

    def member(rel):
        """rel in offs."""
        return (rel >= offs[0]) & (rel <= offs[-1]) & ((rel - offs[0]) % iter_step == 0)

    # Per part (own ring, row above, row below): centered points q [T,H,W,3]
    # and 0/1 weights [T,H,W] over the shifts t_lo..t_hi; the own ring
    # counts only at the shifts in offs.
    ts = torch.arange(t_lo, t_hi + 1, device=xyzg.device)[:, None, None]
    parts = [(_col_shifts(xyzg, t_lo, t_hi) - center,
              _col_shifts(occf, t_lo, t_hi) * member(ts).to(torch.float32))]
    for adj_xyz, adj_occ in rows:
        # adjacent-ring NN over column shifts s in [-sw, sw]
        cand = _col_shifts(adj_xyz, -sw, sw) - center
        d2 = torch.where(_col_shifts(adj_occ, -sw, sw) > 0.5, _dot3(cand, cand), math.inf)
        arg = torch.argmin(d2, dim=0, keepdim=True)
        best_d2 = torch.gather(d2, 0, arg)[0]
        found = torch.isfinite(best_d2) & (best_d2 < knn_distance_threshold)
        s_star = torch.where(found, arg[0] - sw, 0)
        wgt = torch.where(member(ts - s_star) & found, _col_shifts(adj_occ, t_lo, t_hi), 0.0)
        parts.append((_col_shifts(adj_xyz, t_lo, t_hi) - center, wgt))
    cnt = parts[0][1].sum(0) + parts[1][1].sum(0) + parts[2][1].sum(0)

    # Pass 1: first and second moments, one [H, W, 12] sum added term by term
    # (the own ring only at the shifts in offs, as plo_tpu adds it).
    terms = []
    for q, wgt in parts:
        qq = (q[..., :, None] * q[..., None, :]).reshape(q.shape[:-1] + (9,))
        terms.append(torch.cat([q, qq], dim=-1) * wgt[..., None])
    acc = torch.zeros((h, w, 12), dtype=torch.float32, device=xyzg.device)
    for i, t in enumerate(range(t_lo, t_hi + 1)):
        for p, part in enumerate(terms):
            if p > 0 or t in offs:
                acc = acc + part[i]
    s1, s2 = acc[..., :3], acc[..., 3:].reshape(h, w, 3, 3)

    rowcnt = occ.sum(1)
    size_ok = ((rowcnt >= 17) & (_row_shift(rowcnt, -1) >= 17)
               & (_row_shift(rowcnt, +1) >= 17))
    row_ok = (torch.arange(h, device=occ.device) >= 1) & (torch.arange(h, device=occ.device) <= h - 2)
    full = occ & (row_ok & size_ok)[:, None] & (cnt == num)

    denom = cnt.clamp_min(1.0)
    mu_q = s1 / denom[..., None]
    cov = ((s2 - denom[..., None, None] * (mu_q[..., :, None] * mu_q[..., None, :]))
           / (denom - 1.0).clamp_min(1.0)[..., None, None])
    eigvals, eigvecs = eigh3_descending(cov.reshape(-1, 3, 3))
    eigvals = eigvals.reshape(h, w, 3)
    eigvecs = eigvecs.reshape(h, w, 3, 3)
    normal = eigvecs[..., :, 2]

    # Pass 2: plane-validity count (scan_registration.cpp:138-156).
    n_close = torch.zeros((h, w), dtype=torch.float32, device=xyzg.device)
    for q, wgt in parts:
        d = _dot3(q - mu_q, normal).abs()
        n_close = n_close + torch.where(d < distance_threshold, wgt, 0.0).sum(0)
    plane_ok = n_close >= valid_points_threshold * cnt

    normal = normal * torch.where(normal[..., 2:3] < 0, -1.0, 1.0)
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True).clamp_min(1e-12)
    plane_fail = full & ~plane_ok
    keep = full if use_all_points else full & plane_ok
    eigvals = torch.where(plane_fail[..., None], -1.0, eigvals)
    return normal, eigvals, eigvecs, keep, plane_fail


def compute_normals_pca_grid(xyzg: torch.Tensor, occ: torch.Tensor, cfg: PCAConfig,
                             use_all_points: bool, search_window: int = 8):
    """Grid-stencil PCA on the rasterized range image (see `_pca_grid`)."""
    pc = cfg.plane_constraint
    return _pca_grid(xyzg, occ, cfg.window_size, cfg.iter_step, search_window,
                     cfg.knn_distance_threshold, pc.distance_threshold,
                     pc.valid_points_threshold, use_all_points)
